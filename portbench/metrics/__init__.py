"""Metric readers, one file a metric: ``<name>.py`` defines ``read(run)``,
which takes the number from a ``harness.RunLog`` (the harness's clock and
the program's counters, the calls it logged, the trace) and returns it,
or None where the run holds nothing to read."""
import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def reader(name: str, root: Path = HERE):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name}", root / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
