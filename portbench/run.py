"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout.  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics of ``BENCHMARK.json``; with
``--trace 1`` its per-layer metrics and a ``breakdown``), ``device``, and
last ``compared``: each number the correctness check compared, beside its
limit (also the last lines of standard error).  Exits non-zero with no
result without CUDA, with fewer cards than the cell asks for, or if
``jax``, ``jaxlib``, ``flax`` or ``repro`` was loaded.  Build and kernel
caches stay under ``build/`` in the checkout.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def set_caches():
    """Every cache of the run at a fixed path inside the checkout."""
    build = ROOT / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "2"


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import harness, trace
    from portbench.metrics import reader
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        harness.stderr(f"no workload {args.workload} in BENCHMARK.json")
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.stderr(f"{args.workload} needs {chips} CUDA device(s); "
                       f"this machine has "
                       f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    torch.cuda.init()
    cell = harness.Cell.named(args.workload)
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      device, T0)
    log = out.pop("log")
    out.pop("schedule")
    kind = "per_layer" if args.trace else "end_to_end"
    for m in bench[kind]:
        if not applies(m, args.workload):
            continue
        value = reader(m["name"])(log)
        if value is None:
            if kind == "end_to_end":
                harness.stderr(f"{m['name']}: nothing to read")
                return 3
            continue
        out["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    if log.trace is not None:
        out["breakdown"] = {
            "device_ops": trace.top(log.trace["kernel_s"], name=trace.short),
            "idle_gaps": trace.top(log.trace["idle_by_host"])}
    loaded = sorted({m.split(".")[0] for m in sys.modules}
                    & set(harness.FORBIDDEN))
    if loaded:
        harness.stderr(f"refused: the run loaded {loaded}")
        return 4
    out["compared"] = out.pop("compared")
    for name, c in out["compared"].items():
        harness.stderr(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
