"""Rules of the port: it imports neither JAX nor the reference package, and
its copy of the control plane and configs agrees with the reference's."""
import ast
import dataclasses
import re
from pathlib import Path

import jax  # noqa: F401  (the reference side of the comparisons)
import numpy as np
import pytest
import torch  # noqa: F401

from repro import core as jcore
from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro_torch import core as tcore
from repro_torch.configs import get_config

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / n for n in ("chip_smoke.py", "chip_compare.py",
                          "chip_decode_sweep.py", "chip_prefill_probe.py")]


#: the control plane, both simulators, the flight recorder, the
#: training data pipeline and the dry-run's report, copied from the
#: reference package (the last two verbatim, numpy or nothing but the
#: standard library): each file's text is the reference's with every
#: ``repro`` token read as ``repro_torch``, but for these lines, reworded
#: in the port so that they name no change number (or, in the report's
#: docstring, the port's module path).
COPIED = [f"core/{n}.py" for n in (
    "__init__", "autoscaler", "convertible", "fleet", "gateway", "hardware",
    "predictor", "router", "velocity")] \
    + [f"sim/{n}.py" for n in (
        "__init__", "cluster", "events", "faults", "instances", "kvcache",
        "runner", "traces")] \
    + [f"obs/{n}.py" for n in (
        "__init__", "__main__", "explain", "export", "metrics", "recorder")] \
    + ["training/data.py", "launch/roofline_report.py"]
#: the copies whose reference is not the file of the same path under
#: src/repro
SOURCES = {"launch/roofline_report.py": "benchmarks/roofline_report.py"}
REWORDED = {
    "core/router.py": [(
        "never-burst before PR 2)\n",
        "never-burst under the\n        # original per-window "
        "normalization)\n")],
    "core/fleet.py": [("the PR 4 owner-steering",
                       "the session-cache owner-steering")],
    "core/gateway.py": [("The PR 4 prefix cache", "The per-session prefix "
                         "cache")],
    "sim/faults.py": [("(the PR 9 degradation contract)",
                       "(the recorder's degradation contract)")],
    "sim/instances.py": [("are thin drivers over", "are thin loops over"),
                         ("(pre-PR-2 behavior)",
                          "(the pre-priority behavior)")],
    "obs/__init__.py": [("observability layer (PR 9).",
                         "observability layer.")],
    "launch/roofline_report.py": [("python -m benchmarks.roofline_report",
                                   "python -m repro.launch.roofline_report")],
}


def _forbidden(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") \
        or name == "repro" or name.startswith("repro.")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_reference(arch, smoke):
    assert dataclasses.asdict(get_config(arch, smoke)) \
        == dataclasses.asdict(jget_config(arch, smoke))


@pytest.mark.parametrize("chip", ["h100", "v5e"])
def test_profile_equals_reference(chip):
    mine = tcore.profile(get_config("llama31_8b"),
                         tcore.InstanceSpec(tcore.CHIPS[chip], 1))
    want = jcore.profile(jget_config("llama31_8b"),
                         jcore.InstanceSpec(jcore.CHIPS[chip], 1))
    assert dataclasses.asdict(mine) == dataclasses.asdict(want)


def _observations(pkg, seed=0, n=40):
    rng = np.random.RandomState(seed)
    buckets = list(pkg.BUCKETS)
    obs = []
    for i in range(n):
        by_bucket = {b: float(rng.uniform(0, 4e4)) for b in buckets
                     if rng.rand() < 0.7}
        obs.append(pkg.Observation(
            t=0.5 * i, token_rate_in=float(rng.uniform(0, 8e4)),
            token_rate_by_bucket=by_bucket, rps=float(rng.uniform(0, 40)),
            prefill_queue=int(rng.randint(0, 20)),
            decode_inflight=int(rng.randint(0, 200)),
            mem_util=float(rng.uniform(0, 1)),
            cur_prefillers=int(rng.randint(1, 6)),
            cur_decoders=int(rng.randint(1, 6))))
    return obs


@pytest.mark.parametrize("convertible", [0, 1])
def test_tokenscale_decisions_equal_reference(convertible):
    def decisions(pkg, cfg):
        prof = pkg.profile(cfg, pkg.InstanceSpec(pkg.CHIPS["h100"], 1))
        pol = pkg.TokenScalePolicy(prof, convertible=convertible)
        return [dataclasses.asdict(pol.decide(o))
                for o in _observations(pkg)]
    assert decisions(tcore, get_config("llama31_8b")) \
        == decisions(jcore, jget_config("llama31_8b"))


def test_router_placement_equals_reference():
    """Alg. 1 over the same sequence of prefill requests picks the same
    target kinds in both copies."""
    class Inst:
        def __init__(self, v, q):
            self.v, self.q = v, q

        def prefill_velocity(self):
            return self.v

        def inflight_tokens(self):
            return self.q

    def kinds(pkg):
        rng = np.random.RandomState(1)
        router = pkg.Router(pkg.BurstDetector())
        out = []
        for i in range(30):
            pre = [Inst(2e4, float(rng.uniform(0, 4e4))) for _ in range(2)]
            conv = [Inst(5e3, float(rng.uniform(0, 1e4)))]
            _, kind = router.route_prefill(int(rng.randint(16, 4096)), pre,
                                           conv, 0.1 * i)
            out.append(kind)
        return out
    assert kinds(tcore) == kinds(jcore)


@pytest.mark.parametrize("rel", COPIED)
def test_copied_file_is_the_reference(rel):
    """The port's copy reads as the reference's once ``repro_torch`` is read
    as ``repro``, but for the listed rewordings; each of those is in the
    reference exactly once."""
    want = (ROOT / SOURCES.get(rel, f"src/repro/{rel}")).read_text()
    for old, new in REWORDED.get(rel, []):
        assert want.count(old) == 1, (rel, old)
        want = want.replace(old, new)
    mine = (ROOT / "src" / "repro_torch" / rel).read_text()
    assert re.sub(r"\brepro_torch\b", "repro", mine) == want
