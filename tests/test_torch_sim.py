"""The port's copy of the control plane and both cluster simulators
against the reference's, on the CPU: the same experiments give the same
reports, exactly, and the golden fixtures replay within the reference's
own tolerances.

The two packages keep their registries and caches apart (a reference
object fails the port's isinstance), so experiments cross between them as
data: plain keyword arguments, the fixtures' JSON, or
``ExperimentSpec.to_dict()`` into the other package's ``from_dict``.  The
fixtures are replayed by ``chip_smoke.golden_replay``, the code that
replays them on the card's machine.
"""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))      # chip_smoke and benchmarks.run

import chip_smoke as cs  # noqa: E402
from benchmarks.run import (PARETO_CFG, PARETO_VARIANTS,  # noqa: E402
                            pareto_fleet_spec)
from repro.core import POLICY_REGISTRY  # noqa: E402
from repro.core import ExperimentSpec as JExperimentSpec  # noqa: E402
from repro.core.fleet import FLEET_POLICY_REGISTRY  # noqa: E402
from repro.sim import TRACES  # noqa: E402
from repro.sim import runner as jrunner  # noqa: E402
from repro_torch.core import POLICY_REGISTRY as T_POLICY_REGISTRY  # noqa: E402
from repro_torch.core.fleet import \
    FLEET_POLICY_REGISTRY as T_FLEET_REGISTRY  # noqa: E402
from repro_torch.sim import runner as trunner  # noqa: E402

POLICIES = sorted(POLICY_REGISTRY) + sorted(FLEET_POLICY_REGISTRY)
ENGINES = ("fluid", "events")
GOLDEN_NAMES = sorted(p.stem for p in cs.GOLDEN.glob("*.json"))


def _rows(rep):
    """What two runs must share: the summary and each request's first
    token and finish times (non-finite as None)."""
    return cs._finite({
        "summary": rep.summary(),
        "requests": [(r.t_first_token, r.t_finish) for r in rep.requests]})


def test_registries_equal_reference():
    assert sorted(T_POLICY_REGISTRY) == sorted(POLICY_REGISTRY)
    assert sorted(T_FLEET_REGISTRY) == sorted(FLEET_POLICY_REGISTRY)
    assert len(GOLDEN_NAMES) == 8 \
        and set(cs.GOLDEN_ON_CARD) == set(GOLDEN_NAMES) - {"pareto_coord"}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("trace", sorted(TRACES) + ["mixed"])
@pytest.mark.parametrize("policy", POLICIES)
def test_report_equals_reference(policy, trace, engine):
    kw = dict(duration=12.0, rps=6.0, seed=1, engine=engine)
    mine = _rows(trunner.run_policy(policy, trace, **kw))
    want = _rows(jrunner.run_policy(policy, trace, **kw))
    assert mine["summary"]["n_requests"] > 0
    assert mine == want


def _pareto_specs(g):
    """benchmarks.run's pareto cells as the reference's ExperimentSpec
    dicts (the fixture does not hold its pool list)."""
    return {(eng, v): JExperimentSpec(
        fleet=pareto_fleet_spec(v, g["trace"]), policy=PARETO_VARIANTS[v][0],
        engine=eng, duration=g["duration"], seed=PARETO_CFG["seed"],
        max_instances=PARETO_CFG["max_instances"]).to_dict()
        for eng in g["engines"] for v in g["variants"]}


@pytest.mark.parametrize("name", GOLDEN_NAMES)
def test_golden_equals_reference_and_fixture(name):
    """Each fixture replays through both packages to the same rows,
    exactly, and the port's rows meet the committed fixture at the
    reference's tolerances (counts exact)."""
    g = json.loads((cs.GOLDEN / f"{name}.json").read_text())
    specs = _pareto_specs(g) if name == "pareto_coord" else None
    mine = cs.golden_replay(name, g, trunner, specs)
    want = cs.golden_replay(name, g, jrunner, specs)
    assert json.dumps(mine, sort_keys=True) == json.dumps(want, sort_keys=True)
    worst, bad = cs.golden_deviation(
        g["engines"], mine, cs.GOLDEN_REL.get(name, cs.GOLDEN_REL_DEFAULT))
    assert not bad, bad


def test_golden_deviation_flags_a_count_and_a_float():
    """The fixture check holds counts exact and floats to `rel`."""
    want = {"n_requests": 10, "ttft_p99": 1.0, "kv": {"x": None}}
    assert cs.golden_deviation(want, dict(want), 0.05) == (0.0, [])
    worst, bad = cs.golden_deviation({**want, "ttft_p99": 1.04}, want, 0.05)
    assert not bad and worst == pytest.approx(0.04 / 1.04)
    assert cs.golden_deviation({**want, "ttft_p99": 1.06}, want, 0.05)[1]
    assert cs.golden_deviation(want, {**want, "n_requests": 11}, 0.05)[1]
    assert cs.golden_deviation(want, {**want, "kv": {"x": 0.0}}, 0.05)[1]
    assert cs.golden_deviation(want, {"n_requests": 10}, 0.05)[1]


@pytest.mark.parametrize("engine", ENGINES)
def test_hetero_demo_spec_crosses_as_data(engine):
    """The reference's hetero_demo_spec, through to_dict into the port's
    from_dict, is the port's own spec and runs to the same report."""
    d = jrunner.hetero_demo_spec(duration=20.0, rps=6.0, engine=engine) \
        .to_dict()
    spec = trunner.ExperimentSpec.from_dict(d)
    assert spec.to_dict() == d
    assert trunner.hetero_demo_spec(duration=20.0, rps=6.0,
                                    engine=engine).to_dict() == d
    assert _rows(trunner.run_spec(spec)) \
        == _rows(jrunner.run_spec(jrunner.ExperimentSpec.from_dict(d)))


def test_compare_engines_equals_reference():
    kw = dict(duration=15.0, rps=6.0, seed=0)
    mine = trunner.compare_engines("tokenscale", "burstgpt1", **kw)
    want = jrunner.compare_engines("tokenscale", "burstgpt1", **kw)
    assert {e: _rows(r) for e, r in mine.items()} \
        == {e: _rows(r) for e, r in want.items()}


def test_compare_policies_at_h100_equals_reference():
    """What phase 11 prints on the card: the policies head to head at the
    H100 profile."""
    kw = dict(chip="h100", duration=20.0, rps=8.0)
    mine = trunner.compare_policies("mixed", **kw)
    want = jrunner.compare_policies("mixed", **kw)
    assert {p: _rows(r) for p, r in mine.items()} \
        == {p: _rows(r) for p, r in want.items()}


def test_convertible_plan_equals_reference():
    """Phase 11's plan: chunk 2816 for Llama-3.1-8B on one H100, with
    Eq. 5's mixed step under the 100 ms TPOT SLO, as the reference's."""
    from repro.configs import get_config as jget_config
    from repro.core import CHIPS as JCHIPS
    from repro.core import InstanceSpec as JInstanceSpec
    from repro.core import plan_convertible as jplan
    from repro_torch.configs import get_config
    from repro_torch.core import CHIPS, InstanceSpec, plan_convertible
    from repro_torch.core.velocity import mixed_iter_time
    cfg = get_config("llama31_8b")
    inst = InstanceSpec(CHIPS["h100"], 1)
    plan = plan_convertible(cfg, inst, **cs.PLAN_ARGS)
    want = jplan(jget_config("llama31_8b"), JInstanceSpec(JCHIPS["h100"], 1),
                 **cs.PLAN_ARGS)
    assert (plan.chunk_size, plan.v_prefill, plan.mem_reserved,
            plan.pool_size) == (want.chunk_size, want.v_prefill,
                                want.mem_reserved, want.pool_size)
    assert plan.chunk_size == 2816 == cs.convertible_chunk()
    assert cs.CONVERTIBLE_MAX_LEN > plan.chunk_size
    for b in (3, 4):
        assert mixed_iter_time(cfg, inst, b, cs.PLAN_ARGS["avg_ctx"],
                               plan.chunk_size) < 0.1


@pytest.mark.parametrize("arch", ["llama31_8b", "qwen25_32b",
                                  "deepseek_v2_lite_16b"])
def test_payloads_held_to_kv_bytes_per_token(arch):
    """chip_smoke.payloads_ok: every transfer is the reference's
    kv_bytes_per_token per rounded token, and one byte off fails it."""
    from repro.configs import get_config as jget_config
    from repro.core import hardware as jhardware
    from repro_torch.configs import get_config
    per_token = int(jhardware.kv_bytes_per_token(jget_config(arch)))
    run = {"max_len": 2048, "transfers": [(per_token * 128, 100),
                                          (per_token * 2048, 2000)]}
    assert cs.payloads_ok(run, arch, get_config(arch))
    run["transfers"].append((per_token * 256 + 1, 200))
    assert not cs.payloads_ok(run, arch, get_config(arch))


def test_rounded_transfer_length():
    """chip_smoke's rounding of a transfer's tokens (128, at least 8, at
    most max_len), which phase 11 holds each transfer's bytes to."""
    assert [cs.rounded(L, 2048) for L in (1, 8, 127, 128, 129, 2047)] \
        == [128, 128, 128, 128, 256, 2048]
    assert cs.rounded(100, 96) == 96
