"""Each cell's entry driven through the harness on the CPU at the SMOKE
size of its model (f32), against the plain reference: sound runs are
correct, a seed's schedule repeats, and a broken timed path is caught."""
import itertools

import numpy as np
import pytest
import torch

from portbench import faults, harness, traffic

CELLS = ["qwen25-32b.conv-code", "dsv2-lite.pd-code"]
SMALL = {"qwen25-32b.conv-code": dict(slots=4, max_len=384, chunk_size=192,
                                      clients=6, sample=3)}
# The PD entry on DeepSeek-V2-Lite (MLA, the latent cache's transfer):
# no cell of BENCHMARK.json runs it yet, so its workload is given here.
PD = dict(config="dsv2-lite", traffic="code", entry="pd", chips=1, slots=4,
          max_len=384, clients=6, sample=3, limits={"logit_gap": 0.15})
SEED = 2 ** 31 + 17


def cell(name):
    if name in SMALL:
        return harness.Cell.named(name, **SMALL[name])
    return harness.Cell(name, PD, harness.load("configs", PD["config"]),
                        traffic.load_mix(PD["traffic"]))


def smoke_run(name, seed=SEED, seconds=0.3, **kw):
    """A run on the CPU under a clock that ticks a millisecond a reading,
    so that its window, and the requests it finishes, are the same on
    every machine."""
    ticks = itertools.count(0.0, 1e-3)
    return harness.run(cell(name), seed, seconds, False, torch.device("cpu"),
                       0.0, smoke=True, clock=lambda: next(ticks), **kw)


@pytest.mark.parametrize("name", CELLS)
def test_smoke_run_is_correct(name):
    out = smoke_run(name)
    log = out["log"]
    assert out["correct"], out["compared"]
    assert out["compared"]["logit_gap"]["value"] <= 1e-3
    assert log.window_steps() and any(
        r.token_t and log.in_window(r.token_t[0]) for r in log.requests)
    assert out["attempted"] > 0 and out["failed"] == 0
    kinds = {c["kind"] for s in log.steps for c in s.calls}
    assert {"prefill", "decode"} <= kinds
    if name.startswith("dsv2"):
        assert {"extract", "insert"} <= kinds
    else:
        assert any(c["kind"] == "prefill" and c["start"] > 0
                   for s in log.steps for c in s.calls), "no chunk ran"


@pytest.mark.parametrize("name", CELLS)
def test_schedule_repeats_for_a_seed(name):
    a, b = smoke_run(name), smoke_run(name, seconds=0.1)
    c = smoke_run(name, seed=SEED + 1, seconds=0.1)
    assert a["schedule"] == b["schedule"] != c["schedule"]
    steps = [[(c["kind"], c.get("padded"), c.get("start"), c.get("n"))
              for c in s.calls] for s in a["log"].steps]
    assert steps[:len(b["log"].steps)] == [
        [(c["kind"], c.get("padded"), c.get("start"), c.get("n"))
         for c in s.calls] for s in b["log"].steps]


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in CELLS for fault in ("stale_cache", "alter_token")
] + [("dsv2-lite.pd-code", "zero_transfer")])
def test_a_broken_path_is_not_correct(name, fault):
    with faults.FAULTS[fault]():
        out = smoke_run(name)
    assert not out["correct"]
    assert out["compared"]["logit_gap"]["value"] > \
        out["compared"]["logit_gap"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_the_float8_control_is_not_correct(name):
    """The control (the reference computed in float8, the precision below
    the configuration's bf16, in the program's place) fails the cell's
    limit on the same tokens.  At 32 layers and a 32k vocabulary its
    rounding builds up to about what the full-size cell reads (twice the
    limit and more, PERF.md)."""
    out = smoke_run(name, seconds=0.15, control="fp8", fill=2,
                    resize=dict(num_layers=32, vocab_size=32768))
    assert out["correct"]
    assert not out["control"]["correct"]
    assert out["control"]["logit_gap"] > out["compared"]["logit_gap"]["limit"]


def test_a_traced_run_profiles_only_after_its_window(monkeypatch):
    """The host-clock numbers of a traced run come from the untraced
    window; the profiler covers only the steps after it."""
    from contextlib import nullcontext

    from portbench import trace
    seen = {}

    def read(prof, spans):
        seen["spans"] = spans
        return {"window_s": 1.0, "busy_s": 0.5, "kernel_s": {},
                "idle_by_host": {}}
    monkeypatch.setattr(trace, "profiler", nullcontext)
    monkeypatch.setattr(trace, "read", read)
    ticks = itertools.count(0.0, 1e-3)
    out = harness.run(cell(CELLS[0]), SEED, 0.3, True, torch.device("cpu"),
                      0.0, smoke=True, clock=lambda: next(ticks))
    log = out["log"]
    assert out["correct"] and log.trace["busy_s"] == 0.5
    window, traced = log.window_steps(), [s for s in log.steps if s.traced]
    assert window and traced and not any(s.traced for s in window)
    assert window[-1].k < traced[0].k and log.t_w1 <= traced[0].t0
    assert log.traced_calls("decode") and log.window_calls("decode")
    names = [n for n, _, _ in seen["spans"]]
    assert names.count(trace.WINDOW) == 1 and "portbench::decode" in names


def test_sample_has_the_longest_and_is_seeded():
    reqs = [harness.ReqLog(i, 0, 100 + 7 * i % 50, 4 + i % 9, 0.0)
            for i in range(30)]
    a = harness.sample(reqs, 5, 6)
    assert [r.rid for r in a] == [r.rid for r in harness.sample(reqs, 5, 6)]
    assert max(reqs, key=lambda r: r.prompt_len + r.out_len) in a
    assert max(reqs, key=lambda r: r.out_len) in a
    assert len(a) == 6
    assert [r.rid for r in harness.sample(reqs, 6, 6)] != [r.rid for r in a]


def test_pads_are_the_programs_prefill_pads():
    assert harness.pads(3072, 128) == [128, 256, 512, 1024, 2048, 3072]
    assert harness.pads(4096, 128) == [128, 256, 512, 1024, 2048, 4096]
    for L in (128, 129, 2047, 2049, 2944):
        pad = min(max(8, 1 << (L - 1).bit_length()), 3072)
        assert pad in harness.pads(3072, 128)


def test_weights_repeat_and_follow_their_roles():
    from portbench import weights
    leaves = [("a", (64, 32), "in"), ("b", (32, 64), "out"),
              ("n", (64,), "norm"), ("e", (10, 64), "embed")]
    w1 = weights.make(leaves, 4, 2 ** 33 + 1, torch.float32, "cpu")
    w2 = weights.make(leaves, 4, 2 ** 33 + 1, torch.float32, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert abs(float(w1["a"].std()) - 64 ** -0.5) < 0.02
    assert abs(float(w1["b"].std()) - 32 ** -0.5 / 8 ** 0.5) < 0.01
    assert abs(float(w1["n"].mean()) - 1.0) < 0.05
    assert np.isclose(float(w1["e"].std()), 1.0, atol=0.15)
