"""The port's twins of the reference's three examples, on the CPU: their
simulator parts print what the reference's print (at the same chip), and
their engines serve the smoke model's greedy tokens."""
import ast
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import CHIPS as JCHIPS
from repro.core import InstanceSpec as JInstanceSpec
from repro.core import plan_convertible as jplan
from repro.core import profile as jprofile
from repro.sim import compare_policies as jcompare_policies
from repro_torch.configs import get_config
from repro_torch.examples import burst_absorption, pd_disaggregated, \
    quickstart
from repro_torch.models import greedy_generate, init_params

ROOT = Path(__file__).resolve().parents[1]


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _greedy(cfg, params, prompt, new):
    return greedy_generate(cfg, params, torch.as_tensor(prompt)[None],
                           [len(prompt)], new)[0].tolist()


@pytest.mark.parametrize("engine", ["fluid", "events"])
def test_burst_absorption_equals_reference(engine):
    ref = _reference_example("burst_absorption")
    for name, n_conv in [("tokenscale", 1), ("tokenscale", 0),
                         ("blitzscale", 0), ("distserve", 0),
                         ("aibrix", 0)]:
        rep, p99 = burst_absorption.run(name, n_conv, engine)
        want, want_p99 = ref.run(name, n_conv, engine)
        assert rep.summary() == want.summary() and p99 == want_p99, name


def test_quickstart_prints_the_reference_figures(capsys):
    """Steps 1, 2 and 4 print the reference's figures for an H100 TP-4
    instance; step 3's engine gives greedy tokens."""
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    cfg_full = jget_config("llama-3.1-8b")
    inst = JInstanceSpec(JCHIPS["h100"], tp=4)
    prof = jprofile(cfg_full, inst)
    conv = jplan(cfg_full, inst, expected_decode_batch=32, avg_ctx=1200.0,
                 burst_ratio=0.2, max_decoders=8)
    assert out[0] == (f"V_P = {prof.v_prefill:,.0f} tok/s   "
                      f"V_N = {prof.v_network:,.0f} tok/s")
    assert f"convertible: chunk={conv.chunk_size} tokens, " \
        f"V_D^P'={conv.v_prefill:,.0f} tok/s" in "\n".join(out)
    want = [f"  {name:12s} SLO={rep.slo_attainment() * 100:5.1f}%  "
            f"avg_gpus={rep.avg_gpus():.2f}" for name, rep in
            jcompare_policies("mixed", duration=60.0, rps=8.0).items()]
    assert out[-len(want):] == want
    outputs = ast.literal_eval(next(
        line for line in out if line.startswith("engine outputs:")
    ).split(":", 1)[1].strip())
    cfg = get_config("llama-3.1-8b", smoke=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.RandomState(0)
    for i, L in enumerate([5, 7, 40]):
        prompt = rng.randint(0, cfg.vocab_size, size=(L,)).astype(np.int32)
        assert outputs[i] == _greedy(cfg, params, prompt, 8)[:4]


def test_pd_disaggregated_serves_greedy_tokens_on_cpu():
    """Greedy tokens (greedy_generate is held to the reference's by the
    model tests), and the transfers the reference's kvtransfer would make
    of the same prompts: their count, tokens and bytes."""
    from repro.models import init_state as jinit_state
    from repro.serving import kvtransfer as jkvtransfer
    cl, reqs = pd_disaggregated.serve("cpu")
    cfg = get_config("llama-3.1-8b", smoke=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert len(reqs) == 6 and cl.transfers.n_transfers == 6
    for r in reqs:
        assert r.output == _greedy(cfg, params, r.prompt, r.max_new_tokens)
    jcfg = jget_config("llama-3.1-8b", smoke=True)
    jstate = jinit_state(jcfg, 1, cl.max_len)
    assert cl.transfers.total_tokens == sum(len(r.prompt) for r in reqs)
    assert cl.transfers.total_bytes == sum(
        jkvtransfer.payload_bytes(jkvtransfer.extract(jcfg, jstate,
                                                      len(r.prompt)))
        for r in reqs)


@pytest.mark.parametrize("engine", ["fluid", "events"])
def test_pd_disaggregated_crosscheck_equals_reference(engine, capsys):
    ref = _reference_example("pd_disaggregated")
    pd_disaggregated.sim_crosscheck(engine)
    mine = capsys.readouterr().out
    ref.sim_crosscheck(engine)
    assert mine == capsys.readouterr().out and "SLO" in mine


def test_pd_disaggregated_main_takes_device_and_engine(capsys):
    pd_disaggregated.main(["--device", "cpu", "--engine=events"])
    out = capsys.readouterr().out
    assert "completed 6/6 requests" in out
    assert "[events sim cross-check]" in out
    with pytest.raises(ValueError, match="unknown engine"):
        pd_disaggregated.parse_args(["--engine=nope"])
