"""The port's serving stack on RWKV-6 against the reference package: greedy
tokens EQUAL ``repro.models.greedy_generate``'s on the same weights, the
recurrent state crosses the PD transfer whole, and payload sizes equal the
reference's.

Weights are the reference's rwkv6 SMOKE parameters with seeded noise on the
zero-initialised lora outputs (test_torch_rwkv.py); the reference
generations are computed once for the module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro import serving as jserving
from repro.configs import get_config as jget_config
from repro_torch import models as tm
from repro_torch.configs import get_config
from repro_torch.core import CHIPS, InstanceSpec, TokenScalePolicy, profile
from repro_torch.launch import serve
from repro_torch.serving import (Engine, PDCluster, Request, extract, insert,
                                 payload_bytes)
from test_torch_rwkv import noisy_reference_params

ARCH = "rwkv6_3b"
PROMPT_LENS = (7, 12, 5, 20, 9)     # the PD scenario; the engine's is [:4]
MAX_NEW = 6


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config(ARCH, smoke=True)
    tree = noisy_reference_params(jcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    cfg = get_config(ARCH, smoke=True)
    model = tm.from_jax_params(cfg, tree, device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=(L,)).astype(np.int32)
               for L in PROMPT_LENS]
    refs = [np.asarray(jm.greedy_generate(
        jcfg, jparams, jnp.asarray(p[None]), jnp.array([len(p)], jnp.int32),
        MAX_NEW)[0]) for p in prompts]
    return cfg, model, prompts, refs


@pytest.mark.parametrize("kw", [
    dict(num_slots=4, max_len=64),
    dict(num_slots=2, max_len=64),                  # queueing
    dict(num_slots=2, max_len=64, chunk_size=8),    # convertible
], ids=["4slots", "2slots", "convertible"])
def test_engine_tokens_equal_reference(setup, kw):
    """With 2 slots and chunk 8 the 20-token prompt is chunked into a slot
    that an earlier request used: its first chunk must start from a zeroed
    recurrent state."""
    cfg, model, prompts, refs = setup
    eng = Engine(cfg, model, **kw)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(prompts[:4])]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_drained()
    for r, ref in zip(reqs, refs):
        assert np.array_equal(np.array(r.output), ref), r.rid
    if kw.get("chunk_size"):
        assert eng.mixed_steps > 0


def test_pd_cluster_tokens_equal_reference(setup):
    cfg, model, prompts, refs = setup
    prof = profile(get_config("llama31_8b"), InstanceSpec(CHIPS["h100"], 1))
    cl = PDCluster(cfg, model, TokenScalePolicy(prof, convertible=1),
                   n_prefillers=1, n_decoders=1, n_convertible=1,
                   max_len=96)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        cl.submit(r)
    cl.run_until_drained()
    for r, ref in zip(reqs, refs):
        assert np.array_equal(np.array(r.output), ref), r.rid
    assert cl.transfers.n_transfers >= 1
    per_request = payload_bytes(extract(cfg, tm.init_state(cfg, 1, 96,
                                                           "meta"), 1))
    assert cl.transfers.total_bytes == per_request * cl.transfers.n_transfers


def test_recurrent_state_crosses_the_transfer_whole(setup):
    """extract -> insert into ANOTHER slot of a pool leaves wkv, shift_t and
    shift_c bit-equal to the source, and decoding continues with the
    reference's tokens (a trimmed or re-zeroed state would diverge)."""
    cfg, model, prompts, refs = setup
    prompt = prompts[3]                               # 20 tokens
    L = len(prompt)
    st_p = tm.init_state(cfg, 2, 64, "cpu")
    toks = np.zeros((2, 32), np.int32)
    toks[1, :L] = prompt
    logits, st_p = tm.prefill(cfg, model, st_p, toks, [1, L])
    payload = extract(cfg, st_p, L, slot=1)
    eng = Engine(cfg, model, num_slots=4, max_len=64)
    for layer in eng.state:                          # stale state everywhere
        for t in layer.values():
            t.fill_(3.0)
    req = Request(rid=0, prompt=prompt, max_new_tokens=MAX_NEW)
    eng._alloc_slot(req)
    req.slot = eng._alloc_slot(req)                  # slot 1 of the pool
    eng.active[0] = False
    eng.slot_req[0] = None
    eng.state = insert(cfg, eng.state, payload, req.slot)
    for src, dst in zip(st_p, eng.state):
        for key in ("wkv", "shift_t", "shift_c"):
            assert torch.equal(dst[key][req.slot], src[key][1]), key
    first = int(logits[1].argmax())
    eng.last_tokens[req.slot] = first
    eng.cur_lens[req.slot] = L
    req.prefill_done = L
    req.output.append(first)
    eng.run_until_drained()
    assert np.array_equal(np.array(req.output), refs[3])


@pytest.mark.parametrize("arch", [ARCH, "llama31_8b"])
@pytest.mark.parametrize("length", [10, 2000])
def test_payload_bytes_equal_reference(arch, length):
    jcfg = jget_config(arch, smoke=True)
    jst = jm.init_state(jcfg, 2, 2048)
    want = jserving.payload_bytes(jserving.extract(jcfg, jst, length,
                                                   slot=1))
    cfg = get_config(arch, smoke=True)
    st = tm.init_state(cfg, 2, 2048, "meta")
    assert payload_bytes(extract(cfg, st, length, slot=1)) == want


def test_full_width_rwkv_payload_does_not_grow_with_the_prompt():
    """32 layers x (40 x 64 x 64 x 4 B of WKV state + 2 x 2560 x 2 B of
    token shift) = 21,299,200 B at every length (shapes only: the state
    lives on `meta`); a Llama-3.1-8B request of 1024 tokens ships
    134,217,728 B."""
    cfg = get_config(ARCH)
    assert cfg.dtype == "bfloat16"
    st = tm.init_state(cfg, 1, 2048, "meta")
    for L in (1, 64, 700, 1536, 2048):
        assert payload_bytes(extract(cfg, st, L)) == 21_299_200
    llama = get_config("llama31_8b")
    assert payload_bytes(extract(llama, tm.init_state(llama, 1, 2048, "meta"),
                                 1024)) == 134_217_728


def test_serve_cli_runs_rwkv(capsys):
    serve.main(["--arch", "rwkv6-3b", "--requests", "3", "--max-new", "4",
                "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"arch": "rwkv6-smoke"' in out and '"completed": 3' in out
