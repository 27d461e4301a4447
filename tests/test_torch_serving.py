"""Port serving stack (Engine, kvtransfer, PDCluster) against the reference
package: greedy tokens must EQUAL ``repro.models.greedy_generate``'s on the
same weights, and payload sizes must equal the reference's.

Scenarios are those of tests/test_engine.py and tests/test_disagg.py (whose
JAX-engine runs are marked slow); the reference generations are computed
once for the module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro import serving as jserving
from repro.configs import get_config as jget_config
from repro.serving.engine import SamplingParams as JSamplingParams
from repro.serving.engine import sample_token as jsample_token
from repro_torch import models as tm
from repro_torch.configs import get_config
from repro_torch.core import CHIPS, InstanceSpec, TokenScalePolicy, profile
from repro_torch.serving import (Engine, PDCluster, Request, SamplingParams,
                                 TransferStats, extract, insert,
                                 payload_bytes, sample_token)

PROMPT_LENS = (7, 12, 5, 20, 9)     # the PD scenario; the engine's is [:4]
MAX_NEW = 6


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("llama31_8b", smoke=True)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("llama31_8b", smoke=True)
    model = tm.from_jax_params(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=(L,)).astype(np.int32)
               for L in PROMPT_LENS]
    refs = [np.asarray(jm.greedy_generate(
        jcfg, jparams, jnp.asarray(p[None]), jnp.array([len(p)], jnp.int32),
        MAX_NEW)[0]) for p in prompts]
    return cfg, model, jcfg, jparams, prompts, refs


def _run_engine(cfg, model, prompts, **kw):
    eng = Engine(cfg, model, **kw)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_drained()
    return eng, reqs


@pytest.mark.parametrize("kw", [
    dict(num_slots=4, max_len=64),
    dict(num_slots=2, max_len=64),                  # queueing
    dict(num_slots=2, max_len=64, chunk_size=8),    # convertible
], ids=["4slots", "2slots", "convertible"])
def test_engine_tokens_equal_reference(setup, kw):
    cfg, model, _, _, prompts, refs = setup
    eng, reqs = _run_engine(cfg, model, prompts[:4], **kw)
    for r, ref in zip(reqs, refs):
        assert np.array_equal(np.array(r.output), ref), r.rid
    if kw.get("chunk_size"):
        assert eng.mixed_steps > 0


def test_engine_chunk_is_cut_at_the_cache_end(setup):
    """A chunked prompt whose second chunk, padded to the chunk size, would
    run past max_len (a 16-token chunk at offset 16 of a 30-row cache):
    the chunk is cut at the cache's end and the tokens are the reference's
    greedy ones (the reference's own Engine clamps that write onto earlier
    rows)."""
    cfg, model, _, _, prompts, refs = setup
    eng, reqs = _run_engine(cfg, model, [prompts[0], prompts[3]],
                            num_slots=2, max_len=30, chunk_size=16)
    assert eng.mixed_steps == 2
    for r, ref in zip(reqs, [refs[0], refs[3]]):
        assert np.array_equal(np.array(r.output), ref), r.rid


def test_engine_memory_accounting(setup):
    cfg, model, _, _, prompts, _ = setup
    eng = Engine(cfg, model, num_slots=4, max_len=64)
    assert eng.memory_tokens_used() == 0
    r = Request(rid=0, prompt=prompts[0], max_new_tokens=4)
    eng.add_request(r)
    assert eng.memory_tokens_used() == len(prompts[0])
    eng.run_until_drained()
    assert eng.memory_tokens_used() == 0
    assert eng.free_slots() == 4


def test_pd_cluster_tokens_equal_reference(setup):
    cfg, model, _, _, prompts, refs = setup
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
    assert cl.transfers.total_bytes > 0


def test_kv_payload_roundtrip(setup):
    """extract -> insert across two state pools preserves the decode stream
    exactly (the KV transfer contract)."""
    cfg, model, _, _, prompts, refs = setup
    prompt = prompts[1]
    L = len(prompt)
    st_p = tm.init_state(cfg, 1, 64, "cpu")
    logits, st_p = tm.prefill(cfg, model, st_p, prompt[None], [L])
    payload = extract(cfg, st_p, L, slot=0)
    assert payload_bytes(payload) > 0
    eng = Engine(cfg, model, num_slots=4, max_len=64)
    eng.state[0]["k"].fill_(7.0)                 # stale rows must be cleared
    req = Request(rid=0, prompt=prompt, max_new_tokens=MAX_NEW)
    req.slot = eng._alloc_slot(req)
    eng.state = insert(cfg, eng.state, payload, req.slot)
    assert eng.state[0]["k"][req.slot, 128:].eq(0).all()
    first = int(logits[0].argmax())
    eng.last_tokens[req.slot] = first
    eng.cur_lens[req.slot] = L
    req.prefill_done = L
    req.output.append(first)
    eng.run_until_drained()
    assert np.array_equal(np.array(req.output), refs[1])


def test_payload_is_length_trimmed(setup):
    cfg = setup[0]
    st = tm.init_state(cfg, 1, 4096, "meta")
    assert payload_bytes(extract(cfg, st, 10)) \
        < payload_bytes(extract(cfg, st, 3000))


@pytest.mark.parametrize("length", [1, 10, 128, 129, 1000, 3000, 4096])
def test_payload_bytes_equal_reference(setup, length):
    cfg, _, jcfg, _, _, _ = setup
    jst = jm.init_state(jcfg, 2, 4096)
    want = jserving.payload_bytes(jserving.extract(jcfg, jst, length,
                                                   slot=1))
    st = tm.init_state(cfg, 2, 4096, "meta")
    assert payload_bytes(extract(cfg, st, length, slot=1)) == want


def test_full_width_llama_payload_is_128k_per_rounded_token():
    """32 layers x 2 x Hkv 8 x D 128 x 2 B = 131072 B per token, over the
    length rounded up to 128 (shapes only: the state lives on `meta`)."""
    cfg = get_config("llama31_8b")
    st = tm.init_state(cfg, 1, 2048, "meta")
    for L in (1, 64, 700, 1536):
        n = max(-(-L // 128) * 128, 8)
        assert payload_bytes(extract(cfg, st, L)) == 131072 * n


def test_transfer_stats_velocity():
    s = TransferStats()
    s.record(nbytes=131072 * 100, tokens=100, wall_s=0.01)
    assert s.bytes_per_token() == pytest.approx(131072)
    assert s.measured_network_velocity(50e9) == pytest.approx(
        50e9 / 131072, rel=1e-6)


@pytest.mark.parametrize("sp", [
    dict(), dict(temperature=0.8, seed=3),
    dict(temperature=1.0, top_k=5, seed=1),
    dict(temperature=0.7, top_p=0.9, seed=2),
])
def test_sampling_matches_reference(sp):
    """Same logits, same per-request seeding -> the same sampled stream."""
    rng = np.random.RandomState(4)
    logits = rng.randn(6, 64).astype(np.float32) * 3
    jrng = Request(rid=5, prompt=np.zeros(1, np.int32), max_new_tokens=1,
                   sampling=SamplingParams(**sp))._rng
    trng = np.random.RandomState(
        (SamplingParams(**sp).seed * 1009 + 5) % (2 ** 31 - 1))
    got = [sample_token(row, SamplingParams(**sp), jrng) for row in logits]
    want = [jsample_token(row, JSamplingParams(**sp), trng)
            for row in logits]
    assert got == want


def test_state_lives_on_the_params_device(setup):
    cfg, model = setup[0], setup[1]
    eng = Engine(cfg, model, num_slots=2, max_len=16)
    assert eng.device == torch.device("cpu")
    assert all(t.device == eng.device for layer in eng.state
               for t in layer.values())
