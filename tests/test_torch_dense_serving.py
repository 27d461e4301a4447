"""The port's serving stack on the dense family's two new cache shapes
against the reference package: Gemma-2's window-alternating layers with
prompts past the window, and Llama-3.1-8B with the int8 KV cache.  Greedy
tokens of ``Engine`` and ``PDCluster`` EQUAL ``repro.models.greedy_generate``'s
on the same weights; payload sizes equal the reference's (int8 values with
their f32 scales; Gemma's head dim of 256).  The reference generations are
computed once for the module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import models as jm
from repro import serving as jserving
from repro.configs import get_config as jget_config
from repro_torch import models as tm
from repro_torch.configs import get_config
from repro_torch.core import CHIPS, InstanceSpec, TokenScalePolicy, profile
from repro_torch.launch import serve
from repro_torch.serving import (Engine, PDCluster, Request, SamplingParams,
                                 extract, insert, payload_bytes)

MAX_NEW = 6
# gemma2 SMOKE's window is 64: three of its prompts run past it
# id: arch, config override, prompt lengths, max_len, convertible chunk
CASES = {"gemma2-window": ("gemma2_9b", {}, (70, 12, 90, 66), 112, 32),
         "llama-int8": ("llama31_8b", {"kv_cache_dtype": "int8"},
                        (7, 12, 5, 20, 9), 64, 8)}


@pytest.fixture(scope="module", params=list(CASES))
def setup(request):
    arch, over, lens, max_len, chunk = CASES[request.param]
    jcfg = jget_config(arch, smoke=True).replace(**over)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config(arch, smoke=True).replace(**over)
    model = tm.from_jax_params(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=(L,)).astype(np.int32)
               for L in lens]
    # one batched reference run (rows padded to the longest prompt)
    toks = np.zeros((len(lens), max(lens)), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    refs = np.asarray(jm.greedy_generate(
        jcfg, jparams, jnp.asarray(toks), jnp.asarray(lens, jnp.int32),
        MAX_NEW))
    return arch, cfg, model, jcfg, prompts, refs, max_len, chunk


@pytest.mark.parametrize("convertible", [False, True],
                         ids=["4slots", "convertible"])
def test_engine_tokens_equal_reference(setup, convertible):
    """With 2 slots and chunks of 32, gemma2's long prompts' chunks past
    position 64 meet its window; int8 chunks read back the quantised
    prefix."""
    _, cfg, model, _, prompts, refs, max_len, chunk = setup
    kw = dict(num_slots=2, chunk_size=chunk) if convertible \
        else dict(num_slots=4)
    eng = Engine(cfg, model, max_len=max_len, **kw)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_drained()
    for r, ref in zip(reqs, refs):
        assert np.array_equal(np.array(r.output), ref), r.rid
    if convertible:
        assert eng.mixed_steps > 0


def test_pd_cluster_tokens_equal_reference(setup):
    arch, cfg, model, _, prompts, refs, max_len, chunk = setup
    prof = profile(get_config(arch), InstanceSpec(CHIPS["h100"], 1))
    cl = PDCluster(cfg, model, TokenScalePolicy(prof, convertible=1),
                   n_prefillers=1, n_decoders=1, n_convertible=1,
                   max_len=max_len, chunk_size=chunk)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        cl.submit(r)
    cl.run_until_drained()
    for r, ref in zip(reqs, refs):
        assert np.array_equal(np.array(r.output), ref), r.rid
    assert cl.transfers.n_transfers >= 1


def test_payload_crosses_whole(setup):
    """extract -> insert into another slot keeps every leaf (the int8
    scales too) bit for bit, and zeroes the rows past the payload."""
    _, cfg, model, _, prompts, _, max_len, _ = setup
    p = prompts[2]
    st = tm.init_state(cfg, 1, max_len, "cpu")
    tm.prefill(cfg, model, st, p[None], [len(p)])
    payload = extract(cfg, st, len(p))
    pool = tm.init_state(cfg, 3, max_len, "cpu")
    for layer in pool:
        for leaf in layer.values():
            leaf.fill_(3)
    insert(cfg, pool, payload, 1)
    n = min(max(-(-len(p) // 128) * 128, 8), max_len)
    for one, layer in zip(st, pool):
        assert set(one) == set(layer)
        for key, leaf in layer.items():
            assert leaf.dtype == one[key].dtype
            assert leaf[1, :n].equal(one[key][0, :n]), key
            assert leaf[1, n:].eq(0).all() and leaf[0].eq(3).all(), key


@pytest.mark.parametrize("length", [1, 10, 128, 129, 1000])
def test_payload_bytes_equal_reference(setup, length):
    arch, cfg, _, jcfg = setup[:4]
    if arch == "gemma2_9b":        # SMOKE widths at Gemma's head dim of 256
        over = dict(head_dim=256, query_scale=1.0 / 16.0)
        cfg, jcfg = cfg.replace(**over), jcfg.replace(**over)
    jst = jm.init_state(jcfg, 2, 1024)
    want = jserving.payload_bytes(jserving.extract(jcfg, jst, length,
                                                   slot=1))
    st = tm.init_state(cfg, 2, 1024, "meta")
    assert payload_bytes(extract(cfg, st, length, slot=1)) == want


def test_full_width_gemma2_payload_is_344064_per_rounded_token():
    """42 layers x 2 x Hkv 8 x D 256 x 2 B = 344,064 B per token, over the
    length rounded up to 128 (shapes only: the state lives on `meta`)."""
    cfg = get_config("gemma2_9b")
    st = tm.init_state(cfg, 1, 5120, "meta")
    for L in (1, 64, 700, 4096, 4700):
        n = max(-(-L // 128) * 128, 8)
        assert payload_bytes(extract(cfg, st, L)) == 344_064 * n


def test_int8_payload_is_values_plus_scales():
    """Llama-3.1-8B with the int8 cache: per token 32 layers x 2 x Hkv 8 x
    (D 128 B of values + 4 B of scale) = 67,584 B, about half the bf16
    cache's 131,072 B."""
    cfg = get_config("llama31_8b").replace(kv_cache_dtype="int8")
    st = tm.init_state(cfg, 1, 2048, "meta")
    assert payload_bytes(extract(cfg, st, 700)) == 67_584 * 768


@pytest.mark.parametrize("arch", ["gemma2-9b", "gemma-2b", "yi-9b",
                                  "qwen2-0.5b", "musicgen-large"])
def test_serve_launcher_takes_the_new_configs(arch, capsys):
    serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                "--max-new", "4"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"completed": 3' in out and '"device": "cpu"' in out


def test_sampled_stream_is_reproducible_and_equals_reference():
    """The twin of tests/test_paged_and_sampling.py's
    test_engine_sampled_generation_reproducible on qwen2_0_5b SMOKE: the
    same sampling seed gives the same stochastic stream twice, and it is
    the reference engine's stream on the same weights."""
    from repro.serving import Engine as JEngine
    from repro.serving import Request as JRequest
    from repro.serving.engine import SamplingParams as JSamplingParams
    jcfg = jget_config("qwen2_0_5b", smoke=True)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("qwen2_0_5b", smoke=True)
    model = tm.from_jax_params(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    prompt = np.random.RandomState(3).randint(0, cfg.vocab_size, size=(9,)) \
        .astype(np.int32)
    sp = dict(temperature=0.8, top_k=20, seed=42)
    outs = []
    for _ in range(2):
        eng = Engine(cfg, model, num_slots=1, max_len=48)
        r = Request(rid=0, prompt=prompt, max_new_tokens=6,
                    sampling=SamplingParams(**sp))
        eng.add_request(r)
        eng.run_until_drained()
        outs.append(list(r.output))
    assert outs[0] == outs[1]
    jeng = JEngine(jcfg, jparams, num_slots=1, max_len=48)
    jr = JRequest(rid=0, prompt=prompt, max_new_tokens=6,
                  sampling=JSamplingParams(**sp))
    jeng.add_request(jr)
    jeng.run_until_drained()
    assert outs[0] == [int(t) for t in jr.output]
