"""The dense-attention family in the port against the reference package.

The dense attention configs the port gained beside the paper's two
(Gemma-2-9B with its local/global layers and softcaps, Gemma-2B's MQA,
Yi-9B, Qwen2-0.5B's bias and tied embeddings, MusicGen-Large's MHA) run at
their SMOKE size on the reference's weights, carried across by
``from_jax_params``.  Logits must agree within the reference's model
tolerance, 2e-4: prefill and three decode steps, Gemma-2 prompts past its
64-token window, and Llama-3.1-8B with the int8 KV cache.
``forward_train`` is in test_torch_dense_train.py, head dim 256 in
test_torch_head_dim_256.py, the serving stack in test_torch_dense_serving.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_config as jget_config
from repro_torch import models as tm
from repro_torch.configs import get_config

NEW = ["gemma2_9b", "gemma_2b", "yi_9b", "qwen2_0_5b", "musicgen_large"]
TOL = 2e-4


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def _pair(arch, **over):
    jcfg = jget_config(arch, smoke=True).replace(**over)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config(arch, smoke=True).replace(**over)
    model = tm.from_jax_params(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return cfg, model, jcfg, jparams


def _prefill_decode(cfg, model, jcfg, jparams, toks, lens, max_len, steps=3):
    """Prefill then `steps` greedy decode steps on both sides, logits
    compared at each; returns both final states."""
    jst = jm.init_state(jcfg, toks.shape[0], max_len)
    jl, jst = jm.prefill(jcfg, jparams, jst, jnp.asarray(toks),
                         jnp.asarray(lens))
    tst = tm.init_state(cfg, toks.shape[0], max_len, "cpu")
    tl, tst = tm.prefill(cfg, model, tst, toks, lens)
    _close(tl, jl)
    cur = lens.copy()
    last = np.asarray(jnp.argmax(jl, -1), np.int32)
    for _ in range(steps):
        jl, jst = jm.decode_step(jcfg, jparams, jst, jnp.asarray(last),
                                 jnp.asarray(cur))
        tl, tst = tm.decode_step(cfg, model, tst, last, cur)
        _close(tl, jl)
        last = np.asarray(jnp.argmax(jl, -1), np.int32)
        cur = cur + 1
    return jst, tst


@pytest.mark.parametrize("arch", NEW)
def test_prefill_then_decode_logits_match(arch):
    cfg, model, jcfg, jparams = _pair(arch)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    _prefill_decode(cfg, model, jcfg, jparams, toks,
                    np.array([16, 9], np.int32), 40)


def test_gemma2_prompts_past_the_window():
    """gemma2 SMOKE has a 64-token window on its local layers: prompts of
    70 and 90 tokens, three decode steps, and the same prompt prefilled in
    chunks of 32 (the chunks past position 64 meet the window)."""
    cfg, model, jcfg, jparams = _pair("gemma2_9b")
    assert cfg.sliding_window == 64
    assert [layer.window for layer in model.layers] == [64, 0]
    rng = np.random.RandomState(5)
    toks = rng.randint(0, cfg.vocab_size, size=(2, 90)).astype(np.int32)
    _prefill_decode(cfg, model, jcfg, jparams, toks,
                    np.array([90, 70], np.int32), 100)
    prompt = toks[:1]
    jst = jm.init_state(jcfg, 1, 100)
    tst = tm.init_state(cfg, 1, 100, "cpu")
    for a in range(0, 90, 32):
        b = min(a + 32, 90)
        piece = np.zeros((1, 32), np.int32)
        piece[0, :b - a] = prompt[0, a:b]
        jl, jst = jm.prefill(jcfg, jparams, jst, jnp.asarray(piece),
                             jnp.array([b], jnp.int32),
                             start=jnp.array([a], jnp.int32))
        tl, tst = tm.prefill(cfg, model, tst, piece, [b], start=[a])
        _close(tl, jl)


def test_int8_kv_cache_matches_reference():
    """llama31_8b SMOKE with kv_cache_dtype="int8": int8 values and f32
    per-(token, head) scales, quantised as the reference does (the int8
    caches equal; the scales, an absmax of k or v, within the f32 noise of
    their inputs), logits within 2e-4 of the reference's int8 path through
    prefill and three decode steps."""
    cfg, model, jcfg, jparams = _pair("llama31_8b", kv_cache_dtype="int8")
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    jst, tst = _prefill_decode(cfg, model, jcfg, jparams, toks,
                               np.array([16, 9], np.int32), 40)
    for i, layer in enumerate(tst):
        assert layer["k"].dtype == torch.int8
        assert layer["k_scale"].shape == layer["k"].shape[:3]
        for name in ("k", "v"):
            jl = jst["blocks"]["p0"]
            assert np.array_equal(layer[name].numpy(),
                                  np.asarray(jl[name][i]))
            np.testing.assert_allclose(layer[f"{name}_scale"].numpy(),
                                       np.asarray(jl[f"{name}_scale"][i]),
                                       rtol=1e-5, atol=0)


def test_quant_kv_matches_reference():
    from repro.models.ops import _quant_kv as jquant
    from repro_torch.models.ops import _quant_kv
    x = np.random.RandomState(6).randn(2, 5, 3, 64).astype(np.float32)
    x[0, 0, 0] = 0.0                          # absmax 0: the 1e-8 floor
    x[1, 1, 1, :2] = [127.5 / 127, -0.5 / 127]    # halves round to even
    x[1, 1, 1, 2:] = 0.0
    q, s = _quant_kv(torch.from_numpy(x))
    jq, js = jquant(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7, atol=0)
