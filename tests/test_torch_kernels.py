"""Port kernels' CPU path (the plain PyTorch versions behind the wrappers)
against the reference package's kernels, on the same numpy inputs.

The reference runs its Pallas kernels in interpret mode on the CPU, as
tests/test_kernels.py does.  Tolerances are the reference's own: 2e-5 in
f32, 3e-2 in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops

SWEEP = [
    # B, Sq, Skv, Hq, Hkv, D, window, softcap
    (1, 8, 8, 1, 1, 16, 0, 0.0),
    (2, 24, 40, 4, 2, 64, 0, 0.0),
    (2, 24, 40, 4, 2, 64, 16, 0.0),
    (2, 24, 40, 4, 2, 64, 0, 30.0),
    (1, 128, 128, 8, 8, 32, 0, 0.0),     # MHA
    (3, 17, 33, 6, 1, 64, 0, 0.0),       # MQA, ragged sizes
    (1, 256, 384, 2, 2, 128, 64, 50.0),  # gemma2-style local+softcap
    (2, 9, 40, 10, 2, 64, 0, 0.0),       # qwen-style group of 5
]

DECODE_SWEEP = [
    # B, L, Hq, Hkv, D, window, softcap
    (1, 16, 1, 1, 16, 0, 0.0),
    (2, 64, 8, 2, 64, 0, 0.0),
    (2, 64, 8, 2, 64, 16, 0.0),
    (2, 64, 8, 2, 64, 0, 30.0),
    (4, 129, 4, 1, 128, 0, 0.0),     # non-multiple cache length, MQA
    (1, 512, 16, 16, 64, 0, 0.0),    # MHA long-ish
    (3, 96, 10, 2, 128, 0, 50.0),    # qwen-style group of 5
]


def _prefill_inputs(B, Sq, Skv, Hq, Hkv, D, window, seed):
    """Random q/k/v and per-row offsets/lengths.  With a window, lengths
    cover every query row, so no row is left without a visible key (the
    reference's Pallas kernel and oracle disagree on such rows)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Sq, Hq, D).astype(np.float32)
    k = rng.randn(B, Skv, Hkv, D).astype(np.float32)
    v = rng.randn(B, Skv, Hkv, D).astype(np.float32)
    off = rng.randint(0, Skv - Sq + 1, size=(B,)).astype(np.int32)
    lo = off + Sq if window else np.ones(B, np.int32)
    lens = np.array([rng.randint(a, Skv + 1) for a in lo], np.int32)
    return q, k, v, off, lens


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,window,cap", SWEEP)
def test_prefill_attention_matches_reference(B, Sq, Skv, Hq, Hkv, D, window,
                                             cap):
    q, k, v, off, lens = _prefill_inputs(B, Sq, Skv, Hq, Hkv, D, window,
                                         seed=B * 100 + Sq)
    out = tops.prefill_attention(_t(q), _t(k), _t(v), _t(off), _t(lens),
                                 window=window, softcap=cap)
    jargs = [jnp.asarray(a) for a in (q, k, v, off, lens)]
    want = jops.prefill_attention(*jargs, window=window, softcap=cap)
    oracle = jref.chunked_prefill_attention_ref(*jargs, window=window,
                                                softcap=cap)
    np.testing.assert_allclose(out.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle),
                               atol=2e-5, rtol=2e-5)


def test_prefill_attention_bf16_matches_reference():
    B, Sq, Skv, Hq, Hkv, D = 2, 16, 32, 4, 2, 64
    q, k, v, _, _ = _prefill_inputs(B, Sq, Skv, Hq, Hkv, D, 0, seed=5)
    off = np.zeros((B,), np.int32)
    lens = np.full((B,), Skv, np.int32)
    out = tops.prefill_attention(*(_t(a).bfloat16() for a in (q, k, v)),
                                 _t(off), _t(lens))
    want = jops.prefill_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        jnp.asarray(off), jnp.asarray(lens))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=3e-2, rtol=3e-2)


def test_prefill_attention_row_without_visible_key():
    """A windowed row past every valid key softmaxes to the uniform average
    over all keys, as the reference oracle does (the kernel copies this)."""
    q, k, v, _, _ = _prefill_inputs(1, 8, 24, 2, 1, 16, 0, seed=9)
    off = np.array([12], np.int32)
    lens = np.array([3], np.int32)
    out = tops.prefill_attention(_t(q), _t(k), _t(v), _t(off), _t(lens),
                                 window=4)
    want = jref.chunked_prefill_attention_ref(
        *(jnp.asarray(a) for a in (q, k, v, off, lens)), window=4)
    np.testing.assert_allclose(out.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)
    mean_v = v.mean(axis=1)                                # (1, Hkv, D)
    np.testing.assert_allclose(out.numpy()[0, -1, 0], mean_v[0, 0],
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,L,Hq,Hkv,D,window,cap", DECODE_SWEEP)
def test_decode_attention_matches_reference(B, L, Hq, Hkv, D, window, cap):
    rng = np.random.RandomState(B * 1000 + L)
    q = rng.randn(B, Hq, D).astype(np.float32)
    k = rng.randn(B, L, Hkv, D).astype(np.float32)
    v = rng.randn(B, L, Hkv, D).astype(np.float32)
    cur = rng.randint(0, L, size=(B,)).astype(np.int32)
    cur[0] = 0
    out = tops.decode_attention_op(_t(q), _t(k), _t(v), _t(cur),
                                   window=window, softcap=cap)
    jargs = [jnp.asarray(a) for a in (q, k, v, cur)]
    want = jops.decode_attention_op(*jargs, window=window, softcap=cap,
                                    block_k=32)
    oracle = jref.decode_attention_ref(*jargs, window=window, softcap=cap)
    np.testing.assert_allclose(out.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle),
                               atol=2e-5, rtol=2e-5)


def test_decode_attention_ignores_dead_region():
    """NaN past cur_len must never reach the result (the reference's
    block-skipping check, tests/test_kernels.py)."""
    B, L, H, D = 1, 64, 2, 32
    rng = np.random.RandomState(3)
    q = rng.randn(B, H, D).astype(np.float32)
    k = rng.randn(B, L, H, D).astype(np.float32)
    v = rng.randn(B, L, H, D).astype(np.float32)
    cur = np.array([10], np.int32)
    want = jops.decode_attention_op(*(jnp.asarray(a) for a in (q, k, v, cur)),
                                    block_k=16)
    k2, v2 = k.copy(), v.copy()
    k2[:, 11:] = np.nan
    v2[:, 11:] = np.nan
    out = tops.decode_attention_op(_t(q), _t(k2), _t(v2), _t(cur))
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


def test_cpu_path_launches_no_kernel():
    tops.reset_launches()
    q = torch.randn(1, 4, 2, 16)
    kv = torch.randn(1, 8, 2, 16)
    tops.prefill_attention(q, kv, kv, torch.zeros(1), torch.full((1,), 8))
    tops.decode_attention_op(q[:, 0], kv, kv, torch.tensor([3]))
    assert tops.LAUNCHES == {"chunked_prefill_attention": 0,
                             "decode_attention": 0}


def test_wrappers_refuse_devices_without_a_kernel():
    q = torch.empty(1, 4, 2, 16, device="meta")
    kv = torch.empty(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tops.prefill_attention(q, kv, kv, torch.zeros(1), torch.ones(1))
    with pytest.raises(ValueError, match="no kernel"):
        tops.decode_attention_op(q[:, 0], kv, kv, torch.zeros(1))
