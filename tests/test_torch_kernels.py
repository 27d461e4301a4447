"""Port kernels' CPU path (the plain PyTorch versions behind the wrappers)
against the reference package's kernels, on the same numpy inputs.

The reference runs its Pallas kernels in interpret mode on the CPU, as
tests/test_kernels.py does.  Tolerances are the reference's own: 2e-5 in
f32, 3e-2 in bf16, 2e-4 for WKV6 (1e-4 for its zero-key property).  The
paged kernel's plain version is tested in test_torch_paged.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

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
    tops.decode_attention_partial(q[:, 0], kv, kv, torch.tensor([11]), 4)
    tops.paged_decode_attention(q[:, 0], kv[0, None], kv[0, None],
                                torch.zeros(1, 1), torch.tensor([3]))
    x = torch.rand(1, 8, 2, 16)
    tops.wkv6_op(x, x, x, x, torch.rand(2, 16), torch.zeros(1, 2, 16, 16))
    assert tops.LAUNCHES == {"chunked_prefill_attention": 0,
                             "decode_attention": 0,
                             "decode_attention_partial": 0,
                             "paged_decode_attention": 0, "wkv6": 0}


def test_wrappers_refuse_devices_without_a_kernel():
    q = torch.empty(1, 4, 2, 16, device="meta")
    kv = torch.empty(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tops.prefill_attention(q, kv, kv, torch.zeros(1), torch.ones(1))
    with pytest.raises(ValueError, match="no kernel"):
        tops.decode_attention_op(q[:, 0], kv, kv, torch.zeros(1))
    with pytest.raises(ValueError, match="no kernel"):
        tops.paged_decode_attention(q[:, 0], kv, kv, torch.zeros(1, 1),
                                    torch.zeros(1))
    with pytest.raises(ValueError, match="no kernel"):
        tops.wkv6_op(q, q, q, q, torch.empty(2, 16, device="meta"),
                     torch.empty(1, 2, 16, 16, device="meta"))


# ---------------------------------------------------------------------------
# WKV6: the plain chunked version against the Pallas kernel and the oracle
# ---------------------------------------------------------------------------

def _wkv_inputs(B, S, H, K, seed=0):
    """tests/test_kernels.py's inputs: (B,S,H,K) r, k, v, w in (0, 1),
    u (H,K), s0 (B,H,K,K)."""
    rng = np.random.RandomState(seed)
    r = rng.randn(B, S, H, K).astype(np.float32)
    k = rng.randn(B, S, H, K).astype(np.float32)
    v = rng.randn(B, S, H, K).astype(np.float32)
    w = np.exp(-np.exp(rng.randn(B, S, H, K).astype(np.float32) * 0.5 - 1))
    u = rng.randn(H, K).astype(np.float32)
    s0 = rng.randn(B, H, K, K).astype(np.float32)
    return r, k, v, w, u, s0


def _bhsk(a):
    return np.asarray(a).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("B,S,H,K,chunk", [
    (1, 16, 1, 8, 16),
    (2, 37, 2, 16, 16),      # padded tail
    (1, 64, 4, 32, 32),
    (2, 16, 2, 64, 8),
])
def test_wkv6_matches_reference(B, S, H, K, chunk):
    args = _wkv_inputs(B, S, H, K, seed=B * 100 + S)
    y, sT = tops.wkv6_op(*map(_t, args), chunk=chunk)
    jargs = [jnp.asarray(a) for a in args]
    jy, jsT = jops.wkv6_op(*jargs, chunk=chunk)
    r, k, v, w, u, s0 = args
    oy, osT = jref.wkv6_ref(*(jnp.asarray(_bhsk(a)) for a in (r, k, v, w)),
                            jnp.asarray(u), jnp.asarray(s0))
    for got, want in ((y, jy), (sT, jsT), (y, _bhsk(oy)), (sT, osT)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-4, rtol=2e-4)


def test_wkv6_oracles_agree():
    """The port's own sequential oracle (kernels/ref.py wkv6_ref) equals
    the reference's on the padded-tail case."""
    r, k, v, w, u, s0 = _wkv_inputs(2, 37, 2, 16, seed=237)
    got = tref.wkv6_ref(*(_t(_bhsk(a)) for a in (r, k, v, w)), _t(u), _t(s0))
    want = jref.wkv6_ref(*(jnp.asarray(_bhsk(a)) for a in (r, k, v, w)),
                         jnp.asarray(u), jnp.asarray(s0))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4,
                                   rtol=2e-4)


def test_wkv6_state_carry_composes():
    """Two halves with the state carried == the whole sequence (the
    chunked-prefill invariant for recurrent layers)."""
    r, k, v, w, u, s0 = map(_t, _wkv_inputs(1, 32, 2, 16, seed=7))
    y_full, sT_full = tops.wkv6_op(r, k, v, w, u, s0)
    y1, s_mid = tops.wkv6_op(r[:, :16], k[:, :16], v[:, :16], w[:, :16], u,
                             s0)
    y2, sT = tops.wkv6_op(r[:, 16:], k[:, 16:], v[:, 16:], w[:, 16:], u,
                          s_mid)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(sT.numpy(), sT_full.numpy(), atol=2e-4,
                               rtol=2e-4)


@pytest.mark.parametrize("b,s,h,k", [(1, 1, 1, 8), (2, 7, 2, 16),
                                     (3, 10, 1, 16), (1, 5, 2, 8)])
def test_wkv6_zero_key_is_identity(b, s, h, k):
    """k = 0 writes nothing: the state is the decayed initial state, as in
    the reference's and its kernel's (tests/test_properties.py)."""
    rng = np.random.RandomState(b * s)
    r = rng.randn(b, s, h, k).astype(np.float32)
    kk = np.zeros((b, s, h, k), np.float32)
    v = rng.randn(b, s, h, k).astype(np.float32)
    w = np.full((b, s, h, k), 0.5, np.float32)
    u = rng.randn(h, k).astype(np.float32)
    s0 = rng.randn(b, h, k, k).astype(np.float32)
    _, sT = tops.wkv6_op(*map(_t, (r, kk, v, w, u, s0)))
    np.testing.assert_allclose(sT.numpy(), s0 * 0.5 ** s, atol=1e-4,
                               rtol=1e-4)
    _, jsT = jops.wkv6_op(*map(jnp.asarray, (r, kk, v, w, u, s0)))
    np.testing.assert_allclose(sT.numpy(), np.asarray(jsT), atol=1e-4,
                               rtol=1e-4)
