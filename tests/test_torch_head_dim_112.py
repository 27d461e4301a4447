"""The plain attention versions at head dim 112 (Kimi K2: d_model 7168 over
64 heads) against the reference's Pallas kernels in interpret mode, as
tests/test_kernels.py runs them, at 2e-5: prefill at Kimi's group of 8
with offsets, a window that bites with softcap 50, ragged lengths and MQA;
decode, its split-and-merge form (the card's two passes) and the bf16
tensor-core decode kernel's arithmetic; paged decode.  Also the bf16
tensor-core prefill's arithmetic at D = 112 (kernels/ref.py
``chunked_prefill_attention_split_p_ref``) within 2e-5 + 2 bf16 steps of
the f32 version.  The kernels themselves run in tests/test_torch_gpu.py;
the narrow Kimi K2 with heads of 112 against the reference model is a case
of tests/test_torch_zoo.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.paged_decode_attention import \
    paged_decode_attention as jpaged
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

D = 112


def _close(a, b, tol=2e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _bound_share(out, want):
    """Largest |out - want| as a share of 2e-5 + 2 bf16 steps of |want|
    (chip_smoke.bf16_bound_share)."""
    w = want.float()
    _, e = torch.frexp(w)
    bound = 2e-5 + 2 * torch.ldexp(torch.ones_like(w), e - 8)
    return ((out.float() - w).abs() / bound).max().item()


def test_head_dim_112_is_taken():
    assert D in tops.HEAD_DIMS


D112_PREFILL = [
    # B, Sq, Skv, Hq, Hkv, window, softcap, off, lens
    (1, 32, 96, 16, 2, 0, 0.0, [0], [32]),                 # Kimi's G = 8
    (2, 24, 160, 16, 2, 64, 50.0, [96, 120], [120, 144]),  # window, softcap
    (2, 17, 40, 8, 1, 0, 0.0, [5, 0], [22, 40]),           # MQA, ragged
]


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,window,cap,off,lens",
                         D112_PREFILL, ids=["kimi", "window", "mqa"])
def test_prefill_plain_d112_matches_pallas(B, Sq, Skv, Hq, Hkv, window, cap,
                                           off, lens):
    rng = np.random.RandomState(Sq + Skv + D)
    q = rng.randn(B, Sq, Hq, D).astype(np.float32)
    k = rng.randn(B, Skv, Hkv, D).astype(np.float32)
    v = rng.randn(B, Skv, Hkv, D).astype(np.float32)
    off, lens = np.array(off, np.int32), np.array(lens, np.int32)
    out = tops.prefill_attention(_t(q), _t(k), _t(v), _t(off), _t(lens),
                                 window=window, softcap=cap)
    jargs = [jnp.asarray(a) for a in (q, k, v, off, lens)]
    _close(out, jops.prefill_attention(*jargs, window=window, softcap=cap))
    # the bf16 tensor-core kernel's arithmetic (64-key tiles, P as bf16
    # hi + lo) at D = 112 on bf16 inputs: within 2e-5 + 2 bf16 steps of the
    # f32 version
    qb, kb, vb = (_t(a).bfloat16() for a in (q, k, v))
    want = tref.chunked_prefill_attention_ref(qb, kb, vb, _t(off), _t(lens),
                                              window=window, softcap=cap)
    got = tref.chunked_prefill_attention_split_p_ref(
        qb, kb, vb, _t(off), _t(lens), window=window, softcap=cap)
    assert _bound_share(got, want) <= 1


@pytest.mark.parametrize("Hq,Hkv,window,cap", [(16, 2, 0, 0.0),
                                               (16, 2, 64, 50.0),
                                               (8, 1, 0, 0.0)],
                         ids=["kimi", "window-softcap", "mqa"])
def test_decode_plain_d112_matches_pallas(Hq, Hkv, window, cap):
    """Decode at D = 112: the plain version, its split-and-merge form (the
    card's two passes) and the bf16 tensor-core kernel's arithmetic
    (``decode_attention_split_p_ref``: f32 within 2e-5, bf16 within 2e-5 +
    2 bf16 steps) against the Pallas kernel."""
    B, L = 3, 192
    rng = np.random.RandomState(Hq + window)
    q = rng.randn(B, Hq, D).astype(np.float32)
    k = rng.randn(B, L, Hkv, D).astype(np.float32)
    v = rng.randn(B, L, Hkv, D).astype(np.float32)
    cur = np.array([0, 100, 191], np.int32)
    want = jops.decode_attention_op(*(jnp.asarray(a) for a in (q, k, v, cur)),
                                    window=window, softcap=cap)
    out = tops.decode_attention_op(_t(q), _t(k), _t(v), _t(cur),
                                   window=window, softcap=cap)
    _close(out, want)
    split, nsplit = tops.decode_split(L, B, Hkv, D)
    assert nsplit > 1
    _close(tref.decode_attention_split_ref(_t(q), _t(k), _t(v), _t(cur),
                                           split, window=window,
                                           softcap=cap), want)
    # the tensor-core kernel's arithmetic, on values bf16 holds exactly
    qb, kb, vb = (_t(a).bfloat16() for a in (q, k, v))
    exact = [jnp.asarray(t.float().numpy()) for t in (qb, kb, vb)]
    want16 = np.asarray(jops.decode_attention_op(
        *exact, jnp.asarray(cur), window=window, softcap=cap))
    _close(tref.decode_attention_split_p_ref(
        qb.float(), kb.float(), vb.float(), _t(cur), split, window=window,
        softcap=cap), want16)
    got = tref.decode_attention_split_p_ref(qb, kb, vb, _t(cur), split,
                                            window=window, softcap=cap)
    assert got.dtype == torch.bfloat16
    assert _bound_share(got, torch.tensor(want16)) <= 1


def test_paged_plain_d112_matches_pallas():
    """Paged decode at Kimi's group of 8 (16 / 2 heads, D = 112) over
    shuffled pages of 16 positions."""
    B, MB, NB, BS, Hq, Hkv = 2, 4, 10, 16, 16, 2
    rng = np.random.RandomState(D)
    pk = rng.randn(NB, BS, Hkv, D).astype(np.float32)
    pv = rng.randn(NB, BS, Hkv, D).astype(np.float32)
    perm = rng.permutation(NB)
    tables = np.full((B, MB), -1, np.int32)
    tables[0, :4], tables[1, :2] = perm[:4], perm[4:6]
    cur = np.array([60, 20], np.int32)
    q = rng.randn(B, Hq, D).astype(np.float32)
    out = tops.paged_decode_attention(*map(_t, (q, pk, pv, tables, cur)))
    want = jpaged(*map(jnp.asarray, (q, pk, pv, tables, cur)),
                  interpret=True)
    _close(out, want)
