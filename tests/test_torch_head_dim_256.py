"""The plain attention versions at head dim 256 (Gemma, Gemma-2) against
the reference's Pallas kernels in interpret mode, as tests/test_kernels.py
runs them, at 2e-5: prefill with Gemma-2-9B's heads and softcap 50, with a
window that bites and with Gemma-2B's MQA heads; decode and its
split-and-merge form (the card's two passes); paged decode.  Also the bf16
tensor-core prefill's arithmetic at D = 256 (kernels/ref.py
``chunked_prefill_attention_split_p_ref``) within 2e-5 + 2 bf16 steps of
the f32 version.  The kernels themselves run in tests/test_torch_gpu.py.
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


def _close(a, b, tol=2e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def test_head_dim_256_is_taken():
    assert 256 in tops.HEAD_DIMS


def _t(a):
    return torch.from_numpy(np.asarray(a))


D256_PREFILL = [
    # B, Sq, Skv, Hq, Hkv, window, softcap, off, lens
    (1, 32, 96, 16, 8, 0, 50.0, [0], [32]),            # gemma2 heads
    (2, 24, 160, 16, 8, 64, 50.0, [96, 120], [120, 144]),  # window bites
    (2, 17, 40, 8, 1, 0, 0.0, [5, 0], [22, 40]),        # gemma-2b MQA
]


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,window,cap,off,lens",
                         D256_PREFILL, ids=["gemma2", "window", "mqa"])
def test_prefill_plain_d256_matches_pallas(B, Sq, Skv, Hq, Hkv, window, cap,
                                           off, lens):
    rng = np.random.RandomState(Sq + Skv)
    q = rng.randn(B, Sq, Hq, 256).astype(np.float32)
    k = rng.randn(B, Skv, Hkv, 256).astype(np.float32)
    v = rng.randn(B, Skv, Hkv, 256).astype(np.float32)
    off, lens = np.array(off, np.int32), np.array(lens, np.int32)
    out = tops.prefill_attention(_t(q), _t(k), _t(v), _t(off), _t(lens),
                                 window=window, softcap=cap)
    jargs = [jnp.asarray(a) for a in (q, k, v, off, lens)]
    _close(out, jops.prefill_attention(*jargs, window=window, softcap=cap))
    # the bf16 tensor-core kernel's arithmetic (64-key tiles, P as bf16
    # hi + lo) at D = 256 on bf16 inputs: within 2e-5 + 2 bf16 steps of the
    # f32 version
    qb, kb, vb = (_t(a).bfloat16() for a in (q, k, v))
    want = tref.chunked_prefill_attention_ref(qb, kb, vb, _t(off), _t(lens),
                                              window=window, softcap=cap)
    got = tref.chunked_prefill_attention_split_p_ref(
        qb, kb, vb, _t(off), _t(lens), window=window, softcap=cap)
    w = want.float()
    _, e = torch.frexp(w)
    bound = 2e-5 + 2 * torch.ldexp(torch.ones_like(w), e - 8)
    assert ((got.float() - w).abs() / bound).max().item() <= 1


@pytest.mark.parametrize("Hq,Hkv,window,cap", [(16, 8, 64, 50.0),
                                               (8, 1, 0, 0.0)],
                         ids=["gemma2", "mqa"])
def test_decode_plain_d256_matches_pallas(Hq, Hkv, window, cap):
    """Decode at D = 256: the plain version and its split-and-merge form
    (the card's two passes) against the Pallas kernel."""
    B, L = 3, 192
    rng = np.random.RandomState(Hq)
    q = rng.randn(B, Hq, 256).astype(np.float32)
    k = rng.randn(B, L, Hkv, 256).astype(np.float32)
    v = rng.randn(B, L, Hkv, 256).astype(np.float32)
    cur = np.array([0, 100, 191], np.int32)
    want = jops.decode_attention_op(*(jnp.asarray(a) for a in (q, k, v, cur)),
                                    window=window, softcap=cap)
    out = tops.decode_attention_op(_t(q), _t(k), _t(v), _t(cur),
                                   window=window, softcap=cap)
    _close(out, want)
    split, nsplit = tops.decode_split(L, B, Hkv, 256)
    assert nsplit > 1
    _close(tref.decode_attention_split_ref(_t(q), _t(k), _t(v), _t(cur),
                                           split, window=window,
                                           softcap=cap), want)


def test_paged_plain_d256_matches_pallas():
    """Paged decode at Gemma-2-9B's heads (16 / 8, D = 256) over shuffled
    pages of 16 positions."""
    B, MB, NB, BS, Hq, Hkv = 2, 4, 10, 16, 16, 8
    rng = np.random.RandomState(8)
    pk = rng.randn(NB, BS, Hkv, 256).astype(np.float32)
    pv = rng.randn(NB, BS, Hkv, 256).astype(np.float32)
    perm = rng.permutation(NB)
    tables = np.full((B, MB), -1, np.int32)
    tables[0, :4], tables[1, :2] = perm[:4], perm[4:6]
    cur = np.array([60, 20], np.int32)
    q = rng.randn(B, Hq, 256).astype(np.float32)
    out = tops.paged_decode_attention(*map(_t, (q, pk, pv, tables, cur)))
    want = jpaged(*map(jnp.asarray, (q, pk, pv, tables, cur)),
                  interpret=True)
    _close(out, want)
