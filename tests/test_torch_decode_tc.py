"""The bf16 tensor-core decode kernel's arithmetic on the CPU.

``kernels/ref.py decode_attention_split_p_ref`` computes decode attention
with the kernel's arithmetic: splits of positions, 16-key tiles each a step
of an online softmax in the log2 domain, P fed to P·V as a bf16 hi + lo
pair, the splits merged by log-sum-exp.  On inputs made from a seed with
numpy and rounded to bf16 it is held against the reference package's Pallas
decode kernel in interpret mode (as tests/test_torch_split_decode.py runs
it) and against its oracle ``repro.kernels.ref.decode_attention_ref``: in
f32 within 2e-5 (both compute in f32 from the same values), and in bf16
within 2e-5 + 2 bf16 steps of the reference's f32 value, the bound the card
holds the kernel to.  A single bf16 P is shown to break that bound.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref

TOL = 2e-5
# the oracle compiled once a shape rather than op by op
ORACLE = jax.jit(jref.decode_attention_ref, static_argnames=("window",
                                                             "softcap"))
B, HKV, L, SPLIT = 2, 2, 256, 128    # two splits of eight 16-key tiles
# (window, softcap) and cur_lens, taken in turn: cur_len on a split's
# first key (128) and last (127), on a tile's last key (15) and first (16),
# at 0 and at the cache's last row
MASKS = [(0, 0.0), (0, 50.0), (40, 0.0), (100, 30.0)]
CURS = [[255, 128], [127, 15], [16, 0]]
CASES = [(G, D, *MASKS[i % len(MASKS)], CURS[i % len(CURS)])
         for i, (G, D) in enumerate(itertools.product((1, 2, 4, 5, 7, 8),
                                                      (64, 128, 256)))]


def _bf16_values(rng, *shape):
    """Normal values that bf16 holds exactly, as f32."""
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)) \
        .bfloat16().float()


def _inputs(G, D, curs, seed):
    rng = np.random.RandomState(seed)
    q = _bf16_values(rng, B, G * HKV, D)
    k, v = _bf16_values(rng, B, L, HKV, D), _bf16_values(rng, B, L, HKV, D)
    return q, k, v, torch.tensor(curs, dtype=torch.int32)


def _bound_share(out, want):
    """Largest |out - want| as a share of 2e-5 + 2 bf16 steps of |want|
    (chip_smoke.bf16_bound_share)."""
    w = want.float()
    _, e = torch.frexp(w)
    bound = TOL + 2 * torch.ldexp(torch.ones_like(w), e - 8)
    return ((out.float() - w).abs() / bound).max().item()


@pytest.mark.parametrize("G,D,window,cap,curs", CASES)
def test_split_p_matches_reference(G, D, window, cap, curs):
    """In f32 within 2e-5 of the Pallas kernel (and, at D = 128, of the
    oracle); in bf16 within 2e-5 + 2 bf16 steps of the kernel's f32 value."""
    q, k, v, cur = _inputs(G, D, curs, seed=10 * G + D)
    jargs = [jnp.asarray(t.numpy()) for t in (q, k, v, cur)]
    want = np.asarray(jops.decode_attention_op(*jargs, window=window,
                                               softcap=cap))
    out = tref.decode_attention_split_p_ref(q, k, v, cur, SPLIT,
                                            window=window, softcap=cap)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want, atol=TOL, rtol=TOL)
    if D == 128:
        oracle = np.asarray(ORACLE(*jargs, window=window, softcap=cap))
        np.testing.assert_allclose(out.numpy(), oracle, atol=TOL, rtol=TOL)
    out16 = tref.decode_attention_split_p_ref(
        q.bfloat16(), k.bfloat16(), v.bfloat16(), cur, SPLIT, window=window,
        softcap=cap)
    assert out16.dtype == torch.bfloat16
    assert _bound_share(out16, torch.tensor(want).bfloat16()) <= 1


def test_split_p_ignores_dead_region():
    """NaN past cur_len and behind the window never reaches the result:
    the dead rows are never loaded."""
    q, k, v, cur = _inputs(4, 64, [200, 17], seed=3)
    clean = tref.decode_attention_split_p_ref(q, k, v, cur, SPLIT, window=40)
    for b, c in enumerate(cur.tolist()):
        for t in (k, v):
            t[b, c + 1:] = float("nan")
            t[b, :max(c - 39, 0)] = float("nan")
    dirty = tref.decode_attention_split_p_ref(q, k, v, cur, SPLIT, window=40)
    assert torch.isfinite(dirty).all()
    assert torch.equal(clean, dirty)
    want = tref.decode_attention_ref(q, k, v, cur, window=40)
    np.testing.assert_allclose(dirty.numpy(), want.numpy(), atol=TOL,
                               rtol=TOL)


def test_split_p_rank_slice_matches_partial():
    """With pos0: one slice's (o, lse), -inf where it has no live key, as
    the plain rank-slice version gives them."""
    q, k, v, _ = _inputs(5, 128, [0, 0], seed=4)
    cur = torch.tensor([200, 100], dtype=torch.int32)
    ks, vs = k[:, 128:].contiguous(), v[:, 128:].contiguous()
    o, lse = tref.decode_attention_split_p_ref(q, ks, vs, cur, SPLIT,
                                               window=64, pos0=128)
    wo, wl = tref.decode_attention_partial_ref(q, ks, vs, cur, 128,
                                               window=64)
    assert torch.equal(torch.isneginf(lse), torch.isneginf(wl))
    assert torch.isneginf(lse[1]).all()          # cur 100: nothing in 128..
    live = torch.isfinite(wl)
    np.testing.assert_allclose(o.numpy(), wo.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse[live].numpy(), wl[live].numpy(),
                               atol=TOL, rtol=TOL)


def test_single_bf16_p_breaks_the_bound():
    """Outputs near zero (v of mean zero over many keys of similar
    weight): the hi + lo pair keeps P to ~2^-16 and stays within the bound;
    a single bf16 P errs by ~2^-9 of the weights and does not."""
    rng = np.random.RandomState(5)
    q = torch.from_numpy(0.05 * rng.randn(B, 8, 128).astype(np.float32))
    k, v = _bf16_values(rng, B, 2048, 2, 128), \
        _bf16_values(rng, B, 2048, 2, 128)
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    cur = torch.tensor([2047, 1500], dtype=torch.int32)
    plain = tref.decode_attention_ref(q, k, v, cur)
    pair = tref.decode_attention_split_p_ref(q, k, v, cur, SPLIT)
    single = tref.decode_attention_split_p_ref(q, k, v, cur, SPLIT,
                                               p_parts=1)
    assert _bound_share(pair, plain) <= 1
    assert _bound_share(single, plain) > 2
