"""Decode against a cache split over its positions, on the CPU: the plain
version of the rank-slice entry point (``kernels/ref.py``
``decode_attention_partial_ref``: one slice's normalised output and
log-sum-exp) and the merge across slices (``merge_decode_partials``)
against the plain one-pass decode and the reference package's decode
kernel, on the same numpy inputs.

The reference runs its Pallas kernel in interpret mode on the CPU, as
tests/test_torch_split_decode.py does.  Tolerance: the reference's own,
2e-5 in f32 (the merge reorders f32 sums).  The kernel itself is held to
this plain version on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = 2e-5

CASES = {
    # id: (L, Hq, Hkv, D, window, softcap, cur_lens)
    "plain": (96, 8, 2, 32, 0, 0.0, [95, 40, 7]),
    "cur-on-a-slice-boundary": (128, 8, 2, 32, 0, 0.0, [31, 32, 63, 64]),
    "window-across-slices": (128, 4, 2, 16, 40, 0.0, [100, 70, 45]),
    "window-inside-one-slice": (128, 4, 1, 16, 8, 0.0, [20, 127]),
    "window-starts-mid-slice": (128, 8, 2, 32, 37, 30.0, [90, 50]),
    "softcap": (64, 8, 2, 32, 0, 50.0, [63, 12]),
    "group-of-5": (80, 10, 2, 16, 0, 0.0, [79, 33]),
    "head-dim-256": (64, 4, 2, 256, 24, 50.0, [63, 30]),
}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def _inputs(L, Hq, Hkv, D, curs, seed):
    rng = np.random.RandomState(seed)
    B = len(curs)
    return (rng.randn(B, Hq, D).astype(np.float32),
            rng.randn(B, L, Hkv, D).astype(np.float32),
            rng.randn(B, L, Hkv, D).astype(np.float32),
            np.asarray(curs, np.int32))


def _sliced(q, k, v, cur, n, **kw):
    """The n slices' (o, lse), stacked in slice order, and the merge."""
    L = k.shape[1]
    per = L // n
    parts = [tref.decode_attention_partial_ref(
        _t(q), _t(k[:, i * per:(i + 1) * per]),
        _t(v[:, i * per:(i + 1) * per]), _t(cur), i * per, **kw)
        for i in range(n)]
    o = torch.stack([p[0] for p in parts])
    lse = torch.stack([p[1] for p in parts])
    return o, lse, tref.merge_decode_partials(o, lse)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_slices_merge_to_the_plain_decode_and_the_reference(case, n):
    L, Hq, Hkv, D, window, cap, curs = CASES[case]
    q, k, v, cur = _inputs(L, Hq, Hkv, D, curs, L + Hq + window + n)
    _, _, out = _sliced(q, k, v, cur, n, window=window, softcap=cap)
    plain = tref.decode_attention_ref(_t(q), _t(k), _t(v), _t(cur),
                                      window=window, softcap=cap)
    _close(out, plain)
    want = jops.decode_attention_op(*(jnp.asarray(a) for a in (q, k, v, cur)),
                                    window=window, softcap=cap, block_k=16)
    _close(out, np.asarray(want))


def test_one_slice_is_the_whole_decode_with_its_logsumexp():
    """With the whole cache as one slice, o is the plain decode and lse the
    natural log of the sum of exp(score) over the live keys."""
    L, Hq, Hkv, D, window, cap, curs = CASES["window-starts-mid-slice"]
    q, k, v, cur = _inputs(L, Hq, Hkv, D, curs, 3)
    o, lse = tref.decode_attention_partial_ref(
        _t(q), _t(k), _t(v), _t(cur), 0, window=window, softcap=cap)
    _close(o, tref.decode_attention_ref(_t(q), _t(k), _t(v), _t(cur),
                                        window=window, softcap=cap))
    G = Hq // Hkv
    s = np.einsum("bkgd,blkd->bkgl", q.reshape(len(curs), Hkv, G, D),
                  k) / np.sqrt(D)
    s = cap * np.tanh(s / cap)
    pos = np.arange(L)[None]
    live = (pos <= cur[:, None]) & (pos > cur[:, None] - window)
    s = np.where(live[:, None, None], s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m[..., 0] + np.log(np.exp(s - m).sum(-1))).reshape(len(curs), Hq)
    _close(lse, want)


def test_rows_with_no_live_key():
    """A slice with no live key for a row gives o = 0 and lse = -inf there;
    the merge skips it, and a row whose every slice is empty (its cur_len
    past the cache, behind its window) merges to 0 with no NaN, the plain
    decode's value."""
    L, Hq, Hkv, D = 64, 4, 2, 16
    q, k, v, cur = _inputs(L, Hq, Hkv, D, [10, 200], 5)
    o, lse, out = _sliced(q, k, v, cur, 4, window=8)
    # row 0: only slice 0 holds its keys 3 .. 10
    assert torch.isneginf(lse[1:, 0]).all() and torch.isfinite(lse[0, 0]).all()
    assert (o[1:, 0] == 0).all()
    assert torch.isneginf(lse[:, 1]).all() and (o[:, 1] == 0).all()
    assert not torch.isnan(out).any()
    assert (out[1] == 0).all()
    _close(out, tref.decode_attention_ref(_t(q), _t(k), _t(v), _t(cur),
                                          window=8))


def test_dead_rows_never_reach_the_result():
    """NaN in the slice's rows outside the live range changes nothing."""
    L, Hq, Hkv, D, window, cap, curs = CASES["window-across-slices"]
    q, k, v, cur = _inputs(L, Hq, Hkv, D, curs, 9)
    _, _, clean = _sliced(q, k, v, cur, 4, window=window)
    for b, c in enumerate(curs):
        for t in (k, v):
            t[b, c + 1:] = np.nan
            t[b, :max(c - window + 1, 0)] = np.nan
    _, _, dirty = _sliced(q, k, v, cur, 4, window=window)
    assert torch.equal(clean, dirty)


def test_merge_is_bit_equal_run_to_run():
    L, Hq, Hkv, D, window, cap, curs = CASES["plain"]
    q, k, v, cur = _inputs(L, Hq, Hkv, D, curs, 1)
    o, lse, first = _sliced(q, k, v, cur, 4)
    for _ in range(3):
        assert torch.equal(tref.merge_decode_partials(o, lse), first)


def test_wrapper_on_the_cpu_is_the_plain_version():
    """The wrapper runs the plain version on CPU tensors and refuses a
    negative slice start."""
    L, Hq, Hkv, D, window, cap, curs = CASES["softcap"]
    q, k, v, cur = (_t(a) for a in _inputs(L, Hq, Hkv, D, curs, 2))
    got = tops.decode_attention_partial(q, k[:, 32:], v[:, 32:], cur, 32,
                                        softcap=cap)
    want = tref.decode_attention_partial_ref(q, k[:, 32:], v[:, 32:], cur,
                                             32, softcap=cap)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].dtype == got[1].dtype == torch.float32
    with pytest.raises(ValueError, match="pos0"):
        tops.decode_attention_partial(q, k, v, cur, -1)
