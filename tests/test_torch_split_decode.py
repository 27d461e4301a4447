"""The split-KV decode kernels' arithmetic on the CPU: the plain split-and-
merge versions (kernels/ref.py ``*_split_ref``) against the plain one-pass
versions and against the reference package's kernels, on the same numpy
inputs, and the split rule the wrappers use.

The reference runs its Pallas kernels in interpret mode on the CPU, as
tests/test_kernels.py and tests/test_paged_and_sampling.py do.  Tolerance:
the reference's own, 2e-5 in f32 (the merge reorders f32 sums).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.paged_decode_attention import \
    paged_decode_attention as jpaged
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = 2e-5

SPLIT_CASES = {
    # id: (L, Hq, Hkv, D, window, softcap, split, cur_lens)
    "boundary-at-cur-1-cur-cur+1": (192, 8, 2, 32, 0, 0.0, 64, [65, 64, 63]),
    "cur-0": (128, 4, 1, 16, 0, 0.0, 64, [0, 0]),
    "window-inside-one-split": (256, 8, 2, 32, 20, 0.0, 64, [100, 140]),
    "window-spans-two-splits": (256, 8, 2, 32, 50, 0.0, 64, [80, 200]),
    "window-boundary-at-start": (256, 4, 2, 16, 37, 0.0, 64, [100, 63]),
    "no-visible-key": (128, 4, 2, 16, 16, 0.0, 64, [127, 143]),
    "L-not-a-multiple": (150, 8, 2, 64, 0, 0.0, 64, [149, 70, 128]),
    "single-split": (48, 4, 2, 32, 0, 30.0, 64, [47, 12]),
    "group-of-5-qwen": (160, 40, 8, 16, 0, 0.0, 64, [159, 64, 3]),
    "softcap-window-many": (512, 8, 2, 32, 100, 50.0, 64, [511, 300, 10]),
}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_decode_split_ref_matches_plain_and_reference(case):
    L, Hq, Hkv, D, window, cap, split, curs = SPLIT_CASES[case]
    B = len(curs)
    rng = np.random.RandomState(L + 7 * Hq + window)
    q = rng.randn(B, Hq, D).astype(np.float32)
    k = rng.randn(B, L, Hkv, D).astype(np.float32)
    v = rng.randn(B, L, Hkv, D).astype(np.float32)
    cur = np.asarray(curs, np.int32)
    out = tref.decode_attention_split_ref(_t(q), _t(k), _t(v), _t(cur), split,
                                          window=window, softcap=cap)
    plain = tref.decode_attention_ref(_t(q), _t(k), _t(v), _t(cur),
                                      window=window, softcap=cap)
    _close(out.numpy(), plain.numpy())
    if (cur > L - 1).any():
        # no key visible: the port's plain versions give 0, the reference's
        # oracle the mean of v over the cache; neither is a serving input
        return
    jargs = [jnp.asarray(a) for a in (q, k, v, cur)]
    want = jops.decode_attention_op(*jargs, window=window, softcap=cap,
                                    block_k=32)
    _close(out.numpy(), np.asarray(want))
    oracle = jref.decode_attention_ref(*jargs, window=window, softcap=cap)
    _close(out.numpy(), np.asarray(oracle))


def test_decode_split_ref_ignores_dead_region():
    """NaN outside the live range (past cur_len, behind the window, in the
    padding of the last split) never reaches the merged result."""
    rng = np.random.RandomState(11)
    B, L, H, D = 2, 150, 2, 16
    q = rng.randn(B, H, D).astype(np.float32)
    k = rng.randn(B, L, H, D).astype(np.float32)
    v = rng.randn(B, L, H, D).astype(np.float32)
    cur = np.array([70, 140], np.int32)
    clean = tref.decode_attention_split_ref(_t(q), _t(k), _t(v), _t(cur), 64,
                                            window=40)
    for b, c in enumerate(cur):
        for a in (k, v):
            a[b, c + 1:] = np.nan
            a[b, :c - 39] = np.nan
    dirty = tref.decode_attention_split_ref(_t(q), _t(k), _t(v), _t(cur), 64,
                                            window=40)
    assert torch.isfinite(dirty).all()
    assert torch.equal(clean, dirty)


PAGED_SPLIT_CASES = {
    # id: (BS, MB, NB, Hq, Hkv, D, split, cur_lens, holes)
    #   holes: (request, table slot) set to -1 inside the live range
    "bs16-hole": (16, 8, 20, 4, 2, 16, 64, [100, 40], [(0, 2)]),
    "bs32-hole-split-edge": (32, 6, 16, 8, 2, 32, 64, [130, 63, 64],
                             [(0, 1), (2, 0)]),
    "bs128-hole": (128, 3, 8, 4, 1, 16, 128, [300, 127], [(0, 1)]),
    "bs16-group-of-5": (16, 6, 16, 10, 2, 16, 64, [95, 17], []),
}


def _paged_inputs(BS, MB, NB, Hq, Hkv, D, curs, holes, seed):
    rng = np.random.RandomState(seed)
    B = len(curs)
    pool_k = rng.randn(NB, BS, Hkv, D).astype(np.float32)
    pool_v = rng.randn(NB, BS, Hkv, D).astype(np.float32)
    tables = np.full((B, MB), -1, np.int32)
    perm = rng.permutation(NB)
    j = 0
    for b, c in enumerate(curs):
        n = c // BS + 1
        tables[b, :n] = perm[j:j + n]
        j += n
    for b, slot in holes:
        tables[b, slot] = -1
    q = rng.randn(B, Hq, D).astype(np.float32)
    return q, pool_k, pool_v, tables, np.asarray(curs, np.int32)


@pytest.mark.parametrize("case", list(PAGED_SPLIT_CASES))
def test_paged_split_ref_matches_plain_and_reference(case):
    BS, MB, NB, Hq, Hkv, D, split, curs, holes = PAGED_SPLIT_CASES[case]
    args = _paged_inputs(BS, MB, NB, Hq, Hkv, D, curs, holes, seed=BS + MB)
    out = tref.paged_decode_attention_split_ref(*map(_t, args), split)
    plain = tref.paged_decode_attention_ref(*map(_t, args))
    _close(out.numpy(), plain.numpy())
    want = jpaged(*map(jnp.asarray, args), interpret=True)
    _close(out.numpy(), np.asarray(want))


def test_paged_split_ref_equals_contiguous_split_ref_on_gathered_kv():
    """Full tables: the paged and contiguous split-and-merge versions see
    the same positions in the same splits."""
    q, pk, pv, tables, cur = _paged_inputs(32, 6, 16, 8, 2, 32,
                                           [130, 63, 191], [], seed=5)
    safe = np.maximum(tables, 0)
    k = pk[safe].reshape(3, 6 * 32, 2, 32)
    v = pv[safe].reshape(3, 6 * 32, 2, 32)
    for b, c in enumerate(cur):          # the gathered stand-ins are dead
        k[b, c + 1:] = np.nan
        v[b, c + 1:] = np.nan
    split, _ = tops.decode_split(6 * 32, 3, 2, 32, 32)
    paged = tref.paged_decode_attention_split_ref(
        *map(_t, (q, pk, pv, tables, cur)), split)
    contiguous = tref.decode_attention_split_ref(*map(_t, (q, k, v, cur)),
                                                 split)
    _close(paged.numpy(), contiguous.numpy())


@pytest.mark.parametrize("positions,B,Hkv,D,bs,split,nsplit", [
    (2048, 4, 8, 128, 1, 128, 16),      # Llama-3.1-8B decode rows
    (2048, 4, 8, 128, 128, 128, 16),    # ... and over 128-token pages
    (8192, 1, 8, 128, 1, 128, 64),      # one long request: many splits
    (150, 2, 2, 64, 1, 128, 2),         # positions not a multiple
    (48, 1, 1, 32, 1, 128, 1),          # a single split
    (2048, 4, 8, 128, 16, 128, 16),     # small pages: the same split
    (32768, 128, 8, 128, 1, 2048, 16),  # large batch: capped at SPLIT_MAX
    (5120, 4, 8, 256, 1, 256, 20),      # Gemma-2-9B decode rows
    (2048, 4, 8, 256, 128, 128, 16),    # ... over 128-token pages
])
def test_decode_split_rule(positions, B, Hkv, D, bs, split, nsplit):
    got = tops.decode_split(positions, B, Hkv, D, bs)
    assert got == (split, nsplit)
    assert split % tops.SPLIT_QUANTUM == 0 and split % bs == 0


@pytest.mark.parametrize("D,blocks", [(16, 16), (32, 10), (64, 6),
                                      (128, 3), (256, 2)])
def test_decode_blocks_per_sm(D, blocks):
    """The bf16 kernel's ring leaves room for this many blocks on an SM
    (228 KB, 1 KB a block besides; at most 16 blocks of 4 warps): the
    slots the split rule fills twice over.  chip_smoke.py holds the card's
    occupancy calculator to the same figures at D = 64, 128 and 256."""
    assert tops.decode_blocks_per_sm(D) == blocks


def test_decode_split_fills_the_card_at_the_main_path_shape():
    """B=4, Hkv=8, L=2048 with cur_lens 0/700/1500/2047: at least ~2 blocks
    per SM of an H100 carry live rows; the contiguous and paged kernels cut
    the keys alike."""
    split, nsplit = tops.decode_split(2048, 4, 8, 128)
    assert (split, nsplit) == tops.decode_split(2048, 4, 8, 128, 128)
    live = sum(c // split + 1 for c in (0, 700, 1500, 2047)) * 8
    assert live >= 2 * 132


def test_decode_split_refuses_pages_larger_than_a_split():
    with pytest.raises(ValueError):
        tops.decode_split(8192, 1, 1, 128, 4096)
