"""The port's paged KV pool (serving/paged.py) and the plain version of its
paged decode-attention kernel against the reference package's, on the same
numpy inputs.

The reference runs its Pallas kernel in interpret mode on the CPU, as
tests/test_paged_and_sampling.py does; the tolerance is its own, 2e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_decode_attention import \
    paged_decode_attention as jpaged
from repro.serving import paged as jp
from repro_torch.kernels import ops as tops
from repro_torch.serving import paged as tp


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(a, b, tol=2e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def _paged_inputs(B, MB, NB, BS, Hq, Hkv, D):
    """tests/test_paged_and_sampling.py's inputs: each request owns a
    random run of pages of a shuffled pool; cur_len inside its pages."""
    rng = np.random.RandomState(B * 100 + MB)
    pool_k = rng.randn(NB, BS, Hkv, D).astype(np.float32)
    pool_v = rng.randn(NB, BS, Hkv, D).astype(np.float32)
    tables = np.full((B, MB), -1, np.int32)
    perm = rng.permutation(NB)
    j = 0
    curs = []
    for b in range(B):
        n = rng.randint(1, MB + 1)
        tables[b, :n] = perm[j:j + n]
        j += n
        curs.append(rng.randint(0, n * BS))
    cur = np.asarray(curs, np.int32)
    q = rng.randn(B, Hq, D).astype(np.float32)
    return q, pool_k, pool_v, tables, cur


CASES = [
    (1, 2, 4, 16, 2, 1, 16),
    (3, 4, 12, 16, 4, 2, 32),
    (2, 3, 8, 32, 8, 8, 64),      # MHA
]


@pytest.mark.parametrize("B,MB,NB,BS,Hq,Hkv,D", CASES)
def test_paged_decode_attention_matches_reference(B, MB, NB, BS, Hq, Hkv, D):
    q, pk, pv, tables, cur = _paged_inputs(B, MB, NB, BS, Hq, Hkv, D)
    out = tops.paged_decode_attention(*map(_t, (q, pk, pv, tables, cur)))
    want = jpaged(*map(jnp.asarray, (q, pk, pv, tables, cur)),
                  interpret=True)
    _close(out.numpy(), want)
    for b in range(B):
        oracle = jp.paged_decode_attention_ref(
            *map(jnp.asarray, (q[b], pk, pv, tables[b], cur[b])))
        _close(out[b].numpy(), oracle)
        mine = tp.paged_decode_attention_ref(
            *map(_t, (q[b], pk, pv, tables[b])), int(cur[b]))
        _close(mine.numpy(), oracle)


def test_paged_attention_ignores_foreign_pages():
    """Pages owned by other requests (and the stand-in page an unallocated
    entry reads) must not leak into the output: NaN there leaves it
    bit-identical."""
    rng = np.random.RandomState(0)
    NB, BS, H, D = 6, 16, 2, 16
    pool_k = rng.randn(NB, BS, H, D).astype(np.float32)
    pool_v = rng.randn(NB, BS, H, D).astype(np.float32)
    q = rng.randn(1, 2, D).astype(np.float32)
    t1 = np.array([[2, 4, -1]], np.int32)
    cur = np.array([20], np.int32)
    out1 = tops.paged_decode_attention(*map(_t, (q, pool_k, pool_v, t1, cur)))
    want = jpaged(*map(jnp.asarray, (q, pool_k, pool_v, t1, cur)),
                  interpret=True)
    _close(out1.numpy(), want)
    pk, pv = pool_k.copy(), pool_v.copy()
    pk[[0, 1, 3, 5]] = np.nan              # every page NOT in the table
    pv[[0, 1, 3, 5]] = np.nan
    out2 = tops.paged_decode_attention(*map(_t, (q, pk, pv, t1, cur)))
    assert torch.equal(out1, out2)


def test_paged_decode_equals_contiguous_decode():
    """The same KV gathered contiguous gives decode_attention_op's result."""
    q, pk, pv, tables, cur = _paged_inputs(3, 4, 12, 16, 4, 2, 32)
    out = tops.paged_decode_attention(*map(_t, (q, pk, pv, tables, cur)))
    safe = np.maximum(tables, 0)
    k = pk[safe].reshape(3, 4 * 16, 2, 32)
    v = pv[safe].reshape(3, 4 * 16, 2, 32)
    _close(out.numpy(),
           tops.decode_attention_op(*map(_t, (q, k, v, cur))).numpy())


def test_allocator_basic_and_oom():
    al = tp.BlockAllocator(4)
    blocks = [al.alloc(1), al.alloc(1), al.alloc(2)]
    assert len(set(blocks)) == 3
    assert al.n_free == 1
    assert al.utilization() == pytest.approx(0.75)
    assert al.free_request(1) == 2
    assert al.n_free == 3
    al = tp.BlockAllocator(2)
    al.alloc(1)
    al.alloc(1)
    with pytest.raises(tp.OutOfBlocks):
        al.alloc(2)


def test_allocator_hands_out_the_reference_blocks():
    """The same sequence of alloc/free calls gives the same block ids."""
    rng = np.random.RandomState(5)
    mine, ref = tp.BlockAllocator(8), jp.BlockAllocator(8)
    for _ in range(60):
        rid = int(rng.randint(0, 4))
        if rng.rand() < 0.3:
            assert mine.free_request(rid) == ref.free_request(rid)
            continue
        try:
            want = ref.alloc(rid)
        except jp.OutOfBlocks:
            with pytest.raises(tp.OutOfBlocks):
                mine.alloc(rid)
            continue
        assert mine.alloc(rid) == want


def test_pagedkv_write_and_capacity():
    kv = tp.PagedKV(num_layers=2, num_blocks=8, num_slots=2,
                    max_blocks_per_slot=4, n_kv_heads=2, head_dim=8,
                    dtype=torch.float32, device="cpu")
    kv.ensure_capacity(0, rid=7, n_tokens=130)   # needs 2 blocks (BS=128)
    assert (kv.tables[0] >= 0).sum() == 2
    k = torch.ones((2, 130, 2, 8))
    kv.write_tokens(0, k, k * 2, start=0)
    assert kv.lens[0] == 130
    blk0 = int(kv.tables[0, 0])
    assert float(kv.pool_k[0, blk0, 0, 0, 0]) == 1.0
    assert float(kv.pool_v[1, blk0, 5, 1, 3]) == 2.0
    kv.release(0, rid=7)
    assert kv.alloc.n_free == 8


def test_pagedkv_writes_equal_reference():
    """Interleaved allocation, a write across a page boundary at an offset:
    the pools and tables equal the reference's per-token writes."""
    rng = np.random.RandomState(1)
    shape = dict(num_layers=2, num_blocks=6, num_slots=2,
                 max_blocks_per_slot=3, n_kv_heads=2, head_dim=8)
    mine = tp.PagedKV(**shape, dtype=torch.float32, device="cpu")
    ref = jp.PagedKV(**shape, dtype=jnp.float32)
    for kv in (mine, ref):
        kv.ensure_capacity(0, rid=0, n_tokens=100)
        kv.ensure_capacity(1, rid=1, n_tokens=200)
        kv.ensure_capacity(0, rid=0, n_tokens=300)
    assert np.array_equal(mine.tables, ref.tables)
    for slot, start, n in ((0, 0, 100), (1, 0, 200), (0, 100, 190)):
        k = rng.randn(2, n, 2, 8).astype(np.float32)
        v = rng.randn(2, n, 2, 8).astype(np.float32)
        mine.write_tokens(slot, _t(k), _t(v), start)
        ref.write_tokens(slot, jnp.asarray(k), jnp.asarray(v), start)
    assert np.array_equal(mine.lens, ref.lens)
    assert np.array_equal(mine.pool_k.numpy(), np.asarray(ref.pool_k))
    assert np.array_equal(mine.pool_v.numpy(), np.asarray(ref.pool_v))


def test_pagedkv_refuses_unallocated_pages():
    kv = tp.PagedKV(num_layers=1, num_blocks=2, num_slots=1,
                    max_blocks_per_slot=2, n_kv_heads=1, head_dim=8,
                    dtype=torch.float32, device="cpu")
    kv.ensure_capacity(0, rid=0, n_tokens=128)
    with pytest.raises(AssertionError, match="unallocated"):
        kv.write_tokens(0, torch.ones(1, 2, 1, 8), torch.ones(1, 2, 1, 8),
                        start=127)
