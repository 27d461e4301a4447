"""Paged KV cache: a shared pool of fixed-size pages and per-request block
tables (vLLM's block-table idea).

The counterpart of the reference package's ``serving/paged.py``, with the
same components:

  * ``BlockAllocator``  free-list allocation with explicit OOM signalling
    (backpressure: the memory-release dynamic TokenScale's decode velocity
    V_D measures);
  * ``PagedKV``         the layer-stacked pooled K/V on an explicit device,
    with host block tables and lengths;
  * ``paged_decode_attention_ref``  the plain oracle over one request.

The kernel is ``kernels.ops.paged_decode_attention``.  As in the reference,
``Engine`` keeps its slot-contiguous cache: this pool is an API of its own.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ref

BLOCK_SIZE = 128


class OutOfBlocks(Exception):
    """Allocation failure == decoder backpressure (§III-B)."""


@dataclass
class BlockAllocator:
    num_blocks: int
    _free: list = field(default_factory=list)
    _owner: dict = field(default_factory=dict)     # block -> rid

    def __post_init__(self):
        self._free = list(range(self.num_blocks - 1, -1, -1))

    def alloc(self, rid: int) -> int:
        if not self._free:
            raise OutOfBlocks(f"no free blocks for request {rid}")
        b = self._free.pop()
        self._owner[b] = rid
        return b

    def free_request(self, rid: int) -> int:
        blocks = [b for b, r in self._owner.items() if r == rid]
        for b in blocks:
            del self._owner[b]
            self._free.append(b)
        return len(blocks)

    @property
    def n_free(self) -> int:
        return len(self._free)

    def utilization(self) -> float:
        return 1.0 - self.n_free / max(self.num_blocks, 1)


class PagedKV:
    """One layer-stacked paged pool + per-slot block tables.

    pool_k/pool_v : (L, num_blocks, BLOCK_SIZE, Hkv, Dh) on `device`
    tables        : (num_slots, max_blocks) int32 on the host, -1 = unallocated
    lens          : (num_slots,) tokens currently cached per slot
    """

    def __init__(self, num_layers: int, num_blocks: int, num_slots: int,
                 max_blocks_per_slot: int, n_kv_heads: int, head_dim: int,
                 dtype=torch.bfloat16, device="cuda"):
        self.block_size = BLOCK_SIZE
        self.alloc = BlockAllocator(num_blocks)
        self.pool_k = torch.zeros(
            (num_layers, num_blocks, BLOCK_SIZE, n_kv_heads, head_dim),
            dtype=dtype, device=device)
        self.pool_v = torch.zeros_like(self.pool_k)
        self.tables = np.full((num_slots, max_blocks_per_slot), -1, np.int32)
        self.lens = np.zeros((num_slots,), np.int32)

    def ensure_capacity(self, slot: int, rid: int, n_tokens: int):
        """Allocate blocks so slot can hold `n_tokens`; raises OutOfBlocks."""
        need = -(-n_tokens // self.block_size)
        have = int((self.tables[slot] >= 0).sum())
        for i in range(have, need):
            self.tables[slot, i] = self.alloc.alloc(rid)

    def write_tokens(self, slot: int, layer_k, layer_v, start: int):
        """Write (L, n, Hkv, Dh) new tokens at positions start .. start+n-1,
        every layer in one indexed copy."""
        n = layer_k.shape[1]
        pos = start + np.arange(n)
        blk = self.tables[slot, pos // self.block_size]
        assert (blk >= 0).all(), "write into unallocated block"
        dev = self.pool_k.device
        blk = torch.as_tensor(blk, dtype=torch.long, device=dev)
        row = torch.as_tensor(pos % self.block_size, dtype=torch.long,
                              device=dev)
        self.pool_k[:, blk, row] = layer_k.to(self.pool_k)
        self.pool_v[:, blk, row] = layer_v.to(self.pool_v)
        self.lens[slot] = max(self.lens[slot], start + n)

    def release(self, slot: int, rid: int):
        self.alloc.free_request(rid)
        self.tables[slot] = -1
        self.lens[slot] = 0


def paged_decode_attention_ref(q, pool_k, pool_v, table, cur_len,
                               scale: Optional[float] = None):
    """Oracle: single-layer paged decode attention for ONE request.

    q: (Hq, D); pool_k/v: (num_blocks, BS, Hkv, D); table: (max_blocks,)
    int (-1 = unallocated); attend to positions 0..cur_len (inclusive: the
    current token's KV is already written)."""
    table = torch.as_tensor(table).reshape(1, -1)
    cur = torch.as_tensor(cur_len).reshape(1)
    return ref.paged_decode_attention_ref(q[None], pool_k, pool_v, table, cur,
                                          scale=scale)[0]
