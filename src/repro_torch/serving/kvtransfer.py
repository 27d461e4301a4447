"""KV-cache transfer between PD instances.

The counterpart of the reference package's ``serving/kvtransfer.py``, with
the same interface:

    payload = extract(cfg, state, length)      # prefiller side
    nbytes  = payload_bytes(payload)           # what would cross the wire
    state   = insert(cfg, pool_state, payload, slot)   # decoder side
    state   = transfer(cfg, src, dst, length, src_slot, dst_slot, stats)

``extract`` copies the request's slot and trims each sequence leaf (a KV
cache, MLA's latent ``c_kv`` / ``k_rope``) to the request's length rounded
up to 128 tokens (at least 8); a recurrent state (RWKV-6's ``wkv``,
``shift_t``, ``shift_c``; Mamba's ``ssm``, ``conv``) crosses whole, which
is why an attention-free model's payload does not grow with the prompt
(§III-C), and so do a cross-attention layer's image keys / values ``xk``
/ ``xv``.  ``payload_bytes`` is the reference's for the same config and
length; it is the measured source of the network-stage Token Velocity.
Instances share one process and one device, so the "wire" is a
device-to-device copy.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig


@dataclass
class KVPayload:
    """One request's transferable state: per-layer state dicts of batch 1,
    the sequence leaves cut to n, the rounded length (e.g. {"k", "v"}
    (1, n, Hkv, D)), the other leaves whole."""
    tree: list
    length: int


# the leaves with a sequence axis (right after batch): the reference's list
_SEQ_LEAVES = ("k", "v", "k_scale", "v_scale", "c_kv", "k_rope")


def extract(cfg: ModelConfig, state, length: int, slot: int = 0) -> KVPayload:
    """Copy slot `slot` out of a pooled state, trimming the sequence leaves
    to `length` tokens (rounded up to 128); other leaves cross whole."""
    n = max(int(math.ceil(length / 128.0)) * 128, 8)
    tree = [{key: (leaf[slot:slot + 1, :min(n, leaf.shape[1])]
                   if key in _SEQ_LEAVES else leaf[slot:slot + 1]).clone()
             for key, leaf in layer.items()}
            for layer in state]
    return KVPayload(tree=tree, length=length)


def insert(cfg: ModelConfig, pool_state, payload: KVPayload, slot: int):
    """Write a payload into slot `slot` of a decoder's pooled state, in
    place; sequence rows past the payload are zeroed, as the reference's
    re-padding does."""
    for pool_layer, one_layer in zip(pool_state, payload.tree):
        for key, leaf in pool_layer.items():
            one = one_layer[key][0]
            if key in _SEQ_LEAVES:
                n = one.shape[0]
                leaf[slot, :n].copy_(one)
                leaf[slot, n:].zero_()
            else:
                leaf[slot].copy_(one)
    return pool_state


def payload_bytes(payload: KVPayload) -> int:
    return int(sum(t.numel() * t.element_size()
                   for layer in payload.tree for t in layer.values()))


@dataclass
class TransferStats:
    """Ledger of prefiller->decoder transfers (drives measured V_N)."""
    n_transfers: int = 0
    total_bytes: int = 0
    total_tokens: int = 0
    total_wall_s: float = 0.0

    def record(self, nbytes: int, tokens: int, wall_s: float):
        self.n_transfers += 1
        self.total_bytes += nbytes
        self.total_tokens += tokens
        self.total_wall_s += wall_s

    def bytes_per_token(self) -> float:
        return self.total_bytes / max(self.total_tokens, 1)

    def measured_network_velocity(self, link_bw: float) -> float:
        """tok/s the link could sustain at the observed bytes/token."""
        return link_bw / max(self.bytes_per_token(), 1e-9)



def transfer(cfg: ModelConfig, src_state, dst_state, length: int,
             src_slot: int, dst_slot: int,
             stats: TransferStats | None = None):
    """extract -> (wire) -> insert, with ledger accounting."""
    t0 = time.perf_counter()
    payload = extract(cfg, src_state, length, src_slot)
    nbytes = payload_bytes(payload)
    new_dst = insert(cfg, dst_state, payload, dst_slot)
    if stats is not None:
        stats.record(nbytes, length, time.perf_counter() - t0)
    return new_dst
