"""Plain PyTorch versions of the attention kernels (the correctness contract).

Each function is the reference package's ``kernels/ref.py`` oracle written
in PyTorch: the same masks, the same finite ``NEG_INF`` sentinel (so a row
with no visible key softmaxes to a uniform average, exactly as there), f32
arithmetic, output in the input's dtype.  The CPU path of every wrapper in
``kernels/ops.py`` runs these; on the card they are what the kernels are
held against.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0 ** 30


def chunked_prefill_attention_ref(
        q: torch.Tensor,            # (B, Sq, Hq, D)
        k: torch.Tensor,            # (B, Skv, Hkv, D) — the KV cache
        v: torch.Tensor,            # (B, Skv, Hkv, D)
        offset: torch.Tensor,       # (B,) absolute position of q row 0
        lengths: torch.Tensor,      # (B,) absolute valid key length
        window: int = 0,
        softcap: float = 0.0,
        scale: Optional[float] = None) -> torch.Tensor:
    """Causal (chunked) prefill attention against a cache.

    Row t of q sits at absolute position offset+t; a key at cache slot
    k_pos is visible iff k_pos <= q_pos and k_pos < lengths (and
    k_pos > q_pos - window when window > 0)."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qq = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqkgd,blkd->bkgql", qq, k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    dev = q.device
    q_pos = offset.to(dev).long()[:, None] + torch.arange(Sq, device=dev)[None]
    k_pos = torch.arange(Skv, device=dev)[None, None, :]
    mask = k_pos <= q_pos[:, :, None]                         # (B, Sq, Skv)
    mask &= k_pos < lengths.to(dev).long()[:, None, None]
    if window:
        mask &= k_pos > (q_pos[:, :, None] - window)
    s = torch.where(mask[:, None, None], s, torch.tensor(NEG_INF, device=dev))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgql,blkd->bqkgd", p, v.float())
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


def decode_attention_ref(
        q: torch.Tensor,            # (B, Hq, D) — the single new token
        k: torch.Tensor,            # (B, L, Hkv, D)
        v: torch.Tensor,            # (B, L, Hkv, D)
        cur_lens: torch.Tensor,     # (B,) cache tokens; new token at cur_lens
        window: int = 0,
        softcap: float = 0.0,
        scale: Optional[float] = None) -> torch.Tensor:
    """Flash-decode semantics: attend to k_pos <= cur_len (the new token's
    k/v has already been written at slot cur_len)."""
    B, Hq, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qq = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bkgd,blkd->bkgl", qq, k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    dev = q.device
    cur = cur_lens.to(dev).long()[:, None]
    k_pos = torch.arange(L, device=dev)[None]
    mask = k_pos <= cur
    if window:
        mask &= k_pos > (cur - window)
    s = torch.where(mask[:, None, None], s, torch.tensor(NEG_INF, device=dev))
    p = torch.softmax(s, dim=-1)
    # key cur_len is always visible, so a masked key's weight is exactly 0;
    # zeroing its value as well keeps garbage (even NaN) in the dead region
    # out of the result, as the kernel's never reading it does
    vf = torch.where(mask[:, :, None, None], v.float(), 0.0)
    o = torch.einsum("bkgl,blkd->bkgd", p, vf)
    return o.reshape(B, Hq, D).to(q.dtype)
