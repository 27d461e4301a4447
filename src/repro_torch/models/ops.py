"""Layer math of the attention + dense-FFN decoder, in PyTorch.

The counterpart of the reference package's ``models/ops.py`` for the
layers this slice ports.  ``apply_attn`` routes attention through the
kernel wrappers (``kernels/ops.py``) the way the reference's
``_pallas_attn`` does; with ``ApplyCtx.plain_attention`` it runs the
masked ``_sdpa`` instead, which is how the reference computes by default
and what the kernel path is compared with.  Accumulations are f32;
activations run in cfg.dtype.  KV caches are updated in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops

NEG_INF = -2.0 ** 30


@dataclass
class ApplyCtx:
    mode: str                      # "prefill" | "decode"
    positions: torch.Tensor        # (B, S) int32 absolute token positions
    write_idx: np.ndarray          # (B,) host copy of positions[:, 0]
    lengths: Optional[torch.Tensor] = None   # (B,) prefill: valid lengths
    window: int = 0                # sliding window for local_attn layers
    plain_attention: bool = False  # masked _sdpa instead of the kernels


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def rmsnorm(x, w, plus_one: bool = False, eps: float = 1e-6):
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    scale = (1.0 + w.float()) if plus_one else w.float()
    return (xf * scale).to(x.dtype)


def _rope_tables(positions, dim, theta):
    half = dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs           # (B, S, half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, theta):
    """x: (B, S, H, Dh) — llama-style rotate-half RoPE (no frequency
    scaling, as in the reference)."""
    cos, sin = _rope_tables(positions, x.shape[-1], theta)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def softcap(x, cap: float):
    return cap * torch.tanh(x / cap) if cap else x


def _act(x, kind: str):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh") if kind == "gelu" else F.silu(x)


def _update_cache(cache, new, idx: np.ndarray, rows: torch.Tensor):
    """cache (B, L, ...) <- new (B, S, ...) at per-row offsets `idx`, in
    place; `rows` (B, S) are the device positions idx[b] + t.  The
    reference's dynamic_update_slice clamps an out-of-range offset (and so
    writes elsewhere); here that is an error."""
    B, S = new.shape[:2]
    L = cache.shape[1]
    if not ((idx >= 0) & (idx + S <= L)).all():
        raise IndexError(f"cache write of {S} rows at {idx.tolist()} "
                         f"outside a cache of {L}")
    bidx = torch.arange(B, device=cache.device)[:, None]
    cache[bidx, rows.long()] = new.to(cache.dtype)


def _causal_mask(q_pos, k_pos, k_len=None, window: int = 0):
    """(B, 1, 1, S, L) boolean mask."""
    m = k_pos[:, None, :] <= q_pos[:, :, None]           # (B, S, L)
    if window:
        m &= k_pos[:, None, :] > (q_pos[:, :, None] - window)
    if k_len is not None:
        m &= k_pos[:, None, :] < k_len[:, None, None]
    return m[:, None, None]


def _sdpa(q, k, v, mask, scale, cap: float = 0.0):
    """Grouped attention (the reference's merged=False form).
    q: (B,S,Hq,Dh) k,v: (B,L,Hkv,Dh) mask: (B,1,1,S,L) bool."""
    B, S, Hq, Dh = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, Dh)
    scores = torch.einsum("bskgd,blkd->bkgsl", qg.float(), k.float()) * scale
    scores = softcap(scores, cap)
    scores = torch.where(mask.transpose(1, 2), scores,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgsl,blkv->bskgv", probs.to(v.dtype), v)
    return out.reshape(B, S, Hq, out.shape[-1])


def _kernel_attn(cfg: ModelConfig, q, kc, vc, ctx: ApplyCtx, scale):
    """Attention through the kernel wrappers: decode -> decode_attention,
    prefill and convertible chunks -> chunked_prefill_attention with
    offset = the chunk's start."""
    if ctx.mode == "decode":
        return kops.decode_attention_op(
            q[:, 0], kc, vc, ctx.positions[:, 0], window=ctx.window,
            softcap=float(cfg.attn_softcap), scale=scale)[:, None]
    return kops.prefill_attention(
        q, kc, vc, ctx.positions[:, 0], ctx.lengths, window=ctx.window,
        softcap=float(cfg.attn_softcap), scale=scale)


# ---------------------------------------------------------------------------
# Attention (GQA / MQA, local, softcap, bias) + KV cache
# ---------------------------------------------------------------------------

def apply_attn(cfg: ModelConfig, p, x, state, ctx: ApplyCtx):
    B, S, _ = x.shape
    dh, nq, nkv = cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads
    h = rmsnorm(x, p.ln1, cfg.norm_plus_one)
    q = h @ p.wq
    k = h @ p.wk
    v = h @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = apply_rope(q.reshape(B, S, nq, dh), ctx.positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, nkv, dh), ctx.positions, cfg.rope_theta)
    v = v.reshape(B, S, nkv, dh)
    scale = cfg.query_scale or dh ** -0.5

    # write offset = absolute position of the first new token (0 for a
    # whole prompt, the chunk start for a chunk, cur_len for decode)
    kc, vc = state["k"], state["v"]
    _update_cache(kc, k, ctx.write_idx, ctx.positions)
    _update_cache(vc, v, ctx.write_idx, ctx.positions)
    if ctx.plain_attention:
        k_pos = torch.arange(kc.shape[1], device=x.device)[None]
        mask = _causal_mask(ctx.positions, k_pos, ctx.lengths, ctx.window)
        out = _sdpa(q, kc, vc, mask, scale, cfg.attn_softcap)
    else:
        out = _kernel_attn(cfg, q, kc, vc, ctx, scale)
    out = out.reshape(B, S, nq * dh) @ p.wo
    if cfg.post_norms:
        out = rmsnorm(out, p.ln1_post, cfg.norm_plus_one)
    return out.to(x.dtype), state


# ---------------------------------------------------------------------------
# Dense gated FFN
# ---------------------------------------------------------------------------

def apply_dense_ffn(cfg: ModelConfig, p, x):
    h = rmsnorm(x, p.ln2, cfg.norm_plus_one)
    g = _act(h @ p.w_gate, cfg.act)
    u = h @ p.w_up
    out = (g * u) @ p.w_down
    if cfg.post_norms:
        out = rmsnorm(out, p.ln2_post, cfg.norm_plus_one)
    return out.to(x.dtype)
