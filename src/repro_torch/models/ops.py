"""Layer math of the port's decoder layers, in PyTorch.

The counterpart of the reference package's ``models/ops.py`` for the
layers the port has: attention + dense FFN, and RWKV-6 time-mix +
channel-mix.  ``apply_attn`` routes attention through the kernel wrappers
(``kernels/ops.py``) the way the reference's ``_pallas_attn`` does, and
``apply_rwkv_tm`` sends every prefill or chunk (S > 1) to ``wkv6_op`` as
the reference does with its Pallas switch on.  With ``ApplyCtx.plain_kernels``
they run the masked ``_sdpa`` and ``rwkv_wkv_chunked`` instead, which is how
the reference computes by default and what the kernel path is compared
with.  Train mode (``forward_train``) has no state: attention runs over the
sequence's own keys, through the prefill kernel at offset 0.  An int8 KV
cache is quantised on write (``_quant_kv``) and dequantised to the
activation dtype before attention, so the kernels see bf16 / f32.
Accumulations are f32; activations run in cfg.dtype.  The state (KV
caches, WKV and token-shift states) is updated in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.params import _RWKV_LORA  # lora width shared with decls

NEG_INF = -2.0 ** 30


@dataclass
class ApplyCtx:
    mode: str                      # "train" | "prefill" | "decode"
    positions: torch.Tensor        # (B, S) int32 absolute token positions
    write_idx: np.ndarray          # (B,) host copy of positions[:, 0]
    lengths: Optional[torch.Tensor] = None   # (B,) prefill: valid lengths
    window: int = 0                # sliding window for local_attn layers
    plain_kernels: bool = False    # plain versions instead of the kernels


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


def _quant_kv(x):
    """(B,S,H,D) -> (int8 values, f32 per-(token, head) scales): the
    reference's absmax / 127 with a 1e-8 floor, round half to even."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


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
    offset = the chunk's start; train -> the same at offset 0 over the
    sequence's keys, lengths or the full length."""
    if ctx.mode == "decode":
        return kops.decode_attention_op(
            q[:, 0], kc, vc, ctx.positions[:, 0], window=ctx.window,
            softcap=float(cfg.attn_softcap), scale=scale)[:, None]
    lengths = ctx.lengths
    if lengths is None:
        lengths = torch.full((q.shape[0],), kc.shape[1], dtype=torch.int32,
                             device=q.device)
    return kops.prefill_attention(
        q, kc, vc, ctx.positions[:, 0], lengths, window=ctx.window,
        softcap=float(cfg.attn_softcap), scale=scale)


def _write_kv(cfg: ModelConfig, state, k, v, ctx: ApplyCtx, dtype):
    """Write the new k/v into the cache at the chunk's offset, in place, and
    return the whole cache as attention reads it: as stored, or with an int8
    cache the values times their scales in the activation dtype (the
    reference's dequantisation)."""
    if cfg.kv_cache_dtype != "int8":
        _update_cache(state["k"], k, ctx.write_idx, ctx.positions)
        _update_cache(state["v"], v, ctx.write_idx, ctx.positions)
        return state["k"], state["v"]
    out = []
    for name, new in (("k", k), ("v", v)):
        vals, scales = _quant_kv(new)
        _update_cache(state[name], vals, ctx.write_idx, ctx.positions)
        _update_cache(state[f"{name}_scale"], scales, ctx.write_idx,
                      ctx.positions)
        out.append(state[name].to(dtype)
                   * state[f"{name}_scale"][..., None].to(dtype))
    return out


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

    if ctx.mode == "train":
        kc, vc = k, v
    else:
        # write offset = absolute position of the first new token (0 for a
        # whole prompt, the chunk start for a chunk, cur_len for decode)
        kc, vc = _write_kv(cfg, state, k, v, ctx, x.dtype)
    if ctx.plain_kernels:
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


# ---------------------------------------------------------------------------
# RWKV-6 (Finch): data-dependent decay time-mix + channel-mix
# ---------------------------------------------------------------------------

rwkv_wkv_chunked = kref.wkv6_chunked   # the plain chunked WKV6, (B,S,H,K)


def _token_shift(x, shift_state):
    """x: (B,S,d); shift_state: (B,d) = last token of the previous chunk."""
    prev = torch.cat([shift_state[:, None], x[:, :-1]], dim=1)
    return prev - x


def rwkv_wkv(r, k, v, w, u, s0):
    """WKV6 recurrence token by token (decode, S = 1).

    r, k, v, w: (B,S,H,K) f32; u: (H,K); s0: (B,H,K,K).
    Returns y: (B,S,H,K), sT."""
    y, sT = kref.wkv6_ref(*(t.transpose(1, 2) for t in (r, k, v, w)), u, s0)
    return y.transpose(1, 2), sT


def _last_valid(h, ctx: ApplyCtx):
    """Last *valid* token's activation (B, d), honoring padded prefill.

    Indices are local to the chunk: absolute length minus chunk start."""
    if ctx.lengths is None:
        return h[:, -1]
    idx = (ctx.lengths - ctx.positions[:, 0] - 1).clamp(0, h.shape[1] - 1)
    return h[torch.arange(h.shape[0], device=h.device), idx.long()]


def apply_rwkv_tm(cfg: ModelConfig, p, x, state, ctx: ApplyCtx):
    B, S, d = x.shape
    K = cfg.rwkv_head_dim
    H = d // K
    h = rmsnorm(x, p.ln1, cfg.norm_plus_one)
    sx = _token_shift(h, state["shift_t"].to(h.dtype))
    xxx = h + sx * p.mu_x
    lora = torch.tanh(xxx @ p.lora_A).reshape(B, S, 5, _RWKV_LORA)
    mixes = torch.einsum("bsln,lnd->bsld", lora, p.lora_B)
    xw, xk, xv, xr, xg = [
        h + sx * (getattr(p, f"mu_{n}") + mixes[:, :, i])
        for i, n in enumerate(("w", "k", "v", "r", "g"))]
    r = (xr @ p.wr).reshape(B, S, H, K).float()
    k = (xk @ p.wk).reshape(B, S, H, K).float()
    v = (xv @ p.wv).reshape(B, S, H, K).float()
    g = F.silu(xg @ p.wg)
    wdec = p.w0.float() + (torch.tanh(xw @ p.decay_A) @ p.decay_B).float()
    w = torch.exp(-torch.exp(wdec)).reshape(B, S, H, K)
    u = p.u.float().reshape(H, K)
    if ctx.lengths is not None:
        # padded prefill: no decay, no writes past each row's valid length
        m = (ctx.positions < ctx.lengths[:, None])[:, :, None, None]
        w = torch.where(m, w, 1.0)
        k = k * m
    s0 = state["wkv"].float()
    if S == 1:
        y, sT = rwkv_wkv(r, k, v, w, u, s0)
    elif ctx.plain_kernels:
        y, sT = rwkv_wkv_chunked(r, k, v, w, u, s0)
    else:
        y, sT = kops.wkv6_op(r, k, v, w, u, s0)
    # per-head groupnorm
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mu) * torch.rsqrt(var + 64e-5)
    y = y.reshape(B, S, d) * p.lnx_g.float() + p.lnx_b.float()
    out = (y.to(x.dtype) * g) @ p.wo
    state["wkv"].copy_(sT)
    state["shift_t"].copy_(_last_valid(h, ctx))
    return out.to(x.dtype), state


def apply_rwkv_cm(cfg: ModelConfig, p, x, state, ctx: ApplyCtx):
    h = rmsnorm(x, p.ln2, cfg.norm_plus_one)
    sx = _token_shift(h, state["shift_c"].to(h.dtype))
    xk = h + sx * p.mu_ck
    xr = h + sx * p.mu_cr
    kk = torch.square(torch.relu(xk @ p.wk_cm))
    out = torch.sigmoid(xr @ p.wr_cm) * (kk @ p.wv_cm)
    state["shift_c"].copy_(_last_valid(h, ctx))
    return out.to(x.dtype), state
