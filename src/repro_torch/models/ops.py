"""Layer math of the port's decoder layers, in PyTorch.

The counterpart of the reference package's ``models/ops.py``: attention
(GQA, local, softcaps, QKV bias, the int8 KV cache), MLA latent attention,
cross-attention to image embeddings, the dense and MoE FFNs, Mamba, and
RWKV-6 time-mix + channel-mix.  ``apply_attn`` routes attention through
the kernel wrappers (``kernels/ops.py``) the way the reference's
``_pallas_attn`` does, and ``apply_rwkv_tm`` sends every prefill or chunk
(S > 1) to ``wkv6_op`` as the reference does with its Pallas switch on.
With ``ApplyCtx.plain_kernels`` they run the masked ``_sdpa`` and
``rwkv_wkv_chunked`` instead, which is how the reference computes by
default and what the kernel path is compared with.  MLA, cross-attention,
MoE and Mamba have no kernel in the reference either: they are plain
torch ops on every device.  Train mode (``forward_train``) has no state:
attention runs over the sequence's own keys, through the prefill kernel
at offset 0.  An int8 KV cache is quantised on write (``_quant_kv``) and
dequantised to the activation dtype before attention, so the kernels see
bf16 / f32.  Accumulations are f32; activations run in cfg.dtype.  The
state (KV caches, latent caches, image keys / values, recurrent states) is
updated in place.
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
    image_embeds: Optional[torch.Tensor] = None  # (B, n_img, d) prefill
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
    q: (B,S,Hq,Dh) k: (B,L,Hkv,Dh) v: (B,L,Hkv,Dv) mask: (B,1,1,S,L) bool,
    or None where every key is visible (cross-attention)."""
    B, S, Hq, Dh = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, Dh)
    scores = torch.einsum("bskgd,blkd->bkgsl", qg.float(), k.float()) * scale
    scores = softcap(scores, cap)
    if mask is not None:
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
    if cfg.kv_lora_rank:
        return _apply_mla(cfg, p, x, state, ctx)
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
# MLA (DeepSeek latent attention): naive expansion for train / prefill /
# chunks, weight-absorbed f32 scoring against the latent cache for decode.
# The reference routes it through no kernel (its _sdpa and einsums).
# ---------------------------------------------------------------------------

def _apply_mla(cfg: ModelConfig, p, x, state, ctx: ApplyCtx):
    B, S, _ = x.shape
    nq = cfg.num_heads
    nope, rope, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    lora = cfg.kv_lora_rank
    h = rmsnorm(x, p.ln1, cfg.norm_plus_one)
    q = (h @ p.wq).reshape(B, S, nq, nope + rope)
    q_nope = q[..., :nope]
    q_rope = apply_rope(q[..., nope:], ctx.positions, cfg.rope_theta)
    ckr = h @ p.w_dkv                                    # (B, S, lora+rope)
    c_kv = rmsnorm(ckr[..., :lora], p.kv_norm)
    k_rope = apply_rope(ckr[..., None, lora:], ctx.positions,
                        cfg.rope_theta)[:, :, 0]         # (B, S, rope)
    scale = (nope + rope) ** -0.5

    if ctx.mode == "train":
        cc, kr, k_pos = c_kv, k_rope, ctx.positions
    else:
        _update_cache(state["c_kv"], c_kv, ctx.write_idx, ctx.positions)
        _update_cache(state["k_rope"], k_rope, ctx.write_idx, ctx.positions)
        cc, kr = state["c_kv"], state["k_rope"]
        k_pos = torch.arange(cc.shape[1], device=x.device)[None]
    mask = _causal_mask(ctx.positions, k_pos, ctx.lengths)  # (B,1,1,S,L)

    w_uk = p.w_uk.reshape(lora, nq, nope)
    w_uv = p.w_uv.reshape(lora, nq, vdim)
    if ctx.mode == "decode":
        # absorbed: score against the latent cache directly
        ccf = cc.float()
        q_abs = torch.einsum("bshn,rhn->bshr", q_nope.float(), w_uk.float())
        scores = (torch.einsum("bshr,blr->bhsl", q_abs, ccf)
                  + torch.einsum("bshr,blr->bhsl", q_rope.float(),
                                 kr.float())) * scale
        scores = torch.where(mask[:, 0], scores,
                             torch.tensor(NEG_INF, device=x.device))
        probs = torch.softmax(scores, dim=-1)
        o_lat = torch.einsum("bhsl,blr->bshr", probs, ccf)
        out = torch.einsum("bshr,rhv->bshv", o_lat, w_uv.float()).to(x.dtype)
    else:
        k_nope = torch.einsum("blr,rhn->blhn", cc, w_uk.to(cc.dtype))
        v = torch.einsum("blr,rhv->blhv", cc, w_uv.to(cc.dtype))
        k_full = torch.cat([k_nope, kr[:, :, None, :].expand(
            -1, -1, nq, -1)], -1)
        q_full = torch.cat([q_nope, q_rope], -1)
        out = _sdpa(q_full, k_full, v, mask, scale)
    out = out.reshape(B, S, nq * vdim) @ p.wo
    return out.to(x.dtype), state


# ---------------------------------------------------------------------------
# Cross attention (VLM image layers)
# ---------------------------------------------------------------------------

def apply_cross_attn(cfg: ModelConfig, p, x, state, ctx: ApplyCtx):
    """Attention from the text to the image embeddings.  Prefill projects
    ``ctx.image_embeds`` to k / v (k normed) and keeps them in the state;
    decode reads them back.  The output is scaled by tanh(gate)."""
    B, S, _ = x.shape
    dh, nq, nkv = cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads
    h = rmsnorm(x, p.ln1, cfg.norm_plus_one)
    q = rmsnorm((h @ p.wq).reshape(B, S, nq, dh), p.q_norm)
    if ctx.mode == "decode":
        k, v = state["xk"], state["xv"]
    else:
        if ctx.image_embeds is None:
            raise ValueError(f"{cfg.name}: a cross-attention prefill needs "
                             "image_embeds")
        ie = ctx.image_embeds.to(x.dtype)
        k = rmsnorm((ie @ p.wk).reshape(B, -1, nkv, dh), p.k_norm)
        v = (ie @ p.wv).reshape(B, -1, nkv, dh)
        if state is not None:
            state["xk"].copy_(k)
            state["xv"].copy_(v)
    out = _sdpa(q, k, v, None, dh ** -0.5)
    out = out.reshape(B, S, nq * dh) @ p.wo
    out = torch.tanh(p.gate.float()).to(x.dtype) * out
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
# Mixture of Experts: the reference's dense path (every expert computed on
# every token, combined by the routing gates), which is what it runs on one
# device; its expert-parallel path is the sharded one (ROADMAP A11).
# ---------------------------------------------------------------------------

def _router(cfg: ModelConfig, p, h):
    """Softmax router, top-k renormalised, and the Switch load-balance aux
    loss coef * E * sum(mean prob x share of routed (token, k) pairs)."""
    m = cfg.moe
    logits = h.float() @ p.router.float()
    probs = torch.softmax(logits, dim=-1)                # (..., E)
    top_p, top_i = torch.topk(probs, m.top_k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    flat = probs.reshape(-1, m.num_experts)
    me = flat.mean(0)
    ce = torch.zeros(m.num_experts, dtype=torch.float32, device=h.device)
    ce = ce.index_add_(0, top_i.reshape(-1), torch.ones(
        top_i.numel(), dtype=torch.float32, device=h.device))
    ce = ce / max(flat.shape[0] * m.top_k, 1)
    aux = m.router_aux_coef * m.num_experts * (me * ce).sum()
    return top_p, top_i, aux


def _moe_dense_path(cfg: ModelConfig, p, h, top_p, top_i):
    """Every expert on every token.  ``torch.matmul`` of the (T, d) tokens
    with the (E, d, f) experts broadcasts the tokens over E and reads the
    expert weights in place (an einsum may permute a copy of them)."""
    m = cfg.moe
    B, S, d = h.shape
    x = h.reshape(B * S, d)
    gates = torch.zeros((B * S, m.num_experts), dtype=h.dtype,
                        device=h.device)
    gates.scatter_(1, top_i.reshape(B * S, -1),
                   top_p.reshape(B * S, -1).to(h.dtype))
    g = _act(torch.matmul(x, p.we_gate), cfg.act)       # (E, T, f)
    u = torch.matmul(x, p.we_up)
    ye = torch.matmul(g * u, p.we_down)                  # (E, T, d)
    y = torch.einsum("etd,te->td", ye, gates)
    return y.reshape(B, S, d)


def apply_moe_ffn(cfg: ModelConfig, p, x):
    """Routed experts plus the shared ones.  Returns (out, aux)."""
    h = rmsnorm(x, p.ln2, cfg.norm_plus_one)
    top_p, top_i, aux = _router(cfg, p, h)
    y = _moe_dense_path(cfg, p, h, top_p, top_i)
    if cfg.moe.num_shared:
        y = y + (_act(h @ p.ws_gate, cfg.act) * (h @ p.ws_up)) @ p.ws_down
    if cfg.post_norms:
        y = rmsnorm(y, p.ln2_post, cfg.norm_plus_one)
    return y.to(x.dtype), aux


# ---------------------------------------------------------------------------
# Mamba (selective SSM): causal depthwise conv + sequential scan.  The
# reference has no kernel for it either.
# ---------------------------------------------------------------------------

def _mamba_ssm_params(cfg: ModelConfig, p, xc):
    """xc: (B, S, di) post-conv activations -> dt, B, C (f32)."""
    mc = cfg.mamba
    dtr = mc.dt_rank or -(-cfg.d_model // 16)
    x_dbl = xc @ p.x_proj
    dt = F.softplus(x_dbl[..., :dtr] @ p.dt_w + p.dt_b.float())
    Bm = x_dbl[..., dtr:dtr + mc.d_state].float()
    Cm = x_dbl[..., dtr + mc.d_state:].float()
    return dt.float(), Bm, Cm


def apply_mamba(cfg: ModelConfig, p, x, state, ctx: ApplyCtx):
    """With ``ctx.lengths`` (a padded prompt or chunk) dt and x are zeroed
    past each row's length, so the state stops there, and the conv state is
    taken from the last d_conv - 1 *valid* inputs, in chunk-local
    coordinates (absolute length minus chunk start)."""
    B, S, d = x.shape
    mc = cfg.mamba
    di, K = mc.expand * d, mc.d_conv
    h = rmsnorm(x, p.ln1, cfg.norm_plus_one)
    xz = h @ p.in_proj
    xi, z = xz[..., :di], xz[..., di:]
    if state is None:
        conv0 = torch.zeros((B, K - 1, di), dtype=x.dtype, device=x.device)
        hs = torch.zeros((B, di, mc.d_state), dtype=torch.float32,
                         device=x.device)
    else:
        conv0, hs = state["conv"].to(x.dtype), state["ssm"].float()
    xp = torch.cat([conv0, xi], dim=1)                   # (B, K-1+S, di)
    xc = sum(xp[:, i:i + S] * p.conv_w[i] for i in range(K)) + p.conv_b
    conv1 = xp[:, S:]
    xc = F.silu(xc)
    dt, Bm, Cm = _mamba_ssm_params(cfg, p, xc)
    A = -torch.exp(p.A_log.float())                      # (di, ds)
    xcf = xc.float()
    if ctx.lengths is not None:
        m = (ctx.positions < ctx.lengths[:, None]).float()[:, :, None]
        dt, xcf = dt * m, xcf * m
        loc = (ctx.lengths - ctx.positions[:, 0]).clamp(0, S).long()
        rows = loc[:, None] + torch.arange(K - 1, device=x.device)[None]
        conv1 = xp[torch.arange(B, device=x.device)[:, None], rows]
    ys = []
    for t in range(S):
        dt_t = dt[:, t, :, None]                         # (B, di, 1)
        hs = (torch.exp(dt_t * A[None]) * hs
              + dt_t * Bm[:, t, None, :] * xcf[:, t, :, None])
        ys.append(torch.einsum("bds,bs->bd", hs, Cm[:, t]))
    y = torch.stack(ys, dim=1) + xcf * p.D.float()
    out = (y.to(x.dtype) * F.silu(z)) @ p.out_proj
    if state is not None:
        state["ssm"].copy_(hs)
        state["conv"].copy_(conv1)
    return out.to(x.dtype), state


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
