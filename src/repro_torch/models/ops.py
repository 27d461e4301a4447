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
torch ops on every device.  Under ``sharding.axis_rules(rules, mesh)``
with "experts" on the mesh, ``apply_moe_ffn`` takes the reference's
expert-parallel path over ``torch.distributed`` (``_moe_ep_path``), and
every mixer and FFN computes on the shards its build split over "heads",
"kv_heads" and "ff" (column- / row-parallel, a split section below and in
each layer's docstring).  Train mode (``forward_train``) has no state:
attention runs over the sequence's own keys, through the prefill kernel
at offset 0, and the recurrent layers start from zero.  An int8 KV cache
is quantised on write (``_quant_kv``) and dequantised to the activation
dtype before attention, so the kernels see bf16 / f32.  Accumulations
are f32; activations run in cfg.dtype.  The state (KV caches, latent
caches, image keys / values, recurrent states) is updated in place.
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
from repro_torch.models.params import built_axes
from repro_torch.scan import scan
from repro_torch.sharding import (_entry_axes, all_gather, all_reduce,
                                  axes_size, axis_group, current_mesh,
                                  current_rules, logical_to_pspec, mesh_axes,
                                  reduce_scatter, shard_index)

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
    mesh = current_mesh()
    if mesh is not None:
        plan = _attn_plan(cfg, p, state, mesh)
        if plan is not None:
            return _apply_attn_tp(cfg, p, x, state, ctx, plan)
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
# Tensor parallelism over the mesh, the reference's "heads", "kv_heads", "ff"
# and "vocab" rules, and the decode cache split over its positions ("ctx").
# Each rank holds the leaves as the model was built (``init_params(...,
# mesh, rules)``: ``logical_to_pspec`` cuts the FLATTENED head dims, so a
# rank may hold part of a head); the collectives are explicit, where the
# reference leaves them to GSPMD.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Split:
    """A dim cut into `n` equal shards over the process group `group`;
    this rank holds shard `i`."""
    group: object
    n: int
    i: int


def _split_over(mesh, axes) -> Optional[Split]:
    sizes = mesh_axes(mesh)
    axes = tuple(a for a in axes if sizes.get(a, 1) > 1)
    if not axes:
        return None
    i, n = shard_index(axes, mesh)
    return Split(axis_group(mesh, axes), n, i)


def leaf_split(p, name: str, dim: int, mesh) -> Optional[Split]:
    """How dim `dim` of leaf `name` of module `p` was cut when the model was
    built (``built_axes``), or None where it is whole (or no mesh)."""
    if mesh is None:
        return None
    axes = built_axes(p, name, mesh)
    return None if axes is None else _split_over(mesh, axes[dim])


@dataclass(frozen=True)
class _AttnPlan:
    q: Optional[Split]         # wq's columns (= wo's rows, bq)
    kv: Optional[Split]        # wk's / wv's columns (bk, bv)
    ctx: Optional[Split]       # the cache's positions
    cache_heads: tuple[int, int]   # the kv heads the rank's cache holds


def _cache_layout(cfg: ModelConfig, mesh):
    """(the Split of the cache's positions, (first, last + 1) of the kv
    heads it holds) under the active rules: the cache leaf's spec, the
    reference's ("batch", "ctx", "kv_heads", None).  A "ctx" mapping is
    taken as given (``models.params.shard_state`` refuses one that does not
    divide the cache length); "kv_heads" splits only where it divides."""
    spec = logical_to_pspec(("batch", "ctx", "kv_heads", None),
                            current_rules() or {}, None, mesh)
    spec = spec + (None,) * (3 - len(spec))
    ctx = _split_over(mesh, _entry_axes(spec[1]))
    kv = _split_over(mesh, _entry_axes(spec[2]))
    nkv = cfg.num_kv_heads
    if kv is None or nkv % kv.n:
        return ctx, (0, nkv)
    per = nkv // kv.n
    return ctx, (kv.i * per, (kv.i + 1) * per)


def _attn_plan(cfg: ModelConfig, p, state, mesh) -> Optional[_AttnPlan]:
    """The layer's tensor-parallel layout under `mesh`, or None where
    nothing is split (the single-device path then runs as it is)."""
    sq, skv = leaf_split(p, "wq", 1, mesh), leaf_split(p, "wk", 1, mesh)
    ctx, heads = (None, (0, cfg.num_kv_heads)) if state is None \
        else _cache_layout(cfg, mesh)
    if (sq, skv, ctx, heads) == (None, None, None, (0, cfg.num_kv_heads)):
        return None
    if skv is not None and (sq is None or sq.group != skv.group):
        raise NotImplementedError(
            f"{cfg.name}: kv projections split where the q projection is "
            "not, or over other axes")
    if state is not None and tuple(state["k"].shape[2:3]) \
            != (heads[1] - heads[0],):
        raise ValueError(f"{cfg.name}: the cache holds {state['k'].shape[2]}"
                         f" kv heads, the rules give {heads}: cut it with "
                         "shard_state under the same (mesh, rules)")
    return _AttnPlan(sq, skv, ctx, heads)


def _span(t, split: Optional[Split], lo: int, hi: int, partial: bool):
    """Columns [lo, hi) of the whole last dim of `t` (an activation or a
    leaf), of which this rank holds `split`'s shard (all of it when None):
    sliced where they lie in the rank's shard, else from the shards
    gathered whole (``_Gather``, `partial` as its)."""
    C = t.shape[-1]
    if split is not None:
        c0 = split.i * C
        if c0 <= lo and hi <= c0 + C:
            return t[..., lo - c0:hi - c0]
        t = _Gather.apply(t, split, t.dim() - 1, partial)
    return t[..., lo:hi]


def _heads(t, split: Optional[Split], lo: int, hi: int, dh: int,
           partial: bool):
    """Heads [lo, hi) of a (B, S, H dh) projection of which this rank holds
    `split`'s columns (``_span``)."""
    return _span(t, split, lo * dh, hi * dh, partial).unflatten(
        -1, (hi - lo, dh))


def _cols(split: Optional[Split], C: int, whole: int) -> tuple[int, int]:
    """[c0, c1) of a dim of `whole` of which this rank holds `split`'s C."""
    return (0, whole) if split is None else (split.i * C, (split.i + 1) * C)


def _cover(c0: int, c1: int, dh: int) -> tuple[int, int]:
    """The heads of width `dh` that cover columns [c0, c1)."""
    return c0 // dh, -(-c1 // dh)


def _enter(x, split: Optional[Split]):
    """``_Enter`` over `split`'s group; `x` itself where nothing is split."""
    return x if split is None else _Enter.apply(x, split.group)


def _leave(y, split: Optional[Split]):
    """``_Leave`` over `split`'s group; `y` itself where nothing is split."""
    return y if split is None else _Leave.apply(y, split.group)


def _state_split(leaf, axes, dim: int, whole: int,
                 mesh) -> Optional[Split]:
    """How dim `dim` (of `whole` entries) of the rank's state `leaf`, of
    logical `axes`, is cut under the active rules: ``shard_state``'s cut,
    where a mapping that does not divide the dim is dropped."""
    if mesh is None:
        return None
    shape = list(leaf.shape)
    shape[dim] = whole
    spec = logical_to_pspec(axes, current_rules() or {}, tuple(shape), mesh)
    e = (spec + (None,) * len(axes))[dim]
    sp = _split_over(mesh, _entry_axes(e))
    if leaf.shape[dim] != whole // (1 if sp is None else sp.n):
        raise ValueError(f"a state leaf of {tuple(leaf.shape)} under rules "
                         f"that cut dim {dim} of {whole} over {e}: cut it "
                         "with shard_state under the same (mesh, rules)")
    return sp


def _group_kv(k, v, q0: int, nq: int, k0: int, G: int):
    """k / v of kv heads [k0, ...) for query heads [q0, q0 + nq) of groups
    of G: as they are where every kv head serves the same number of those
    query heads (the kernels' Hq / Hkv grouping), else one kv head per
    query head."""
    k1 = (q0 + nq - 1) // G + 1
    if k1 - q0 // G == 1 or (q0 % G == 0 and nq % G == 0):
        return k[:, :, q0 // G - k0:k1 - k0], v[:, :, q0 // G - k0:k1 - k0]
    idx = torch.arange(q0, q0 + nq, device=k.device) // G - k0
    return k[:, :, idx], v[:, :, idx]


def _dequant(vals, scales, dtype):
    return vals.to(dtype) * scales[..., None].to(dtype)


def _write_owned(cfg: ModelConfig, state, k, v, ctx: ApplyCtx,
                 plan: _AttnPlan):
    """Write the new rows `k` / `v` (B, S, heads, D) of the heads the cache
    holds, in place (``_write_rows``); an int8 cache gets values and
    scales."""
    news = {}
    for name, new in (("k", k), ("v", v)):
        if cfg.kv_cache_dtype == "int8":
            vals, scales = _quant_kv(new)
            news[name], news[f"{name}_scale"] = vals, scales
        else:
            news[name] = new
    _write_rows(state, news, ctx, plan.ctx)


def _write_rows(state, news: dict, ctx: ApplyCtx, cs: Optional[Split]):
    """Write each of `news` (B, S, ...) into the cache of its name at the
    chunk's offsets, in place: with the caches split over their positions
    (`cs`), only the rows of the positions this rank holds (the host picks
    them from ``ctx.write_idx``)."""
    if cs is None:
        for name, new in news.items():
            _update_cache(state[name], new, ctx.write_idx, ctx.positions)
        return
    name, first = next(iter(news.items()))
    L = state[name].shape[1]
    pos0 = cs.i * L
    B, S = first.shape[:2]
    pos = ctx.write_idx[:, None] + np.arange(S)[None]
    if not ((pos >= 0) & (pos < L * cs.n)).all():
        raise IndexError(f"cache write of {S} rows at "
                         f"{ctx.write_idx.tolist()} outside a cache of "
                         f"{L * cs.n}")
    bb, tt = np.nonzero((pos >= pos0) & (pos < pos0 + L))
    if len(bb):
        dev = first.device
        bi, ti = (torch.as_tensor(a).to(dev) for a in (bb, tt))
        rows = torch.as_tensor(pos[bb, tt] - pos0).to(dev)
        for name, new in news.items():
            state[name][bi, rows] = new[bi, ti].to(state[name].dtype)


def _cache_read(cfg: ModelConfig, state, dtype, plan: _AttnPlan,
                whole: bool):
    """The rank's cache as attention reads it (dequantised for int8), or
    with `whole` and a cache split over its positions, the slices
    gathered over the split's group in position order."""
    kc, vc = state["k"], state["v"]
    if cfg.kv_cache_dtype == "int8":
        kc = _dequant(kc, state["k_scale"], dtype)
        vc = _dequant(vc, state["v_scale"], dtype)
    if whole and plan.ctx is not None:
        kc, vc = (all_gather(t, plan.ctx.group, plan.ctx.n).movedim(0, 1)
                  .flatten(1, 2) for t in (kc, vc))
    return kc, vc


def _ctx_decode(cfg: ModelConfig, q, kc, vc, ctx: ApplyCtx, scale,
                plan: _AttnPlan):
    """Decode against a cache split over its positions: this rank's slice
    scored by every query head (``decode_attention_partial``, or its plain
    version), the slices' (o, lse) gathered over the split's group in
    position order and merged by their log-sum-exp weights.  Returns (B,
    1, Hq, D) in q's dtype."""
    L = kc.shape[1]
    pos0 = plan.ctx.i * L
    fn = kref.decode_attention_partial_ref if ctx.plain_kernels \
        else kops.decode_attention_partial
    o, lse = fn(q[:, 0].contiguous(), kc.contiguous(), vc.contiguous(),
                ctx.positions[:, 0], pos0, window=ctx.window,
                softcap=float(cfg.attn_softcap), scale=scale)
    o = all_gather(o, plan.ctx.group, plan.ctx.n)
    lse = all_gather(lse, plan.ctx.group, plan.ctx.n)
    return kref.merge_decode_partials(o, lse).to(q.dtype)[:, None]


def _apply_attn_tp(cfg: ModelConfig, p, x, state, ctx: ApplyCtx,
                   plan: _AttnPlan):
    """``apply_attn`` on this rank's shards (module section above).

    * q / k / v are column-parallel (``_Enter`` before them; a projection
      the build kept whole enters after it), ``wo`` row-parallel (its
      partial output summed over the group by ``_Leave``).
    * Attention runs on the query heads that cover the rank's q columns:
      whole heads with no gather where the head count divides the split,
      else the projection gathered whole first; its kv heads are sliced
      to them.  After attention the rank's columns go to ``wo``.
    * A cache split over its positions is written by the owner of each
      new row (the new k / v gathered to whole heads first); decode scores
      every query head against the rank's positions and merges the
      slices (``_ctx_decode``); a prefill at offset 0 attends the fresh k /
      v, a chunk at a later offset the cache gathered whole."""
    B, S, _ = x.shape
    dh, nq, nkv = cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads
    G = nq // nkv
    sq, skv = plan.q, plan.kv
    h = rmsnorm(x, p.ln1, cfg.norm_plus_one)
    hin = h if sq is None else _Enter.apply(h, sq.group)

    def proj(w, b, split):
        y = (h if split is None else hin) @ w
        if b is not None:
            y = y + b
        if split is None and sq is not None:
            y = _Enter.apply(y, sq.group)     # whole, used rank by rank
        return y

    bias = cfg.qkv_bias
    q = proj(p.wq, p.bq if bias else None, sq)
    k = proj(p.wk, p.bk if bias else None, skv)
    v = proj(p.wv, p.bv if bias else None, skv)
    # the rank's q columns [c0, c1) and the query heads [qa, qb) attention
    # computes: those covering the columns, or every head against a slice
    # of the cache's positions
    c0, c1 = (0, nq * dh) if sq is None else (sq.i * q.shape[-1],
                                              (sq.i + 1) * q.shape[-1])
    split_decode = ctx.mode == "decode" and plan.ctx is not None
    qa, qb = (0, nq) if split_decode else (c0 // dh, -(-c1 // dh))
    ka, kb = qa // G, (qb - 1) // G + 1
    # kv heads needed: attention's, and those the cache holds for writing
    wa, wb = (0, nkv) if plan.ctx is not None else plan.cache_heads
    na, nb = (ka, kb) if state is None else (min(ka, wa), max(kb, wb))
    partial = sq is not None
    qh = apply_rope(_heads(q, sq, qa, qb, dh, partial), ctx.positions,
                    cfg.rope_theta)
    kh = apply_rope(_heads(k, skv, na, nb, dh, partial), ctx.positions,
                    cfg.rope_theta)
    vh = _heads(v, skv, na, nb, dh, partial)
    scale = cfg.query_scale or dh ** -0.5

    # a prompt at offset 0 attends its fresh rows (all its keys), as the
    # cache stores them
    fresh = state is None or (ctx.mode == "prefill"
                              and not ctx.write_idx.any())
    if state is not None:
        _write_owned(cfg, state, kh[:, :, wa - na:wb - na],
                     vh[:, :, wa - na:wb - na], ctx, plan)
    if split_decode:
        kc, vc = _cache_read(cfg, state, x.dtype, plan, whole=False)
        out = _ctx_decode(cfg, qh, kc, vc, ctx, scale, plan)
    else:
        if fresh:
            kc, vc, k0 = kh, vh, na
            if state is not None and cfg.kv_cache_dtype == "int8":
                kc, vc = (_dequant(*_quant_kv(t), x.dtype) for t in (kh, vh))
        else:
            if not wa <= ka < kb <= wb:
                raise NotImplementedError(
                    f"{cfg.name}: query heads [{qa}, {qb}) read kv heads "
                    f"[{ka}, {kb}), the rank's cache holds [{wa}, {wb})")
            kc, vc = _cache_read(cfg, state, x.dtype, plan, whole=True)
            k0 = wa
        kc, vc = _group_kv(kc, vc, qa, qb - qa, k0, G)
        if ctx.plain_kernels:
            k_pos = torch.arange(kc.shape[1], device=x.device)[None]
            mask = _causal_mask(ctx.positions, k_pos, ctx.lengths,
                                ctx.window)
            out = _sdpa(qh, kc, vc, mask, scale, cfg.attn_softcap)
        else:
            out = _kernel_attn(cfg, qh, kc.contiguous(), vc.contiguous(),
                               ctx, scale)
    out = out.reshape(B, S, (qb - qa) * dh)[..., c0 - qa * dh:c1 - qa * dh]
    out = out @ p.wo
    if sq is not None:
        out = _Leave.apply(out, sq.group)
    if cfg.post_norms:
        out = rmsnorm(out, p.ln1_post, cfg.norm_plus_one)
    return out.to(x.dtype), state


# ---------------------------------------------------------------------------
# MLA (DeepSeek latent attention): naive expansion for train / prefill /
# chunks, weight-absorbed f32 scoring against the latent cache for decode.
# The reference routes it through no kernel (its _sdpa and einsums).
# ---------------------------------------------------------------------------

def _ctx_split(mesh, axes) -> Optional[Split]:
    """The Split of a cache's positions under the active rules: the "ctx"
    entry of the cache leaf's spec (`axes`), taken as given
    (``models.params.shard_state`` refuses one that does not divide)."""
    if mesh is None:
        return None
    spec = logical_to_pspec(axes, current_rules() or {}, None, mesh)
    return _split_over(mesh, _entry_axes(
        (spec + (None,) * len(axes))[axes.index("ctx")]))


def _same_split(cfg: ModelConfig, p, mesh, names) -> Optional[Split]:
    """The one Split of leaves `names` (name, dim), all cut alike over one
    group or all whole; the layer's tensor-parallel code takes nothing
    else."""
    splits = [leaf_split(p, n, d, mesh) for n, d in names]
    if any((sp is None) != (splits[0] is None) or (
            sp is not None and (sp.group, sp.n) != (splits[0].group,
                                                     splits[0].n))
           for sp in splits):
        raise NotImplementedError(
            f"{cfg.name}: {[n for n, _ in names]} split unalike "
            f"({splits})")
    return splits[0]


def _mla_partial(scores, ccf, cs: Split):
    """Absorbed decode over this rank's slice of the latent cache: scores
    (B, H, 1, L) masked with NEG_INF, ccf (B, L, r) -> the slices' latent
    outputs merged by their log-sum-exp weights (``merge_decode_partials``
    of the (o, lse) gathered over the split), (B, 1, H, r) f32.  A slice
    with no live position has lse NEG_INF + log L and weighs nothing."""
    m = scores.amax(-1, keepdim=True)
    pe = torch.exp(scores - m)
    den = pe.sum(-1)                                     # (B, H, 1)
    o = torch.einsum("bhsl,blr->bhr", pe, ccf) / den
    lse = m[..., 0, 0] + torch.log(den[..., 0])          # (B, H)
    o = all_gather(o.contiguous(), cs.group, cs.n)
    lse = all_gather(lse.contiguous(), cs.group, cs.n)
    return kref.merge_decode_partials(o, lse)[:, None]


def _apply_mla(cfg: ModelConfig, p, x, state, ctx: ApplyCtx):
    """Under a mesh whose build split the heads (``wq``, ``w_uk``,
    ``w_uv`` columns and ``wo`` rows over "heads") the rank computes the
    heads covering its ``wo`` rows (a projection whose columns cut a head
    is gathered, ``_span``) and ``wo`` is row-parallel (``_Leave``);
    ``w_dkv`` and ``kv_norm`` stay whole, so c_kv / k_rope are whole on
    every rank.  A latent cache split over its positions ("ctx") is
    written by the owner of each row; a prompt at offset 0 attends its
    fresh rows, a later chunk the cache gathered whole, and decode scores
    every head against the rank's positions and merges the slices
    (``_mla_partial``)."""
    B, S, _ = x.shape
    nq = cfg.num_heads
    nope, rope, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    lora = cfg.kv_lora_rank
    mesh = current_mesh()
    so = _same_split(cfg, p, mesh, (("wq", 1), ("w_uk", 1), ("w_uv", 1),
                                    ("wo", 0)))
    cs = None if state is None else _ctx_split(mesh, ("batch", "ctx",
                                                      "kv_lora"))
    h = rmsnorm(x, p.ln1, cfg.norm_plus_one)
    q = _enter(h, so) @ p.wq                             # the rank's columns
    ckr = h @ p.w_dkv                                    # (B, S, lora+rope)
    c_kv = rmsnorm(ckr[..., :lora], p.kv_norm)
    k_rope = apply_rope(ckr[..., None, lora:], ctx.positions,
                        cfg.rope_theta)[:, :, 0]         # (B, S, rope)
    scale = (nope + rope) ** -0.5
    # the rank's wo rows [r0, r1) and the heads [qa, qb) scored: those
    # covering the rows, or every head against a slice of the positions
    r0, r1 = _cols(so, p.wo.shape[0], nq * vdim)
    ra, rb = _cover(r0, r1, vdim)
    split_decode = ctx.mode == "decode" and cs is not None
    qa, qb = (0, nq) if split_decode else (ra, rb)
    partial = so is not None
    q = _heads(q, so, qa, qb, nope + rope, partial)
    q_nope = q[..., :nope]
    q_rope = apply_rope(q[..., nope:], ctx.positions, cfg.rope_theta)
    w_uk = _span(p.w_uk, so, qa * nope, qb * nope, partial).reshape(
        lora, qb - qa, nope)
    w_uv = _span(p.w_uv, so, ra * vdim, rb * vdim, partial).reshape(
        lora, rb - ra, vdim)

    if ctx.mode == "train":
        cc, kr, k_pos = c_kv, k_rope, ctx.positions
    elif cs is None:
        _update_cache(state["c_kv"], c_kv, ctx.write_idx, ctx.positions)
        _update_cache(state["k_rope"], k_rope, ctx.write_idx, ctx.positions)
        cc, kr = state["c_kv"], state["k_rope"]
        k_pos = torch.arange(cc.shape[1], device=x.device)[None]
    else:
        _write_rows(state, {"c_kv": c_kv, "k_rope": k_rope}, ctx, cs)
        L = state["c_kv"].shape[1]
        if split_decode:
            cc, kr = state["c_kv"], state["k_rope"]
            k_pos = cs.i * L + torch.arange(L, device=x.device)[None]
        elif not ctx.write_idx.any():
            cc, kr, k_pos = c_kv, k_rope, ctx.positions
        else:
            cc, kr = (all_gather(state[n], cs.group, cs.n).movedim(0, 1)
                      .flatten(1, 2) for n in ("c_kv", "k_rope"))
            k_pos = torch.arange(L * cs.n, device=x.device)[None]
    mask = _causal_mask(ctx.positions, k_pos, ctx.lengths)  # (B,1,1,S,L)

    if ctx.mode == "decode":
        # absorbed: score against the latent cache directly
        ccf = cc.float()
        q_abs = torch.einsum("bshn,rhn->bshr", q_nope.float(), w_uk.float())
        scores = (torch.einsum("bshr,blr->bhsl", q_abs, ccf)
                  + torch.einsum("bshr,blr->bhsl", q_rope.float(),
                                 kr.float())) * scale
        scores = torch.where(mask[:, 0], scores,
                             torch.tensor(NEG_INF, device=x.device))
        if split_decode:
            o_lat = _mla_partial(scores, ccf, cs)[:, :, ra:rb]
        else:
            probs = torch.softmax(scores, dim=-1)
            o_lat = torch.einsum("bhsl,blr->bshr", probs, ccf)
        out = torch.einsum("bshr,rhv->bshv", o_lat, w_uv.float()).to(x.dtype)
    else:
        cc, kr = _enter(cc, so), _enter(kr, so)
        k_nope = torch.einsum("blr,rhn->blhn", cc, w_uk.to(cc.dtype))
        v = torch.einsum("blr,rhv->blhv", cc, w_uv.to(cc.dtype))
        k_full = torch.cat([k_nope, kr[:, :, None, :].expand(
            -1, -1, qb - qa, -1)], -1)
        q_full = torch.cat([q_nope, q_rope], -1)
        out = _sdpa(q_full, k_full, v, mask, scale)
    out = out.reshape(B, S, (rb - ra) * vdim)[..., r0 - ra * vdim:
                                              r1 - ra * vdim]
    out = _leave(out @ p.wo, so)
    return out.to(x.dtype), state


# ---------------------------------------------------------------------------
# Cross attention (VLM image layers)
# ---------------------------------------------------------------------------

def apply_cross_attn(cfg: ModelConfig, p, x, state, ctx: ApplyCtx):
    """Attention from the text to the image embeddings.  Prefill projects
    ``ctx.image_embeds`` to k / v (k normed) and keeps them in the state;
    decode reads them back.  The output is scaled by tanh(gate).

    Under a mesh whose build split the heads, as ``_apply_attn_tp``: q / k
    / v column-parallel, the query heads covering the rank's ``wq``
    columns and their kv heads (a projection whose columns cut a head
    gathered), ``wo`` row-parallel; the state holds the kv heads of its
    cut over "kv_heads" (all of them where that does not divide)."""
    B, S, _ = x.shape
    dh, nq, nkv = cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads
    G = nq // nkv
    mesh = current_mesh()
    sq, skv = leaf_split(p, "wq", 1, mesh), leaf_split(p, "wk", 1, mesh)
    if skv is not None and (sq is None or sq.group != skv.group):
        raise NotImplementedError(
            f"{cfg.name}: kv projections split where the q projection is "
            "not, or over other axes")
    h = rmsnorm(x, p.ln1, cfg.norm_plus_one)
    c0, c1 = _cols(sq, p.wq.shape[1], nq * dh)
    qa, qb = _cover(c0, c1, dh)
    ka, kb = qa // G, (qb - 1) // G + 1
    partial = sq is not None
    # the per-head norms' weights are whole, used rank by rank
    q = rmsnorm(_heads(_enter(h, sq) @ p.wq, sq, qa, qb, dh, partial),
                _enter(p.q_norm, sq))
    sx = None if state is None else _state_split(
        state["xk"], ("batch", None, "kv_heads", None), 2, nkv, mesh)
    wa, wb = _cols(sx, nkv // (1 if sx is None else sx.n), nkv)
    if ctx.mode == "decode":
        k, v, k0 = state["xk"], state["xv"], wa
        if not wa <= ka < kb <= wb:
            raise NotImplementedError(
                f"{cfg.name}: query heads [{qa}, {qb}) read kv heads "
                f"[{ka}, {kb}), the rank's state holds [{wa}, {wb})")
    else:
        if ctx.image_embeds is None:
            raise ValueError(f"{cfg.name}: a cross-attention prefill needs "
                             "image_embeds")
        ie = ctx.image_embeds.to(x.dtype)
        k0, kn = (ka, kb) if state is None else (min(ka, wa), max(kb, wb))

        def proj(w):
            y = _enter(ie, skv) @ w if skv is not None \
                else _enter(ie @ w, sq)
            return _heads(y, skv, k0, kn, dh, partial)
        k = rmsnorm(proj(p.wk), _enter(p.k_norm, sq))
        v = proj(p.wv)
        if state is not None:
            state["xk"].copy_(k[:, :, wa - k0:wb - k0])
            state["xv"].copy_(v[:, :, wa - k0:wb - k0])
    k, v = _group_kv(k, v, qa, qb - qa, k0, G)
    out = _sdpa(q, k, v, None, dh ** -0.5)
    out = out.reshape(B, S, (qb - qa) * dh)[..., c0 - qa * dh:c1 - qa * dh]
    out = _leave(out @ p.wo, sq)
    out = torch.tanh(p.gate.float()).to(x.dtype) * out
    return out.to(x.dtype), state


# ---------------------------------------------------------------------------
# Dense gated FFN
# ---------------------------------------------------------------------------

def apply_dense_ffn(cfg: ModelConfig, p, x):
    """Under a mesh whose build split d_ff ("ff"), w_gate / w_up are
    column-parallel and w_down row-parallel: the rank's partial output is
    summed over the split's group (``_Enter`` / ``_Leave``)."""
    h = rmsnorm(x, p.ln2, cfg.norm_plus_one)
    sf = leaf_split(p, "w_gate", 1, current_mesh())
    if sf is not None:
        h = _Enter.apply(h, sf.group)
    g = _act(h @ p.w_gate, cfg.act)
    u = h @ p.w_up
    out = (g * u) @ p.w_down
    if sf is not None:
        out = _Leave.apply(out, sf.group)
    if cfg.post_norms:
        out = rmsnorm(out, p.ln2_post, cfg.norm_plus_one)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Mixture of Experts
#   * dense path: every expert computed on every token, combined by the
#     routing gates (one device, or no mesh active)
#   * expert-parallel path: under ``sharding.axis_rules(rules, mesh)`` with
#     "experts" on mesh axes, each rank runs its own experts on the
#     (token, k) pairs routed to them, capacity-bounded (GShard-style
#     dropping), and the partial outputs are summed over the ranks
# ---------------------------------------------------------------------------

#: (token, k) pairs routed to this rank's experts by the expert-parallel
#: path, and those of them dropped past an expert's capacity: device
#: scalars (or 0), summed over calls until ``reset_ep_pairs``
EP_PAIRS = {"routed": 0, "dropped": 0}


def reset_ep_pairs():
    for name in EP_PAIRS:
        EP_PAIRS[name] = 0


class _SumShards(torch.autograd.Function):
    """`x` summed over `group` forward; identity backward.  Each rank of
    the group adds the same function of the sum to its loss, and the train
    step sums the ranks' gradients: each rank's part of the sum's gradient
    is its own share, counted once."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _router(cfg: ModelConfig, p, h, shards=None):
    """Softmax router, top-k renormalised, and the Switch load-balance aux
    loss coef * E * sum(mean prob x share of routed (token, k) pairs).
    With `shards` = (group, n), h is one of n equal shards of the batch
    over `group`, and the mean and the share are the whole batch's: the
    experts' sums of probs and their pair counts are summed over the
    group before the product (``_SumShards``)."""
    m = cfg.moe
    logits = h.float() @ p.router.float()
    probs = torch.softmax(logits, dim=-1)                # (..., E)
    top_p, top_i = torch.topk(probs, m.top_k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    flat = probs.reshape(-1, m.num_experts)
    ce = torch.zeros(m.num_experts, dtype=torch.float32, device=h.device)
    ce = ce.index_add_(0, top_i.reshape(-1), torch.ones(
        top_i.numel(), dtype=torch.float32, device=h.device))
    if shards is None:
        tokens, me = flat.shape[0], flat.mean(0)
    else:
        group, n = shards
        tokens = flat.shape[0] * n
        me = _SumShards.apply(flat.sum(0), group) / tokens
        ce = all_reduce(ce, group)
    ce = ce / max(tokens * m.top_k, 1)
    aux = m.router_aux_coef * m.num_experts * (me * ce).sum()
    return top_p, top_i, aux


def _expert_ffn(cfg: ModelConfig, we_gate, we_up, we_down, xe):
    """xe: (E, C, d) -> (E, C, d)."""
    g = _act(torch.matmul(xe, we_gate), cfg.act)
    u = torch.matmul(xe, we_up)
    return torch.matmul(g * u, we_down)


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


class _Gather(torch.autograd.Function):
    """A tensor's shards along `dim` gathered whole over `split`'s group
    forward: FSDP'd expert weights (the reference's ``shard_map`` in_spec),
    or tensor-parallel activations.  Backward, with `partial` (each rank
    uses the whole tensor for its own part of a sum that leaves the group
    by ``_Leave``) the gradient summed over the group and cut back to this
    rank's shard (a reduce-scatter); without (every rank uses it alike)
    this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, split, dim, partial):
        ctx.split, ctx.dim, ctx.partial = split, dim, partial
        return all_gather(x, split.group, split.n).movedim(0, dim).flatten(
            dim, dim + 1)

    @staticmethod
    def backward(ctx, g):
        sp, dim = ctx.split, ctx.dim
        parts = g.unflatten(dim, (sp.n, g.shape[dim] // sp.n)).movedim(dim, 0)
        if ctx.partial:
            return reduce_scatter(parts, sp.group), None, None, None
        return parts[sp.i].contiguous(), None, None, None


class _Enter(torch.autograd.Function):
    """Where replicated tokens enter the expert group: identity forward,
    the group's sum of the partial gradients backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Leave(torch.autograd.Function):
    """Where the partial outputs leave it: summed over the group forward,
    identity backward (every rank holds the same output gradient)."""

    @staticmethod
    def forward(ctx, y, group):
        return all_reduce(y.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AuxMean(torch.autograd.Function):
    """The mean of the ranks' aux losses over `group` (N ranks) forward;
    backward each rank's share of a mean over the n_batch batch shards
    (the EP ranks of one shard hold the same aux)."""

    @staticmethod
    def forward(ctx, aux, group, n, n_batch):
        ctx.n_batch = n_batch
        return all_reduce(aux.clone(), group) / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n_batch, None, None, None


def _batch_axes(mesh, rules, exclude=()) -> tuple[str, ...]:
    """The mesh axes that the rules' "batch" maps to, but `exclude`."""
    return tuple(a for a in rules.get("batch", ())
                 if a in mesh.mesh_dim_names and a not in exclude)


def _expert_weights(cfg: ModelConfig, p, mesh, ep_axes, ff_axes):
    """(we_gate, we_up, we_down) of this rank's experts, with d_ff split
    over `ff_axes` (whole when empty): the layout the path computes in.  A
    model built under other rules holds d_ff split over its build's
    "expert_ff" axes: those shards are gathered (``_Gather``), and cut
    to `ff_axes` where these split it, as the reference's ``shard_map``
    in_specs reshard its weights.  A layer that does not say how it was
    built must already hold that layout."""
    m = cfg.moe
    have = built_axes(p, "we_gate", mesh)
    have = ff_axes if have is None else have[2]
    out = []
    for name, dim in (("we_gate", 2), ("we_up", 2), ("we_down", 1)):
        w = getattr(p, name)
        if have != ff_axes and have:
            i, n = shard_index(have, mesh)
            w = _Gather.apply(w, Split(axis_group(mesh, have), n, i), dim,
                              True)
        if have != ff_axes and ff_axes:
            i, n = shard_index(ff_axes, mesh)
            f = w.shape[dim] // n
            w = w.narrow(dim, i * f, f)
        out.append(w)
    want = (m.num_experts // axes_size(mesh, ep_axes), cfg.d_model,
            m.d_ff_expert // axes_size(mesh, ff_axes))
    if tuple(out[0].shape) != want:
        raise ValueError(
            f"{cfg.name}: local experts {tuple(out[0].shape)}, but the "
            f"rules' {'decode' if ff_axes else 'token'} layout needs "
            f"{want}: build the model under the same (mesh, rules)")
    return out


def _dispatch_combine(cfg: ModelConfig, w, x, top_p, top_i, lo: int):
    """The reference's ``local_moe`` for this rank's experts [lo, lo +
    E_local), whose weights `w` are (we_gate, we_up, we_down): x (T, d)
    tokens; top_p / top_i (T, k).  Each (token, k) pair
    routed here takes the next slot of its expert (an exclusive cumsum over
    the pairs in token-major order); past cap = max(8, T k / E x capacity
    factor) it is dropped: it adds zero, and its output is read at slot
    min(pos, cap - 1) with weight 0.  Returns this rank's partial (T, d)."""
    m = cfg.moe
    T, d = x.shape
    e_local = w[0].shape[0]
    cap = int(max(8, T * m.top_k / m.num_experts * m.capacity_factor))
    flat_e = top_i.reshape(-1) - lo                      # (T*k,)
    local = (flat_e >= 0) & (flat_e < e_local)
    flat_e = torch.where(local, flat_e, 0)
    onehot = F.one_hot(flat_e, e_local) * local[:, None]  # (T*k, El)
    pos = onehot.cumsum(0) - onehot                      # pos within expert
    pos_e = (pos * onehot).sum(-1)                       # (T*k,)
    keep = local & (pos_e < cap)
    EP_PAIRS["routed"] = EP_PAIRS["routed"] + local.sum()
    EP_PAIRS["dropped"] = EP_PAIRS["dropped"] + (local & ~keep).sum()
    tok = torch.arange(T, device=x.device).repeat_interleave(m.top_k)
    slot = torch.where(keep, pos_e, cap - 1)
    buf = torch.zeros((e_local, cap, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((torch.where(keep, flat_e, 0), slot),
                        x[tok] * keep[:, None].to(x.dtype), accumulate=True)
    y_e = _expert_ffn(cfg, *w, buf)
    y_pairs = y_e[flat_e, torch.clamp(pos_e, max=cap - 1)]  # (T*k, d)
    gate = (top_p.reshape(-1) * keep).to(x.dtype)
    return (y_pairs * gate[:, None]).reshape(T, m.top_k, d).sum(1)


def _moe_ep_path(cfg: ModelConfig, p, h, mesh, ep_axes):
    """Expert-parallel MoE on this rank's shards, the reference's layouts:

    * S > 1 (train/prefill): h is this rank's shard of the batch over the
      rules' "batch" axes, the same on every rank of the EP group; each
      rank holds its E / n_ep experts whole.  Tokens and routing weights
      enter the group (``_Enter``) and the partial outputs leave it summed
      (``_Leave``): the gradients match the dense path's once every leaf's
      gradient is summed over the batch axes.
    * S == 1 (decode): weight-stationary.  Expert d_ff is split over the
      rules' "expert_ff" axes too, the batch's shards are gathered to
      every rank, and the partial outputs are summed over the EP + ff
      axes; each rank keeps its own rows.  Forward only.

    Each rank's expert slice [rank E_local, (rank + 1) E_local) and d_ff
    slice are those of ``sharding.local_slices`` under the same rules; a
    model built by ``init_params(..., mesh, rules)`` under param rules
    that split d_ff otherwise (FSDP over the batch axes) has its shards
    gathered or cut to that layout (``_expert_weights``).  The aux loss
    is the mean of the per-shard Switch losses over the EP + ff + batch
    axes.  Returns (y (B, S, d), aux)."""
    m = cfg.moe
    rules = current_rules() or {}
    names = mesh.mesh_dim_names
    B, S, d = h.shape
    stationary = S == 1
    batch_axes = _batch_axes(mesh, rules, ep_axes)
    ff_axes = tuple(a for a in rules.get("expert_ff", ())
                    if a in names and a not in ep_axes) \
        if stationary else ()
    if ff_axes and m.d_ff_expert % axes_size(mesh, ff_axes) != 0:
        ff_axes = ()
    n_ep = axes_size(mesh, ep_axes)
    e_local = m.num_experts // n_ep
    w = _expert_weights(cfg, p, mesh, ep_axes, ff_axes)
    ep_rank, _ = shard_index(ep_axes, mesh)
    lo = ep_rank * e_local
    group = axis_group(mesh, ep_axes + ff_axes)
    if not stationary:
        top_p, top_i, aux = _router(cfg, p, h)
        x = _Enter.apply(h.reshape(B * S, d), group)
        top_p = _Enter.apply(top_p.reshape(B * S, m.top_k), group)
        y = _dispatch_combine(cfg, w, x, top_p, top_i.reshape(-1, m.top_k),
                              lo)
        y = _Leave.apply(y, group).reshape(B, S, d)
        n_batch = axes_size(mesh, batch_axes)
        aux = _AuxMean.apply(aux, axis_group(mesh, ep_axes + batch_axes),
                             n_ep * n_batch, n_batch)
        return y, aux
    if torch.is_grad_enabled() and h.requires_grad:
        raise NotImplementedError(
            "the weight-stationary (S == 1) expert-parallel path has no "
            "backward")
    # gather the batch: each rank's rows at its shard's offset, summed
    # (decode batches are small); then back to its own rows at the end
    if batch_axes:
        row, n = shard_index(batch_axes, mesh)
        full = h.new_zeros((n * B, d))
        full[row * B:(row + 1) * B] = h[:, 0]
        hf = all_reduce(full, axis_group(mesh, batch_axes))
    else:
        row, hf = 0, h[:, 0]
    top_p, top_i, aux = _router(cfg, p, hf)
    y = all_reduce(_dispatch_combine(cfg, w, hf, top_p, top_i, lo), group)
    aux = all_reduce(aux, group) / axes_size(mesh, ep_axes + ff_axes)
    return y[row * B:(row + 1) * B, None], aux


def apply_moe_ffn(cfg: ModelConfig, p, x):
    """Routed experts plus the shared ones.  Returns (out, aux).  Takes the
    expert-parallel path exactly where the reference does: a mesh is
    active, "experts" maps to its axes of size > 1, and E divides by it.
    The shared experts are a dense FFN, tensor-parallel where the build
    split their d_ff; the router is whole on every rank."""
    m = cfg.moe
    h = rmsnorm(x, p.ln2, cfg.norm_plus_one)
    mesh = current_mesh()
    rules = current_rules() or {}
    ep_axes = tuple(a for a in rules.get("experts", ())
                    if mesh is not None and a in mesh.mesh_dim_names)
    use_ep = (mesh is not None and ep_axes
              and m.num_experts % axes_size(mesh, ep_axes) == 0
              and axes_size(mesh, ep_axes) > 1)
    if use_ep:
        y, aux = _moe_ep_path(cfg, p, h, mesh, ep_axes)
    else:
        # over the batch's shards the reference's aux is the whole batch's
        # (its dense path is not under ``shard_map``)
        b_axes = _batch_axes(mesh, rules) if mesh is not None else ()
        n = axes_size(mesh, b_axes) if b_axes else 1
        top_p, top_i, aux = _router(
            cfg, p, h, (axis_group(mesh, b_axes), n) if n > 1 else None)
        y = _moe_dense_path(cfg, p, h, top_p, top_i)
    if m.num_shared:
        # column- / row-parallel over the build's "ff" split: the partial
        # output summed over its group once
        ss = _same_split(cfg, p, mesh, (("ws_gate", 1), ("ws_up", 1),
                                        ("ws_down", 0)))
        hs = _enter(h, ss)
        y = y + _leave((_act(hs @ p.ws_gate, cfg.act) * (hs @ p.ws_up))
                       @ p.ws_down, ss)
    if cfg.post_norms:
        y = rmsnorm(y, p.ln2_post, cfg.norm_plus_one)
    return y.to(x.dtype), aux


# ---------------------------------------------------------------------------
# Mamba (selective SSM): causal depthwise conv + sequential scan.  The
# reference has no kernel for it either.
# ---------------------------------------------------------------------------

def _mamba_ssm_params(cfg: ModelConfig, p, xc, sf=None):
    """xc: (B, S, di) post-conv activations -> dt, B, C (f32).  With `sf`
    (``apply_mamba``'s channel split) the rank's rows of ``x_proj`` give a
    partial x_dbl, summed over the split's group."""
    mc = cfg.mamba
    dtr = mc.dt_rank or -(-cfg.d_model // 16)
    x_dbl = _enter(_leave(xc @ p.x_proj, sf), sf)
    dt = F.softplus(x_dbl[..., :dtr] @ p.dt_w + p.dt_b.float())
    Bm = x_dbl[..., dtr:dtr + mc.d_state].float()
    Cm = x_dbl[..., dtr + mc.d_state:].float()
    return dt.float(), Bm, Cm


def _ssm_step(hs, xs, A):
    """One token of the selective scan: hs (B, di, ds) and the token's
    (B, 1, .) dt, B, x and C -> (hs, y (B, 1, di))."""
    dt_t, b_t, x_t, c_t = (x[:, 0] for x in xs)
    dt_t = dt_t[:, :, None]                              # (B, di, 1)
    hs = torch.exp(dt_t * A[None]) * hs + dt_t * b_t[:, None, :] \
        * x_t[:, :, None]
    return hs, torch.einsum("bds,bs->bd", hs, c_t)[:, None]


def apply_mamba(cfg: ModelConfig, p, x, state, ctx: ApplyCtx):
    """With ``ctx.lengths`` (a padded prompt or chunk) dt and x are zeroed
    past each row's length, so the state stops there, and the conv state is
    taken from the last d_conv - 1 *valid* inputs, in chunk-local
    coordinates (absolute length minus chunk start).

    Under a mesh whose build split d_inner ("ff") the rank computes its
    channels [c0, c1): ``in_proj``'s columns are [x | z] flattened, so a
    rank's shard is not its channels' x and z (on 16 ranks, ranks 0-7 hold
    only x): the leaf is gathered (``_Gather``, reduce-scatter backward)
    and the rank takes its channels' columns of both halves.  ``conv_w``,
    ``conv_b``, ``dt_w``, ``dt_b``, ``A_log``, ``D`` and the ssm / conv
    state hold the rank's channels; ``x_proj`` is row-parallel, its (dt, B,
    C) summed over the group (dt_rank + 2 d_state wide), and ``out_proj``
    row-parallel."""
    B, S, d = x.shape
    mc = cfg.mamba
    di, K = mc.expand * d, mc.d_conv
    mesh = current_mesh()
    sf = _same_split(cfg, p, mesh, (
        ("conv_w", 1), ("conv_b", 0), ("x_proj", 0), ("dt_w", 1),
        ("dt_b", 0), ("A_log", 0), ("D", 0), ("out_proj", 0)))
    si = leaf_split(p, "in_proj", 1, mesh)
    c0, c1 = _cols(sf, p.conv_w.shape[1], di)
    w_in = p.in_proj
    if si is not None:
        w_in = _Gather.apply(w_in, si, 1, sf is not None)
    elif sf is not None:
        w_in = _Enter.apply(w_in, sf.group)      # whole, used rank by rank
    h = rmsnorm(x, p.ln1, cfg.norm_plus_one)
    if sf is None and si is None:
        xz = h @ w_in
        xi, z = xz[..., :di], xz[..., di:]
    else:
        hin = _enter(h, sf)
        xi, z = hin @ w_in[:, c0:c1], hin @ w_in[:, di + c0:di + c1]
    n = c1 - c0
    if state is None:
        conv0 = torch.zeros((B, K - 1, n), dtype=x.dtype, device=x.device)
        hs = torch.zeros((B, n, mc.d_state), dtype=torch.float32,
                         device=x.device)
    else:
        for name, dim in (("ssm", 1), ("conv", 2)):
            if state[name].shape[dim] != n:
                raise ValueError(
                    f"{cfg.name}: the {name} state holds "
                    f"{state[name].shape[dim]} channels, the rank computes "
                    f"{n}: cut it with shard_state under the same rules")
        conv0, hs = state["conv"].to(x.dtype), state["ssm"].float()
    xp = torch.cat([conv0, xi], dim=1)                   # (B, K-1+S, n)
    xc = sum(xp[:, i:i + S] * p.conv_w[i] for i in range(K)) + p.conv_b
    conv1 = xp[:, S:]
    xc = F.silu(xc)
    dt, Bm, Cm = _mamba_ssm_params(cfg, p, xc, sf)
    A = -torch.exp(p.A_log.float())                      # (n, ds)
    xcf = xc.float()
    if ctx.lengths is not None:
        m = (ctx.positions < ctx.lengths[:, None]).float()[:, :, None]
        dt, xcf = dt * m, xcf * m
        loc = (ctx.lengths - ctx.positions[:, 0]).clamp(0, S).long()
        rows = loc[:, None] + torch.arange(K - 1, device=x.device)[None]
        conv1 = xp[torch.arange(B, device=x.device)[:, None], rows]
    hs, y = scan(_ssm_step, hs, (dt, Bm, xcf, Cm), S, consts=(A,))
    y = y + xcf * p.D.float()
    out = _leave((y.to(x.dtype) * F.silu(z)) @ p.out_proj, sf)
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
    """With no state (train mode) the shift and the WKV state start at
    zero and nothing is written.

    Under a mesh whose build split the heads ("heads": ``wr``, ``wk``,
    ``wv``, ``wg`` columns, ``wo`` rows) r / k / v / g are column-parallel
    and ``wo`` row-parallel; the token shift, the mixes and the decay are
    whole on every rank, and the decay, ``u``, ``lnx_g`` and ``lnx_b`` are
    sliced to the rank's heads, so WKV6 runs on them alone (with its
    state cut over "heads").  Where the columns cut a head, r / k / v are
    gathered (``_heads``): WKV6 runs on the heads covering the rank's
    columns, or on all of them with a state, which then stays whole on
    every rank."""
    B, S, d = x.shape
    K = cfg.rwkv_head_dim
    H = d // K
    sh = _same_split(cfg, p, current_mesh(), (
        ("wr", 1), ("wk", 1), ("wv", 1), ("wg", 1), ("wo", 0)))
    c0, c1 = _cols(sh, p.wr.shape[1], d)
    lo, hi = _cover(c0, c1, K)
    if state is not None and (c0 % K or c1 % K):
        lo, hi = 0, H
    nh = hi - lo
    h = rmsnorm(x, p.ln1, cfg.norm_plus_one)
    shift0 = x.new_zeros(B, d) if state is None else state["shift_t"]
    sx = _token_shift(h, shift0.to(h.dtype))
    xxx = h + sx * p.mu_x
    lora = torch.tanh(xxx @ p.lora_A).reshape(B, S, 5, _RWKV_LORA)
    mixes = torch.einsum("bsln,lnd->bsld", lora, p.lora_B)
    xw, xk, xv, xr, xg = [
        h + sx * (getattr(p, f"mu_{n}") + mixes[:, :, i])
        for i, n in enumerate(("w", "k", "v", "r", "g"))]
    partial = sh is not None

    def heads(xin, w):
        return _heads(_enter(xin, sh) @ w, sh, lo, hi, K, partial).float()
    r, k, v = heads(xr, p.wr), heads(xk, p.wk), heads(xv, p.wv)
    g = F.silu(_enter(xg, sh) @ p.wg)                    # the rank's columns
    wdec = p.w0.float() + (torch.tanh(xw @ p.decay_A) @ p.decay_B).float()
    w = torch.exp(-torch.exp(_enter(wdec, sh)[..., lo * K:hi * K])).reshape(
        B, S, nh, K)
    u = _enter(p.u.float(), sh)[lo * K:hi * K].reshape(nh, K)
    if ctx.lengths is not None:
        # padded prefill: no decay, no writes past each row's valid length
        m = (ctx.positions < ctx.lengths[:, None])[:, :, None, None]
        w = torch.where(m, w, 1.0)
        k = k * m
    if state is None:
        s0 = torch.zeros((B, nh, K, K), dtype=torch.float32,
                         device=x.device)
    else:
        if state["wkv"].shape[1] != nh:
            raise ValueError(
                f"{cfg.name}: the wkv state holds {state['wkv'].shape[1]} "
                f"heads, the rank computes {nh}: cut it with shard_state "
                "under the same rules")
        s0 = state["wkv"].float()
    if S == 1:
        y, sT = rwkv_wkv(r, k, v, w, u, s0)
    elif ctx.plain_kernels:
        y, sT = rwkv_wkv_chunked(r, k, v, w, u, s0)
    else:
        y, sT = kops.wkv6_op(*(t.contiguous() for t in (r, k, v, w, u)), s0)
    # per-head groupnorm
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mu) * torch.rsqrt(var + 64e-5)
    y = y.reshape(B, S, nh * K) * _enter(p.lnx_g.float(), sh)[lo * K:hi * K] \
        + _enter(p.lnx_b.float(), sh)[lo * K:hi * K]
    y = y[..., c0 - lo * K:c1 - lo * K]
    out = _leave((y.to(x.dtype) * g) @ p.wo, sh)
    if state is not None:
        state["wkv"].copy_(sT)
        state["shift_t"].copy_(_last_valid(h, ctx))
    return out.to(x.dtype), state


def apply_rwkv_cm(cfg: ModelConfig, p, x, state, ctx: ApplyCtx):
    """Under a mesh whose build split d_ff ("ff"), ``wk_cm`` is
    column-parallel and ``wv_cm`` row-parallel; ``wr_cm`` stays whole."""
    h = rmsnorm(x, p.ln2, cfg.norm_plus_one)
    shift0 = x.new_zeros(x.shape[0], x.shape[2]) if state is None \
        else state["shift_c"]
    sx = _token_shift(h, shift0.to(h.dtype))
    xk = h + sx * p.mu_ck
    xr = h + sx * p.mu_cr
    sf = _same_split(cfg, p, current_mesh(), (("wk_cm", 1), ("wv_cm", 0)))
    kk = torch.square(torch.relu(_enter(xk, sf) @ p.wk_cm))
    out = torch.sigmoid(xr @ p.wr_cm) * _leave(kk @ p.wv_cm, sf)
    if state is not None:
        state["shift_c"].copy_(_last_valid(h, ctx))
    return out.to(x.dtype), state
