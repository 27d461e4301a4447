"""Plain PyTorch versions of the kernels (the correctness contract).

The attention functions are the reference package's ``kernels/ref.py``
oracles written in PyTorch: the same masks, the same finite ``NEG_INF``
sentinel (so a row with no visible key softmaxes to a uniform average,
exactly as there), f32 arithmetic, output in the input's dtype.  The paged
one is the batched form of ``serving/paged.py``'s oracle; the two
``*_split_ref`` functions compute the same decode attention in the split-KV
kernels' two passes, for the tests.  ``wkv6_ref`` is
the sequential RWKV-6 oracle and ``wkv6_chunked`` the reference model's
chunked form of it (``models/ops.py: rwkv_wkv_chunked``).
``decode_attention_partial_ref`` is the decode over one slice of a cache
split over its positions (its output and log-sum-exp), and
``merge_decode_partials`` merges the slices, on every device (the merge
is not a kernel's body).  Three more compute
a function here with a kernel's own arithmetic, for the tests:
``chunked_prefill_attention_split_p_ref`` and
``decode_attention_split_p_ref`` (the bf16 tensor-core kernels' tiles and
P rounding) and ``wkv6_segmented`` (the WKV6 kernel's three passes over
segments).  The CPU path of
every wrapper in ``kernels/ops.py`` runs these; on the card they are what
the kernels are held against, and the attention and WKV6 wrappers'
backward passes differentiate ``chunked_prefill_attention_ref`` and
``wkv6_chunked``.  Both compute in f32, or in f64 when given f64 (for
``torch.autograd.gradcheck``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.scan import scan

NEG_INF = -2.0 ** 30


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The arithmetic's dtype: f32, or f64 for f64 inputs."""
    return torch.promote_types(dtype, torch.float32)


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
    acc = _acc(q.dtype)
    qq = q.reshape(B, Sq, Hkv, G, D).to(acc)
    s = torch.einsum("bqkgd,blkd->bkgql", qq, k.to(acc)) * scale
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
    o = torch.einsum("bkgql,blkd->bqkgd", p, v.to(acc))
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


LOG2E = 1.4426950408889634
#: keys a tile of the bf16 prefill kernel at every head dim:
#: csrc/prefill_wg.cuh kWgBN
PREFILL_TILE_KEYS = 64


def chunked_prefill_attention_split_p_ref(
        q, k, v, offset, lengths, window: int = 0, softcap: float = 0.0,
        scale: Optional[float] = None, p_parts: int = 2) -> torch.Tensor:
    """``chunked_prefill_attention_ref`` computed with the bf16 tensor-core
    kernel's rounding: an online softmax (log2 domain) over kv tiles of
    PREFILL_TILE_KEYS keys, P rounded to `p_parts` bf16 terms before P·V
    (2: the kernel's hi + lo pair, p_hi = bf16(p), p_lo = bf16(p - p_hi);
    1: a single bf16 P), V and the products in f32, the row sum from the
    f32 P.
    A row with no visible key gets the mean of v over all Skv keys.  For
    the tests; no serving path calls it."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    dev = q.device
    qq = q.reshape(B, Sq, Hkv, G, D).float().permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)                  # (B, Hkv, Skv, D)
    vf = v.float().permute(0, 2, 1, 3)
    q_pos = offset.to(dev).long()[:, None] + torch.arange(Sq, device=dev)
    lens = lengths.to(dev).long()[:, None, None]
    m = torch.full((B, Hkv, G, Sq), NEG_INF, device=dev)
    l = torch.zeros(B, Hkv, G, Sq, device=dev)
    o = torch.zeros(B, Hkv, G, Sq, D, device=dev)
    for kb in range(0, Skv, PREFILL_TILE_KEYS):
        ke = min(kb + PREFILL_TILE_KEYS, Skv)
        s = torch.einsum("bkgqd,bkld->bkgql", qq, kf[:, :, kb:ke]) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        s = s * LOG2E
        k_pos = torch.arange(kb, ke, device=dev)[None, None]
        vis = (k_pos <= q_pos[:, :, None]) & (k_pos < lens)
        if window:
            vis &= k_pos > q_pos[:, :, None] - window
        s = torch.where(vis[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        terms = []
        rest = p
        for _ in range(p_parts):
            t = rest.bfloat16().float()
            terms.append(t)
            rest = rest - t
        o = o * alpha[..., None]
        for t in terms:
            o = o + torch.einsum("bkgql,bkld->bkgqd", t, vf[:, :, kb:ke])
        m = m_new
    out = o / l.clamp(min=1e-30)[..., None]
    mean_v = vf.mean(2)[:, :, None, None]               # (B, Hkv, 1, 1, D)
    out = torch.where((m == NEG_INF)[..., None], mean_v, out)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)


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


def paged_decode_attention_ref(
        q: torch.Tensor,            # (B, Hq, D)
        pool_k: torch.Tensor,       # (num_blocks, BS, Hkv, D)
        pool_v: torch.Tensor,
        tables: torch.Tensor,       # (B, max_blocks) int, -1 = unallocated
        cur_lens: torch.Tensor,     # (B,)
        scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention over each request's pages: positions 0..cur_len
    (inclusive) whose page is allocated.  Pages are gathered by the table
    (an unallocated entry reads page 0 and is masked), so pages outside a
    request's table are never touched."""
    B, Hq, D = q.shape
    BS, Hkv = pool_k.shape[1], pool_k.shape[2]
    MB = tables.shape[1]
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    dev = q.device
    tables = tables.to(dev).long()
    safe = tables.clamp(min=0)
    k = pool_k[safe].reshape(B, MB * BS, Hkv, D).float()
    v = pool_v[safe].reshape(B, MB * BS, Hkv, D).float()
    pos = torch.arange(MB * BS, device=dev)[None]
    valid = (pos <= cur_lens.to(dev).long()[:, None]) \
        & (tables.repeat_interleave(BS, dim=1) >= 0)           # (B, MB*BS)
    s = torch.einsum("bkgd,blkd->bkgl", q.reshape(B, Hkv, G, D).float(),
                     k) * scale
    s = torch.where(valid[:, None, None], s, torch.tensor(NEG_INF, device=dev))
    p = torch.softmax(s, dim=-1)
    # a masked position's weight is exactly 0 once any position is visible;
    # zeroing its value too keeps garbage (even NaN) in an unallocated
    # entry's stand-in page out of the result, as the kernel's never
    # reading it does
    v = torch.where(valid[:, :, None, None], v, 0.0)
    o = torch.einsum("bkgl,blkd->bkgd", p, v)
    return o.reshape(B, Hq, D).to(q.dtype)


def _split_merge(s, v, live, lo, hi, split, dtype):
    """The decode kernels' two passes in plain PyTorch.

    s (B, Hkv, G, P) scores, v (B, P, Hkv, D) f32 with dead rows zeroed,
    live (B, P), lo/hi (B,) the live range.  Pass 1: per split of `split`
    positions, the partial (o, m, l) over its live keys.  Pass 2: the
    log-sum-exp merge of the splits that meet [lo, hi], in split order
    (nothing meets when lo > hi: the output is 0, as the plain versions
    give when no key is visible)."""
    B, Hkv, G, P = s.shape
    D = v.shape[-1]
    nsplit = -(-P // split)
    pad = nsplit * split - P
    s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    live = torch.nn.functional.pad(live, (0, pad), value=False)
    live = live.reshape(B, 1, 1, nsplit, split)
    s = torch.where(live, s.reshape(B, Hkv, G, nsplit, split), NEG_INF)
    m = s.amax(-1)                                       # (B, Hkv, G, n)
    p = torch.where(live, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    o = torch.einsum("bkgns,bnskd->bkgnd", p,
                     v.reshape(B, nsplit, split, Hkv, D))
    idx = torch.arange(nsplit, device=s.device)
    meet = (idx[None] >= (lo // split)[:, None]) \
        & (idx[None] <= (hi // split)[:, None]) & (lo <= hi)[:, None]
    meet = meet[:, None, None]                           # (B, 1, 1, n)
    M = torch.where(meet, m, NEG_INF).amax(-1)
    O = torch.zeros(B, Hkv, G, D, device=s.device)
    Ls = torch.zeros(B, Hkv, G, device=s.device)
    for i in range(nsplit):
        c = torch.where(meet[..., i], torch.exp(m[..., i] - M), 0.0)
        Ls = Ls + l[..., i] * c
        O = O + o[..., i, :] * c[..., None]
    out = O / Ls.clamp(min=1e-30)[..., None]
    return out.reshape(B, Hkv * G, D).to(dtype)


def decode_attention_split_ref(q, k, v, cur_lens, split: int,
                               window: int = 0, softcap: float = 0.0,
                               scale: Optional[float] = None):
    """``decode_attention_ref`` computed as the split-KV kernel computes it:
    partials per split of `split` positions, then the merge.  For the
    tests; no serving path calls it."""
    B, Hq, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    s = torch.einsum("bkgd,blkd->bkgl", q.reshape(B, Hkv, Hq // Hkv, D).float(),
                     k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    cur = cur_lens.to(q.device).long()
    hi = cur.clamp(max=L - 1)
    lo = (cur - window + 1).clamp(min=0) if window else torch.zeros_like(cur)
    pos = torch.arange(L, device=q.device)[None]
    live = (pos >= lo[:, None]) & (pos <= hi[:, None])
    vf = torch.where(live[:, :, None, None], v.float(), 0.0)
    return _split_merge(s, vf, live, lo, hi, split, q.dtype)


def decode_tc_tile(D: int) -> tuple[int, int]:
    """(KW, STAGES) of the bf16 decode kernel at head dim D
    (csrc/decode_common.cuh TcTile<D>): a tile is KW blocks of 16 keys,
    each with its own online softmax, and the ring holds STAGES tiles."""
    return (2, 3) if D > 128 else (4, 2)


def decode_attention_split_p_ref(
        q, k, v, cur_lens, split: int, window: int = 0,
        softcap: float = 0.0, scale: Optional[float] = None,
        pos0: Optional[int] = None, p_parts: int = 2):
    """``decode_attention_ref`` computed with the bf16 tensor-core decode
    kernel's arithmetic: splits of `split` positions; inside each, tiles
    of KW blocks of 16 keys (``decode_tc_tile``), block w of every tile a
    step of block w's online softmax in the log2 domain (softcap before the
    max, a dead key at NEG_INF and of weight 0), P rounded to `p_parts`
    bf16 terms before P·V (2: the kernel's hi + lo pair, p_hi = bf16(p),
    p_lo = bf16(p - p_hi); 1: a single bf16 P), V and the products in f32,
    the row sum from the f32 P; the blocks' states merged at the end of the
    split, then the splits that meet the live range by log-sum-exp in split
    order.  A row with no live key gives 0.  With `pos0`, k / v are one
    slice of the cache holding absolute positions pos0 .. pos0 + L - 1,
    and it returns (o (B, Hq, D) f32, lse (B, Hq) f32) as
    ``decode_attention_partial_ref`` does.  For the tests; no serving path
    calls it."""
    B, Hq, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    G, (KW, _) = Hq // Hkv, decode_tc_tile(D)
    scale = scale if scale is not None else D ** -0.5
    dev = q.device
    nsplit, nt = -(-L // split), split // (16 * KW)
    Lp = nsplit * split
    base = 0 if pos0 is None else pos0
    cur = cur_lens.to(dev).long()
    hi = cur.clamp(max=base + L - 1) - base
    lo = ((cur - window + 1) if window else torch.zeros_like(cur)) \
        .clamp(min=base) - base
    pos = torch.arange(Lp, device=dev)[None]
    live = (pos >= lo[:, None]) & (pos <= hi[:, None])            # (B, Lp)

    def padded(x):          # dead rows are never loaded: zeros
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, Lp - L))
        return torch.where(live[:, :, None, None], x, 0.0)
    kf, vf = padded(k), padded(v)
    s = torch.einsum("bkgd,blkd->bkgl", q.reshape(B, Hkv, G, D).float(),
                     kf) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(live[:, None, None], s * LOG2E, NEG_INF)
    s = s.reshape(B, Hkv, G, nsplit, nt, KW, 16)
    lv = live.reshape(B, 1, 1, nsplit, nt, KW, 16)
    vt = vf.reshape(B, nsplit, nt, KW, 16, Hkv, D)
    m = torch.full((B, Hkv, G, nsplit, KW), NEG_INF, device=dev)
    l = torch.zeros(B, Hkv, G, nsplit, KW, device=dev)
    o = torch.zeros(B, Hkv, G, nsplit, KW, D, device=dev)
    for t in range(nt):
        x = s[..., t, :, :]
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.where(lv[..., t, :, :], torch.exp2(x - m_new[..., None]),
                        0.0)
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None]
        rest = p
        for _ in range(p_parts):
            term = rest.bfloat16().float()
            rest = rest - term
            o = o + torch.einsum("bkgnwt,bnwtkd->bkgnwd", term,
                                 vt[:, :, t])
        m = m_new
    mw = m.amax(-1)                                      # the blocks merged
    c = torch.exp2(m - mw[..., None])
    m, l, o = mw, (l * c).sum(-1), (o * c[..., None]).sum(-2)
    idx = torch.arange(nsplit, device=dev)
    meet = (idx[None] >= (lo // split)[:, None]) \
        & (idx[None] <= (hi // split)[:, None]) & (lo <= hi)[:, None]
    meet = meet[:, None, None]                           # (B, 1, 1, n)
    M = torch.where(meet, m, NEG_INF).amax(-1)
    c = torch.where(meet, torch.exp2(m - M[..., None]), 0.0)
    Ls = (l * c).sum(-1)
    O = (o * c[..., None]).sum(-2)
    out = (O / Ls.clamp(min=1e-30)[..., None]).reshape(B, Hq, D)
    if pos0 is None:
        return out.to(q.dtype)
    lse = torch.where(Ls > 0, (M + torch.log2(Ls.clamp(min=1e-30))) / LOG2E,
                      float("-inf"))
    return out, lse.reshape(B, Hq)


def decode_attention_partial_ref(
        q: torch.Tensor,            # (B, Hq, D) — the single new token
        k: torch.Tensor,            # (B, L, Hkv, D) — positions pos0 ..
        v: torch.Tensor,            #   pos0 + L - 1 of the whole cache
        cur_lens: torch.Tensor,     # (B,) absolute; new token at cur_lens
        pos0: int,
        window: int = 0,
        softcap: float = 0.0,
        scale: Optional[float] = None):
    """``decode_attention_ref`` over one slice of the cache's positions,
    [pos0, pos0 + L): the keys live in the whole cache ([max(0, cur -
    window + 1), cur]) that fall in the slice.  Returns (o (B, Hq, D) f32,
    the normalised output over those keys; lse (B, Hq) f32, the natural
    log of the sum of their exp(score)).  A row with no live key in the
    slice gives o = 0 and lse = -inf.  ``merge_decode_partials`` of the
    slices' (o, lse) is ``decode_attention_ref``."""
    B, Hq, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    acc = _acc(q.dtype)
    s = torch.einsum("bkgd,blkd->bkgl",
                     q.reshape(B, Hkv, Hq // Hkv, D).to(acc),
                     k.to(acc)) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    dev = q.device
    cur = cur_lens.to(dev).long()[:, None]
    pos = pos0 + torch.arange(L, device=dev)[None]
    live = pos <= cur
    if window:
        live &= pos > cur - window
    s = torch.where(live[:, None, None], s, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)                     # (B, Hkv, G)
    p = torch.exp(s - torch.where(torch.isinf(lse), 0.0, lse)[..., None])
    vf = torch.where(live[:, :, None, None], v.to(acc), 0.0)
    o = torch.einsum("bkgl,blkd->bkgd", p, vf)
    return o.reshape(B, Hq, D), lse.reshape(B, Hq)


def merge_decode_partials(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """The slices' partials merged by their log-sum-exp weights: o (n, B,
    Hq, D) and lse (n, B, Hq) of n slices of the cache, in slice order ->
    (B, Hq, D), in o's dtype.  Elementwise ops and sums over the slice dim,
    no atomics: bit-equal from run to run.  A row whose every slice has
    lse = -inf (no live key anywhere) gives 0, the plain decode's value."""
    m = lse.amax(0)
    m = torch.where(torch.isinf(m), 0.0, m)
    w = torch.exp(lse - m)                               # 0 where -inf
    den = w.sum(0)
    num = (w[..., None] * o).sum(0)
    return num / torch.where(den > 0, den, 1.0)[..., None]


def paged_decode_attention_split_ref(q, pool_k, pool_v, tables, cur_lens,
                                     split: int,
                                     scale: Optional[float] = None):
    """``paged_decode_attention_ref`` computed as the split-KV kernel
    computes it (splits of `split` positions, whole pages).  For the tests;
    no serving path calls it."""
    B, Hq, D = q.shape
    BS, Hkv = pool_k.shape[1], pool_k.shape[2]
    MB = tables.shape[1]
    scale = scale if scale is not None else D ** -0.5
    dev = q.device
    tables = tables.to(dev).long()
    safe = tables.clamp(min=0)
    k = pool_k[safe].reshape(B, MB * BS, Hkv, D).float()
    v = pool_v[safe].reshape(B, MB * BS, Hkv, D).float()
    cur = cur_lens.to(dev).long()
    hi = cur.clamp(max=MB * BS - 1)
    pos = torch.arange(MB * BS, device=dev)[None]
    live = (pos <= hi[:, None]) & (tables.repeat_interleave(BS, dim=1) >= 0)
    s = torch.einsum("bkgd,blkd->bkgl",
                     q.reshape(B, Hkv, Hq // Hkv, D).float(), k) * scale
    v = torch.where(live[:, :, None, None], v, 0.0)
    return _split_merge(s, v, live, torch.zeros_like(cur), hi, split,
                        q.dtype)


def wkv6_ref(r, k, v, w, u, s0):
    """RWKV-6 recurrence oracle, one token at a time.

    r, k, v, w: (B, H, S, K) f32; u: (H, K); s0: (B, H, K, K).
    Returns (y (B, H, S, K), sT (B, H, K, K)), f32."""
    s = s0.float()
    uu = u.float()[None, :, :, None]
    ys = []
    for t in range(r.shape[2]):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]          # (B,H,K,K)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, :, t], s + uu * kv))
        s = w[:, :, t, :, None] * s + kv
    return torch.stack(ys, dim=2), s


def wkv6_chunked(r, k, v, w, u, s0, chunk: int = 16):
    """The same recurrence in chunks of `chunk` tokens: the reference
    model's ``rwkv_wkv_chunked`` (the Pallas kernel's plain twin).

    r, k, v, w: (B, S, H, K) f32; u: (H, K); s0: (B, H, K, K).  A ragged
    tail is padded with w = 1, k = 0, which leaves the state as it is.
    Returns (y (B, S, H, K), sT (B, H, K, K)), f32."""
    B, S, H, K = r.shape
    pad = (-S) % chunk
    if pad:
        def ext(x, val):
            return torch.cat([x, x.new_full((B, pad, H, K), val)], 1)
        r, k, v, w = ext(r, 0.0), ext(k, 0.0), ext(v, 0.0), ext(w, 1.0)
    strict = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    s, y = scan(_wkv6_chunk, s0.to(_acc(s0.dtype)), (r, k, v, w),
                (S + pad) // chunk, chunk, consts=(u, strict))
    return y[:, :S], s


def _wkv6_chunk(s, xs, u, strict):
    """One chunk of ``wkv6_chunked``: the state entering it and its
    (B, C, H, K) r, k, v, w -> (the state leaving it, its y)."""
    rc, kc, vc, wc = xs
    logw = torch.log(wc.clamp(min=1e-38))
    L = torch.cumsum(logw, dim=1)                                # (B,C,H,K)
    q_in = rc * torch.exp(L - logw)
    k_out = kc * torch.exp(-L)
    y = torch.einsum("bchk,bhkv->bchv", q_in, s)
    scores = torch.einsum("bthk,bshk->bhts", q_in, k_out)
    scores = torch.where(strict, scores, 0.0)
    diag = (rc * u[None, None] * kc).sum(-1)                     # (B,C,H)
    y = y + torch.einsum("bhts,bshv->bthv", scores, vc)
    y = y + diag[..., None] * vc
    L_C = L[:, -1:]                                              # (B,1,H,K)
    k_carry = kc * torch.exp(L_C - L)
    s = torch.exp(L_C[:, 0])[..., None] * s \
        + torch.einsum("bchk,bchv->bhkv", k_carry, vc)
    return s, y


def wkv6_segmented(r, k, v, w, u, s0, chunk: int = 16, segment: int = 64):
    """``wkv6_chunked`` computed as the chunk-parallel kernel computes it,
    in three passes over segments of `segment` tokens (a whole number of
    chunks).  Pass 1, every segment but the last: its total decay
    e^{L_last} and its own state contribution from a zero state,
    sum_s (k_s e^{L_last - L_s}) (x) v_s, with L_last - L_s summed directly
    over the tokens after s.  Pass 2: the scan S_{g+1} = e^{L_last,g} S_g +
    dS_g from s0, the state entering each segment.  Pass 3, every segment:
    ``wkv6_chunked`` from its entering state; the last segment's final
    state is sT.  A ragged tail reads as w = 1, k = r = v = 0.  For the
    tests; no serving path calls it.

    r, k, v, w: (B, S, H, K) f32; u: (H, K); s0: (B, H, K, K).
    Returns (y (B, S, H, K), sT (B, H, K, K)), f32."""
    B, S, H, K = r.shape
    if segment % chunk:
        raise ValueError(f"segment {segment} is not a whole number of "
                         f"chunks of {chunk}")
    nseg = -(-S // segment)
    pad = nseg * segment - S
    if pad:
        def ext(x, val):
            return torch.cat([x, x.new_full((B, pad, H, K), val)], 1)
        r, k, v, w = ext(r, 0.0), ext(k, 0.0), ext(v, 0.0), ext(w, 1.0)

    def segs(x):                                    # (B, nseg, T, H, K)
        return x.reshape(B, nseg, segment, H, K)
    logw = torch.log(segs(w).clamp(min=1e-38))
    after = logw.flip(2).cumsum(2).flip(2) - logw   # sum over tokens after s
    dS = torch.einsum("bgshk,bgshv->bghkv", segs(k) * torch.exp(after),
                      segs(v))
    decay = torch.exp(logw.sum(2))                  # (B, nseg, H, K)
    s_in = [s0.float()]
    for g in range(nseg - 1):
        s_in.append(decay[:, g, :, :, None] * s_in[-1] + dS[:, g])
    s_in = torch.stack(s_in, 1).reshape(B * nseg, H, K, K)
    y, s_out = wkv6_chunked(*(segs(x).reshape(B * nseg, segment, H, K)
                              for x in (r, k, v, w)), u, s_in, chunk=chunk)
    y = y.reshape(B, nseg * segment, H, K)[:, :S]
    return y, s_out.reshape(B, nseg, H, K, K)[:, -1]
