"""Plain PyTorch versions of the kernels (the correctness contract).

The attention functions are the reference package's ``kernels/ref.py``
oracles written in PyTorch: the same masks, the same finite ``NEG_INF``
sentinel (so a row with no visible key softmaxes to a uniform average,
exactly as there), f32 arithmetic, output in the input's dtype.  The paged
one is the batched form of ``serving/paged.py``'s oracle; the two
``*_split_ref`` functions compute the same decode attention in the split-KV
kernels' two passes, for the tests.  ``wkv6_ref`` is
the sequential RWKV-6 oracle and ``wkv6_chunked`` the reference model's
chunked form of it (``models/ops.py: rwkv_wkv_chunked``).  Two more compute
a function here with a kernel's own arithmetic, for the tests:
``chunked_prefill_attention_split_p_ref`` (the bf16 tensor-core kernel's
tiles and P rounding) and ``wkv6_segmented`` (the WKV6 kernel's three
passes over segments).  The CPU path of
every wrapper in ``kernels/ops.py`` runs these; on the card they are what
the kernels are held against.
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


LOG2E = 1.4426950408889634
PREFILL_TILE_KEYS = 64      # csrc/chunked_prefill_attention.cu kBK


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
    s = s0.float()
    ys = []
    for c0 in range(0, S + pad, chunk):
        rc, kc, vc, wc = (x[:, c0:c0 + chunk] for x in (r, k, v, w))
        logw = torch.log(wc.clamp(min=1e-38))
        L = torch.cumsum(logw, dim=1)                            # (B,C,H,K)
        q_in = rc * torch.exp(L - logw)
        k_out = kc * torch.exp(-L)
        y = torch.einsum("bchk,bhkv->bchv", q_in, s)
        scores = torch.einsum("bthk,bshk->bhts", q_in, k_out)
        scores = torch.where(strict, scores, 0.0)
        diag = (rc * u[None, None] * kc).sum(-1)                 # (B,C,H)
        y = y + torch.einsum("bhts,bshv->bthv", scores, vc)
        y = y + diag[..., None] * vc
        L_C = L[:, -1:]                                          # (B,1,H,K)
        k_carry = kc * torch.exp(L_C - L)
        s = torch.exp(L_C[:, 0])[..., None] * s \
            + torch.einsum("bchk,bchv->bhkv", k_carry, vc)
        ys.append(y)
    return torch.cat(ys, 1)[:, :S], s


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
