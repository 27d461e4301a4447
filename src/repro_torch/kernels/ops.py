"""Public wrappers around the Hopper kernels.

Each wrapper keeps the reference package's signature and (B, S, H, D)
layout (``repro/kernels/ops.py``; the paged one that of
``repro/kernels/paged_decode_attention.py``) and dispatches by the device of the
tensors it is given: on the CPU it runs the plain version in
``kernels/ref.py``; on a CUDA device it launches the kernel, and raises if
the kernel does not take the inputs or fails to launch.  There is no
switch and no fallback.  ``LAUNCHES`` counts the kernel launches, so a run
can show that it went through the kernels.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"chunked_prefill_attention": 0, "decode_attention": 0,
            "paged_decode_attention": 0, "wkv6": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_cuda(q, k, v):
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError("q, k and v must be on one device")
        if t.dtype != q.dtype:
            raise ValueError(f"dtype mismatch: {t.dtype} vs {q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the kernel takes contiguous, 16-byte aligned "
                             "tensors")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"the kernel takes f32 or bf16, got {q.dtype}")
    D, Hq, Hkv = q.shape[-1], q.shape[-2], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} kv heads")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _int32(x: torch.Tensor, device) -> torch.Tensor:
    return x.to(device=device, dtype=torch.int32).contiguous()


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel failed to launch (error {err})")


def prefill_attention(q, k, v, offset, lengths, window: int = 0,
                      softcap: float = 0.0, scale: Optional[float] = None):
    """(B,Sq,Hq,D) x (B,Skv,Hkv,D) chunked/whole prefill attention."""
    if q.device.type == "cpu":
        return ref.chunked_prefill_attention_ref(
            q, k, v, offset, lengths, window=window, softcap=softcap,
            scale=scale)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, Skv, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"shapes {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    _check_cuda(q, k, v)
    scale = scale if scale is not None else D ** -0.5
    offset, lengths = _int32(offset, q.device), _int32(lengths, q.device)
    out = torch.empty_like(q)
    fn = build.lib("chunked_prefill_attention").chunked_prefill_attention
    err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             offset.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             B, Sq, Skv, Hq, Hkv, D, int(window), float(softcap),
             float(scale), _stream(q))
    _raise_on(err, "chunked_prefill_attention")
    LAUNCHES["chunked_prefill_attention"] += 1
    return out


# The decode kernels' split rule (csrc/decode_common.cuh).  Splits are
# powers of two times SPLIT_QUANTUM positions (a multiple of every tile),
# at most SPLIT_MAX, and as short as it takes to give BLOCKS_WANTED blocks:
# about four per SM of an H100 before the blocks whose split misses the live
# range return.
SPLIT_QUANTUM = 64
SPLIT_MAX = 2048
BLOCKS_WANTED = 4 * 132


def decode_split(positions: int, B: int, Hkv: int,
                 block_size: int = 1) -> tuple[int, int]:
    """(split, nsplit) for `positions` cache positions (L, or MB * BS pages'
    worth), B requests and Hkv kv heads; with pages of `block_size`, the
    split is a whole number of pages.  It depends on the shapes alone: the
    host never reads cur_lens, which lives on the device.  Both decode
    kernels use this rule, so over the same positions they cut the keys
    alike."""
    want = -(-BLOCKS_WANTED // max(B * Hkv, 1))
    raw = -(-max(positions, 1) // want)
    split = SPLIT_QUANTUM
    while split < min(raw, SPLIT_MAX):
        split *= 2
    grain = math.lcm(SPLIT_QUANTUM, block_size)
    split = -(-split // grain) * grain
    if split > SPLIT_MAX:
        raise ValueError(f"pages of {block_size} positions do not fit a "
                         f"split of at most {SPLIT_MAX}")
    return split, -(-max(positions, 1) // split)


def _partials(rows: int, nsplit: int, D: int, device):
    """Scratch for the split pass, f32: the partial o (rows, nsplit, D)
    followed by m, l (rows, nsplit, 2).  None with one split, whose block
    writes the output itself.  Returns (tensor, o pointer, m/l pointer);
    the caller holds the tensor across the launch, and the caching
    allocator reuses its memory only after the kernels on that stream."""
    if nsplit == 1:
        return None, 0, 0
    ws = torch.empty(rows * nsplit * (D + 2), dtype=torch.float32,
                     device=device)
    return ws, ws.data_ptr(), ws.data_ptr() + 4 * rows * nsplit * D


def decode_attention_op(q, k, v, cur_lens, window: int = 0,
                        softcap: float = 0.0, scale: Optional[float] = None):
    """(B,Hq,D) single-token decode against a (B,L,Hkv,D) cache.

    On the card: split-KV, one block per (kv head, request, split of
    ``decode_split(L, B, Hkv)`` positions), then a combine pass when there
    is more than one split; the partials go to scratch of
    B * Hq * nsplit * (D + 2) floats from ``torch.empty``."""
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, cur_lens, window=window,
                                        softcap=softcap, scale=scale)
    B, Hq, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, L, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"shapes {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    _check_cuda(q, k, v)
    scale = scale if scale is not None else D ** -0.5
    cur_lens = _int32(cur_lens, q.device)
    split, nsplit = decode_split(L, B, Hkv)
    out = torch.empty_like(q)
    ws, part_o, part_ml = _partials(B * Hq, nsplit, D, q.device)
    fn = build.lib("decode_attention").decode_attention
    err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             cur_lens.data_ptr(), out.data_ptr(), part_o, part_ml, B, L, Hq,
             Hkv, D, int(window), float(softcap), float(scale), split,
             _stream(q))
    _raise_on(err, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return out


def paged_decode_attention(q, pool_k, pool_v, tables, cur_lens,
                           scale: Optional[float] = None):
    """(B,Hq,D) single-token decode against a shared (NB,BS,Hkv,D) page
    pool through per-request block tables (B, MB) of page ids below NB,
    -1 = unallocated.

    On the card: the decode kernel's split-KV blocks over splits of
    ``decode_split(MB * BS, B, Hkv, BS)`` positions (whole pages), then the
    combine pass; scratch as ``decode_attention_op``'s."""
    if q.device.type == "cpu":
        return ref.paged_decode_attention_ref(q, pool_k, pool_v, tables,
                                              cur_lens, scale=scale)
    B, Hq, D = q.shape
    NB, BS, Hkv = pool_k.shape[:3]
    if pool_k.shape != (NB, BS, Hkv, D) or pool_v.shape != pool_k.shape \
            or tables.dim() != 2 or tables.shape[0] != B:
        raise ValueError(f"shapes {tuple(q.shape)} {tuple(pool_k.shape)} "
                         f"{tuple(pool_v.shape)} {tuple(tables.shape)}")
    _check_cuda(q, pool_k, pool_v)
    scale = scale if scale is not None else D ** -0.5
    tables, cur_lens = _int32(tables, q.device), _int32(cur_lens, q.device)
    MB = tables.shape[1]
    split, nsplit = decode_split(MB * BS, B, Hkv, BS)
    out = torch.empty_like(q)
    ws, part_o, part_ml = _partials(B * Hq, nsplit, D, q.device)
    fn = build.lib("paged_decode_attention").paged_decode_attention
    err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), pool_k.data_ptr(),
             pool_v.data_ptr(), tables.data_ptr(), cur_lens.data_ptr(),
             out.data_ptr(), part_o, part_ml, B, MB, BS, Hq, Hkv, D,
             float(scale), split, _stream(q))
    _raise_on(err, "paged_decode_attention")
    LAUNCHES["paged_decode_attention"] += 1
    return out


WKV_HEAD_DIMS = (8, 16, 32, 64)
WKV_MAX_CHUNK = 64
# The WKV6 kernel's segment rule (csrc/wkv6.cu).  Segments are chunk * 2^k
# tokens, at most max(WKV_SEG_MAX, chunk), and as long as they can be while
# (B * H) * nseg still gives WKV_BLOCKS_WANTED blocks: a few per SM of an
# H100 for the passes that run one block per (segment, head, request).
WKV_SEG_MAX = 64
WKV_BLOCKS_WANTED = 4 * 132


def wkv6_segment(S: int, B: int, H: int, chunk: int) -> tuple[int, int]:
    """(segment, nseg) for a sequence of S tokens in chunks of `chunk`,
    B requests and H heads.  It depends on the shapes alone."""
    want = -(-WKV_BLOCKS_WANTED // max(B * H, 1))
    most = max(WKV_SEG_MAX, chunk)
    seg = chunk
    while 2 * seg <= most and -(-S // (2 * seg)) >= want:
        seg *= 2
    return seg, -(-max(S, 1) // seg)


def wkv6_op(r, k, v, w, u, s0, chunk: int = 16):
    """(B,S,H,K)-layout WKV6: r, k, v, w (B,S,H,K), u (H,K), s0 (B,H,K,K),
    all f32 -> (y (B,S,H,K), sT (B,H,K,K)).  A ragged tail needs no
    padding: the kernel treats positions past S as w = 1, k = 0.

    On the card: three passes over segments of ``wkv6_segment(S, B, H,
    chunk)`` tokens (every segment's decay and state contribution, the scan
    over segments, every segment's outputs), with scratch of
    (nseg - 1) * B * H * (K * K + K) floats from ``torch.empty``."""
    if r.device.type == "cpu":
        return ref.wkv6_chunked(r, k, v, w, u, s0, chunk=chunk)
    B, S, H, K = r.shape
    if r.device.type != "cuda":
        raise ValueError(f"no kernel for device {r.device}")
    for name, t, shape in (("r", r, (B, S, H, K)), ("k", k, (B, S, H, K)),
                           ("v", v, (B, S, H, K)), ("w", w, (B, S, H, K)),
                           ("u", u, (H, K)), ("s0", s0, (B, H, K, K))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, not {shape}")
        if t.device != r.device or t.dtype != torch.float32:
            raise ValueError(f"{name}: the kernel takes f32 on {r.device}, "
                             f"got {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel takes contiguous, 16-byte "
                             f"aligned tensors")
    if K not in WKV_HEAD_DIMS:
        raise ValueError(f"head dim {K} not in {WKV_HEAD_DIMS}")
    if not 1 <= chunk <= WKV_MAX_CHUNK:
        raise ValueError(f"chunk {chunk} not in 1..{WKV_MAX_CHUNK}")
    segment, nseg = wkv6_segment(S, B, H, chunk)
    y = torch.empty_like(r)
    sT = torch.empty_like(s0)
    ws = None if nseg == 1 else torch.empty(
        (nseg - 1) * B * H * (K * K + K), dtype=torch.float32,
        device=r.device)
    fn = build.lib("wkv6").wkv6
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), s0.data_ptr(), y.data_ptr(), sT.data_ptr(),
             0 if ws is None else ws.data_ptr(), B, S, H, K, int(chunk),
             segment, _stream(r))
    _raise_on(err, "wkv6")
    LAUNCHES["wkv6"] += 1
    return y, sT
