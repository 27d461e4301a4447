#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA H100.

    python3 chip_smoke.py          # from the root of a checkout

Phases (any failure exits non-zero; nothing is skipped):
  1. build   — compile the four CUDA kernels from src/repro_torch/kernels/csrc
  2. parity  — each kernel against its plain PyTorch version on the card:
               attention at Llama-3.1-8B heads at the main-path shapes in
               bf16 (3e-2, and 2e-5 + 2 bf16 steps of the plain value) and
               f32 (2e-5), the split-KV decode kernel also against its plain
               split-and-merge version and bit-equal to itself, the prefill
               sweep in bf16 (the tensor-core path: 3e-2 and the bf16-steps
               bound) and the f32 sweeps (the CUDA-core path, 2e-5), NaN in
               the decode kernel's dead region; the
               paged kernel on the reference's cases (f32, 2e-5), on
               interleaved pages at Llama heads (bf16 and f32, and bit-equal
               to the contiguous decode kernel on the gathered KV) and under
               NaN in foreign pages; WKV6 (f32, 2e-4) on the reference's
               sweep, the state carry and RWKV-6 3B heads with model-like
               decays, up to a 4096-token prompt (64 segments, bit-equal to
               itself).  Then times at the main-path shapes beside the bound,
               the plain version and, where one torch call computes the same
               function, that call (a yardstick only): kernels and that call
               by CUDA-graph replay (eager figure and host enqueue beside),
               the plain versions eagerly; also the prefill kernel at the
               convertible chunk and a burst prompt beside SDPA, WKV6 at a
               256-token chunk from a carried state, device time by kernel
               of the split-KV and the three WKV6 passes; then the three
               attention kernels at head dim 256 (Gemma-2-9B's heads with
               softcap 50, windows of 4096 that bite, Gemma-2B's MQA heads;
               paged bit-equal to contiguous) in bf16 and f32, and their
               times at Gemma-2-9B's main shapes beside SDPA at the same
               shape without softcap or window (a yardstick only), and the
               paged kernel's at D = 256 beside SDPA on the gathered KV;
               then the two attention kernels at Qwen-2.5-32B's heads (40
               over 8, G = 5) at the main path's shapes, bf16 and f32, and
               their times beside the bound, plain version and SDPA
  3. serve   — Llama-3.1-8B at its published widths (random weights from a
               seed, bf16) served PD-disaggregated by PDCluster (prefiller,
               decoder, convertible decoder), then a convertible Engine
               with prompts longer than its chunk; the attention kernels'
               launch counters are read around exactly this phase; then a
               decode step at B=4 and the prefill of one 1024-token prompt
               under torch.profiler (device time by kind, idle share)
  4. paged   — a PagedKV pool of Llama-3.1-8B's 32 layers of KV heads:
               four requests allocated page by page in turn, written, and
               attended through the paged kernel (its counter is read
               around this phase) against the contiguous decode kernel
  5. rwkv    — RWKV-6 3B at its published widths and depth (bf16, seed 0)
               served by the same PD traffic; the WKV6 counter is read
               around exactly this phase; every transfer ships the whole
               recurrent state, 21,299,200 B, whatever the prompt length;
               the same two profiles
  6. gemma   — Gemma-2-9B at its published widths and depth (bf16, seed
               0; local window 4096 / global layers, softcaps, D = 256)
               served by the same PD traffic plus one prompt of 4400-4800
               tokens (max_len 5120), then a convertible Engine with two
               prompts of 600-1100 and one of 4300-4700 (chunks past 4096
               meet the window); the attention kernels' counters are read
               around exactly this phase; every transfer is 344,064 B per
               128-rounded token; the long prompt's logits through the
               kernels against the plain versions (bf16: finite, beside the
               plain path against itself in another rounding; the model in
               f32: within 1e-3); the same two profiles
  7. exact   — the f32 SMOKE configs (Llama, RWKV-6, Gemma-2 with prompts
               past its 64-token window, Llama with the int8 KV cache,
               DeepSeek-V2-Lite, Kimi K2, Jamba with prompts past the
               16-token chunk) served by PDCluster, the MoE / Mamba ones
               also by a convertible Engine, and Llama-3.2-Vision by an
               Engine with an image per request, give the same tokens as
               greedy generation on the card
  8. qwen    — Qwen-2.5-32B at its published widths and depth (bf16, seed
               0; 61 GiB of weights shared by every instance; the Scaler
               boots at most 2 of a kind) on phase 3's PD traffic; every
               transfer is 262,144 B per 128-rounded token; both attention
               kernels launch (their counters, read around this phase, go
               into the kernels line as the _qwen rows); the two profiles;
               the logits by phase 3's bf16 rule (or the plain path's own
               spread beside it), then in f32 on the first 12 layers
  9. deepseek — DeepSeek-V2-Lite at its published widths and depth (MLA,
               64 routed experts top-6 + 2 shared, a dense first layer;
               bf16, seed 0) on the same PD traffic; every transfer is the
               latent cache, 31,104 B per 128-rounded token; the attention
               kernels' counters read 0 (MLA takes no kernel path, as in
               the reference); the two profiles
 10. vision  — Llama-3.2-Vision 11B at its published widths and depth
               (bf16, seed 0, cross-attention gates at 1) served by an
               Engine (4 slots, max_len 2048, no chunking) to 6 requests of
               64-1024 tokens, each with its own (6400, 4096) image; both
               attention kernels launch on the self-attention layers; the
               logits change with the image; the two profiles; the logits
               as phase 8's, with the model in f32 at full depth

Phases run in this order, one after another; each frees its model before
the next, and each one's wall time is printed as "[phase] name: s".
The second-to-last line is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BYTES = 3.35e12                     # H100 SXM HBM3, bytes/s
PEAK_OPS = {torch.bfloat16: 989e12,      # dense tensor-core bf16, FLOP/s
            torch.float32: 67e12}        # f32 outside the tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
WKV_TOL = 2e-4                           # tests/test_kernels.py's WKV6 rule
WKV_SWEEP = [                            # tests/test_kernels.py's wkv6 cases
    (1, 16, 1, 8, 16), (2, 37, 2, 16, 16), (1, 64, 4, 32, 32),
    (2, 16, 2, 64, 8),
]
PAGED_CASES = [                          # tests/test_paged_and_sampling.py
    (1, 2, 4, 16, 2, 1, 16), (3, 4, 12, 16, 4, 2, 32),
    (2, 3, 8, 32, 8, 8, 64),
]
DECODE_CUR = [0, 700, 1500, 2047]        # the decode rows' cache lengths
PAYLOAD_LLAMA = 131_072                  # 32 x 2 x 8 x 128 x 2 B per token
PAYLOAD_RWKV = 21_299_200                # 32 x (40*64*64*4 + 2*2560*2) B
PAYLOAD_GEMMA = 344_064                  # 42 x 2 x 8 x 256 x 2 B per token
PAYLOAD_QWEN = 262_144                   # 64 x 2 x 8 x 128 x 2 B per token
PAYLOAD_DEEPSEEK = 31_104                # 27 x (512 + 64) x 2 B per token
QWEN_F32_LAYERS = 12                     # Qwen's f32 logits check: 12 of 64
GEMMA_DECODE_CUR = [0, 700, 1500, 4600]  # Gemma-2-9B's decode rows
GEMMA_WINDOW, GEMMA_CAP = 4096, 50.0     # its local layers' window, softcap
PREFILL_SWEEP = [                        # tests/test_kernels.py SWEEP + G=5
    (1, 8, 8, 1, 1, 16, 0, 0.0), (2, 24, 40, 4, 2, 64, 0, 0.0),
    (2, 24, 40, 4, 2, 64, 16, 0.0), (2, 24, 40, 4, 2, 64, 0, 30.0),
    (1, 128, 128, 8, 8, 32, 0, 0.0), (3, 17, 33, 6, 1, 64, 0, 0.0),
    (1, 256, 384, 2, 2, 128, 64, 50.0), (2, 9, 40, 10, 2, 64, 0, 0.0),
]
# its decode sweep + softcap, G=5; windows inside one split and across
# splits; one request of 8192 positions (64 splits)
DECODE_SWEEP = [
    (1, 16, 1, 1, 16, 0, 0.0), (2, 64, 8, 2, 64, 0, 0.0),
    (2, 64, 8, 2, 64, 16, 0.0), (2, 64, 8, 2, 64, 0, 30.0),
    (4, 129, 4, 1, 128, 0, 0.0), (1, 512, 16, 16, 64, 0, 0.0),
    (3, 96, 10, 2, 128, 0, 50.0), (3, 192, 8, 2, 32, 20, 0.0),
    (2, 256, 8, 2, 32, 100, 0.0), (1, 8192, 32, 8, 128, 0, 0.0),
]


class PhaseFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# masks, bounds, timing
# ---------------------------------------------------------------------------

def prefill_ranges(Sq, off, lens, window):
    """Per (batch row, query row): the visible key range [lo, hi)."""
    t = np.arange(Sq)[None]
    q_pos = np.asarray(off)[:, None] + t
    hi = np.minimum(q_pos + 1, np.asarray(lens)[:, None])
    lo = np.maximum(q_pos - window + 1, 0) if window else np.zeros_like(hi)
    return lo, np.maximum(hi, lo)


def prefill_bound(q, k, off, lens, window):
    """Least time for this call: visible pairs x 4*D flops over the peak
    for the input type, or each q/out row and each needed k/v row once over
    the memory rate, whichever is larger."""
    B, Sq, Hq, D = q.shape
    Hkv, e = k.shape[2], q.element_size()
    lo, hi = prefill_ranges(Sq, off, lens, window)
    ops = 4.0 * D * Hq * float((hi - lo).sum())
    keys = sum(int(h.max() - l.min()) for l, h in zip(lo, hi) if h.max() > 0)
    nbytes = e * D * (2 * B * Sq * Hq + 2 * keys * Hkv)
    return _bound(ops, nbytes, q.dtype)


def decode_bound(q, k, cur, window):
    B, Hq, D = q.shape
    L, Hkv, e = k.shape[1], k.shape[2], q.element_size()
    cur = np.minimum(np.asarray(cur), L - 1)
    lo = np.maximum(cur - window + 1, 0) if window else np.zeros_like(cur)
    keys = float((cur - lo + 1).sum())
    ops = 4.0 * D * Hq * keys
    nbytes = e * D * (2 * B * Hq + 2 * keys * Hkv)
    return _bound(ops, nbytes, q.dtype)


def wkv6_bound(B, S, H, K, C):
    """Each of r, k, v, w read once and y written once (f32), u, s0 read
    and sT written once; the chunked algorithm's flops over the f32 peak:
    per chunk and head, 4 C K^2 (inter-chunk y, state carry) + 4 C^2 K
    (intra-chunk scores and y)."""
    nbytes = 4 * (5 * B * S * H * K + H * K + 2 * B * H * K * K)
    ops = B * H * math.ceil(S / C) * (4 * C * K * K + 4 * C * C * K)
    return _bound(ops, nbytes, torch.float32)


def _bound(ops, nbytes, dtype):
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(fn, arg_sets, iters=20, graph=True, reps=5):
    """Ms per call of `iters` calls cycling through `arg_sets` (held large
    enough together to exceed the 50 MB L2, so inputs come cold).

    With `graph`, the calls are captured once in a torch.cuda.CUDAGraph and
    the graph is replayed `reps` times between CUDA events: the device's
    time, without the host's enqueue (ctypes, allocation), which at tens of
    us per call can exceed a kernel's.  A capture that fails raises.  Also
    returned: the same calls timed eagerly between CUDA events, and the
    host's enqueue time per call.  Returns {"ms", "eager_ms", "host_us"};
    without `graph` (the plain versions, which copy from the host and cannot
    be captured), "ms" is the eager figure."""
    for a in arg_sets[:3]:
        fn(*a)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    h = time.perf_counter()
    t0.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    t1.record()
    host_us = (time.perf_counter() - h) / iters * 1e6
    torch.cuda.synchronize()
    out = dict(ms=t0.elapsed_time(t1) / iters, host_us=host_us)
    out["eager_ms"] = out["ms"]
    if not graph:
        return out
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):               # warm up off the capture
        for a in arg_sets[:3]:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    g.replay()
    torch.cuda.synchronize()
    t0.record()
    for _ in range(reps):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    out["ms"] = t0.elapsed_time(t1) / (reps * iters)
    del g
    return out


def i32(values):
    """A device int32 tensor: what the kernels take, so the timed calls
    launch no conversion kernel."""
    return torch.tensor(values, dtype=torch.int32, device="cuda")


def n_copies(nbytes):
    return int(min(16, max(2, math.ceil(200e6 / max(nbytes, 1)))))


def max_err(out, want):
    torch.cuda.synchronize()
    return (out.float() - want.float()).abs().max().item()


def close(out, want, tol):
    """The reference's assert_allclose rule: |a-b| <= tol + tol*|b|."""
    torch.cuda.synchronize()
    o, w = out.float(), want.float()
    return bool(((o - w).abs() <= tol + tol * w.abs()).all())


def bound_share(out, want, tol):
    """Largest |a-b| as a share of close()'s bound tol + tol*|b|."""
    torch.cuda.synchronize()
    w = want.double()
    return ((out.double() - w).abs() / (tol + tol * w.abs())).max().item()


def bf16_bound_share(out, want):
    """Largest |a-b| as a share of a bound that bf16 outputs of one f32
    computation must meet: the f32 tolerance (order of the f32 arithmetic)
    plus 2 bf16 steps at |b| (each side rounds its f32 result, and may land
    one step of the larger binade away).  At most 1 to pass."""
    torch.cuda.synchronize()
    w = want.float()
    _, e = torch.frexp(w)                   # |w| in [2^(e-1), 2^e)
    bound = TOL[torch.float32] + 2 * torch.ldexp(torch.ones_like(w), e - 8)
    return ((out.float() - w).abs() / bound).max().item()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import build
    t = time.perf_counter()
    build.build_all()
    log(f"[build] all {len(build.SOURCES)} kernels built in "
        f"{time.perf_counter() - t:.1f} s")
    d256 = {}
    for name in build.SOURCES:
        rep = ptxas_report(build.build_log(name))
        log(f"[build] {name}: ptxas {rep}")
        d256.update({k: v for k, v in rep.items() if "256" in k.split("<")[1]})
    log(f"[build] head dim 256 instantiations: ptxas {d256}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(), "nvidia-smi failed")
    card = smi.stdout.strip().splitlines()[0]
    log(card)                           # name, power limit: beside every time
    return card


def ptxas_report(text):
    """Registers and spill bytes of each kernel instantiation in an nvcc
    -Xptxas -v log, as {"kernel<args>": "R regs, spills S/L B"}."""
    import re
    out, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '_ZN(\S+)'", ln)
        if m:                       # _ZN <len><id>... I <template args> E
            mangled, ids = m.group(1), []
            while (k := re.match(r"(\d+)", mangled)):
                n = int(k.group(1))
                ids.append(mangled[len(k.group(1)):len(k.group(1)) + n])
                mangled = mangled[len(k.group(1)) + n:]
            args = ["bf16" if "bfloat16" in a else "f32" if a == "f" else a
                    for a in re.findall(r"L[ib](\d+)E|(13__nv_bfloat16)|"
                                        r"^I(f)", mangled) for a in a if a]
            name = f"{ids[-1] if ids else m.group(1)}<{','.join(args)}>"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            out[name] = f"spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name] = f"{m.group(1)} regs, " + out.get(name, "")
    return out


def judge_attention(errs, kind, label, dt, out, want):
    """An attention kernel's output against its plain version: the
    reference's tolerance for the type and, in bf16, 2e-5 + 2 bf16 steps of
    the plain value; bf16 errors go into errs[kind].  Logs; returns ok."""
    bf = torch.bfloat16
    e, good = max_err(out, want), close(out, want, TOL[dt])
    note = f"max_abs_err {e:.3g} (tol {TOL[dt]})"
    if dt == bf:
        share = bf16_bound_share(out, want)
        good &= share <= 1
        note += f"; {share:.3g} of the 2e-5 + 2 bf16 steps bound"
        errs[kind] = max(errs[kind], e)
    log(f"[parity] {kind} {'bf16' if dt == bf else 'f32'} {label}: "
        f"{note} {'ok' if good else 'FAIL'}")
    return good


def _rand(g, shape, dtype):
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def phase_parity():
    import torch.nn.functional as F

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    errs = {"chunked_prefill_attention": 0.0, "decode_attention": 0.0}
    ok = True

    # Llama-3.1-8B heads at the main-path shapes, bf16 and f32.  A typical
    # output there is ~0.04, as large as the 3e-2 bf16 tolerance, so bf16
    # is also held to 2e-5 + 2 bf16 steps of the plain version's value.
    bf, f32 = torch.bfloat16, torch.float32
    cases = {"whole prompt Sq=512 Skv=2048": (512, 0, 512),
             "convertible chunk Sq=256 off=768 len=1024": (256, 768, 1024),
             "burst prompt Sq=2048 Skv=2048 len=1500": (2048, 0, 1500)}

    main_inputs = {}
    for dt in (bf, f32):
        for label, (Sq, off, n) in cases.items():
            q = _rand(g, (1, Sq, 32, 128), dt)
            k = _rand(g, (1, 2048, 8, 128), dt)
            v = _rand(g, (1, 2048, 8, 128), dt)
            o = torch.tensor([off], device=dev)
            ln = torch.tensor([n], device=dev)
            ok &= judge_attention(
                errs, "chunked_prefill_attention", label, dt,
                kops.prefill_attention(q, k, v, o, ln),
                ref.chunked_prefill_attention_ref(q, k, v, o, ln))
            main_inputs[label] = (Sq, off, n)
        q = _rand(g, (4, 32, 128), dt)
        k, v = _rand(g, (4, 2048, 8, 128), dt), _rand(g, (4, 2048, 8, 128), dt)
        cur = torch.tensor([0, 700, 1500, 2047], device=dev)
        out = kops.decode_attention_op(q, k, v, cur)
        ok &= judge_attention(
            errs, "decode_attention", "B=4 L=2048 cur=[0,700,1500,2047]", dt,
            out, ref.decode_attention_ref(q, k, v, cur))
        split, nsplit = kops.decode_split(2048, 4, 8)
        ok &= judge_attention(
            errs, "decode_attention", f"the same vs the plain split-and-merge "
            f"version ({nsplit} splits of {split})", dt, out,
            ref.decode_attention_split_ref(q, k, v, cur, split))
        same = bool(torch.equal(out, kops.decode_attention_op(q, k, v, cur)))
        ok &= same
        log(f"[parity] decode_attention {'bf16' if dt == bf else 'f32'}: two "
            f"calls bit-equal: {same}")

    # the reference's kernel-test sweep: bf16 runs the tensor-core path
    # (3e-2 and the bf16-steps bound), f32 the CUDA-core path (2e-5)
    for dt in (bf, f32):
        worst = share = 0.0
        for B, Sq, Skv, Hq, Hkv, D, window, cap in PREFILL_SWEEP:
            q = _rand(g, (B, Sq, Hq, D), dt)
            k, v = _rand(g, (B, Skv, Hkv, D), dt), _rand(g, (B, Skv, Hkv, D), dt)
            off = torch.randint(0, Skv - Sq + 1, (B,), generator=g, device=dev)
            ln = torch.randint(1, Skv + 1, (B,), generator=g, device=dev)
            out = kops.prefill_attention(q, k, v, off, ln, window=window,
                                         softcap=cap)
            want = ref.chunked_prefill_attention_ref(
                q, k, v, off, ln, window=window, softcap=cap)
            worst = max(worst, max_err(out, want))
            good = close(out, want, TOL[dt])
            if dt == bf:
                one = bf16_bound_share(out, want)
                share = max(share, one)
                good &= one <= 1
            ok &= good
            if not good:
                log(f"[parity] prefill {dt} "
                    f"{(B, Sq, Skv, Hq, Hkv, D, window, cap)} FAIL")
        note = f"; {share:.3g} of the 2e-5 + 2 bf16 steps bound" \
            if dt == bf else ""
        log(f"[parity] prefill {'bf16' if dt == bf else 'f32'} sweep "
            f"({len(PREFILL_SWEEP)} cases): max_abs_err {worst:.3g} (tol "
            f"{TOL[dt]}){note}")
    worst = 0.0
    for B, L, Hq, Hkv, D, window, cap in DECODE_SWEEP:
        q = _rand(g, (B, Hq, D), f32)
        k, v = _rand(g, (B, L, Hkv, D), f32), _rand(g, (B, L, Hkv, D), f32)
        cur = torch.randint(0, L, (B,), generator=g, device=dev)
        out = kops.decode_attention_op(q, k, v, cur, window=window,
                                       softcap=cap)
        want = ref.decode_attention_ref(q, k, v, cur, window=window,
                                        softcap=cap)
        worst = max(worst, max_err(out, want))
        good = close(out, want, TOL[f32])
        ok &= good
        if not good:
            log(f"[parity] decode f32 {(B, L, Hq, Hkv, D, window, cap)} FAIL")
    log(f"[parity] decode f32 sweep ({len(DECODE_SWEEP)} cases): "
        f"max_abs_err {worst:.3g} (tol {TOL[f32]})")

    # NaN in the dead region (past cur_len, behind the window)
    q = _rand(g, (2, 8, 64), f32)
    k, v = _rand(g, (2, 256, 2, 64), f32), _rand(g, (2, 256, 2, 64), f32)
    cur = torch.tensor([10, 100], device=dev)
    clean = kops.decode_attention_op(q, k, v, cur, window=32)
    for b, c in enumerate(cur.tolist()):
        for t in (k, v):
            t[b, c + 1:] = float("nan")
            t[b, :max(c - 31, 0)] = float("nan")
    dirty = kops.decode_attention_op(q, k, v, cur, window=32)
    want = ref.decode_attention_ref(q, k, v, cur, window=32)
    good = bool(torch.equal(clean, dirty)) and close(dirty, want, TOL[f32])
    ok &= good
    log(f"[parity] decode NaN-poisoned dead region: "
        f"{'ok' if good else 'FAIL'}")
    check(ok, "kernel parity failed")

    # times at the main-path shapes
    rows = {}
    Sq, off, n = main_inputs["whole prompt Sq=512 Skv=2048"]
    set_bytes = (Sq * 32 + 2 * 2048 * 8) * 128 * 2
    sets = []
    for _ in range(n_copies(set_bytes)):
        q = _rand(g, (1, Sq, 32, 128), bf)
        k, v = _rand(g, (1, 2048, 8, 128), bf), _rand(g, (1, 2048, 8, 128), bf)
        sets.append((q, k, v, i32([off]), i32([n])))
    mask = (torch.arange(2048, device=dev)[None, :]
            <= torch.arange(Sq, device=dev)[:, None] + off) \
        & (torch.arange(2048, device=dev)[None, :] < n)
    sdpa_sets = [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  mask[None, None]) for q, k, v, _, _ in sets]
    rows["chunked_prefill_attention"] = timed_row(
        kops.prefill_attention, ref.chunked_prefill_attention_ref, sets,
        lambda q, k, v, m: F.scaled_dot_product_attention(
            q, k, v, attn_mask=m, enable_gqa=True), sdpa_sets,
        bound=prefill_bound(sets[0][0], sets[0][1], [off], [n], 0),
        shape="B=1 Sq=512 Skv=2048 Hq=32 Hkv=8 D=128 bf16, offset 0, len 512")
    # the convertible chunk and a burst prompt, for the record
    for label in ("convertible chunk Sq=256 off=768 len=1024",
                  "burst prompt Sq=2048 Skv=2048 len=1500"):
        Sq2, off2, n2 = main_inputs[label]
        xsets = []
        for _ in range(n_copies((Sq2 * 32 + 2 * 2048 * 8) * 128 * 2)):
            q = _rand(g, (1, Sq2, 32, 128), bf)
            k = _rand(g, (1, 2048, 8, 128), bf)
            xsets.append((q, k, _rand(g, (1, 2048, 8, 128), bf),
                          i32([off2]), i32([n2])))
        xmask = (torch.arange(2048, device=dev)[None, :]
                 <= torch.arange(Sq2, device=dev)[:, None] + off2) \
            & (torch.arange(2048, device=dev)[None, :] < n2)
        r = timed_row(
            kops.prefill_attention, ref.chunked_prefill_attention_ref, xsets,
            lambda q, k, v, m: F.scaled_dot_product_attention(
                q, k, v, attn_mask=m, enable_gqa=True),
            [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
              xmask[None, None]) for q, k, v, _, _ in xsets],
            bound=prefill_bound(xsets[0][0], xsets[0][1], [off2], [n2], 0))
        log(f"[time] prefill kernel, {label}: {r['ms']:.4f} ms (graph; eager "
            f"{r['eager_ms']:.4f} ms, host {r['host_us']:.1f} us/call); "
            f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), "
            f"{r['bound'][0] / r['ms']:.3f} of it; plain {r['plain_ms']:.4f} "
            f"ms (eager); SDPA {r['library_ms']:.4f} ms (eager "
            f"{r['library_eager_ms']:.4f})")
        del xsets

    curs = i32(DECODE_CUR)
    dsets = []
    for _ in range(n_copies(4 * 2048 * 8 * 128 * 2 * 2)):
        q = _rand(g, (4, 32, 128), bf)
        k, v = _rand(g, (4, 2048, 8, 128), bf), _rand(g, (4, 2048, 8, 128), bf)
        dsets.append((q, k, v, curs))
    dmask = (torch.arange(2048, device=dev)[None, :] <= curs[:, None])
    sdpa_d = [(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
               dmask[:, None, None]) for q, k, v, _ in dsets]
    rows["decode_attention"] = timed_row(
        kops.decode_attention_op, ref.decode_attention_ref, dsets,
        lambda q, k, v, m: F.scaled_dot_product_attention(
            q, k, v, attn_mask=m, enable_gqa=True), sdpa_d,
        bound=decode_bound(dsets[0][0], dsets[0][1], DECODE_CUR, 0),
        shape="B=4 L=2048 Hq=32 Hkv=8 D=128 bf16, cur_lens 0/700/1500/2047")
    log(f"[time] decode_attention device us per call by kernel "
        f"(torch.profiler): "
        f"{device_us_by_kernel(kops.decode_attention_op, dsets)}")
    errs["paged_decode_attention"], rows["paged_decode_attention"] = \
        parity_paged(g)
    errs["wkv6"], rows["wkv6"] = parity_wkv6(g)
    e256, r256 = parity_head_dim_256(g)
    for name in r256:
        errs[f"{name}_d256"] = e256[name]
        rows[f"{name}_d256"] = r256[name]
    eq, rq = parity_qwen_heads(g)
    for name in rq:
        errs[f"{name}_qwen"] = eq[name]
        rows[f"{name}_qwen"] = rq[name]
    for name, r in rows.items():
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms (eager {r['library_eager_ms']:.4f})"
        log(f"[time] {name} ({r['shape']}): kernel {r['ms']:.4f} ms "
            f"(graph; eager {r['eager_ms']:.4f} ms, host {r['host_us']:.1f} "
            f"us/call); bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), "
            f"{r['bound'][0] / r['ms']:.3f} of it; plain {r['plain_ms']:.4f}"
            f" ms (eager); library {lib}")
    return errs, rows


def parity_head_dim_256(g):
    """The three attention kernels at head dim 256 (Gemma, Gemma-2) against
    their plain versions, in bf16 (3e-2 and 2e-5 + 2 bf16 steps) and f32
    (2e-5): prefill with Gemma-2-9B's heads (16 / 8) and softcap 50, at a
    prompt, a prompt past the 4096 window and a chunk past it, and with
    Gemma-2B's MQA heads (8 / 1); decode with Gemma-2-9B's heads, a window
    that bites and softcap 50, also against the plain split-and-merge
    version and bit-equal to itself, and with the MQA heads; paged decode
    over interleaved pages, bit-equal to the contiguous kernel on the
    gathered KV.  Then times at Gemma-2-9B's main shapes beside SDPA at the
    same shape with no softcap and no window (SDPA has no softcap: a
    yardstick, not the same function).  Returns (bf16 errors, rows) keyed
    by kernel."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    t0 = time.perf_counter()
    bf, f32, D = torch.bfloat16, torch.float32, 256
    errs = {"chunked_prefill_attention": 0.0, "decode_attention": 0.0,
            "paged_decode_attention": 0.0}
    ok = True
    prefill_cases = {
        # label: (Hq, Hkv, Sq, Skv, offset, length, window, softcap)
        "Gemma-2-9B heads, prompt Sq=512 Skv=2048, softcap 50":
            (16, 8, 512, 2048, 0, 512, 0, GEMMA_CAP),
        "Gemma-2-9B heads, prompt past the window Sq=5120 len=4600, "
        "window 4096, softcap 50":
            (16, 8, 5120, 5120, 0, 4600, GEMMA_WINDOW, GEMMA_CAP),
        "Gemma-2-9B heads, chunk past the window Sq=256 off=4352 len=4608, "
        "window 4096, softcap 50":
            (16, 8, 256, 5120, 4352, 4608, GEMMA_WINDOW, GEMMA_CAP),
        "Gemma-2B MQA heads 8/1, prompt Sq=512 Skv=2048":
            (8, 1, 512, 2048, 0, 512, 0, 0.0),
    }
    decode_cases = {
        # label: (Hq, Hkv, L, cur_lens, window, softcap)
        f"Gemma-2-9B heads B=4 L=5120 cur={GEMMA_DECODE_CUR}, window 4096, "
        "softcap 50": (16, 8, 5120, GEMMA_DECODE_CUR, GEMMA_WINDOW,
                       GEMMA_CAP),
        "Gemma-2B MQA heads 8/1 B=3 L=2048 cur=[2047, 0, 1000]":
            (8, 1, 2048, [2047, 0, 1000], 0, 0.0),
    }
    tables = torch.as_tensor(interleaved_tables([c + 1 for c in DECODE_CUR],
                                                40, 16), device="cuda")
    safe = tables.clamp(min=0).long()
    pcur = i32(DECODE_CUR)
    for dt in (bf, f32):
        tag = "bf16" if dt == bf else "f32"
        for label, (Hq, Hkv, Sq, Skv, off, n, win, cap) in \
                prefill_cases.items():
            q = _rand(g, (1, Sq, Hq, D), dt)
            k = _rand(g, (1, Skv, Hkv, D), dt)
            v = _rand(g, (1, Skv, Hkv, D), dt)
            o, ln = i32([off]), i32([n])
            ok &= judge_attention(
                errs, "chunked_prefill_attention", f"D=256 {label}", dt,
                kops.prefill_attention(q, k, v, o, ln, window=win,
                                       softcap=cap),
                ref.chunked_prefill_attention_ref(q, k, v, o, ln, window=win,
                                                  softcap=cap))
            del q, k, v
        for label, (Hq, Hkv, L, curs, win, cap) in decode_cases.items():
            B = len(curs)
            q = _rand(g, (B, Hq, D), dt)
            k, v = _rand(g, (B, L, Hkv, D), dt), _rand(g, (B, L, Hkv, D), dt)
            cur = i32(curs)
            out = kops.decode_attention_op(q, k, v, cur, window=win,
                                           softcap=cap)
            split, nsplit = kops.decode_split(L, B, Hkv)
            ok &= judge_attention(
                errs, "decode_attention", f"D=256 {label}", dt, out,
                ref.decode_attention_ref(q, k, v, cur, window=win,
                                         softcap=cap))
            ok &= judge_attention(
                errs, "decode_attention", f"D=256 {label}, vs the plain "
                f"split-and-merge version ({nsplit} splits of {split})", dt,
                out, ref.decode_attention_split_ref(q, k, v, cur, split,
                                                    window=win, softcap=cap))
            same = bool(torch.equal(out, kops.decode_attention_op(
                q, k, v, cur, window=win, softcap=cap)))
            ok &= same
            log(f"[parity] decode_attention {tag} D=256 {label}: two calls "
                f"bit-equal: {same}")
        q = _rand(g, (4, 16, D), dt)
        pk, pv = _rand(g, (40, 128, 8, D), dt), _rand(g, (40, 128, 8, D), dt)
        out = kops.paged_decode_attention(q, pk, pv, tables, pcur)
        split, _ = kops.decode_split(16 * 128, 4, 8, 128)
        label = f"D=256 Gemma-2-9B heads B=4 cur={DECODE_CUR} interleaved " \
            "pages"
        ok &= judge_attention(
            errs, "paged_decode_attention", label, dt, out,
            ref.paged_decode_attention_ref(q, pk, pv, tables, pcur))
        ok &= judge_attention(
            errs, "paged_decode_attention", f"{label}, vs the plain "
            "split-and-merge version", dt, out,
            ref.paged_decode_attention_split_ref(q, pk, pv, tables, pcur,
                                                 split))
        same = bool(torch.equal(out, kops.decode_attention_op(
            q, pk[safe].reshape(4, -1, 8, D), pv[safe].reshape(4, -1, 8, D),
            pcur)))
        ok &= same
        log(f"[parity] paged_decode_attention {tag} {label}: bit-equal to "
            f"the contiguous decode kernel on the gathered KV: {same}")
    check(ok, "head dim 256 kernel parity failed")

    def sdpa(q, k, v, m):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                              enable_gqa=True)

    def prefill_row(Sq, Skv, n, win, shape):
        kv_bytes = (Sq * 16 + 2 * Skv * 8) * D * 2
        sets = []
        for _ in range(n_copies(kv_bytes)):
            q = _rand(g, (1, Sq, 16, D), bf)
            k, v = _rand(g, (1, Skv, 8, D), bf), _rand(g, (1, Skv, 8, D), bf)
            sets.append((q, k, v, i32([0]), i32([n])))
        ar = torch.arange(Skv, device="cuda")
        mask = (ar[None, :] <= torch.arange(Sq, device="cuda")[:, None]) \
            & (ar[None, :] < n)
        return timed_row(
            lambda q, k, v, o, ln: kops.prefill_attention(
                q, k, v, o, ln, window=win, softcap=GEMMA_CAP),
            lambda q, k, v, o, ln: ref.chunked_prefill_attention_ref(
                q, k, v, o, ln, window=win, softcap=GEMMA_CAP),
            sets, sdpa,
            [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
              mask[None, None]) for q, k, v, _, _ in sets],
            bound=prefill_bound(sets[0][0], sets[0][1], [0], [n], win),
            shape=shape)

    rows = {"chunked_prefill_attention": prefill_row(
        512, 2048, 512, 0, "B=1 Sq=512 Skv=2048 Hq=16 Hkv=8 D=256 bf16, "
        "softcap 50, offset 0, len 512")}
    r = prefill_row(5120, 5120, 4600, GEMMA_WINDOW, "")
    log(f"[time] prefill kernel D=256, Gemma-2-9B prompt past the window "
        f"(Sq=5120 Skv=5120 len 4600, window 4096, softcap 50): "
        f"{r['ms']:.4f} ms (graph; eager {r['eager_ms']:.4f} ms, host "
        f"{r['host_us']:.1f} us/call); bound {r['bound'][0]:.4f} ms "
        f"({r['bound'][1]}), {r['bound'][0] / r['ms']:.3f} of it; plain "
        f"{r['plain_ms']:.4f} ms (eager); SDPA with no softcap and no window "
        f"{r['library_ms']:.4f} ms (eager {r['library_eager_ms']:.4f})")

    def decode(q, k, v, c):
        return kops.decode_attention_op(q, k, v, c, window=GEMMA_WINDOW,
                                        softcap=GEMMA_CAP)

    L, curs = 5120, i32(GEMMA_DECODE_CUR)
    dsets = []
    for _ in range(n_copies(4 * L * 8 * D * 2 * 2)):
        q = _rand(g, (4, 16, D), bf)
        k, v = _rand(g, (4, L, 8, D), bf), _rand(g, (4, L, 8, D), bf)
        dsets.append((q, k, v, curs))
    dmask = torch.arange(L, device="cuda")[None, :] <= curs[:, None]
    rows["decode_attention"] = timed_row(
        decode, lambda q, k, v, c: ref.decode_attention_ref(
            q, k, v, c, window=GEMMA_WINDOW, softcap=GEMMA_CAP),
        dsets, sdpa,
        [(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
          dmask[:, None, None]) for q, k, v, _ in dsets],
        bound=decode_bound(dsets[0][0], dsets[0][1], GEMMA_DECODE_CUR,
                           GEMMA_WINDOW),
        shape=f"B=4 L=5120 Hq=16 Hkv=8 D=256 bf16, cur_lens "
              f"{'/'.join(map(str, GEMMA_DECODE_CUR))}, window 4096, "
              "softcap 50")
    log(f"[time] decode_attention D=256 device us per call by kernel "
        f"(torch.profiler): "
        f"{device_us_by_kernel(decode, dsets)}")
    for row in rows.values():
        row["shape"] += "; library: SDPA with no softcap and no window, a " \
            "yardstick only"
    rows["paged_decode_attention"] = paged_row_d256(g)
    log(f"[parity] head dim 256 checks and times: "
        f"{time.perf_counter() - t0:.1f} s")
    return errs, rows


def parity_qwen_heads(g):
    """The two attention kernels at Qwen-2.5-32B's heads (Hq 40 over Hkv 8,
    G = 5, D 128) at the main path's shapes, against their plain versions
    in bf16 (3e-2 and 2e-5 + 2 bf16 steps) and f32 (2e-5): prefill of
    Sq=512 into Skv=2048 (length 512) and a convertible chunk, decode at
    B=4, cur 0/700/1500/2047 (also against the split-and-merge version,
    and bit-equal to itself).  Then both timed beside their bound, plain
    version and SDPA (the same function here: no window, no softcap).
    Returns (bf16 errors, rows) keyed by kernel."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    bf, f32, Hq, Hkv, D = torch.bfloat16, torch.float32, 40, 8, 128
    errs = {"chunked_prefill_attention": 0.0, "decode_attention": 0.0}
    ok = True
    for dt in (bf, f32):
        for label, (Sq, off, n) in {
                "prompt Sq=512 Skv=2048 len=512": (512, 0, 512),
                "convertible chunk Sq=256 off=768 len=1024": (256, 768, 1024)
        }.items():
            q = _rand(g, (1, Sq, Hq, D), dt)
            k = _rand(g, (1, 2048, Hkv, D), dt)
            v = _rand(g, (1, 2048, Hkv, D), dt)
            o, ln = i32([off]), i32([n])
            ok &= judge_attention(
                errs, "chunked_prefill_attention", f"Qwen heads 40/8 {label}",
                dt, kops.prefill_attention(q, k, v, o, ln),
                ref.chunked_prefill_attention_ref(q, k, v, o, ln))
        q = _rand(g, (4, Hq, D), dt)
        k, v = _rand(g, (4, 2048, Hkv, D), dt), _rand(g, (4, 2048, Hkv, D), dt)
        cur = i32(DECODE_CUR)
        out = kops.decode_attention_op(q, k, v, cur)
        split, nsplit = kops.decode_split(2048, 4, Hkv)
        label = f"Qwen heads 40/8 B=4 L=2048 cur={DECODE_CUR}"
        ok &= judge_attention(errs, "decode_attention", label, dt, out,
                              ref.decode_attention_ref(q, k, v, cur))
        ok &= judge_attention(
            errs, "decode_attention", f"{label}, vs the plain split-and-merge "
            f"version ({nsplit} splits of {split})", dt, out,
            ref.decode_attention_split_ref(q, k, v, cur, split))
        same = bool(torch.equal(out, kops.decode_attention_op(q, k, v, cur)))
        ok &= same
        log(f"[parity] decode_attention {'bf16' if dt == bf else 'f32'} "
            f"{label}: two calls bit-equal: {same}")
    check(ok, "kernel parity at Qwen's heads failed")

    def sdpa(q, k, v, m):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                              enable_gqa=True)

    sets = []
    for _ in range(n_copies((512 * Hq + 2 * 2048 * Hkv) * D * 2)):
        q = _rand(g, (1, 512, Hq, D), bf)
        k, v = _rand(g, (1, 2048, Hkv, D), bf), _rand(g, (1, 2048, Hkv, D), bf)
        sets.append((q, k, v, i32([0]), i32([512])))
    ar = torch.arange(2048, device="cuda")
    mask = (ar[None, :] <= torch.arange(512, device="cuda")[:, None]) \
        & (ar[None, :] < 512)
    rows = {"chunked_prefill_attention": timed_row(
        kops.prefill_attention, ref.chunked_prefill_attention_ref, sets, sdpa,
        [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
          mask[None, None]) for q, k, v, _, _ in sets],
        bound=prefill_bound(sets[0][0], sets[0][1], [0], [512], 0),
        shape="B=1 Sq=512 Skv=2048 Hq=40 Hkv=8 D=128 bf16, offset 0, "
              "len 512 (Qwen-2.5-32B heads)")}
    curs, dsets = i32(DECODE_CUR), []
    for _ in range(n_copies(4 * 2048 * Hkv * D * 2 * 2)):
        q = _rand(g, (4, Hq, D), bf)
        k, v = _rand(g, (4, 2048, Hkv, D), bf), _rand(g, (4, 2048, Hkv, D), bf)
        dsets.append((q, k, v, curs))
    dmask = torch.arange(2048, device="cuda")[None, :] <= curs[:, None]
    rows["decode_attention"] = timed_row(
        kops.decode_attention_op, ref.decode_attention_ref, dsets, sdpa,
        [(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
          dmask[:, None, None]) for q, k, v, _ in dsets],
        bound=decode_bound(dsets[0][0], dsets[0][1], DECODE_CUR, 0),
        shape="B=4 L=2048 Hq=40 Hkv=8 D=128 bf16, cur_lens "
              "0/700/1500/2047 (Qwen-2.5-32B heads)")
    return errs, rows


def paged_row_d256(g):
    """The paged kernel at D = 256, Gemma-2-9B's heads (16 / 8), B=4 at
    cur 0/700/1500/4600 over interleaved 128-token pages of a 64-page
    pool, timed beside its bound, its plain version and SDPA on the
    gathered KV (the gather not timed).  The paged kernel, like the
    reference's, takes no window and no softcap, so every key up to cur
    is live and SDPA computes the same function."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    bf, D, Hq, Hkv = torch.bfloat16, 256, 16, 8
    tables = torch.as_tensor(interleaved_tables(
        [c + 1 for c in GEMMA_DECODE_CUR], 64, 40), device="cuda")
    safe = tables.clamp(min=0).long()
    cur = i32(GEMMA_DECODE_CUR)
    mask = torch.arange(40 * 128, device="cuda")[None, :] <= cur[:, None]
    sets, sdpa = [], []
    for _ in range(n_copies(2 * 64 * 128 * Hkv * D * 2)):
        q = _rand(g, (4, Hq, D), bf)
        pk = _rand(g, (64, 128, Hkv, D), bf)
        pv = _rand(g, (64, 128, Hkv, D), bf)
        sets.append((q, pk, pv, tables, cur))
        sdpa.append((q[:, :, None],
                     pk[safe].reshape(4, -1, Hkv, D).transpose(1, 2),
                     pv[safe].reshape(4, -1, Hkv, D).transpose(1, 2),
                     mask[:, None, None]))
    q, pk, pv = sets[0][:3]
    good = judge_attention({"paged_decode_attention": 0.0},
                           "paged_decode_attention", "D=256 Gemma-2-9B heads "
                           f"B=4 cur={GEMMA_DECODE_CUR} interleaved pages",
                           bf, kops.paged_decode_attention(q, pk, pv, tables,
                                                           cur),
                           ref.paged_decode_attention_ref(q, pk, pv, tables,
                                                          cur))
    check(good, "paged kernel at D = 256 disagrees")
    return timed_row(
        kops.paged_decode_attention, ref.paged_decode_attention_ref, sets,
        lambda q, k, v, m: F.scaled_dot_product_attention(
            q, k, v, attn_mask=m, enable_gqa=True), sdpa,
        bound=decode_bound(q, sdpa[0][1].transpose(1, 2), GEMMA_DECODE_CUR,
                           0),
        shape=f"B=4 Hq=16 Hkv=8 D=256 bf16, 128-token pages interleaved, "
              f"cur_lens {'/'.join(map(str, GEMMA_DECODE_CUR))} (no window "
              "or softcap: the paged kernel takes none)")


def device_us_by_kernel(fn, arg_sets, calls=20):
    """Device microseconds per call of each kernel `fn` launches, from
    torch.profiler (CUPTI) over `calls` eager calls."""
    from torch.profiler import ProfilerActivity, profile
    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    us = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.split("<")[0].split("::")[-1]
            us[name] = us.get(name, 0.0) + e.time_range.elapsed_us() / calls
    return {k: round(v, 2) for k, v in us.items()}


def timed_row(kernel, plain, sets, library=None, library_sets=None, **row):
    """One row of the kernels line: the kernel and the library call timed
    from a CUDA graph (with their eager figures), the plain version eagerly,
    all on the same inputs."""
    k = time_ms(kernel, sets)
    row.update(ms=k["ms"], eager_ms=k["eager_ms"], host_us=k["host_us"],
               plain_ms=time_ms(plain, sets, graph=False)["ms"],
               library_ms=None, library_eager_ms=None)
    if library is not None:
        lib = time_ms(library, library_sets)
        row.update(library_ms=lib["ms"], library_eager_ms=lib["eager_ms"])
    return row


def interleaved_tables(lens, n_blocks, max_blocks):
    """Block tables for requests of `lens` tokens from a BlockAllocator
    that hands one page to each request in turn: no request's pages are
    contiguous."""
    from repro_torch.serving.paged import BLOCK_SIZE, BlockAllocator
    al = BlockAllocator(n_blocks)
    need = [-(-n // BLOCK_SIZE) for n in lens]
    tables = np.full((len(lens), max_blocks), -1, np.int32)
    for i in range(max(need)):
        for b, n in enumerate(need):
            if i < n:
                tables[b, i] = al.alloc(b)
    return tables


def parity_paged(g):
    """The paged kernel against its plain version: the reference's cases
    (f32), Llama-3.1-8B heads over interleaved 128-token pages (bf16, f32),
    the contiguous decode kernel on the same KV gathered, NaN in foreign
    pages; then its time at the decode rows' shape, with SDPA on the
    gathered KV as the yardstick (the gather is not timed)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    dev, bf, f32 = "cuda", torch.bfloat16, torch.float32
    ok, worst = True, 0.0
    for B, MB, NB, BS, Hq, Hkv, D in PAGED_CASES:
        pk, pv = _rand(g, (NB, BS, Hkv, D), f32), _rand(g, (NB, BS, Hkv, D), f32)
        perm = torch.randperm(NB, generator=g, device=dev)
        tables = torch.full((B, MB), -1, dtype=torch.int32, device=dev)
        curs, j = [], 0
        for b in range(B):
            n = int(torch.randint(1, MB + 1, (1,), generator=g, device=dev))
            tables[b, :n] = perm[j:j + n]
            j += n
            curs.append(int(torch.randint(0, n * BS, (1,), generator=g,
                                          device=dev)))
        cur = torch.tensor(curs, device=dev)
        q = _rand(g, (B, Hq, D), f32)
        out = kops.paged_decode_attention(q, pk, pv, tables, cur)
        want = ref.paged_decode_attention_ref(q, pk, pv, tables, cur)
        worst = max(worst, max_err(out, want))
        ok &= close(out, want, TOL[f32])
    log(f"[parity] paged f32 reference cases ({len(PAGED_CASES)}): "
        f"max_abs_err {worst:.3g} (tol {TOL[f32]}) {'ok' if ok else 'FAIL'}")

    cur = torch.tensor(DECODE_CUR, device=dev)
    tables = torch.as_tensor(interleaved_tables([c + 1 for c in DECODE_CUR],
                                                40, 16), device=dev)
    safe = tables.clamp(min=0).long()
    err = 0.0
    for dt in (bf, f32):
        q = _rand(g, (4, 32, 128), dt)
        pk, pv = _rand(g, (40, 128, 8, 128), dt), _rand(g, (40, 128, 8, 128), dt)
        out = kops.paged_decode_attention(q, pk, pv, tables, cur)
        want = ref.paged_decode_attention_ref(q, pk, pv, tables, cur)
        contiguous = kops.decode_attention_op(
            q, pk[safe].reshape(4, -1, 8, 128),
            pv[safe].reshape(4, -1, 8, 128), cur)
        split, _ = kops.decode_split(16 * 128, 4, 8, 128)
        for label, w in (("plain", want), ("plain split-and-merge",
                         ref.paged_decode_attention_split_ref(
                             q, pk, pv, tables, cur, split))):
            e, good = max_err(out, w), close(out, w, TOL[dt])
            note = f"max_abs_err {e:.3g} (tol {TOL[dt]})"
            if dt == bf:
                share = bf16_bound_share(out, w)
                good &= share <= 1
                note += f"; {share:.3g} of the 2e-5 + 2 bf16 steps bound"
                if label == "plain":
                    err = e
            ok &= good
            log(f"[parity] paged {'bf16' if dt == bf else 'f32'} B=4 "
                f"cur={DECODE_CUR} interleaved pages vs {label}: {note} "
                f"{'ok' if good else 'FAIL'}")
        same = bool(torch.equal(out, contiguous))
        ok &= same
        log(f"[parity] paged {'bf16' if dt == bf else 'f32'}: bit-equal to "
            f"the contiguous decode kernel on the gathered KV: {same}")
    clean = kops.paged_decode_attention(q, pk, pv, tables, cur)
    used = set(tables[tables >= 0].tolist())
    foreign = [i for i in range(pk.shape[0]) if i not in used]
    pk[foreign] = float("nan")
    pv[foreign] = float("nan")
    dirty = kops.paged_decode_attention(q, pk, pv, tables, cur)
    good = bool(torch.equal(clean, dirty))
    ok &= good
    log(f"[parity] paged NaN-poisoned foreign pages ({len(foreign)}): "
        f"{'ok' if good else 'FAIL'}")
    check(ok, "paged kernel parity failed")

    sets, sdpa = [], []
    mask = (torch.arange(16 * 128, device=dev)[None, :] <= cur[:, None])
    tables32, cur32 = tables.to(torch.int32), i32(DECODE_CUR)
    for _ in range(n_copies(2 * 40 * 128 * 8 * 128 * 2)):
        q = _rand(g, (4, 32, 128), bf)
        pk, pv = _rand(g, (40, 128, 8, 128), bf), _rand(g, (40, 128, 8, 128), bf)
        sets.append((q, pk, pv, tables32, cur32))
        sdpa.append((q[:, :, None],
                     pk[safe].reshape(4, -1, 8, 128).transpose(1, 2),
                     pv[safe].reshape(4, -1, 8, 128).transpose(1, 2),
                     mask[:, None, None]))
    gathered = sdpa[0][1].transpose(1, 2)
    log(f"[time] paged_decode_attention device us per call by kernel "
        f"(torch.profiler): "
        f"{device_us_by_kernel(kops.paged_decode_attention, sets)}")
    return err, timed_row(
        kops.paged_decode_attention, ref.paged_decode_attention_ref, sets,
        lambda q, k, v, m: F.scaled_dot_product_attention(
            q, k, v, attn_mask=m, enable_gqa=True), sdpa,
        bound=decode_bound(sets[0][0], gathered, DECODE_CUR, 0),
        shape="B=4 Hq=32 Hkv=8 D=128 bf16, 128-token pages interleaved, "
              "cur_lens 0/700/1500/2047")


def _wkv_inputs(g, B, S, H, K, model_decay=False, s0_zero=False):
    """r, k, v ~ N(0, 1); w in (0, 1): the reference test's
    exp(-exp(N(-1, 0.5))), or with `model_decay` RWKV-6's initial w0
    (-6 .. -1 across channels) plus N(0, 0.5); u ~ N(0, 1); s0 ~ N(0, 1)
    or zero."""
    r, k, v, z = (_rand(g, (B, S, H, K), torch.float32) for _ in range(4))
    if model_decay:
        w0 = -6.0 + 5.0 * torch.arange(H * K, device="cuda").reshape(H, K) \
            / (H * K - 1)
        w = torch.exp(-torch.exp(w0 + 0.5 * z))
    else:
        w = torch.exp(-torch.exp(0.5 * z - 1))
    u = _rand(g, (H, K), torch.float32)
    s0 = torch.zeros(B, H, K, K, device="cuda") if s0_zero \
        else _rand(g, (B, H, K, K), torch.float32)
    return r, k, v, w, u, s0


def parity_wkv6(g):
    """The WKV6 kernel against the plain chunked version beside it and the
    sequential oracle, f32 at 2e-4: the reference's sweep, the state-carry
    composition, RWKV-6 3B heads (H=40, K=64) with model-like decays: a
    1024-token prompt from a zero state, a convertible chunk of 256 from a
    carried state, a ragged 8-token tail, a 4096-token prompt from a
    carried state.  Over 4096 tokens the f32 sequential oracle itself
    drifts to about the 2e-4 bound from its float64 result (0.89-1.11 of
    it on the CPU at this shape, where the chunked forms stay within
    0.27-0.34), so that case runs the oracle in float64.  Then its times."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    ok, worst = True, 0.0

    def judge(label, args, chunk=16, oracle_dtype=torch.float32):
        nonlocal ok, worst
        y, sT = kops.wkv6_op(*args, chunk=chunk)
        r, k, v, w, u, s0 = (t.to(oracle_dtype) for t in args)
        oy, osT = ref.wkv6_ref(*(t.transpose(1, 2) for t in (r, k, v, w)),
                               u, s0)
        wants = (ref.wkv6_chunked(*args, chunk=chunk),
                 (oy.transpose(1, 2), osT))
        good = True
        for want_y, want_s in wants:
            good &= close(y, want_y, WKV_TOL) and close(sT, want_s, WKV_TOL)
        e = max(max_err(y, wants[0][0]), max_err(sT, wants[0][1]))
        worst = max(worst, e)
        ok &= good
        share = max(bound_share(y, wants[1][0], WKV_TOL),
                    bound_share(sT, osT, WKV_TOL))
        log(f"[parity] wkv6 {label}: max_abs_err {e:.3g} vs the plain "
            f"chunked version, {max(max_err(y, oy.transpose(1, 2)), max_err(sT, osT)):.3g} "
            f"vs the oracle ({str(oracle_dtype)[6:]}; {share:.3g} of its "
            f"{WKV_TOL} + {WKV_TOL} |b| bound) {'ok' if good else 'FAIL'}")
        return y, sT

    for B, S, H, K, chunk in WKV_SWEEP:
        judge(f"B={B} S={S} H={H} K={K} chunk={chunk}",
              _wkv_inputs(g, B, S, H, K), chunk)
    r, k, v, w, u, s0 = _wkv_inputs(g, 1, 40, 2, 64)
    y_full, sT_full = kops.wkv6_op(r, k, v, w, u, s0)
    y1, s_mid = kops.wkv6_op(*(t[:, :24].contiguous() for t in (r, k, v, w)),
                             u, s0)
    y2, sT = kops.wkv6_op(*(t[:, 24:].contiguous() for t in (r, k, v, w)), u,
                          s_mid)
    good = close(torch.cat([y1, y2], 1), y_full, WKV_TOL) \
        and close(sT, sT_full, WKV_TOL)
    ok &= good
    log(f"[parity] wkv6 state carry (24 + 16 tokens == 40): "
        f"{'ok' if good else 'FAIL'}")
    for label, S, s0_zero in (("prompt S=1024 from s0=0", 1024, True),
                              ("convertible chunk S=256 from a carried s0",
                               256, False),
                              ("ragged tail S=8", 8, False),
                              ("long prompt S=4096 from a carried s0", 4096,
                               False)):
        seg, nseg = kops.wkv6_segment(S, 1, 40, 16)
        args = _wkv_inputs(g, 1, S, 40, 64, model_decay=True, s0_zero=s0_zero)
        y, sT = judge(f"H=40 K=64 model-like decays, {label} ({nseg} "
                      f"segments of {seg})", args,
                      oracle_dtype=torch.float64 if S > 1024
                      else torch.float32)
        y2, sT2 = kops.wkv6_op(*args)
        same = bool(torch.equal(y, y2) and torch.equal(sT, sT2))
        ok &= same
        log(f"[parity] wkv6 {label}: two calls bit-equal: {same}")
    check(ok, "wkv6 kernel parity failed")

    sets = [_wkv_inputs(g, 1, 1024, 40, 64, model_decay=True, s0_zero=True)
            for _ in range(n_copies(5 * 1024 * 40 * 64 * 4))]
    log(f"[time] wkv6 device us per call by kernel (torch.profiler), "
        f"S=1024: {device_us_by_kernel(kops.wkv6_op, sets)}")
    csets = [_wkv_inputs(g, 1, 256, 40, 64, model_decay=True)
             for _ in range(n_copies(5 * 256 * 40 * 64 * 4))]
    r = timed_row(kops.wkv6_op, ref.wkv6_chunked, csets,
                  bound=wkv6_bound(1, 256, 40, 64, 16))
    log(f"[time] wkv6 kernel, convertible chunk S=256 from a carried s0: "
        f"{r['ms']:.4f} ms (graph; eager {r['eager_ms']:.4f} ms, host "
        f"{r['host_us']:.1f} us/call); bound {r['bound'][0]:.4f} ms "
        f"({r['bound'][1]}), {r['bound'][0] / r['ms']:.3f} of it; plain "
        f"{r['plain_ms']:.4f} ms (eager)")
    return worst, timed_row(           # no single torch call computes WKV6
        kops.wkv6_op, ref.wkv6_chunked, sets,
        bound=wkv6_bound(1, 1024, 40, 64, 16),
        shape="B=1 S=1024 H=40 K=64 f32, chunk 16")


def drive_pd(cfg, model, tag, max_len=2048, long_pd=(), long_direct=(),
             max_instances=8):
    """The main path's traffic, as a user sends it: PDCluster (1 prefiller,
    1 decoder, 1 convertible; 4 slots, `max_len`, chunk 256; the Scaler
    boots at most `max_instances` of a kind) takes a trickle of 8 requests
    of 64-768 tokens, then a burst of 4 of 1024-1536, 32 new tokens each,
    with the burst a request of each (lo, hi) prompt-length range in
    `long_pd`; then a convertible Engine takes 2 prompts of 600-1100 and
    one of each range in `long_direct`.  The long prompts are drawn from a
    second seed, so the other requests are the same with and without them.
    The kernels' counters are zeroed just before and read just after.
    Returns the run's figures; prints them under `tag`."""
    from repro_torch.core import CHIPS, InstanceSpec, TokenScalePolicy, profile
    from repro_torch.kernels import ops as kops
    from repro_torch.serving import Engine, PDCluster, Request

    rng, rng_long = np.random.RandomState(0), np.random.RandomState(1)
    new = 32

    def req(rid, lo, hi, r=rng):
        L = int(r.randint(lo, hi + 1))
        return Request(rid=rid, prompt=r.randint(
            0, cfg.vocab_size, size=(L,)).astype(np.int32),
            max_new_tokens=new)

    def steps(engines):             # (mixed, decode) steps and their walls
        return np.array([(e.mixed_steps, e.decode_steps, e.mixed_wall_s,
                          e.decode_wall_s) for e in engines]).sum(0)

    torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()
    # ---- the main path: counters run from here ...
    t0 = time.perf_counter()
    pol = TokenScalePolicy(profile(cfg, InstanceSpec(CHIPS["h100"], 1)),
                           convertible=1)
    cl = PDCluster(cfg, model, pol, n_prefillers=1, n_decoders=1,
                   n_convertible=1, slots_per_decoder=4, max_len=max_len,
                   chunk_size=256, max_instances=max_instances)
    transfers = []
    record = cl.transfers.record

    def record_each(nbytes, tokens, wall_s):
        transfers.append((nbytes, tokens))
        record(nbytes, tokens, wall_s)
    cl.transfers.record = record_each
    reqs = []
    for i in range(8):                               # a trickle ...
        reqs.append(req(i, 64, 768))
        cl.submit(reqs[-1])
        for _ in range(3):
            cl.step()
    for i in range(8, 12):                           # ... then a burst
        reqs.append(req(i, 1024, 1536))
        cl.submit(reqs[-1])
    for i, (lo, hi) in enumerate(long_pd):
        reqs.append(req(12 + i, lo, hi, rng_long))
        cl.submit(reqs[-1])
    cl.run_until_drained(max_steps=5000)
    torch.cuda.synchronize()
    pd_s = time.perf_counter() - t0
    counts = steps(d.eng for d in cl.decoders + cl.convertibles)
    shape = (f"{len(cl.prefillers)} prefillers, {len(cl.decoders)} decoders, "
             f"{len(cl.convertibles)} convertible at the end")
    pre_tok = sum(p.tokens_done for p in cl.prefillers)
    pre_s = sum(p.wall_s for p in cl.prefillers)
    del cl                          # its caches, before the Engine's
    eng = Engine(cfg, model, num_slots=4, max_len=max_len, chunk_size=256)
    direct = [req(100 + i, 600, 1100) for i in range(2)]
    direct += [req(102 + i, lo, hi, rng_long)
               for i, (lo, hi) in enumerate(long_direct)]
    for r in direct:
        eng.add_request(r)
    eng.run_until_drained()
    torch.cuda.synchronize()
    launches = dict(kops.LAUNCHES)
    # ... to here
    mixed, dec, mixed_s, dec_s = counts + steps([eng])
    run = dict(
        launches=launches, reqs=reqs, direct=direct, transfers=transfers,
        max_len=max_len,
        done=sum(len(r.output) == new for r in reqs + direct),
        n=len(reqs) + len(direct), mixed=int(mixed), dec_steps=int(dec))
    dec_ms = 1e3 * dec_s / max(dec, 1)
    mix_ms = 1e3 * mixed_s / max(mixed, 1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{tag}] requests completed {run['done']}/{run['n']} "
        f"(PD cluster {pd_s:.1f} s, {shape}); prompt lengths "
        f"{[len(r.prompt) for r in reqs]} (PD), "
        f"{[len(r.prompt) for r in direct]} (convertible Engine)")
    log(f"[{tag}] prefiller: {pre_tok} tokens in {pre_s:.3f} s = "
        f"{pre_tok / max(pre_s, 1e-9):.0f} tok/s")
    log(f"[{tag}] decode steps {run['dec_steps']}, mean {dec_ms:.2f} ms; "
        f"mixed steps {run['mixed']}, mean {mix_ms:.2f} ms")
    log(f"[{tag}] kernel launches {launches}; peak device memory "
        f"{peak:.2f} GiB")
    return run


def last_logits(cfg, model, prompt, max_len, plain=False, image=None):
    """One prompt's last-token logits, through the kernels or through their
    plain versions; `image` (num_vision_tokens, d_model) for a vision
    model."""
    from repro_torch.models import init_state, prefill
    toks = np.zeros((1, min(1 << (len(prompt) - 1).bit_length(), max_len)),
                    np.int32)
    toks[0, :len(prompt)] = prompt
    out, _ = prefill(cfg, model, init_state(cfg, 1, max_len, "cuda"), toks,
                     [len(prompt)], None if image is None else image[None],
                     plain_kernels=plain)
    return out


def image(cfg, seed):
    """A (num_vision_tokens, d_model) image embedding in cfg.dtype, normal
    from `seed`, made on the card (the stubbed vision frontend's output),
    or None for a text model."""
    if not cfg.num_vision_tokens:
        return None
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(cfg.num_vision_tokens, cfg.d_model, generator=g,
                       device="cuda").to(getattr(torch, cfg.dtype))


def compare_logits(a, b, tag, what):
    """Largest |a - b| as a share of the largest |b|; logs it with both
    argmaxes.  Returns (share, same argmax, finite)."""
    diff = (a - b).abs().max().item()
    scale = b.abs().max().item()
    share = diff / max(scale, 1e-30)
    log(f"[{tag}] last-token logits, {what}: max abs diff {diff:.4g} of max "
        f"|logit| {scale:.4g} ({share:.3g}); argmax {int(a.argmax())} vs "
        f"{int(b.argmax())}")
    return share, int(a.argmax()) == int(b.argmax()), \
        bool(torch.isfinite(a).all())


def phase_serve():
    cfg, model = full_model("llama31_8b", "serve")
    run = drive_pd(cfg, model, "serve")
    launches = {n: run["launches"][n]
                for n in ("chunked_prefill_attention", "decode_attention")}
    bytes_ok = payloads_ok(run, "serve", PAYLOAD_LLAMA)
    check(run["done"] == run["n"], "not every request completed")
    check(run["mixed"] > 0, "no mixed (convertible) step ran")
    check(all(n > 0 for n in launches.values()), f"launches {launches}")
    check(bytes_ok, "KV payload sizes")
    profile_decode(cfg, model)
    profile_prefill(cfg, model)
    p, L = run["reqs"][3].prompt, run["max_len"]
    share, _, finite = compare_logits(
        last_logits(cfg, model, p, L), last_logits(cfg, model, p, L, True),
        "serve", f"kernels vs plain attention (L={len(p)})")
    check(finite and share <= 0.05, "kernel and plain logits disagree")
    return launches


def phase_paged():
    """The paged pool's path, through its API: a PagedKV of Llama-3.1-8B's
    32 layers of KV heads (bf16, 128-token pages); four requests of
    1/701/1501/2048 tokens take pages in turn (so none is contiguous), are
    written, and every layer's new token attends its pages through the
    paged kernel.  The counter is zeroed just before and read just after;
    each layer's result is then held against the contiguous decode kernel
    on the same KV gathered, and the pages are released."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.serving.paged import PagedKV

    cfg = get_config("llama31_8b")
    g = torch.Generator(device="cuda").manual_seed(3)
    nL, Hkv, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    lens = [c + 1 for c in DECODE_CUR]
    kv = PagedKV(nL, num_blocks=48, num_slots=4, max_blocks_per_slot=16,
                 n_kv_heads=Hkv, head_dim=D, dtype=torch.bfloat16,
                 device="cuda")
    new_k = [_rand(g, (nL, n, Hkv, D), torch.bfloat16) for n in lens]
    new_v = [_rand(g, (nL, n, Hkv, D), torch.bfloat16) for n in lens]
    q = _rand(g, (nL, 4, cfg.num_heads, D), torch.bfloat16)
    cur = torch.tensor(DECODE_CUR, device="cuda")
    kops.reset_launches()
    # ---- the paged path: its counter runs from here ...
    t0 = time.perf_counter()
    for i in range(1, 17):                    # one page per request in turn
        for slot, n in enumerate(lens):
            kv.ensure_capacity(slot, rid=slot, n_tokens=min(n, 128 * i))
    for slot in range(4):
        kv.write_tokens(slot, new_k[slot], new_v[slot], start=0)
    tables = torch.as_tensor(kv.tables, device="cuda")
    outs = [kops.paged_decode_attention(q[l], kv.pool_k[l], kv.pool_v[l],
                                        tables, cur) for l in range(nL)]
    torch.cuda.synchronize()
    launches = kops.LAUNCHES["paged_decode_attention"]
    # ... to here
    path_ms = 1e3 * (time.perf_counter() - t0)
    safe = tables.clamp(min=0).long()
    worst, share, equal = 0.0, 0.0, True
    for l, out in enumerate(outs):
        want = kops.decode_attention_op(
            q[l], kv.pool_k[l][safe].reshape(4, -1, Hkv, D),
            kv.pool_v[l][safe].reshape(4, -1, Hkv, D), cur)
        worst = max(worst, max_err(out, want))
        share = max(share, bf16_bound_share(out, want))
        equal &= bool(torch.equal(out, want))
    scattered = all(not (np.diff(t[t >= 0]) == 1).all()
                    for t in kv.tables if (t >= 0).sum() > 1)
    log(f"[paged] {kv.alloc.num_blocks - kv.alloc.n_free} pages of "
        f"{kv.alloc.num_blocks} for lengths {lens}; no multi-page request's "
        f"pages contiguous: {scattered}")
    log(f"[paged] {nL} layers through the paged kernel in {path_ms:.1f} ms "
        f"(allocation and writes included), launches {launches}; vs the "
        f"contiguous decode kernel: max_abs_err {worst:.3g} (tol "
        f"{TOL[torch.bfloat16]}), {share:.3g} of the 2e-5 + 2 bf16 steps "
        f"bound; bit-equal: {equal}")
    for slot in range(4):
        kv.release(slot, rid=slot)
    check(scattered, "the allocator gave a request contiguous pages")
    check(launches == nL, f"paged launches {launches}")
    check(worst <= TOL[torch.bfloat16] and share <= 1 and equal,
          "paged path disagrees with the contiguous decode kernel")
    check(kv.alloc.n_free == kv.alloc.num_blocks, "pages not released")
    return launches


def phase_rwkv():
    """RWKV-6 3B at its published widths and depth, bf16, from seed 0, on
    the main path's PD traffic.  Every transfer must carry the whole
    recurrent state (21,299,200 B) whatever the prompt's length."""
    cfg, model = full_model("rwkv6_3b", "rwkv")
    run = drive_pd(cfg, model, "rwkv")
    sent = [b for b, _ in run["transfers"]]
    lens = sorted(L for _, L in run["transfers"])
    log(f"[rwkv] state transfers {len(sent)} for prompts of {lens[0]}.."
        f"{lens[-1]} tokens, {sum(sent)} bytes; each {PAYLOAD_RWKV} B: "
        f"{all(b == PAYLOAD_RWKV for b in sent)} (a Llama-3.1-8B prompt of "
        f"1024 tokens ships {PAYLOAD_LLAMA * 1024} B)")
    check(run["done"] == run["n"], "rwkv: not every request completed")
    check(run["mixed"] > 0, "rwkv: no mixed (convertible) step ran")
    check(run["launches"]["wkv6"] > 0, f"rwkv launches {run['launches']}")
    check(len(sent) > 0 and all(b == PAYLOAD_RWKV for b in sent),
          "rwkv payload sizes")
    profile_decode(cfg, model)
    profile_prefill(cfg, model)
    check_logits(cfg, model, run["reqs"][3].prompt, run["max_len"], "rwkv",
                 "WKV6 kernel", ("rwkv_wkv_chunked",
                                 lambda f: partial(f, chunk=8)),
                 "in chunks of 8 vs of 16")
    return run["launches"]["wkv6"]


def phase_gemma():
    """Gemma-2-9B at its published widths and depth (42 layers alternating
    a 4096-token window and global attention, softcaps 50 / 30, D = 256),
    bf16 from seed 0, on the main path's PD traffic plus one prompt of
    4400-4800 tokens (max_len 5120; the Scaler boots at most 3 instances of
    a kind, which bounds the caches at 7 GB a decoder), then a convertible
    Engine with one prompt of 4300-4700 beside two of 600-1100, so that
    chunks past position 4096 meet the window.  Every transfer must be
    344,064 B per 128-rounded token.  The long PD prompt's last-token logits
    through the kernels are held against the plain versions as RWKV-6's are
    (check_logits): in bf16 this random-weight model turns the last bits of
    any two roundings into different logits (the plain path against itself
    with P in f32 shows it), so phase 3's bf16 rule cannot hold; in f32 the
    kernels agree within 1e-3."""
    cfg, model = full_model("gemma2_9b", "gemma")
    run = drive_pd(cfg, model, "gemma", max_len=5120,
                   long_pd=[(4400, 4800)], long_direct=[(4300, 4700)],
                   max_instances=3)
    launches = {n: run["launches"][n]
                for n in ("chunked_prefill_attention", "decode_attention")}
    bytes_ok = payloads_ok(run, "gemma", PAYLOAD_GEMMA)
    long_ok = [len(r.output) == 32 for r in (run["reqs"][-1],
                                             run["direct"][-1])]
    log(f"[gemma] the prompts past the window ({len(run['reqs'][-1].prompt)} "
        f"PD, {len(run['direct'][-1].prompt)} convertible) completed: "
        f"{long_ok}")
    check(run["done"] == run["n"] and all(long_ok),
          "gemma: not every request completed")
    check(run["mixed"] > 0, "gemma: no mixed (convertible) step ran")
    check(all(n > 0 for n in launches.values()), f"gemma launches {launches}")
    check(bytes_ok, "gemma payload sizes")
    profile_decode(cfg, model)
    profile_prefill(cfg, model)
    check_logits(cfg, model, run["reqs"][-1].prompt, run["max_len"], "gemma",
                 "attention kernels, past the window",
                 SDPA_F32_P, "with P and P.V in f32 vs P in bf16",
                 bf16="finite")
    return launches


def check_logits(cfg, model, prompt, max_len, tag, kernel, swap, swap_what,
                 bf16="argmax", f32_layers=0, img=None):
    """One prompt's last-token logits through the kernels and through their
    plain versions.  In bf16 the two differ where f32 results round to
    different bf16 values, and many layers amplify that; the plain path's
    own sensitivity is shown by running it with `swap` = (attribute of
    models.ops, a function of the original giving its stand-in): the same
    function in another rounding, `swap_what`.  What bf16 must show:
    "finite"; "argmax", finite with the same argmax; "rule", phase 3's
    rule (within 0.05 of the largest |logit|, the same argmax) or, where
    the plain path against itself is outside that rule too (so no two
    roundings of this model meet it), finite.  Then the same model
    converted in place to f32 (same weights, full width; with `f32_layers`
    cut to its first f32_layers layers first, for a model whose f32 copy
    does not fit the card), where the kernels must agree within 1e-3 of the
    largest |logit| with the same argmax.  `img` is a vision model's
    image."""
    from repro_torch.models import ops as mops
    what = f"L={len(prompt)}"
    kern = last_logits(cfg, model, prompt, max_len, image=img)
    plain = last_logits(cfg, model, prompt, max_len, plain=True, image=img)
    share, same, finite = compare_logits(
        kern, plain, tag, f"{cfg.dtype}, {kernel} vs plain ({what})")
    attr, stand_in = swap
    orig = getattr(mops, attr)
    setattr(mops, attr, stand_in(orig))
    try:
        alt = last_logits(cfg, model, prompt, max_len, plain=True, image=img)
    finally:
        setattr(mops, attr, orig)
    alt_share, _, _ = compare_logits(
        alt, plain, tag, f"{cfg.dtype}, plain {swap_what} ({what})")
    rule = share <= 0.05 and same
    if bf16 == "rule":
        log(f"[{tag}] bf16: phase 3's rule (0.05, same argmax) "
            f"{'holds' if rule else 'fails'} for the kernels; the plain path "
            f"against itself is {'outside' if alt_share > 0.05 else 'within'}"
            f" it")
    held = {"finite": finite, "argmax": finite and same,
            "rule": finite and (rule or alt_share > 0.05)}[bf16]
    check(held, f"{tag}: bf16 kernel and plain logits disagree")
    if f32_layers:
        n = len(model.layers)
        model.layers = model.layers[:f32_layers]
        cfg = cfg.replace(num_layers=f32_layers)
        torch.cuda.empty_cache()
        log(f"[{tag}] f32 check on the first {f32_layers} of {n} layers, at "
            f"full width (the whole model in f32 does not fit the card)")
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    model.float()
    img = None if img is None else img.float()
    share, same, finite = compare_logits(
        last_logits(cfg32, model, prompt, max_len, image=img),
        last_logits(cfg32, model, prompt, max_len, plain=True, image=img),
        tag, f"f32 weights and activations, {kernel} vs plain ({what})")
    check(finite and same and share <= 1e-3,
          f"{tag}: f32 kernel and plain logits disagree")


def _device_by_kind(prof):
    """Device microseconds of the profiled events by kind, the number of
    device events and of attention kernels among them."""
    kinds = {"attention": 0.0, "wkv6": 0.0, "matmul": 0.0, "other": 0.0}
    n = n_attn = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.lower()
        us = e.time_range.elapsed_us()
        n += 1
        if any(w in name for w in ("decode_split_kernel", "prefill_",
                                   "decode_combine_kernel")):
            kinds["attention"] += us
            n_attn += 1
        elif "wkv6_" in name:
            kinds["wkv6"] += us
        elif any(w in name for w in ("gemm", "gemv", "xmma", "nvjet",
                                     "cutlass", "matmul")):
            kinds["matmul"] += us
        else:
            kinds["other"] += us
    return kinds, n, n_attn


def profile_decode(cfg, model, ctx=1024, steps=8):
    """Where one decode step's time goes: 4 slots at ~`ctx` tokens of
    context, `steps` decode steps under torch.profiler; kernel time by kind
    and the device's idle share of the host's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Engine, Request
    rng = np.random.RandomState(1)
    eng = Engine(cfg, model, num_slots=4, max_len=2048)
    for i in range(4):
        eng.add_request(Request(rid=i, prompt=rng.randint(
            0, cfg.vocab_size, size=(ctx,)).astype(np.int32),
            max_new_tokens=steps + 4, image_embeds=image(cfg, 100 + i)))
    eng.step()
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kinds, n, n_attn = _device_by_kind(prof)
    busy = sum(kinds.values())
    if n == 0:
        log("[profile] decode step breakdown: not measured (the profiler "
            "recorded no device events)")
        return
    per = {k: round(v / steps / 1e3, 3) for k, v in kinds.items()}
    log(f"[profile] {cfg.name} decode step at B=4, ctx~{ctx}: wall "
        f"{wall_us / steps / 1e3:.2f} ms/step; device ms/step by kind {per};"
        f" {n / steps:.0f} kernels/step ({n_attn / steps:.0f} attention); "
        f"device idle share {1 - busy / wall_us:.3f}")


def profile_prefill(cfg, model, length=1024):
    """Where one prompt's prefill time goes (the prefiller's work, TTFT):
    a `length`-token prompt through models.prefill under torch.profiler;
    kernel time by kind and the device's idle share of the host's wall."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import init_state, prefill
    toks = np.random.RandomState(2).randint(
        0, cfg.vocab_size, size=(1, length)).astype(np.int32)
    img = image(cfg, 200)
    img = None if img is None else img[None]
    prefill(cfg, model, init_state(cfg, 1, 2048, "cuda"), toks, [length],
            img)
    torch.cuda.synchronize()
    state = init_state(cfg, 1, 2048, "cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill(cfg, model, state, toks, [length], img)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kinds, n, _ = _device_by_kind(prof)
    if n == 0:
        log("[profile] prefill breakdown: not measured (the profiler "
            "recorded no device events)")
        return
    per = {k: round(v / 1e3, 3) for k, v in kinds.items()}
    log(f"[profile] {cfg.name} prefill of one {length}-token prompt: wall "
        f"{wall_us / 1e3:.2f} ms; device ms by kind {per}; {n} kernels; "
        f"device idle share {1 - sum(kinds.values()) / wall_us:.3f}")


def _same_as_greedy(cfg, model, reqs, new=6):
    """Whether each request's `new` tokens equal greedy_generate's on the
    card (with its image, for a vision model)."""
    from repro_torch.models import greedy_generate
    return [r.output == greedy_generate(
        cfg, model, r.prompt[None], [len(r.prompt)], new,
        None if r.image_embeds is None else r.image_embeds[None])[0].tolist()
        for r in reqs]


def phase_exact():
    """The f32 SMOKE configs served on the card give greedy_generate's
    tokens there: Llama, RWKV-6, Gemma-2 past its window and int8 Llama by
    PDCluster; DeepSeek-V2-Lite (MLA, MoE), Kimi K2 (MoE, GQA) and Jamba
    (Mamba, MoE; prompts past the 16-token chunk) by PDCluster and by a
    convertible Engine of 2 slots and 16-token chunks (chunks from carried
    latent and Mamba states, reused slots); Llama-3.2-Vision by an Engine
    with an image per request and the cross-attention gates at 1."""
    from repro_torch.configs import get_config
    from repro_torch.core import CHIPS, InstanceSpec, TokenScalePolicy, profile
    from repro_torch.models import init_params
    from repro_torch.serving import Engine, PDCluster, Request

    short = [7, 12, 5, 20, 9]
    for arch, over, lens, max_len, what in (
            ("llama31_8b", {}, short, 96, ""),
            ("rwkv6_3b", {}, short, 96, ""),
            ("gemma2_9b", {}, [70, 12, 90, 20, 9], 160,
             ", prompts past the 64-token window"),
            ("llama31_8b", {"kv_cache_dtype": "int8"}, short, 96,
             ", int8 KV cache"),
            ("deepseek_v2_lite_16b", {}, short, 96, ""),
            ("kimi_k2_1t_a32b", {}, short, 96, ""),
            ("jamba_v0_1_52b", {}, [40, 12, 5, 33, 20], 96,
             ", prompts past the 16-token chunk"),
            ("llama_3_2_vision_11b", {}, short, 96, ", an image each")):
        cfg = get_config(arch, smoke=True).replace(**over)
        model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
        rng = np.random.RandomState(0)
        prompts = [rng.randint(0, cfg.vocab_size, size=(L,)).astype(np.int32)
                   for L in lens]

        def requests():
            return [Request(rid=i, prompt=p, max_new_tokens=6,
                            image_embeds=image(cfg, 300 + i))
                    for i, p in enumerate(prompts)]
        if cfg.num_vision_tokens:
            open_cross_gates(model)
            eng = Engine(cfg, model, num_slots=2, max_len=max_len)
            reqs = requests()
            for r in reqs:
                eng.add_request(r)
            eng.run_until_drained()
            same = _same_as_greedy(cfg, model, reqs)
            log(f"[exact] {cfg.name}{what} f32 Engine tokens equal "
                f"greedy_generate on the card: {same}")
            check(all(same), f"exact tokens ({arch}{what})")
            continue
        prof = profile(get_config(arch), InstanceSpec(CHIPS["h100"], 1))
        cl = PDCluster(cfg, model, TokenScalePolicy(prof, convertible=1),
                       n_prefillers=1, n_decoders=1, n_convertible=1,
                       max_len=max_len)
        reqs = requests()
        for r in reqs:
            cl.submit(r)
        cl.run_until_drained()
        same = _same_as_greedy(cfg, model, reqs)
        log(f"[exact] {cfg.name}{what} f32 PD tokens equal greedy_generate "
            f"on the card: {same}; transfers {cl.transfers.n_transfers}")
        check(all(same) and cl.transfers.n_transfers > 0,
              f"exact tokens ({arch}{what})")
        if cfg.moe or cfg.mamba:
            eng = Engine(cfg, model, num_slots=2, max_len=max_len,
                         chunk_size=16)
            reqs = requests()
            for r in reqs:
                eng.add_request(r)
            eng.run_until_drained()
            same = _same_as_greedy(cfg, model, reqs)
            log(f"[exact] {cfg.name}{what} f32 convertible Engine tokens "
                f"equal greedy_generate on the card: {same}; mixed steps "
                f"{eng.mixed_steps}")
            check(all(same) and eng.mixed_steps > 0,
                  f"exact tokens, convertible ({arch}{what})")


def full_model(arch, tag):
    """The config at its published widths and depth, with random bf16
    weights from seed 0 made on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import count_params, init_params
    cfg = get_config(arch)
    t = time.perf_counter()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    torch.cuda.synchronize()
    heads = (f"{cfg.d_model // cfg.rwkv_head_dim} WKV heads"
             if cfg.layer_specs[0].mixer == "rwkv" else
             f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim_}")
    if cfg.sliding_window:
        heads += f", window {cfg.sliding_window} on its local layers"
    log(f"[{tag}] {cfg.name}: {count_params(model) / 1e9:.2f}B params "
        f"({cfg.num_layers}L d={cfg.d_model}, {heads}) made on the card in "
        f"{time.perf_counter() - t:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    if cfg.num_vision_tokens:           # tanh(0) would silence the images
        open_cross_gates(model)
    return cfg, model


def open_cross_gates(model):
    """Set every cross-attention gate to 1: the reference initialises them
    to 0, and tanh(0) silences the image."""
    with torch.no_grad():
        for layer in model.layers:
            if layer.spec.mixer == "cross_attn":
                layer.gate.fill_(1.0)


def payloads_ok(run, tag, per_token):
    """Every transfer of the run is `per_token` B per 128-rounded token."""
    want = [per_token * min(max(-(-L // 128) * 128, 8), run["max_len"])
            for _, L in run["transfers"]]
    sent = [b for b, _ in run["transfers"]]
    ok = len(sent) > 0 and sent == want
    log(f"[{tag}] transfers {len(sent)}, {sum(sent)} bytes, for prompts of "
        f"{sorted(L for _, L in run['transfers'])} tokens; each {per_token} "
        f"B x rounded length: {ok}")
    return ok


SDPA_F32_P = ("_sdpa", lambda f: lambda q, k, v, mask, scale, cap=0.0:
              f(q, k, v.float(), mask, scale, cap).to(q.dtype))


def phase_qwen():
    """Qwen-2.5-32B, the paper's large evaluation model, at its published
    widths and depth (64 layers, 40/8 heads of 128, QKV bias; 32.76 B
    parameters, 61 GiB in bf16, seed 0) on the main path's PD traffic
    (max_len 2048; the Scaler boots at most 2 instances of a kind, so the
    caches stay near 6.4 GB beside the weights).  Every transfer must be
    262,144 B per 128-rounded token, and both attention kernels launch.
    Logits (request 3's prompt): phase 3's bf16 rule, or the plain path's
    own spread beside it; then f32 on the first 12 layers at full width
    (the whole model in f32, 131 GB, does not fit the card)."""
    cfg, model = full_model("qwen25_32b", "qwen")
    run = drive_pd(cfg, model, "qwen", max_instances=2)
    launches = {n: run["launches"][n]
                for n in ("chunked_prefill_attention", "decode_attention")}
    bytes_ok = payloads_ok(run, "qwen", PAYLOAD_QWEN)
    check(run["done"] == run["n"], "qwen: not every request completed")
    check(run["mixed"] > 0, "qwen: no mixed (convertible) step ran")
    check(all(n > 0 for n in launches.values()), f"qwen launches {launches}")
    check(bytes_ok, "qwen payload sizes")
    profile_decode(cfg, model)
    profile_prefill(cfg, model)
    check_logits(cfg, model, run["reqs"][3].prompt, run["max_len"], "qwen",
                 "attention kernels", SDPA_F32_P,
                 "with P and P.V in f32 vs P in bf16", bf16="rule",
                 f32_layers=QWEN_F32_LAYERS)
    log(f"[qwen] peak device memory over the phase "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def phase_deepseek():
    """DeepSeek-V2-Lite at its published widths and depth (27 layers of
    MLA, the first with a dense FFN, the rest 64 routed experts top-6 + 2
    shared; 15.71 B parameters, bf16, seed 0) on the main path's PD
    traffic.  Every transfer must be the latent cache, 31,104 B per
    128-rounded token; the attention kernels' counters must read 0 (MLA
    takes no kernel path, as in the reference).  So the kernels-vs-plain
    logits are one computation, held by phase 3's rule."""
    cfg, model = full_model("deepseek_v2_lite_16b", "deepseek")
    run = drive_pd(cfg, model, "deepseek")
    attn = {n: run["launches"][n]
            for n in ("chunked_prefill_attention", "decode_attention")}
    bytes_ok = payloads_ok(run, "deepseek", PAYLOAD_DEEPSEEK)
    check(run["done"] == run["n"], "deepseek: not every request completed")
    check(run["mixed"] > 0, "deepseek: no mixed (convertible) step ran")
    check(all(n == 0 for n in attn.values()),
          f"deepseek: attention kernels launched under MLA: {attn}")
    check(bytes_ok, "deepseek payload sizes")
    profile_decode(cfg, model)
    profile_prefill(cfg, model)
    p, L = run["reqs"][3].prompt, run["max_len"]
    share, same, finite = compare_logits(
        last_logits(cfg, model, p, L), last_logits(cfg, model, p, L, True),
        "deepseek", f"bf16, kernels vs plain (L={len(p)}; no kernel on "
        "this path)")
    check(finite and same and share <= 0.05,
          "deepseek: kernel and plain logits disagree")
    return attn


def phase_vision():
    """Llama-3.2-Vision 11B at its published widths and depth (32
    self-attention and 8 cross-attention layers, 9.78 B parameters, bf16,
    seed 0; the cross-attention gates set to 1 after init, since tanh(0)
    silences them) served by an Engine of 4 slots, max_len 2048 and no
    chunking (the reference's chunked step and prefiller pass no image):
    6 requests of 64-1024 prompt tokens, 32 new tokens each, each with its
    own (6400, 4096) image from a seed.  Both attention kernels must launch
    on the self-attention layers (counters read around exactly the
    Engine's run); one prompt's logits must change with the image; the
    kernels against the plain versions by check_logits (phase 3's rule or
    the plain path's own spread; the model in f32 within 1e-3)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.serving import Engine, Request
    cfg, model = full_model("llama_3_2_vision_11b", "vision")
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=rng.randint(
        0, cfg.vocab_size, size=(int(L),)).astype(np.int32),
        max_new_tokens=32, image_embeds=image(cfg, i))
        for i, L in enumerate(rng.randint(64, 1025, size=6))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()
    # ---- the vision path: counters run from here ...
    t0 = time.perf_counter()
    eng = Engine(cfg, model, num_slots=4, max_len=2048)
    for r in reqs:
        eng.add_request(r)
    eng.run_until_drained()
    torch.cuda.synchronize()
    launches = {n: kops.LAUNCHES[n]
                for n in ("chunked_prefill_attention", "decode_attention")}
    # ... to here
    wall = time.perf_counter() - t0
    done = sum(len(r.output) == 32 for r in reqs)
    log(f"[vision] requests completed {done}/{len(reqs)} in {wall:.1f} s; "
        f"prompt lengths {[len(r.prompt) for r in reqs]}; decode steps "
        f"{eng.decode_steps}, mean "
        f"{1e3 * eng.decode_wall_s / max(eng.decode_steps, 1):.2f} ms")
    log(f"[vision] kernel launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(done == len(reqs), "vision: not every request completed")
    check(all(n > 0 for n in launches.values()), f"vision launches {launches}")
    p = reqs[0].prompt
    share, _, finite = compare_logits(
        last_logits(cfg, model, p, 2048, image=reqs[1].image_embeds),
        last_logits(cfg, model, p, 2048, image=reqs[0].image_embeds),
        "vision", f"image 1 vs image 0 (L={len(p)})")
    check(finite and share > 1e-3, "vision: the logits ignore the image")
    profile_decode(cfg, model)
    profile_prefill(cfg, model)
    check_logits(cfg, model, p, 2048, "vision", "attention kernels",
                 SDPA_F32_P, "with P and P.V in f32 vs P in bf16",
                 bf16="rule", img=reqs[0].image_embeds)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()

    def timed(phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        torch.cuda.empty_cache()
        log(f"[phase] {phase.__name__[6:]}: {time.perf_counter() - t:.1f} s")
        return out

    timed(phase_build)
    errs, rows = timed(phase_parity)
    launches = timed(phase_serve)
    launches["paged_decode_attention"] = timed(phase_paged)
    launches["wkv6"] = timed(phase_rwkv)
    for name, n in timed(phase_gemma).items():
        launches[f"{name}_d256"] = n
    timed(phase_exact)
    for name, n in timed(phase_qwen).items():
        launches[f"{name}_qwen"] = n
    timed(phase_deepseek)
    timed(phase_vision)
    src = {"chunked_prefill_attention":
           ("src/repro_torch/kernels/csrc/chunked_prefill_attention.cu",
            "src/repro/kernels/chunked_prefill_attention.py:37"),
           "decode_attention":
           ("src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:30"),
           "paged_decode_attention":
           ("src/repro_torch/kernels/csrc/paged_decode_attention.cu",
            "src/repro/kernels/paged_decode_attention.py:77"),
           "wkv6":
           ("src/repro_torch/kernels/csrc/wkv6.cu",
            "src/repro/kernels/wkv6.py:32")}
    # the same two kernels' D = 256 instantiations, on Gemma-2-9B's path,
    # and at Qwen-2.5-32B's heads (G = 5), on its path
    for name in ("chunked_prefill_attention", "decode_attention"):
        src[f"{name}_d256"] = src[name]
        src[f"{name}_qwen"] = src[name]
    kernels = [dict(name=n, route="cuda", source=src[n][0],
                    replaces=src[n][1], launches=launches[n],
                    max_abs_err=errs[n], ms=rows[n]["ms"],
                    plain_ms=rows[n]["plain_ms"], bound_ms=rows[n]["bound"][0],
                    bound_by=rows[n]["bound"][1],
                    library_ms=rows[n]["library_ms"]) for n in src]
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
