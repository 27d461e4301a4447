#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA H100.

    python3 chip_smoke.py          # from the root of a checkout

Phases (any failure exits non-zero; nothing is skipped):
  1. build   — compile the four CUDA kernels from src/repro_torch/kernels/csrc
               (one nvcc each, in parallel) and print every instantiation's
               ptxas registers and spills (no decode and no bf16 prefill
               instantiation may spill; the bf16 prefill kernel's (wgmma
               + TMA, every head dim) registers on a line of their own;
               the eleven D = 112
               instantiations on a line of their own, none spilling); the
               bf16 decode kernel's blocks an SM by head dim
               from the card's occupancy calculator, held to the split
               rule's count (kernels/ops.decode_blocks_per_sm) at 64, 112,
               128 and 256
  2. parity  — each kernel against its plain PyTorch version on the card:
               attention at Llama-3.1-8B heads at the main-path shapes
               and at phase 11's (a chunk of the planned size into a
               4096-row cache, whole and partial, the last chunk at its
               offset, decode at B=4 L=4096) in
               bf16 (3e-2, and 2e-5 + 2 bf16 steps of the plain value) and
               f32 (2e-5), the split-KV decode kernel also against its plain
               split-and-merge version and bit-equal to itself, and in bf16
               (the tensor-core kernel) at every decode case below also
               against its own arithmetic, decode_attention_split_p_ref,
               under the same bounds; the decode kernel at G = 1, 2, 7, 12
               and 16 (MusicGen-large, Gemma-2-9B's global layers,
               Qwen2-0.5B, two n-tiles of heads at D = 128 and 256); the
               prefill sweep in bf16 (the wgmma path: 3e-2 and the
               bf16-steps bound) and the f32 sweeps (the CUDA-core path,
               2e-5), NaN in the decode kernel's dead region in both
               dtypes; the
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
               convertible chunk, and as rows of their own the burst prompt
               (1p) and phase 11's planned chunk into its cache (1c), each
               beside SDPA (bf16 prefill at every head dim is the wgmma +
               TMA kernel: at the main-path cases also against its own
               arithmetic and bit-equal to itself), WKV6 at a
               256-token chunk from a carried state, device time by kernel
               of the split-KV and the three WKV6 passes; then the three
               attention kernels at head dim 256 (Gemma-2-9B's heads with
               softcap 50, windows of 4096 that bite, Gemma-2B's MQA heads;
               paged bit-equal to contiguous) in bf16 and f32, the bf16
               prefill (wgmma + TMA) also against its own arithmetic and
               bit-equal to itself, and with NaN in the keys no row sees
               bit-equal to its output on clean keys, and their times at
               Gemma-2-9B's main shapes (the prefill's prompt, prompt past
               the window and chunk past it, three rows) beside SDPA at the
               same shape without softcap or window (a yardstick only), and the
               paged kernel's at D = 256 beside SDPA on the gathered KV;
               then the two attention kernels at Qwen-2.5-32B's heads (40
               over 8, G = 5) at the main path's shapes, bf16 and f32, and
               their times beside the bound, plain version and SDPA; then
               the bf16 prefill (wgmma + TMA) at D = 64 and 128 on
               Qwen2-0.5B's, MusicGen-large's, Qwen's, Llama's and MQA
               heads with windows, softcaps and ragged batches, bf16 and
               f32, in bf16 also against its own arithmetic, one launch a
               call, bit-equal to itself and with NaN in the keys no row
               sees bit-equal to its output on clean keys, and row 1h
               (Qwen2-0.5B's 14 / 2 heads at D = 64) timed beside the
               bound, plain version and SDPA; then
               the three attention kernels at Kimi K2's head dim 112 (64 /
               8 heads, G = 8) in bf16 and f32: prefill at a prompt, a
               chunk at an offset with window and softcap, a ragged batch
               and the burst prompt (bf16, the wgmma + TMA kernel with its
               rows padded to 128 columns, also against its own
               arithmetic), the B = 1 cases again with NaN in every key no
               row sees, bit-equal to the clean output; decode at the
               decode rows' lengths and with a window across split
               boundaries (also against the split-and-merge version and in
               bf16 the tensor-core kernel's arithmetic), paged bit-equal
               to contiguous, every call bit-equal to itself, and rows 1k
               (prefill B=1 Sq=512 Skv=2048), 1kp (the burst prompt, Sq =
               Skv = 2048, len 1500) and 2k (decode B=4 L=2048) timed
               beside the bound, plain version and SDPA; then
               the decode kernel's rank-slice entry (decode_attention_
               partial: one slice of a cache split over its positions,
               f32 o and lse) against its plain version at Llama-3.1-8B's,
               Gemma-2-9B's (D = 256, window 4096 starting mid-slice,
               softcap 50), Qwen-2.5-32B's and Kimi K2's (D = 112, a window
               starting mid-slice) heads, 4 slices, cur_len on a
               slice boundary and slices with no live key, bf16 and f32
               within 2e-5, bit-equal to itself, the slices merged against
               the one-pass plain decode; its time on a rank's slice of
               phase 15's cache beside the bound, the plain version and
               SDPA over the slice; then WKV6 on a rank's heads of
               RWKV-6 3B under TP over 4 (H = 10, B = 4, S = 1536 and
               two chunks from a carried state, f32, 2e-4 against the
               plain chunked version and the float64 oracle, bit-equal
               to itself) and its time at phase 16 (a)'s prefill
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
               DeepSeek-V2-Lite, Kimi K2, Kimi K2 at head dim 112 (d_model
               448 over 4 / 2 heads), Jamba with prompts past the
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
 11. control — the paper's control plane and both cluster simulators,
               copied into the port (numpy on the host; no JAX here):
               seven of the eight golden fixtures in tests/golden
               replayed as the reference's tests replay them, counts
               exact and the rest within the reference's 5%, then
               compare_policies at the H100 profile; the Token Velocity
               profile (an analytic H100 roofline) beside what phases 3,
               8, 9 and 17 measured (printed only), each of their transfers
               held to hardware.kv_bytes_per_token per rounded token; a
               full-width Llama-3.1-8B convertible Engine (max_len 4096)
               at the chunk plan_convertible picks for one H100 (2816
               tokens): every
               request completes, a mixed step runs a chunk of exactly
               that size, and one profiled mixed step is set beside Eq.
               5's prediction and the 100 ms TPOT SLO; its attention
               launches are printed on its own line, and its prefill
               launches are the kernels line's planned-chunk row's (1c)
 12. train   — training, gradients through the prefill and WKV6 kernels:
               (a) the two differentiable wrappers (kernel forward, the
               plain version's VJP as backward) against autograd of the
               plain versions, outputs and every input gradient (nonzero,
               finite; 2e-5 f32, 3e-2 bf16, 2e-4 WKV6): prefill at
               Llama-3.1-8B's heads (B=1, S=2048) in bf16 and f32, at
               Gemma-2-9B's D = 256 with softcap 50 and a window of 4096
               that bites (S=4608), WKV6 at RWKV-6 3B's heads (S=1024)
               from a zero and a carried state; (b) f32 SMOKE Llama,
               Gemma-2 past its window, RWKV-6, DeepSeek-V2-Lite and Jamba:
               every leaf's loss gradient through the kernels within 2e-4
               of the leaf's largest |gradient| of the plain_kernels
               path's, none missing or zero; gemma_2b SMOKE's loss drops
               over 25 steps of 8 x 64, and a checkpoint round trip gives
               the same next-step loss; (c) Llama-3.1-8B at its published
               widths and depth (bf16, seed 0): 4 train steps of B=1 x
               2048 from PackedDataset, remat, bf16 factored moments, lr
               1e-2 without warmup (so that every bf16 leaf moves): finite
               losses and grad norms, every leaf moves, the prefill
               kernel launches; (d) RWKV-6 3B: 3 steps of B=1 x 1024 with
               f32 moments, the WKV6 kernel launches; for (c) and (d) per
               step wall, loss, grad norm, tokens/s, the peak memory,
               and the last step under torch.profiler (device time by
               kind: the kernels, their plain backward, matmul, the
               optimizer, other; the idle share; model FLOPs over the
               wall against 989 TFLOP/s); its launches are printed on
               their own line, not in the kernels line
 13. ep      — the expert-parallel MoE path over torch.distributed: 4
               ranks started with torch.multiprocessing (spawn, a
               FileStore) share the card, gloo between them (NCCL refuses
               two ranks on one device); each builds only its shard of
               every leaf (seed 0, the whole model's values).  DeepSeek-
               V2-Lite at its published widths and depth, one 8-layer
               period of Jamba v0.1 at its published widths (32 layers do
               not fit: 51.6 B parameters), both bf16, and DeepSeek-V2-
               Lite's first 8 layers in f32: (a) at capacity factor 100
               (no pair dropped, checked) a prefill of 4 prompts under
               mesh ("data", "model") = (1, 4), then 4 teacher-forced
               decode steps under (2, 2), weight-stationary (the model
               rebuilt with expert d_ff over "data", the prefill's state
               cut to each rank's rows); every rank's logits against the
               single-process dense path's, computed before the ranks
               start (the ranks run the reference's act tables: their
               heads, d_ff, vocab and caches over "model" too, and the
               prefill's state is gathered whole and cut again for the
               decode mesh): bf16 by phase 3's rule, or where the dense path
               against itself (its experts in f32) is outside that rule
               too, finite; f32 within 1e-3, argmax equal; (b) the
               prefill at the config's own capacity factor, 1.25: the
               share of (token, k) pairs dropped, finite logits; Jamba's
               attention kernels launch in every rank (printed, not in the
               kernels line); each rank's peak GiB and walls, the phase's
               wall
 14. roofline — (a) the dry-run (launch/dryrun.py) of every architecture
               x input shape on both production meshes, (16, 16) and
               (2, 16, 16): one rank's step on meta tensors inside a fake
               group of 256 / 512 ranks, in SWEEP_JOBS processes on the
               host (no card), after (b); the counts of ok, skipped and
               error records, every pair whose per-rank arguments + temp
               bytes pass one H100's 80 GB, and the report's markdown
               (launch/roofline_report.py); any error fails; (b)
               Llama-3.1-8B at its published widths and depth (bf16, seed
               0): a decode step at B=4 with ~1024 of context, the
               prefill of one 1024-token prompt and a train step of 1 x
               2048 (remat, bf16 factored moments), each counted on meta
               (launch/roofline.count_step: the plain path) and run on the
               card through the kernels under torch.profiler: counted
               FLOPs against MODEL_FLOPS, t_compute and t_memory, the
               arguments read once and outputs written once over 3.35
               TB/s, device and wall ms against the roofline's largest
               term, the predicted peak against the allocator's; the
               attention kernels' launches on their own line
 15. tp      — tensor parallelism and the decode cache split over its
               positions ("ctx"): 4 ranks started with torch.
               multiprocessing (spawn, a FileStore) share the card, gloo
               between them; each builds only its shard of every leaf
               (seed 0, the whole model's values; heads, d_ff and vocab
               over "model").  (a) Llama-3.1-8B at its published widths
               and depth in bf16, and its first 8 layers in f32, under
               mesh ("data", "model") = (1, 4): 4 prompts of 64-1536
               tokens, then 8 teacher-forced decode steps with the cache
               over "model"; (b) the cache of one 32768-token Llama-3.1-8B
               prompt, from the single process's prefill, cut by
               shard_state under the batch-1 rules ("ctx" over ("data",
               "model")) on (2, 2), then 8 decode steps; (c) Qwen-2.5-32B
               at its published widths, 16 of its 64 layers, under (1, 4)
               (10 q and 2 kv heads a rank, G = 5, the qkv bias cut with
               its heads).  Every rank's logits against the single
               process's, computed before the ranks start: bf16 by phase
               3's rule (0.05 of max |logit|, each row's argmax equal or a
               near tie in the single process) or, where the single
               process's plain path against its kernels is outside it
               too, finite; f32 within 1e-3, argmaxes equal.  Each rank's
               launches (the prefill kernel, the rank-slice decode entry),
               peak GiB and walls; the phase's wall (not a TP speed)
 16. zoo     — tensor parallelism for the rest of the zoo and FSDP of
               "embed", under the reference's own rule tables
               (launch.mesh.act_rules / param_rules): 4 gloo ranks share
               the card as in phase 15, each building only its shards
               (seed 0).  (a) RWKV-6 3B whole under (1, 4), 10 of its 40
               heads a rank, and its first 8 layers in f32: 4 prompts of
               64-1536 tokens, 8 teacher-forced decode steps; each rank
               launches WKV6 once a layer in its prefill; (b) Llama-3.2-
               Vision 11B whole under (1, 4) with an image a prompt,
               cross-attention at 8 q / 2 kv heads a rank; (c) Jamba
               v0.1's first 8-layer period under (2, 2): the prefill with
               "embed" over "data" (FSDP; Mamba, attention and the dense
               FFN over "model", the experts over "model"), the decode
               steps under the decode table's model; (d) Qwen-2.5-32B's
               first 4 of 64 layers in bf16 and 2 in f32: 2 train steps
               of 2 x 512 under (2, 2) with FSDP and TP, remat and bf16
               factored moments (ROADMAP C8).  The single process's
               results are computed and freed before the ranks start.
               Logits as phase 15's (bf16 by phase 3's rule or the single
               process's own spread: its plain path, and for Jamba its
               experts in f32; f32 within 1e-3); (d)'s losses and the
               updated leaves of its first and last layers (not the key
               bias: its gradient is 0 in exact arithmetic): f32 within
               1e-3 (the q / v biases, which start at zero, 1e-2 of
               their own largest |value|), bf16 losses within 1e-2 and
               leaves within two bf16 steps of each one's largest |value|
               (the biases printed).  Each rank's launches, peak
               GiB and walls (not a TP speed)

 17. kimi    — Kimi K2 at its published widths (d_model 7168, 64 / 8 heads
               of 112, vocabulary 163,840; a dense first layer of d_ff
               18,432, then 384 experts of d_ff 2048, top-8, + 1 shared),
               its depth cut to 2 of 61 layers (19.93 B parameters, 37.1
               GiB in bf16, seed 0; the dense MoE path runs every expert on
               every token, as the reference) on phase 3's PD traffic (the
               Scaler boots at most 2 of a kind): every request completes,
               a mixed step runs, both attention kernels launch at D = 112
               (their counters go into the kernels line as the _kimi
               rows), every transfer is 7,168 B per 128-rounded token; the
               two profiles; the logits by phase 3's bf16 rule (or the
               plain path's own spread beside it), then the dense first
               layer in f32 at full width within 2e-4 of max |logit|; the
               phase's peak device memory and wall

Phases run one after another in the order 1-9, 17, 10-16 (phase
17 runs after phase 9, so that phase 11 sets its figures beside the
control plane's); each frees its model before the next, and each one's
wall time is printed as "[phase] name: s".
The second-to-last line is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero
and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from functools import partial
from pathlib import Path
from types import SimpleNamespace

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
PAYLOAD_RWKV = 21_299_200                # 32 x (40*64*64*4 + 2*2560*2) B
CONVERTIBLE_MAX_LEN = 4096               # phase 11's Engine
#: phase 11's decode rows: the chunked slot (0), three decoding requests,
#: a burst request decoding after its chunks, the cache's last row
CONVERTIBLE_CUR = [0, 1100, 3540, 4095]
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


def partial_bound(q, k, pos0, cur, window):
    """decode_bound over one slice of the cache: its live keys read once,
    q read and the f32 (o, lse) written once."""
    B, Hq, D = q.shape
    L, Hkv, e = k.shape[1], k.shape[2], q.element_size()
    cur = np.asarray(cur)
    hi = np.minimum(cur, pos0 + L - 1)
    lo = np.maximum(np.maximum(cur - window + 1, 0) if window else 0, pos0)
    keys = float(np.maximum(hi - lo + 1, 0).sum())
    ops = 4.0 * D * Hq * keys
    nbytes = e * D * (B * Hq + 2 * keys * Hkv) + 4 * B * Hq * (D + 1)
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
    from repro_torch.kernels import ops as kops
    t = time.perf_counter()
    build.build_all()
    log(f"[build] all {len(build.SOURCES)} kernels built in "
        f"{time.perf_counter() - t:.1f} s")
    d256, d112, decode, prefill = {}, {}, {}, {}
    for name in build.SOURCES:
        rep = ptxas_report(build.build_log(name))
        log(f"[build] {name}: ptxas {rep}")
        d256.update({k: v for k, v in rep.items() if "256" in k.split("<")[1]})
        d112.update({f"{name}: {k}": v for k, v in rep.items()
                     if "112" in k.split("<")[1].rstrip(">").split(",")})
        if "decode" in name:
            decode.update({f"{name}: {k}": v for k, v in rep.items()})
        # the bf16 prefill kernel (wgmma + TMA) at every head dim
        prefill.update({k: v for k, v in rep.items()
                        if k.startswith("prefill_wg_kernel")})
    log(f"[build] head dim 256 instantiations: ptxas {d256}")
    spills = {k: v for k, v in d112.items() if "spills 0/0 B" not in v}
    log(f"[build] head dim 112 instantiations: ptxas {d112}; spilling: "
        f"{spills}")
    check(len(d112) == 11 and not spills,
          "a head dim 112 instantiation spills or is missing")
    spills = {k: v for k, v in decode.items() if "spills 0/0 B" not in v}
    log(f"[build] decode instantiations: {len(decode)}, spilling: {spills}")
    check(decode and not spills, "a decode instantiation spills")
    log(f"[build] the bf16 prefill kernel at every head dim, without and "
        f"with a softcap: ptxas {prefill} (registers at entry; setmaxnreg "
        f"gives its consumer warpgroups 240, its producer 24)")
    spills = {k: v for k, v in prefill.items() if "spills 0/0 B" not in v}
    log(f"[build] bf16 prefill instantiations: {len(prefill)}, spilling: "
        f"{spills}")
    check(len(prefill) == 2 * len(kops.HEAD_DIMS) and not spills,
          "a bf16 prefill instantiation spills or is missing")
    # the bf16 decode kernel's blocks an SM, as the split rule counts them
    # and as the card's occupancy calculator gives them
    lib = build.lib("decode_attention")
    occ = {D: (lib.decode_blocks_per_sm(D), kops.decode_blocks_per_sm(D))
           for D in kops.HEAD_DIMS}
    log(f"[build] bf16 decode blocks an SM by head dim (card, split rule): "
        f"{occ}")
    check(all(occ[D][0] == occ[D][1] for D in (64, 112, 128, 256)),
          "the split rule's blocks an SM differ from the card's at the "
          "zoo's head dims")
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
    cases = {"whole prompt Sq=512 Skv=2048": (512, 0, 512, 2048),
             "convertible chunk Sq=256 off=768 len=1024": (256, 768, 1024,
                                                           2048),
             "burst prompt Sq=2048 Skv=2048 len=1500": (2048, 0, 1500, 2048)}
    # phase 11's shapes: a chunk of the planned size C into a cache of
    # CONVERTIBLE_MAX_LEN rows, whole and partial, and a prompt's last
    # chunk, cut at the cache's end, at offset C
    C, M = convertible_chunk(), CONVERTIBLE_MAX_LEN
    cases.update({
        f"planned chunk Sq={C} Skv={M} len={C}": (C, 0, C, M),
        f"planned chunk Sq={C} Skv={M} len={C - 700}": (C, 0, C - 700, M),
        f"last chunk Sq={M - C} off={C} Skv={M} len=3540": (M - C, C, 3540,
                                                            M)})

    main_inputs, case_errs = {}, {}
    for dt in (bf, f32):
        for label, (Sq, off, n, Skv) in cases.items():
            q = _rand(g, (1, Sq, 32, 128), dt)
            k = _rand(g, (1, Skv, 8, 128), dt)
            v = _rand(g, (1, Skv, 8, 128), dt)
            o = torch.tensor([off], device=dev)
            ln = torch.tensor([n], device=dev)
            out = kops.prefill_attention(q, k, v, o, ln)
            want = ref.chunked_prefill_attention_ref(q, k, v, o, ln)
            ok &= judge_attention(
                errs, "chunked_prefill_attention", label, dt, out, want)
            if dt == bf:
                # D = 128: prefill_wg_kernel, against its own arithmetic too
                case_errs[label] = max_err(out, want)
                ok &= judge_attention(
                    errs, "chunked_prefill_attention", f"{label}, vs the "
                    "kernel's arithmetic (split_p_ref)", dt, out,
                    ref.chunked_prefill_attention_split_p_ref(q, k, v, o,
                                                              ln))
                same = bool(torch.equal(out, kops.prefill_attention(
                    q, k, v, o, ln)))
                ok &= same
                log(f"[parity] chunked_prefill_attention bf16 {label}: two "
                    f"calls bit-equal: {same}")
            main_inputs[label] = (Sq, off, n)
            del out, want
        for L, curs in ((2048, DECODE_CUR), (M, CONVERTIBLE_CUR)):
            q = _rand(g, (4, 32, 128), dt)
            k, v = _rand(g, (4, L, 8, 128), dt), _rand(g, (4, L, 8, 128), dt)
            cur = torch.tensor(curs, device=dev)
            out = kops.decode_attention_op(q, k, v, cur)
            ok &= judge_attention(
                errs, "decode_attention", f"B=4 L={L} cur={curs}", dt,
                out, ref.decode_attention_ref(q, k, v, cur))
            split, nsplit = kops.decode_split(L, 4, 8, 128)
            ok &= judge_attention(
                errs, "decode_attention", f"the same vs the plain "
                f"split-and-merge version ({nsplit} splits of {split})", dt,
                out, ref.decode_attention_split_ref(q, k, v, cur, split))
            if dt == bf:
                ok &= judge_attention(
                    errs, "decode_attention", "the same vs the tensor-core "
                    "kernel's arithmetic (decode_attention_split_p_ref)", dt,
                    out, ref.decode_attention_split_p_ref(q, k, v, cur,
                                                          split))
            same = bool(torch.equal(out,
                                    kops.decode_attention_op(q, k, v, cur)))
            ok &= same
            log(f"[parity] decode_attention {'bf16' if dt == bf else 'f32'} "
                f"L={L}: two calls bit-equal: {same}")
        del q, k, v

    # the reference's kernel-test sweep: bf16 runs the wgmma path
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

    # NaN in the dead region (past cur_len, behind the window), both kernels
    for dt in (f32, bf):
        q = _rand(g, (2, 8, 64), dt)
        k, v = _rand(g, (2, 256, 2, 64), dt), _rand(g, (2, 256, 2, 64), dt)
        cur = torch.tensor([10, 100], device=dev)
        clean = kops.decode_attention_op(q, k, v, cur, window=32)
        for b, c in enumerate(cur.tolist()):
            for t in (k, v):
                t[b, c + 1:] = float("nan")
                t[b, :max(c - 31, 0)] = float("nan")
        dirty = kops.decode_attention_op(q, k, v, cur, window=32)
        want = ref.decode_attention_ref(q, k, v, cur, window=32)
        good = bool(torch.equal(clean, dirty)) and close(dirty, want, TOL[dt])
        ok &= good
        log(f"[parity] decode {'bf16' if dt == bf else 'f32'} NaN-poisoned "
            f"dead region: {'ok' if good else 'FAIL'}")
    errs["decode_attention"] = max(errs["decode_attention"],
                                   parity_decode_groups(g))
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

    def llama_row(label, Skv):
        """Row of the prefill kernel at Llama heads on main_inputs[label]
        into a cache of Skv rows, beside SDPA (the same function)."""
        Sq, off, n = main_inputs[label]
        xsets = []
        for _ in range(n_copies((Sq * 32 + 2 * Skv * 8) * 128 * 2)):
            q = _rand(g, (1, Sq, 32, 128), bf)
            k = _rand(g, (1, Skv, 8, 128), bf)
            xsets.append((q, k, _rand(g, (1, Skv, 8, 128), bf),
                          i32([off]), i32([n])))
        ar = torch.arange(Skv, device=dev)
        xmask = (ar[None, :] <= torch.arange(Sq, device=dev)[:, None] + off) \
            & (ar[None, :] < n)
        return timed_row(
            kops.prefill_attention, ref.chunked_prefill_attention_ref, xsets,
            lambda q, k, v, m: F.scaled_dot_product_attention(
                q, k, v, attn_mask=m, enable_gqa=True),
            [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
              xmask[None, None]) for q, k, v, _, _ in xsets],
            bound=prefill_bound(xsets[0][0], xsets[0][1], [off], [n], 0),
            shape=f"B=1 Sq={Sq} Skv={Skv} Hq=32 Hkv=8 D=128 bf16, offset "
                  f"{off}, len {n}")

    # the convertible chunk, for the record; the burst prompt (row 1p) and
    # phase 11's planned chunk into its cache (row 1c), rows of their own
    r = llama_row("convertible chunk Sq=256 off=768 len=1024", 2048)
    log(f"[time] prefill kernel, convertible chunk Sq=256 off=768 len=1024: "
        f"{r['ms']:.4f} ms (graph; eager {r['eager_ms']:.4f} ms, host "
        f"{r['host_us']:.1f} us/call); bound {r['bound'][0]:.4f} ms "
        f"({r['bound'][1]}), {r['bound'][0] / r['ms']:.3f} of it; plain "
        f"{r['plain_ms']:.4f} ms (eager); SDPA {r['library_ms']:.4f} ms "
        f"(eager {r['library_eager_ms']:.4f})")
    burst = "burst prompt Sq=2048 Skv=2048 len=1500"
    planned = f"planned chunk Sq={C} Skv={M} len={C}"
    rows["chunked_prefill_attention_burst"] = llama_row(burst, 2048)
    rows["chunked_prefill_attention_planned_chunk"] = llama_row(planned, M)
    errs["chunked_prefill_attention_burst"] = case_errs[burst]
    errs["chunked_prefill_attention_planned_chunk"] = case_errs[planned]

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
    errs["wkv6_rank"], rows["wkv6_rank"] = parity_wkv6_rank(g)
    e256, r256 = parity_head_dim_256(g)
    for name in r256:
        errs[f"{name}_d256"] = e256[name]
        rows[f"{name}_d256"] = r256[name]
    eq, rq = parity_qwen_heads(g)
    for name in rq:
        errs[f"{name}_qwen"] = eq[name]
        rows[f"{name}_qwen"] = rq[name]
    ew, rw = parity_wg_small_dims(g)
    errs.update(ew)
    rows.update(rw)
    ek, rk = parity_head_dim_112(g)
    for name in rk:
        errs[f"{name}_kimi"] = ek[name]
        rows[f"{name}_kimi"] = rk[name]
    errs["decode_attention_partial"], rows["decode_attention_partial"] = \
        parity_partial(g)
    for name, r in rows.items():
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms (eager {r['library_eager_ms']:.4f})"
        log(f"[time] {name} ({r['shape']}): kernel {r['ms']:.4f} ms "
            f"(graph; eager {r['eager_ms']:.4f} ms, host {r['host_us']:.1f} "
            f"us/call); bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), "
            f"{r['bound'][0] / r['ms']:.3f} of it; plain {r['plain_ms']:.4f}"
            f" ms (eager); library {lib}")
    return errs, rows


#: decode at the group sizes the other decode rows do not reach: (label,
#: Hq, Hkv, D, softcap), each at B = 4, L = 2048, cur_lens DECODE_CUR
DECODE_GROUPS = [
    ("MusicGen-large heads 32/32 (G = 1)", 32, 32, 64, 0.0),
    ("Gemma-2-9B global-layer heads 16/8 (G = 2), softcap 50", 16, 8, 256,
     GEMMA_CAP),
    ("Qwen2-0.5B heads 14/2 (G = 7)", 14, 2, 64, 0.0),
    ("heads 24/2 (G = 12: two n-tiles of heads)", 24, 2, 128, 0.0),
    ("heads 16/1 at D = 256 (G = 16: two n-tiles, Q^T from shared memory)",
     16, 1, 256, 0.0),
]


def parity_decode_groups(g):
    """The decode kernel at DECODE_GROUPS' heads, bf16 and f32: against the
    plain version and the plain split-and-merge version, in bf16 also the
    tensor-core kernel's arithmetic (``decode_attention_split_p_ref``), and
    bit-equal to itself.  Returns the largest bf16 error."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    errs, ok, cur = {"decode_attention": 0.0}, True, i32(DECODE_CUR)
    for dt in (torch.bfloat16, torch.float32):
        for label, Hq, Hkv, D, cap in DECODE_GROUPS:
            q = _rand(g, (4, Hq, D), dt)
            k = _rand(g, (4, 2048, Hkv, D), dt)
            v = _rand(g, (4, 2048, Hkv, D), dt)
            out = kops.decode_attention_op(q, k, v, cur, softcap=cap)
            split, nsplit = kops.decode_split(2048, 4, Hkv, D)
            wants = {"plain": ref.decode_attention_ref(q, k, v, cur,
                                                       softcap=cap),
                     f"plain split-and-merge ({nsplit} splits of {split})":
                     ref.decode_attention_split_ref(q, k, v, cur, split,
                                                    softcap=cap)}
            if dt == torch.bfloat16:
                wants["decode_attention_split_p_ref"] = \
                    ref.decode_attention_split_p_ref(q, k, v, cur, split,
                                                     softcap=cap)
            for what, want in wants.items():
                ok &= judge_attention(errs, "decode_attention",
                                      f"{label} vs {what}", dt, out, want)
            same = bool(torch.equal(out, kops.decode_attention_op(
                q, k, v, cur, softcap=cap)))
            ok &= same
            log(f"[parity] decode_attention {label}: two calls bit-equal: "
                f"{same}")
    check(ok, "decode kernel parity at the other group sizes failed")
    return errs["decode_attention"]


#: decode_attention_partial's cases: (label, whole L, slices, Hq, Hkv, D,
#: window, softcap, cur_lens): Llama-3.1-8B's heads on phase 15 (a)'s
#: 2048-position cache in 4 slices, cur_len on and beside a slice
#: boundary and at 0 (slices with no live key); Gemma-2-9B's D = 256 with
#: its 4096 window starting mid-slice and softcap 50; Qwen-2.5-32B's G = 5;
#: Kimi K2's D = 112 (G = 8) with a window starting mid-slice
PARTIAL_PARITY = [
    ("Llama heads L=2048 in 4 slices", 2048, 4, 32, 8, 128, 0, 0.0,
     [511, 512, 0, 2047]),
    ("Gemma-2-9B heads D=256 L=8192 in 4 slices, window 4096, softcap 50",
     8192, 4, 16, 8, 256, 4096, 50.0, [8191, 5000, 3000, 100]),
    ("Qwen-2.5-32B heads G=5 L=2048 in 4 slices", 2048, 4, 40, 8, 128, 0,
     0.0, [2047, 1000, 513, 3]),
    ("Kimi K2 heads D=112 L=2048 in 4 slices, window 700 starting "
     "mid-slice", 2048, 4, 64, 8, 112, 700, 0.0, [2047, 1000, 512, 0]),
]
#: the timed slice: rank 1's of phase 15 (a)'s cache (positions 512 ..
#: 1023 of 2048), every row with a live key there
PARTIAL_TIMED = dict(L=512, pos0=512, cur=[2047, 1500, 700, 600])


def parity_partial(g):
    """decode_attention_partial (the rank-slice entry point of the decode
    kernel) against its plain version, each slice's f32 (o, lse): within
    2e-5 in bf16 and f32 (both sides compute in f32 from the same
    inputs), -inf exactly where the plain version has it, bit-equal from
    run to run; the slices merged against the one-pass plain decode on the
    same values.  Then its time on the timed slice beside the bound, the
    plain version and SDPA over the slice's live keys (o only: SDPA gives
    no log-sum-exp; a yardstick)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    worst, ok = 0.0, True
    for dt in (torch.bfloat16, torch.float32):
        for label, L, n, Hq, Hkv, D, window, cap, curs in PARTIAL_PARITY:
            q = _rand(g, (len(curs), Hq, D), dt)
            k = _rand(g, (len(curs), L, Hkv, D), dt)
            v = _rand(g, (len(curs), L, Hkv, D), dt)
            cur = i32(curs)
            per, parts, same, err = L // n, [], True, 0.0
            for i in range(n):
                ks = k[:, i * per:(i + 1) * per].contiguous()
                vs = v[:, i * per:(i + 1) * per].contiguous()
                o, lse = kops.decode_attention_partial(
                    q, ks, vs, cur, i * per, window=window, softcap=cap)
                wants = [ref.decode_attention_partial_ref(
                    q, ks, vs, cur, i * per, window=window, softcap=cap)]
                if dt == torch.bfloat16:       # the tensor-core arithmetic
                    wants.append(ref.decode_attention_split_p_ref(
                        q, ks, vs, cur, kops.decode_split(per, len(curs),
                                                          Hkv, D)[0],
                        window=window, softcap=cap, pos0=i * per))
                for wo, wl in wants:
                    live = torch.isfinite(wl)
                    ok &= bool(torch.equal(torch.isneginf(lse),
                                           torch.isneginf(wl)))
                    ok &= close(o, wo, TOL[torch.float32]) \
                        and close(lse[live], wl[live], TOL[torch.float32])
                    err = max(err, max_err(o, wo),
                              max_err(lse[live], wl[live]))
                again = kops.decode_attention_partial(
                    q, ks, vs, cur, i * per, window=window, softcap=cap)
                same &= bool(torch.equal(o, again[0])
                             and torch.equal(lse, again[1]))
                parts.append((o, lse))
            merged = ref.merge_decode_partials(
                torch.stack([o for o, _ in parts]),
                torch.stack([l for _, l in parts]))
            whole = ref.decode_attention_ref(q.float(), k.float(), v.float(),
                                             cur, window=window, softcap=cap)
            good = close(merged, whole, TOL[torch.float32]) and same \
                and not bool(torch.isnan(merged).any())
            ok &= good
            worst = max(worst, err)
            log(f"[parity] decode_attention_partial "
                f"{'bf16' if dt == torch.bfloat16 else 'f32'} {label} "
                f"cur={curs}: max_abs_err {err:.3g} (o, lse; tol 2e-5), "
                f"merged vs one-pass {max_err(merged, whole):.3g}, "
                f"bit-equal {same}: {'ok' if good else 'FAIL'}")
    check(ok, "decode_attention_partial parity failed")
    L, pos0, curs = PARTIAL_TIMED["L"], PARTIAL_TIMED["pos0"], \
        PARTIAL_TIMED["cur"]
    bf, dev = torch.bfloat16, "cuda"
    sets = []
    for _ in range(n_copies(4 * L * 8 * 128 * 2 * 2)):
        q = _rand(g, (4, 32, 128), bf)
        k, v = _rand(g, (4, L, 8, 128), bf), _rand(g, (4, L, 8, 128), bf)
        sets.append((q, k, v, i32(curs), pos0))
    mask = (pos0 + torch.arange(L, device=dev))[None, :] \
        <= torch.tensor(curs, device=dev)[:, None]
    sdpa = [(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
             mask[:, None, None]) for q, k, v, _, _ in sets]
    row = timed_row(
        kops.decode_attention_partial, ref.decode_attention_partial_ref,
        sets, lambda q, k, v, m: F.scaled_dot_product_attention(
            q, k, v, attn_mask=m, enable_gqa=True), sdpa,
        bound=partial_bound(sets[0][0], sets[0][1], pos0, curs, 0),
        shape=f"a rank's slice: B=4 L={L} pos0={pos0} Hq=32 Hkv=8 D=128 "
              f"bf16, cur_lens {curs}")
    return worst, row


def parity_head_dim_256(g):
    """The three attention kernels at head dim 256 (Gemma, Gemma-2) against
    their plain versions, in bf16 (3e-2 and 2e-5 + 2 bf16 steps) and f32
    (2e-5): prefill with Gemma-2-9B's heads (16 / 8) and softcap 50, at a
    prompt, a prompt past the 4096 window and a chunk past it, and with
    Gemma-2B's MQA heads (8 / 1), in bf16 (prefill_wg_kernel) also against
    its own arithmetic (chunked_prefill_attention_split_p_ref), two calls
    bit-equal; the chunk past the window with NaN in K and V at every key
    no row sees (behind every row's window, past lengths), bit-equal to the
    clean inputs' output; decode with Gemma-2-9B's heads, a window
    that bites and softcap 50, also against the plain split-and-merge
    version and bit-equal to itself, and with the MQA heads; paged decode
    over interleaved pages, bit-equal to the contiguous kernel on the
    gathered KV.  Then times at Gemma-2-9B's main shapes (the prompt, and
    the prompt and the chunk past the window, each a row of its own) beside
    SDPA at the same shape with no softcap and no window (SDPA has no
    softcap: a yardstick, not the same function).  Returns (bf16 errors,
    rows), keyed by the kernels line's names."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    t0 = time.perf_counter()
    bf, f32, D = torch.bfloat16, torch.float32, 256
    errs = {"chunked_prefill_attention": 0.0, "decode_attention": 0.0,
            "paged_decode_attention": 0.0}
    ok = True
    window_label = "Gemma-2-9B heads, prompt past the window Sq=5120 " \
        "len=4600, window 4096, softcap 50"
    chunk_label = "Gemma-2-9B heads, chunk past the window Sq=256 off=4352 " \
        "len=4608, window 4096, softcap 50"
    by_case = {window_label: 0.0, chunk_label: 0.0}    # their bf16 errors
    prefill_cases = {
        # label: (Hq, Hkv, Sq, Skv, offset, length, window, softcap)
        "Gemma-2-9B heads, prompt Sq=512 Skv=2048, softcap 50":
            (16, 8, 512, 2048, 0, 512, 0, GEMMA_CAP),
        window_label: (16, 8, 5120, 5120, 0, 4600, GEMMA_WINDOW, GEMMA_CAP),
        chunk_label: (16, 8, 256, 5120, 4352, 4608, GEMMA_WINDOW, GEMMA_CAP),
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
            args = dict(window=win, softcap=cap)
            out = kops.prefill_attention(q, k, v, o, ln, **args)
            want = ref.chunked_prefill_attention_ref(q, k, v, o, ln, **args)
            ok &= judge_attention(
                errs, "chunked_prefill_attention", f"D=256 {label}", dt, out,
                want)
            if dt == bf:
                if label in by_case:
                    by_case[label] = max_err(out, want)
                ok &= judge_attention(
                    errs, "chunked_prefill_attention", f"D=256 {label}, vs "
                    "the kernel's arithmetic (split_p_ref)", dt, out,
                    ref.chunked_prefill_attention_split_p_ref(q, k, v, o, ln,
                                                              **args))
            same = bool(torch.equal(out, kops.prefill_attention(q, k, v, o, ln,
                                                                **args)))
            ok &= same
            log(f"[parity] chunked_prefill_attention {tag} D=256 {label}: two "
                f"calls bit-equal: {same}")
            del q, k, v, out, want
        ok &= prefill_dead_keys(g, dt, *prefill_cases[chunk_label])
        for label, (Hq, Hkv, L, curs, win, cap) in decode_cases.items():
            B = len(curs)
            q = _rand(g, (B, Hq, D), dt)
            k, v = _rand(g, (B, L, Hkv, D), dt), _rand(g, (B, L, Hkv, D), dt)
            cur = i32(curs)
            out = kops.decode_attention_op(q, k, v, cur, window=win,
                                           softcap=cap)
            split, nsplit = kops.decode_split(L, B, Hkv, D)
            ok &= judge_attention(
                errs, "decode_attention", f"D=256 {label}", dt, out,
                ref.decode_attention_ref(q, k, v, cur, window=win,
                                         softcap=cap))
            ok &= judge_attention(
                errs, "decode_attention", f"D=256 {label}, vs the plain "
                f"split-and-merge version ({nsplit} splits of {split})", dt,
                out, ref.decode_attention_split_ref(q, k, v, cur, split,
                                                    window=win, softcap=cap))
            if dt == bf:
                ok &= judge_attention(
                    errs, "decode_attention", f"D=256 {label}, vs the "
                    "tensor-core kernel's arithmetic", dt, out,
                    ref.decode_attention_split_p_ref(
                        q, k, v, cur, split, window=win, softcap=cap))
            same = bool(torch.equal(out, kops.decode_attention_op(
                q, k, v, cur, window=win, softcap=cap)))
            ok &= same
            log(f"[parity] decode_attention {tag} D=256 {label}: two calls "
                f"bit-equal: {same}")
        q = _rand(g, (4, 16, D), dt)
        pk, pv = _rand(g, (40, 128, 8, D), dt), _rand(g, (40, 128, 8, D), dt)
        out = kops.paged_decode_attention(q, pk, pv, tables, pcur)
        split, _ = kops.decode_split(16 * 128, 4, 8, D, 128)
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
        gk, gv = pk[safe].reshape(4, -1, 8, D), pv[safe].reshape(4, -1, 8, D)
        if dt == bf:
            ok &= judge_attention(
                errs, "paged_decode_attention", f"{label}, vs the "
                "tensor-core kernel's arithmetic on the gathered KV", dt, out,
                ref.decode_attention_split_p_ref(q, gk, gv, pcur, split))
        same = bool(torch.equal(out, kops.decode_attention_op(q, gk, gv,
                                                              pcur)))
        ok &= same
        log(f"[parity] paged_decode_attention {tag} {label}: bit-equal to "
            f"the contiguous decode kernel on the gathered KV: {same}")
    check(ok, "head dim 256 kernel parity failed")

    def sdpa(q, k, v, m):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                              enable_gqa=True)

    def prefill_row(Sq, Skv, off, n, win, shape):
        kv_bytes = (Sq * 16 + 2 * Skv * 8) * D * 2
        sets = []
        for _ in range(n_copies(kv_bytes)):
            q = _rand(g, (1, Sq, 16, D), bf)
            k, v = _rand(g, (1, Skv, 8, D), bf), _rand(g, (1, Skv, 8, D), bf)
            sets.append((q, k, v, i32([off]), i32([n])))
        ar = torch.arange(Skv, device="cuda")
        mask = (ar[None, :] <= torch.arange(Sq, device="cuda")[:, None] + off) \
            & (ar[None, :] < n)
        return timed_row(
            lambda q, k, v, o, ln: kops.prefill_attention(
                q, k, v, o, ln, window=win, softcap=GEMMA_CAP),
            lambda q, k, v, o, ln: ref.chunked_prefill_attention_ref(
                q, k, v, o, ln, window=win, softcap=GEMMA_CAP),
            sets, sdpa,
            [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
              mask[None, None]) for q, k, v, _, _ in sets],
            bound=prefill_bound(sets[0][0], sets[0][1], [off], [n], win),
            shape=shape)

    rows = {"chunked_prefill_attention": prefill_row(
        512, 2048, 0, 512, 0, "B=1 Sq=512 Skv=2048 Hq=16 Hkv=8 D=256 bf16, "
        "softcap 50, offset 0, len 512"),
        "chunked_prefill_attention_window": prefill_row(
        5120, 5120, 0, 4600, GEMMA_WINDOW, "B=1 Sq=5120 Skv=5120 Hq=16 Hkv=8 "
        "D=256 bf16, softcap 50, window 4096, offset 0, len 4600"),
        "chunked_prefill_attention_chunk": prefill_row(
        256, 5120, 4352, 4608, GEMMA_WINDOW, "B=1 Sq=256 Skv=5120 Hq=16 "
        "Hkv=8 D=256 bf16, softcap 50, window 4096, offset 4352, len 4608")}
    errs["chunked_prefill_attention_window"] = by_case[window_label]
    errs["chunked_prefill_attention_chunk"] = by_case[chunk_label]

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


def prefill_dead_keys(g, dt, Hq, Hkv, Sq, Skv, off, n, win, cap, D=256):
    """The prefill kernel at head dim D with NaN in K and V at every key no
    row can see (behind every row's window, at and past lengths): the
    output bit-equal to the clean inputs', finite, within the bounds of the
    plain version (and in bf16 of the kernel's arithmetic) on the clean
    inputs, and two calls bit-equal.  bf16 at D = 64, 128 and 256 loads
    those rows by TMA with the live ones, in the first and the last tile a
    block visits; they must weigh exactly 0.  Logs; returns ok."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    q = _rand(g, (1, Sq, Hq, D), dt)
    k, v = _rand(g, (1, Skv, Hkv, D), dt), _rand(g, (1, Skv, Hkv, D), dt)
    o, ln, args = i32([off]), i32([n]), dict(window=win, softcap=cap)
    clean = kops.prefill_attention(q, k, v, o, ln, **args)
    wants = {"the plain version": ref.chunked_prefill_attention_ref(
        q, k, v, o, ln, **args)}
    if dt == torch.bfloat16:
        wants["the kernel's arithmetic"] = \
            ref.chunked_prefill_attention_split_p_ref(q, k, v, o, ln, **args)
    for t in (k, v):
        t[0, n:] = float("nan")
        if win:
            t[0, :max(off - win + 1, 0)] = float("nan")
    dirty = kops.prefill_attention(q, k, v, o, ln, **args)
    again = kops.prefill_attention(q, k, v, o, ln, **args)
    torch.cuda.synchronize()
    good = bool(torch.isfinite(dirty).all()) \
        and bool(torch.equal(dirty, clean)) and bool(torch.equal(dirty, again))
    errs = {"chunked_prefill_attention": 0.0}
    for what, want in wants.items():
        good &= judge_attention(errs, "chunked_prefill_attention",
                                f"D={D} NaN in the dead keys, vs {what} on "
                                "the clean inputs", dt, dirty, want)
    tag = "bf16" if dt == torch.bfloat16 else "f32"
    log(f"[parity] chunked_prefill_attention {tag} D={D} NaN in K/V behind "
        f"the window and past lengths (heads {Hq}/{Hkv}, Sq={Sq} off={off} "
        f"len={n} Skv={Skv}, window {win}): finite, bit-equal to the clean "
        f"output and to itself: {'ok' if good else 'FAIL'}")
    return good


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
        split, nsplit = kops.decode_split(2048, 4, Hkv, D)
        label = f"Qwen heads 40/8 B=4 L=2048 cur={DECODE_CUR}"
        ok &= judge_attention(errs, "decode_attention", label, dt, out,
                              ref.decode_attention_ref(q, k, v, cur))
        ok &= judge_attention(
            errs, "decode_attention", f"{label}, vs the plain split-and-merge "
            f"version ({nsplit} splits of {split})", dt, out,
            ref.decode_attention_split_ref(q, k, v, cur, split))
        if dt == bf:
            ok &= judge_attention(
                errs, "decode_attention", f"{label}, vs the tensor-core "
                "kernel's arithmetic", dt, out,
                ref.decode_attention_split_p_ref(q, k, v, cur, split))
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


#: bf16 prefill on prefill_wg_kernel at D = 64 and 128 beyond the Llama and
#: Qwen rows: label -> (Hq, Hkv, D, B, Sq, Skv, offsets, lengths, window,
#: softcap); the B = 1 cases again with NaN in the keys no row sees
WG_PREFILL = {
    "Qwen2-0.5B heads 14/2 D=64, prompt Sq=512 Skv=2048 len=512":
        (14, 2, 64, 1, 512, 2048, [0], [512], 0, 0.0),
    "Qwen2-0.5B heads 14/2 D=64, chunk Sq=256 off=1100 Skv=2048 len=1300, "
    "window 700, softcap 50": (14, 2, 64, 1, 256, 2048, [1100], [1300], 700,
                               50.0),
    "MusicGen-large heads 32/32 D=64, ragged batch B=2 Sq=150 off=[500, 37] "
    "len=[650, 187], window 300, softcap 50":
        (32, 32, 64, 2, 150, 700, [500, 37], [650, 187], 300, 50.0),
    "Qwen heads 40/8 D=128, chunk Sq=256 off=1536 Skv=2048 len=1700, "
    "window 1024": (40, 8, 128, 1, 256, 2048, [1536], [1700], 1024, 0.0),
    f"Llama heads 32/8 D=128, last chunk Sq={CONVERTIBLE_MAX_LEN - 2816} "
    f"off=2816 Skv={CONVERTIBLE_MAX_LEN} len=3540":
        (32, 8, 128, 1, CONVERTIBLE_MAX_LEN - 2816, CONVERTIBLE_MAX_LEN,
         [2816], [3540], 0, 0.0),
    "MQA heads 6/1 D=128, ragged batch B=2 Sq=200 off=[0, 300] Skv=512 "
    "len=[200, 500]": (6, 1, 128, 2, 200, 512, [0, 300], [200, 500], 0, 0.0),
}


def parity_wg_small_dims(g):
    """The bf16 prefill at D = 64 and 128 (prefill_wg_kernel: wgmma, TMA, a
    warp-specialised producer) and the f32 path at the same shapes, on
    WG_PREFILL's cases: against the plain version in bf16 (3e-2 and 2e-5 +
    2 bf16 steps, and against the kernel's own arithmetic,
    chunked_prefill_attention_split_p_ref) and f32 (2e-5), two calls
    bit-equal, one launch a call; the B = 1 cases with NaN in every key
    no row sees, bit-equal to the clean output.  Then row 1h: Qwen2-0.5B's
    heads (14 / 2, D = 64) at B=1 Sq=512 Skv=2048 len 512 beside its bound,
    plain version and SDPA (the same function).  Returns (bf16 errors,
    rows) keyed by the kernels line's names."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    bf, f32 = torch.bfloat16, torch.float32
    errs = {"chunked_prefill_attention": 0.0}
    ok, row_err = True, 0.0
    for dt in (bf, f32):
        tag = "bf16" if dt == bf else "f32"
        for label, (Hq, Hkv, D, B, Sq, Skv, offs, lens, win, cap) in \
                WG_PREFILL.items():
            q = _rand(g, (B, Sq, Hq, D), dt)
            k = _rand(g, (B, Skv, Hkv, D), dt)
            v = _rand(g, (B, Skv, Hkv, D), dt)
            o, ln, args = i32(offs), i32(lens), dict(window=win, softcap=cap)
            n0 = kops.LAUNCHES["chunked_prefill_attention"]
            out = kops.prefill_attention(q, k, v, o, ln, **args)
            one = kops.LAUNCHES["chunked_prefill_attention"] == n0 + 1
            want = ref.chunked_prefill_attention_ref(q, k, v, o, ln, **args)
            ok &= one and judge_attention(
                errs, "chunked_prefill_attention", label, dt, out, want)
            if dt == bf:
                if label.startswith("Qwen2-0.5B heads 14/2 D=64, prompt"):
                    row_err = max_err(out, want)
                ok &= judge_attention(
                    errs, "chunked_prefill_attention", f"{label}, vs the "
                    "kernel's arithmetic (split_p_ref)", dt, out,
                    ref.chunked_prefill_attention_split_p_ref(q, k, v, o, ln,
                                                              **args))
            same = bool(torch.equal(out, kops.prefill_attention(q, k, v, o, ln,
                                                                **args)))
            ok &= same
            log(f"[parity] chunked_prefill_attention {tag} {label}: one "
                f"launch a call: {one}; two calls bit-equal: {same}")
            del q, k, v, out, want
            if B == 1:
                ok &= prefill_dead_keys(g, dt, Hq, Hkv, Sq, Skv, offs[0],
                                        lens[0], win, cap, D=D)
    check(ok, "prefill parity at D = 64 and 128 failed")

    Hq, Hkv, D = 14, 2, 64
    sets = []
    for _ in range(n_copies((512 * Hq + 2 * 2048 * Hkv) * D * 2)):
        q = _rand(g, (1, 512, Hq, D), bf)
        k, v = _rand(g, (1, 2048, Hkv, D), bf), _rand(g, (1, 2048, Hkv, D), bf)
        sets.append((q, k, v, i32([0]), i32([512])))
    ar = torch.arange(2048, device="cuda")
    mask = (ar[None, :] <= torch.arange(512, device="cuda")[:, None]) \
        & (ar[None, :] < 512)
    row = timed_row(
        kops.prefill_attention, ref.chunked_prefill_attention_ref, sets,
        lambda q, k, v, m: F.scaled_dot_product_attention(
            q, k, v, attn_mask=m, enable_gqa=True),
        [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
          mask[None, None]) for q, k, v, _, _ in sets],
        bound=prefill_bound(sets[0][0], sets[0][1], [0], [512], 0),
        shape="B=1 Sq=512 Skv=2048 Hq=14 Hkv=2 D=64 bf16, offset 0, len 512 "
              "(Qwen2-0.5B heads)")
    return {"chunked_prefill_attention_d64": row_err}, \
        {"chunked_prefill_attention_d64": row}


#: phase 2's cases at head dim 112 (Kimi K2: 64 / 8 heads, G = 8).
#: Prefill (bf16: prefill_wg_kernel<112, *>, rows padded to 128 columns;
#: f32: prefill_f32_kernel<112>): label -> (B, Sq, Skv, offsets, lengths,
#: window, softcap); the B = 1 cases again with NaN in the keys no row sees
KIMI_BURST = "Kimi heads, burst prompt Sq=2048 Skv=2048 len=1500"
KIMI_PREFILL = {
    "Kimi heads, prompt Sq=512 Skv=2048 len=512": (1, 512, 2048, [0], [512],
                                                   0, 0.0),
    "Kimi heads, chunk Sq=256 off=1536 Skv=2048 len=1700, window 1024, "
    "softcap 50": (1, 256, 2048, [1536], [1700], 1024, 50.0),
    "Kimi heads, ragged batch B=2 Sq=320 off=[300, 0] len=[600, 200], "
    "window 256": (2, 320, 1024, [300, 0], [600, 200], 256, 0.0),
    KIMI_BURST: (1, 2048, 2048, [0], [1500], 0, 0.0),
}
#: Decode: label -> (L, cur_lens, window, softcap); splits of 128 positions
KIMI_DECODE = {
    f"Kimi heads B=4 L=2048 cur={DECODE_CUR}": (2048, DECODE_CUR, 0, 0.0),
    "Kimi heads B=4 L=2048 cur=[1023, 128, 1500, 2047], window 600 across "
    "split boundaries": (2048, [1023, 128, 1500, 2047], 600, 0.0),
}


def parity_head_dim_112(g):
    """The three attention kernels at head dim 112 (Kimi K2, 64 / 8 heads)
    against their plain versions, in bf16 (3e-2 and 2e-5 + 2 bf16 steps)
    and f32 (2e-5): prefill (prefill_wg_kernel<112, *>,
    prefill_f32_kernel<112>) at a prompt, a chunk at an offset with a
    window and softcap, a ragged batch and the burst prompt, in bf16 also
    against its own arithmetic (chunked_prefill_attention_split_p_ref), the
    B = 1 cases with NaN in every key no row sees bit-equal to the clean
    output; decode (decode_tc_kernel<112>,
    decode_split_kernel<f32, 112>) at the decode rows' cache lengths and
    with a window across split boundaries, also against the plain
    split-and-merge version and in bf16 the tensor-core kernel's
    arithmetic; paged decode over interleaved pages, bit-equal to the
    contiguous kernel on the gathered KV; every kernel bit-equal to itself
    (the rank-slice entry's case at these heads is in PARTIAL_PARITY).
    Then rows 1k, 1kp and 2k: prefill at B=1 Sq=512 Skv=2048 (len 512)
    and at the burst prompt (Sq = Skv = 2048, len 1500) and decode at B=4
    L=2048 (DECODE_CUR), each beside its bound, the plain version and SDPA
    (the same function: no window, no softcap).  Returns (bf16 errors,
    rows) keyed by the kernels line's names, less the _kimi suffix."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    t0 = time.perf_counter()
    bf, f32, Hq, Hkv, D = torch.bfloat16, torch.float32, 64, 8, 112
    errs = {"chunked_prefill_attention": 0.0, "decode_attention": 0.0,
            "paged_decode_attention": 0.0}
    ok, burst_err = True, 0.0
    tables = torch.as_tensor(interleaved_tables([c + 1 for c in DECODE_CUR],
                                                40, 16), device="cuda")
    safe = tables.clamp(min=0).long()
    pcur = i32(DECODE_CUR)
    for dt in (bf, f32):
        tag = "bf16" if dt == bf else "f32"
        for label, (B, Sq, Skv, offs, lens, win, cap) in KIMI_PREFILL.items():
            q = _rand(g, (B, Sq, Hq, D), dt)
            k = _rand(g, (B, Skv, Hkv, D), dt)
            v = _rand(g, (B, Skv, Hkv, D), dt)
            o, ln, args = i32(offs), i32(lens), dict(window=win, softcap=cap)
            out = kops.prefill_attention(q, k, v, o, ln, **args)
            want = ref.chunked_prefill_attention_ref(q, k, v, o, ln, **args)
            ok &= judge_attention(
                errs, "chunked_prefill_attention", f"D=112 {label}", dt, out,
                want)
            if dt == bf:
                if label == KIMI_BURST:
                    burst_err = max_err(out, want)
                ok &= judge_attention(
                    errs, "chunked_prefill_attention", f"D=112 {label}, vs "
                    "the kernel's arithmetic (split_p_ref)", dt, out,
                    ref.chunked_prefill_attention_split_p_ref(q, k, v, o, ln,
                                                              **args))
            same = bool(torch.equal(out, kops.prefill_attention(q, k, v, o, ln,
                                                                **args)))
            ok &= same
            log(f"[parity] chunked_prefill_attention {tag} D=112 {label}: two "
                f"calls bit-equal: {same}")
            del q, k, v, out, want
            if B == 1:
                ok &= prefill_dead_keys(g, dt, Hq, Hkv, Sq, Skv, offs[0],
                                        lens[0], win, cap, D=D)
        for label, (L, curs, win, cap) in KIMI_DECODE.items():
            B, cur, args = len(curs), i32(curs), dict(window=win, softcap=cap)
            q = _rand(g, (B, Hq, D), dt)
            k, v = _rand(g, (B, L, Hkv, D), dt), _rand(g, (B, L, Hkv, D), dt)
            out = kops.decode_attention_op(q, k, v, cur, **args)
            split, nsplit = kops.decode_split(L, B, Hkv, D)
            wants = {"plain": ref.decode_attention_ref(q, k, v, cur, **args),
                     f"plain split-and-merge ({nsplit} splits of {split})":
                     ref.decode_attention_split_ref(q, k, v, cur, split,
                                                    **args)}
            if dt == bf:
                wants["the tensor-core kernel's arithmetic"] = \
                    ref.decode_attention_split_p_ref(q, k, v, cur, split,
                                                     **args)
            for what, want in wants.items():
                ok &= judge_attention(errs, "decode_attention",
                                      f"D=112 {label} vs {what}", dt, out,
                                      want)
            same = bool(torch.equal(out, kops.decode_attention_op(
                q, k, v, cur, **args)))
            ok &= same
            log(f"[parity] decode_attention {tag} D=112 {label}: two calls "
                f"bit-equal: {same}")
        q = _rand(g, (4, Hq, D), dt)
        pk, pv = _rand(g, (40, 128, Hkv, D), dt), _rand(g, (40, 128, Hkv, D), dt)
        out = kops.paged_decode_attention(q, pk, pv, tables, pcur)
        split, _ = kops.decode_split(16 * 128, 4, Hkv, D, 128)
        label = f"D=112 Kimi heads B=4 cur={DECODE_CUR} interleaved pages"
        ok &= judge_attention(
            errs, "paged_decode_attention", label, dt, out,
            ref.paged_decode_attention_ref(q, pk, pv, tables, pcur))
        ok &= judge_attention(
            errs, "paged_decode_attention", f"{label}, vs the plain "
            "split-and-merge version", dt, out,
            ref.paged_decode_attention_split_ref(q, pk, pv, tables, pcur,
                                                 split))
        gk = pk[safe].reshape(4, -1, Hkv, D)
        gv = pv[safe].reshape(4, -1, Hkv, D)
        same = bool(torch.equal(out, kops.decode_attention_op(q, gk, gv, pcur))
                    and torch.equal(out, kops.paged_decode_attention(
                        q, pk, pv, tables, pcur)))
        ok &= same
        log(f"[parity] paged_decode_attention {tag} {label}: bit-equal to "
            f"the contiguous decode kernel on the gathered KV and to "
            f"itself: {same}")
    check(ok, "head dim 112 kernel parity failed")

    def sdpa(q, k, v, m):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                              enable_gqa=True)

    def prefill_row(Sq, n):
        """Row of the prefill kernel at Kimi's heads, B=1, Sq rows from
        offset 0 into 2048 keys of which n are live, beside SDPA."""
        sets = []
        for _ in range(n_copies((Sq * Hq + 2 * 2048 * Hkv) * D * 2)):
            q = _rand(g, (1, Sq, Hq, D), bf)
            k = _rand(g, (1, 2048, Hkv, D), bf)
            sets.append((q, k, _rand(g, (1, 2048, Hkv, D), bf), i32([0]),
                         i32([n])))
        ar = torch.arange(2048, device="cuda")
        mask = (ar[None, :] <= torch.arange(Sq, device="cuda")[:, None]) \
            & (ar[None, :] < n)
        return timed_row(
            kops.prefill_attention, ref.chunked_prefill_attention_ref, sets,
            sdpa, [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    mask[None, None]) for q, k, v, _, _ in sets],
            bound=prefill_bound(sets[0][0], sets[0][1], [0], [n], 0),
            shape=f"B=1 Sq={Sq} Skv=2048 Hq=64 Hkv=8 D=112 bf16, offset 0, "
                  f"len {n} (Kimi K2 heads)")

    rows = {"chunked_prefill_attention": prefill_row(512, 512),
            "chunked_prefill_attention_burst": prefill_row(2048, 1500)}
    errs["chunked_prefill_attention_burst"] = burst_err
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
        shape="B=4 L=2048 Hq=64 Hkv=8 D=112 bf16, cur_lens "
              "0/700/1500/2047 (Kimi K2 heads)")
    log(f"[time] decode_attention D=112 device us per call by kernel "
        f"(torch.profiler): "
        f"{device_us_by_kernel(kops.decode_attention_op, dsets)}")
    log(f"[parity] head dim 112 checks and times: "
        f"{time.perf_counter() - t0:.1f} s")
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
        split, _ = kops.decode_split(16 * 128, 4, 8, 128, 128)
        wants = [("plain", want), ("plain split-and-merge",
                  ref.paged_decode_attention_split_ref(q, pk, pv, tables,
                                                       cur, split))]
        if dt == bf:
            wants.append(("the tensor-core kernel's arithmetic on the "
                          "gathered KV", ref.decode_attention_split_p_ref(
                              q, pk[safe].reshape(4, -1, 8, 128),
                              pv[safe].reshape(4, -1, 8, 128), cur, split)))
        for label, w in wants:
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


#: WKV6 on one rank's heads of RWKV-6 3B under tensor parallelism over 4
#: (phase 16 (a): 40 heads / 4), at the prompts' shapes: (label, B, S,
#: zero state)
WKV_RANK_H = 10
WKV_RANK_CASES = [("4 prompts S=1536 from s0=0", 4, 1536, True),
                  ("one prompt S=64 from a carried s0", 1, 64, False),
                  ("a chunk S=700 from a carried s0", 2, 700, False)]


def parity_wkv6_rank(g):
    """The WKV6 kernel on a rank's heads (H = 10, K = 64, model-like
    decays) against the plain chunked version and the float64 sequential
    oracle, f32 at 2e-4, bit-equal to itself; its time at phase 16 (a)'s
    prefill (B = 4, S = 1536) beside the bound and the plain version."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    ok, worst = True, 0.0
    for label, B, S, s0_zero in WKV_RANK_CASES:
        args = _wkv_inputs(g, B, S, WKV_RANK_H, 64, model_decay=True,
                           s0_zero=s0_zero)
        y, sT = kops.wkv6_op(*args)
        want_y, want_s = ref.wkv6_chunked(*args)
        r, k, v, w, u, s0 = (t.double() for t in args)
        oy, osT = ref.wkv6_ref(*(t.transpose(1, 2) for t in (r, k, v, w)),
                               u, s0)
        good = close(y, want_y, WKV_TOL) and close(sT, want_s, WKV_TOL) \
            and close(y, oy.transpose(1, 2).float(), WKV_TOL) \
            and close(sT, osT.float(), WKV_TOL)
        y2, sT2 = kops.wkv6_op(*args)
        same = bool(torch.equal(y, y2) and torch.equal(sT, sT2))
        e = max(max_err(y, want_y), max_err(sT, want_s))
        worst = max(worst, e)
        ok &= good and same
        log(f"[parity] wkv6 a rank's heads H={WKV_RANK_H} K=64, {label}: "
            f"max_abs_err {e:.3g} vs the plain chunked version, "
            f"{max(max_err(y, oy.transpose(1, 2)), max_err(sT, osT)):.3g} "
            f"vs the float64 oracle; bit-equal to itself {same}; "
            f"{'ok' if good and same else 'FAIL'}")
    check(ok, "wkv6 kernel parity on a rank's heads failed")
    B, S = 4, 1536
    sets = [_wkv_inputs(g, B, S, WKV_RANK_H, 64, model_decay=True,
                        s0_zero=True)
            for _ in range(n_copies(5 * B * S * WKV_RANK_H * 64 * 4))]
    return worst, timed_row(           # no single torch call computes WKV6
        kops.wkv6_op, ref.wkv6_chunked, sets,
        bound=wkv6_bound(B, S, WKV_RANK_H, 64, 16),
        shape=f"B={B} S={S} H={WKV_RANK_H} K=64 f32, chunk 16 (a rank's "
              "heads of RWKV-6 3B over 4)")


#: the prefill kernel's launches by (dtype, B, Sq, Skv, Hq, Hkv, D)
#: (kops.PREFILL_SHAPES) in each serving run, by the run's tag; read with
#: the run's other counters
SERVED = {}


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
    SERVED[tag] = dict(kops.PREFILL_SHAPES)
    # ... to here
    mixed, dec, mixed_s, dec_s = counts + steps([eng])
    run = dict(
        launches=launches, reqs=reqs, direct=direct, transfers=transfers,
        max_len=max_len,
        done=sum(len(r.output) == new for r in reqs + direct),
        n=len(reqs) + len(direct), mixed=int(mixed), dec_steps=int(dec),
        prefill_tok_s=pre_tok / max(pre_s, 1e-9))
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
    bytes_ok = payloads_ok(run, "serve", cfg)
    check(run["done"] == run["n"], "not every request completed")
    check(run["mixed"] > 0, "no mixed (convertible) step ran")
    check(all(n > 0 for n in launches.values()), f"launches {launches}")
    check(bytes_ok, "KV payload sizes")
    figures = velocity_figures(cfg, model, run, bytes_ok)
    p, L = run["reqs"][3].prompt, run["max_len"]
    share, _, finite = compare_logits(
        last_logits(cfg, model, p, L), last_logits(cfg, model, p, L, True),
        "serve", f"kernels vs plain attention (L={len(p)})")
    check(finite and share <= 0.05, "kernel and plain logits disagree")
    return launches, figures


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
        f"{all(b == PAYLOAD_RWKV for b in sent)}")
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
    bytes_ok = payloads_ok(run, "gemma", cfg)
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
                 bf16="argmax", f32_layers=0, img=None, f32_tol=1e-3):
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
    does not fit the card), where the kernels must agree within `f32_tol`
    of the largest |logit| with the same argmax.  `img` is a vision model's
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
    log(f"[{tag}] f32: within {f32_tol:g} of max |logit|: "
        f"{share <= f32_tol}")
    check(finite and same and share <= f32_tol,
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
        if any(w in name for w in ("decode_tc_kernel", "decode_split_kernel",
                                   "prefill_", "decode_combine_kernel")):
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


def _profiled(fn):
    """Run `fn` once under torch.profiler: the host's wall microseconds,
    then _device_by_kind of what ran."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return (wall_us, *_device_by_kind(prof))


def profile_decode(cfg, model, ctx=1024, steps=8):
    """Where one decode step's time goes: 4 slots at ~`ctx` tokens of
    context, `steps` decode steps under torch.profiler; kernel time by kind
    and the device's idle share of the host's wall time.  Returns the
    step's wall and device ms, or None if the profiler saw no device."""
    from repro_torch.serving import Engine, Request
    rng = np.random.RandomState(1)
    eng = Engine(cfg, model, num_slots=4, max_len=2048)
    for i in range(4):
        eng.add_request(Request(rid=i, prompt=rng.randint(
            0, cfg.vocab_size, size=(ctx,)).astype(np.int32),
            max_new_tokens=steps + 4, image_embeds=image(cfg, 100 + i)))
    eng.step()
    eng.step()
    wall_us, kinds, n, n_attn = _profiled(
        lambda: [eng.step() for _ in range(steps)])
    busy = sum(kinds.values())
    if n == 0:
        log("[profile] decode step breakdown: not measured (the profiler "
            "recorded no device events)")
        return None
    per = {k: round(v / steps / 1e3, 3) for k, v in kinds.items()}
    log(f"[profile] {cfg.name} decode step at B=4, ctx~{ctx}: wall "
        f"{wall_us / steps / 1e3:.2f} ms/step; device ms/step by kind {per};"
        f" {n / steps:.0f} kernels/step ({n_attn / steps:.0f} attention); "
        f"device idle share {1 - busy / wall_us:.3f}")
    return dict(wall_ms=wall_us / steps / 1e3, device_ms=busy / steps / 1e3)


def profile_prefill(cfg, model, length=1024):
    """Where one prompt's prefill time goes (the prefiller's work, TTFT):
    a `length`-token prompt through models.prefill under torch.profiler;
    kernel time by kind and the device's idle share of the host's wall.
    Returns its wall and device ms, or None if the profiler saw no
    device."""
    from repro_torch.models import init_state, prefill
    toks = np.random.RandomState(2).randint(
        0, cfg.vocab_size, size=(1, length)).astype(np.int32)
    img = image(cfg, 200)
    img = None if img is None else img[None]
    prefill(cfg, model, init_state(cfg, 1, 2048, "cuda"), toks, [length],
            img)
    torch.cuda.synchronize()
    state = init_state(cfg, 1, 2048, "cuda")
    wall_us, kinds, n, _ = _profiled(
        lambda: prefill(cfg, model, state, toks, [length], img))
    if n == 0:
        log("[profile] prefill breakdown: not measured (the profiler "
            "recorded no device events)")
        return None
    per = {k: round(v / 1e3, 3) for k, v in kinds.items()}
    log(f"[profile] {cfg.name} prefill of one {length}-token prompt: wall "
        f"{wall_us / 1e3:.2f} ms; device ms by kind {per}; {n} kernels; "
        f"device idle share {1 - sum(kinds.values()) / wall_us:.3f}")
    return dict(wall_ms=wall_us / 1e3, device_ms=sum(kinds.values()) / 1e3)


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
    PDCluster; DeepSeek-V2-Lite (MLA, MoE), Kimi K2 (MoE, GQA; at head
    dim 64, and at its published 112 with d_model 448 over its 4 / 2
    heads) and Jamba (Mamba, MoE; prompts past the 16-token chunk) by
    PDCluster and by a
    convertible Engine of 2 slots and 16-token chunks (chunks from carried
    latent and Mamba states, reused slots); Llama-3.2-Vision by an Engine
    with an image per request and the cross-attention gates at 1."""
    from repro_torch.configs import get_config
    from repro_torch.core import CHIPS, InstanceSpec, TokenScalePolicy, profile
    from repro_torch.kernels import ops as kops
    from repro_torch.models import init_params
    from repro_torch.serving import Engine, PDCluster, Request

    short = [7, 12, 5, 20, 9]
    kops.reset_launches()
    for arch, over, lens, max_len, what in (
            ("llama31_8b", {}, short, 96, ""),
            ("rwkv6_3b", {}, short, 96, ""),
            ("gemma2_9b", {}, [70, 12, 90, 20, 9], 160,
             ", prompts past the 64-token window"),
            ("llama31_8b", {"kv_cache_dtype": "int8"}, short, 96,
             ", int8 KV cache"),
            ("deepseek_v2_lite_16b", {}, short, 96, ""),
            ("kimi_k2_1t_a32b", {}, short, 96, ""),
            ("kimi_k2_1t_a32b", {"d_model": 448}, short, 96,
             ", head dim 112"),
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
    SERVED["exact"] = dict(kops.PREFILL_SHAPES)


def full_model(arch, tag, num_layers=None):
    """The config at its published widths and depth (or its first
    `num_layers` layers), with random bf16 weights from seed 0 made on the
    card."""
    from repro_torch.configs import get_config
    from repro_torch.models import count_params, init_params
    cfg = get_config(arch)
    depth = ""
    if num_layers is not None:
        depth = f", depth cut to {num_layers} of {cfg.num_layers} layers"
        cfg = cfg.replace(num_layers=num_layers)
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
        f"({cfg.num_layers}L d={cfg.d_model}, {heads}{depth}) made on the "
        f"card in "
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


def velocity_figures(cfg, model, run, bytes_ok):
    """What phase 11 sets beside the control plane's Token Velocity
    profile: the served run's prefiller rate, its transfers and whether
    each was kv_bytes_per_token per rounded token, and the two profiles
    (decode step at B=4, ctx 1024; one 1024-token prefill)."""
    return dict(cfg=cfg, prefill_tok_s=run["prefill_tok_s"],
                transfers=run["transfers"], bytes_ok=bytes_ok,
                decode=profile_decode(cfg, model),
                prefill=profile_prefill(cfg, model))


def rounded(L, max_len):
    """The tokens a transfer of an L-token prompt ships: L rounded up to
    128, at least 8, at most max_len."""
    return min(max(-(-L // 128) * 128, 8), max_len)


def payloads_ok(run, tag, cfg):
    """Every transfer of the run is hardware.kv_bytes_per_token(cfg) B per
    128-rounded token."""
    from repro_torch.core import hardware
    per_token = int(hardware.kv_bytes_per_token(cfg))
    want = [per_token * rounded(L, run["max_len"])
            for _, L in run["transfers"]]
    sent = [b for b, _ in run["transfers"]]
    ok = len(sent) > 0 and sent == want
    log(f"[{tag}] transfers {len(sent)}, {sum(sent)} bytes, for prompts of "
        f"{sorted(L for _, L in run['transfers'])} tokens; each "
        f"kv_bytes_per_token {per_token} B x rounded length: {ok}")
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
    bytes_ok = payloads_ok(run, "qwen", cfg)
    check(run["done"] == run["n"], "qwen: not every request completed")
    check(run["mixed"] > 0, "qwen: no mixed (convertible) step ran")
    check(all(n > 0 for n in launches.values()), f"qwen launches {launches}")
    check(bytes_ok, "qwen payload sizes")
    figures = velocity_figures(cfg, model, run, bytes_ok)
    check_logits(cfg, model, run["reqs"][3].prompt, run["max_len"], "qwen",
                 "attention kernels", SDPA_F32_P,
                 "with P and P.V in f32 vs P in bf16", bf16="rule",
                 f32_layers=QWEN_F32_LAYERS)
    log(f"[qwen] peak device memory over the phase "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, figures


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
    bytes_ok = payloads_ok(run, "deepseek", cfg)
    check(run["done"] == run["n"], "deepseek: not every request completed")
    check(run["mixed"] > 0, "deepseek: no mixed (convertible) step ran")
    check(all(n == 0 for n in attn.values()),
          f"deepseek: attention kernels launched under MLA: {attn}")
    check(bytes_ok, "deepseek payload sizes")
    figures = velocity_figures(cfg, model, run, bytes_ok)
    p, L = run["reqs"][3].prompt, run["max_len"]
    share, same, finite = compare_logits(
        last_logits(cfg, model, p, L), last_logits(cfg, model, p, L, True),
        "deepseek", f"bf16, kernels vs plain (L={len(p)}; no kernel on "
        "this path)")
    check(finite and same and share <= 0.05,
          "deepseek: kernel and plain logits disagree")
    return figures


KIMI_LAYERS = 2          # phase 17: Kimi K2's dense first layer + one MoE
KIMI_F32_LAYERS = 1      # its f32 logits check: the dense layer (11.4 GB)
KIMI_F32_TOL = 2e-4      # the reference's model tolerance, of max |logit|
KIMI_PAYLOAD = 7168      # B a token: 2 layers x (K, V) x 8 heads x 112 x 2 B


def phase_kimi():
    """Kimi K2 at its published widths (d_model 7168, 64 / 8 heads of 112,
    vocabulary 163,840, rope theta 5e4; the dense first layer's d_ff
    18,432, then 384 experts of d_ff 2048, top-8, and one shared expert),
    its depth cut to KIMI_LAYERS of 61: one dense layer and one MoE layer,
    19.93 B parameters, 37.1 GiB in bf16 from seed 0, made on the card.
    The dense MoE path runs all 384 experts on every token, as the
    reference does.  On the main path's PD traffic (the Scaler boots at
    most 2 instances of a kind; the weights are shared): every request
    completes, a mixed step runs, both attention kernels launch at D = 112
    (their counters, read around the traffic, go into the kernels line as
    the _kimi rows), every transfer is 7,168 B per 128-rounded token; the
    velocity figures and the two profiles; the logits by phase 3's bf16
    rule (or the plain path's own spread beside it), then the dense first
    layer alone in f32 at full width within 2e-4 of max |logit| (two
    layers in f32, 80 GB, do not fit).  Prints the phase's peak device
    memory and wall."""
    from repro_torch.core import hardware
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, model = full_model("kimi_k2_1t_a32b", "kimi", KIMI_LAYERS)
    check(cfg.head_dim_ == 112 and cfg.d_model == 7168
          and cfg.moe.num_experts == 384,
          f"kimi: not at its published widths ({cfg})")
    check(int(hardware.kv_bytes_per_token(cfg)) == KIMI_PAYLOAD,
          "kimi: kv_bytes_per_token")
    run = drive_pd(cfg, model, "kimi", max_instances=2)
    launches = {n: run["launches"][n]
                for n in ("chunked_prefill_attention", "decode_attention")}
    bytes_ok = payloads_ok(run, "kimi", cfg)
    check(run["done"] == run["n"], "kimi: not every request completed")
    check(run["mixed"] > 0, "kimi: no mixed (convertible) step ran")
    check(all(n > 0 for n in launches.values()), f"kimi launches {launches}")
    check(bytes_ok, "kimi payload sizes")
    figures = velocity_figures(cfg, model, run, bytes_ok)
    check_logits(cfg, model, run["reqs"][3].prompt, run["max_len"], "kimi",
                 "attention kernels", SDPA_F32_P,
                 "with P and P.V in f32 vs P in bf16", bf16="rule",
                 f32_layers=KIMI_F32_LAYERS, f32_tol=KIMI_F32_TOL)
    log(f"[kimi] peak device memory over the phase "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; wall "
        f"{time.perf_counter() - t0:.1f} s (depth cut to {KIMI_LAYERS} of "
        f"61 layers)")
    del model
    return launches, figures


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
    SERVED["vision"] = dict(kops.PREFILL_SHAPES)
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


# ---------------------------------------------------------------------------
# phase 11: the control plane and both simulators, beside the card
# ---------------------------------------------------------------------------

GOLDEN = ROOT / "tests" / "golden"
#: the fixtures phase 11 replays.  pareto_coord.json does not hold its pool
#: list (benchmarks/run.py's pareto_fleet_spec builds it), so only the CPU
#: tests replay that one, from the spec's dict.
GOLDEN_ON_CARD = ("tokenscale_azure_conv", "priority_preemption_burstgpt2",
                  "hetero_fleet", "kvtiers_session", "gateway_locality",
                  "deflect_burst", "chaos_recovery")
GOLDEN_REL = {"pareto_coord": 1e-6}      # the reference's tests' tolerances;
GOLDEN_REL_DEFAULT = 0.05                # counts (ints) are held exact
#: the chaos bench's knobs that its fixture does not record
#: (benchmarks/run.py run_chaos_variant)
CHAOS_KNOBS = dict(preemption="evict-lowest", block_size=16,
                   prefix_cache=True)
PLAN_ARGS = dict(expected_decode_batch=4, avg_ctx=1024, burst_ratio=0.2,
                 max_decoders=2)         # phase 11's convertible plan


def convertible_plan(cfg):
    """plan_convertible's plan for `cfg` on one H100 (TP 1), phase 11's."""
    from repro_torch.core import CHIPS, InstanceSpec, plan_convertible
    return plan_convertible(cfg, InstanceSpec(CHIPS["h100"], 1), **PLAN_ARGS)


def convertible_chunk():
    """The chunk size of phase 11's plan for Llama-3.1-8B (2816 tokens)."""
    from repro_torch.configs import get_config
    return convertible_plan(get_config("llama31_8b")).chunk_size


def _finite(x):
    """`x` with each non-finite float as None, as the fixtures store it."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def _golden_variant(name, g, runner, eng, v, mix, pareto_specs):
    """One variant's row of a per-variant fixture, as its regenerator
    writes it (scripts/regen_golden.py)."""
    knob = g["variants"][v]
    run = partial(runner.run_policy, "tokenscale", g["trace"], engine=eng)
    if name == "kvtiers_session":
        rep = run(preemption=knob[0], priority_mix=mix,
                  session_prob=g["session_prob"], block_size=g["block_size"],
                  prefix_cache=knob[1], **g["fleet"])
        return {"n_requests": len(rep.requests),
                "n_preemptions": len(rep.preemptions),
                "prefill_tokens": sum(r.src.in_len - r.kv_hit_tokens
                                      for r in rep.requests),
                "kv": rep.kv_summary()}
    if name == "gateway_locality":
        rep = run(preemption="pause-requeue", session_prob=g["session_prob"],
                  block_size=g["block_size"], prefix_cache=True,
                  gateway=knob[0], kv_alloc=knob[1], **g["shared_prefix"],
                  **g["fleet"])
        return {"n_requests": len(rep.requests),
                "ttft_p99": rep.percentile("ttft", 99),
                "slo_attainment": rep.slo_attainment(),
                "avg_gpus": rep.avg_gpus(), "kv": rep.kv_summary(),
                "gw": rep.gw_summary()}
    if name == "deflect_burst":
        rep = run(prefill_chunking=knob, **g["fleet"])
        return {**rep.summary(), "tpot_p99": rep.percentile("tpot", 99),
                "n_deflected": rep.n_deflected}
    if name == "chaos_recovery":
        rep = run(priority_mix=mix, faults=dict(g["faults"], recovery=knob),
                  **CHAOS_KNOBS, **g["fleet"])
        return {**rep.summary(), "class0": rep.class_summary(0),
                "faults": rep.fault_summary()}
    if name == "pareto_coord":
        rep = runner.run_spec(runner.ExperimentSpec.from_dict(
            pareto_specs[(eng, v)]))
        return {**rep.summary(), "cost": rep.cost_summary()}
    raise KeyError(name)


def golden_replay(name, g, runner, pareto_specs=None):
    """Replay golden fixture `g` (tests/golden/`name`.json) through
    `runner` (a package's sim.runner module) as the reference's tests
    replay it.  Returns its rows in the fixture's schema, {engine: row} or
    {engine: {variant: row}}, non-finite floats as None.  pareto_coord's
    pool list is not in its fixture: `pareto_specs` maps (engine, variant)
    to its ExperimentSpec's dict."""
    mix = {int(k): v for k, v in g.get("priority_mix", {}).items()} or None
    out = {}
    for eng in g["engines"]:
        if name == "tokenscale_azure_conv":
            row = runner.run_policy(
                g["policy"], g["trace"], duration=g["duration"],
                rps=g["rps"], seed=g["seed"], engine=eng).summary()
        elif name == "priority_preemption_burstgpt2":
            rep = runner.run_policy(
                g["policy"], g["trace"], model=g["model"], tp=g["tp"],
                duration=g["duration"], rps=g["rps"], seed=g["seed"],
                engine=eng, preemption=g["preemption"],
                max_instances=g["max_instances"], priority_mix=mix)
            row = {"n_requests": len(rep.requests),
                   "n_preemptions": len(rep.preemptions),
                   "classes": {str(c): rep.class_summary(c)
                               for c in rep.priority_classes()}}
        elif name == "hetero_fleet":
            row = runner.run_spec(runner.ExperimentSpec.from_dict(
                {**g["spec"], "engine": eng})).summary()
        else:
            row = {v: _golden_variant(name, g, runner, eng, v, mix,
                                      pareto_specs) for v in g["variants"]}
        out[eng] = _finite(row)
    return out


def golden_deviation(want, got, rel):
    """Hold `got` to fixture rows `want`: floats within `rel` (relative to
    the fixture's value), everything else (counts, key sets, None for a
    non-finite value) exact.  Returns the largest relative deviation of
    a float and the places that fail."""
    worst, bad = 0.0, []

    def walk(w, x, at):
        nonlocal worst
        if isinstance(w, dict):
            if not isinstance(x, dict) or set(w) != set(x):
                bad.append(f"{at}: keys")
                return
            for k in w:
                walk(w[k], x[k], f"{at}/{k}")
        elif isinstance(w, float) and isinstance(x, (int, float)):
            d = abs(x - w) / max(abs(w), 1e-12)
            worst = max(worst, d)
            if d > rel:
                bad.append(f"{at}: {x!r} vs {w!r}")
        elif x != w:
            bad.append(f"{at}: {x!r} vs {w!r}")
    walk(want, got, "")
    return worst, bad


def control_goldens():
    """Part 1 of phase 11: the seven self-contained fixtures through the
    port's simulators, then the policies head to head at the H100
    profile."""
    from repro_torch.sim import runner
    for name in GOLDEN_ON_CARD:
        g = json.loads((GOLDEN / f"{name}.json").read_text())
        t = time.perf_counter()
        got = golden_replay(name, g, runner)
        wall = time.perf_counter() - t
        worst, bad = golden_deviation(
            g["engines"], got, GOLDEN_REL.get(name, GOLDEN_REL_DEFAULT))
        log(f"[control] golden {name}: largest relative deviation "
            f"{worst:.3g}, {len(bad)} places past tolerance; sim wall "
            f"{wall:.2f} s")
        check(not bad, f"control: golden {name} differs at {bad[:4]}")
    t = time.perf_counter()
    reps = runner.compare_policies("mixed", chip="h100", duration=60.0,
                                   rps=8.0)
    wall = time.perf_counter() - t
    log("[control] compare_policies(mixed, 60 s, 8 rps) at the h100 "
        "profile: " + ", ".join(
            f"{n} SLO {100 * r.slo_attainment():.1f}% avg GPUs "
            f"{r.avg_gpus():.2f}" for n, r in reps.items())
        + f"; sim wall {wall:.2f} s")


def control_velocity(figures, card):
    """Part 2 of phase 11: the control plane's Token Velocity profile (an
    analytic roofline of one H100) beside what phases 3, 8, 9 and 17
    measured (phase 17's at its cut depth, the profile of the same cut).
    Printed only (those phases held every transfer to
    hardware.kv_bytes_per_token per rounded token)."""
    from repro_torch.core import CHIPS, InstanceSpec, hardware, profile
    inst = InstanceSpec(CHIPS["h100"], 1)
    log(f"[control] Token Velocity, analytic (H100 roofline, TP 1) vs "
        f"measured on {card}:")
    for arch, f in figures.items():
        cfg = f["cfg"]
        log(f"[control] {arch}: {len(f['transfers'])} transfers, each "
            f"kv_bytes_per_token {hardware.kv_bytes_per_token(cfg):.0f} B "
            f"x rounded length: {f['bytes_ok']}")
        v_p = profile(cfg, inst).v_prefill
        parts = [f"V_P analytic {v_p:.0f} tok/s, the prefiller measured "
                 f"{f['prefill_tok_s']:.0f} (analytic / measured "
                 f"{v_p / f['prefill_tok_s']:.2f})"]
        for kind, what, want in (
                ("decode", "decode step at B=4, ctx 1024",
                 hardware.decode_iter_time(cfg, inst, 4, 1024)),
                ("prefill", "1024-token prefill",
                 hardware.prefill_time(cfg, inst, 1024))):
            got, want = f[kind], 1e3 * want
            parts.append(f"{what} analytic {want:.2f} ms, " + (
                "device and wall not measured" if got is None else
                f"device {got['device_ms']:.2f} ms "
                f"({got['device_ms'] / want:.2f}x), wall "
                f"{got['wall_ms']:.2f} ms ({got['wall_ms'] / want:.2f}x)"))
        log(f"[control] {arch}: " + "; ".join(parts))


def control_convertible(card):
    """Part 3 of phase 11: a full-width Llama-3.1-8B convertible Engine at
    the chunk C that plan_convertible picks for one H100 (4 slots):
    3 requests decoding, then 2 burst prompts of 3000-3800 tokens, the
    second admitted once the first has left chunked mode (an Engine
    chunks one prompt at a time), at max_len CONVERTIBLE_MAX_LEN: a
    prompt's second chunk is cut at the cache's end (phase 2 holds both
    attention kernels against their plain versions at these shapes).
    Every request must complete and a mixed step must run a chunk of
    exactly the planned size; then one mixed step (B=3 decoding, a
    planned-size chunk) under torch.profiler beside Eq. 5's
    prediction."""
    from repro_torch.core import CHIPS, InstanceSpec
    from repro_torch.core.velocity import mixed_iter_time
    from repro_torch.kernels import ops as kops
    from repro_torch.serving import Engine, Request
    cfg, model = full_model("llama31_8b", "control")
    inst = InstanceSpec(CHIPS["h100"], 1)
    plan = convertible_plan(cfg)
    C = plan.chunk_size
    eq5 = {b: 1e3 * mixed_iter_time(cfg, inst, b, PLAN_ARGS["avg_ctx"], C)
           for b in (3, 4)}
    log(f"[control] plan_convertible({cfg.name}, h100 TP 1, {PLAN_ARGS}): "
        f"chunk {C} tokens, V_D^P' {plan.v_prefill:.0f} tok/s; Eq. 5 mixed "
        f"step {eq5[3]:.2f} ms at B=3, {eq5[4]:.2f} ms at B=4 (TPOT SLO "
        "100 ms)")
    rng = np.random.RandomState(0)

    def req(rid, lo, hi, new):
        return Request(rid=rid, prompt=rng.randint(
            0, cfg.vocab_size, size=(int(rng.randint(lo, hi + 1)),)
        ).astype(np.int32), max_new_tokens=new)
    decoding = [req(i, 900, 1150, 16) for i in range(3)]
    bursts = [req(3 + i, 3000, 3800, 8) for i in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()
    # ---- phase 11's engine: counters run from here ...
    t0 = time.perf_counter()
    eng = Engine(cfg, model, num_slots=4, max_len=CONVERTIBLE_MAX_LEN,
                 chunk_size=C)
    for r in decoding:
        eng.add_request(r)
    eng.step()
    chunks = []                                 # (tokens, wall s) a step
    for b in bursts:
        eng.add_request(b)              # waits until a slot frees
        while b.prefill_done < len(b.prompt):
            p, w = eng.pending_chunked, eng.mixed_wall_s
            before = p.prefill_done if p is not None else 0
            eng.step()
            if p is not None:
                chunks.append((p.prefill_done - before, eng.mixed_wall_s - w))
    eng.run_until_drained()
    torch.cuda.synchronize()
    launches = {n: kops.LAUNCHES[n]
                for n in ("chunked_prefill_attention", "decode_attention")}
    SERVED["control"] = dict(kops.PREFILL_SHAPES)
    # ... to here
    wall = time.perf_counter() - t0
    reqs = decoding + bursts
    done = sum(len(r.output) == r.max_new_tokens for r in reqs)
    mean_ms = 1e3 * eng.mixed_wall_s / max(eng.mixed_steps, 1)
    log(f"[control] convertible Engine: requests completed {done}/"
        f"{len(reqs)} in {wall:.1f} s; prompt lengths "
        f"{[len(r.prompt) for r in reqs]}, max_len {eng.max_len}; mixed "
        f"steps {eng.mixed_steps} "
        f"(chunks {[n for n, _ in chunks]}, walls "
        f"{[round(1e3 * s, 1) for _, s in chunks]} ms), mean "
        f"{mean_ms:.2f} ms; decode steps {eng.decode_steps}, mean "
        f"{1e3 * eng.decode_wall_s / max(eng.decode_steps, 1):.2f} ms; "
        f"kernel launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(done == len(reqs), "control: not every request completed")
    check(any(n == C for n, _ in chunks),
          f"control: no mixed step ran a {C}-token chunk: {chunks}")
    check(all(n > 0 for n in launches.values()),
          f"control: launches {launches}")
    # one mixed step under the profiler: 3 decoding, a C-token chunk
    for r in [req(10 + i, 900, 1150, 4) for i in range(3)] \
            + [req(13, 3000, 3800, 2)]:
        eng.add_request(r)
    check(eng.pending_chunked is not None and eng.pending_chunked.rid == 13,
          "control: the profiled step has no chunk")
    wall_us, kinds, n, n_attn = _profiled(eng.step)
    eng.run_until_drained()
    if n == 0:
        log("[control] mixed step breakdown: not measured (the profiler "
            "recorded no device events)")
        return
    per = {k: round(v / 1e3, 3) for k, v in kinds.items()}
    log(f"[control] one mixed step (B=3 decoding + a {C}-token chunk) "
        f"under the profiler, on {card}: wall {wall_us / 1e3:.2f} ms, "
        f"device {sum(kinds.values()) / 1e3:.2f} ms by kind {per}; {n} "
        f"kernels ({n_attn} attention); device idle share "
        f"{1 - sum(kinds.values()) / wall_us:.3f}; Eq. 5 predicts "
        f"{eq5[3]:.2f} ms, the TPOT SLO is 100 ms; unprofiled mixed steps' "
        f"mean wall {mean_ms:.2f} ms")


def phase_control(figures, card):
    """The paper's control plane and both cluster simulators on the card's
    machine (no JAX there), beside the card's own Token Velocities: the
    golden fixtures, the velocity table, and the Convertible Decoder at
    the chunk its planner picks for the card."""
    control_goldens()
    control_velocity(figures, card)
    control_convertible(card)


# ---------------------------------------------------------------------------
# phase 12: training, with gradients through the prefill and WKV6 kernels
# ---------------------------------------------------------------------------

# f32 SMOKE configs and their sequence lengths: gemma2's past its 64-token
# window, jamba's attention layer beside Mamba + MoE, deepseek's MLA (no
# attention kernel), rwkv6's WKV6
TRAIN_SMOKE = [("llama31_8b", 32), ("gemma2_9b", 96), ("rwkv6_3b", 40),
               ("deepseek_v2_lite_16b", 32), ("jamba_v0_1_52b", 40)]
GRAD_TOL = 2e-4          # of each leaf's largest |gradient| (the CPU tests')
# the full-width steps' schedule: no warmup and lr 1e-2, so that a bf16
# leaf of ones (a norm) moves by more than half its 2^-7 step
TRAIN_LR = dict(lr=1e-2, warmup_steps=0)


def _vjp_pair(kernel, plain, inputs, cots):
    """(outputs, gradients) of sum(out * cot) through `kernel` (the
    Function: kernel forward, plain VJP) and through `plain` (autograd of
    the plain version), from the same leaves."""
    res = []
    for fn in (kernel, plain):
        xs = [x.detach().requires_grad_() for x in inputs]
        out = fn(*xs)
        out = out if isinstance(out, tuple) else (out,)
        res.append(([o.detach() for o in out],
                    torch.autograd.grad(out, xs, cots)))
    return res


def _judge_grads(tag, names, res, tol):
    """Each output and gradient of the kernel path within `tol` (the
    reference's close rule) of the plain path's, and each gradient nonzero
    and finite."""
    (ko, kg), (po, pg) = res
    errs = {}
    for name, a, b in [(f"out{i}", x, y) for i, (x, y) in
                       enumerate(zip(ko, po))] + list(zip(names, kg, pg)):
        errs[name] = max_err(a, b)
        ok = close(a, b, tol)
        if name in names:
            ok = ok and bool(torch.isfinite(a).all()) \
                and a.abs().max().item() > 0
        check(ok, f"{tag}: {name} differs from the plain path's, or is "
              f"zero or not finite ({errs[name]:.3g})")
    log(f"[train] {tag}: outputs and gradients within {tol} of the plain "
        f"path's, each gradient nonzero and finite; max |diff| "
        f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} }")


def train_function_grads():
    """Phase 12 (a): the two differentiable wrappers with the kernel in
    their forward against autograd of the plain versions: prefill at
    Llama-3.1-8B's heads (B=1, S=2048) in bf16 and f32, at Gemma-2-9B's
    D = 256 with softcap 50 and a window of 4096 that bites (S=4608), WKV6
    at RWKV-6 3B's heads (S=1024, f32) from a zero and a carried state."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(12)
    for tag, (S, Hq, Hkv, D, window, cap) in (
            ("prefill, Llama heads", (2048, 32, 8, 128, 0, 0.0)),
            ("prefill, Gemma-2 D=256", (4608, 16, 8, 256, 4096, 50.0))):
        for dt in (torch.bfloat16, torch.float32):
            q = _rand(g, (1, S, Hq, D), dt)
            k, v = (_rand(g, (1, S, Hkv, D), dt) for _ in range(2))
            off, lens = i32([0]), i32([S])
            args = dict(window=window, softcap=cap)
            res = _vjp_pair(
                lambda q, k, v: kops.prefill_attention(q, k, v, off, lens,
                                                       **args),
                lambda q, k, v: ref.chunked_prefill_attention_ref(
                    q, k, v, off, lens, **args),
                (q, k, v), (_rand(g, (1, S, Hq, D), dt),))
            _judge_grads(f"{tag}, S={S}, {str(dt)[6:]}", ["dq", "dk", "dv"],
                         res, TOL[dt])
            del res, q, k, v
            torch.cuda.empty_cache()
    for zero in (True, False):
        ins = _wkv_inputs(g, 1, 1024, 40, 64, model_decay=True, s0_zero=zero)
        res = _vjp_pair(kops.wkv6_op, ref.wkv6_chunked, ins,
                        (_rand(g, (1, 1024, 40, 64), torch.float32),
                         _rand(g, (1, 40, 64, 64), torch.float32)))
        _judge_grads(f"WKV6, RWKV-6 3B heads, S=1024, "
                     f"{'zero' if zero else 'carried'} state",
                     ["dr", "dk", "dv", "dw", "du", "ds0"], res, WKV_TOL)


def _noisy_zero_leaves(model, seed):
    """Small noise on the leaves that start at zero (RWKV-6's lora and
    decay up-projections, biases), so that every path carries a
    gradient."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                p.copy_(0.05 * torch.randn(p.shape, generator=g,
                                           device="cuda"))


def train_smoke():
    """Phase 12 (b): f32 SMOKE train steps on the card.  Every leaf's
    gradient through the kernels equals the plain_kernels path's (each
    within GRAD_TOL of the leaf's largest |gradient|), none is missing or
    zero; gemma_2b's loss drops over the reference's loss-drop steps (25
    of 8 x 64), and a checkpoint round trip gives the same next-step
    loss."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models import init_params
    from repro_torch.training import (AdamWConfig, DataConfig, PackedDataset,
                                      adamw_init, lm_loss, make_train_step,
                                      restore, save, train)
    for arch, S in TRAIN_SMOKE:
        cfg = get_config(arch, smoke=True)
        model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
        _noisy_zero_leaves(model, 1)
        model.requires_grad_(True)
        toks, labels = PackedDataset(DataConfig(cfg.vocab_size, S, 2)).batch(0)
        params = list(model.parameters())
        kops.reset_launches()
        lk, _ = lm_loss(cfg, model, toks, labels)
        gk = torch.autograd.grad(lk, params)
        launched = dict(kops.LAUNCHES)
        lp, _ = lm_loss(cfg, model, toks, labels, plain_kernels=True)
        gp = torch.autograd.grad(lp, params)
        check(kops.LAUNCHES == launched,
              f"{arch}: the plain path or a backward launched a kernel")
        shares = [((a - b).abs().max() / b.abs().max()).item()
                  for a, b in zip(gk, gp)]
        zero = sum(b.abs().max().item() == 0 for b in gp)
        finite = all(bool(torch.isfinite(a).all()) for a in gk)
        kernel = {"rwkv6_3b": "wkv6", "deepseek_v2_lite_16b": None}.get(
            arch, "chunked_prefill_attention")
        log(f"[train] {cfg.name} SMOKE f32, B=2 S={S}: loss kernels "
            f"{lk.item():.6f} / plain {lp.item():.6f}; {len(gk)} leaves, "
            f"each present, {zero} zero; largest |diff| / max|grad| of a "
            f"leaf {max(shares):.3g}; launches {launched}")
        check(finite and zero == 0 and max(shares) <= GRAD_TOL
              and abs(lk.item() - lp.item()) <= GRAD_TOL * abs(lp.item()),
              f"{arch}: SMOKE gradients through the kernels")
        check(launched[kernel] > 0 if kernel else
              sum(launched.values()) == 0, f"{arch}: launches {launched}")
    cfg = get_config("gemma_2b", smoke=True)
    t = time.perf_counter()
    params, res = train(cfg, steps=25, batch=8, seq_len=64, log_every=0,
                        device="cuda")
    log(f"[train] {cfg.name} SMOKE, 25 steps of 8 x 64 on the card: loss "
        f"{res.losses[0]:.4f} -> {res.losses[-1]:.4f} in "
        f"{time.perf_counter() - t:.1f} s")
    check(res.losses[-1] < res.losses[0] - 0.2, "gemma_2b loss did not drop")
    opt_cfg = AdamWConfig(total_steps=30, warmup_steps=5)
    toks, labels = PackedDataset(DataConfig(cfg.vocab_size, 64, 8)).batch(25)
    step_fn = make_train_step(cfg, opt_cfg, device="cuda")
    with tempfile.TemporaryDirectory() as d:
        save(d, params, step=res.steps)
        got, step = restore(d, like=params)
    losses = [float(step_fn(p, adamw_init(p, opt_cfg), toks, labels)[2]
                    ["loss"]) for p in (params, got)]
    log(f"[train] checkpoint round trip at step {step}: next-step loss "
        f"{losses[0]!r} / restored {losses[1]!r}")
    check(step == 25 and losses[0] == losses[1],
          "the restored model's next-step loss differs")


def _train_by_kind(prof):
    """Device microseconds of one profiled train step by kind: the prefill
    and WKV6 kernels, the plain backward of attention and of WKV6 (the
    kernels that the host ops inside their autograd nodes launched), the
    optimizer (inside the step's "adamw_update" range), and the rest's
    matmuls and other kernels.  A host op may list a kernel that another
    op with the same correlation id lists too, so each range takes a
    kernel only while the device's own record has one left of that name
    and duration: each kernel counts once.  Also the number of device
    events."""
    import collections

    def kind(name):
        name = name.lower()
        if "prefill_" in name:
            return "prefill kernel"
        if "wkv6_" in name:
            return "wkv6 kernel"
        if any(w in name for w in ("gemm", "gemv", "xmma", "nvjet",
                                   "cutlass", "matmul")):
            return "matmul"
        return "other"

    def under(e):
        # a range timed with CUDA events also lists itself as a kernel of
        # its own name: that is its children's time again, so skip it
        out = [k for k in e.kernels if k.name != e.name]
        for ch in e.cpu_children:
            out += under(ch)
        return out
    ranges = {"_PrefillAttentionBackward": "plain backward attention",
              "_WKV6Backward": "plain backward wkv6",
              "adamw_update": "optimizer"}
    kinds = dict.fromkeys(("prefill kernel", "wkv6 kernel",
                           "plain backward attention", "plain backward wkv6",
                           "optimizer", "matmul", "other"), 0.0)
    # a range of the host's (adamw_update) is also drawn on the device
    # timeline as a user annotation: a span, not a kernel
    left = collections.Counter(
        (e.name, e.time_range.elapsed_us()) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
        and e.name not in ranges)
    n = sum(left.values())
    for e in prof.events():
        label = next((v for k, v in ranges.items() if k in e.name), None)
        parent = e.cpu_parent.name if e.cpu_parent is not None else ""
        if e.device_type != torch.autograd.DeviceType.CPU or label is None \
                or any(k in parent for k in ranges if ranges[k] == label):
            continue
        for k in under(e):
            if left[(k.name, k.duration)] > 0:
                left[(k.name, k.duration)] -= 1
                kinds[label] += k.duration
    for (name, us), count in left.items():
        kinds[kind(name)] += us * count
    return kinds, n


def _leaf_sample(p):
    """Up to 65,536 evenly spaced elements of a leaf, copied."""
    flat = p.detach().reshape(-1)
    return flat[::max(1, flat.numel() // 65536)].clone()


def train_full(arch, seq, steps, opt_over, remat, counter, card,
               every_leaf_moves=True):
    """Phase 12 (c), (d): `steps` train steps of B=1 x `seq` tokens from
    PackedDataset at the config's published widths and depth (bf16, seed
    0), the last one under torch.profiler.  Checks: finite losses and
    grad norms, the `counter` kernel launches, and with
    `every_leaf_moves` every leaf moves."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models import count_params
    from repro_torch.training import (AdamWConfig, DataConfig, PackedDataset,
                                      adamw_init, make_train_step)
    from torch.profiler import ProfilerActivity, profile
    cfg, model = full_model(arch, "train")
    opt_cfg = AdamWConfig(total_steps=steps, **TRAIN_LR, **opt_over)
    ds = PackedDataset(DataConfig(cfg.vocab_size, seq, 1))
    step_fn = make_train_step(cfg, opt_cfg, remat=remat, device="cuda")
    named = dict(model.named_parameters())
    before = {n: _leaf_sample(p) for n, p in named.items()}
    opt = adamw_init(model, opt_cfg)
    torch.cuda.synchronize()
    log(f"[train] {cfg.name}: {opt_cfg}, remat {remat}; params + moments "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB ({card})")
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()
    walls = []
    for i in range(steps):
        toks, labels = ds.batch(i)
        last = i == steps - 1
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) if last \
            else contextlib.nullcontext()
        with prof:
            t = time.perf_counter()
            model, opt, m = step_fn(model, opt, toks, labels)
            loss, gn = float(m["loss"]), float(m["grad_norm"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        walls.append(wall)
        log(f"[train] {cfg.name} step {i}{' (profiled)' if last else ''}: "
            f"wall {wall * 1e3:.1f} ms, loss {loss:.4f}, grad norm "
            f"{gn:.4f}, lr {float(m['lr']):.3e}, {seq / wall:.0f} tokens/s "
            f"({card})")
        check(math.isfinite(loss) and math.isfinite(gn),
              f"{arch}: step {i} not finite")
    launches = dict(kops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    still = [n for n, p in named.items()
             if torch.equal(_leaf_sample(p), before[n])]
    log(f"[train] {cfg.name}: {len(named) - len(still)} of {len(named)} "
        f"leaves moved; peak {peak:.2f} GiB; launches over the {steps} "
        f"steps {launches} ({card})")
    if still:
        log(f"[train] {cfg.name}: leaves that did not move: {still[:8]}"
            f"{' ...' if len(still) > 8 else ''}")
    check(not (every_leaf_moves and still), f"{arch}: leaves did not move")
    check(launches[counter] > 0, f"{arch}: {counter} never launched")
    kinds, n = _train_by_kind(prof)
    wall_us = walls[-1] * 1e6
    busy = sum(kinds.values())
    n_model = count_params(model) - model.embed.numel()
    attn = 3 * 4 * cfg.num_heads * cfg.head_dim_ * seq * (seq + 1) / 2 * sum(
        s.mixer in ("attn", "local_attn") for s in cfg.layer_specs)
    flops = 6 * n_model * seq + (attn if counter != "wkv6" else 0)
    if n == 0:
        log("[train] step breakdown: not measured (the profiler recorded "
            "no device events)")
    else:
        log(f"[profile] {cfg.name} train step B=1 S={seq}: wall "
            f"{walls[-1] * 1e3:.1f} ms under the profiler; device ms by "
            f"kind { {k: round(v / 1e3, 3) for k, v in kinds.items()} }; "
            f"{n} kernels; device idle share {1 - busy / wall_us:.3f} "
            f"({card})")
    steady = float(np.mean(walls[1:-1]))     # after the first, unprofiled
    log(f"[train] {cfg.name}: model FLOPs a step {flops / 1e12:.2f} T "
        f"(6 x {n_model / 1e9:.3f} B non-embedding params x {seq} tokens"
        f"{' + causal attention' if counter != 'wkv6' else ''}); over the "
        f"mean wall of steps 1-{steps - 2}, {steady * 1e3:.1f} ms: "
        f"{flops / steady / 1e12:.1f} TFLOP/s, "
        f"{flops / steady / PEAK_OPS[torch.bfloat16]:.3f} of 989 TFLOP/s; "
        f"profiled step {flops / walls[-1] / 1e12:.1f} TFLOP/s ({card})")
    del model, opt, named, before
    return launches[counter]


def phase_train(card):
    """(a) the differentiable wrappers' gradients on the card, (b) f32
    SMOKE train steps through the kernels against the plain path, (c)
    Llama-3.1-8B and (d) RWKV-6 3B taking train steps at full width."""
    train_function_grads()
    train_smoke()
    launches = {
        "chunked_prefill_attention": train_full(
            "llama31_8b", 2048, 4, dict(moment_dtype="bfloat16",
                                        factored=True), True,
            "chunked_prefill_attention", card)}
    torch.cuda.empty_cache()
    # RWKV-6's decay_B starts at zero, so mu_w has no gradient until it
    # moves: not every leaf moves in 3 steps (the counts are printed)
    launches["wkv6"] = train_full("rwkv6_3b", 1024, 3, {}, False, "wkv6",
                                  card, every_leaf_moves=False)
    log(f"[train] phase 12 launches (not in the kernels line): {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 13: the expert-parallel MoE path over torch.distributed
# ---------------------------------------------------------------------------

EP_RANKS = 4
EP_MESHES = {"prefill": (1, 4), "decode": (2, 2)}    # ("data", "model")
EP_LENGTHS = [256, 201, 97, 230]       # the prompts, padded to 256
EP_STEPS = 4                           # decode steps, teacher-forced
EP_MAX_LEN = 272
EP_NO_DROP_CF = 100.0                  # (a): no (token, k) pair dropped
#: (arch, layers or 0 for all, dtype): DeepSeek-V2-Lite whole; Jamba v0.1
#: cut to one period of its 8-layer block (4 MoE layers of 16 experts, 1
#: attention layer); DeepSeek-V2-Lite's first 8 layers in f32, where the
#: EP path must meet the dense path within 1e-3 (f32 at full depth, 19.6
#: GB a rank, does not fit four ranks on the card)
EP_MODELS = [("deepseek_v2_lite_16b", 0, "bfloat16"),
             ("jamba_v0_1_52b", 8, "bfloat16"),
             ("deepseek_v2_lite_16b", 8, "float32")]
#: the dense path with its experts in f32: the same function in another
#: rounding, the dense path's own spread in bf16
MOE_F32 = ("_moe_dense_path", lambda f: lambda cfg, p, h, top_p, top_i: f(
    cfg, SimpleNamespace(we_gate=p.we_gate.float(), we_up=p.we_up.float(),
                         we_down=p.we_down.float()),
    h.float(), top_p, top_i).to(h.dtype))


def ep_config(arch, layers, dtype, cf=EP_NO_DROP_CF):
    """The published config, cut to `layers` if given, in `dtype`, at
    capacity factor `cf` (None: the config's own)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    if cf is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=cf))
    return cfg.replace(dtype=dtype, param_dtype=dtype)


def ep_name(arch, layers, dtype):
    return f"{arch}{f' ({layers} layers)' if layers else ''}, {dtype}"


def ep_inputs(cfg):
    """The prompts (B, 256) and the teacher-forced decode tokens (steps,
    B), from a seed."""
    rng = np.random.RandomState(13)
    toks = np.zeros((len(EP_LENGTHS), max(EP_LENGTHS)), np.int64)
    for b, L in enumerate(EP_LENGTHS):
        toks[b, :L] = rng.randint(0, cfg.vocab_size, L)
    return toks, rng.randint(0, cfg.vocab_size, (EP_STEPS, len(EP_LENGTHS)))


def ep_decode(cfg, model, state, rows):
    """The teacher-forced decode steps of the prompts' `rows`: each step's
    logits on the host."""
    from repro_torch.models import decode_step
    steps = ep_inputs(cfg)[1]
    cur = np.array(EP_LENGTHS)[rows]
    out = []
    for t in range(EP_STEPS):
        logits, state = decode_step(cfg, model, state, steps[t][rows],
                                    cur + t)
        out.append(logits.float().cpu())
    return out


def ep_prefill(cfg, model, mesh=None, rules=None):
    """The prompts' prefill: (logits on the host, state); under (`mesh`,
    `rules`) the state is this rank's shard (``shard_state``)."""
    from repro_torch.models import init_state, prefill
    from repro_torch.models.params import shard_state
    state = init_state(cfg, len(EP_LENGTHS), EP_MAX_LEN, "cuda")
    if mesh is not None:
        state = shard_state(cfg, state, mesh, rules)
    logits, state = prefill(cfg, model, state, ep_inputs(cfg)[0],
                            EP_LENGTHS)
    return logits.float().cpu(), state


def ep_dense_reference(arch, layers, dtype):
    """The single-process dense path on the same weights (seed 0), whole
    on the card: its logits, and in bf16 its logits with the experts in
    f32 (``MOE_F32``)."""
    from repro_torch.models import count_params, init_params
    from repro_torch.models import ops as mops
    cfg = ep_config(arch, layers, dtype)
    t = time.perf_counter()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")

    def run():
        logits, state = ep_prefill(cfg, model)
        return [logits] + ep_decode(cfg, model, state, slice(None))
    out = {"logits": run()}
    if dtype == "bfloat16":
        attr, stand_in = MOE_F32
        orig = getattr(mops, attr)
        setattr(mops, attr, stand_in(orig))
        try:
            out["f32_experts"] = run()
        finally:
            setattr(mops, attr, orig)
    log(f"[ep] dense {ep_name(arch, layers, dtype)}: "
        f"{count_params(model) / 1e9:.2f}B params, whole on the card, "
        f"{time.perf_counter() - t:.1f} s")
    del model
    torch.cuda.empty_cache()
    return out


def ep_local_experts(model):
    """The shape of this rank's shard of the first MoE layer's we_gate."""
    return tuple(next(layer.we_gate.shape for layer in model.layers
                      if layer.spec.ffn == "moe"))


def _ep_rank(rank, tmpdir, backend):
    """One EP rank on the shared card, for each of EP_MODELS: (a) the
    prefill under mesh (1, 4) at capacity factor 100, then the decode
    steps under (2, 2), the model rebuilt for the weight-stationary layout
    and the prefill's state cut to this rank's rows; (b) the prefill at
    the config's own capacity factor.  Saves what it saw."""
    import datetime
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import InputShape
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import act_rules
    from repro_torch.models import init_params
    from repro_torch.models import ops as mops
    from repro_torch.models.params import shard_state, whole_state
    from repro_torch.sharding import axis_rules

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        backend, store=dist.FileStore(f"{tmpdir}/store", EP_RANKS),
        rank=rank, world_size=EP_RANKS,
        timeout=datetime.timedelta(seconds=600))
    try:
        B = len(EP_LENGTHS)
        meshes = {k: init_device_mesh("cuda", v, mesh_dim_names=(
            "data", "model")) for k, v in EP_MESHES.items()}
        rules = {k: act_rules(InputShape(k, EP_MAX_LEN, B, k),
                              multi_pod=False) for k in EP_MESHES}
        res = []
        for arch, layers, dtype in EP_MODELS:
            torch.cuda.reset_peak_memory_stats()
            kops.reset_launches()
            mops.reset_ep_pairs()
            cfg = ep_config(arch, layers, dtype)
            gen = torch.Generator(device="cuda")
            r = {"walls": {}}
            t0 = time.perf_counter()

            def build(kind):
                t = time.perf_counter()
                mesh, rl = meshes[kind], rules[kind]
                model = init_params(cfg, gen.manual_seed(0), "cuda", mesh,
                                    rl)
                torch.cuda.synchronize()
                r["walls"][f"build_{kind}"] = time.perf_counter() - t
                r[f"experts_{kind}"] = ep_local_experts(model)
                return model, mesh, rl

            model, mesh, rl = build("prefill")
            t = time.perf_counter()
            with axis_rules(rl, mesh):
                logits, state = ep_prefill(cfg, model, mesh, rl)
                state = whole_state(cfg, state, mesh, rl, B, EP_MAX_LEN)
            r["logits"] = [logits]
            r["walls"]["prefill"] = time.perf_counter() - t
            r["pairs_prefill"] = [int(mops.EP_PAIRS[k]) for k in
                                  ("routed", "dropped")]
            del model
            torch.cuda.empty_cache()
            # the decode layout: experts over "model", their d_ff over
            # "data"; this rank's cut of the prefill's state, gathered
            # whole from the prefill's mesh
            model, mesh, rl = build("decode")
            state = shard_state(cfg, state, mesh, rl)
            d, n = mesh.get_coordinate()[0], EP_MESHES["decode"][0]
            r["rows"] = (d * B // n, (d + 1) * B // n)
            t = time.perf_counter()
            mops.reset_ep_pairs()
            with axis_rules(rl, mesh):
                r["logits"] += ep_decode(cfg, model, state,
                                         slice(*r["rows"]))
            r["walls"]["decode"] = time.perf_counter() - t
            del model, state
            r["pairs_decode"] = [int(mops.EP_PAIRS[k]) for k in
                                 ("routed", "dropped")]
            r["launches"] = dict(kops.LAUNCHES)
            r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.empty_cache()
            # (b) the config's own capacity factor, in the prefill layout
            model, mesh, rl = build("prefill")
            t = time.perf_counter()
            mops.reset_ep_pairs()
            with axis_rules(rl, mesh):
                r["prefill_b"], _ = ep_prefill(
                    ep_config(arch, layers, dtype, None), model, mesh, rl)
            r["pairs_b"] = [int(mops.EP_PAIRS[k]) for k in
                            ("routed", "dropped")]
            r["walls"]["prefill_b"] = time.perf_counter() - t
            r["wall"] = time.perf_counter() - t0
            del model
            torch.cuda.empty_cache()
            res.append(r)
        torch.save(res, f"{tmpdir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def ep_rows(logits_by_rank, ref):
    """Every rank's rows and the dense path's same rows, stacked: (the
    prefill's, the decode steps')."""
    pre = [torch.cat([r["logits"][0] for r in logits_by_rank]),
           torch.cat([ref[0]] * len(logits_by_rank))]
    dec = [torch.cat([x for r in logits_by_rank for x in r["logits"][1:]]),
           torch.cat([w[slice(*r["rows"])] for r in logits_by_rank
                      for w in ref[1:]])]
    return pre, dec


def ep_compare(got, want, name, what):
    """(largest |diff| over the largest |want|, rows whose argmax agree,
    rows, finite), logged."""
    share = ((got - want).abs().max() / want.abs().max()).item()
    same = int((got.argmax(-1) == want.argmax(-1)).sum())
    finite = bool(torch.isfinite(got).all())
    log(f"[ep] {name}: {what}: max abs diff / max |logit| {share:.4g}, "
        f"argmax equal in {same} of {got.shape[0]} rows, finite {finite}")
    return share, same, got.shape[0], finite


def phase_ep():
    """The expert-parallel MoE path (``models.ops._moe_ep_path``) over 4
    ranks that share the one card, gloo between them (NCCL refuses two
    ranks on one device).  This phase holds the path's results, not its
    speed: 4 ranks on one card are no EP deployment."""
    import tempfile
    import torch.multiprocessing as tmp
    backend = "gloo"
    t0 = time.perf_counter()
    refs = [ep_dense_reference(*m) for m in EP_MODELS]
    log(f"[ep] dense references in {time.perf_counter() - t0:.1f} s")
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmpdir:
        try:
            tmp.start_processes(_ep_rank, args=(tmpdir, backend),
                                nprocs=EP_RANKS, join=True,
                                start_method="spawn")
        except tmp.ProcessException as e:
            raise PhaseFailed(f"ep: a rank failed: {e}")
        ranks = [torch.load(f"{tmpdir}/rank{r}.pt")
                 for r in range(EP_RANKS)]
    log(f"[ep] backend {backend}, {EP_RANKS} ranks on one card, meshes "
        f"(data, model): prefill {EP_MESHES['prefill']}, decode "
        f"{EP_MESHES['decode']}; the ranks' wall "
        f"{time.perf_counter() - t:.1f} s (4 ranks sharing one card: not an "
        f"EP speed)")
    for i, (arch, layers, dtype) in enumerate(EP_MODELS):
        cfg = ep_config(arch, layers, dtype)
        name = ep_name(arch, layers, dtype)
        rs = [r[i] for r in ranks]
        log(f"[ep] {name}: a rank's we_gate shard: prefill "
            f"{rs[0]['experts_prefill']}, decode {rs[0]['experts_decode']}; "
            f"peak GiB by rank {[round(r['peak_gib'], 2) for r in rs]}")
        for k, r in enumerate(rs):
            log(f"[ep] {name}: rank {k} walls (s) "
                f"{ {w: round(v, 2) for w, v in r['walls'].items()} }, "
                f"{r['wall']:.1f} in all")
        n_moe = sum(spec.ffn == "moe" for spec in cfg.layer_specs)
        routed, dropped = (sum(r["pairs_prefill"][j] for r in rs)
                           for j in (0, 1))
        dec = [sum(r["pairs_decode"][j] for r in rs) for j in (0, 1)]
        log(f"[ep] {name}: (a) capacity factor {EP_NO_DROP_CF}: prefill "
            f"{dropped} of {routed} pairs dropped, decode {dec[1]} of "
            f"{dec[0]}")
        check(dropped == dec[1] == 0 and routed == len(EP_LENGTHS)
              * max(EP_LENGTHS) * cfg.moe.top_k * n_moe,
              f"{name}: (a) pairs dropped or lost")
        pre, dec = ep_rows(rs, refs[i]["logits"])
        errs = [ep_compare(*pre, name, "(a) prefill, EP vs dense"),
                ep_compare(*dec, name, f"(a) {EP_STEPS} decode steps, EP vs "
                           "dense")]
        share = max(e[0] for e in errs)
        agree = all(e[1] == e[2] and e[3] for e in errs)
        if dtype == "float32":
            check(agree and share <= 1e-3,
                  f"{name}: f32 EP logits not within 1e-3 of the dense path")
        else:
            own = ep_compare(torch.cat(refs[i]["f32_experts"]),
                             torch.cat(refs[i]["logits"]), name,
                             "the dense path with its experts in f32 vs bf16")
            rule = agree and share <= 0.05
            log(f"[ep] {name}: phase 3's rule (0.05, same argmax) "
                f"{'holds' if rule else 'fails'} for EP vs dense; the dense "
                f"path against itself is "
                f"{'outside' if own[0] > 0.05 else 'within'} it")
            check(rule or (own[0] > 0.05 and all(e[3] for e in errs)),
                  f"{name}: EP logits outside phase 3's rule")
        routed, dropped = (sum(r["pairs_b"][j] for r in rs) for j in (0, 1))
        finite = all(torch.isfinite(r["prefill_b"]).all() for r in rs)
        log(f"[ep] {name}: (b) capacity factor "
            f"{ep_config(arch, layers, dtype, None).moe.capacity_factor}: "
            f"{dropped} of {routed} prefill (token, k) pairs dropped, share "
            f"{dropped / routed:.4f}; logits finite {finite}")
        check(finite, f"{name}: (b) logits not finite")
        launches = [r["launches"] for r in rs]
        log(f"[ep] {name}: attention kernel launches by rank "
            f"{[{k: v for k, v in n.items() if v} for n in launches]}")
        if not cfg.kv_lora_rank:
            # decode with the cache over "ctx" takes the rank-slice entry
            check(all(n["chunked_prefill_attention"] > 0
                      and n["decode_attention_partial"] > 0
                      for n in launches),
                  f"{name}: the attention kernels did not launch under EP")
    log(f"[ep] phase wall {time.perf_counter() - t0:.1f} s (4 ranks sharing "
        f"one card: not an EP speed)")



# ---------------------------------------------------------------------------
# phase 15: tensor parallelism and the decode cache split over "ctx"
# ---------------------------------------------------------------------------

TP_RANKS = 4
TP_LENGTHS = [1536, 700, 64, 1100]     # (a), (c): the prompts, padded
TP_MAX_LEN = 2048                      # 512 positions a rank's slice
TP_STEPS = 8                           # decode steps, teacher-forced
TP_LONG = 32768                        # (b): one prompt
TP_LONG_MAX = TP_LONG + 256            # 8256 positions a rank's slice
#: (name, arch, layers or 0 for all, dtype, mesh ("data", "model"), the
#: rules' batch): (a) Llama-3.1-8B whole in bf16 and its first 8 layers in
#: f32, (b) the B = 1 long context, (c) Qwen-2.5-32B's first 16 of 64
#: layers (its 40 q / 8 kv heads give each of 4 ranks 10 / 2, G = 5)
TP_CASES = [("llama", "llama31_8b", 0, "bfloat16", (1, 4), 4),
            ("llama_f32", "llama31_8b", 8, "float32", (1, 4), 4),
            ("llama_long", "llama31_8b", 0, "bfloat16", (2, 2), 1),
            ("qwen", "qwen25_32b", 16, "bfloat16", (1, 4), 4)]


def tp_config(arch, layers, dtype):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    return cfg.replace(dtype=dtype, param_dtype=dtype)


def tp_inputs(cfg, batch):
    """The prompts (B, S) and lengths, and the teacher-forced decode tokens
    (steps, B), from a seed: (a) / (c) TP_LENGTHS, (b) one prompt of
    TP_LONG."""
    rng = np.random.RandomState(15)
    lens = [TP_LONG] if batch == 1 else TP_LENGTHS
    toks = np.zeros((len(lens), max(lens)), np.int64)
    for b, L in enumerate(lens):
        toks[b, :L] = rng.randint(0, cfg.vocab_size, L)
    return toks, np.array(lens), rng.randint(0, cfg.vocab_size,
                                             (TP_STEPS, len(lens)))


def tp_decode(cfg, model, state, steps, lens, plain=False):
    """The teacher-forced decode steps: each step's logits on the host."""
    from repro_torch.models import decode_step
    out = []
    for t in range(TP_STEPS):
        logits, state = decode_step(cfg, model, state, steps[t], lens + t,
                                    plain_kernels=plain)
        out.append(logits.float().cpu())
    return out


def tp_reference(case, tmpdir):
    """The single process on the same weights (seed 0), whole on the card:
    prefill and decode steps through the kernels, and (bf16) the same
    through the plain versions (the path's own spread in another rounding;
    for (b) its decode steps from a copy of the prefill's cache).  (b)
    writes its prefill's cache to `tmpdir`, whence the ranks cut it."""
    from repro_torch.models import init_params, init_state, prefill
    name, arch, layers, dtype, _, batch = case
    cfg = tp_config(arch, layers, dtype)
    t = time.perf_counter()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    toks, lens, steps = tp_inputs(cfg, batch)
    max_len = TP_LONG_MAX if batch == 1 else TP_MAX_LEN
    out = {}
    logits, state = prefill(cfg, model, init_state(cfg, len(lens), max_len,
                                                   "cuda"), toks, lens)
    if batch == 1:
        torch.save([{n: v.cpu() for n, v in st.items()} for st in state],
                   f"{tmpdir}/long_state.pt")
        spare = [{n: v.clone() for n, v in st.items()} for st in state]
    out["logits"] = [logits.float().cpu()] + tp_decode(cfg, model, state,
                                                       steps, lens)
    if dtype == "bfloat16":
        if batch == 1:
            out["plain"] = out["logits"][:1] + tp_decode(
                cfg, model, spare, steps, lens, plain=True)
            del spare
        else:
            pl, state = prefill(cfg, model, init_state(
                cfg, len(lens), max_len, "cuda"), toks, lens,
                plain_kernels=True)
            out["plain"] = [pl.float().cpu()] + tp_decode(
                cfg, model, state, steps, lens, plain=True)
    del model, state
    torch.cuda.empty_cache()
    log(f"[tp] {name}: single process in {time.perf_counter() - t:.1f} s")
    return out


def _tp_rank(rank, tmpdir, backend):
    """One rank on the shared card, for each of TP_CASES: the model built
    with its heads, d_ff and vocab over "model" (each leaf drawn whole,
    cut), the cache over "ctx" (``shard_state``: for (b) of the single
    process's prefill, read from disk), then the prefill (not (b)) and the
    decode steps under the case's rules.  Saves what it saw."""
    import datetime
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import InputShape
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import act_rules, param_rules
    from repro_torch.models import init_params, init_state, prefill
    from repro_torch.models.params import shard_state
    from repro_torch.sharding import axis_rules

    torch.cuda.set_device(0)
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        backend, store=dist.FileStore(f"{tmpdir}/store", TP_RANKS),
        rank=rank, world_size=TP_RANKS,
        timeout=datetime.timedelta(seconds=600))
    try:
        res = []
        meshes = {}
        for name, arch, layers, dtype, shape, batch in TP_CASES:
            if shape not in meshes:
                meshes[shape] = init_device_mesh("cuda", shape,
                                                 mesh_dim_names=("data",
                                                                 "model"))
            mesh = meshes[shape]
            torch.cuda.reset_peak_memory_stats()
            kops.reset_launches()
            cfg = tp_config(arch, layers, dtype)
            max_len = TP_LONG_MAX if batch == 1 else TP_MAX_LEN
            kind = InputShape("decode", max_len, batch, "decode")
            rules_a = act_rules(kind, False)
            rules_p = param_rules(cfg, kind, False)
            toks, lens, steps = tp_inputs(cfg, batch)
            r = {"walls": {}}
            t0 = t = time.perf_counter()
            model = init_params(cfg, torch.Generator(
                device="cuda").manual_seed(0), "cuda", mesh, rules_p)
            r["wq"] = tuple(model.layers[0].wq.shape)
            torch.cuda.synchronize()
            r["walls"]["build"] = time.perf_counter() - t
            t = time.perf_counter()
            if batch == 1:
                whole = torch.load(f"{tmpdir}/long_state.pt", mmap=True)
                state = [{n: v.to("cuda") for n, v in st.items()}
                         for st in shard_state(cfg, whole, mesh, rules_a)]
                del whole
                r["logits"] = []
            else:
                state = shard_state(cfg, init_state(cfg, len(lens), max_len,
                                                    "cuda"), mesh, rules_a)
            r["cache"] = tuple(state[0]["k"].shape)
            r["walls"]["cache"] = time.perf_counter() - t
            with axis_rules(rules_a, mesh):
                if batch > 1:
                    t = time.perf_counter()
                    logits, state = prefill(cfg, model, state, toks, lens)
                    r["logits"] = [logits.float().cpu()]
                    r["walls"]["prefill"] = time.perf_counter() - t
                t = time.perf_counter()
                r["logits"] += tp_decode(cfg, model, state, steps, lens)
                r["walls"]["decode"] = time.perf_counter() - t
            r["launches"] = dict(kops.LAUNCHES)
            r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            r["wall"] = time.perf_counter() - t0
            del model, state
            torch.cuda.empty_cache()
            res.append(r)
        torch.save(res, f"{tmpdir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def tp_compare(got, want, name, what, tag="tp"):
    """(largest |diff| over the largest |want|, rows whose argmax agree,
    rows, finite), logged.  A row's argmax agrees where it is `want`'s, or
    where `want` has a near tie there: its logit at `got`'s argmax within
    twice the row's largest |diff| of its maximum (teacher-forced rows of
    many steps meet such ties; a rounding may pick either side)."""
    diff = (got - want).abs()
    share = (diff.max() / want.abs().max()).item()
    exact = got.argmax(-1) == want.argmax(-1)
    at = want.gather(-1, got.argmax(-1, keepdim=True))[:, 0]
    tie = ~exact & (want.max(-1).values - at <= 2 * diff.max(-1).values)
    same = int((exact | tie).sum())
    finite = bool(torch.isfinite(got).all())
    log(f"[{tag}] {name}: {what}: max abs diff / max |logit| {share:.4g}, "
        f"argmax equal in {int(exact.sum())} of {got.shape[0]} rows"
        f"{f' and a near tie in {int(tie.sum())}' if tie.any() else ''}, "
        f"finite {finite}")
    return share, same, got.shape[0], finite


def phase_tp():
    """Tensor parallelism over "model" and the decode cache split over
    "ctx" (``models.ops._apply_attn_tp``) on 4 ranks that share the one
    card, gloo between them (NCCL refuses two ranks on one device).  This
    phase holds the path's results, not its speed: 4 ranks on one card are
    no TP deployment.  Returns the launches of the rank-slice decode entry
    point (every rank's, summed) for the kernels line."""
    import tempfile
    import torch.multiprocessing as tmp
    from torch.multiprocessing.spawn import ProcessException
    backend = "gloo"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmpdir:
        refs = [tp_reference(c, tmpdir) for c in TP_CASES]
        log(f"[tp] single-process references in "
            f"{time.perf_counter() - t0:.1f} s")
        t = time.perf_counter()
        try:
            tmp.start_processes(_tp_rank, args=(tmpdir, backend),
                                nprocs=TP_RANKS, join=True,
                                start_method="spawn")
        except ProcessException as e:
            raise PhaseFailed(f"tp: a rank failed: {e}")
        ranks = [torch.load(f"{tmpdir}/rank{r}.pt")
                 for r in range(TP_RANKS)]
    log(f"[tp] backend {backend}, {TP_RANKS} ranks on one card; the ranks' "
        f"wall {time.perf_counter() - t:.1f} s (4 ranks sharing one card: "
        f"not a TP speed)")
    partial = 0
    for i, (name, arch, layers, dtype, shape, batch) in enumerate(TP_CASES):
        rs = [r[i] for r in ranks]
        label = (f"{arch}{f' ({layers} layers)' if layers else ''}, {dtype},"
                 f" mesh {shape}, batch {batch}")
        log(f"[tp] {label}: a rank's wq {rs[0]['wq']}, cache "
            f"{rs[0]['cache']}; peak GiB by rank "
            f"{[round(r['peak_gib'], 2) for r in rs]}")
        for k, r in enumerate(rs):
            log(f"[tp] {label}: rank {k} walls (s) "
                f"{ {w: round(v, 2) for w, v in r['walls'].items()} }, "
                f"{r['wall']:.1f} in all; launches "
                f"{ {n: v for n, v in r['launches'].items() if v} }")
        # every rank holds the same rows, the whole batch; (b)'s ranks
        # decode from the single process's prefill
        first = 1 if batch == 1 else 0
        want = torch.cat(refs[i]["logits"][first:])
        errs = [tp_compare(torch.cat(r["logits"]), want, label,
                           f"rank {k} vs the single process")
                for k, r in enumerate(rs)]
        share = max(e[0] for e in errs)
        agree = all(e[1] == e[2] and e[3] for e in errs)
        if dtype == "float32":
            check(agree and share <= 1e-3,
                  f"{label}: f32 TP logits not within 1e-3 of the single "
                  "process")
        else:
            own = tp_compare(torch.cat(refs[i]["plain"][first:]), want,
                             label,
                             "the single process's plain path vs its "
                             "kernels")
            rule = agree and share <= 0.05
            outside = own[0] > 0.05 or own[1] < own[2]
            log(f"[tp] {label}: phase 3's rule (0.05, same argmax) "
                f"{'holds' if rule else 'fails'} for TP vs the single "
                f"process; the single process against itself is "
                f"{'outside' if outside else 'within'} it")
            check(rule or (outside and all(e[3] for e in errs)),
                  f"{label}: TP logits outside phase 3's rule")
        launched = [r["launches"] for r in rs]
        check(all(n["decode_attention_partial"] > 0 for n in launched)
              and all(n["chunked_prefill_attention"] > 0 for n in launched
                      if batch > 1),
              f"{label}: a rank did not launch the prefill kernel and the "
              "rank-slice decode entry point")
        partial += sum(n["decode_attention_partial"] for n in launched)
    log(f"[tp] phase wall {time.perf_counter() - t0:.1f} s (4 ranks sharing "
        f"one card: not a TP speed)")
    return partial


# ---------------------------------------------------------------------------
# phase 16: tensor parallelism for the rest of the zoo, FSDP of "embed"
# ---------------------------------------------------------------------------

ZOO_RANKS = 4
ZOO_LENGTHS = [1536, 700, 64, 1100]    # the prompts, padded to 1536
ZOO_MAX_LEN = 1600                     # 400 positions a rank of "model" 4
ZOO_STEPS = 8                          # decode steps, teacher-forced
#: the serving cases: (name, arch, layers or 0 for all, dtype, mesh
#: ("data", "model"), FSDP in the prefill's param table): (a) RWKV-6 3B
#: whole (10 of its 40 heads a rank) and its first 8 layers in f32; (b)
#: Llama-3.2-Vision 11B whole with images (8 q / 2 kv heads a rank in its
#: cross-attention); (c) Jamba v0.1's first 8-layer period with "embed"
#: over "data" in the prefill, the decode table's model after it
ZOO_SERVE = [("rwkv", "rwkv6_3b", 0, "bfloat16", (1, 4), False),
             ("rwkv_f32", "rwkv6_3b", 8, "float32", (1, 4), False),
             ("vision", "llama_3_2_vision_11b", 0, "bfloat16", (1, 4),
              False),
             ("jamba", "jamba_v0_1_52b", 8, "bfloat16", (2, 2), True)]
#: (d) the train cases: Qwen-2.5-32B's first 4 of 64 layers (its train_4k
#: needs FSDP) in bf16 and 2 in f32 under (2, 2): FSDP and TP, remat, bf16
#: factored moments (C8), 2 steps of 2 x 512 tokens.  Every step gathers a
#: rank's FSDP shards through gloo on the host: ~20 s a step at 8 / 4
#: layers on an H100 (NVIDIA H100 80GB HBM3, 700 W), which the phase's
#: ~150 s cannot hold
ZOO_TRAIN = [("qwen_train", "qwen25_32b", 4, "bfloat16", (2, 2)),
             ("qwen_train_f32", "qwen25_32b", 2, "float32", (2, 2))]
ZOO_TRAIN_SHAPE = (2, 512)
ZOO_TRAIN_STEPS = 2
ZOO_LR = 1e-3


def zoo_inputs(cfg):
    """The prompts (B, S), lengths and teacher-forced decode tokens (steps,
    B), from a seed."""
    rng = np.random.RandomState(16)
    toks = np.zeros((len(ZOO_LENGTHS), max(ZOO_LENGTHS)), np.int64)
    for b, L in enumerate(ZOO_LENGTHS):
        toks[b, :L] = rng.randint(0, cfg.vocab_size, L)
    return toks, np.array(ZOO_LENGTHS), rng.randint(
        0, cfg.vocab_size, (ZOO_STEPS, len(ZOO_LENGTHS)))


def zoo_images(cfg):
    """An image a prompt, (B, num_vision_tokens, d_model), or None."""
    if not cfg.num_vision_tokens:
        return None
    return torch.stack([image(cfg, 16 + b) for b in range(len(ZOO_LENGTHS))])


def zoo_opt():
    from repro_torch.training import AdamWConfig
    return AdamWConfig(lr=ZOO_LR, warmup_steps=0, total_steps=10,
                       factored=True, moment_dtype="bfloat16")


def zoo_batches(cfg):
    """The train steps' (tokens, labels), from a seed."""
    rng = np.random.RandomState(17)
    return [tuple(torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                               ZOO_TRAIN_SHAPE))
                  for _ in range(2)) for _ in range(ZOO_TRAIN_STEPS)]


def zoo_compared(cfg):
    """The leaves (d) holds against the single process: every leaf of the
    first and the last layer, and the final norm; but the key bias, whose
    gradient is zero in exact arithmetic (a softmax does not move when the
    same q . b is added to every score of a row), so that Adam's update of
    it is rounding noise over its own scale, on either side."""
    last = cfg.num_layers - 1
    return lambda n: n == "final_norm" or (
        n.startswith(("layers.0.", f"layers.{last}."))
        and not n.endswith(".bk"))


def zoo_serve(cfg, model, state, toks, lens, steps, img, plain=False):
    """The single process's prefill, then the teacher-forced decode steps:
    each one's logits on the host."""
    from repro_torch.models import decode_step, prefill
    logits, state = prefill(cfg, model, state, toks, lens, img,
                            plain_kernels=plain)
    out = [logits.float().cpu()]
    for t in range(ZOO_STEPS):
        logits, state = decode_step(cfg, model, state, steps[t], lens + t,
                                    plain_kernels=plain)
        out.append(logits.float().cpu())
    return out


def zoo_single(case):
    """The single process of a serving case, whole on the card: through
    the kernels, and (bf16) through the plain versions and, for an MoE
    arch, with its experts in f32 (the path's own spread in other
    roundings)."""
    from repro_torch.models import init_params, init_state
    from repro_torch.models import ops as mops
    name, arch, layers, dtype, _, _ = case
    cfg = tp_config(arch, layers, dtype)
    t = time.perf_counter()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    if cfg.num_vision_tokens:
        open_cross_gates(model)
    toks, lens, steps = zoo_inputs(cfg)
    img = zoo_images(cfg)

    def run(plain=False):
        return zoo_serve(cfg, model, init_state(cfg, len(lens), ZOO_MAX_LEN,
                                                "cuda"),
                         toks, lens, steps, img, plain)
    out = {"logits": run()}
    if dtype == "bfloat16":
        out["plain"] = run(plain=True)
        if cfg.moe is not None:
            attr, stand_in = MOE_F32
            orig = getattr(mops, attr)
            setattr(mops, attr, stand_in(orig))
            try:
                out["f32_experts"] = run()
            finally:
                setattr(mops, attr, orig)
    del model
    torch.cuda.empty_cache()
    log(f"[zoo] {name}: single process in {time.perf_counter() - t:.1f} s")
    return out


def zoo_train(cfg, model, rows=slice(None), rules=None, mesh=None):
    """ZOO_TRAIN_STEPS steps of `model` (remat, zoo_opt): (losses, the
    compared leaves on the host, walls)."""
    from repro_torch.sharding import axis_rules
    from repro_torch.training import adamw_init, make_train_step
    opt = adamw_init(model, zoo_opt())
    step = make_train_step(cfg, zoo_opt(), remat=True, device="cuda")
    losses, walls = [], []
    with axis_rules(rules or {}, mesh):
        for toks, labels in zoo_batches(cfg):
            t = time.perf_counter()
            model, opt, m = step(model, opt, toks[rows], labels[rows])
            losses.append(float(m["loss"]))
            walls.append(time.perf_counter() - t)
    keep = zoo_compared(cfg)
    return losses, {n: q.detach().cpu() for n, q in model.named_parameters()
                    if keep(n)}, walls


def zoo_train_single(case):
    from repro_torch.models import init_params
    name, arch, layers, dtype, _ = case
    cfg = tp_config(arch, layers, dtype)
    t = time.perf_counter()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    losses, leaves, _ = zoo_train(cfg, model)
    del model
    torch.cuda.empty_cache()
    log(f"[zoo] {name}: single process's {ZOO_TRAIN_STEPS} steps in "
        f"{time.perf_counter() - t:.1f} s, losses {losses}")
    return {"losses": losses, "leaves": leaves}


def _zoo_rank(rank, tmpdir, backend):
    """One rank on the shared card: each serving case built under the
    reference's param table (only this rank's shards, seed 0), the state
    cut by ``shard_state``, the prefill under the prefill's act table and
    the decode steps under the decode's (with the decode table's model
    where the two param tables differ: FSDP); each train case's steps
    under the train tables with FSDP.  Saves what it saw."""
    import datetime
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import InputShape
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import act_rules, param_rules
    from repro_torch.models import (decode_step, init_params, init_state,
                                    prefill)
    from repro_torch.models.params import shard_state
    from repro_torch.sharding import axis_rules

    torch.cuda.set_device(0)
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        backend, store=dist.FileStore(f"{tmpdir}/store", ZOO_RANKS),
        rank=rank, world_size=ZOO_RANKS,
        timeout=datetime.timedelta(seconds=600))
    try:
        res, meshes = {}, {}

        def mesh_of(shape):
            if shape not in meshes:
                meshes[shape] = init_device_mesh(
                    "cuda", shape, mesh_dim_names=("data", "model"))
            return meshes[shape]

        def rows_of(mesh, n):
            d = mesh.get_coordinate()[0]
            return slice(d * n // mesh.shape[0], (d + 1) * n // mesh.shape[0])

        for name, arch, layers, dtype, shape, fsdp in ZOO_SERVE:
            mesh = mesh_of(shape)
            torch.cuda.reset_peak_memory_stats()
            kops.reset_launches()
            cfg = tp_config(arch, layers, dtype)
            toks, lens, steps = zoo_inputs(cfg)
            B = len(lens)
            sp = InputShape("prefill", ZOO_MAX_LEN, B, "prefill")
            sd = InputShape("decode", ZOO_MAX_LEN, B, "decode")
            rows = rows_of(mesh, B)
            img = zoo_images(cfg)
            r = {"walls": {}, "rows": (rows.start, rows.stop)}
            t0 = t = time.perf_counter()

            def build(table):
                model = init_params(cfg, torch.Generator(
                    device="cuda").manual_seed(0), "cuda", mesh, table)
                if cfg.num_vision_tokens:
                    open_cross_gates(model)
                return model
            model = build(param_rules(cfg, sp, False, fsdp=fsdp))
            r["shards"] = {n: tuple(q.shape) for n, q in
                           model.layers[0].named_parameters()}
            state = shard_state(cfg, init_state(cfg, B, ZOO_MAX_LEN, "cuda"),
                                mesh, act_rules(sp, False))
            r["state"] = {n: tuple(v.shape) for n, v in state[0].items()}
            torch.cuda.synchronize()
            r["walls"]["build"] = time.perf_counter() - t
            t = time.perf_counter()
            with axis_rules(act_rules(sp, False), mesh):
                logits, state = prefill(cfg, model, state, toks[rows],
                                        lens[rows],
                                        None if img is None else img[rows])
            r["logits"] = [logits.float().cpu()]
            r["prefill_launches"] = dict(kops.LAUNCHES)
            r["walls"]["prefill"] = time.perf_counter() - t
            if param_rules(cfg, sd, False) != model.shard_rules:
                del model
                torch.cuda.empty_cache()
                t = time.perf_counter()
                model = build(param_rules(cfg, sd, False))
                r["walls"]["build_decode"] = time.perf_counter() - t
            t = time.perf_counter()
            with axis_rules(act_rules(sd, False), mesh):
                for k in range(ZOO_STEPS):
                    logits, state = decode_step(cfg, model, state,
                                                steps[k][rows],
                                                lens[rows] + k)
                    r["logits"].append(logits.float().cpu())
            r["walls"]["decode"] = time.perf_counter() - t
            r["launches"] = dict(kops.LAUNCHES)
            r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            r["wall"] = time.perf_counter() - t0
            del model, state
            torch.cuda.empty_cache()
            res[name] = r
        for name, arch, layers, dtype, shape in ZOO_TRAIN:
            mesh = mesh_of(shape)
            torch.cuda.reset_peak_memory_stats()
            kops.reset_launches()
            cfg = tp_config(arch, layers, dtype)
            st = InputShape("train", ZOO_TRAIN_SHAPE[1], ZOO_TRAIN_SHAPE[0],
                            "train")
            table = param_rules(cfg, st, False, fsdp=True)
            t0 = time.perf_counter()
            model = init_params(cfg, torch.Generator(
                device="cuda").manual_seed(0), "cuda", mesh, table)
            build = time.perf_counter() - t0
            losses, leaves, walls = zoo_train(
                cfg, model, rows_of(mesh, ZOO_TRAIN_SHAPE[0]),
                act_rules(st, False), mesh)
            res[name] = {"losses": losses, "leaves": leaves,
                         "walls": {"build": build,
                                   **{f"step{k}": w
                                      for k, w in enumerate(walls)}},
                         "launches": dict(kops.LAUNCHES),
                         "peak_gib": torch.cuda.max_memory_allocated()
                         / 2**30,
                         "wall": time.perf_counter() - t0,
                         "coord": tuple(mesh.get_coordinate()),
                         "table": table}
            del model
            torch.cuda.empty_cache()
        torch.save(res, f"{tmpdir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def zoo_leaf_shares(got, want, cfg, table, shape, coord):
    """For each compared leaf, the largest |diff| of a rank's shard against
    the single process's whole leaf, over the leaf's largest |value|."""
    from repro_torch.models.params import param_axes
    from repro_torch.sharding import local_slices, logical_to_pspec
    sm = SimpleNamespace(mesh_dim_names=("data", "model"), shape=shape)
    axes = param_axes(cfg)
    out = {}
    for n, w in want.items():
        spec = logical_to_pspec(axes[n], table, tuple(w.shape), sm)
        cut = w[local_slices(tuple(w.shape), spec, sm,
                             dict(zip(("data", "model"), coord)))]
        check(tuple(got[n].shape) == tuple(cut.shape),
              f"{n}: shard {tuple(got[n].shape)}, want {tuple(cut.shape)}")
        out[n] = ((got[n].float() - cut.float()).abs().max()
                  / w.float().abs().max().clamp(min=1e-30)).item()
    return out


def zero_init(cfg):
    """The names of the leaves that start at zero (the q / v biases)."""
    from repro_torch.models.params import abstract_params
    model = abstract_params(cfg)
    return {f"layers.{i}.{n}" for i, layer in enumerate(model.layers)
            for n, lf in layer.leaves.items() if lf.init == "zeros"}


def phase_zoo():
    """Tensor parallelism for the rest of the zoo (RWKV-6, Mamba, MLA's
    phase-13 run aside, cross-attention, the MoE archs' non-expert leaves)
    and FSDP of "embed", under the reference's own rule tables, on 4
    ranks that share the one card, gloo between them.  This phase holds
    the path's results, not its speed: 4 ranks on one card are no TP
    deployment.  Returns the WKV6 launches of (a) (every rank's, summed)
    for the kernels line."""
    import tempfile
    import torch.multiprocessing as tmp
    from torch.multiprocessing.spawn import ProcessException
    backend = "gloo"
    t0 = time.perf_counter()
    refs = {c[0]: zoo_single(c) for c in ZOO_SERVE}
    refs.update({c[0]: zoo_train_single(c) for c in ZOO_TRAIN})
    log(f"[zoo] single-process references in "
        f"{time.perf_counter() - t0:.1f} s")
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmpdir:
        try:
            tmp.start_processes(_zoo_rank, args=(tmpdir, backend),
                                nprocs=ZOO_RANKS, join=True,
                                start_method="spawn")
        except ProcessException as e:
            raise PhaseFailed(f"zoo: a rank failed: {e}")
        ranks = [torch.load(f"{tmpdir}/rank{r}.pt")
                 for r in range(ZOO_RANKS)]
    log(f"[zoo] backend {backend}, {ZOO_RANKS} ranks on one card; the "
        f"ranks' wall {time.perf_counter() - t:.1f} s (4 ranks sharing one "
        f"card: not a TP speed)")
    wkv = 0
    for name, arch, layers, dtype, shape, fsdp in ZOO_SERVE:
        cfg = tp_config(arch, layers, dtype)
        rs = [r[name] for r in ranks]
        label = (f"{arch}{f' ({layers} layers)' if layers else ''}, {dtype},"
                 f" mesh {shape}{', FSDP prefill' if fsdp else ''}")
        log(f"[zoo] {label}: layer 0's shards {rs[0]['shards']}; its state "
            f"{rs[0]['state']}; peak GiB by rank "
            f"{[round(r['peak_gib'], 2) for r in rs]}")
        for k, r in enumerate(rs):
            log(f"[zoo] {label}: rank {k} rows {r['rows']}, walls (s) "
                f"{ {w: round(v, 2) for w, v in r['walls'].items()} }, "
                f"{r['wall']:.1f} in all; launches "
                f"{ {n: v for n, v in r['launches'].items() if v} }")
        ref = refs[name]
        errs = [tp_compare(torch.cat(r["logits"]), torch.cat(
            [w[slice(*r["rows"])] for w in ref["logits"]]), label,
            f"rank {k} vs the single process", "zoo")
            for k, r in enumerate(rs)]
        share = max(e[0] for e in errs)
        agree = all(e[1] == e[2] and e[3] for e in errs)
        if dtype == "float32":
            check(agree and share <= 1e-3,
                  f"{label}: f32 logits not within 1e-3 of the single "
                  "process")
        else:
            spreads = [tp_compare(torch.cat(ref[k]), torch.cat(ref["logits"]),
                                  label, f"the single process's {what} vs "
                                  "its kernels", "zoo")
                       for k, what in (("plain", "plain path"),
                                       ("f32_experts", "experts in f32"))
                       if k in ref]
            rule = agree and share <= 0.05
            outside = any(o[0] > 0.05 or o[1] < o[2] for o in spreads)
            log(f"[zoo] {label}: phase 3's rule (0.05, same argmax) "
                f"{'holds' if rule else 'fails'} for the ranks vs the "
                f"single process; the single process against itself is "
                f"{'outside' if outside else 'within'} it")
            check(rule or (outside and all(e[3] for e in errs)),
                  f"{label}: logits outside phase 3's rule")
        n_rwkv = sum(spec.mixer == "rwkv" for spec in cfg.layer_specs)
        if n_rwkv:
            check(all(r["prefill_launches"]["wkv6"] == n_rwkv for r in rs),
                  f"{label}: a rank did not launch WKV6 once a layer in its "
                  "prefill")
            wkv += sum(r["launches"]["wkv6"] for r in rs)
        if any(spec.mixer in ("attn", "local_attn")
               for spec in cfg.layer_specs):
            check(all(r["launches"]["chunked_prefill_attention"] > 0
                      for r in rs),
                  f"{label}: a rank did not launch the prefill kernel")
    for name, arch, layers, dtype, shape in ZOO_TRAIN:
        cfg = tp_config(arch, layers, dtype)
        rs = [r[name] for r in ranks]
        ref = refs[name]
        label = (f"{arch} ({layers} layers), {dtype}, mesh {shape}, FSDP + "
                 f"TP, remat, bf16 factored moments")
        for k, r in enumerate(rs):
            log(f"[zoo] {label}: rank {k} losses {r['losses']}, walls (s) "
                f"{ {w: round(v, 2) for w, v in r['walls'].items()} }, "
                f"peak {r['peak_gib']:.2f} GiB; launches "
                f"{ {n: v for n, v in r['launches'].items() if v} }")
        loss = max(abs(a - b) / abs(b) for r in rs
                   for a, b in zip(r["losses"], ref["losses"]))
        shares = {}
        for r in rs:
            for n, v in zoo_leaf_shares(r["leaves"], ref["leaves"], cfg,
                                        r["table"], shape,
                                        r["coord"]).items():
                shares[n] = max(shares.get(n, 0.0), v)
        zero = zero_init(cfg) & set(shares)
        leaf, worst = max((v, n) for n, v in shares.items() if n not in zero)
        biases = max(shares[n] for n in zero) if zero else 0.0
        log(f"[zoo] {label}: single process's losses {ref['losses']}; the "
            f"ranks' against them within {loss:.3g} (relative); the "
            f"updated leaves of layers 0 and {cfg.num_layers - 1} within "
            f"{leaf:.3g} of their largest |value| (worst {worst}); those "
            f"that start at zero (the q / v biases: their values are the "
            f"two updates alone) {({n: round(shares[n], 5) for n in zero})}")
        if dtype == "float32":
            # a bias's scale is its updates', over which the rounding of
            # its gradient's sum over the batch shows (1.6e-3 measured)
            check(loss <= 1e-3 and leaf <= 1e-3 and biases <= 1e-2,
                  f"{label}: f32 steps not within 1e-3 of the single process"
                  " (the biases 1e-2 of theirs)")
        else:
            # the loss's rounding, and two bf16 steps of each leaf's largest
            # value; the biases' bf16 gradients are rounding over their own
            # scale (0.07-0.32 measured): printed, and held in f32
            check(loss <= 1e-2 and leaf <= 2 * 2 ** -7,
                  f"{label}: bf16 steps outside two bf16 steps of the "
                  "single process")
    log(f"[zoo] phase wall {time.perf_counter() - t0:.1f} s (4 ranks sharing "
        f"one card: not a TP speed)")
    return wkv


# ---------------------------------------------------------------------------
# phase 14: the dry-run over the production meshes, and the counted
# roofline held against Llama-3.1-8B's steps on the card
# ---------------------------------------------------------------------------

SWEEP_JOBS = 6                          # the sweep's processes, on the host
SWEEP_TIMEOUT = 600
H100_BYTES = 80e9                       # one H100's HBM
#: (b)'s steps: profile_decode's (B = 4 slots at ~1024 tokens of context
#: in a 2048-token cache), profile_prefill's (one 1024-token prompt), and
#: phase 12's (B = 1 x 2048, remat, bf16 factored moments)
ROOF_DECODE = dict(batch=4, ctx=1024, max_len=2048)
ROOF_PREFILL = dict(length=1024, max_len=2048)
ROOF_TRAIN = dict(batch=1, seq=2048)
ROOF_REPS = {"decode": 8, "prefill": 4, "train": 1}   # timed after a warm-up


def sweep_start(out):
    """(a): the dry-run of every arch x shape on both production meshes, in
    SWEEP_JOBS processes on the host (meta tensors, a fake group of their
    own: no card, nothing of phase 13's)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--both-meshes", "--jobs", str(SWEEP_JOBS), "--out", out],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def sweep_finish(proc, out, t0):
    """Wait for (a); print the counts by status, the pairs that do not fit
    one H100 and the report; fail on any error record."""
    from repro_torch.launch import roofline_report
    try:
        _, err = proc.communicate(timeout=SWEEP_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise PhaseFailed(f"roofline: the sweep took over {SWEEP_TIMEOUT} s")
    recs = [json.loads(line) for line in open(out)] \
        if os.path.exists(out) else []
    counts = {k: sum(r["status"] == k for r in recs)
              for k in ("ok", "skipped", "error")}
    log(f"[roofline] (a) the dry-run sweep: {len(recs)} records {counts} in "
        f"{time.perf_counter() - t0:.1f} s ({SWEEP_JOBS} processes on the "
        f"host, meta tensors, fake groups of 256 / 512 ranks)")
    for r in recs:
        if r["status"] == "error":
            log(f"[roofline] error: {r['arch']} {r['shape']} {r['mesh']}: "
                f"{r['error']}")
    over = [r for r in recs if r["status"] == "ok"
            and sum(r["memory"][k] for k in ("argument_bytes", "temp_bytes"))
            > H100_BYTES]
    log(f"[roofline] (a) {len(over)} ok pairs whose per-rank argument + "
        f"temp bytes exceed one H100's 80 GB:")
    for r in over:
        m = r["memory"]
        log(f"[roofline]   {r['arch']} {r['shape']} {r['mesh']}: arguments "
            f"{m['argument_bytes'] / 1e9:.1f} GB + temp "
            f"{m['temp_bytes'] / 1e9:.1f} GB")
    if recs and counts["ok"]:
        log(roofline_report.render(roofline_report.load(out)))
    check(proc.returncode == 0 and counts["error"] == 0
          and len(recs) == 96, f"roofline: the sweep exited "
          f"{proc.returncode} with {len(recs)} records {counts}: "
          f"{err[-2000:]}")
    return counts


def roof_steps(cfg, device):
    """(b)'s three steps of `cfg` on `device` ("cuda": a model of random
    weights through the kernels; "meta": shapes only, the plain path, as
    the dry-run counts it), over one model: {name: (make, InputShape)},
    where make() -> (fn, args) makes the step's own state or moments."""
    from repro_torch.configs import InputShape
    from repro_torch.models import (decode_step, init_params, init_state,
                                    prefill)
    from repro_torch.training import AdamWConfig, adamw_init, make_train_step
    plain = device == "meta"
    gen = None if plain else torch.Generator(device=device).manual_seed(0)
    model = init_params(cfg, gen, device)
    rng = np.random.RandomState(5)

    def ints(*shape):
        return torch.from_numpy(rng.randint(0, cfg.vocab_size, shape)).to(
            device)
    d, p, t = ROOF_DECODE, ROOF_PREFILL, ROOF_TRAIN
    ocfg = AdamWConfig(**TRAIN_LR, moment_dtype="bfloat16", factored=True)

    def decode():
        return (partial(decode_step, cfg, plain_kernels=plain),
                (model, init_state(cfg, d["batch"], d["max_len"], device),
                 ints(d["batch"]), np.full(d["batch"], d["ctx"])))

    def prompt():
        return (partial(prefill, cfg, plain_kernels=plain),
                (model, init_state(cfg, 1, p["max_len"], device),
                 ints(1, p["length"]), [p["length"]]))

    def train():
        return (make_train_step(cfg, ocfg, remat=True, device=device,
                                plain_kernels=plain),
                (model, adamw_init(model, ocfg), ints(t["batch"], t["seq"]),
                 ints(t["batch"], t["seq"])))
    return {
        "decode": (decode, InputShape("decode", d["ctx"], d["batch"],
                                      "decode")),
        "prefill": (prompt, InputShape("prefill", p["length"], 1,
                                       "prefill")),
        "train": (train, InputShape("train", t["seq"], t["batch"],
                                    "train")),
    }


def roof_measure(fn, args, reps):
    """One warm-up call, the wall of `reps` calls by the host's clock
    (synced), then one call under torch.profiler with the peak memory
    reset before it: (wall ms, device ms or None, peak bytes).  The
    device time sums the card's kernels; a host range drawn on the
    device's timeline ("adamw_update") is no kernel and is skipped."""
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) / reps * 1e3
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and not getattr(e, "is_user_annotation", False)
          and e.name != "adamw_update"]
    return wall, (sum(us) / 1e3 if us else None), peak


def roof_against_card(card):
    """(b) Llama-3.1-8B at its published widths and depth, bf16: each step
    counted on meta (count_step) and run on the card through the kernels;
    the counted FLOPs against MODEL_FLOPS, the roofline terms, the least
    time for the arguments read once and outputs written once, the
    device and wall times against the roofline's largest term, the
    predicted peak against the allocator's."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import roofline as rf
    cfg = get_config("llama31_8b")
    counted = {}
    for name, (make, shape) in roof_steps(cfg, "meta").items():
        t = time.perf_counter()
        c = rf.count_step(*(lambda fn, args: (fn, *args))(*make()))
        counted[name] = (c, shape, time.perf_counter() - t)
    t = time.perf_counter()
    steps = roof_steps(cfg, "cuda")
    torch.cuda.synchronize()
    log(f"[roofline] (b) {cfg.name} made on the card in "
        f"{time.perf_counter() - t:.1f} s ({card})")
    kops.reset_launches()
    rows = {}
    for name, (make, _) in steps.items():
        fn, args = make()
        rows[name] = roof_measure(fn, args, ROOF_REPS[name])
        del fn, args
        torch.cuda.empty_cache()
    launches = dict(kops.LAUNCHES)
    del steps
    log(f"[roofline] (b) kernel launches over the three steps (not in the "
        f"kernels line): {launches}")
    check(launches["chunked_prefill_attention"] > 0
          and launches["decode_attention"] > 0,
          "roofline: the attention kernels did not launch")
    for name, (c, shape, t_count) in counted.items():
        wall, dev, peak = rows[name]
        model = rf.model_flops_estimate(cfg, shape)
        t_c, t_m = c.flops / rf.PEAK_FLOPS, c.hbm_bytes / rf.HBM_BW
        least = (c.memory["argument_bytes"] + c.memory["output_bytes"]) \
            / rf.HBM_BW
        roof = max(t_c, t_m, c.collective_bytes / rf.LINK_BW)
        log(f"[roofline] (b) {cfg.name} {name} {shape.global_batch} x "
            f"{shape.seq_len}: counted {c.flops / 1e12:.4f} TFLOP (plain "
            f"path) vs MODEL_FLOPS {model / 1e12:.4f} (ratio "
            f"{c.flops / model:.3f}); t_compute {t_c * 1e3:.3f} ms, "
            f"t_memory {t_m * 1e3:.3f} ms ({c.hbm_bytes / 1e9:.2f} GB of "
            f"eager traffic); arguments read once + outputs written once "
            f"{least * 1e3:.3f} ms; counted in {t_count:.1f} s ({card})")
        dev_s = "not measured" if dev is None else \
            f"{dev:.3f} ms ({dev / 1e3 / roof:.2f} x the roofline)"
        log(f"[roofline] (b) {cfg.name} {name} on the card: device {dev_s} "
            f"(one call under the profiler); wall {wall:.3f} ms, the mean "
            f"of {ROOF_REPS[name]} (synced host clock; {wall / 1e3 / roof:.2f}"
            f" x the roofline's {roof * 1e3:.3f} ms, {wall / 1e3 / least:.1f}"
            f" x the least time); peak {peak / 1e9:.2f} GB vs predicted "
            f"{c.memory['peak_bytes'] / 1e9:.2f} GB ({card})")
        check(math.isfinite(c.flops) and c.flops > 0 and wall > 0,
              f"roofline: {name} counted or ran nothing")
    return rows


def phase_roofline(card):
    """(b) on the card, then (a) the dry-run sweep on the host: the sweep's
    processes would compete for the host that (b)'s walls are timed on."""
    import tempfile
    roof_against_card(card)
    with tempfile.TemporaryDirectory() as tmpdir:
        out = os.path.join(tmpdir, "results.jsonl")
        t0 = time.perf_counter()
        sweep_finish(sweep_start(out), out, t0)


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

    card = timed(phase_build)
    errs, rows = timed(phase_parity)
    figures = {}
    launches, figures["llama31_8b"] = timed(phase_serve)
    launches["paged_decode_attention"] = timed(phase_paged)
    launches["wkv6"] = timed(phase_rwkv)
    for name, n in timed(phase_gemma).items():
        launches[f"{name}_d256"] = n
    timed(phase_exact)
    qwen, figures["qwen25_32b"] = timed(phase_qwen)
    for name, n in qwen.items():
        launches[f"{name}_qwen"] = n
    figures["deepseek_v2_lite_16b"] = timed(phase_deepseek)
    kimi, figures["kimi_k2_1t_a32b"] = timed(phase_kimi)
    for name, n in kimi.items():
        launches[f"{name}_kimi"] = n
    timed(phase_vision)
    timed(phase_control, figures, card)
    timed(phase_train, card)
    timed(phase_ep)
    timed(phase_roofline, card)
    launches["decode_attention_partial"] = timed(phase_tp)
    launches["wkv6_rank"] = timed(phase_zoo)
    src = {"chunked_prefill_attention":
           ("src/repro_torch/kernels/csrc/chunked_prefill_attention.cu",
            "src/repro/kernels/chunked_prefill_attention.py:37"),
           "decode_attention":
           ("src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:30"),
           "decode_attention_partial":
           ("src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:30"),
           "paged_decode_attention":
           ("src/repro_torch/kernels/csrc/paged_decode_attention.cu",
            "src/repro/kernels/paged_decode_attention.py:77"),
           "wkv6":
           ("src/repro_torch/kernels/csrc/wkv6.cu",
            "src/repro/kernels/wkv6.py:32")}
    # WKV6 on a rank's heads of RWKV-6 3B (phase 16 (a))
    src["wkv6_rank"] = src["wkv6"]
    # the same two kernels' D = 256 instantiations, on Gemma-2-9B's path,
    # at Qwen-2.5-32B's heads (G = 5), on its path, and at Kimi K2's head
    # dim 112 (64 / 8 heads), on its path (phase 17)
    for name in ("chunked_prefill_attention", "decode_attention"):
        src[f"{name}_d256"] = src[name]
        src[f"{name}_qwen"] = src[name]
        src[f"{name}_kimi"] = src[name]
    # bf16 prefill at D = 256 is prefill_wg_kernel; beside Gemma-2-9B's
    # prompt row, its prompt and its chunk past the 4096 window (the same
    # kernel, so phase 6's launches)
    src["chunked_prefill_attention_d256"] = (
        "src/repro_torch/kernels/csrc/prefill_wg.cuh",
        src["chunked_prefill_attention"][1])
    for shape in ("window", "chunk"):
        src[f"chunked_prefill_attention_{shape}_d256"] = \
            src["chunked_prefill_attention_d256"]
        launches[f"chunked_prefill_attention_{shape}_d256"] = \
            launches["chunked_prefill_attention_d256"]
    # bf16 prefill at every other head dim is prefill_wg_kernel too: beside
    # Llama's prompt row (phase 3's launches, every shape), Qwen's (phase
    # 8's) and Kimi's (phase 17's), four rows counted at their own shapes:
    # the burst prompt in phases 3 and 17 (their prefillers pad a prompt of
    # 1025-2048 tokens to 2048 rows), a chunk of the planned size into
    # phase 11's 4096-row cache (whatever the chunk's length), and bf16 at
    # D = 64 (Qwen2-0.5B's heads) in any serving run
    for name in ("chunked_prefill_attention", "chunked_prefill_attention_qwen",
                 "chunked_prefill_attention_kimi",
                 "chunked_prefill_attention_burst",
                 "chunked_prefill_attention_burst_kimi",
                 "chunked_prefill_attention_planned_chunk",
                 "chunked_prefill_attention_d64"):
        src[name] = src["chunked_prefill_attention_d256"]
    log(f"[launches] the prefill kernel's launches by (dtype, B, Sq, Skv, "
        f"Hq, Hkv, D) in each serving run: {SERVED}")
    launches["chunked_prefill_attention_burst"] = SERVED["serve"].get(
        ("bfloat16", 1, 2048, 2048, 32, 8, 128), 0)
    launches["chunked_prefill_attention_burst_kimi"] = SERVED["kimi"].get(
        ("bfloat16", 1, 2048, 2048, 64, 8, 112), 0)
    launches["chunked_prefill_attention_planned_chunk"] = SERVED[
        "control"].get(("bfloat16", 1, convertible_chunk(),
                        CONVERTIBLE_MAX_LEN, 32, 8, 128), 0)
    launches["chunked_prefill_attention_d64"] = sum(
        n for shapes in SERVED.values() for key, n in shapes.items()
        if key[0] == "bfloat16" and key[-1] == 64)
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
