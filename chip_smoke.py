#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100.

    python3 chip_smoke.py          # from the root of a checkout

Phases (any failure exits non-zero; nothing is skipped):
  1. build   — compile both CUDA kernels from src/repro_torch/kernels/csrc
  2. parity  — each kernel against its plain PyTorch version on the card:
               Llama-3.1-8B heads at the main-path shapes in bf16 (3e-2,
               and 2e-5 + 2 bf16 steps of the plain value) and f32 (2e-5), the
               f32 sweeps (2e-5), NaN in the decode kernel's dead region;
               then times at the
               main-path shapes beside the bound, the plain version and
               torch's scaled_dot_product_attention (a yardstick only)
  3. serve   — Llama-3.1-8B at its published widths (random weights from a
               seed, bf16) served PD-disaggregated by PDCluster (prefiller,
               decoder, convertible decoder), then a convertible Engine
               with prompts longer than its chunk; the kernels' launch
               counters are read around exactly this phase
  4. exact   — the f32 SMOKE config served by PDCluster gives the same
               tokens as greedy generation on the card

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
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BYTES = 3.35e12                     # H100 SXM HBM3, bytes/s
PEAK_OPS = {torch.bfloat16: 989e12,      # dense tensor-core bf16, FLOP/s
            torch.float32: 67e12}        # f32 outside the tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
PREFILL_SWEEP = [                        # tests/test_kernels.py SWEEP + G=5
    (1, 8, 8, 1, 1, 16, 0, 0.0), (2, 24, 40, 4, 2, 64, 0, 0.0),
    (2, 24, 40, 4, 2, 64, 16, 0.0), (2, 24, 40, 4, 2, 64, 0, 30.0),
    (1, 128, 128, 8, 8, 32, 0, 0.0), (3, 17, 33, 6, 1, 64, 0, 0.0),
    (1, 256, 384, 2, 2, 128, 64, 50.0), (2, 9, 40, 10, 2, 64, 0, 0.0),
]
DECODE_SWEEP = [                         # its decode sweep + softcap, G=5
    (1, 16, 1, 1, 16, 0, 0.0), (2, 64, 8, 2, 64, 0, 0.0),
    (2, 64, 8, 2, 64, 16, 0.0), (2, 64, 8, 2, 64, 0, 30.0),
    (4, 129, 4, 1, 128, 0, 0.0), (1, 512, 16, 16, 64, 0, 0.0),
    (3, 96, 10, 2, 128, 0, 50.0),
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


def _bound(ops, nbytes, dtype):
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(fn, arg_sets, iters=20):
    """Mean ms per call over CUDA events, cycling through `arg_sets` (held
    large enough together to exceed the 50 MB L2, so inputs come cold)."""
    for a in arg_sets[:3]:
        fn(*a)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


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
    log(f"[build] both kernels built in {time.perf_counter() - t:.1f} s")
    for name in build.SOURCES:
        regs = [ln.strip() for ln in build.build_log(name).splitlines()
                if "registers" in ln or "spill" in ln and " 0 bytes" not in ln]
        log(f"[build] {name}: ptxas {sorted(set(regs))}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(), "nvidia-smi failed")
    card = smi.stdout.strip().splitlines()[0]
    log(card)                           # name, power limit: beside every time
    return card


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

    def judge(kind, label, dt, out, want):
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

    main_inputs = {}
    for dt in (bf, f32):
        for label, (Sq, off, n) in cases.items():
            q = _rand(g, (1, Sq, 32, 128), dt)
            k = _rand(g, (1, 2048, 8, 128), dt)
            v = _rand(g, (1, 2048, 8, 128), dt)
            o = torch.tensor([off], device=dev)
            ln = torch.tensor([n], device=dev)
            ok &= judge("chunked_prefill_attention", label, dt,
                        kops.prefill_attention(q, k, v, o, ln),
                        ref.chunked_prefill_attention_ref(q, k, v, o, ln))
            main_inputs[label] = (Sq, off, n)
        q = _rand(g, (4, 32, 128), dt)
        k, v = _rand(g, (4, 2048, 8, 128), dt), _rand(g, (4, 2048, 8, 128), dt)
        cur = torch.tensor([0, 700, 1500, 2047], device=dev)
        ok &= judge("decode_attention", "B=4 L=2048 cur=[0,700,1500,2047]",
                    dt, kops.decode_attention_op(q, k, v, cur),
                    ref.decode_attention_ref(q, k, v, cur))

    # the f32 sweeps of the reference's kernel tests
    worst = 0.0
    for B, Sq, Skv, Hq, Hkv, D, window, cap in PREFILL_SWEEP:
        q = _rand(g, (B, Sq, Hq, D), f32)
        k, v = _rand(g, (B, Skv, Hkv, D), f32), _rand(g, (B, Skv, Hkv, D), f32)
        off = torch.randint(0, Skv - Sq + 1, (B,), generator=g, device=dev)
        ln = torch.randint(1, Skv + 1, (B,), generator=g, device=dev)
        out = kops.prefill_attention(q, k, v, off, ln, window=window,
                                     softcap=cap)
        want = ref.chunked_prefill_attention_ref(q, k, v, off, ln,
                                                 window=window, softcap=cap)
        worst = max(worst, max_err(out, want))
        good = close(out, want, TOL[f32])
        ok &= good
        if not good:
            log(f"[parity] prefill f32 {(B, Sq, Skv, Hq, Hkv, D, window, cap)}"
                " FAIL")
    log(f"[parity] prefill f32 sweep ({len(PREFILL_SWEEP)} cases): "
        f"max_abs_err {worst:.3g} (tol {TOL[f32]})")
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
        sets.append((q, k, v, torch.tensor([off], device=dev),
                     torch.tensor([n], device=dev)))
    mask = (torch.arange(2048, device=dev)[None, :]
            <= torch.arange(Sq, device=dev)[:, None] + off) \
        & (torch.arange(2048, device=dev)[None, :] < n)
    sdpa_sets = [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  mask[None, None]) for q, k, v, _, _ in sets]
    rows["chunked_prefill_attention"] = dict(
        ms=time_ms(kops.prefill_attention, sets),
        plain_ms=time_ms(ref.chunked_prefill_attention_ref, sets),
        library_ms=time_ms(lambda q, k, v, m: F.scaled_dot_product_attention(
            q, k, v, attn_mask=m, enable_gqa=True), sdpa_sets),
        bound=prefill_bound(sets[0][0], sets[0][1], [off], [n], 0),
        shape="B=1 Sq=512 Skv=2048 Hq=32 Hkv=8 D=128 bf16, offset 0, len 512")
    # the convertible chunk, for the record
    Sq2, off2, n2 = main_inputs["convertible chunk Sq=256 off=768 len=1024"]
    csets = [(q[:, :Sq2].contiguous(), k, v, torch.tensor([off2], device=dev),
              torch.tensor([n2], device=dev)) for q, k, v, _, _ in sets]
    chunk_ms = time_ms(kops.prefill_attention, csets)
    chunk_plain = time_ms(ref.chunked_prefill_attention_ref, csets)
    cb, cby = prefill_bound(csets[0][0], k, [off2], [n2], 0)
    log(f"[time] prefill kernel, chunk Sq=256 off=768 len=1024: {chunk_ms:.4f}"
        f" ms; plain {chunk_plain:.4f} ms; bound {cb:.4f} ms ({cby})")

    curs = torch.tensor([0, 700, 1500, 2047], device=dev)
    dsets = []
    for _ in range(n_copies(4 * 2048 * 8 * 128 * 2 * 2)):
        q = _rand(g, (4, 32, 128), bf)
        k, v = _rand(g, (4, 2048, 8, 128), bf), _rand(g, (4, 2048, 8, 128), bf)
        dsets.append((q, k, v, curs))
    dmask = (torch.arange(2048, device=dev)[None, :] <= curs[:, None])
    sdpa_d = [(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
               dmask[:, None, None]) for q, k, v, _ in dsets]
    rows["decode_attention"] = dict(
        ms=time_ms(kops.decode_attention_op, dsets),
        plain_ms=time_ms(ref.decode_attention_ref, dsets),
        library_ms=time_ms(lambda q, k, v, m: F.scaled_dot_product_attention(
            q, k, v, attn_mask=m, enable_gqa=True), sdpa_d),
        bound=decode_bound(dsets[0][0], dsets[0][1], curs.tolist(), 0),
        shape="B=4 L=2048 Hq=32 Hkv=8 D=128 bf16, cur_lens 0/700/1500/2047")
    for name, r in rows.items():
        log(f"[time] {name} ({r['shape']}): kernel {r['ms']:.4f} ms; "
            f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}); plain "
            f"{r['plain_ms']:.4f} ms; sdpa {r['library_ms']:.4f} ms")
    return errs, rows


def phase_serve():
    from repro_torch.configs import get_config
    from repro_torch.core import CHIPS, InstanceSpec, TokenScalePolicy, profile
    from repro_torch.kernels import ops as kops
    from repro_torch.models import (count_params, init_params, init_state,
                                    prefill)
    from repro_torch.serving import Engine, PDCluster, Request

    cfg = get_config("llama31_8b")
    t = time.perf_counter()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {count_params(model) / 1e9:.2f}B params "
        f"({cfg.num_layers}L d={cfg.d_model}) made on the card in "
        f"{time.perf_counter() - t:.1f} s")
    rng = np.random.RandomState(0)
    max_len, new = 2048, 32

    def req(rid, lo, hi):
        L = int(rng.randint(lo, hi + 1))
        return Request(rid=rid, prompt=rng.randint(
            0, cfg.vocab_size, size=(L,)).astype(np.int32),
            max_new_tokens=new)

    torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()
    # ---- the main path: counters run from here ...
    t0 = time.perf_counter()
    pol = TokenScalePolicy(profile(cfg, InstanceSpec(CHIPS["h100"], 1)),
                           convertible=1)
    cl = PDCluster(cfg, model, pol, n_prefillers=1, n_decoders=1,
                   n_convertible=1, slots_per_decoder=4, max_len=max_len,
                   chunk_size=256)
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
    cl.run_until_drained(max_steps=5000)
    torch.cuda.synchronize()
    pd_s = time.perf_counter() - t0
    eng = Engine(cfg, model, num_slots=4, max_len=max_len, chunk_size=256)
    direct = [req(100 + i, 600, 1100) for i in range(2)]
    for r in direct:
        eng.add_request(r)
    eng.run_until_drained()
    torch.cuda.synchronize()
    launches = dict(kops.LAUNCHES)
    # ... to here
    engines = [d.eng for d in cl.decoders + cl.convertibles] + [eng]
    done = sum(len(r.output) == new for r in reqs + direct)
    mixed = sum(e.mixed_steps for e in engines)
    dec_steps = sum(e.decode_steps for e in engines)
    dec_ms = 1e3 * sum(e.decode_wall_s for e in engines) / max(dec_steps, 1)
    mix_ms = 1e3 * sum(e.mixed_wall_s for e in engines) / max(mixed, 1)
    pre_tok = sum(p.tokens_done for p in cl.prefillers)
    pre_s = sum(p.wall_s for p in cl.prefillers)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[serve] requests completed {done}/{len(reqs) + len(direct)} "
        f"(PD cluster {pd_s:.1f} s, {len(cl.prefillers)} prefillers, "
        f"{len(cl.decoders)} decoders, {len(cl.convertibles)} convertible "
        f"at the end)")
    log(f"[serve] prefiller: {pre_tok} tokens in {pre_s:.3f} s = "
        f"{pre_tok / max(pre_s, 1e-9):.0f} tok/s")
    log(f"[serve] decode steps {dec_steps}, mean {dec_ms:.2f} ms; mixed steps "
        f"{mixed}, mean {mix_ms:.2f} ms")
    want_bytes = [131072 * min(max(-(-L // 128) * 128, 8), max_len)
                  for _, L in transfers]
    sent = [b for b, _ in transfers]
    log(f"[serve] KV transfers {len(sent)}, {sum(sent)} bytes; each "
        f"131072 B x rounded length: {sent == want_bytes}")
    log(f"[serve] kernel launches {launches}; peak device memory "
        f"{peak:.2f} GiB")
    check(done == len(reqs) + len(direct), "not every request completed")
    check(mixed > 0, "no mixed (convertible) step ran")
    check(all(n > 0 for n in launches.values()), f"launches {launches}")
    check(len(sent) > 0 and sent == want_bytes, "KV payload sizes")
    del cl, eng, engines
    profile_decode(cfg, model)

    # one prompt through the kernels and through the plain attention
    p = reqs[3].prompt
    toks = np.zeros((1, 1 << (len(p) - 1).bit_length()), np.int32)
    toks[0, :len(p)] = p
    a, _ = prefill(cfg, model, init_state(cfg, 1, max_len, "cuda"), toks,
                   [len(p)])
    b, _ = prefill(cfg, model, init_state(cfg, 1, max_len, "cuda"), toks,
                   [len(p)], plain_attention=True)
    diff = (a - b).abs().max().item()
    scale = b.abs().max().item()
    log(f"[serve] last-token logits, kernels vs plain attention (L={len(p)}):"
        f" max abs diff {diff:.4g} of max |logit| {scale:.4g}; argmax "
        f"{int(a.argmax())} vs {int(b.argmax())}")
    check(bool(torch.isfinite(a).all()) and diff <= 0.05 * scale,
          "kernel and plain logits disagree")
    return launches


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
            max_new_tokens=steps + 4))
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
    kinds = {"attention": 0.0, "matmul": 0.0, "other": 0.0}
    n = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.lower()
        us = e.time_range.elapsed_us()
        n += 1
        if "decode_kernel" in name or "prefill_kernel" in name:
            kinds["attention"] += us
        elif any(w in name for w in ("gemm", "gemv", "xmma", "nvjet",
                                     "cutlass", "matmul")):
            kinds["matmul"] += us
        else:
            kinds["other"] += us
    busy = sum(kinds.values())
    if n == 0:
        log("[profile] decode step breakdown: not measured (the profiler "
            "recorded no device events)")
        return
    per = {k: round(v / steps / 1e3, 3) for k, v in kinds.items()}
    log(f"[profile] decode step at B=4, ctx~{ctx}: wall "
        f"{wall_us / steps / 1e3:.2f} ms/step; device ms/step by kind {per};"
        f" {n / steps:.0f} kernels/step; device idle share "
        f"{1 - busy / wall_us:.3f}")


def phase_exact():
    from repro_torch.configs import get_config
    from repro_torch.core import CHIPS, InstanceSpec, TokenScalePolicy, profile
    from repro_torch.models import greedy_generate, init_params
    from repro_torch.serving import PDCluster, Request

    cfg = get_config("llama31_8b", smoke=True)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    prof = profile(get_config("llama31_8b"), InstanceSpec(CHIPS["h100"], 1))
    cl = PDCluster(cfg, model, TokenScalePolicy(prof, convertible=1),
                   n_prefillers=1, n_decoders=1, n_convertible=1, max_len=96)
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab_size, size=(L,))
                    .astype(np.int32), max_new_tokens=6)
            for i, L in enumerate([7, 12, 5, 20, 9])]
    for r in reqs:
        cl.submit(r)
    cl.run_until_drained()
    same = [r.output == greedy_generate(cfg, model, r.prompt[None],
                                        [len(r.prompt)], 6)[0].tolist()
            for r in reqs]
    log(f"[exact] SMOKE f32 PD tokens equal greedy_generate on the card: "
        f"{same}; transfers {cl.transfers.n_transfers}")
    check(all(same) and cl.transfers.n_transfers > 0, "exact tokens")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_build()
    errs, rows = phase_parity()
    launches = phase_serve()
    phase_exact()
    src = {"chunked_prefill_attention":
           ("src/repro_torch/kernels/csrc/chunked_prefill_attention.cu",
            "src/repro/kernels/chunked_prefill_attention.py:37"),
           "decode_attention":
           ("src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:30")}
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
