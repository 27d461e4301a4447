#!/usr/bin/env python3
"""Where a tile's time goes in the bf16 prefill kernel (wgmma + TMA), and
how variants of it compare.

    python3 chip_prefill_probe.py [--variants NAME,...] [--out FILE]

Builds src/repro_torch/kernels/csrc/chunked_prefill_attention.cu as it is
and a copy whose prefill_wg.cuh reads clock64() between the stages of the
consumers' steady-state loop (issue Q K^T and P V; wait for Q K^T;
softmax; wait for P V; rescale O and pack P), each into its own library
under build/prefill_probe/, and with --variants one more library for each
named entry of VARIANTS (prefill_wg.cuh with a tile, ring or grid order
changed), all compiled at once.  At each of SHAPES (phase 2's bf16 prefill
rows at head dims 64, 128 and 256) it checks
the probed copy's output bit-equal to the shipped kernel's and each
variant's within 2e-5 + 2 bf16 steps of the plain version, times them in
turns (shipped, probe, the variants, then the same backwards), and prints
the cycles a loop iteration spends in each stage, for each consumer
warpgroup of the block that holds the prompt's last rows (the one with the
most tiles) of kv head 0.  Prints the card's name and power limit and each
library's ptxas registers and spills, and with --out writes it all to FILE
as JSON.  Needs one card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

STAGES = ("issue", "wait_qk", "softmax", "wait_pv", "rescale_pack")
#: (text in prefill_wg.cuh, text that replaces it) for the probed copy;
#: thread 0 of each consumer warpgroup of block (0, 0, 0) adds each
#: stage's cycles to g_probe[8 * warpgroup + stage]
PROBE = [
    ("constexpr int kWgBM = 128;",
     "__device__ unsigned long long g_probe[16];\nconstexpr int kWgBM = 128;"),
    ("      for (int it = 1; it < ntiles; ++it) {\n",
     "      const bool probe = blockIdx.x == 0 && blockIdx.y == 0 &&\n"
     "                         blockIdx.z == 0 && wtid == 0;\n"
     "      if (probe) g_probe[8 * wg + 5] = ntiles;\n"
     "      for (int it = 1; it < ntiles; ++it) {\n"
     "        const long long c0 = clock64();\n"),
    ("        issue_pv(it - 1);\n",
     "        issue_pv(it - 1);\n        const long long c1 = clock64();\n"),
    ("        softmax_tile(it, alpha);\n",
     "        const long long c2 = clock64();\n"
     "        softmax_tile(it, alpha);\n"
     "        const long long c3 = clock64();\n"),
    ("        rescale(alpha);\n        pack_p();\n      }\n",
     "        const long long c4 = clock64();\n"
     "        rescale(alpha);\n        pack_p();\n"
     "        if (probe) {\n"
     "          g_probe[8 * wg] += c1 - c0;\n"
     "          g_probe[8 * wg + 1] += c2 - c1;\n"
     "          g_probe[8 * wg + 2] += c3 - c2;\n"
     "          g_probe[8 * wg + 3] += c4 - c3;\n"
     "          g_probe[8 * wg + 4] += clock64() - c4;\n"
     "        }\n      }\n"),
]
READ = """
extern "C" int prefill_probe_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, repro_torch::g_probe,
                                   sizeof(repro_torch::g_probe));
}
extern "C" int prefill_probe_reset() {
  static const unsigned long long zero[16] = {};
  return (int)cudaMemcpyToSymbol(repro_torch::g_probe, zero, sizeof(zero));
}
"""
#: phase 2's bf16 prefill rows: label -> (Hq, Hkv, D, Sq, Skv, offset,
#: length, window, softcap)
SHAPES = {"1 prompt": (32, 8, 128, 512, 2048, 0, 512, 0, 0.0),
          "1q Qwen prompt": (40, 8, 128, 512, 2048, 0, 512, 0, 0.0),
          "1p burst prompt": (32, 8, 128, 2048, 2048, 0, 1500, 0, 0.0),
          "1c planned chunk": (32, 8, 128, 2816, 4096, 0, 2816, 0, 0.0),
          "1h Qwen2-0.5B prompt": (14, 2, 64, 512, 2048, 0, 512, 0, 0.0),
          "1b prompt": (16, 8, 256, 512, 2048, 0, 512, 0, 50.0),
          "1bw prompt past the window": (16, 8, 256, 5120, 5120, 0, 4600,
                                         4096, 50.0),
          "1bc chunk past the window": (16, 8, 256, 256, 5120, 4352, 4608,
                                        4096, 50.0),
          "Gemma-2B MQA prompt": (8, 1, 256, 512, 2048, 0, 512, 0, 0.0)}
#: the m64n128k16 form of wgmma_ss, for S of a 128-key tile
SS_N128 = """__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %66, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\\n}\\n"
      : REPRO_F32(d, 0), REPRO_F32(d, 32)
      : "l"(a), "l"(b), "r"(1));
}

"""
RS_NOTE = "// d (64 x N, f32) += a (64 x 16, bf16 fragment in registers)"


def per_d(const, fn, expr):
    """Rewrites that make prefill_wg.cuh's `const` a function `fn` of the
    head dim, `expr` in D, at its declaration and at every use."""
    return [(re.compile(rf"constexpr int {const} = \d+;"),
             f"__host__ __device__ constexpr int {fn}(int D) {{ return "
             f"{expr}; }}"),
            (re.compile(rf"\b{const}\b"), f"{fn}(D)")]


#: prefill_wg.cuh rewritten: name -> [(text or compiled pattern, text that
#: replaces it)]; a text must be in the header once, a pattern at least once
VARIANTS = {
    "bn128": [("{64, 1, kWgBN, 1}", "{64, 1, (cuuint32_t)kWgBN, 1}")]
    + per_d("kWgBN", "wg_bn", "D == 256 ? 64 : 128")
    + [(RS_NOTE, SS_N128 + RS_NOTE)],
    "stages3": per_d("kWgStages", "wg_stages", "D == 256 ? 2 : 3"),
    "stages4": per_d("kWgStages", "wg_stages", "D == 256 ? 2 : 4"),
    # the grid (row blocks, Hkv, B): the heaviest rows first per head
    "per-head-order": [
        ("const int hk = blockIdx.x % Hkv, b = blockIdx.y;",
         "const int hk = blockIdx.y, b = blockIdx.z;"),
        ("const int p0 = (gridDim.x / Hkv - 1 - blockIdx.x / Hkv) * kWgBM;",
         "const int p0 = (gridDim.x - 1 - blockIdx.x) * kWgBM;"),
        ("const dim3 grid(Hkv * ((P + kWgBM - 1) / kWgBM), B);",
         "const dim3 grid((P + kWgBM - 1) / kWgBM, Hkv, B);")],
}


def prepare(name, subs, extra, out):
    """A copy of csrc/ under out/name with prefill_wg.cuh rewritten by subs
    and `extra` appended to the .cu; returns (name, library, nvcc
    command)."""
    from repro_torch.kernels import build as kbuild
    d = out / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(kbuild.CSRC, d)
    hdr = d / "prefill_wg.cuh"
    text = hdr.read_text()
    for a, b in subs:
        if isinstance(a, re.Pattern):
            text, n = a.subn(b, text)
            if n == 0:
                raise SystemExit(f"{name}: '{a.pattern}' is not in {hdr}")
            continue
        if text.count(a) != 1:
            raise SystemExit(f"{name}: '{a.strip()}' is not once in {hdr}")
        text = text.replace(a, b)
    hdr.write_text(text)
    cu = d / "chunked_prefill_attention.cu"
    cu.write_text(cu.read_text() + extra)
    cmd = [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-I", str(d), "-o",
           str(d / "lib.so"), str(cu)]
    return name, d / "lib.so", cmd


def caller(lib, win, cap):
    """The C entry chunked_prefill_attention of `lib`, bf16."""
    import torch
    from repro_torch.kernels import build as kbuild
    fn = lib.chunked_prefill_attention
    fn.argtypes = kbuild._ARGTYPES["chunked_prefill_attention"]
    fn.restype = ctypes.c_int

    def call(q, k, v, o, ln):
        B, Sq, Hq, D = q.shape
        out = torch.empty_like(q)
        err = fn(1, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 ln.data_ptr(), out.data_ptr(), B, Sq, k.shape[1], Hq,
                 k.shape[2], D, win, cap, D ** -0.5,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"prefill failed to launch ({err})")
        return out
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="",
                    help="names of VARIANTS, comma-separated; a+b applies "
                         "both")
    ap.add_argument("--out", type=Path)
    a = ap.parse_args()
    variants = [x for x in a.variants.split(",") if x]
    for x in variants:
        for y in x.split("+"):
            if y not in VARIANTS:
                raise SystemExit(f"unknown variant {y!r}: {list(VARIANTS)}")
    import torch
    if not torch.cuda.is_available():
        print("chip_prefill_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import ref
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    out = ROOT / "build" / "prefill_probe"
    jobs = [prepare("shipped", [], "", out),
            prepare("probe", PROBE, READ, out)]
    for x in variants:
        jobs.append(prepare(x, [s for y in x.split("+")
                                for s in VARIANTS[y]], "", out))
    jobs = [(name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
            for name, so, cmd in jobs]
    libs, regs = {}, {}
    for name, so, p in jobs:
        log, _ = p.communicate()
        if p.returncode != 0:
            print(log, file=sys.stderr)
            return 1
        regs[name] = {k: v for k, v in cs.ptxas_report(log).items()
                      if k.startswith("prefill_wg")}
        print(f"[probe] {name}: ptxas {regs[name]}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    libs["probe"].prefill_probe_reset.restype = ctypes.c_int
    libs["probe"].prefill_probe_read.argtypes = [ctypes.c_void_p]
    order = list(libs)
    g = torch.Generator(device="cuda").manual_seed(0)
    bf, res = torch.bfloat16, {}
    for label, (Hq, Hkv, D, Sq, Skv, off, n, win, cap) in SHAPES.items():
        sets = []
        for _ in range(cs.n_copies((Sq * Hq + 2 * Skv * Hkv) * D * 2)):
            q = cs._rand(g, (1, Sq, Hq, D), bf)
            k = cs._rand(g, (1, Skv, Hkv, D), bf)
            sets.append((q, k, cs._rand(g, (1, Skv, Hkv, D), bf),
                         cs.i32([off]), cs.i32([n])))
        fns = {name: caller(lib, win, cap) for name, lib in libs.items()}
        q, k, v, o, ln = sets[0]
        want = ref.chunked_prefill_attention_ref(q, k, v, o, ln, window=win,
                                                 softcap=cap)
        shipped = fns["shipped"](*sets[0])
        if libs["probe"].prefill_probe_reset():
            raise RuntimeError("prefill_probe_reset failed")
        probed = fns["probe"](*sets[0])
        torch.cuda.synchronize()
        cycles = (ctypes.c_ulonglong * 16)()
        if libs["probe"].prefill_probe_read(cycles):
            raise RuntimeError("prefill_probe_read failed")
        shares = {name: cs.bf16_bound_share(fns[name](*sets[0]), want)
                  for name in order}
        ms = {name: [] for name in order}
        for name in order + order[::-1]:
            ms[name].append(cs.time_ms(fns[name], sets)["ms"])
        r = {"ms": ms, "bound_ms": cs.prefill_bound(q, k, [off], [n], win)[0],
             "share_of_bf16_bound": shares,
             "probe_bit_equal": bool(torch.equal(shipped, probed))}
        for wg in range(2):
            its = max(int(cycles[8 * wg + 5]) - 1, 1)
            r[f"warpgroup {wg}"] = dict(
                tiles=int(cycles[8 * wg + 5]),
                **{s: cycles[8 * wg + i] / its
                   for i, s in enumerate(STAGES)})
        print(f"[probe] {label}: " + json.dumps(r), flush=True)
        res[label] = r
        del sets, want
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps({"card": card, "stages": STAGES,
                                     "ptxas": regs, "rows": res}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
