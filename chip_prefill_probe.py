#!/usr/bin/env python3
"""Where a tile's time goes in the bf16 prefill kernel at head dim 256.

    python3 chip_prefill_probe.py [--out FILE]

Builds src/repro_torch/kernels/csrc/chunked_prefill_attention.cu as it is
and a copy whose prefill_wg.cuh reads clock64() between the stages of the
consumers' steady-state loop (issue Q K^T and P V; wait for Q K^T;
softmax; wait for P V; rescale O and pack P), each into its own library
under build/prefill_probe/.  At phase 2's D = 256 prefill shapes it checks
the copy's output bit-equal to the shipped kernel's, times both in turns
(shipped, probe, probe, shipped), and prints the cycles a loop iteration
spends in each stage, for each consumer warpgroup of the block that holds
the prompt's last rows (the one with the most tiles).  Prints the card's
name and power limit, and with --out writes it all to FILE as JSON.  Needs
one card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
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
#: phase 2's D = 256 prefill rows: (Hq, Hkv, Sq, Skv, offset, length,
#: window, softcap)
SHAPES = {"1b prompt": (16, 8, 512, 2048, 0, 512, 0, 50.0),
          "1bw prompt past the window": (16, 8, 5120, 5120, 0, 4600, 4096,
                                         50.0),
          "1bc chunk past the window": (16, 8, 256, 5120, 4352, 4608, 4096,
                                        50.0),
          "Gemma-2B MQA prompt": (8, 1, 512, 2048, 0, 512, 0, 0.0)}


def build(name, subs, extra, out):
    """nvcc of the prefill library with prefill_wg.cuh rewritten by subs
    and `extra` appended to the .cu."""
    from repro_torch.kernels import build as kbuild
    d = out / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(kbuild.CSRC, d)
    hdr = d / "prefill_wg.cuh"
    text = hdr.read_text()
    for a, b in subs:
        if text.count(a) != 1:
            raise SystemExit(f"{name}: '{a.strip()}' is not once in {hdr}")
        text = text.replace(a, b)
    hdr.write_text(text)
    cu = d / "chunked_prefill_attention.cu"
    cu.write_text(cu.read_text() + extra)
    cmd = [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-I", str(d), "-o",
           str(d / "lib.so"), str(cu)]
    return name, d / "lib.so", subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


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
    ap.add_argument("--out", type=Path)
    a = ap.parse_args()
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
    libs = {}
    for name, so, p in [build("shipped", [], "", out),
                        build("probe", PROBE, READ, out)]:
        log, _ = p.communicate()
        if p.returncode != 0:
            print(log, file=sys.stderr)
            return 1
        regs = {k: v for k, v in cs.ptxas_report(log).items()
                if k.startswith("prefill_wg")}
        print(f"[probe] {name}: ptxas {regs}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    libs["probe"].prefill_probe_reset.restype = ctypes.c_int
    libs["probe"].prefill_probe_read.argtypes = [ctypes.c_void_p]
    g = torch.Generator(device="cuda").manual_seed(0)
    bf, res = torch.bfloat16, {}
    for label, (Hq, Hkv, Sq, Skv, off, n, win, cap) in SHAPES.items():
        sets = []
        for _ in range(cs.n_copies((Sq * Hq + 2 * Skv * Hkv) * 256 * 2)):
            q = cs._rand(g, (1, Sq, Hq, 256), bf)
            k = cs._rand(g, (1, Skv, Hkv, 256), bf)
            sets.append((q, k, cs._rand(g, (1, Skv, Hkv, 256), bf),
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
        ms = {"shipped": [], "probe": []}
        for name in ("shipped", "probe", "probe", "shipped"):
            ms[name].append(cs.time_ms(fns[name], sets)["ms"])
        r = {"ms": ms, "bound_ms": cs.prefill_bound(q, k, [off], [n], win)[0],
             "share_of_bf16_bound": cs.bf16_bound_share(shipped, want),
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
                                     "rows": res}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
