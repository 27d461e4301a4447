#!/usr/bin/env python3
"""Time the bf16 decode kernel's block shapes and splits on one card.

    python3 chip_decode_sweep.py [--other OTHER_ROOT] [--out FILE]

Builds src/repro_torch/kernels/csrc/decode_attention.cu as it is and with
its block shape (kTcWarps and TcTile<D> in decode_common.cuh) rewritten to
four others, each into its own library under build/decode_sweep/, and
times each at splits of 128 to 1024 positions on phase 2's decode rows
(Llama-3.1-8B's and Qwen-2.5-32B's heads at L = 2048, Gemma-2-9B's at L =
5120 with window 4096 and softcap 50, Gemma-2B's MQA heads, a rank's
512-position slice), beside SDPA and the bound, with each output's share
of the 2e-5 + 2 bf16 steps bound against the plain version.  With
--other, the decode kernel of another checkout (an older commit unpacked
with ``git archive``) is timed beside them at its own split rule's split.
Prints the card's name and power limit and the times, and with --out
writes them to FILE as JSON.  Needs one card and nvcc.
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

WARPS = "constexpr int kTcWarps = 4;"
DW = "static constexpr int DW = D > 128 ? 2 : 1;"
ST = "static constexpr int STAGES = D > 128 ? 3 : 2;"


def _blocks_of(warps):
    """Blocks of `warps` warps, each on its own 16 keys of a tile, and a
    3-slot ring at every head dim."""
    return [(WARPS, WARPS.replace("4", str(warps))),
            (DW, "static constexpr int DW = 1;"),
            (ST, "static constexpr int STAGES = 3;")]


#: the shipped TcTile and four others: warp pairs on 32-key tiles with 3
#: ring slots from D = 128 up; four warps on 64-key tiles with 2 slots at
#: every head dim (one block an SM at D = 256); blocks of one warp (16-key
#: tiles) and of two (32-key tiles), each warp with its own keys
VARIANTS = {"shipped": [],
            "pairs_from_128": [(DW, DW.replace("128", "64")),
                               (ST, ST.replace("128", "64"))],
            "64_keys_everywhere": [(DW, DW.replace("128", "1024")),
                                   (ST, ST.replace("128", "1024"))],
            "one_warp": _blocks_of(1),
            "two_warps": _blocks_of(2)}
#: (B, L, Hq, Hkv, D, window, softcap, cur_lens)
ROWS = {"2 Llama": (4, 2048, 32, 8, 128, 0, 0.0, [0, 700, 1500, 2047]),
        "2q Qwen": (4, 2048, 40, 8, 128, 0, 0.0, [0, 700, 1500, 2047]),
        "2b Gemma-2-9B": (4, 5120, 16, 8, 256, 4096, 50.0,
                          [0, 700, 1500, 4600]),
        "Gemma-2B MQA": (3, 2048, 8, 1, 256, 0, 0.0, [2047, 0, 1000]),
        "a rank's slice": (4, 512, 32, 8, 128, 0, 0.0,
                           [1535, 1000, 200, 88])}


def build(name, csrc, subs, out):
    """nvcc of csrc's decode_attention.cu, its header rewritten by subs."""
    from repro_torch.kernels import build as kbuild
    d = out / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(csrc, d)
    hdr = d / "decode_common.cuh"
    text = hdr.read_text()
    for a, b in subs:
        if a not in text:
            raise SystemExit(f"{name}: no '{a}' in {hdr}")
        text = text.replace(a, b)
    hdr.write_text(text)
    cmd = [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-I", str(d), "-o",
           str(d / "lib.so"), str(d / "decode_attention.cu")]
    return name, d / "lib.so", subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def caller(lib, B, L, Hq, Hkv, D, window, cap, split):
    """The C entry decode_attention of `lib` at a given split, bf16."""
    import torch
    from repro_torch.kernels import build as kbuild
    fn = lib.decode_attention
    fn.argtypes = kbuild._ARGTYPES["decode_attention"]
    fn.restype = ctypes.c_int
    nsplit = -(-L // split)

    def call(q, k, v, cur):
        out = torch.empty_like(q)
        ws = torch.empty(B * Hq * nsplit * (D + 2), dtype=torch.float32,
                         device="cuda")
        err = fn(1, q.data_ptr(), k.data_ptr(), v.data_ptr(), cur.data_ptr(),
                 out.data_ptr(), ws.data_ptr(),
                 ws.data_ptr() + 4 * B * Hq * nsplit * D, B, L, Hq, Hkv, D,
                 window, cap, D ** -0.5, split,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"decode_attention failed to launch ({err})")
        return out
    return call


def other_split(root: Path, L, B, Hkv, D):
    """The split `root`'s own rule gives (its decode_split takes the head
    dim or not), from a process that imports `root`'s package."""
    code = ("import inspect, sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import ops; a = [int(x) for x in "
            "sys.argv[2:]]; f = ops.decode_split; "
            "takes_d = 'D' in inspect.signature(f).parameters; "
            "print(f(*(a if takes_d else a[:3]))[0])")
    r = subprocess.run([sys.executable, "-c", code, str(root / "src"),
                        str(L), str(B), str(Hkv), str(D)],
                       capture_output=True, text=True, check=True)
    return int(r.stdout)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path)
    ap.add_argument("--out", type=Path)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_decode_sweep: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import ref
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    out = ROOT / "build" / "decode_sweep"
    csrc = ROOT / "src/repro_torch/kernels/csrc"
    procs = [build(n, csrc, subs, out) for n, subs in VARIANTS.items()]
    splits = {}
    if a.other is not None:
        other = a.other.resolve()
        procs.append(build("other", other / "src/repro_torch/kernels/csrc",
                           [], out))
        splits = {row: other_split(other, L, B, Hkv, D)
                  for row, (B, L, _, Hkv, D, *_) in ROWS.items()}
    libs = {}
    for name, so, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            print(log, file=sys.stderr)
            return 1
        regs = {k: v for k, v in cs.ptxas_report(log).items()
                if "decode_tc" in k or "bf16" in k}
        print(f"[sweep] {name}: ptxas {regs}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    g = torch.Generator(device="cuda").manual_seed(0)
    bf, res = torch.bfloat16, {}
    for row, (B, L, Hq, Hkv, D, win, cap, curs) in ROWS.items():
        cur = cs.i32(curs)
        sets = []
        for _ in range(cs.n_copies(B * L * Hkv * D * 2 * 2)):
            q = cs._rand(g, (B, Hq, D), bf)
            k = cs._rand(g, (B, L, Hkv, D), bf)
            sets.append((q, k, cs._rand(g, (B, L, Hkv, D), bf), cur))
        q, k, v, _ = sets[0]
        want = ref.decode_attention_ref(q, k, v, cur, window=win, softcap=cap)
        mask = torch.arange(L, device="cuda")[None, :] <= cur[:, None]
        sdpa = [(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                 mask[:, None, None]) for q, k, v, _ in sets]
        r = {"bound_ms": cs.decode_bound(q, k, curs, win)[0],
             "sdpa_ms": cs.time_ms(
                 lambda q, k, v, m: F.scaled_dot_product_attention(
                     q, k, v, attn_mask=m, enable_gqa=True), sdpa)["ms"]}
        runs = [(n, s) for n in VARIANTS for s in (128, 256, 512, 1024)
                if s <= max(128, L // 2)]
        if "other" in libs:
            runs.insert(0, ("other", splits[row]))
        for name, split in runs:
            fn = caller(libs[name], B, L, Hq, Hkv, D, win, cap, split)
            share = cs.bf16_bound_share(fn(q, k, v, cur), want)
            r[f"{name} @{split}"] = [cs.time_ms(fn, sets)["ms"], share]
        print(f"[sweep] {row}: " + ", ".join(
            f"{k} {v[0]:.4f} ms ({v[1]:.2f} of the bound)"
            if isinstance(v, list) else f"{k} {v:.4f}"
            for k, v in r.items()), flush=True)
        res[row] = r
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps({"card": card, "rows": res}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
