#!/usr/bin/env python3
"""Time chip_smoke.py's phase 2 kernel rows of this checkout and of another
checkout of the repo on one card, in turns, and check that the attention
kernels give the same bits in both.

    python3 chip_compare.py OTHER_ROOT [--may-differ REGEX] [--out FILE]

OTHER_ROOT is another checkout (an older commit unpacked with
``git archive``).  Each turn runs one checkout's phase 1 (build) and phase
2 (parity and times) in a process of its own, so that each imports its own
``repro_torch``; the turns go other, this, this, other.  Before its
phase 2, each turn times the prefill kernel on PREFILL_SHAPES (phase 2's
bf16 prefill rows, inputs from seed 1) and saves its outputs there, then
runs each of the four attention wrappers (prefill, decode, the rank-slice
decode entry, paged decode) at every head dim in HEAD_DIMS, in bf16 and
f32, on OUTPUT_CASES' inputs (each case's own seed), and WKV6 on
WKV6_CASES', and saves those outputs too (under build/compare/, with each
turn's rows).  Every saved output of the first turn of each checkout must
be bit-equal to the other's, and the two turns of each checkout to each
other; an output whose label matches --may-differ (one a change meant to
alter) need only be bit-equal run to run, and its largest difference from
the other checkout is printed.  Prints each row's kernel ms in every turn
beside the card's name and power limit, and with --out writes it all to
FILE as JSON.  Exits 1 unless every output meets its rule.  Needs one
card.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SAVED = ROOT / "build" / "compare"      # each turn's rows and outputs

#: phase 2's prefill shapes: (label, B, Sq, Skv, Hq, Hkv, D, offset,
#: length, window, softcap), bf16
PREFILL_SHAPES = [
    ("Llama heads, whole prompt", 1, 512, 2048, 32, 8, 128, 0, 512, 0, 0.0),
    ("Llama heads, convertible chunk", 1, 256, 2048, 32, 8, 128, 768, 1024,
     0, 0.0),
    ("Llama heads, burst prompt", 1, 2048, 2048, 32, 8, 128, 0, 1500, 0,
     0.0),
    ("Llama heads, planned chunk into 4096", 1, 2816, 4096, 32, 8, 128, 0,
     2816, 0, 0.0),
    ("Qwen heads, prompt", 1, 512, 2048, 40, 8, 128, 0, 512, 0, 0.0),
    ("Qwen2-0.5B heads, prompt", 1, 512, 2048, 14, 2, 64, 0, 512, 0, 0.0),
    ("Qwen2-0.5B heads, burst prompt", 1, 2048, 2048, 14, 2, 64, 0, 1500, 0,
     0.0),
    ("Kimi K2 heads, prompt", 1, 512, 2048, 64, 8, 112, 0, 512, 0, 0.0),
    ("Kimi K2 heads, burst prompt", 1, 2048, 2048, 64, 8, 112, 0, 1500, 0,
     0.0),
    ("Gemma-2-9B heads, prompt, softcap 50", 1, 512, 2048, 16, 8, 256, 0,
     512, 0, 50.0),
    ("Gemma-2-9B heads past the window", 1, 5120, 5120, 16, 8, 256, 0, 4600,
     4096, 50.0),
    ("Gemma-2-9B heads, chunk past the window", 1, 256, 5120, 16, 8, 256,
     4352, 4608, 4096, 50.0),
    ("Gemma-2B MQA heads", 1, 512, 2048, 8, 1, 256, 0, 512, 0, 0.0),
    ("sweep: local + softcap", 1, 256, 384, 2, 2, 128, 100, 384, 64, 50.0),
    ("sweep: group of 5", 2, 9, 40, 10, 2, 64, 20, 40, 0, 0.0),
]


#: the head dims both checkouts take (the kernels' outputs are compared at
#: each) and the inputs of each wrapper there: (label, wrapper, shape
#: arguments); every case runs in bf16 and f32
HEAD_DIMS = (16, 32, 64, 112, 128, 256)
OUTPUT_CASES = [
    ("prefill G=4", "prefill", dict(B=1, Sq=200, Skv=512, Hq=8, Hkv=2,
                                    offs=[0], lens=[200], window=0,
                                    softcap=0.0)),
    ("prefill ragged, window 64, softcap 30", "prefill",
     dict(B=2, Sq=96, Skv=320, Hq=8, Hkv=2, offs=[100, 0], lens=[196, 60],
          window=64, softcap=30.0)),
    ("decode G=8, window 300, softcap 30", "decode",
     dict(B=4, L=1024, Hq=16, Hkv=2, cur=[1023, 0, 500, 700], window=300,
          softcap=30.0)),
    ("decode G=16", "decode", dict(B=3, L=1024, Hq=32, Hkv=2,
                                   cur=[1023, 129, 5], window=0,
                                   softcap=0.0)),
    ("rank slice pos0=512 L=512, window 300", "partial",
     dict(B=4, L=512, Hq=16, Hkv=2, pos0=512, cur=[1023, 600, 100, 700],
          window=300, softcap=0.0)),
    ("paged, interleaved 128-token pages", "paged",
     dict(B=4, Hq=16, Hkv=2, cur=[0, 700, 1500, 2047])),
]


#: WKV6's inputs (chip_smoke._wkv_inputs): (label, B, S, H, K, RWKV-6's
#: decays, zero initial state), f32
WKV6_CASES = [
    ("wkv6 B=2 S=300 H=4 K=64, carried state", 2, 300, 4, 64, False, False),
    ("wkv6 B=1 S=1024 H=40 K=64, RWKV-6 decays, zero state", 1, 1024, 40, 64,
     True, True),
]


def kernel_outputs(seed0=7):
    """The four attention wrappers' outputs on OUTPUT_CASES at every head
    dim in HEAD_DIMS, bf16 and f32, as {label: cpu tensor}: the same
    inputs in any checkout (each case's generator has its own seed)."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops as kops
    outs = {}
    for i, (label, kind, a) in enumerate(OUTPUT_CASES):
        for D in HEAD_DIMS:
            for dt in (torch.bfloat16, torch.float32):
                g = torch.Generator(device="cuda").manual_seed(
                    seed0 + 1000 * i + D)

                def rand(*shape):
                    return torch.randn(shape, generator=g,
                                       device="cuda").to(dt)
                if kind == "prefill":
                    q = rand(a["B"], a["Sq"], a["Hq"], D)
                    k, v = (rand(a["B"], a["Skv"], a["Hkv"], D)
                            for _ in range(2))
                    got = kops.prefill_attention(
                        q, k, v, cs.i32(a["offs"]), cs.i32(a["lens"]),
                        window=a["window"], softcap=a["softcap"])
                elif kind == "decode":
                    q = rand(a["B"], a["Hq"], D)
                    k, v = (rand(a["B"], a["L"], a["Hkv"], D)
                            for _ in range(2))
                    got = kops.decode_attention_op(
                        q, k, v, cs.i32(a["cur"]), window=a["window"],
                        softcap=a["softcap"])
                elif kind == "partial":
                    q = rand(a["B"], a["Hq"], D)
                    k, v = (rand(a["B"], a["L"], a["Hkv"], D)
                            for _ in range(2))
                    got = torch.cat([t.reshape(-1) for t in
                                     kops.decode_attention_partial(
                                         q, k, v, cs.i32(a["cur"]), a["pos0"],
                                         window=a["window"],
                                         softcap=a["softcap"])])
                else:
                    tables = torch.as_tensor(cs.interleaved_tables(
                        [c + 1 for c in a["cur"]], 40, 16), device="cuda")
                    q = rand(a["B"], a["Hq"], D)
                    pk, pv = (rand(40, 128, a["Hkv"], D) for _ in range(2))
                    got = kops.paged_decode_attention(q, pk, pv, tables,
                                                      cs.i32(a["cur"]))
                tag = "bf16" if dt == torch.bfloat16 else "f32"
                outs[f"{label}, D={D} {tag}"] = got.cpu()
    for i, (label, B, S, H, K, decay, zero) in enumerate(WKV6_CASES):
        g = torch.Generator(device="cuda").manual_seed(seed0 + 5000 + i)
        y, sT = kops.wkv6_op(*cs._wkv_inputs(g, B, S, H, K, decay, zero))
        outs[label] = torch.cat([y.reshape(-1), sT.reshape(-1)]).cpu()
    return outs


def worker(root: Path, out: Path) -> int:
    """One turn: build, the prefill outputs, then phase 2, in `root`."""
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops as kops
    card = cs.phase_build()
    g = torch.Generator(device="cuda").manual_seed(1)
    outs, prefill_ms = {}, []
    for label, B, Sq, Skv, Hq, Hkv, D, off, n, win, cap in PREFILL_SHAPES:
        sets = []
        for _ in range(cs.n_copies((Sq * Hq + 2 * Skv * Hkv) * D * 2 * B)):
            q = torch.randn((B, Sq, Hq, D), generator=g, device="cuda")
            k = torch.randn((B, Skv, Hkv, D), generator=g, device="cuda")
            v = torch.randn((B, Skv, Hkv, D), generator=g, device="cuda")
            q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
            o = torch.full((B,), off, dtype=torch.int32, device="cuda")
            ln = torch.full((B,), n, dtype=torch.int32, device="cuda")
            sets.append((q, k, v, o, ln))
        prefill_ms.append(cs.time_ms(
            lambda q, k, v, o, ln: kops.prefill_attention(
                q, k, v, o, ln, window=win, softcap=cap), sets)["ms"])
        q, k, v, o, ln = sets[0]
        del sets
        got = kops.prefill_attention(q, k, v, o, ln, window=win, softcap=cap)
        outs[f"timed prefill {label}, D={D} bf16"] = got.cpu()
        del q, k, v, got
    outs.update(kernel_outputs())
    torch.save(outs, out.with_suffix(".pt"))
    _, rows = cs.phase_parity()
    out.write_text(json.dumps({"card": card,
                               "prefill_ms": prefill_ms, "rows": {
        name: {k: r.get(k) for k in ("ms", "eager_ms", "plain_ms",
                                     "library_ms", "bound", "shape")}
        for name, r in rows.items()}}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--may-differ", default=None, metavar="REGEX",
                    help="labels of outputs held only run to run")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker is not None:
        return worker(a.other.resolve(), a.worker)
    import torch
    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device", file=sys.stderr)
        return 1
    SAVED.mkdir(parents=True, exist_ok=True)
    trees = {"other": a.other.resolve(), "this": ROOT}
    turns = ["other", "this", "this", "other"]
    runs = []
    for i, name in enumerate(turns):
        out = SAVED / f"turn_{i}_{name}.json"
        print(f"[compare] turn {i}: {name} ({trees[name]})", flush=True)
        r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            str(trees[name]), "--worker", str(out)],
                           cwd=trees[name])
        if r.returncode != 0:
            print(f"chip_compare: turn {i} ({name}) failed", file=sys.stderr)
            return 1
        runs.append((name, out))
    saved = [torch.load(o.with_suffix(".pt")) for _, o in runs]
    data = [(n, json.loads(o.read_text())) for n, o in runs]
    # turn 0 (other) against turn 1 (this), and each checkout's two turns
    verdict, differ = {}, {}
    for label in saved[0]:
        runs = bool(torch.equal(saved[1][label], saved[2][label])
                    and torch.equal(saved[0][label], saved[3][label]))
        same = bool(torch.equal(saved[0][label], saved[1][label]))
        if a.may_differ and re.search(a.may_differ, label):
            differ[label] = (saved[0][label].float()
                             - saved[1][label].float()).abs().max().item()
            verdict[label] = runs
            print(f"[compare] {label}: may differ; bit-equal run to run: "
                  f"{runs}; bit-equal to the other checkout: {same}, largest "
                  f"|difference| {differ[label]:.3g}")
        else:
            verdict[label] = runs and same
            print(f"[compare] {label}: bit-equal to the other checkout and "
                  f"run to run: {verdict[label]}")
    print(f"[compare] outputs meeting their rule: {sum(verdict.values())} of "
          f"{len(verdict)} ({len(differ)} allowed to differ from the other "
          f"checkout)")
    for i, (label, *_) in enumerate(PREFILL_SHAPES):
        print(f"[compare] prefill {label}: kernel ms (graph) " + ", ".join(
            f"{t}_{n} {d['prefill_ms'][i]:.4f}"
            for t, (n, d) in enumerate(data)))
    print(f"[compare] {data[0][1]['card']}")
    table = {}
    names = [n for _, d in data for n in d["rows"]]
    for row in dict.fromkeys(names):         # every turn's rows, in order
        r0 = next(d["rows"][row] for _, d in data if row in d["rows"])
        table[row] = {"shape": r0.get("shape"), "bound_ms": r0["bound"][0]}
        for i, (n, d) in enumerate(data):
            r = d["rows"].get(row)
            table[row][f"{i}_{n}"] = None if r is None else r["ms"]
            if r is not None and r["library_ms"] is not None:
                table[row][f"{i}_{n}_library"] = r["library_ms"]
        print(f"[compare] {row}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in table[row].items()
            if isinstance(v, float)))
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps({
            "card": data[0][1]["card"], "turns": turns,
            "bit_equal": verdict, "may_differ": differ,
            "prefill_ms": {p[0]: [d["prefill_ms"][i] for _, d in data]
                           for i, p in enumerate(PREFILL_SHAPES)},
            "rows": table}, indent=1))
    return 0 if all(verdict.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
