#!/usr/bin/env python3
"""Time chip_smoke.py's phase 2 kernel rows of this checkout and of another
checkout of the repo on one card, in turns, and check the prefill kernel's
outputs: the same bits in both at D <= 128, within the bf16 bounds of the
plain version at D = 256.

    python3 chip_compare.py OTHER_ROOT [--out FILE]

OTHER_ROOT is another checkout (an older commit unpacked with
``git archive``).  Each turn runs one checkout's phase 1 (build) and phase
2 (parity and times) in a process of its own, so that each imports its own
``repro_torch``; the turns go other, this, this, other.  Before its
phase 2, each turn runs the prefill kernel on phase 2's prefill shapes
with inputs from seed 1 and saves the outputs; the first turn of each
checkout's are compared bit for bit at D <= 128 (the outputs are kept
under build/compare/, with each turn's rows).  At D = 256, where the bf16
kernel is prefill_wg_kernel here and prefill_tc_kernel<256> before it,
each turn holds its outputs to the plain version (kernels/ref.py
chunked_prefill_attention_ref) on the same inputs: 3e-2 and 2e-5 + 2 bf16
steps (chip_smoke.close, chip_smoke.bf16_bound_share).  Prints each row's
kernel ms in every turn beside the card's name and power limit, and with
--out writes it all to FILE as JSON.  Exits 1 unless every D <= 128 shape
is bit-equal and every D = 256 shape of both checkouts is within the
bounds.  Needs one card.
"""
from __future__ import annotations

import argparse
import json
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
    ("Qwen heads, prompt", 1, 512, 2048, 40, 8, 128, 0, 512, 0, 0.0),
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


def worker(root: Path, out: Path) -> int:
    """One turn: build, the prefill outputs, then phase 2, in `root`."""
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    card = cs.phase_build()
    g = torch.Generator(device="cuda").manual_seed(1)
    outs, judged, prefill_ms = [], [], []
    for _, B, Sq, Skv, Hq, Hkv, D, off, n, win, cap in PREFILL_SHAPES:
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
        outs.append(got.cpu())
        if D == 256:
            want = ref.chunked_prefill_attention_ref(q, k, v, o, ln,
                                                     window=win, softcap=cap)
            judged.append([cs.bf16_bound_share(got, want),
                           cs.close(got, want, 3e-2)])
            del want
        else:
            judged.append(None)
    torch.save(outs, out.with_suffix(".pt"))
    _, rows = cs.phase_parity()
    out.write_text(json.dumps({"card": card, "judged": judged,
                               "prefill_ms": prefill_ms, "rows": {
        name: {k: r.get(k) for k in ("ms", "eager_ms", "plain_ms",
                                     "library_ms", "bound", "shape")}
        for name, r in rows.items()}}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
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
    first = {n: next(o for m, o in runs if m == n) for n in trees}
    got = {n: torch.load(first[n].with_suffix(".pt")) for n in trees}
    data = [(n, json.loads(o.read_text())) for n, o in runs]
    verdict = {}
    for i, (label, *_, D, _o, _n, _w, _c) in enumerate(PREFILL_SHAPES):
        if D < 256:
            verdict[label] = bool(torch.equal(got["other"][i],
                                              got["this"][i]))
            print(f"[compare] prefill {label}: bit-equal {verdict[label]}")
            continue
        held = [d["judged"][i] for _, d in data]
        verdict[label] = all(share <= 1 and ok for share, ok in held)
        print(f"[compare] prefill {label} (D = 256): against the plain "
              f"version, each turn's share of the 2e-5 + 2 bf16 steps bound "
              f"and 3e-2 held: " + ", ".join(
                  f"{n} {share:.3g} {ok}"
                  for (n, _), (share, ok) in zip(data, held))
              + f"; bit-equal to the other checkout "
              f"{bool(torch.equal(got['other'][i], got['this'][i]))}")
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
            "prefill_held": verdict,
            "prefill_ms": {p[0]: [d["prefill_ms"][i] for _, d in data]
                           for i, p in enumerate(PREFILL_SHAPES)},
            "rows": table}, indent=1))
    return 0 if all(verdict.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
