"""Render the §Dry-run / §Roofline tables from results_dryrun.jsonl.

    PYTHONPATH=src python -m repro_torch.launch.roofline_report [results_dryrun.jsonl]

Emits markdown: the full per-(arch x shape) roofline table (single-pod,
as prescribed), the multi-pod lowering check, and the three hillclimb
candidates (worst roofline fraction / most collective-bound / most
paper-representative).
"""
from __future__ import annotations

import json
import sys


def load(path: str) -> dict:
    recs = {}
    for line in open(path):
        r = json.loads(line)
        recs[(r["arch"], r["shape"], r["mesh"])] = r   # keep last
    return recs


def fmt_t(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def render(recs: dict) -> str:
    out = []
    out.append("### Single-pod (16x16 = 256 chips) roofline — all pairs\n")
    out.append("| arch | shape | compute | memory | collective |"
               " bottleneck | MODEL/HLO flops | coll GB/chip |")
    out.append("|---|---|---|---|---|---|---|---|")
    rows = []
    for (arch, shape, mesh), r in sorted(recs.items()):
        if mesh != "16x16":
            continue
        if r["status"] == "skipped":
            out.append(f"| {arch} | {shape} | — | — | — | *skipped:"
                       f" sub-quadratic required* | — | — |")
            continue
        if r["status"] != "ok":
            out.append(f"| {arch} | {shape} | ERROR | | | | | |")
            continue
        rows.append(r)
        out.append(
            f"| {arch} | {shape} | {fmt_t(r['t_compute_s'])} "
            f"| {fmt_t(r['t_memory_s'])} | {fmt_t(r['t_collective_s'])} "
            f"| **{r['bottleneck']}** | {r['useful_ratio']:.2f} "
            f"| {r['collective_bytes_per_chip'] / 1e9:.1f} |")

    out.append("\n### Multi-pod (2x16x16 = 512 chips) lowering check\n")
    ok = sum(1 for (a, s, m), r in recs.items()
             if m == "2x16x16" and r["status"] == "ok")
    sk = sum(1 for (a, s, m), r in recs.items()
             if m == "2x16x16" and r["status"] == "skipped")
    er = [(a, s) for (a, s, m), r in recs.items()
          if m == "2x16x16" and r["status"] == "error"]
    out.append(f"{ok} pairs compile, {sk} documented skips, "
               f"{len(er)} errors {er if er else ''}.")

    # hillclimb candidate selection
    out.append("\n### Hillclimb candidates\n")
    worst = min(rows, key=lambda r: r["useful_ratio"])
    coll = max(rows, key=lambda r: (r["t_collective_s"]
                                    / max(r["t_compute_s"]
                                          + r["t_memory_s"], 1e-12)))
    out.append(f"* worst useful-flops fraction: **{worst['arch']} x "
               f"{worst['shape']}** (ratio {worst['useful_ratio']:.3f})")
    out.append(f"* most collective-bound: **{coll['arch']} x "
               f"{coll['shape']}** (t_coll {fmt_t(coll['t_collective_s'])} "
               f"vs compute+mem {fmt_t(coll['t_compute_s'] + coll['t_memory_s'])})")
    out.append("* most paper-representative: **llama-3.1-8b x decode_32k** "
               "(the paper's small-model decode stage — V_D's roofline)")
    return "\n".join(out)


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "results_dryrun.jsonl"
    print(render(load(path)))


if __name__ == "__main__":
    main()
