"""The readings a cell's correctness limit is set from, in one process.

    python3 portbench/limits.py --workload <cell> --seconds <s>
        --seeds <n> [<n> ...] [--faults <fault> ...]
        [--out <file.json>]

For each seed: a run of the cell at its own load (weights, warm shapes,
the loop's fill, a window of `s` seconds), then the widest gap of the
served tokens against the float32 reference (the program's reading) and,
over the same prompts and tokens, the widest gap of the tokens that the
reference computed from float8 inputs puts first (the control's), each
judged by the same rule as a run's ``correct``.  With ``--faults``, in
place of those: for each fault of ``faults.py`` named, a run of each seed
with that fault planted under the timed path, judged the same way.  The limit lies above the largest
program reading and below the smallest control reading.  The benchmark's
own runs never run the control or a fault.
"""
import argparse
import json
import sys
import time
from contextlib import nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.run import set_caches
    set_caches()
    import torch

    from portbench import faults, harness
    if not torch.cuda.is_available():
        harness.stderr("no CUDA device")
        return 2
    device = torch.device("cuda", 0)
    cell = harness.Cell.named(args.workload)
    rows = []
    for fault in args.faults or [None]:
        for seed in args.seeds:
            t0 = time.perf_counter()
            with faults.FAULTS[fault]() if fault else nullcontext():
                out = harness.run(cell, seed, args.seconds, False, device,
                                  t0, control=None if fault else "fp8")
            gap = out["compared"]["logit_gap"]
            row = {"seed": seed, "fault": fault, "program": gap["value"],
                   "correct": out["correct"], "limit": gap["limit"],
                   "window_steps": len(out["log"].window_steps()),
                   "seconds": time.perf_counter() - t0}
            if not fault:
                row["control"] = out["control"]["logit_gap"]
                row["control_correct"] = out["control"]["correct"]
            rows.append(row)
            harness.stderr(f"[limits] {json.dumps(row)}")
            del out
    summary = {"workload": args.workload, "rows": rows,
               "correct": sum(r["correct"] for r in rows)}
    if not args.faults:
        summary.update(lower=max(r["program"] for r in rows),
                       upper=min(r["control"] for r in rows),
                       controls_correct=sum(r["control_correct"]
                                            for r in rows))
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
