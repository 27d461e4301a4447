"""The closed loop's client count, swept once when a cell is defined.

    python3 portbench/sweep.py --workload <cell> --seconds <s> --seed <n>
        --clients <C> [<C> ...]

Runs the cell at each client count in one process and prints, for each,
the end-to-end metrics and ``prefill_step_share``; the cell takes the
smallest count at which that share reaches its plateau.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
READ = ("prefill_step_share", "ttft_p90_ms", "tok_s", "itl_p90_ms",
        "decode_step_ms", "mixed_step_ms", "cluster_step_ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--clients", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.run import set_caches
    set_caches()
    import torch

    from portbench import harness
    from portbench.metrics import reader
    device = torch.device("cuda", 0)
    for c in args.clients:
        cell = harness.Cell.named(args.workload, clients=c)
        out = harness.run(cell, args.seed, args.seconds, False, device,
                          time.perf_counter())
        log = out["log"]
        row = {"clients": c, "correct": out["correct"],
               "peak_gib": out["device"]["memory_peak_bytes"] / 2 ** 30,
               "window_steps": len(log.window_steps())}
        row.update({m: reader(m)(log) for m in READ})
        print(json.dumps(row), flush=True)
        del out, log
    return 0


if __name__ == "__main__":
    sys.exit(main())
