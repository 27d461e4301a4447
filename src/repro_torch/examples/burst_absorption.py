"""Reproduce the paper's Fig. 10 experiment as a runnable scenario:
a 20x RPS burst hits at t=10 s; compare TTFT with and without the
Convertible Decoder (and against the three baseline autoscalers).

    PYTHONPATH=src python -m repro_torch.examples.burst_absorption
    PYTHONPATH=src python -m repro_torch.examples.burst_absorption \\
        --engine=events

``--engine=events`` runs the discrete-event simulator (exact per-request
tails) instead of the default dt-stepped fluid model; see DESIGN.md.
"""
import sys

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import (CHIPS, InstanceSpec, OutputPredictor,
                              plan_convertible, profile)
from repro_torch.sim import step_trace
from repro_torch.sim.runner import get_engine, make_policy


def run(policy_name: str, n_convertible: int, engine: str = "fluid"):
    cfg = get_config("llama-3.1-8b")
    inst = InstanceSpec(CHIPS["a100"], tp=1)
    prof = profile(cfg, inst)
    trace = step_trace(30.0, base_rps=1.0, burst_rps=20.0,
                       burst_start=10.0, burst_len=4.0, seed=3)
    # baseline thresholds calibrated from the actual trace's size stats
    policy = make_policy(policy_name, prof, n_convertible, trace=trace)
    conv = plan_convertible(cfg, inst, 32, 1200.0, 0.2, 8)
    cl = get_engine(engine)(cfg, inst, prof, policy, OutputPredictor(0.85, 3),
                            conv_cfg=conv, n_convertible=n_convertible)
    rep = cl.run(trace, 30.0)
    burst = [r.ttft * 1e3 for r in rep.requests
             if 10.0 <= r.src.t < 14.0 and r.t_first_token >= 0]
    return rep, float(np.percentile(burst, 99)) if burst else float("nan")


def main():
    engine = "fluid"
    for a in sys.argv[1:]:
        if a.startswith("--engine="):
            engine = a.split("=", 1)[1]
    print(f"[{engine} engine] 20x burst at t=10s for 4s; "
          "p99 TTFT of in-burst requests:")
    for name, n_conv in [("tokenscale", 1), ("tokenscale", 0),
                         ("blitzscale", 0), ("distserve", 0),
                         ("aibrix", 0)]:
        rep, p99 = run(name, n_conv, engine)
        label = f"{name}{' +convertible' if n_conv else ''}"
        print(f"  {label:26s} burst p99 TTFT = {p99:8.0f} ms   "
              f"SLO = {rep.slo_attainment() * 100:5.1f}%")
    print("\nThe convertible decoder absorbs what instance startup latency"
          " (5 s) cannot: the burst is over before a new prefiller boots.")


if __name__ == "__main__":
    main()
