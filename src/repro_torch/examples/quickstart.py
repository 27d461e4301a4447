"""Quickstart: the TokenScale pipeline in ~60 lines.

1. offline-profile Token Velocity for a (model, chip) pair,
2. plan the Convertible-Decoder restriction (chunk size, Eq.5-6),
3. serve a burst through a real PyTorch engine in convertible mode,
4. compare autoscaling policies on a bursty trace.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import (CHIPS, InstanceSpec, plan_convertible, profile)
from repro_torch.models import init_params
from repro_torch.serving import Engine, Request
from repro_torch.sim import compare_policies


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # -- 1. Token Velocity profile (the paper's Table II methodology) ------
    cfg_full = get_config("llama-3.1-8b")
    inst = InstanceSpec(CHIPS["h100"], tp=4)
    prof = profile(cfg_full, inst)
    print(f"V_P = {prof.v_prefill:,.0f} tok/s   "
          f"V_N = {prof.v_network:,.0f} tok/s")
    print("V_D per bucket:",
          {b: f"{v:,.0f}" for b, v in sorted(prof.v_decode.items())})

    # -- 2. Convertible-Decoder planning (Eq. 5-6) --------------------------
    conv = plan_convertible(cfg_full, inst, expected_decode_batch=32,
                            avg_ctx=1200.0, burst_ratio=0.2, max_decoders=8)
    print(f"\nconvertible: chunk={conv.chunk_size} tokens, "
          f"V_D^P'={conv.v_prefill:,.0f} tok/s, "
          f"reserved={conv.mem_reserved / 1e9:.2f} GB, "
          f"pool={conv.pool_size}")

    # -- 3. a real engine in convertible mode (smoke model) -----------------
    cfg = get_config("llama-3.1-8b", smoke=True)
    params = init_params(
        cfg, torch.Generator(device=args.device).manual_seed(0), args.device)
    eng = Engine(cfg, params, num_slots=3, max_len=96, chunk_size=8)
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i,
                    prompt=rng.randint(0, cfg.vocab_size,
                                       size=(L,)).astype(np.int32),
                    max_new_tokens=8)
            for i, L in enumerate([5, 7, 40])]    # 40 = the "burst" prompt
    for r in reqs:
        eng.add_request(r)
    eng.run_until_drained()
    print("\nengine outputs:", {r.rid: r.output[:4] for r in reqs})

    # -- 4. policies head-to-head on a bursty trace --------------------------
    print("\npolicy comparison (mixed trace, 60 s):")
    for name, rep in compare_policies("mixed", duration=60.0,
                                      rps=8.0).items():
        print(f"  {name:12s} SLO={rep.slo_attainment() * 100:5.1f}%  "
              f"avg_gpus={rep.avg_gpus():.2f}")


if __name__ == "__main__":
    main()
