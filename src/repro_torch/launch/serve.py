"""Serving launcher: a convertible-decoder engine on the port.

The counterpart of the reference package's ``repro.launch.serve``, with the
same options plus ``--device``: it builds a smoke-scale model from a seed on
the device, replays random prompts through one ``Engine`` and reports what
completed.  The offline Token Velocity profile is of the full model on an
H100 instance:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-3.1-8b \\
        --requests 32 [--device cpu]

``--arch`` takes any of the registry's configs (``configs.ARCH_IDS``) but
llama-3.2-vision-11b, whose requests need an image, as the reference's
launcher's do.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import CHIPS, InstanceSpec, profile
from repro_torch.models import init_params
from repro_torch.serving import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-3.1-8b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--chunk-size", type=int, default=16,
                    help=">0 runs the decoder in convertible mode")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=True)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = init_params(cfg, gen, args.device)
    rng = np.random.RandomState(args.seed)

    prof = profile(get_config(args.arch), InstanceSpec(CHIPS["h100"], tp=1))
    print(f"# offline profile (h100): V_P={prof.v_prefill:.0f} tok/s "
          f"V_N={prof.v_network:.0f} tok/s "
          f"V_D(M-M)={prof.v_decode['M-M']:.0f} tok/s")

    eng = Engine(cfg, params, num_slots=args.slots, max_len=128,
                 chunk_size=args.chunk_size)
    reqs = []
    for i in range(args.requests):
        L = int(rng.randint(4, 48))
        prompt = rng.randint(0, cfg.vocab_size, size=(L,)).astype(np.int32)
        r = Request(rid=i, prompt=prompt, max_new_tokens=args.max_new)
        reqs.append(r)
        eng.add_request(r)
    eng.run_until_drained()
    done = sum(1 for r in reqs if len(r.output) >= args.max_new)
    toks = sum(len(r.output) for r in reqs)
    print(json.dumps({"arch": cfg.name, "device": str(params.device),
                      "requests": len(reqs), "completed": done,
                      "tokens_generated": toks,
                      "convertible_mode": args.chunk_size > 0}))


if __name__ == "__main__":
    main()
