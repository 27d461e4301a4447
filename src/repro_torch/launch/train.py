"""Training launcher on the port.

The counterpart of the reference package's ``repro.launch.train``, with the
same options plus ``--device`` ("cuda" unless the caller passes "cpu"): a
real run of a config (``--smoke`` for the reduced one) on the synthetic
packed corpus, printing one JSON line:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --smoke --steps 50 --batch 8 --seq-len 128 [--device cpu]
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config
from repro_torch.training import AdamWConfig, save, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None,
                    help="directory to save the final checkpoint")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 5))
    params, res = train(cfg, steps=args.steps, batch=args.batch,
                        seq_len=args.seq_len, opt_cfg=opt_cfg,
                        seed=args.seed, device=args.device)
    if args.checkpoint:
        save(args.checkpoint, params, step=res.steps)
        print(f"checkpoint -> {args.checkpoint}")
    print(json.dumps({"arch": cfg.name, "steps": res.steps,
                      "loss_first": res.losses[0],
                      "loss_last": res.losses[-1],
                      "wall_s": round(res.wall_s, 2)}))


if __name__ == "__main__":
    main()
