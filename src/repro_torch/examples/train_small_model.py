"""End-to-end training run: train a reduced model for a few hundred
steps on the synthetic packed corpus, checkpoint, restore, and keep going.

    PYTHONPATH=src python -m repro_torch.examples.train_small_model \\
        [--steps 200] [--device cpu]
"""
import argparse
import tempfile

from repro_torch.configs import get_config
from repro_torch.training import AdamWConfig, restore, save, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=True)
    opt_cfg = AdamWConfig(lr=3e-4, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 5))
    params, res = train(cfg, steps=args.steps // 2, batch=args.batch,
                        seq_len=args.seq_len, opt_cfg=opt_cfg,
                        log_every=20, device=args.device)
    print(f"[phase 1] loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}")

    with tempfile.TemporaryDirectory() as d:
        save(d, params, step=res.steps)
        params2, step = restore(d, like=params)
        print(f"[checkpoint] round-trip at step {step} OK")

    params3, res2 = train(cfg, steps=args.steps - args.steps // 2,
                          batch=args.batch, seq_len=args.seq_len,
                          opt_cfg=opt_cfg, params=params2, log_every=20,
                          device=args.device)
    print(f"[phase 2] loss {res2.losses[0]:.3f} -> {res2.losses[-1]:.3f}")
    if not res2.losses[-1] < res.losses[0]:
        raise SystemExit("training did not improve")
    print("done: loss improved across checkpoint boundary")


if __name__ == "__main__":
    main()
