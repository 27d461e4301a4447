"""The train step and the host loop.

``make_train_step`` builds the (params, opt, tokens, labels) -> (params,
opt, metrics) step: loss = causal LM cross-entropy + the MoE router aux,
gradients by autograd through ``forward_train`` (attention and WKV6
through their kernels on the card, each with the plain version's VJP as
its backward, ``kernels/ops.py``), then AdamW in place.  No ``jax.jit``
here, and no ``torch.compile``: the step runs eagerly.  The step and the
loop run on the device they are given, "cuda" unless the caller passes
"cpu", and refuse parameters on another.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward_train, init_params
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_init, adamw_update)


def lm_loss(cfg: ModelConfig, params, tokens, labels, image_embeds=None,
            remat: bool = False,
            plain_kernels: bool = False) -> tuple[torch.Tensor, dict]:
    """(ce + aux, {"ce", "aux"}); `plain_kernels` runs the forward through
    the plain versions in place of the kernels (to compare with them)."""
    logits, aux = forward_train(cfg, params, tokens,
                                image_embeds=image_embeds, remat=remat,
                                plain_kernels=plain_kernels)
    logp = torch.log_softmax(logits, dim=-1)
    labels = torch.as_tensor(labels).to(logp.device).long()
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    ce = -ll.mean()
    return ce + aux, {"ce": ce, "aux": aux}


def _check_device(params, device):
    if params.device.type != torch.device(device).type:
        raise ValueError(f"the parameters are on {params.device}, the step "
                         f"runs on {device}")


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    remat: bool = False, device="cuda") -> Callable:
    """step(params, opt, tokens, labels, image_embeds=None) -> (params,
    opt, metrics {"loss", "ce", "aux", "grad_norm", "lr"}).  The step
    turns ``requires_grad`` on for every leaf of `params` and updates them
    in place; the update runs in a profiler range named "adamw_update", so
    that a profile of the step can tell its device time apart."""
    def step(params, opt: AdamWState, tokens, labels, image_embeds=None):
        _check_device(params, device)
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        loss, parts = lm_loss(cfg, params, tokens, labels, image_embeds,
                              remat=remat)
        grads = dict(zip(named, torch.autograd.grad(
            loss, list(named.values()), allow_unused=True,
            materialize_grads=True)))
        with torch.profiler.record_function("adamw_update"):
            params, opt, om = adamw_update(opt_cfg, grads, opt, params)
        del grads
        metrics = {"loss": loss.detach(), "ce": parts["ce"].detach(),
                   "aux": parts["aux"].detach(), **om}
        return params, opt, metrics

    return step


@dataclass
class TrainResult:
    losses: list
    steps: int
    wall_s: float


def train(cfg: ModelConfig, *, steps: int, batch: int, seq_len: int,
          opt_cfg: Optional[AdamWConfig] = None, seed: int = 0,
          log_every: int = 10, params=None, log_fn=print,
          device="cuda") -> tuple[object, TrainResult]:
    """Single-device training loop over the synthetic packed dataset."""
    from repro_torch.training.data import DataConfig, PackedDataset
    opt_cfg = opt_cfg or AdamWConfig(total_steps=steps,
                                     warmup_steps=max(steps // 20, 5))
    if params is None:
        params = init_params(cfg, torch.Generator(device=device)
                             .manual_seed(seed), device)
    _check_device(params, device)
    opt = adamw_init(params, opt_cfg)
    ds = PackedDataset(DataConfig(cfg.vocab_size, seq_len, batch, seed))
    step_fn = make_train_step(cfg, opt_cfg, device=device)
    losses = []
    t0 = time.time()
    for i in range(steps):
        tokens, labels = ds.batch(i)
        params, opt, m = step_fn(params, opt, tokens, labels)
        losses.append(float(m["loss"]))
        if log_every and (i % log_every == 0 or i == steps - 1):
            log_fn(f"step {i:5d} loss={losses[-1]:.4f} "
                   f"lr={float(m['lr']):.2e} gnorm={float(m['grad_norm']):.3f}")
    return params, TrainResult(losses, steps, time.time() - t0)
