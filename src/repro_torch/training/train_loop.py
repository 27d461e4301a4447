"""The train step and the host loop.

``make_train_step`` builds the (params, opt, tokens, labels) -> (params,
opt, metrics) step: loss = causal LM cross-entropy + the MoE router aux,
gradients by autograd through ``forward_train`` (attention and WKV6
through their kernels on the card, each with the plain version's VJP as
its backward, ``kernels/ops.py``), then AdamW in place.  No ``jax.jit``
here, and no ``torch.compile``: the step runs eagerly.  The step and the
loop run on the device they are given, "cuda" unless the caller passes
"cpu", and refuse parameters on another.

Under ``sharding.axis_rules(rules, mesh)`` the step is the reference's
step of the global batch, which XLA's SPMD partitioner gives it under
``jit`` with shardings: each rank holds its shard of the batch over the
rules' "batch" axes and its shard of each leaf as the model was built
(``init_params(..., mesh, rules)``).  Each rank differentiates its share
of the global mean loss (its local mean CE over the number of batch
shards; the MoE aux already carries its own share, ``models.ops._AuxMean``
on the expert-parallel path and ``_SumShards`` on the dense one), each
leaf's gradient is summed over the batch axes that do not split the leaf,
and the clip norm sums each sharded leaf's squares over the ranks that
hold its shards; all through ``sharding.all_reduce``.  The clip and the
update are the single-device ones.  With tensor parallelism (a model built
with its heads, d_ff and vocab split over "model") the gradient of a split
leaf is the rank's shard's, and stays local; a leaf replicated over
"model" gets the same whole gradient on every rank of it (the layers'
``_Enter`` all-reduces the gradient where replicated activations turn
rank-specific), so it is summed over the batch axes only.  The loss never
gathers the (B, S, V) logits: ``lm_loss`` takes the cross-entropy of the
rank's vocab slice, the row max, the sum of exps and the label's logit
each reduced over the vocab's split, as the reference's ``log_softmax`` of
vocab-sharded logits partitions.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.models import init_params
from repro_torch.models.ops import _Leave
from repro_torch.models.params import _leaf_modules, _prefix, built_axes
from repro_torch.models.transformer import forward_train_local
from repro_torch.sharding import (all_reduce, axes_size, axis_group,
                                  current_mesh, current_rules, mesh_axes)
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_init, adamw_update)


def lm_loss(cfg: ModelConfig, params, tokens, labels, image_embeds=None,
            remat: bool = False,
            plain_kernels: bool = False) -> tuple[torch.Tensor, dict]:
    """(ce + aux, {"ce", "aux"}); `plain_kernels` runs the forward through
    the plain versions in place of the kernels (to compare with them).
    With the vocab split (module docstring) the cross-entropy is computed
    on the rank's slice of the logits."""
    logits, aux, sv = forward_train_local(
        cfg, params, tokens, image_embeds=image_embeds, remat=remat,
        plain_kernels=plain_kernels)
    labels = torch.as_tensor(labels).to(logits.device).long()
    if sv is None:
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, labels[..., None])[..., 0]
        ce = -ll.mean()
    else:
        ce = _vocab_parallel_ce(logits, labels, sv)
    return ce + aux, {"ce": ce, "aux": aux}


def _vocab_parallel_ce(logits, labels, sv):
    """The mean of -log softmax(logits)[label] over the rows, from this
    rank's vocab slice (B, S, V / n) of the logits: the row max (taken
    over the split, no gradient: any shift gives the same value), the sum
    of the exps and the label's logit (zero on the ranks without it), each
    summed over the split with ``_Leave`` (every rank's loss is the same;
    each rank's slice gets its own gradient)."""
    V = logits.shape[-1]
    m = all_reduce(logits.detach().amax(-1), sv.group, dist.ReduceOp.MAX)
    se = _Leave.apply(torch.exp(logits - m[..., None]).sum(-1), sv.group)
    loc = labels - sv.i * V
    mine = (loc >= 0) & (loc < V)
    ll = torch.gather(logits, -1, loc.clamp(0, V - 1)[..., None])[..., 0]
    ll = _Leave.apply(torch.where(mine, ll, 0.0), sv.group)
    return (m + torch.log(se) - ll).mean()


def _check_device(params, device):
    if params.device.type != torch.device(device).type:
        raise ValueError(f"the parameters are on {params.device}, the step "
                         f"runs on {device}")


@dataclass
class _DataParallel:
    """How a step under a mesh makes the global batch's gradient: the
    number of batch shards and their group, and for each leaf's name the
    group its gradient is summed over and the group of the ranks holding
    its shards (for the clip norm)."""
    n_batch: int
    batch: object
    reduce: dict
    norm: dict


def _data_parallel(params) -> Optional[_DataParallel]:
    """The active (mesh, rules)'s `_DataParallel` for `params`, or None
    with no mesh.  Only mesh axes of size > 1 count."""
    mesh = current_mesh()
    if mesh is None:
        return None
    sizes = mesh_axes(mesh)
    b_axes = tuple(a for a in (current_rules() or {}).get("batch", ())
                   if sizes.get(a, 1) > 1)
    reduce, norm = {}, {}
    for i, mod in _leaf_modules(params):
        prefix = _prefix(i)
        for name in mod.leaves:
            split = {a for dim in built_axes(mod, name, mesh) or ()
                     for a in dim if sizes[a] > 1}
            over = tuple(a for a in b_axes if a not in split)
            if over:
                reduce[prefix + name] = axis_group(mesh, over)
            if split:
                norm[prefix + name] = axis_group(
                    mesh, tuple(a for a in sizes if a in split))
    return _DataParallel(axes_size(mesh, b_axes),
                         axis_group(mesh, b_axes) if b_axes else None,
                         reduce, norm)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    remat: bool = False, device="cuda",
                    plain_kernels: bool = False) -> Callable:
    """step(params, opt, tokens, labels, image_embeds=None) -> (params,
    opt, metrics {"loss", "ce", "aux", "grad_norm", "lr"}).  The step
    turns ``requires_grad`` on for every leaf of `params` and updates them
    in place; the update runs in a profiler range named "adamw_update", so
    that a profile of the step can tell its device time apart.  Under a
    mesh (module docstring) it steps on the global batch, and its metrics
    are the global batch's.  `plain_kernels` as ``lm_loss``'s."""
    def step(params, opt: AdamWState, tokens, labels, image_embeds=None):
        _check_device(params, device)
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        dp = _data_parallel(params)
        loss, parts = lm_loss(cfg, params, tokens, labels, image_embeds,
                              remat=remat, plain_kernels=plain_kernels)
        ce, aux = parts["ce"], parts["aux"]
        if dp is not None:
            # this rank's share of the global mean; aux carries its own
            loss = ce / dp.n_batch + aux
        grads = dict(zip(named, torch.autograd.grad(
            loss, list(named.values()), allow_unused=True,
            materialize_grads=True)))
        if dp is not None:
            for name, group in dp.reduce.items():
                grads[name] = all_reduce(grads[name], group)
            ce = ce.detach()
            if dp.batch is not None:
                ce = all_reduce(ce, dp.batch) / dp.n_batch
            loss = ce + aux
        with torch.profiler.record_function("adamw_update"):
            params, opt, om = adamw_update(opt_cfg, grads, opt, params,
                                           None if dp is None else dp.norm)
        del grads
        metrics = {"loss": loss.detach(), "ce": ce.detach(),
                   "aux": aux.detach(), **om}
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
