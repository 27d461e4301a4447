"""AdamW and its learning-rate schedule on tensors: the reference package's
``training/optimizer.py`` (linear warmup then cosine decay, clipping by the
global norm, bias corrections, decoupled weight decay on every leaf, bf16
moments and the factored second moment as options).

The parameters are a port model (``models.Transformer``) or a flat dict of
tensors; ``adamw_update`` changes them and the state's moments in place.
The state mirrors the reference's leaves (``models.params.
reference_paths``).  The reference stacks a leaf of the repeated block
along a leading ``num_blocks`` dim, where the port keeps one tensor per
layer: the update is elementwise but for the factored second moment,
which keeps row and column means over a leaf's last two dims.  So a block
leaf of two or more dims per layer has one moment per layer (its rows and
columns are the stacked leaf's), and a block leaf of one dim or none per
layer (a norm, a bias, a mix, a gate) is updated stacked, as the
reference's 1- or 2-D leaf: such leaves are small.  The update goes one
leaf at a time under ``no_grad``, and a leaf's f32 temporaries are freed
before the next one's are made.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.models.params import DTYPES, reference_paths
from repro_torch.sharding import all_reduce


class AdamWState(NamedTuple):
    step: torch.Tensor     # () int32
    m: dict                # reference path -> moment (a list: one a layer)
    v: dict                # the same; a factored moment is a (row, col) pair


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # memory options for frontier-scale models (see DESIGN.md):
    moment_dtype: str = "float32"   # "bfloat16" halves m/v residency
    factored: bool = False          # adafactor-style factored 2nd moment
                                    # (row/col means for >=2D leaves)


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio (f32)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _groups(params):
    """Each reference leaf: (path, its parameters' names, their tensors,
    how its state is kept): "one" a tensor of its own, "each" a tensor a
    layer, "stacked" the layers' tensors stacked (block leaves of at most
    one dim a layer).  A dict's leaves are its own."""
    if isinstance(params, nn.Module):
        named, paths = dict(params.named_parameters()), \
            reference_paths(params)
    else:
        named, paths = params, {n: ([n], False) for n in params}
    for path, (names, stacked) in paths.items():
        ts = [named[n] for n in names]
        kind = "one" if not stacked else ("each" if ts[0].dim() >= 2
                                          else "stacked")
        yield path, names, ts, kind


def adamw_init(params, cfg: AdamWConfig = AdamWConfig()) -> AdamWState:
    mdt = DTYPES[cfg.moment_dtype]

    def zeros_m(shape, dev):
        return torch.zeros(shape, dtype=mdt, device=dev)

    def zeros_v(shape, dev):
        if cfg.factored and len(shape) >= 2:
            # factored second moment: row means + col means over the last
            # two dims (leading stacking dims kept whole)
            return (zeros_m(shape[:-1], dev),
                    zeros_m(shape[:-2] + shape[-1:], dev))
        return zeros_m(shape, dev)

    m, v = {}, {}
    for path, _, ts, kind in _groups(params):
        dev = ts[0].device
        if kind == "each":
            m[path] = [zeros_m(tuple(t.shape), dev) for t in ts]
            v[path] = [zeros_v(tuple(t.shape), dev) for t in ts]
        else:
            shape = tuple(ts[0].shape)
            if kind == "stacked":
                shape = (len(ts),) + shape
            m[path], v[path] = zeros_m(shape, dev), zeros_v(shape, dev)
    return AdamWState(step=torch.zeros((), dtype=torch.int32), m=m, v=v)


def global_norm(tree, groups=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32: `tree` a dict of
    tensors or a module's parameters.  `groups` maps the name of each leaf
    that this rank holds one shard of to the process group of the ranks
    that hold its shards: the squares of the leaves of one group are
    summed over it, in one all-reduce (``sharding.all_reduce``); every
    other leaf is whole on each rank and counted once."""
    named = tree.items() if isinstance(tree, dict) \
        else tree.named_parameters()
    groups = groups or {}
    total, by_group = 0, {}
    for name, x in named:
        sq = torch.sum(torch.square(x.float()))
        if name in groups:
            by_group.setdefault(groups[name], []).append(sq)
        else:
            total = total + sq
    for group, sqs in by_group.items():
        total = total + all_reduce(torch.stack(sqs).sum(), group)
    return torch.sqrt(total)


def _mean(x, dim: int, split):
    """The mean of `x` over dim `dim` of the whole leaf: with `split` =
    (group, n) this rank holds one of n shards of that dim, and the sum is
    taken over the group."""
    if split is None:
        return x.mean(dim=dim)
    group, n = split
    return all_reduce(x.sum(dim=dim), group) / (x.shape[dim] * n)


@torch.no_grad()
def _update_leaf(cfg: AdamWConfig, p, g, m, v, scale, lr, bc1, bc2,
                 split=(None, None)):
    """The reference's ``upd`` for one leaf, in place: p, m and v (or its
    row / col pair) take their new values.  `split` says, for the leaf's
    last dim and the one before it, how this rank's shard cuts it: None
    (whole) or (group, n); the factored moment's row and column means are
    then the whole leaf's, as the reference's under GSPMD."""
    g = g.float() * scale
    mf = cfg.b1 * m.float() + (1 - cfg.b1) * g
    if isinstance(v, tuple):   # factored second moment
        vr, vc = v
        last, second = split
        g2 = g.mul_(g)
        vrf = cfg.b2 * vr.float() + (1 - cfg.b2) * _mean(g2, -1, last)
        vcf = cfg.b2 * vc.float() + (1 - cfg.b2) * _mean(g2, -2, second)
        del g, g2
        vh = (vrf[..., None] * vcf[..., None, :]
              / torch.clamp(_mean(vrf, -1, second)[..., None, None],
                            min=1e-30)) / bc2
        vr.copy_(vrf)
        vc.copy_(vcf)
    else:
        vf = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        del g
        vh = vf / bc2
        v.copy_(vf)
        del vf
    m.copy_(mf)
    delta = mf.div_(bc1).div_(vh.sqrt_().add_(cfg.eps))   # mh / (√vh + eps)
    del vh
    delta.add_(cfg.weight_decay * p.float())
    p.copy_(p.float() - lr * delta)


def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params,
                 norm_groups=None, splits=None):
    """Returns (params, new_state, metrics): `params` and the state's
    moments changed in place.  `grads` maps each of the parameters' names
    (a module's ``named_parameters``, or the dict's keys) to its
    gradient; a sharded leaf's gradient is this rank's shard, and
    `norm_groups` (``global_norm``'s `groups`) says where its other shards
    are, so that the clip norm is the whole tree's.  `splits` maps a
    sharded leaf's name to how its last two dims are cut (last, the one
    before), each None or (group, n), for the factored moment's means."""
    splits = splits or {}
    gnorm = global_norm(grads, norm_groups)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip else torch.ones(())
    step = state.step + 1
    lr = lr_at(cfg, step)
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()
    for path, names, ts, kind in _groups(params):
        m, v = state.m[path], state.v[path]
        if kind == "one":
            _update_leaf(cfg, ts[0], grads[names[0]], m, v, scale, lr, bc1,
                         bc2, splits.get(names[0], (None, None)))
        elif kind == "each":
            for t, n, mi, vi in zip(ts, names, m, v):
                _update_leaf(cfg, t, grads[n], mi, vi, scale, lr, bc1, bc2,
                             splits.get(n, (None, None)))
        else:
            # a layer's one dim is the stack's last, the layers before it
            with torch.no_grad():
                p = torch.stack(ts)
                _update_leaf(cfg, p, torch.stack([grads[n] for n in names]),
                             m, v, scale, lr, bc1, bc2,
                             (splits.get(names[0], (None,))[0], None))
                for i, t in enumerate(ts):
                    t.copy_(p[i])
    return params, AdamWState(step, state.m, state.v), {
        "grad_norm": gnorm, "lr": lr}
