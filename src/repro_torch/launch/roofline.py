"""Roofline terms of one rank's step, counted on the ``meta`` device.

The counterpart of the reference package's ``launch/roofline.py``.  Three
terms per (arch x shape x mesh), in seconds, all per rank:

  compute    = FLOPs / PEAK_FLOPS
  memory     = HBM bytes / HBM_BW
  collective = collective bytes / LINK_BW

The reference reads them from the optimized HLO of its SPMD-partitioned
program (``parse_hlo``, ``analyze_hlo``); those have no counterpart here,
because the port has no compiler.  Its step is eager PyTorch on each
rank's local shards with explicit collectives, so ``count_step`` runs one
rank's step on ``meta`` tensors (shapes and dtypes, no memory, no kernel)
and counts what it dispatches:

  * FLOPs: the formulas of ``torch.utils.flop_counter`` (those of its
    ``FlopCounterMode``): 2·M·N·K for each matmul (mm, bmm, addmm,
    baddbmm: the reference's ``dot`` rule), and its formulas for SDPA and
    convolution;
  * HBM bytes: each dispatched op's tensor inputs read once and its
    outputs written once (a broadcast input's distinct elements), views
    and allocations excluded.  This is the eager port's own traffic, op
    by op, every intermediate through memory; the reference's figure is
    the fusion I/O of XLA's program, whose fused intermediates stay on
    chip, so the two are not the same quantity;
  * collectives: each ``c10d`` collective's kind (the reference's HLO
    names), count and payload bytes (its output, as the reference counts
    them); they are not HBM bytes;
  * memory: the bytes of the step's arguments (this rank's shards), of its
    outputs that are not arguments, and the peak of the live storage
    during the step (``temp_bytes`` is that peak less the arguments).

A sequential scan (``repro_torch.scan``: Mamba's selective scan, the
chunked WKV6) runs one step counted n times, its backward too, as the
reference counts a ``while`` body times its trip count: its steps all
have the same shapes on ``meta``, and an eager loop of 32k tokens would
take the dry-run minutes a layer.

Constants: one NVIDIA H100 SXM (NVIDIA's H100 data sheet, 700 W): 989
TFLOP/s dense bf16 and 3.35 TB/s of HBM3 (``core.hardware.CHIPS["h100"]``).
Every 16-rank axis of the production meshes spans more than one 8-card
NVLink node, so the collective term takes one card's link off its node:
one 400 Gb/s NDR InfiniBand port, 50 GB/s.
"""
from __future__ import annotations

import dataclasses
import weakref
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch import scan
from repro_torch.core.hardware import CHIPS

PEAK_FLOPS = CHIPS["h100"].flops_bf16
HBM_BW = CHIPS["h100"].hbm_bw
LINK_BW = 50e9

#: c10d's collectives by the reference's HLO names
COLLECTIVES = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
}

#: ops that move no data: allocations and metadata (views are told apart
#: by their schema)
_NO_TRAFFIC = {
    "empty", "empty_strided", "empty_like", "new_empty",
    "new_empty_strided", "_unsafe_view", "detach", "alias", "lift_fresh",
    "set_", "resize_",
}


@dataclass
class RooflineCounts:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: dict[str, float] = field(default_factory=dict)
    collective_counts: dict[str, float] = field(default_factory=dict)
    memory: Optional[dict] = None      # argument / output / temp / peak


def _tensors(tree) -> list[torch.Tensor]:
    """Every tensor in `tree`: nested dicts, lists, tuples, dataclasses and
    named tuples, modules (their parameters and buffers)."""
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, nn.Module):
            out.extend(x.parameters())
            out.extend(x.buffers())
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
    walk(tree)
    return out


def _storages(tree) -> dict:
    """{id: nbytes} of the device storages under `tree` (CPU scalars and
    host arrays are not the device's)."""
    out = {}
    for t in _tensors(tree):
        if t.device.type != "cpu":
            st = t.untyped_storage()
            out[id(st)] = st.nbytes()
    return out


def argument_bytes(*args) -> int:
    """The bytes a step's arguments hold on this rank: each storage once,
    at its local shard's shape."""
    return sum(_storages(args).values())


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements `t` addresses (a broadcast dim, of
    stride 0, reads one)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


class _Counter(TorchDispatchMode):
    """FLOPs, HBM bytes and collectives of the ops it sees, each counted
    ``scan.multiplier()`` times, and their live storage."""

    def __init__(self, counts: RooflineCounts, base: dict):
        super().__init__()
        self.counts = counts
        self.live = dict(base)
        self.now = self.peak = sum(base.values())

    def _track(self, out):
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor) or t.device.type == "cpu":
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self.live:
                continue
            nbytes = st.nbytes()
            self.live[key] = nbytes
            self.now += nbytes
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.now)

    def _free(self, key):
        self.now -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._track(out)
        mult = scan.multiplier()
        if not mult:
            return out
        ns, _, op = func._schema.name.partition("::")
        c = self.counts
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            c.flops += mult * formula(*args, **kwargs, out_val=out)
        if ns == "c10d":
            kind = COLLECTIVES.get(op, op)
            nbytes = mult * sum(_distinct_bytes(t)
                                for t in tree_flatten(args[0])[0]
                                if isinstance(t, torch.Tensor))
            c.collective_bytes += nbytes
            c.collectives[kind] = c.collectives.get(kind, 0.0) + nbytes
            c.collective_counts[kind] = \
                c.collective_counts.get(kind, 0.0) + mult
        elif not func.is_view and op not in _NO_TRAFFIC:
            tensors = tree_flatten((args, kwargs, out))[0]
            c.hbm_bytes += mult * sum(_distinct_bytes(t) for t in tensors
                                      if isinstance(t, torch.Tensor))
        return out


def count_step(fn, *args, **kwargs) -> RooflineCounts:
    """Run ``fn(*args, **kwargs)`` once (on ``meta`` tensors: nothing is
    computed or allocated; its scans folded) and count its FLOPs, HBM
    bytes, collectives and memory (module docstring).  The arguments'
    storages are live from the start; a storage the step frees stops
    counting when it is freed."""
    counts = RooflineCounts()
    base = _storages((args, kwargs))
    counter = _Counter(counts, base)
    with scan.folding(), counter:
        out = fn(*args, **kwargs)
    arg = sum(base.values())
    counts.memory = {
        "argument_bytes": arg,
        "output_bytes": sum(n for k, n in _storages(out).items()
                            if k not in base),
        "temp_bytes": counter.peak - arg,
        "peak_bytes": counter.peak,
    }
    return counts


# ---------------------------------------------------------------------------
# The reference's Roofline and MODEL_FLOPS, with the port's counts: the
# counted FLOPs are ``flops_global`` in ``row()``, not ``hlo_flops_global``
# ---------------------------------------------------------------------------

@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    hbm_bytes_per_chip: float
    collective_bytes_per_chip: float
    model_flops: float               # 6·N_active·D (train) / 2·N_active·D
    memory_stats: Optional[dict] = None
    collectives: Optional[dict] = None

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_chip / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (global counted flops) — remat/redundancy waste."""
        return self.model_flops / max(self.flops_per_chip * self.chips, 1.0)

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "flops_global": self.flops_per_chip * self.chips,
            "useful_ratio": self.useful_flops_ratio,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "collectives": self.collectives,
            "memory": self.memory_stats,
        }


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N_active·D for training, 2·N_active·D per forward."""
    n_act = cfg.param_counts()["active"]
    if shape.kind == "train":
        return 6.0 * n_act * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.global_batch * shape.seq_len
    return 2.0 * n_act * shape.global_batch      # decode: one token
