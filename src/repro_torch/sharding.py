"""Sharding rules of the port: logical axes mapped onto a torch DeviceMesh.

The counterpart of the reference package's ``sharding.py``.  Model code
names the logical axes of its parameters and state ("batch", "experts",
"expert_ff", ...; ``models.params.param_axes`` / ``state_axes``), and a
rules table maps each logical name to mesh axes.  ``logical_to_pspec``
turns a leaf's axes into a ``PartitionSpec`` exactly as the reference
does (a mapping that does not divide the dim is dropped, and no mesh axis
is used twice), ``placements`` gives the DTensor placements of a spec, and
``local_shard`` cuts a whole tensor to one rank's shard.

The reference's ``shard_map`` has no counterpart: in the port each rank
holds its local shards and the sharded code (``models.ops``'s
expert-parallel MoE) calls the collectives itself, over the process
groups of the mesh's axes (``axis_group``).  So ``shard`` is a no-op:
there is no compiler to pass a sharding constraint to.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Union

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

# ---------------------------------------------------------------------------
# Logical -> physical rules
# ---------------------------------------------------------------------------

# Default production rules.  "batch" maps to both the pod axis and the data
# axis (pod-major); tensor-parallel dims map to "model".
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),            # sequence unsharded by default (overridden for 500k)
    "ctx": ("data",),     # context parallelism for long-context decode caches
    "embed": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "experts": ("model",),
    "expert_ff": (),      # FSDP axis for expert weights (launch overrides)
    "vocab": ("model",),
    "kv_lora": (),
    "state": (),
}

#: a PartitionSpec: one entry per tensor dim, None (replicated), a mesh
#: axis name, or a tuple of names (the first one major); trailing Nones
#: trimmed.  It compares equal, as a tuple, to the reference's ``P``.
PartitionSpec = tuple[Union[None, str, tuple[str, ...]], ...]

_tls = threading.local()


def _ctx():
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


@contextlib.contextmanager
def axis_rules(rules: dict[str, tuple[str, ...]], mesh=None):
    """Activate a logical->physical mapping (and optionally a DeviceMesh)."""
    _ctx().append((dict(rules), mesh))
    try:
        yield
    finally:
        _ctx().pop()


def current_rules() -> Optional[dict[str, tuple[str, ...]]]:
    stack = _ctx()
    return stack[-1][0] if stack else None


def current_mesh():
    stack = _ctx()
    return stack[-1][1] if stack else None


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh, in the mesh's order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axes_size(mesh, axes) -> int:
    sizes = mesh_axes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def logical_to_pspec(axes: tuple[Optional[str], ...],
                     rules: Optional[dict] = None,
                     shape: Optional[tuple[int, ...]] = None,
                     mesh=None) -> PartitionSpec:
    """Map a tuple of logical axis names (or None) to a PartitionSpec.

    If `shape` and `mesh` are given, any mapping whose mesh-axis product does
    not divide the corresponding dim is dropped (e.g. 4 GQA KV heads cannot
    shard over a 16-way model axis -> replicate instead)."""
    rules = rules if rules is not None else (current_rules() or {})
    sizes = mesh_axes(mesh) if mesh is not None else None
    parts = []
    used: set[str] = set()
    for i, name in enumerate(axes):
        if name is None:
            parts.append(None)
            continue
        phys = tuple(a for a in rules.get(name, ()) if a not in used)
        if shape is not None and sizes is not None and phys:
            n = 1
            for a in phys:
                n *= sizes[a]
            if n == 0 or shape[i] % n != 0:
                parts.append(None)
                continue
        used.update(phys)
        if len(phys) == 0:
            parts.append(None)
        elif len(phys) == 1:
            parts.append(phys[0])
        else:
            parts.append(phys)
    # trim trailing Nones (canonical form)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def shard(x, *axes: Optional[str]):
    """Annotate an activation with logical axes: a no-op in the port, whose
    tensors are already each rank's local shards."""
    return x


def pspec_tree_from_logical(logical_tree, rules: Optional[dict] = None,
                            shape_tree=None, mesh=None):
    """Map a tree (dicts and lists) whose leaves are tuples of logical axis
    names to PartitionSpecs.

    With `shape_tree` (the same tree of tensors, ``meta`` ones included)
    and `mesh`, indivisible mappings are dropped per leaf."""
    rules = rules or DEFAULT_RULES

    def walk(ax, shp):
        if isinstance(ax, tuple):
            return logical_to_pspec(
                ax, rules, None if shp is None else tuple(shp.shape), mesh)
        if isinstance(ax, dict):
            return {k: walk(v, None if shp is None else shp[k])
                    for k, v in ax.items()}
        return [walk(v, None if shp is None else shp[i])
                for i, v in enumerate(ax)]

    return walk(logical_tree, shape_tree)


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: PartitionSpec, mesh) -> tuple:
    """The DTensor placements of `spec`: for each mesh dim, ``Shard(d)`` if
    tensor dim d is split over it, else ``Replicate()``.  A dim over two
    mesh axes is ``Shard(d)`` on both; DTensor splits it in mesh order, so
    the spec must name them in that order (as the rules tables do)."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"{spec}: dim {d} names mesh axes out of the "
                             f"mesh's order {tuple(names)}")
        for a in axes:
            out[names.index(a)] = Shard(d)
    return tuple(out)


def shard_index(axes, mesh, coord=None) -> tuple[int, int]:
    """(this rank's index, count) of the shards split over mesh `axes`: the
    rank's coordinates flattened with the first axis major, the reference's
    ``axis_index`` of a tuple of axes.  `coord` ({axis: index}) defaults to
    the calling rank's place in the mesh."""
    if coord is None:
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = mesh_axes(mesh)
    idx, n = 0, 1
    for a in axes:
        idx = idx * sizes[a] + coord[a]
        n *= sizes[a]
    return idx, n


def local_slices(shape, spec: PartitionSpec, mesh, coord=None) -> tuple:
    """The slices of a tensor of `shape` that one rank holds under `spec`
    (even splits: ``logical_to_pspec`` with the shape has dropped any that
    do not divide)."""
    out = []
    for d, size in enumerate(shape):
        axes = _entry_axes(spec[d]) if d < len(spec) else ()
        idx, n = shard_index(axes, mesh, coord)
        if size % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"{n} ways ({spec})")
        step = size // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def local_shard(x: torch.Tensor, spec: PartitionSpec, mesh,
                coord=None) -> torch.Tensor:
    """A copy of this rank's shard of the whole tensor `x` (the reference's
    ``device_put`` under ``named_sharding`` / ``sharding_tree``)."""
    return x[local_slices(x.shape, spec, mesh, coord)].clone()


# ---------------------------------------------------------------------------
# Process groups over mesh axes
# ---------------------------------------------------------------------------

_groups: dict = {}


def axis_group(mesh, axes: tuple[str, ...]):
    """The process group of the ranks that differ from the caller only in
    mesh `axes`.  Made on first use, by every rank of the mesh together
    (``new_group`` is collective), and kept for the mesh's life."""
    names = list(mesh.mesh_dim_names)
    axes = tuple(sorted(axes, key=names.index))
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _groups:
        ranks = mesh.mesh
        dims = [names.index(a) for a in axes]
        rest = [d for d in range(ranks.ndim) if d not in dims]
        rows = ranks.permute(*rest, *dims).reshape(-1, axes_size(mesh, axes))
        me = dist.get_rank()
        for row in rows.tolist():
            g = dist.new_group(row)
            if me in row:
                _groups[key] = (mesh, g)
    return _groups[key][1]


def all_reduce(x, group, op=dist.ReduceOp.SUM):
    """`x` summed (or reduced by `op`) over `group`, in a new tensor where
    `x` is not contiguous (else in place)."""
    x = x.contiguous()
    dist.all_reduce(x, op=op, group=group)
    return x


def all_gather(x, group, n):
    """(n, *x.shape): the group's shards of `x`, in its rank order (gloo
    takes them concatenated along dim 0)."""
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out.unflatten(0, (n, x.shape[0]))


def reduce_scatter(parts, group):
    """parts (n, ...) summed over the group; this rank keeps its part."""
    out = parts.new_empty(parts.shape[1:])
    dist.reduce_scatter_tensor(out, parts.flatten(0, 1).contiguous(),
                               group=group)
    return out
