"""Sharded .npz checkpoints in the reference package's layout
(``training/checkpoint.py``): leaves flattened to path-keyed arrays
("blocks/p0/wq", ...), split across ``shard_{i:04d}.npz`` files so that no
shard exceeds `shard_bytes`, and an ``index.json`` of the step, the shard
count and each key's shard.  A port model is saved through
``models.to_jax_params``, so each package reads the other's checkpoints;
bf16 leaves are raw 2-byte values (``|V2``) either way.  Restore rebuilds
the tree on the host, or a port model on the device of `like`.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.models.params import (Transformer, _from_numpy,
                                       from_jax_params, nest,
                                       reference_paths, to_jax_params,
                                       to_numpy)


def _flatten(tree) -> dict[str, np.ndarray]:
    if isinstance(tree, Transformer):
        tree = to_jax_params(tree.cfg, tree)
    flat = {}

    def rec(prefix, t):
        if isinstance(t, dict):
            for k in sorted(t):
                rec(f"{prefix}/{k}" if prefix else k, t[k])
        elif isinstance(t, (list, tuple)):
            for i, x in enumerate(t):
                rec(f"{prefix}/{i}", x)
        else:
            flat[prefix] = to_numpy(t) if torch.is_tensor(t) \
                else np.asarray(t)
    rec("", tree)
    return flat


def save(path: str, tree: Any, step: int = 0,
         shard_bytes: int = 1 << 30) -> None:
    os.makedirs(path, exist_ok=True)
    flat = _flatten(tree)
    shards: list[dict[str, np.ndarray]] = [{}]
    sizes = [0]
    for k, v in flat.items():
        if sizes[-1] + v.nbytes > shard_bytes and shards[-1]:
            shards.append({})
            sizes.append(0)
        shards[-1][k] = v
        sizes[-1] += v.nbytes
    index = {"step": step, "n_shards": len(shards),
             "keys": {k: i for i, sh in enumerate(shards) for k in sh}}
    for i, sh in enumerate(shards):
        np.savez(os.path.join(path, f"shard_{i:04d}.npz"), **sh)
    with open(os.path.join(path, "index.json"), "w") as f:
        json.dump(index, f)


def restore(path: str, like: Any = None) -> tuple[Any, int]:
    """Returns (tree, step).  With `like` a port model, a new model of its
    config on its device; with another tree, re-nests into its structure
    and casts to its dtypes (numpy or tensor leaves); otherwise returns the
    flat {path: array} dict."""
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    flat: dict[str, np.ndarray] = {}
    for i in range(index["n_shards"]):
        with np.load(os.path.join(path, f"shard_{i:04d}.npz")) as z:
            flat.update({k: z[k] for k in z.files})
    if like is None:
        return flat, index["step"]

    paths_like = (reference_paths(like) if isinstance(like, Transformer)
                  else _flatten(like))
    assert set(paths_like) == set(flat), (
        "checkpoint/param structure mismatch: "
        f"{set(paths_like) ^ set(flat)}")
    if isinstance(like, Transformer):
        return from_jax_params(like.cfg, nest(flat),
                               device=like.device), index["step"]

    def rebuild(prefix, t):
        if isinstance(t, dict):
            return {k: rebuild(f"{prefix}/{k}" if prefix else k, v)
                    for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            out = [rebuild(f"{prefix}/{i}", x) for i, x in enumerate(t)]
            return type(t)(out)
        if torch.is_tensor(t):
            return _from_numpy(flat[prefix]).to(dtype=t.dtype,
                                                device=t.device)
        return flat[prefix].astype(np.asarray(t).dtype)

    return rebuild("", like), index["step"]
