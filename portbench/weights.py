"""Seeded weights, made on the device in a few large calls.

A family's reference (``reference/<family>.py``) lists its leaves as
(name, shape, role); the names and shapes are the port's parameters'.
Every leaf is a view of one flat buffer in the serving dtype, filled with
standard normals by a ``torch.Generator`` on the device in chunks of
2^30 elements, then scaled in place by its role:

- ``embed``: std 1;
- ``norm``: 1 + 0.1 z, so a dropped norm weight shows;
- ``bias``: std 0.5, so a dropped bias shows;
- ``in``: std 1 / sqrt(fan-in), the first of the last two dims;
- ``qk`` (a family's query and key projections, where it asks for
  sharper attention): twice that, so that scores spread by about 4 and
  each query attends to a few keys;
- ``attn_out`` (attention's output projection): 1 / sqrt(fan-in);
- ``out`` (the MLP's and experts' projections back onto the residual
  stream): 1 / sqrt(fan-in) times 1 / sqrt(2 * layers), the scaled init
  of GPT-2 and Megatron.

With every projection at 1 / sqrt(fan-in) a random deep model is
chaotic: two roundings of the same bf16 model differ by a tenth of the
largest logit or more, and no comparison can tell a fault from rounding.
With all of them scaled down, attention averages hundreds of keys into
almost nothing, and a cache or a transfer that loses every key still
serves nearly the same tokens.  Attention at full weight (sharpened
where the family's rounding allows), and scaled MLPs, keep both the
rounding small and the cache in play.
"""
from __future__ import annotations

import math

import torch

CHUNK = 1 << 30


def role_scale(role: str, shape: tuple, layers: int) -> tuple[float, float]:
    """(std, mean) of a leaf of `role`."""
    if role == "embed":
        return 1.0, 0.0
    if role == "norm":
        return 0.1, 1.0
    if role == "bias":
        return 0.5, 0.0
    std = 1.0 / math.sqrt(shape[-2] if len(shape) >= 2 else shape[-1])
    if role == "out":
        std /= math.sqrt(2.0 * layers)
    elif role == "qk":
        std *= 2.0
    elif role not in ("in", "attn_out"):
        raise ValueError(f"unknown role {role}")
    return std, 0.0


@torch.no_grad()
def make(leaves: list, layers: int, seed: int, dtype: torch.dtype,
         device) -> dict[str, torch.Tensor]:
    """{name: tensor} for `leaves` [(name, shape, role)], all views of one
    buffer, the same for the same seed."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 63)
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    flat = torch.empty(sum(sizes), dtype=dtype, device=device)
    for off in range(0, flat.numel(), CHUNK):
        flat[off:off + CHUNK].normal_(generator=g)
    out, off = {}, 0
    for (name, shape, role), n in zip(leaves, sizes):
        t = flat[off:off + n].view(shape)
        std, mean = role_scale(role, shape, layers)
        t.mul_(std)
        if mean:
            t.add_(mean)
        out[name] = t
        off += n
    return out
