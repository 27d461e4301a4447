"""Parameters and decode state of the attention + dense-FFN decoder.

The leaf names and shapes are those of the reference package's
``models/params.py`` (``_attn_leaves``, ``_dense_ffn_leaves``, ``embed``,
``final_norm``, ``lm_head``), so a parameter tree made there carries over
one to one (``from_jax_params``).  Where the reference stacks the repeated
block's leaves under a leading ``num_blocks`` dim for ``lax.scan``, the port
keeps one ``DecoderLayer`` module per layer and loops over them.

The state is one ``{"k", "v"}`` dict of (B, max_len, Hkv, D) caches per
layer, updated in place by the forward pass.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import LayerSpec, ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class Leaf:
    shape: tuple[int, ...]
    init: str = "fanin"          # fanin | zeros | ones | embed


def _attn_leaves(cfg: ModelConfig) -> dict[str, Leaf]:
    d, dh = cfg.d_model, cfg.head_dim_
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    t = {"ln1": Leaf((d,), "ones"),
         "wq": Leaf((d, nq * dh)),
         "wk": Leaf((d, nkv * dh)),
         "wv": Leaf((d, nkv * dh)),
         "wo": Leaf((nq * dh, d))}
    if cfg.qkv_bias:
        t["bq"] = Leaf((nq * dh,), "zeros")
        t["bk"] = Leaf((nkv * dh,), "zeros")
        t["bv"] = Leaf((nkv * dh,), "zeros")
    if cfg.post_norms:
        t["ln1_post"] = Leaf((d,), "ones")
    return t


def _dense_ffn_leaves(cfg: ModelConfig) -> dict[str, Leaf]:
    d, f = cfg.d_model, cfg.d_ff
    t = {"ln2": Leaf((d,), "ones"),
         "w_gate": Leaf((d, f)),
         "w_up": Leaf((d, f)),
         "w_down": Leaf((f, d))}
    if cfg.post_norms:
        t["ln2_post"] = Leaf((d,), "ones")
    return t


def check_supported(cfg: ModelConfig):
    """This slice ports attention + dense-FFN decoders only."""
    if cfg.kv_lora_rank:
        raise NotImplementedError(
            f"{cfg.name}: MLA attention is ported in a later slice "
            "(ROADMAP A8)")
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError(
            f"{cfg.name}: the int8 KV cache is ported in a later slice "
            "(ROADMAP A8)")
    for spec in cfg.layer_specs:
        if spec.mixer not in ("attn", "local_attn") or spec.ffn != "dense":
            raise NotImplementedError(
                f"{cfg.name}: {spec.mixer}/{spec.ffn} layers are ported in "
                "a later slice (ROADMAP A8)")


class _Leaves(nn.Module):
    """A module whose parameters are the named leaves, uninitialised."""

    def __init__(self, leaves: dict[str, Leaf], dtype: torch.dtype, device):
        super().__init__()
        self.leaves = leaves
        for name, lf in leaves.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(lf.shape, dtype=dtype, device=device),
                requires_grad=False))


class DecoderLayer(_Leaves):
    """One residual layer: attention (``ln1``, ``wq``...) + dense FFN
    (``ln2``, ``w_gate``...), the reference's per-layer leaves."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, device):
        super().__init__({**_attn_leaves(cfg), **_dense_ffn_leaves(cfg)},
                         DTYPES[cfg.param_dtype], device)
        self.window = cfg.sliding_window if spec.mixer == "local_attn" else 0


def _top_leaves(cfg: ModelConfig) -> dict[str, Leaf]:
    d, v = cfg.d_model, cfg.vocab_size
    t = {"embed": Leaf((v, d), "embed"), "final_norm": Leaf((d,), "ones")}
    if not cfg.tie_embeddings:
        t["lm_head"] = Leaf((d, v))
    return t


class Transformer(_Leaves):
    """Embedding (``embed``), the decoder layers (``layers``), final norm
    (``final_norm``) and LM head (``lm_head``)."""

    def __init__(self, cfg: ModelConfig, device):
        check_supported(cfg)
        super().__init__(_top_leaves(cfg), DTYPES[cfg.param_dtype], device)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, spec, device) for spec in cfg.layer_specs)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _leaf_modules(model: Transformer):
    yield model
    yield from model.layers


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Transformer:
    """A model with seeded random weights, made on `device`: fan-in normal
    (std 1/sqrt(fan_in)), 0.02 normal for the embedding, ones and zeros as
    tagged.  `generator` must live on `device`."""
    model = Transformer(cfg, device)
    for mod in _leaf_modules(model):
        for name, lf in mod.leaves.items():
            p = getattr(mod, name)
            if lf.init == "zeros":
                p.zero_()
            elif lf.init == "ones":
                p.fill_(1.0)
            else:
                fan_in = lf.shape[-2] if len(lf.shape) >= 2 else lf.shape[-1]
                std = 0.02 if lf.init == "embed" else 1.0 / math.sqrt(
                    max(fan_in, 1))
                p.copy_(torch.randn(lf.shape, generator=generator,
                                    device=device) * std)
    return model


def _from_numpy(a) -> torch.Tensor:
    a = np.array(a)                     # a writable, contiguous copy
    if a.dtype.name == "bfloat16":      # ml_dtypes.bfloat16: not a torch type
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@torch.no_grad()
def from_jax_params(cfg: ModelConfig, tree, device="cuda") -> Transformer:
    """The reference package's ``init_params`` tree, with numpy arrays as
    leaves, as a port model.  The stacked leading ``num_blocks`` dim of
    ``tree["blocks"]`` is split into per-layer modules."""
    model = Transformer(cfg, device)
    for name in model.leaves:
        getattr(model, name).copy_(_from_numpy(tree[name]))
    P = len(cfg.block_pattern)
    for i, layer in enumerate(model.layers):
        if i < cfg.first_k_dense:
            src = {n: tree["prefix"][f"l{i}"][n] for n in layer.leaves}
        else:
            blk, j = divmod(i - cfg.first_k_dense, P)
            src = {n: tree["blocks"][f"p{j}"][n][blk] for n in layer.leaves}
        for name, a in src.items():
            getattr(layer, name).copy_(_from_numpy(a))
    return model


def init_state(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> list[dict[str, torch.Tensor]]:
    """Zeroed per-layer KV caches, (batch, max_len, Hkv, D) in cfg.dtype."""
    check_supported(cfg)
    dt = DTYPES[cfg.kv_cache_dtype or cfg.dtype]
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim_)
    return [{"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
            for _ in cfg.layer_specs]


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
