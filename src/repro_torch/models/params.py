"""Parameters and decode state of the port's decoder layers.

The leaf names, shapes, dtypes and init tags are those of the reference
package's ``models/params.py`` (``_attn_leaves``, ``_dense_ffn_leaves``,
``_rwkv_tm_leaves``, ``_rwkv_cm_leaves``, ``embed``, ``final_norm``,
``lm_head``), so a parameter tree made there carries over one to one
(``from_jax_params``).  Where the reference stacks the repeated block's
leaves under a leading ``num_blocks`` dim for ``lax.scan``, the port keeps
one ``DecoderLayer`` module per layer and loops over them.

The state is one dict per layer, updated in place by the forward pass:
``{"k", "v"}`` (B, max_len, Hkv, D) caches for an attention layer (with
``kv_cache_dtype="int8"``, int8 values and f32 ``{"k_scale", "v_scale"}``
(B, max_len, Hkv) per-(token, head) scales), and ``{"wkv"}`` (B, H, K, K)
f32 plus ``{"shift_t", "shift_c"}`` (B, d) for an RWKV-6 layer.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import LayerSpec, ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}


@dataclass(frozen=True)
class Leaf:
    shape: tuple[int, ...]
    init: str = "fanin"          # fanin | zeros | ones | embed | const:<v> | decay
    dtype: Optional[str] = None  # None -> cfg.param_dtype


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


_RWKV_LORA = 32
_RWKV_DECAY_LORA = 64


def _rwkv_tm_leaves(cfg: ModelConfig) -> dict[str, Leaf]:
    """RWKV-6 time-mix.  ``w0`` and ``u`` stay f32 in a bf16 model;
    ``lora_B`` and ``decay_B`` start at zero, so the decay starts at
    ``w0``'s (``decay`` tag: -6 .. -1 across channels)."""
    d = cfg.d_model
    t = {"ln1": Leaf((d,), "ones")}
    for n in ("x", "w", "k", "v", "r", "g"):
        t[f"mu_{n}"] = Leaf((d,), "const:0.5")
    t["lora_A"] = Leaf((d, 5 * _RWKV_LORA))
    t["lora_B"] = Leaf((5, _RWKV_LORA, d), "zeros")
    t["w0"] = Leaf((d,), "decay", "float32")
    t["decay_A"] = Leaf((d, _RWKV_DECAY_LORA))
    t["decay_B"] = Leaf((_RWKV_DECAY_LORA, d), "zeros")
    t["u"] = Leaf((d,), "const:0.5", "float32")
    for n in ("wr", "wk", "wv", "wg", "wo"):
        t[n] = Leaf((d, d))
    t["lnx_g"] = Leaf((d,), "ones")
    t["lnx_b"] = Leaf((d,), "zeros")
    return t


def _rwkv_cm_leaves(cfg: ModelConfig) -> dict[str, Leaf]:
    d, f = cfg.d_model, cfg.d_ff
    return {"ln2": Leaf((d,), "ones"),
            "mu_ck": Leaf((d,), "const:0.5"),
            "mu_cr": Leaf((d,), "const:0.5"),
            "wk_cm": Leaf((d, f)),
            "wv_cm": Leaf((f, d)),
            "wr_cm": Leaf((d, d))}


_MIXERS = {"attn": _attn_leaves, "local_attn": _attn_leaves,
           "rwkv": _rwkv_tm_leaves}
_FFNS = {"dense": _dense_ffn_leaves, "rwkv_cm": _rwkv_cm_leaves}


def check_supported(cfg: ModelConfig):
    """The port has attention / RWKV-6 mixers and dense / RWKV channel-mix
    FFNs; anything else is refused by name."""
    if cfg.kv_lora_rank:
        raise NotImplementedError(
            f"{cfg.name}: MLA attention is ported in a later slice "
            "(ROADMAP A8)")
    for spec in cfg.layer_specs:
        if spec.mixer not in _MIXERS or spec.ffn not in _FFNS:
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
                torch.empty(lf.shape, device=device,
                            dtype=DTYPES[lf.dtype] if lf.dtype else dtype),
                requires_grad=False))


class DecoderLayer(_Leaves):
    """One residual layer: the leaves of its spec's mixer (attention
    ``ln1``, ``wq``... or RWKV time-mix ``mu_x``, ``w0``...) and FFN (dense
    ``w_gate``... or channel-mix ``wk_cm``...), the reference's per-layer
    leaves."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, device):
        super().__init__({**_MIXERS[spec.mixer](cfg), **_FFNS[spec.ffn](cfg)},
                         DTYPES[cfg.param_dtype], device)
        self.spec = spec
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


def abstract_params(cfg: ModelConfig) -> Transformer:
    """The model with every leaf's shape and dtype on the ``meta`` device:
    no memory is allocated (the reference's ShapeDtypeStruct tree)."""
    return Transformer(cfg, "meta")


def _leaf_modules(model: Transformer):
    yield model
    yield from model.layers


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Transformer:
    """A model with seeded random weights, made on `device`: fan-in normal
    (std 1/sqrt(fan_in)), 0.02 normal for the embedding, ones, zeros,
    constants and the RWKV decay ramp as tagged.  `generator` must live on
    `device`."""
    model = Transformer(cfg, device)
    for mod in _leaf_modules(model):
        for name, lf in mod.leaves.items():
            p = getattr(mod, name)
            if lf.init == "zeros":
                p.zero_()
            elif lf.init == "ones":
                p.fill_(1.0)
            elif lf.init.startswith("const:"):
                p.fill_(float(lf.init[6:]))
            elif lf.init == "decay":
                d = lf.shape[-1]
                ramp = torch.arange(d, dtype=torch.float32, device=device)
                p.copy_(-6.0 + 5.0 * (ramp / max(d - 1, 1)))
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


def _layer_state(cfg: ModelConfig, spec: LayerSpec, batch: int,
                 max_len: int, device) -> dict[str, torch.Tensor]:
    dt = DTYPES[cfg.dtype]
    if spec.mixer == "rwkv":
        K = cfg.rwkv_head_dim
        return {"wkv": torch.zeros((batch, cfg.d_model // K, K, K),
                                   dtype=torch.float32, device=device),
                "shift_t": torch.zeros((batch, cfg.d_model), dtype=dt,
                                       device=device),
                "shift_c": torch.zeros((batch, cfg.d_model), dtype=dt,
                                       device=device)}
    dt = DTYPES[cfg.kv_cache_dtype or cfg.dtype]
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim_)
    st = {"k": torch.zeros(shape, dtype=dt, device=device),
          "v": torch.zeros(shape, dtype=dt, device=device)}
    if dt == torch.int8:
        for name in ("k_scale", "v_scale"):
            st[name] = torch.zeros(shape[:3], dtype=torch.float32,
                                   device=device)
    return st


def init_state(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> list[dict[str, torch.Tensor]]:
    """Zeroed per-layer state: (batch, max_len, Hkv, D) KV caches in
    cfg.kv_cache_dtype or cfg.dtype for attention (int8 adds the f32
    (batch, max_len, Hkv) k_scale / v_scale); for RWKV-6 the f32 (batch, H,
    K, K) WKV state and the (batch, d) token-shift states in cfg.dtype (no
    max_len)."""
    check_supported(cfg)
    return [_layer_state(cfg, spec, batch, max_len, device)
            for spec in cfg.layer_specs]


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
