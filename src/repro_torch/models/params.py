"""Parameters and decode state of the port's decoder layers.

The leaf names, shapes, dtypes and init tags are those of the reference
package's ``models/params.py`` (``_attn_leaves`` with its MLA and
cross-attention variants, ``_dense_ffn_leaves``, ``_moe_ffn_leaves``,
``_mamba_leaves``, ``_rwkv_tm_leaves``, ``_rwkv_cm_leaves``, ``embed``,
``final_norm``, ``lm_head``), so a parameter tree made there carries over
one to one (``from_jax_params``).  Where the reference stacks the repeated
block's leaves under a leading ``num_blocks`` dim for ``lax.scan`` and
keeps the ``first_k_dense`` layers apart under ``prefix``, the port keeps
one ``DecoderLayer`` module per layer, prefix first, and loops over them.

The state is one dict per layer, updated in place by the forward pass:
``{"k", "v"}`` (B, max_len, Hkv, D) caches for an attention layer (with
``kv_cache_dtype="int8"``, int8 values and f32 ``{"k_scale", "v_scale"}``
(B, max_len, Hkv) per-(token, head) scales); under MLA the latent
``{"c_kv"}`` (B, max_len, kv_lora_rank) and ``{"k_rope"}`` (B, max_len,
qk_rope_dim); ``{"xk", "xv"}`` (B, num_vision_tokens, Hkv, D) for a
cross-attention layer; ``{"ssm"}`` (B, d_inner, d_state) f32 and
``{"conv"}`` (B, d_conv - 1, d_inner) for Mamba; ``{"wkv"}`` (B, H, K, K)
f32 plus ``{"shift_t", "shift_c"}`` (B, d) for RWKV-6.
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
    init: str = "fanin"  # fanin|zeros|ones|embed|const:<v>|alog|decay
    dtype: Optional[str] = None  # None -> cfg.param_dtype


def _attn_leaves(cfg: ModelConfig, cross: bool = False) -> dict[str, Leaf]:
    """GQA attention; with ``kv_lora_rank`` the MLA projections (latent
    down-projection ``w_dkv``, its norm, the up-projections ``w_uk`` /
    ``w_uv``); a cross-attention layer adds a scalar ``gate`` (zero at
    init, so the layer starts silent) and q / k norms."""
    d, dh = cfg.d_model, cfg.head_dim_
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    t = {"ln1": Leaf((d,), "ones")}
    if cfg.kv_lora_rank and not cross:
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        t["wq"] = Leaf((d, nq * qk))
        t["w_dkv"] = Leaf((d, cfg.kv_lora_rank + cfg.qk_rope_dim))
        t["kv_norm"] = Leaf((cfg.kv_lora_rank,), "ones")
        t["w_uk"] = Leaf((cfg.kv_lora_rank, nq * cfg.qk_nope_dim))
        t["w_uv"] = Leaf((cfg.kv_lora_rank, nq * cfg.v_head_dim))
        t["wo"] = Leaf((nq * cfg.v_head_dim, d))
    else:
        t["wq"] = Leaf((d, nq * dh))
        t["wk"] = Leaf((d, nkv * dh))
        t["wv"] = Leaf((d, nkv * dh))
        t["wo"] = Leaf((nq * dh, d))
        if cfg.qkv_bias:
            t["bq"] = Leaf((nq * dh,), "zeros")
            t["bk"] = Leaf((nkv * dh,), "zeros")
            t["bv"] = Leaf((nkv * dh,), "zeros")
    if cross:
        t["gate"] = Leaf((), "zeros")
        t["q_norm"] = Leaf((dh,), "ones")
        t["k_norm"] = Leaf((dh,), "ones")
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


def _moe_ffn_leaves(cfg: ModelConfig) -> dict[str, Leaf]:
    """Router, E stacked experts (E, d, f) / (E, f, d), and the shared
    experts as one dense FFN of num_shared * f."""
    d, m = cfg.d_model, cfg.moe
    e, f = m.num_experts, m.d_ff_expert
    t = {"ln2": Leaf((d,), "ones"),
         "router": Leaf((d, e)),
         "we_gate": Leaf((e, d, f)),
         "we_up": Leaf((e, d, f)),
         "we_down": Leaf((e, f, d))}
    if m.num_shared:
        fs = m.num_shared * f
        t["ws_gate"] = Leaf((d, fs))
        t["ws_up"] = Leaf((d, fs))
        t["ws_down"] = Leaf((fs, d))
    if cfg.post_norms:
        t["ln2_post"] = Leaf((d,), "ones")
    return t


def _mamba_leaves(cfg: ModelConfig) -> dict[str, Leaf]:
    """Mamba mixer: ``dt_b``, ``A_log`` (``alog`` tag: log 1 .. d_state)
    and ``D`` stay f32 in a bf16 model."""
    d, mc = cfg.d_model, cfg.mamba
    di = mc.expand * d
    dtr = mc.dt_rank or -(-d // 16)
    return {"ln1": Leaf((d,), "ones"),
            "in_proj": Leaf((d, 2 * di)),
            "conv_w": Leaf((mc.d_conv, di)),
            "conv_b": Leaf((di,), "zeros"),
            "x_proj": Leaf((di, dtr + 2 * mc.d_state)),
            "dt_w": Leaf((dtr, di)),
            "dt_b": Leaf((di,), "const:-4.6", "float32"),
            "A_log": Leaf((di, mc.d_state), "alog", "float32"),
            "D": Leaf((di,), "ones", "float32"),
            "out_proj": Leaf((di, d))}


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
           "cross_attn": lambda cfg: _attn_leaves(cfg, cross=True),
           "mamba": _mamba_leaves, "rwkv": _rwkv_tm_leaves}
_FFNS = {"dense": _dense_ffn_leaves, "moe": _moe_ffn_leaves,
         "rwkv_cm": _rwkv_cm_leaves}


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
    ``ln1``, ``wq``..., MLA ``w_dkv``..., cross-attention ``gate``...,
    Mamba ``in_proj``... or RWKV time-mix ``mu_x``...) and FFN (dense
    ``w_gate``..., MoE ``router``, ``we_gate``... or channel-mix
    ``wk_cm``...), the reference's per-layer leaves.  The ``first_k_dense``
    prefix layers are ``LayerSpec()`` layers (MLA leaves under MLA)."""

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
    constants, Mamba's log(1 .. d_state) and the RWKV decay ramp as
    tagged.  `generator` must live on `device`."""
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
            elif lf.init == "alog":
                ds = lf.shape[-1]
                p.copy_(torch.log(torch.arange(
                    1, ds + 1, dtype=torch.float32, device=device)))
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

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    if spec.mixer == "rwkv":
        K = cfg.rwkv_head_dim
        return {"wkv": zeros(batch, cfg.d_model // K, K, K,
                             dtype=torch.float32),
                "shift_t": zeros(batch, cfg.d_model),
                "shift_c": zeros(batch, cfg.d_model)}
    if spec.mixer == "mamba":
        mc = cfg.mamba
        di = mc.expand * cfg.d_model
        return {"ssm": zeros(batch, di, mc.d_state, dtype=torch.float32),
                "conv": zeros(batch, mc.d_conv - 1, di)}
    if spec.mixer == "cross_attn":
        shape = (batch, cfg.num_vision_tokens, cfg.num_kv_heads,
                 cfg.head_dim_)
        return {"xk": zeros(*shape), "xv": zeros(*shape)}
    if cfg.kv_lora_rank:
        return {"c_kv": zeros(batch, max_len, cfg.kv_lora_rank),
                "k_rope": zeros(batch, max_len, cfg.qk_rope_dim)}
    kv_dt = DTYPES[cfg.kv_cache_dtype or cfg.dtype]
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim_)
    st = {"k": zeros(*shape, dtype=kv_dt), "v": zeros(*shape, dtype=kv_dt)}
    if kv_dt == torch.int8:
        for name in ("k_scale", "v_scale"):
            st[name] = zeros(*shape[:3], dtype=torch.float32)
    return st


def init_state(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> list[dict[str, torch.Tensor]]:
    """Zeroed per-layer state (module docstring): KV caches in
    cfg.kv_cache_dtype or cfg.dtype, or MLA's latent caches in cfg.dtype,
    (batch, max_len, ...); cross-attention's image keys / values and the
    Mamba and RWKV-6 recurrent states, which have no max_len."""
    return [_layer_state(cfg, spec, batch, max_len, device)
            for spec in cfg.layer_specs]


def abstract_state(cfg: ModelConfig, batch: int,
                   max_len: int) -> list[dict[str, torch.Tensor]]:
    """The state's shapes and dtypes on the ``meta`` device: no memory is
    allocated (the reference's ShapeDtypeStruct tree)."""
    return init_state(cfg, batch, max_len, "meta")


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
