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
``to_jax_params`` stacks them back into the reference's tree.

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
from repro_torch.sharding import (all_gather, axis_group, local_shard,
                                  local_slices, logical_to_pspec, mesh_axes)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}


@dataclass(frozen=True)
class Leaf:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]  # logical axes (``sharding``), per dim
    init: str = "fanin"  # fanin|zeros|ones|embed|const:<v>|alog|decay
    dtype: Optional[str] = None  # None -> cfg.param_dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} with axes {self.axes}")


def _attn_leaves(cfg: ModelConfig, cross: bool = False) -> dict[str, Leaf]:
    """GQA attention; with ``kv_lora_rank`` the MLA projections (latent
    down-projection ``w_dkv``, its norm, the up-projections ``w_uk`` /
    ``w_uv``); a cross-attention layer adds a scalar ``gate`` (zero at
    init, so the layer starts silent) and q / k norms."""
    d, dh = cfg.d_model, cfg.head_dim_
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    t = {"ln1": Leaf((d,), (None,), "ones")}
    if cfg.kv_lora_rank and not cross:
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        t["wq"] = Leaf((d, nq * qk), ("embed", "heads"))
        t["w_dkv"] = Leaf((d, cfg.kv_lora_rank + cfg.qk_rope_dim),
                          ("embed", "kv_lora"))
        t["kv_norm"] = Leaf((cfg.kv_lora_rank,), ("kv_lora",), "ones")
        t["w_uk"] = Leaf((cfg.kv_lora_rank, nq * cfg.qk_nope_dim),
                         ("kv_lora", "heads"))
        t["w_uv"] = Leaf((cfg.kv_lora_rank, nq * cfg.v_head_dim),
                         ("kv_lora", "heads"))
        t["wo"] = Leaf((nq * cfg.v_head_dim, d), ("heads", "embed"))
    else:
        t["wq"] = Leaf((d, nq * dh), ("embed", "heads"))
        t["wk"] = Leaf((d, nkv * dh), ("embed", "kv_heads"))
        t["wv"] = Leaf((d, nkv * dh), ("embed", "kv_heads"))
        t["wo"] = Leaf((nq * dh, d), ("heads", "embed"))
        if cfg.qkv_bias:
            t["bq"] = Leaf((nq * dh,), ("heads",), "zeros")
            t["bk"] = Leaf((nkv * dh,), ("kv_heads",), "zeros")
            t["bv"] = Leaf((nkv * dh,), ("kv_heads",), "zeros")
    if cross:
        t["gate"] = Leaf((), (), "zeros")
        t["q_norm"] = Leaf((dh,), (None,), "ones")
        t["k_norm"] = Leaf((dh,), (None,), "ones")
    if cfg.post_norms:
        t["ln1_post"] = Leaf((d,), (None,), "ones")
    return t


def _dense_ffn_leaves(cfg: ModelConfig) -> dict[str, Leaf]:
    d, f = cfg.d_model, cfg.d_ff
    t = {"ln2": Leaf((d,), (None,), "ones"),
         "w_gate": Leaf((d, f), ("embed", "ff")),
         "w_up": Leaf((d, f), ("embed", "ff")),
         "w_down": Leaf((f, d), ("ff", "embed"))}
    if cfg.post_norms:
        t["ln2_post"] = Leaf((d,), (None,), "ones")
    return t


def _moe_ffn_leaves(cfg: ModelConfig) -> dict[str, Leaf]:
    """Router, E stacked experts (E, d, f) / (E, f, d), and the shared
    experts as one dense FFN of num_shared * f.  The experts split over
    "experts" and, for the weight-stationary decode, their d_ff over
    "expert_ff" (not d_model)."""
    d, m = cfg.d_model, cfg.moe
    e, f = m.num_experts, m.d_ff_expert
    t = {"ln2": Leaf((d,), (None,), "ones"),
         "router": Leaf((d, e), ("embed", None)),
         "we_gate": Leaf((e, d, f), ("experts", None, "expert_ff")),
         "we_up": Leaf((e, d, f), ("experts", None, "expert_ff")),
         "we_down": Leaf((e, f, d), ("experts", "expert_ff", None))}
    if m.num_shared:
        fs = m.num_shared * f
        t["ws_gate"] = Leaf((d, fs), ("embed", "ff"))
        t["ws_up"] = Leaf((d, fs), ("embed", "ff"))
        t["ws_down"] = Leaf((fs, d), ("ff", "embed"))
    if cfg.post_norms:
        t["ln2_post"] = Leaf((d,), (None,), "ones")
    return t


def _mamba_leaves(cfg: ModelConfig) -> dict[str, Leaf]:
    """Mamba mixer: ``dt_b``, ``A_log`` (``alog`` tag: log 1 .. d_state)
    and ``D`` stay f32 in a bf16 model."""
    d, mc = cfg.d_model, cfg.mamba
    di = mc.expand * d
    dtr = mc.dt_rank or -(-d // 16)
    return {"ln1": Leaf((d,), (None,), "ones"),
            "in_proj": Leaf((d, 2 * di), ("embed", "ff")),
            "conv_w": Leaf((mc.d_conv, di), (None, "ff")),
            "conv_b": Leaf((di,), ("ff",), "zeros"),
            "x_proj": Leaf((di, dtr + 2 * mc.d_state), ("ff", None)),
            "dt_w": Leaf((dtr, di), (None, "ff")),
            "dt_b": Leaf((di,), ("ff",), "const:-4.6", "float32"),
            "A_log": Leaf((di, mc.d_state), ("ff", None), "alog", "float32"),
            "D": Leaf((di,), ("ff",), "ones", "float32"),
            "out_proj": Leaf((di, d), ("ff", "embed"))}


_RWKV_LORA = 32
_RWKV_DECAY_LORA = 64


def _rwkv_tm_leaves(cfg: ModelConfig) -> dict[str, Leaf]:
    """RWKV-6 time-mix.  ``w0`` and ``u`` stay f32 in a bf16 model;
    ``lora_B`` and ``decay_B`` start at zero, so the decay starts at
    ``w0``'s (``decay`` tag: -6 .. -1 across channels)."""
    d = cfg.d_model
    t = {"ln1": Leaf((d,), (None,), "ones")}
    for n in ("x", "w", "k", "v", "r", "g"):
        t[f"mu_{n}"] = Leaf((d,), (None,), "const:0.5")
    t["lora_A"] = Leaf((d, 5 * _RWKV_LORA), ("embed", None))
    t["lora_B"] = Leaf((5, _RWKV_LORA, d), (None, None, "embed"), "zeros")
    t["w0"] = Leaf((d,), (None,), "decay", "float32")
    t["decay_A"] = Leaf((d, _RWKV_DECAY_LORA), ("embed", None))
    t["decay_B"] = Leaf((_RWKV_DECAY_LORA, d), (None, "embed"), "zeros")
    t["u"] = Leaf((d,), (None,), "const:0.5", "float32")
    for n in ("wr", "wk", "wv", "wg"):
        t[n] = Leaf((d, d), ("embed", "heads"))
    t["wo"] = Leaf((d, d), ("heads", "embed"))
    t["lnx_g"] = Leaf((d,), (None,), "ones")
    t["lnx_b"] = Leaf((d,), (None,), "zeros")
    return t


def _rwkv_cm_leaves(cfg: ModelConfig) -> dict[str, Leaf]:
    d, f = cfg.d_model, cfg.d_ff
    return {"ln2": Leaf((d,), (None,), "ones"),
            "mu_ck": Leaf((d,), (None,), "const:0.5"),
            "mu_cr": Leaf((d,), (None,), "const:0.5"),
            "wk_cm": Leaf((d, f), ("embed", "ff")),
            "wv_cm": Leaf((f, d), ("ff", "embed")),
            "wr_cm": Leaf((d, d), ("embed", None))}


_MIXERS = {"attn": _attn_leaves, "local_attn": _attn_leaves,
           "cross_attn": lambda cfg: _attn_leaves(cfg, cross=True),
           "mamba": _mamba_leaves, "rwkv": _rwkv_tm_leaves}
_FFNS = {"dense": _dense_ffn_leaves, "moe": _moe_ffn_leaves,
         "rwkv_cm": _rwkv_cm_leaves}


class _Leaves(nn.Module):
    """A module whose parameters are the named leaves, uninitialised.
    ``shard_rules`` is the rules table its leaves were cut to one rank's
    shards under, or None (whole), and ``shard_mesh`` the mesh."""

    def __init__(self, leaves: dict[str, Leaf], dtype: torch.dtype, device):
        super().__init__()
        self.leaves = leaves
        self.shard_rules: Optional[dict] = None
        self.shard_mesh = None
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
    t = {"embed": Leaf((v, d), ("vocab", "embed"), "embed"),
         "final_norm": Leaf((d,), (None,), "ones")}
    if not cfg.tie_embeddings:
        t["lm_head"] = Leaf((d, v), ("embed", "vocab"))
    return t


class Transformer(_Leaves):
    """Embedding (``embed``), the decoder layers (``layers``), final norm
    (``final_norm``) and LM head (``lm_head``)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__(_top_leaves(cfg), DTYPES[cfg.param_dtype], device)
        self.cfg = cfg
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
    """(None, the top-level module), then (i, layer i)."""
    yield None, model
    yield from enumerate(model.layers)


def _prefix(i) -> str:
    return "" if i is None else f"layers.{i}."


def param_axes(cfg: ModelConfig) -> dict[str, tuple]:
    """Each parameter's logical axes, by its name in ``named_parameters``
    ("embed", "layers.3.we_gate", ...): the reference's ``param_axes``
    leaf by leaf (``reference_paths`` maps the names onto its tree; a
    stacked leaf there has a leading None)."""
    return {_prefix(i) + n: lf.axes
            for i, mod in _leaf_modules(abstract_params(cfg))
            for n, lf in mod.leaves.items()}


def built_axes(mod: nn.Module, name: str, mesh) -> Optional[tuple]:
    """For each dim of leaf `name` of `mod`, the mesh axes that split it as
    the model was built (the module's ``shard_rules``), or None where the
    module was built whole."""
    rules = getattr(mod, "shard_rules", None)
    if rules is None:
        return None
    lf = mod.leaves[name]
    spec = logical_to_pspec(lf.axes, rules, lf.shape, mesh)
    spec = spec + (None,) * (len(lf.shape) - len(spec))
    return tuple(() if e is None else ((e,) if isinstance(e, str)
                                       else tuple(e)) for e in spec)


def _leaf_values(lf: Leaf, generator, device) -> torch.Tensor:
    """One leaf's seeded values, whole, in f32; only the fan-in and embed
    tags draw from `generator`."""
    shape = lf.shape
    consts = {"zeros": 0.0, "ones": 1.0}
    if lf.init in consts or lf.init.startswith("const:"):
        c = consts[lf.init] if lf.init in consts else float(lf.init[6:])
        return torch.full(shape, c, device=device)
    if lf.init == "alog":
        return torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                                      device=device)).expand(shape)
    if lf.init == "decay":
        d = shape[-1]
        ramp = torch.arange(d, dtype=torch.float32, device=device)
        return (-6.0 + 5.0 * (ramp / max(d - 1, 1))).expand(shape)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = 0.02 if lf.init == "embed" else 1.0 / math.sqrt(max(fan_in, 1))
    return torch.randn(shape, generator=generator, device=device).mul_(std)


def _local(lf: Leaf, mesh, rules):
    """The leaf's slices on this rank under (mesh, rules), or None (whole)
    without a mesh."""
    if mesh is None:
        return None
    return local_slices(lf.shape, logical_to_pspec(lf.axes, rules, lf.shape,
                                                   mesh), mesh)


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", mesh=None, rules=None) -> Transformer:
    """A model with seeded random weights, made on `device`: fan-in normal
    (std 1/sqrt(fan_in)), 0.02 normal for the embedding, ones, zeros,
    constants, Mamba's log(1 .. d_state) and the RWKV decay ramp as
    tagged.  `generator` must live on `device`.

    With a DeviceMesh `mesh` and a rules table, the model holds only this
    rank's shard of each leaf (``sharding.logical_to_pspec`` of its axes),
    with the whole model's values: each leaf is drawn whole, cut and
    freed, so at most one leaf is ever whole on the device; every module
    keeps `rules` as its ``shard_rules``."""
    model = Transformer(cfg, device if mesh is None else "meta")
    for _, mod in _leaf_modules(model):
        for name, lf in mod.leaves.items():
            values = _leaf_values(lf, generator, device)
            cut = _local(lf, mesh, rules)
            if cut is None:
                getattr(mod, name).copy_(values)
            else:
                _set_leaf(mod, name, values[cut].to(getattr(mod, name).dtype,
                                                    copy=True))
            del values
    return _built_under(model, mesh, rules)


def _built_under(model: Transformer, mesh, rules) -> Transformer:
    """Each module keeps the rules and the mesh its leaves were cut under."""
    if mesh is not None:
        for _, mod in _leaf_modules(model):
            mod.shard_rules = dict(rules)
            mod.shard_mesh = mesh
    return model


def whole_leaf(mod: nn.Module, name: str) -> torch.Tensor:
    """Leaf `name` of `mod` whole: its shards gathered over the groups that
    split it as it was built (``built_axes``), dim by dim, in the ranks'
    shard order.  Collective where the leaf is split: every rank of the
    mesh calls it, leaf for leaf in the same order."""
    t = getattr(mod, name).detach()
    mesh = mod.shard_mesh
    if mesh is None:
        return t
    sizes = mesh_axes(mesh)
    for dim, axes in enumerate(built_axes(mod, name, mesh)):
        axes = tuple(a for a in axes if sizes[a] > 1)
        if axes:
            n = 1
            for a in axes:
                n *= sizes[a]
            t = all_gather(t.movedim(dim, 0), axis_group(mesh, axes), n
                           ).flatten(0, 1).movedim(0, dim)
    return t.contiguous()


def _set_leaf(mod: nn.Module, name: str, value: torch.Tensor):
    setattr(mod, name, nn.Parameter(value.contiguous(), requires_grad=False))


#: bf16 in numpy: raw 2-byte values, as ``np.asarray`` of the reference's
#: bf16 arrays writes them to an npz (``ml_dtypes`` is not needed)
BF16_RAW = np.dtype("V2")


def _from_numpy(a) -> torch.Tensor:
    a = np.array(a)                     # a writable, contiguous copy
    if a.dtype.name == "bfloat16" or a.dtype == BF16_RAW:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bf16 as raw 2-byte values
    (``BF16_RAW``)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_RAW)
    return t.numpy()


def reference_paths(model: Transformer) -> dict[str, tuple[list[str], bool]]:
    """Each leaf of the reference's tree, by its path ("embed",
    "prefix/l0/wq", "blocks/p1/wq", ...), with the names of the model's
    parameters that make it and whether the reference stacks them: a leaf
    of the repeated block is, in block order, along a leading
    ``num_blocks`` dim."""
    cfg = model.cfg
    out = {name: ([name], False) for name in model.leaves}
    P = len(cfg.block_pattern)
    for i, layer in enumerate(model.layers):
        for n in layer.leaves:
            if i < cfg.first_k_dense:
                out[f"prefix/l{i}/{n}"] = ([f"layers.{i}.{n}"], False)
            else:
                j = (i - cfg.first_k_dense) % P
                out.setdefault(f"blocks/p{j}/{n}", ([], True))[0].append(
                    f"layers.{i}.{n}")
    return out


def nest(flat: dict) -> dict:
    """{"blocks/p0/wq": leaf, ...} as the reference's nested tree (with its
    "prefix" and "blocks" even when empty)."""
    tree: dict = {"prefix": {}, "blocks": {}}
    for path, leaf in flat.items():
        *parents, name = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = leaf
    return tree


def to_jax_params(cfg: ModelConfig, model: Transformer) -> dict:
    """The inverse of ``from_jax_params``: the reference's ``init_params``
    tree of the model's weights, numpy leaves in its layout (``prefix/l{i}``
    apart, ``blocks/p{j}`` stacked on a leading ``num_blocks`` dim; bf16 as
    raw 2-byte values).  Each leaf's global value: a model built under a
    mesh has its shards gathered (``whole_leaf``; collective, every rank
    of the mesh calls it)."""
    if model.cfg != cfg:
        raise ValueError(f"the model is a {model.cfg.name}, not {cfg.name}")
    named = {_prefix(i) + n: whole_leaf(mod, n)
             for i, mod in _leaf_modules(model) for n in mod.leaves}
    return nest({
        path: (np.stack([to_numpy(named[n]) for n in names]) if stacked
               else to_numpy(named[names[0]]))
        for path, (names, stacked) in reference_paths(model).items()})


@torch.no_grad()
def from_jax_params(cfg: ModelConfig, tree, device="cuda", mesh=None,
                    rules=None) -> Transformer:
    """The reference package's ``init_params`` tree, with numpy arrays as
    leaves, as a port model.  The stacked leading ``num_blocks`` dim of
    ``tree["blocks"]`` is split into per-layer modules.  With (`mesh`,
    `rules`) only this rank's shard of each leaf is kept, as
    ``init_params`` keeps it."""
    model = Transformer(cfg, device if mesh is None else "meta")
    P = len(cfg.block_pattern)
    for i, mod in _leaf_modules(model):
        if i is None:
            src = tree
        elif i < cfg.first_k_dense:
            src = tree["prefix"][f"l{i}"]
        else:
            blk, j = divmod(i - cfg.first_k_dense, P)
            src = {n: a[blk] for n, a in tree["blocks"][f"p{j}"].items()}
        for name, lf in mod.leaves.items():
            a = src[name]
            cut = _local(lf, mesh, rules)
            if cut is None:
                getattr(mod, name).copy_(_from_numpy(a))
            else:
                dtype = getattr(mod, name).dtype
                _set_leaf(mod, name, _from_numpy(np.asarray(a)[cut]).to(
                    device=device, dtype=dtype))
    return _built_under(model, mesh, rules)


def _layer_state_leaves(cfg: ModelConfig, spec: LayerSpec, batch: int,
                        max_len: int) -> dict[str, Leaf]:
    """One layer's state (module docstring), zeros, with the reference's
    logical axes (its ``layer_state_leaves``)."""
    cdt = cfg.dtype
    if spec.mixer == "rwkv":
        K = cfg.rwkv_head_dim
        return {"wkv": Leaf((batch, cfg.d_model // K, K, K),
                            ("batch", "heads", None, None), "zeros",
                            "float32"),
                "shift_t": Leaf((batch, cfg.d_model), ("batch", "embed"),
                                "zeros", cdt),
                "shift_c": Leaf((batch, cfg.d_model), ("batch", "embed"),
                                "zeros", cdt)}
    if spec.mixer == "mamba":
        mc = cfg.mamba
        di = mc.expand * cfg.d_model
        return {"ssm": Leaf((batch, di, mc.d_state), ("batch", "ff", None),
                            "zeros", "float32"),
                "conv": Leaf((batch, mc.d_conv - 1, di),
                             ("batch", None, "ff"), "zeros", cdt)}
    if spec.mixer == "cross_attn":
        shape = (batch, cfg.num_vision_tokens, cfg.num_kv_heads,
                 cfg.head_dim_)
        axes = ("batch", None, "kv_heads", None)
        return {"xk": Leaf(shape, axes, "zeros", cdt),
                "xv": Leaf(shape, axes, "zeros", cdt)}
    if cfg.kv_lora_rank:
        return {"c_kv": Leaf((batch, max_len, cfg.kv_lora_rank),
                             ("batch", "ctx", "kv_lora"), "zeros", cdt),
                "k_rope": Leaf((batch, max_len, cfg.qk_rope_dim),
                               ("batch", "ctx", None), "zeros", cdt)}
    kv_dt = cfg.kv_cache_dtype or cdt
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim_)
    axes = ("batch", "ctx", "kv_heads", None)
    st = {"k": Leaf(shape, axes, "zeros", kv_dt),
          "v": Leaf(shape, axes, "zeros", kv_dt)}
    if kv_dt == "int8":
        for name in ("k_scale", "v_scale"):
            st[name] = Leaf(shape[:3], axes[:3], "zeros", "float32")
    return st


def init_state(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> list[dict[str, torch.Tensor]]:
    """Zeroed per-layer state (module docstring): KV caches in
    cfg.kv_cache_dtype or cfg.dtype, or MLA's latent caches in cfg.dtype,
    (batch, max_len, ...); cross-attention's image keys / values and the
    Mamba and RWKV-6 recurrent states, which have no max_len."""
    return [{n: torch.zeros(lf.shape, dtype=DTYPES[lf.dtype], device=device)
             for n, lf in _layer_state_leaves(cfg, spec, batch,
                                              max_len).items()}
            for spec in cfg.layer_specs]


def abstract_state(cfg: ModelConfig, batch: int,
                   max_len: int) -> list[dict[str, torch.Tensor]]:
    """The state's shapes and dtypes on the ``meta`` device: no memory is
    allocated (the reference's ShapeDtypeStruct tree)."""
    return init_state(cfg, batch, max_len, "meta")


def state_axes(cfg: ModelConfig, batch: int = 1,
               max_len: int = 8) -> list[dict[str, tuple]]:
    """Each state leaf's logical axes, in ``init_state``'s layout (a dict a
    layer; the reference keeps layer i under prefix/l{i} or stacks it under
    blocks/p{j} as ``reference_paths`` says of its parameters)."""
    return [{n: lf.axes for n, lf in _layer_state_leaves(
        cfg, spec, batch, max_len).items()} for spec in cfg.layer_specs]


def shard_state(cfg: ModelConfig, state, mesh, rules):
    """This rank's shard of a whole `state` (``init_state``'s layout) under
    (`mesh`, `rules`): each leaf cut by its logical axes.  A cache whose
    length does not divide over the axes "ctx" maps to is refused: the
    layers take a "ctx" mapping as given (``models.ops._cache_layout``)."""
    out = []
    for st, axes in zip(state, state_axes(cfg)):
        leaves = {}
        for n, t in st.items():
            spec = logical_to_pspec(axes[n], rules, tuple(t.shape), mesh)
            if "ctx" in axes[n]:
                d = axes[n].index("ctx")
                want = logical_to_pspec(axes[n], rules, None, mesh)
                if (want + (None,) * 4)[d] != (spec + (None,) * 4)[d]:
                    raise ValueError(
                        f"{n}: a cache of {t.shape[d]} positions does not "
                        f"split over {want[d]}")
            leaves[n] = local_shard(t, spec, mesh)
        out.append(leaves)
    return out


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
