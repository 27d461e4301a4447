"""Production mesh + sharding-rule tables.

The counterpart of the reference package's ``launch/mesh.py``.  Importing
this module touches no process group: the mesh is built by a FUNCTION,
over the process group the caller has initialised (one rank per device,
or a ``fake`` group to reason about a mesh without its devices).

Mesh shapes (the reference's):
  single-pod  (16, 16)        axes ("data", "model")   = 256 ranks
  multi-pod   (2, 16, 16)     axes ("pod", "data", "model") = 512 ranks

Rule tables map the models' logical axes to mesh axes per run kind:

  * ACT rules   — activations + decode/prefill state.  Batch shards over
    (pod, data); tensor-parallel dims over model; decode caches shard their
    sequence axis over model (GQA KV-head counts < 16 cannot split the
    model axis, the cache would otherwise replicate 16x); the batch=1
    long-context shape context-shards the cache over (data, model).
  * PARAM rules — weights.  TP dims over model; optionally FSDP: the embed
    (d_model) axis over (pod, data) when TP-only residency would overflow
    the chip's memory (always on for training, where grads + moments
    triple the bytes).

``needs_fsdp`` keeps the reference's budget, a TPU v5e's 16 GB
(``core.hardware.V5E``); a budget for an H100 mesh is still to be chosen.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.hardware import V5E, weight_bytes


def make_production_mesh(device_type: str = "cuda", *,
                         multi_pod: bool = False):
    """The production DeviceMesh over the initialised process group, whose
    world size must be 256 (512 with `multi_pod`)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def batch_axes(multi_pod: bool) -> tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def act_rules(shape: InputShape, multi_pod: bool) -> dict:
    b = batch_axes(multi_pod)
    rules = {
        "batch": b,
        "seq": (),
        "ctx": ("model",),          # cache sequence axis (see module doc)
        "embed": (),
        "heads": ("model",),
        "kv_heads": ("model",),
        "ff": ("model",),
        "experts": ("model",),
        "expert_ff": (),
        "vocab": ("model",),
        "kv_lora": (),
        "state": (),
    }
    if shape.kind == "decode":
        # decode: weight-stationary MoE (ops._moe_ep_path S==1 path) keeps
        # expert d_ff sharded over the FSDP axes instead of re-gathering
        # weights every token
        rules["expert_ff"] = b
    if shape.kind == "decode" and shape.global_batch == 1:
        # long-context decode: context parallelism replaces data parallelism
        rules["batch"] = ()
        rules["ctx"] = ("data", "model") if not multi_pod \
            else ("pod", "data", "model")
    return rules


def param_rules(cfg: ModelConfig, shape: InputShape, multi_pod: bool,
                fsdp: Optional[bool] = None) -> dict:
    if fsdp is None:
        fsdp = needs_fsdp(cfg, shape)
    f = batch_axes(multi_pod) if fsdp else ()
    # decode: dense/attention weights always fit TP-resident, so never FSDP
    # them — FSDP'd weights would be re-gathered every decoded token.
    # Expert weights stay sharded over the FSDP axes and are consumed in
    # place by the weight-stationary S==1 MoE path (ops._moe_ep_path).
    embed_f = () if shape.kind == "decode" else f
    return {
        "embed": embed_f,           # FSDP axis (d_model rows)
        "expert_ff": f,             # FSDP axis for expert d_ff (see params)
        "heads": ("model",),
        "kv_heads": ("model",),
        "ff": ("model",),
        "experts": ("model",),
        "vocab": ("model",),
        "kv_lora": (),
        "batch": (), "seq": (), "ctx": (), "state": (),
    }


def needs_fsdp(cfg: ModelConfig, shape: InputShape,
               model_shards: int = 16) -> bool:
    """TP-only residency check against the v5e memory budget.

    Training counts params(bf16) + grads(bf16) + AdamW moments(f32) =
    12 bytes/param; if that fits TP-only we skip FSDP entirely — FSDP'd
    weights re-gather inside the depth loop every step."""
    wb = weight_bytes(cfg)
    if shape.kind == "train":
        n = cfg.param_counts()["total"]
        train_bytes = 12.0 * n / model_shards
        return train_bytes > 0.8 * V5E.hbm_cap
    return wb / model_shards > 0.35 * V5E.hbm_cap

