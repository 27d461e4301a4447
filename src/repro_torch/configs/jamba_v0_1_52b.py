"""Jamba v0.1 52B — Mamba+attention 1:7 interleave with MoE.

[arXiv:2403.19887] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536;
attention at layer offset 4 of each period-8 block; MoE (16 experts top-2)
every other layer; Mamba d_state=16 d_conv=4 expand=2.
"""
from repro_torch.configs.base import (LayerSpec, MambaConfig, ModelConfig,
                                      MoEConfig)

_BLOCK = (
    LayerSpec(mixer="mamba", ffn="dense"),
    LayerSpec(mixer="mamba", ffn="moe"),
    LayerSpec(mixer="mamba", ffn="dense"),
    LayerSpec(mixer="mamba", ffn="moe"),
    LayerSpec(mixer="attn", ffn="dense"),
    LayerSpec(mixer="mamba", ffn="moe"),
    LayerSpec(mixer="mamba", ffn="dense"),
    LayerSpec(mixer="mamba", ffn="moe"),
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    citation="arXiv:2403.19887",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    block_pattern=_BLOCK,
    moe=MoEConfig(num_experts=16, top_k=2, num_shared=0, d_ff_expert=14336),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
)

SMOKE = CONFIG.replace(
    name="jamba-smoke",
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
    d_ff=512, vocab_size=512,
    block_pattern=(LayerSpec(mixer="mamba", ffn="moe"),
                   LayerSpec(mixer="attn", ffn="dense")),
    moe=MoEConfig(num_experts=4, top_k=2, num_shared=0, d_ff_expert=128),
    mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
    dtype="float32", param_dtype="float32",
)
