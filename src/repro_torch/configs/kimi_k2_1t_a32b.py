"""Kimi K2 — trillion-parameter MoE (paper-table geometry).

[arXiv:2501.kimi2] 61L d_model=7168 64H (GQA kv=8) expert d_ff=2048
vocab=163840, MoE 384 routed experts top-8 + 1 shared; first layer dense
(dense d_ff=18432, per the K2 card).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    citation="arXiv:2501.kimi2",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=18432,                      # dense-FFN layers (first_k_dense)
    vocab_size=163840,
    first_k_dense=1,
    block_pattern=(LayerSpec(ffn="moe"),),
    moe=MoEConfig(num_experts=384, top_k=8, num_shared=1, d_ff_expert=2048),
    rope_theta=5e4,
)

SMOKE = CONFIG.replace(
    name="kimi-k2-smoke",
    num_layers=2, first_k_dense=1, d_model=256, num_heads=4, num_kv_heads=2,
    d_ff=512, vocab_size=512,
    moe=MoEConfig(num_experts=4, top_k=2, num_shared=1, d_ff_expert=128),
    dtype="float32", param_dtype="float32",
)
