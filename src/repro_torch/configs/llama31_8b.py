"""Llama-3.1-8B — the paper's *small model* evaluation target (§V).

[arXiv:2407.21783] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.1-8b",
    arch_type="dense",
    citation="arXiv:2407.21783 (paper §V small model)",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=5e5,
    block_pattern=(LayerSpec(),),
)

SMOKE = CONFIG.replace(
    name="llama31-smoke",
    num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
    d_ff=512, vocab_size=512, dtype="float32", param_dtype="float32",
)
