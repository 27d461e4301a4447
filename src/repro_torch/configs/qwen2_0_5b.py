"""Qwen2-0.5B — dense GQA with QKV bias, tied embeddings.

[arXiv:2407.10671] 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    arch_type="dense",
    citation="arXiv:2407.10671",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e6,
    block_pattern=(LayerSpec(),),
)

SMOKE = CONFIG.replace(
    name="qwen2-smoke",
    num_layers=2, d_model=224, num_heads=14, num_kv_heads=2,
    d_ff=512, vocab_size=512, dtype="float32", param_dtype="float32",
)
