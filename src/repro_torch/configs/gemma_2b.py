"""Gemma 2B — GeGLU, head_dim=256, MQA (kv=1), tied embeddings.

[arXiv:2403.08295] 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    arch_type="dense",
    citation="arXiv:2403.08295",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    act="gelu",
    tie_embeddings=True,
    scale_embeds=True,
    norm_plus_one=True,
    block_pattern=(LayerSpec(),),
)

SMOKE = CONFIG.replace(
    name="gemma-smoke",
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=1, head_dim=64,
    d_ff=512, vocab_size=512, dtype="float32", param_dtype="float32",
)
