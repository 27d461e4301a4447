"""Qwen-2.5-32B — the paper's *large model* evaluation target (§V).

[arXiv:2412.15115] 64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064,
QKV bias.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen-2.5-32b",
    arch_type="dense",
    citation="arXiv:2412.15115 (paper §V large model)",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    block_pattern=(LayerSpec(),),
)

SMOKE = CONFIG.replace(
    name="qwen25-smoke",
    num_layers=2, d_model=320, num_heads=5, num_kv_heads=1,
    d_ff=512, vocab_size=512, dtype="float32", param_dtype="float32",
)
