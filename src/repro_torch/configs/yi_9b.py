"""Yi-9B — llama-architecture dense GQA.

[arXiv:2403.04652] 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    arch_type="dense",
    citation="arXiv:2403.04652",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5e6,
    block_pattern=(LayerSpec(),),
)

SMOKE = CONFIG.replace(
    name="yi-smoke",
    num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
    d_ff=512, vocab_size=512, dtype="float32", param_dtype="float32",
)
