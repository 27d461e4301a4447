"""RWKV-6 "Finch" 3B — attention-free SSM with data-dependent decay.

[arXiv:2404.05892] 32L d_model=2560 d_ff=8960 vocab=65536; head_dim=64
(40 wkv heads).  Mixer = RWKV6 time-mix, FFN = RWKV channel-mix.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    arch_type="ssm",
    citation="arXiv:2404.05892",
    num_layers=32,
    d_model=2560,
    num_heads=40,          # wkv heads = d_model / rwkv_head_dim
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    rwkv_head_dim=64,
    block_pattern=(LayerSpec(mixer="rwkv", ffn="rwkv_cm"),),
)

SMOKE = CONFIG.replace(
    name="rwkv6-smoke",
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
    d_ff=512, vocab_size=512, dtype="float32", param_dtype="float32",
)
