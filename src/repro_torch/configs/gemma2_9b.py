"""Gemma-2 9B — alternating local/global attention with logit softcaps.

[arXiv:2408.00118] 42L d_model=3584 16H (GQA kv=8) head_dim=256 d_ff=14336
vocab=256000; sliding window 4096 on local layers; attn softcap 50, final
logit softcap 30; GeGLU; tied embeddings; pre+post norms.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    arch_type="dense",
    citation="arXiv:2408.00118",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    sliding_window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    act="gelu",
    tie_embeddings=True,
    scale_embeds=True,
    norm_plus_one=True,
    post_norms=True,
    query_scale=1.0 / 256.0 ** 0.5,
    block_pattern=(LayerSpec(mixer="local_attn"), LayerSpec(mixer="attn")),
)

SMOKE = CONFIG.replace(
    name="gemma2-smoke",
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
    d_ff=512, vocab_size=512, sliding_window=64,
    query_scale=1.0 / 64.0 ** 0.5,
    dtype="float32", param_dtype="float32",
)
