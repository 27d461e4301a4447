"""MusicGen-Large — decoder-only transformer over EnCodec audio tokens.

[arXiv:2306.05284] 48L d_model=2048 32H (kv=32, i.e. MHA) d_ff=8192
vocab=2048 (EnCodec codebook).  Backbone only: the EnCodec conv codec
(audio -> discrete tokens) is the stubbed modality frontend, so the model
takes token ids (see DESIGN.md).
GELU-gated FFN; rope replaces the original learned sinusoidal embedding
(TPU-idiomatic adaptation, noted in DESIGN.md).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    citation="arXiv:2306.05284",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    act="gelu",
    block_pattern=(LayerSpec(),),
)

SMOKE = CONFIG.replace(
    name="musicgen-smoke",
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
    d_ff=512, vocab_size=512, dtype="float32", param_dtype="float32",
)
