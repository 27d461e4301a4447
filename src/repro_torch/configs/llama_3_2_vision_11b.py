"""Llama-3.2-Vision 11B — text decoder with cross-attention image layers.

[hf:meta-llama/Llama-3.2-11B-Vision] 40L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=128256; cross-attention layers every 5th layer
(positions 3, 8, 13, ... — block pattern of 5 with cross at index 3).
The ViT vision encoder + projector is the stubbed modality frontend:
prefill takes (B, 6400, d_model) patch embeddings as `image_embeds`.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

_BLOCK = (LayerSpec(), LayerSpec(), LayerSpec(),
          LayerSpec(mixer="cross_attn"), LayerSpec())

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    arch_type="vlm",
    citation="hf:meta-llama/Llama-3.2-11B-Vision",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=5e5,
    num_vision_tokens=6400,
    block_pattern=_BLOCK,
)

SMOKE = CONFIG.replace(
    name="llama-vision-smoke",
    num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
    d_ff=512, vocab_size=512, num_vision_tokens=64,
    block_pattern=(LayerSpec(), LayerSpec(mixer="cross_attn")),
    dtype="float32", param_dtype="float32",
)
