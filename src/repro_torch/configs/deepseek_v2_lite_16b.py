"""DeepSeek-V2-Lite 16B — MLA latent attention + fine-grained MoE.

[arXiv:2405.04434] 27L d_model=2048 16H, MLA kv_lora_rank=512
(qk_nope=128, qk_rope=64, v_head=128), expert d_ff=1408,
2 shared + 64 routed experts top-6, first layer dense (d_ff=10944).
(The pool line's "160 routed" is the full V2; the Lite card is 64 routed —
we follow the Lite card, see DESIGN.md.)
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    citation="arXiv:2405.04434",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,                      # dense-FFN first layer
    vocab_size=102400,
    first_k_dense=1,
    block_pattern=(LayerSpec(ffn="moe"),),
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, d_ff_expert=1408),
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    rope_theta=1e4,
)

SMOKE = CONFIG.replace(
    name="deepseek-v2-lite-smoke",
    num_layers=2, first_k_dense=1, d_model=256, num_heads=4, num_kv_heads=4,
    d_ff=512, vocab_size=512,
    moe=MoEConfig(num_experts=4, top_k=2, num_shared=1, d_ff_expert=128),
    kv_lora_rank=64, qk_rope_dim=16, qk_nope_dim=32, v_head_dim=32,
    dtype="float32", param_dtype="float32",
)
