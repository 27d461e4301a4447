"""Model configuration: the dataclasses of the reference package's
``repro/configs/base.py``, copied so the port needs no JAX.

Each supported architecture has a module ``repro_torch/configs/<id>.py``
exporting ``CONFIG`` (the published geometry, cited) and ``SMOKE`` (a
reduced same-family variant for CPU tests).
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional

# ---------------------------------------------------------------------------
# Layer / model configs
# ---------------------------------------------------------------------------

MIXERS = ("attn", "local_attn", "cross_attn", "mamba", "rwkv")
FFNS = ("dense", "moe", "rwkv_cm")


@dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"          # one of MIXERS
    ffn: str = "dense"           # one of FFNS

    def __post_init__(self):
        assert self.mixer in MIXERS, self.mixer
        assert self.ffn in FFNS, self.ffn


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8          # routed experts
    top_k: int = 2
    num_shared: int = 0           # shared (always-on) experts
    d_ff_expert: int = 0          # expert hidden dim
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01  # load-balance loss coefficient


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 -> ceil(d_model/16)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                # dense | moe | ssm | hybrid | vlm | audio
    citation: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    # layer pattern: `block_pattern` repeats `num_layers // len(block_pattern)`
    # times after `first_k_dense` unrolled prefix layers (dense-FFN attn).
    block_pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    first_k_dense: int = 0
    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0       # window for local_attn layers
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    query_scale: float = 0.0      # 0 -> 1/sqrt(head_dim)
    # MLA (deepseek-style latent attention); kv_lora_rank>0 enables it
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128
    # FFN
    act: str = "silu"             # silu (SwiGLU) | gelu (GeGLU)
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    # embeddings
    tie_embeddings: bool = False
    scale_embeds: bool = False    # gemma-style sqrt(d_model) scaling
    norm_plus_one: bool = False   # gemma RMSNorm (1+w)
    post_norms: bool = False      # gemma2 post-attn/post-ffn norms
    # multimodal
    num_vision_tokens: int = 0    # vlm cross-attn source length (stub frontend)
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    kv_cache_dtype: str = ""      # "" -> dtype; "int8" = quantized KV cache
                                  # (per-token-per-head scales; halves decode
                                  # HBM traffic and doubles the memory-bound
                                  # batch -> raises decode Token Velocity)
    # rwkv
    rwkv_head_dim: int = 64

    # ---- derived ----
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def num_blocks(self) -> int:
        body = self.num_layers - self.first_k_dense
        assert body % len(self.block_pattern) == 0, (
            f"{self.name}: {body} layers not divisible by block "
            f"pattern of {len(self.block_pattern)}")
        return body // len(self.block_pattern)

    @property
    def layer_specs(self) -> tuple[LayerSpec, ...]:
        return (tuple(LayerSpec() for _ in range(self.first_k_dense))
                + self.block_pattern * self.num_blocks)

    @property
    def uses_attention(self) -> bool:
        return any(s.mixer in ("attn", "local_attn", "cross_attn")
                   for s in self.layer_specs)

    @property
    def is_subquadratic(self) -> bool:
        """True if no unbounded full-attention KV cache is required."""
        return all(s.mixer in ("mamba", "rwkv", "local_attn", "cross_attn")
                   for s in self.layer_specs)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (for roofline MODEL_FLOPS = 6 N D) ----
    def param_counts(self) -> dict[str, float]:
        d, dh = self.d_model, self.head_dim_
        nq, nkv = self.num_heads, self.num_kv_heads
        embed = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d

        def attn_params(cross: bool = False) -> float:
            if self.kv_lora_rank and not cross:
                qk = self.qk_nope_dim + self.qk_rope_dim
                p = d * nq * qk                                 # q proj
                p += d * (self.kv_lora_rank + self.qk_rope_dim)  # kv down
                p += self.kv_lora_rank * nq * (self.qk_nope_dim
                                               + self.v_head_dim)  # kv up
                p += nq * self.v_head_dim * d                   # o proj
                return p
            return d * (nq * dh) + 2 * d * (nkv * dh) + (nq * dh) * d

        def ffn_params(spec: LayerSpec) -> float:
            if spec.ffn == "dense":
                return 3 * d * self.d_ff
            if spec.ffn == "rwkv_cm":
                return 2 * d * self.d_ff + d * d
            m = self.moe
            routed = m.num_experts * 3 * d * m.d_ff_expert
            shared = m.num_shared * 3 * d * m.d_ff_expert
            return routed + shared + d * m.num_experts

        def ffn_active(spec: LayerSpec) -> float:
            if spec.ffn != "moe":
                return ffn_params(spec)
            m = self.moe
            return (m.top_k + m.num_shared) * 3 * d * m.d_ff_expert \
                + d * m.num_experts

        def mixer_params(spec: LayerSpec) -> float:
            if spec.mixer in ("attn", "local_attn"):
                return attn_params()
            if spec.mixer == "cross_attn":
                return attn_params(cross=True)
            if spec.mixer == "mamba":
                mc = self.mamba
                di = mc.expand * d
                dtr = mc.dt_rank or -(-d // 16)
                return (d * 2 * di + di * mc.d_conv
                        + di * (dtr + 2 * mc.d_state) + dtr * di
                        + di * mc.d_state + di + di * d)
            if spec.mixer == "rwkv":
                # r,k,v,g,o projections + decay lora + token-shift loras
                return 5 * d * d + 6 * (d * 32 + 32 * d) + d * 64 + 64 * d
            raise ValueError(spec.mixer)

        total = embed + head
        active = embed + head
        for spec in self.layer_specs:
            mp = mixer_params(spec)
            total += mp + ffn_params(spec)
            active += mp + ffn_active(spec)
        return {"total": float(total), "active": float(active)}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = [
    "rwkv6_3b", "qwen2_0_5b", "kimi_k2_1t_a32b", "deepseek_v2_lite_16b",
    "yi_9b", "musicgen_large", "gemma2_9b", "gemma_2b",
    "llama_3_2_vision_11b", "jamba_v0_1_52b",
    # the paper's own evaluation models
    "llama31_8b", "qwen25_32b",
]

_ALIAS = {i.replace("_", "-"): i for i in ARCH_IDS}
_ALIAS.update({
    "rwkv6-3b": "rwkv6_3b", "qwen2-0.5b": "qwen2_0_5b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b", "yi-9b": "yi_9b",
    "musicgen-large": "musicgen_large", "gemma2-9b": "gemma2_9b",
    "gemma-2b": "gemma_2b", "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "llama-3.1-8b": "llama31_8b", "qwen-2.5-32b": "qwen25_32b",
})


def canonical_id(arch: str) -> str:
    return _ALIAS.get(arch, arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical_id(arch)}")
    return mod.SMOKE if smoke else mod.CONFIG
