"""Operations and bytes: the yardstick of ``mfu`` and the rooflines.

Counts are from a reference's ``dims`` (the published sizes), never from
the program.  ``layer_active`` is a frozen copy of the arithmetic of the
port's ``configs.base.ModelConfig.param_counts`` (whose ``active`` count
``launch.roofline.model_flops_estimate`` doubles per token), and
``kv_bytes_per_token`` of ``core.hardware.kv_bytes_per_token``.  A
model FLOP is 2 per active weight per token that passes it, plus the
attention that the token's causal context needs; the embedding is a
lookup, and the LM head counts only where logits are computed.

A kernel's bound (``prefill_attn`` / ``decode_attn``, per layer and call)
reads each input byte once and writes each output byte once: the valid
query rows, the keys and values up to the last valid position, the valid
output rows; its operations are the causal products over the valid
lengths, 4 x head_dim a (query, key) pair and head (Q K^T and P V).
"""
from __future__ import annotations

#: published dense peaks (NVIDIA's data sheet, SXM part, 700 W), by the
#: name ``torch.cuda.get_device_name()`` gives
PEAKS = {"NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12,
                                   "hbm_bytes_s": 3.35e12}}


def is_mla(d: dict) -> bool:
    return "kv_lora_rank" in d


def layer_active(d: dict, i: int) -> float:
    """Weights a token passes in layer `i` (attention + the FFN's active
    part: the top-k and the shared experts and the router)."""
    D, H = d["hidden_size"], d["num_attention_heads"]
    if is_mla(d):
        qk = d["qk_nope_head_dim"] + d["qk_rope_head_dim"]
        attn = (D * H * qk + D * (d["kv_lora_rank"] + d["qk_rope_head_dim"])
                + d["kv_lora_rank"] * H * (d["qk_nope_head_dim"]
                                           + d["v_head_dim"])
                + H * d["v_head_dim"] * D)
        if i < d["first_k_dense_replace"]:
            return attn + 3 * D * d["intermediate_size"]
        f = d["moe_intermediate_size"]
        return attn + (d["num_experts_per_tok"] + d["n_shared_experts"]) \
            * 3 * D * f + D * d["n_routed_experts"]
    hd, Hkv = d["head_dim"], d["num_key_value_heads"]
    attn = D * (H * hd) + 2 * D * (Hkv * hd) + (H * hd) * D
    return attn + 3 * D * d["intermediate_size"]


def body_active(d: dict) -> float:
    return sum(layer_active(d, i) for i in range(d["num_hidden_layers"]))


def head_weights(d: dict) -> float:
    return float(d["hidden_size"] * d["vocab_size"])


def pair_flops(d: dict) -> float:
    """Attention FLOPs of one (query, key) pair in one layer, all heads."""
    H = d["num_attention_heads"]
    if is_mla(d):
        return 2.0 * H * (d["qk_nope_head_dim"] + d["qk_rope_head_dim"]
                          + d["v_head_dim"])
    return 4.0 * H * d["head_dim"]


def causal_pairs(start: int, n: int) -> int:
    """(query, key) pairs of `n` queries at positions start .. start+n-1,
    each seeing every key at or before it."""
    return n * start + n * (n + 1) // 2


def kv_bytes_per_token(d: dict, bytes_per_el: int = 2) -> float:
    """Cache bytes a token over all layers (bf16; MLA's latent cache)."""
    L = d["num_hidden_layers"]
    if is_mla(d):
        return float(L * (d["kv_lora_rank"] + d["qk_rope_head_dim"])
                     * bytes_per_el)
    return float(L * 2 * d["num_key_value_heads"] * d["head_dim"]
                 * bytes_per_el)


def prefill_model_flops(d: dict, start: int, n: int) -> float:
    """A prefill call of `n` valid tokens at offset `start`, one row of
    logits."""
    return (2.0 * body_active(d) * n + 2.0 * head_weights(d)
            + pair_flops(d) * causal_pairs(start, n) * d["num_hidden_layers"])


def decode_model_flops(d: dict, contexts) -> float:
    """One decode token for each slot in `contexts` (keys it sees,
    itself included)."""
    per = 2.0 * (body_active(d) + head_weights(d))
    return sum(per + pair_flops(d) * c * d["num_hidden_layers"]
               for c in contexts)


def prefill_attn(d: dict, start: int, n: int, el: int = 2):
    """(FLOPs, bytes) of one layer's prefill attention kernel call."""
    H, Hkv, hd = (d["num_attention_heads"], d["num_key_value_heads"],
                  d["head_dim"])
    flops = 4.0 * H * hd * causal_pairs(start, n)
    nbytes = (2 * n * H * hd + 2 * (start + n) * Hkv * hd) * el
    return flops, float(nbytes)


def decode_attn(d: dict, keys, el: int = 2):
    """(FLOPs, bytes) of one layer's decode attention kernel call over
    slots that each read `keys[b]` positions."""
    H, Hkv, hd = (d["num_attention_heads"], d["num_key_value_heads"],
                  d["head_dim"])
    total = sum(keys)
    flops = 4.0 * H * hd * total
    nbytes = (2 * len(keys) * H * hd + 2 * total * Hkv * hd) * el
    return flops, float(nbytes)


def bound_s(flops: float, nbytes: float, peak: dict) -> float:
    """The least time: the larger of operations over the peak rate and
    bytes over the memory bandwidth."""
    return max(flops / peak["bf16_flops"], nbytes / peak["hbm_bytes_s"])
