"""Plain reference of the Qwen2 family (Qwen-2.5, arXiv:2412.15115).

Pre-norm decoder: RMSNorm, grouped-query attention with a bias on the q,
k and v projections and rotate-half RoPE (theta from the file), RMSNorm,
SwiGLU MLP; final RMSNorm and an untied LM head.  Weights are x @ W
(in, out), the port's layout.
"""
from __future__ import annotations

import torch

from portbench.reference.common import (Lin, causal_attention, rmsnorm, rope,
                                        swiglu, unembed)

#: the port's ModelConfig field for each key of the file this family reads
PORT_KEYS = {"d_model": "hidden_size", "num_layers": "num_hidden_layers",
             "num_heads": "num_attention_heads",
             "num_kv_heads": "num_key_value_heads",
             "d_ff": "intermediate_size", "vocab_size": "vocab_size",
             "rope_theta": "rope_theta"}


def dims(hf: dict) -> dict:
    d = {k: hf[k] for k in PORT_KEYS.values()}
    d["head_dim"] = hf["hidden_size"] // hf["num_attention_heads"]
    d["rms_norm_eps"] = hf["rms_norm_eps"]
    return d


def leaves(d: dict) -> list:
    D, H, Hkv, F, V = (d["hidden_size"], d["num_attention_heads"],
                       d["num_key_value_heads"], d["intermediate_size"],
                       d["vocab_size"])
    hd = d["head_dim"]
    out = [("embed", (V, D), "embed"), ("final_norm", (D,), "norm"),
           ("lm_head", (D, V), "in")]
    for i in range(d["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [(p + "ln1", (D,), "norm"), (p + "wq", (D, H * hd), "qk"),
                (p + "wk", (D, Hkv * hd), "qk"),
                (p + "wv", (D, Hkv * hd), "in"),
                (p + "wo", (H * hd, D), "attn_out"),
                (p + "bq", (H * hd,), "bias"), (p + "bk", (Hkv * hd,), "bias"),
                (p + "bv", (Hkv * hd,), "bias"), (p + "ln2", (D,), "norm"),
                (p + "w_gate", (D, F), "in"), (p + "w_up", (D, F), "in"),
                (p + "w_down", (F, D), "out")]
    return out


@torch.no_grad()
def logits(d: dict, w: dict, seqs: list, positions: list, quant=None):
    """Float32 logits of each sequence (a 1-D int64 tensor on the
    weights' device) at its `positions`, layer by layer over all of them
    (each layer's weights in float32 once)."""
    lin = Lin(quant)
    eps, theta = d["rms_norm_eps"], d["rope_theta"]
    H, Hkv, hd = (d["num_attention_heads"], d["num_key_value_heads"],
                  d["head_dim"])
    xs = [lin.act(w["embed"][s].float()) for s in seqs]
    for i in range(d["num_hidden_layers"]):
        L = {n: w[f"layers.{i}.{n}"] for n in
             ("ln1", "wq", "wk", "wv", "wo", "bq", "bk", "bv", "ln2",
              "w_gate", "w_up", "w_down")}
        norms = {n: L[n].float() for n in ("ln1", "ln2", "bq", "bk", "bv")}
        mats = {n: lin.w(L[n]) for n in ("wq", "wk", "wv", "wo", "w_gate",
                                          "w_up", "w_down")}
        for j, x in enumerate(xs):
            S = x.shape[0]
            pos = torch.arange(S, device=x.device)
            h = rmsnorm(x, norms["ln1"], eps)
            q = (lin(h, mats["wq"]) + norms["bq"]).view(S, H, hd)
            k = (lin(h, mats["wk"]) + norms["bk"]).view(S, Hkv, hd)
            v = (lin(h, mats["wv"]) + norms["bv"]).view(S, Hkv, hd)
            o = causal_attention(rope(q, pos, theta),
                                 lin.act(rope(k, pos, theta)), lin.act(v),
                                 hd ** -0.5)
            x = lin.act(x + lin(o.reshape(S, H * hd), mats["wo"]))
            h = rmsnorm(x, norms["ln2"], eps)
            xs[j] = lin.act(x + swiglu(lin, h, mats["w_gate"], mats["w_up"],
                                       mats["w_down"]))
        del mats
    head = lin.w(w["lm_head"])
    fn = w["final_norm"].float()
    return [unembed(lin, x[p], fn, head, eps) for x, p in zip(xs, positions)]
