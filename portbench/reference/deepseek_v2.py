"""Plain reference of the DeepSeek-V2 family (arXiv:2405.04434), as the
configuration file states it is run.

Multi-head latent attention without a query compression (q_lora_rank
null): q = h Wq split into a no-position part and a RoPE part; the
compressed latent c = RMSNorm((h W_dkv)[:rank]) and one RoPE key part
shared by all heads; keys and values are the latent projected up per
head (W_uk, W_uv); softmax scale (nope + rope)^-1/2.  RoPE is the
rotate-half form with no YaRN scaling: the file lists ``rope_scaling`` as
changed.  The first ``first_k_dense_replace`` layers have a dense SwiGLU
MLP; the rest route each token by a softmax over the experts to its top
k, with the k gates renormalised to sum to one (``norm_topk_prob``, listed
as changed), plus the shared experts as one SwiGLU MLP of n_shared times
the expert width.  Only the chosen experts are computed, token by token.
"""
from __future__ import annotations

import torch

from portbench.reference.common import (Lin, causal_attention, rmsnorm, rope,
                                        swiglu, unembed)

PORT_KEYS = {"d_model": "hidden_size", "num_layers": "num_hidden_layers",
             "num_heads": "num_attention_heads", "d_ff": "intermediate_size",
             "vocab_size": "vocab_size", "first_k_dense":
             "first_k_dense_replace", "kv_lora_rank": "kv_lora_rank",
             "qk_rope_dim": "qk_rope_head_dim",
             "qk_nope_dim": "qk_nope_head_dim", "v_head_dim": "v_head_dim",
             "rope_theta": "rope_theta", "moe.num_experts": "n_routed_experts",
             "moe.top_k": "num_experts_per_tok",
             "moe.num_shared": "n_shared_experts",
             "moe.d_ff_expert": "moe_intermediate_size"}


def dims(hf: dict) -> dict:
    if hf.get("q_lora_rank") is not None:
        raise ValueError("the reference has no query compression")
    if hf.get("scoring_func", "softmax") != "softmax" or \
            hf.get("routed_scaling_factor", 1) != 1:
        raise ValueError("the reference routes by softmax, unscaled")
    d = {k: hf[k] for k in PORT_KEYS.values()}
    d["rms_norm_eps"] = hf["rms_norm_eps"]
    d["norm_topk_prob"] = hf["norm_topk_prob"]
    return d


def leaves(d: dict) -> list:
    D, H, V = d["hidden_size"], d["num_attention_heads"], d["vocab_size"]
    nope, rp, vd, r = (d["qk_nope_head_dim"], d["qk_rope_head_dim"],
                       d["v_head_dim"], d["kv_lora_rank"])
    E, f, ns = (d["n_routed_experts"], d["moe_intermediate_size"],
                d["n_shared_experts"])
    out = [("embed", (V, D), "embed"), ("final_norm", (D,), "norm"),
           ("lm_head", (D, V), "in")]
    for i in range(d["num_hidden_layers"]):
        p = f"layers.{i}."
        # queries and keys at 1 / sqrt(fan-in), not "qk": with sharper
        # scores the bf16 program reads 1.5-2 logits off the reference on
        # every seed (routing flips; PERF.md), where Qwen reads 0.03-0.07
        out += [(p + "ln1", (D,), "norm"),
                (p + "wq", (D, H * (nope + rp)), "in"),
                (p + "w_dkv", (D, r + rp), "in"),
                (p + "kv_norm", (r,), "norm"),
                (p + "w_uk", (r, H * nope), "in"),
                (p + "w_uv", (r, H * vd), "in"),
                (p + "wo", (H * vd, D), "attn_out"), (p + "ln2", (D,), "norm")]
        if i < d["first_k_dense_replace"]:
            F = d["intermediate_size"]
            out += [(p + "w_gate", (D, F), "in"), (p + "w_up", (D, F), "in"),
                    (p + "w_down", (F, D), "out")]
        else:
            out += [(p + "router", (D, E), "in"),
                    (p + "we_gate", (E, D, f), "in"),
                    (p + "we_up", (E, D, f), "in"),
                    (p + "we_down", (E, f, D), "out"),
                    (p + "ws_gate", (D, ns * f), "in"),
                    (p + "ws_up", (D, ns * f), "in"),
                    (p + "ws_down", (ns * f, D), "out")]
    return out


def _mla(lin, d, m, x, eps, theta):
    S = x.shape[0]
    H, nope, rp, vd, r = (d["num_attention_heads"], d["qk_nope_head_dim"],
                          d["qk_rope_head_dim"], d["v_head_dim"],
                          d["kv_lora_rank"])
    pos = torch.arange(S, device=x.device)
    h = rmsnorm(x, m["ln1"], eps)
    q = lin(h, m["wq"]).view(S, H, nope + rp)
    ckr = lin(h, m["w_dkv"])
    c = lin.act(rmsnorm(ckr[:, :r], m["kv_norm"], eps))    # the cache
    k_rope = lin.act(rope(ckr[:, None, r:], pos, theta))   # (S, 1, rope)
    k_nope = lin(c, m["w_uk"]).view(S, H, nope)
    v = lin(c, m["w_uv"]).view(S, H, vd)
    qf = torch.cat([q[..., :nope], rope(q[..., nope:], pos, theta)], -1)
    kf = torch.cat([k_nope, k_rope.expand(S, H, rp)], -1)
    o = causal_attention(qf, kf, v, (nope + rp) ** -0.5)
    return lin(o.reshape(S, H * vd), m["wo"])


def _moe(lin, d, m, h):
    k = d["num_experts_per_tok"]
    probs = torch.softmax(lin(h, m["router"]), -1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    if d["norm_topk_prob"]:
        top_p = top_p / top_p.sum(-1, keepdim=True)
    y = swiglu(lin, h, m["ws_gate"], m["ws_up"], m["ws_down"])
    for e in torch.unique(top_i).tolist():
        tok, slot = torch.nonzero(top_i == e, as_tuple=True)
        ye = swiglu(lin, h[tok], m["we_gate"][e], m["we_up"][e],
                    m["we_down"][e])
        y.index_add_(0, tok, ye * top_p[tok, slot, None])
    return y


@torch.no_grad()
def logits(d: dict, w: dict, seqs: list, positions: list, quant=None):
    """Float32 logits of each sequence at its `positions`, layer by layer
    over all of them."""
    lin = Lin(quant)
    eps, theta = d["rms_norm_eps"], d["rope_theta"]
    xs = [lin.act(w["embed"][s].float()) for s in seqs]
    for i in range(d["num_hidden_layers"]):
        p = f"layers.{i}."
        names = [n[len(p):] for n in w if n.startswith(p)]
        m = {n: (w[p + n].float() if w[p + n].dim() == 1 else lin.w(w[p + n]))
             for n in names}
        for j, x in enumerate(xs):
            x = lin.act(x + _mla(lin, d, m, x, eps, theta))
            h = rmsnorm(x, m["ln2"], eps)
            if i < d["first_k_dense_replace"]:
                y = swiglu(lin, h, m["w_gate"], m["w_up"], m["w_down"])
            else:
                y = _moe(lin, d, m, h)
            xs[j] = lin.act(x + y)
        del m
    head = lin.w(w["lm_head"])
    fn = w["final_norm"].float()
    return [unembed(lin, x[p], fn, head, eps) for x, p in zip(xs, positions)]
