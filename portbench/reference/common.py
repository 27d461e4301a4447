"""Plain float32 pieces shared by the references: RMSNorm, rotate-half
RoPE, causal softmax attention, and the matrix product with its float8
control."""
from __future__ import annotations

import torch

FP8_MAX = 448.0            # the largest finite float8 e4m3 value
Q_BLOCK = 1024             # query rows a block in attention


def no_tf32():
    """Float32 products in float32 (TF32 is the control's precision for
    float32, not the reference's)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fake_fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """`t` rounded to float8 e4m3 with one scale per slice along `dim`
    (absmax / 448), back in float32."""
    s = t.abs().amax(dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


class Lin:
    """x @ w in float32; with quant="fp8" from float8 x (a scale a row) and
    float8 w (a scale an output column), and every activation the program
    holds in bf16 (``act``) rounded to float8 as well."""

    def __init__(self, quant):
        self.quant = quant

    def w(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        return fake_fp8(t, -2) if self.quant else t

    def __call__(self, x, w):
        return self.act(x) @ w

    def act(self, x):
        """An activation the program keeps in its own precision (a matrix
        product's input, the residual stream, the cache): with quant, in
        float8 with a scale a row."""
        return fake_fp8(x, -1) if self.quant else x


def rmsnorm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """x (S, H, D): rotate-half RoPE over the last dim at positions
    `pos` (S,)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def causal_attention(q, k, v, scale):
    """q (S, Hq, D), k (S, Hkv, D), v (S, Hkv, Dv): query head h reads kv
    head h // (Hq / Hkv).  Softmax over the keys at or before each
    query's position."""
    S, Hq, _ = q.shape
    G = Hq // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    out = torch.empty((S, Hq, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for s0 in range(0, S, Q_BLOCK):
        s1 = min(s0 + Q_BLOCK, S)
        sc = torch.einsum("nhd,lhd->hnl", q[s0:s1], k[:s1]) * scale
        keep = (torch.arange(s1, device=q.device)[None, :]
                <= torch.arange(s0, s1, device=q.device)[:, None])
        sc = sc.masked_fill(~keep, float("-inf"))
        out[s0:s1] = torch.einsum("hnl,lhd->nhd", torch.softmax(sc, -1),
                                  v[:s1])
    return out


def swiglu(lin, h, w_gate, w_up, w_down):
    return lin(torch.nn.functional.silu(lin(h, w_gate)) * lin(h, w_up),
               w_down)


def unembed(lin, x, final_norm, lm_head, eps):
    return lin(rmsnorm(x, final_norm, eps), lm_head)
