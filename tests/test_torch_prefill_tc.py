"""The bf16 tensor-core prefill kernel's arithmetic on the CPU.

``kernels/ref.py chunked_prefill_attention_split_p_ref`` computes prefill
attention with the kernel's rounding: an online softmax over 64-key tiles
and P fed to P·V as a bf16 hi + lo pair.  On bf16 inputs made from a seed
with numpy it is held against the reference package's Pallas kernel in
interpret mode (3e-2, the reference's bf16 tolerance) and within 2e-5 + 2
bf16 steps of the port's plain f32 version, the bound the card holds the
kernel to.  A single bf16 P is shown to break that bound.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref as tref

SWEEP = [
    # B, Sq, Skv, Hq, Hkv, D, window, softcap
    (1, 8, 8, 1, 1, 16, 0, 0.0),
    (2, 24, 40, 4, 2, 64, 0, 0.0),
    (2, 24, 40, 4, 2, 64, 16, 0.0),
    (2, 24, 40, 4, 2, 64, 0, 30.0),
    (1, 128, 128, 8, 8, 32, 0, 0.0),     # MHA
    (3, 17, 33, 6, 1, 64, 0, 0.0),       # MQA, ragged sizes
    (1, 256, 384, 2, 2, 128, 64, 50.0),  # gemma2-style local+softcap
    (2, 9, 40, 10, 2, 64, 0, 0.0),       # qwen-style group of 5
]


def _inputs(B, Sq, Skv, Hq, Hkv, D, window, seed):
    """bf16 q/k/v and per-row offsets/lengths.  With a window, lengths
    cover every query row (the reference's Pallas kernel and oracle
    disagree on rows with no visible key)."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, S, H, D).astype(np.float32)
               for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv)))
    off = rng.randint(0, Skv - Sq + 1, size=(B,)).astype(np.int32)
    lo = off + Sq if window else np.ones(B, np.int32)
    lens = np.array([rng.randint(a, Skv + 1) for a in lo], np.int32)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    return q, k, v, torch.from_numpy(off), torch.from_numpy(lens)


def _bound_share(out, want):
    """Largest |out - want| as a share of 2e-5 + 2 bf16 steps of |want|
    (tests/test_torch_gpu.py _within_bf16_steps)."""
    w = want.float()
    _, e = torch.frexp(w)
    bound = 2e-5 + 2 * torch.ldexp(torch.ones_like(w), e - 8)
    return ((out.float() - w).abs() / bound).max().item()


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,window,cap", SWEEP)
def test_split_p_matches_reference_and_plain(B, Sq, Skv, Hq, Hkv, D, window,
                                             cap):
    q, k, v, off, lens = _inputs(B, Sq, Skv, Hq, Hkv, D, window,
                                 seed=B * 100 + Sq)
    out = tref.chunked_prefill_attention_split_p_ref(
        q, k, v, off, lens, window=window, softcap=cap)
    assert out.dtype == torch.bfloat16
    want = jops.prefill_attention(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
        jnp.asarray(off.numpy()), jnp.asarray(lens.numpy()), window=window,
        softcap=cap)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=3e-2, rtol=3e-2)
    plain = tref.chunked_prefill_attention_ref(q, k, v, off, lens,
                                               window=window, softcap=cap)
    assert _bound_share(out, plain) <= 1


def test_split_p_main_path_like_shape():
    """A reduced main-path shape (Sq=256 into Skv=512, Hq=8, Hkv=2, D=128,
    a causal prompt at offset 0 over its own 256 keys)."""
    q, k, v, _, _ = _inputs(1, 256, 512, 8, 2, 128, 0, seed=256)
    off, lens = torch.tensor([0]), torch.tensor([256])
    out = tref.chunked_prefill_attention_split_p_ref(q, k, v, off, lens)
    plain = tref.chunked_prefill_attention_ref(q, k, v, off, lens)
    np.testing.assert_allclose(out.float().numpy(), plain.float().numpy(),
                               atol=3e-2, rtol=3e-2)
    assert _bound_share(out, plain) <= 1


def test_split_p_row_without_visible_key_is_the_mean_of_v():
    q, k, v, _, _ = _inputs(1, 40, 96, 8, 2, 64, 0, seed=19)
    off, lens = torch.tensor([15]), torch.tensor([20])
    out = tref.chunked_prefill_attention_split_p_ref(q, k, v, off, lens,
                                                     window=8)
    plain = tref.chunked_prefill_attention_ref(q, k, v, off, lens, window=8)
    assert _bound_share(out, plain) <= 1
    mean_v = v.float().mean(1)[0, 0]          # row 39 sees no key
    np.testing.assert_allclose(out[0, -1, 0].float().numpy(),
                               mean_v.bfloat16().float().numpy(), atol=1e-6)


def test_single_bf16_p_breaks_the_bound_that_hi_lo_keeps():
    """Why the kernel feeds P as bf16 hi + lo: rounding P to one bf16 errs
    by ~2^-9 |v| whatever the output's size, far past 2e-5 + 2 bf16 steps
    on outputs near zero; the hi + lo pair stays inside it (a causal
    512-token prompt, 8 heads, D=128)."""
    q, k, v, _, _ = _inputs(1, 512, 512, 8, 2, 128, 0, seed=0)
    off, lens = torch.tensor([0]), torch.tensor([512])
    plain = tref.chunked_prefill_attention_ref(q, k, v, off, lens)
    pair = tref.chunked_prefill_attention_split_p_ref(q, k, v, off, lens)
    single = tref.chunked_prefill_attention_split_p_ref(q, k, v, off, lens,
                                                        p_parts=1)
    assert _bound_share(pair, plain) <= 1
    assert _bound_share(single, plain) > 10
