"""The arithmetic of the bf16 prefill kernel at head dim 256 on the CPU.

``csrc/prefill_wg.cuh`` (wgmma, TMA, a warp-specialised producer) runs
every bf16 prefill at D = 256: Gemma-2-9B's heads (16 / 8, G = 2) and
Gemma-2B's (8 / 1, G = 8).  Its online softmax runs over tiles of
``ref.PREFILL_TILE_KEYS`` keys, as it does at D <= 128, and P enters
P V as a bf16 hi + lo pair; ``ref.chunked_prefill_attention_split_p_ref``
computes that on the CPU.  On bf16 inputs made from a seed with numpy it is
held against the reference package's Pallas kernel in interpret mode
(3e-2, the reference's bf16 tolerance) and within 2e-5 + 2 bf16 steps of
the port's plain f32 version, the bound the card holds the kernel to.  The
kernel itself, with NaN in the keys no row sees, runs in
tests/test_torch_gpu.py.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref as tref

CSRC = Path(tref.__file__).parent / "csrc"

CASES = {
    # id: (B, Sq, Skv, Hq, Hkv, window, softcap, offsets, lengths); with a
    # window, lengths reach every query row (the reference's Pallas kernel
    # and oracle disagree on rows with no visible key)
    "gemma2-9b-prompt": (1, 48, 48, 16, 8, 0, 50.0, [0], [48]),
    "gemma2-9b-window-bites": (1, 40, 160, 16, 8, 64, 50.0, [100], [140]),
    "gemma2-9b-chunks-ragged": (2, 24, 128, 16, 8, 0, 50.0, [70, 10],
                                [94, 30]),
    "gemma-2b-mqa": (2, 20, 96, 8, 1, 0, 0.0, [0, 60], [20, 80]),
    "gemma-2b-mqa-window": (1, 33, 130, 8, 1, 16, 50.0, [90], [123]),
}


def _inputs(B, Sq, Skv, Hq, Hkv, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(B, S, H, 256).astype(np.float32))
               .bfloat16()
               for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv)))
    return q, k, v


def _bound_share(out, want):
    """Largest |out - want| as a share of 2e-5 + 2 bf16 steps of |want|
    (tests/test_torch_gpu.py _within_bf16_steps)."""
    w = want.float()
    _, e = torch.frexp(w)
    bound = 2e-5 + 2 * torch.ldexp(torch.ones_like(w), e - 8)
    return ((out.float() - w).abs() / bound).max().item()


def test_the_reference_tile_is_both_kernels():
    """The keys a tile of split_p_ref's online softmax: prefill_wg.cuh's
    kWgBN, the tile of the bf16 prefill kernel at D = 256 and at D <= 128
    alike; chunked_prefill_attention.cu includes that kernel and holds no
    bf16 kernel (no tile) of its own."""
    wg = (CSRC / "prefill_wg.cuh").read_text()
    got = re.search(r"constexpr int kWgBN = (\d+);", wg)
    assert got and int(got.group(1)) == tref.PREFILL_TILE_KEYS
    cu = (CSRC / "chunked_prefill_attention.cu").read_text()
    assert '#include "prefill_wg.cuh"' in cu
    assert "bfloat16" not in cu


@pytest.mark.parametrize("case", list(CASES))
def test_split_p_d256_matches_pallas_and_plain(case):
    B, Sq, Skv, Hq, Hkv, window, cap, offs, lens = CASES[case]
    q, k, v = _inputs(B, Sq, Skv, Hq, Hkv, seed=Sq * 1000 + Skv)
    off, ln = torch.tensor(offs), torch.tensor(lens)
    out = tref.chunked_prefill_attention_split_p_ref(
        q, k, v, off, ln, window=window, softcap=cap)
    assert out.dtype == torch.bfloat16
    want = jops.prefill_attention(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
        jnp.asarray(off.numpy(), jnp.int32), jnp.asarray(ln.numpy(),
                                                         jnp.int32),
        window=window, softcap=cap)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=3e-2, rtol=3e-2)
    plain = tref.chunked_prefill_attention_ref(q, k, v, off, ln,
                                               window=window, softcap=cap)
    assert _bound_share(out, plain) <= 1


def test_split_p_d256_row_without_visible_key():
    """Rows 12.. of a window-8 layer past lengths see no key: the mean of v
    over all Skv keys, as the plain version's softmax gives."""
    q, k, v = _inputs(1, 40, 96, 16, 8, seed=23)
    off, ln = torch.tensor([15]), torch.tensor([20])
    out = tref.chunked_prefill_attention_split_p_ref(q, k, v, off, ln,
                                                     window=8, softcap=50.0)
    plain = tref.chunked_prefill_attention_ref(q, k, v, off, ln, window=8,
                                               softcap=50.0)
    assert _bound_share(out, plain) <= 1
    mean_v = v.float().mean(1)[0]                      # (Hkv, D)
    for h in range(16):                                # q head h, kv h // 2
        np.testing.assert_allclose(
            out[0, 12:, h].float().numpy(),
            np.broadcast_to(mean_v[h // 2].bfloat16().float().numpy(),
                            (28, 256)), atol=1e-6)


def test_single_bf16_p_breaks_the_bound_at_d256():
    """Why P enters P V as bf16 hi + lo at D = 256 too: a single bf16 P
    fails 2e-5 + 2 bf16 steps on a causal 256-token prompt with Gemma-2's
    softcap, the pair keeps it."""
    q, k, v = _inputs(1, 256, 256, 4, 2, seed=0)
    off, ln = torch.tensor([0]), torch.tensor([256])
    plain = tref.chunked_prefill_attention_ref(q, k, v, off, ln, softcap=50.0)
    pair = tref.chunked_prefill_attention_split_p_ref(q, k, v, off, ln,
                                                      softcap=50.0)
    single = tref.chunked_prefill_attention_split_p_ref(
        q, k, v, off, ln, softcap=50.0, p_parts=1)
    assert _bound_share(pair, plain) <= 1
    assert _bound_share(single, plain) > 10
