"""The arithmetic of the bf16 prefill kernel at head dims 64 and 128 on the
CPU, and which kernel each head dim runs.

``csrc/prefill_wg.cuh`` (wgmma, TMA, a warp-specialised producer) runs
every bf16 prefill at D = 64, 128 and 256: Llama-3.1-8B's and Qwen-2.5-32B's
heads at 128, Qwen2-0.5B's and MusicGen-large's at 64.
``csrc/chunked_prefill_attention.cu``'s ``prefill_tc_kernel`` (mma.sync)
keeps D = 16, 32 and 112.  Both run the online softmax over tiles of
``ref.PREFILL_TILE_KEYS`` keys and P enters P V as a bf16 hi + lo pair;
``ref.chunked_prefill_attention_split_p_ref`` computes that on the CPU.  On
bf16 inputs made from a seed with numpy it is held against the reference
package's Pallas kernel in interpret mode (3e-2, the reference's bf16
tolerance) and within 2e-5 + 2 bf16 steps of the port's plain f32 version,
the bound the card holds the kernel to.  The kernel itself, with NaN in
the keys no row sees, runs in tests/test_torch_gpu.py.
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
    "llama-32-over-8": (1, 40, 40, 32, 8, 0, 0.0, [0], [40]),
    "qwen-40-over-8-chunk": (1, 24, 96, 40, 8, 0, 0.0, [50], [74]),
    "mqa-6-over-1": (2, 20, 96, 6, 1, 0, 0.0, [0, 60], [20, 80]),
    "window-64-softcap-50": (1, 256, 384, 2, 2, 64, 50.0, [100], [384]),
    "ragged-chunks": (2, 24, 160, 16, 2, 0, 0.0, [70, 10], [94, 30]),
}


def _inputs(B, Sq, Skv, Hq, Hkv, D, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32))
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


def _dispatch():
    """{head dim: the launch function} of dispatch_d's bf16 cases."""
    text = (CSRC / "chunked_prefill_attention.cu").read_text()
    body = text[text.index("int dispatch_d("):]
    return {int(d): fn for d, fn in
            re.findall(r"REPRO_PREFILL_CASE\((\d+), (launch_\w+)\)", body)}


def test_dispatch_routes_bf16_head_dims():
    """bf16 at D = 64, 128 and 256 launches prefill_wg_kernel (launch_wg);
    D = 16, 32 and 112 keep prefill_tc_kernel (launch_tc)."""
    assert _dispatch() == {16: "launch_tc", 32: "launch_tc", 64: "launch_wg",
                           112: "launch_tc", 128: "launch_wg",
                           256: "launch_wg"}


def test_the_tile_is_one_constant_at_every_head_dim():
    """split_p_ref models every bf16 head dim with one tile of
    ref.PREFILL_TILE_KEYS keys, so each kernel's tile is declared once, as
    a plain constant of that value: neither a template over D nor
    specialised for one."""
    for name, const in (("prefill_wg.cuh", "kWgBN"),
                        ("chunked_prefill_attention.cu", "kBK")):
        decls = re.findall(rf"((?:template\s*<[^>]*>\s*)?constexpr int "
                           rf"{const}\b[^;]*;)", (CSRC / name).read_text())
        assert decls == [f"constexpr int {const} = "
                         f"{tref.PREFILL_TILE_KEYS};"], (name, decls)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case", list(CASES))
def test_split_p_matches_pallas_and_plain(case, D):
    B, Sq, Skv, Hq, Hkv, window, cap, offs, lens = CASES[case]
    q, k, v = _inputs(B, Sq, Skv, Hq, Hkv, D, seed=Sq * 1000 + Skv + D)
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


@pytest.mark.parametrize("D", [64, 128])
def test_split_p_row_without_visible_key(D):
    """Rows 12.. of a window-8 layer past lengths see no key: the mean of v
    over all Skv keys, as the plain version's softmax gives."""
    q, k, v = _inputs(1, 40, 96, 8, 2, D, seed=29 + D)
    off, ln = torch.tensor([15]), torch.tensor([20])
    out = tref.chunked_prefill_attention_split_p_ref(q, k, v, off, ln,
                                                     window=8)
    plain = tref.chunked_prefill_attention_ref(q, k, v, off, ln, window=8)
    assert _bound_share(out, plain) <= 1
    mean_v = v.float().mean(1)[0]                      # (Hkv, D)
    for h in range(8):                                 # q head h, kv h // 4
        np.testing.assert_allclose(
            out[0, 12:, h].float().numpy(),
            np.broadcast_to(mean_v[h // 4].bfloat16().float().numpy(),
                            (28, D)), atol=1e-6)
