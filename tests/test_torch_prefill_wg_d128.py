"""The arithmetic of the bf16 prefill kernel at head dims 16 to 128 on the
CPU, and which kernel each head dim runs.

``csrc/prefill_wg.cuh`` (wgmma, TMA, a warp-specialised producer) runs
every bf16 prefill: Llama-3.1-8B's and Qwen-2.5-32B's heads at 128, Kimi
K2's at 112, Qwen2-0.5B's and MusicGen-large's at 64, and the test widths
16 and 32; at 16, 32 and 112 its rows are padded in shared memory to whole
64-column blocks by the TMA map's zero fill.  It runs the online softmax
over tiles of ``ref.PREFILL_TILE_KEYS`` keys and P enters P V as a bf16
hi + lo pair; ``ref.chunked_prefill_attention_split_p_ref`` computes that
on the CPU.  On bf16 inputs made from a seed with numpy it is held against
the reference package's Pallas kernel in interpret mode (3e-2, the
reference's bf16 tolerance) and within 2e-5 + 2 bf16 steps of the port's
plain f32 version, the bound the card holds the kernel to.  The kernel
itself, with NaN in the keys no row sees, runs in tests/test_torch_gpu.py.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
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
    """{head dim: the bf16 launch function} of dispatch_d's cases."""
    text = (CSRC / "chunked_prefill_attention.cu").read_text()
    body = text[text.index("int dispatch_d("):]
    bf16 = re.search(r"return BF16 \? (launch_\w+)<DD>", body).group(1)
    return {int(d): bf16
            for d in re.findall(r"REPRO_PREFILL_CASE\((\d+)\)", body)}


def test_dispatch_routes_bf16_head_dims():
    """bf16 at every head dim the wrappers take launches prefill_wg_kernel
    (launch_wg): the mma.sync kernel that ran D = 16, 32 and 112 is gone."""
    assert _dispatch() == {D: "launch_wg" for D in tops.HEAD_DIMS}
    text = (CSRC / "chunked_prefill_attention.cu").read_text()
    assert "launch_tc" not in text and "prefill_tc_kernel" not in text


def test_the_tile_is_one_constant_at_every_head_dim():
    """split_p_ref models every bf16 head dim with one tile of
    ref.PREFILL_TILE_KEYS keys, so the bf16 kernel's tile is declared once,
    as a plain constant of that value: neither a template over D nor
    specialised for one."""
    decls = re.findall(r"((?:template\s*<[^>]*>\s*)?constexpr int "
                       r"kWgBN\b[^;]*;)", (CSRC / "prefill_wg.cuh").read_text())
    assert decls == [f"constexpr int kWgBN = {tref.PREFILL_TILE_KEYS};"]


def _wg_layout(D):
    """prefill_wg.cuh's WgLayout<D>, its constants evaluated in order as
    the compiler does (integer arithmetic), and the kernel's head-dim
    static_assert at D."""
    text = (CSRC / "prefill_wg.cuh").read_text()
    env = {name: int(v) for name, v in re.findall(
        r"constexpr int (kWg\w+) = (\d+);", text)}
    env["D"] = D
    body = text[text.index("struct WgLayout {"):]
    body = body[:body.index("};")]
    for name, expr in re.findall(r"static constexpr int (k\w+) = ([^;]+);",
                                 body):
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))
    cond = re.search(r"static_assert\(([^,]+),", text).group(1)
    env["admitted"] = eval(cond.replace("&&", "and").replace("||", "or")
                           .replace("/", "//"), {}, dict(env))
    return env


@pytest.mark.parametrize("D", tops.HEAD_DIMS)
def test_the_kernel_admits_every_head_dim(D):
    """The bf16 kernel's static_assert admits each head dim the wrappers
    take, and WgLayout<D> holds whole 64-column swizzle blocks (D rounded
    up: 128 at D = 112, 64 at 16 and 32) in one block's shared memory
    (227 KB on an H100), a TMA box's worth of 64 keys a K or V tile."""
    L = _wg_layout(D)
    assert L["admitted"]
    assert L["kDP"] % 64 == 0 and D <= L["kDP"] < D + 64
    assert L["kTile"] == L["kDP"] * 2 * L["kWgBN"]
    assert L["kBytes"] <= 232448
    assert L["kBytes"] == _wg_layout(L["kDP"])["kBytes"]


@pytest.mark.parametrize("D", [16, 32, 64, 112, 128])
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


@pytest.mark.parametrize("D", [16, 32, 64, 112, 128])
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
