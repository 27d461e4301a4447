"""The Hopper kernels on the card, against their plain PyTorch versions.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips when no
CUDA device is present (decided when the test runs, never at import).
On a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are the reference's: 2e-5 in f32, 3e-2 in bf16, 2e-4 for
WKV6 (f32 only); at the main-path shapes bf16 attention is also held to
2e-5 + 2 bf16 steps of the plain value.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref

pytestmark = pytest.mark.gpu

SWEEP = [
    # B, Sq, Skv, Hq, Hkv, D, window, softcap
    (1, 8, 8, 1, 1, 16, 0, 0.0),
    (2, 24, 40, 4, 2, 64, 0, 0.0),
    (2, 24, 40, 4, 2, 64, 16, 0.0),
    (2, 24, 40, 4, 2, 64, 0, 30.0),
    (1, 128, 128, 8, 8, 32, 0, 0.0),
    (3, 17, 33, 6, 1, 64, 0, 0.0),
    (1, 256, 384, 2, 2, 128, 64, 50.0),
    (2, 9, 40, 10, 2, 64, 0, 0.0),
    (1, 1, 2048, 32, 8, 128, 0, 0.0),
]
DECODE_SWEEP = [
    # B, L, Hq, Hkv, D, window, softcap
    (1, 16, 1, 1, 16, 0, 0.0),
    (2, 64, 8, 2, 64, 0, 0.0),
    (2, 64, 8, 2, 64, 16, 0.0),
    (2, 64, 8, 2, 64, 0, 30.0),
    (4, 129, 4, 1, 128, 0, 0.0),
    (1, 512, 16, 16, 64, 0, 0.0),
    (3, 96, 10, 2, 128, 0, 50.0),
    (3, 192, 8, 2, 32, 20, 0.0),         # a window inside one split
    (2, 256, 8, 2, 32, 100, 0.0),        # a window across splits
    (1, 8192, 32, 8, 128, 0, 0.0),       # one long request: 64 splits
]
# Explicit cur_lens against the splits the wrapper picks (64 positions at
# these shapes): the same cases as tests/test_torch_split_decode.py.
DECODE_SPLIT_CASES = {
    # id: (L, Hq, Hkv, D, window, softcap, cur_lens)
    "boundary-at-cur-1-cur-cur+1": (192, 8, 2, 32, 0, 0.0, [129, 128, 127]),
    "cur-0": (128, 4, 1, 16, 0, 0.0, [0, 0]),
    "window-inside-one-split": (256, 8, 2, 32, 20, 0.0, [100, 250]),
    "window-spans-two-splits": (256, 8, 2, 32, 50, 0.0, [150, 140]),
    "window-boundary-at-start": (256, 4, 2, 16, 37, 0.0, [164, 127]),
    "no-visible-key": (128, 4, 2, 16, 16, 0.0, [127, 143]),
    "L-not-a-multiple": (150, 8, 2, 64, 0, 0.0, [149, 70, 128]),
    "single-split": (48, 4, 2, 32, 0, 30.0, [47, 12]),
    "group-of-5-qwen": (160, 40, 8, 16, 0, 0.0, [159, 64, 3]),
    "group-of-12": (256, 24, 2, 64, 0, 0.0, [255, 100]),
    "softcap-window-many": (512, 8, 2, 32, 100, 50.0, [511, 300, 10]),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, dtype=torch.float32, device="cuda"):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def _close(out, want, tol):
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


def _within_bf16_steps(out, want, steps=2):
    """At the main-path shapes a typical output is ~0.04, as large as the
    3e-2 tolerance.  Both sides round an f32 result to bf16: they may differ
    by the f32 tolerance (order of the f32 arithmetic) plus one step of the
    larger binade, so 2e-5 + 2 steps of |want|'s."""
    torch.cuda.synchronize()
    w = want.float()
    _, e = torch.frexp(w)
    bound = 2e-5 + steps * torch.ldexp(torch.ones_like(w), e - 8)
    share = ((out.float() - w).abs() / bound).max().item()
    assert share <= 1, f"{share} of the bound"


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,window,cap", SWEEP)
def test_prefill_kernel_f32(cuda, B, Sq, Skv, Hq, Hkv, D, window, cap):
    g = torch.Generator(device=cuda).manual_seed(B * 100 + Sq)
    q = _randn(g, B, Sq, Hq, D)
    k, v = _randn(g, B, Skv, Hkv, D), _randn(g, B, Skv, Hkv, D)
    off = torch.randint(0, Skv - Sq + 1, (B,), generator=g, device=cuda)
    lens = torch.randint(1, Skv + 1, (B,), generator=g, device=cuda)
    out = kops.prefill_attention(q, k, v, off, lens, window=window,
                                 softcap=cap)
    want = ref.chunked_prefill_attention_ref(q, k, v, off, lens,
                                             window=window, softcap=cap)
    _close(out, want, 2e-5)


MAIN_PATH_PREFILL = [(512, 0, 512), (256, 768, 1024), (2048, 0, 1500)]


def _main_path_prefill(cuda, Sq, off, lens, dtype):
    g = torch.Generator(device=cuda).manual_seed(Sq)
    q = _randn(g, 1, Sq, 32, 128, dtype=dtype)
    k = _randn(g, 1, 2048, 8, 128, dtype=dtype)
    v = _randn(g, 1, 2048, 8, 128, dtype=dtype)
    o = torch.tensor([off], device=cuda)
    n = torch.tensor([lens], device=cuda)
    return (kops.prefill_attention(q, k, v, o, n),
            ref.chunked_prefill_attention_ref(q, k, v, o, n))


@pytest.mark.parametrize("Sq,off,lens", MAIN_PATH_PREFILL)
def test_prefill_kernel_bf16_main_path(cuda, Sq, off, lens):
    """Llama-3.1-8B heads in bf16: a whole prompt, a convertible chunk, a
    burst prompt padded to the cache length."""
    out, want = _main_path_prefill(cuda, Sq, off, lens, torch.bfloat16)
    _close(out, want, 3e-2)
    _within_bf16_steps(out, want)


@pytest.mark.parametrize("Sq,off,lens", MAIN_PATH_PREFILL)
def test_prefill_kernel_f32_main_path(cuda, Sq, off, lens):
    out, want = _main_path_prefill(cuda, Sq, off, lens, torch.float32)
    _close(out, want, 2e-5)


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,window,cap", SWEEP)
def test_prefill_kernel_bf16_sweep(cuda, B, Sq, Skv, Hq, Hkv, D, window, cap):
    """The tensor-core path on every head dim, window, softcap and group
    size: against the plain version (3e-2, and 2e-5 + 2 bf16 steps) and
    against the plain version with the kernel's rounding (split P)."""
    g = torch.Generator(device=cuda).manual_seed(B * 100 + Sq + 7)
    q = _randn(g, B, Sq, Hq, D, dtype=torch.bfloat16)
    k = _randn(g, B, Skv, Hkv, D, dtype=torch.bfloat16)
    v = _randn(g, B, Skv, Hkv, D, dtype=torch.bfloat16)
    off = torch.randint(0, Skv - Sq + 1, (B,), generator=g, device=cuda)
    lens = torch.randint(1, Skv + 1, (B,), generator=g, device=cuda)
    out = kops.prefill_attention(q, k, v, off, lens, window=window,
                                 softcap=cap)
    for want in (ref.chunked_prefill_attention_ref(
                     q, k, v, off, lens, window=window, softcap=cap),
                 ref.chunked_prefill_attention_split_p_ref(
                     q, k, v, off, lens, window=window, softcap=cap)):
        _close(out, want, 3e-2)
        _within_bf16_steps(out, want)


@pytest.mark.parametrize("Sq,off,lens", MAIN_PATH_PREFILL)
def test_prefill_kernel_bf16_main_path_split_p(cuda, Sq, off, lens):
    """The main-path cases against the plain version with the kernel's own
    rounding (64-key tiles, P as bf16 hi + lo)."""
    g = torch.Generator(device=cuda).manual_seed(Sq)
    q = _randn(g, 1, Sq, 32, 128, dtype=torch.bfloat16)
    k = _randn(g, 1, 2048, 8, 128, dtype=torch.bfloat16)
    v = _randn(g, 1, 2048, 8, 128, dtype=torch.bfloat16)
    o = torch.tensor([off], device=cuda)
    n = torch.tensor([lens], device=cuda)
    out = kops.prefill_attention(q, k, v, o, n)
    want = ref.chunked_prefill_attention_split_p_ref(q, k, v, o, n)
    _close(out, want, 3e-2)
    _within_bf16_steps(out, want)
    again = kops.prefill_attention(q, k, v, o, n)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prefill_kernel_row_without_visible_key_both_paths(cuda, dtype):
    """A windowed row past every valid key gets the mean of v over Skv, on
    the tensor-core (bf16) and the CUDA-core (f32) path alike."""
    g = torch.Generator(device=cuda).manual_seed(19)
    q = _randn(g, 1, 40, 8, 64, dtype=dtype)
    k = _randn(g, 1, 96, 2, 64, dtype=dtype)
    v = _randn(g, 1, 96, 2, 64, dtype=dtype)
    o, n = torch.tensor([15], device=cuda), torch.tensor([20], device=cuda)
    out = kops.prefill_attention(q, k, v, o, n, window=8)
    want = ref.chunked_prefill_attention_ref(q, k, v, o, n, window=8)
    if dtype == torch.bfloat16:
        _close(out, want, 3e-2)
        _within_bf16_steps(out, want)
    else:
        _close(out, want, 2e-5)


def test_prefill_kernel_row_without_visible_key(cuda):
    g = torch.Generator(device=cuda).manual_seed(9)
    q = _randn(g, 1, 8, 2, 16)
    k, v = _randn(g, 1, 24, 1, 16), _randn(g, 1, 24, 1, 16)
    o, n = torch.tensor([12], device=cuda), torch.tensor([3], device=cuda)
    _close(kops.prefill_attention(q, k, v, o, n, window=4),
           ref.chunked_prefill_attention_ref(q, k, v, o, n, window=4), 2e-5)


@pytest.mark.parametrize("B,L,Hq,Hkv,D,window,cap", DECODE_SWEEP)
def test_decode_kernel_f32(cuda, B, L, Hq, Hkv, D, window, cap):
    g = torch.Generator(device=cuda).manual_seed(B * 1000 + L)
    q = _randn(g, B, Hq, D)
    k, v = _randn(g, B, L, Hkv, D), _randn(g, B, L, Hkv, D)
    cur = torch.randint(0, L, (B,), generator=g, device=cuda)
    cur[0] = 0
    _close(kops.decode_attention_op(q, k, v, cur, window=window, softcap=cap),
           ref.decode_attention_ref(q, k, v, cur, window=window, softcap=cap),
           2e-5)


@pytest.mark.parametrize("case", list(DECODE_SPLIT_CASES))
def test_decode_kernel_split_cases(cuda, case):
    """Split boundaries at cur - 1, cur and cur + 1, windows that start
    inside a split or span two, cur = 0, a ragged last split, one split,
    groups of 5 and 12: the kernel against the plain version and the plain
    split-and-merge version, and bit-equal to itself."""
    L, Hq, Hkv, D, window, cap, curs = DECODE_SPLIT_CASES[case]
    B = len(curs)
    g = torch.Generator(device=cuda).manual_seed(L + Hq)
    q = _randn(g, B, Hq, D)
    k, v = _randn(g, B, L, Hkv, D), _randn(g, B, L, Hkv, D)
    cur = torch.tensor(curs, dtype=torch.int32, device=cuda)
    out = kops.decode_attention_op(q, k, v, cur, window=window, softcap=cap)
    split, _ = kops.decode_split(L, B, Hkv, D)
    _close(out, ref.decode_attention_ref(q, k, v, cur, window=window,
                                         softcap=cap), 2e-5)
    _close(out, ref.decode_attention_split_ref(q, k, v, cur, split,
                                               window=window, softcap=cap),
           2e-5)
    again = kops.decode_attention_op(q, k, v, cur, window=window,
                                     softcap=cap)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


# One slice of a cache split over its positions (decode_attention_partial):
# the whole cache's length, the number of slices, heads and cur_lens.
PARTIAL_CASES = {
    # id: (L, n, Hq, Hkv, D, window, softcap, cur_lens)
    "window-starts-mid-slice": (256, 4, 8, 2, 64, 100, 0.0, [200, 130, 70]),
    "cur-on-a-slice-boundary": (256, 4, 8, 2, 32, 0, 0.0,
                                [63, 64, 127, 128]),
    "rows-with-no-live-key": (256, 4, 8, 2, 32, 16, 0.0, [10, 300]),
    "llama-heads": (4096, 4, 32, 8, 128, 0, 0.0, [4095, 1500, 700, 0]),
    "qwen-heads-g5": (2048, 4, 40, 8, 128, 0, 0.0, [2047, 1000]),
    "gemma-d256-window-softcap": (8192, 4, 16, 8, 256, 4096, 50.0,
                                  [8191, 5000, 3000, 100]),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(PARTIAL_CASES))
def test_decode_partial_kernel(cuda, case, dtype):
    """Each slice's (o, lse) against the plain version within 2e-5 (o and
    lse are f32 for both input types; -inf exactly where the plain version
    has it), bit-equal to itself; the slices merged against the plain
    one-pass decode on the same values in f32."""
    L, n, Hq, Hkv, D, window, cap, curs = PARTIAL_CASES[case]
    B = len(curs)
    g = torch.Generator(device=cuda).manual_seed(L + Hq + D)
    q = _randn(g, B, Hq, D, dtype=dtype)
    k = _randn(g, B, L, Hkv, D, dtype=dtype)
    v = _randn(g, B, L, Hkv, D, dtype=dtype)
    cur = torch.tensor(curs, dtype=torch.int32, device=cuda)
    per = L // n
    os_, lses = [], []
    for i in range(n):
        ks = k[:, i * per:(i + 1) * per].contiguous()
        vs = v[:, i * per:(i + 1) * per].contiguous()
        o, lse = kops.decode_attention_partial(q, ks, vs, cur, i * per,
                                               window=window, softcap=cap)
        wo, wl = ref.decode_attention_partial_ref(q, ks, vs, cur, i * per,
                                                  window=window, softcap=cap)
        assert o.dtype == lse.dtype == torch.float32
        _close(o, wo, 2e-5)
        torch.testing.assert_close(torch.isneginf(lse), torch.isneginf(wl))
        live = torch.isfinite(wl)
        _close(lse[live], wl[live], 2e-5)
        again = kops.decode_attention_partial(q, ks, vs, cur, i * per,
                                              window=window, softcap=cap)
        torch.cuda.synchronize()
        assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
        os_.append(o)
        lses.append(lse)
    merged = ref.merge_decode_partials(torch.stack(os_), torch.stack(lses))
    assert not torch.isnan(merged).any()
    _close(merged, ref.decode_attention_ref(q.float(), k.float(), v.float(),
                                            cur, window=window, softcap=cap),
           2e-5)


def _main_path_decode(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(4)
    q = _randn(g, 4, 32, 128, dtype=dtype)
    k = _randn(g, 4, 2048, 8, 128, dtype=dtype)
    v = _randn(g, 4, 2048, 8, 128, dtype=dtype)
    cur = torch.tensor([0, 700, 1500, 2047], device=cuda)
    return (kops.decode_attention_op(q, k, v, cur),
            ref.decode_attention_ref(q, k, v, cur))


def test_decode_kernel_bf16_main_path(cuda):
    out, want = _main_path_decode(cuda, torch.bfloat16)
    _close(out, want, 3e-2)
    _within_bf16_steps(out, want)


def test_decode_kernel_f32_main_path(cuda):
    out, want = _main_path_decode(cuda, torch.float32)
    _close(out, want, 2e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernel_main_path_split_and_deterministic(cuda, dtype):
    """The main-path shape runs 16 splits and the combine pass: it matches
    the plain split-and-merge version, and two calls are bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q = _randn(g, 4, 32, 128, dtype=dtype)
    k = _randn(g, 4, 2048, 8, 128, dtype=dtype)
    v = _randn(g, 4, 2048, 8, 128, dtype=dtype)
    cur = torch.tensor([0, 700, 1500, 2047], device=cuda)
    split, nsplit = kops.decode_split(2048, 4, 8, 128)
    assert nsplit > 1
    out = kops.decode_attention_op(q, k, v, cur)
    want = ref.decode_attention_split_ref(q, k, v, cur, split)
    if dtype == torch.bfloat16:
        _close(out, want, 3e-2)
        _within_bf16_steps(out, want)
    else:
        _close(out, want, 2e-5)
    again = kops.decode_attention_op(q, k, v, cur)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


@pytest.mark.parametrize("G,D", [(1, 64), (2, 256), (4, 128), (5, 128),
                                 (7, 64), (8, 256), (12, 128), (16, 256),
                                 (20, 64)])
def test_decode_kernel_bf16_groups(cuda, G, D):
    """The bf16 tensor-core kernel at every group of the zoo and past it
    (one n-tile of 8 heads, two, Q^T from shared memory at D = 256, a
    group over two blocks), with a window and softcap: against the plain
    version, its own arithmetic (decode_attention_split_p_ref) and bit-equal
    to itself."""
    g = torch.Generator(device=cuda).manual_seed(10 * G + D)
    Hkv, L = 2, 640
    q = _randn(g, 3, G * Hkv, D, dtype=torch.bfloat16)
    k = _randn(g, 3, L, Hkv, D, dtype=torch.bfloat16)
    v = _randn(g, 3, L, Hkv, D, dtype=torch.bfloat16)
    cur = torch.tensor([639, 128, 15], device=cuda)
    out = kops.decode_attention_op(q, k, v, cur, window=300, softcap=30.0)
    split, _ = kops.decode_split(L, 3, Hkv, D)
    for want in (ref.decode_attention_ref(q, k, v, cur, window=300,
                                          softcap=30.0),
                 ref.decode_attention_split_p_ref(q, k, v, cur, split,
                                                  window=300, softcap=30.0)):
        _close(out, want, 3e-2)
        _within_bf16_steps(out, want)
    again = kops.decode_attention_op(q, k, v, cur, window=300, softcap=30.0)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


def test_decode_kernel_never_reads_dead_region(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    q = _randn(g, 2, 8, 64)
    k, v = _randn(g, 2, 256, 2, 64), _randn(g, 2, 256, 2, 64)
    cur = torch.tensor([10, 100], device=cuda)
    want = kops.decode_attention_op(q, k, v, cur, window=32)
    for b, c in enumerate(cur.tolist()):
        k[b, c + 1:] = float("nan")
        v[b, c + 1:] = float("nan")
        k[b, :max(c - 31, 0)] = float("nan")
        v[b, :max(c - 31, 0)] = float("nan")
    out = kops.decode_attention_op(q, k, v, cur, window=32)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert torch.equal(out, want)


def test_wrappers_count_launches(cuda):
    kops.reset_launches()
    q = torch.randn(1, 4, 2, 16, device=cuda)
    kv = torch.randn(1, 8, 2, 16, device=cuda)
    kops.prefill_attention(q, kv, kv, torch.zeros(1, device=cuda),
                           torch.full((1,), 8, device=cuda))
    kops.decode_attention_op(q[:, 0], kv, kv, torch.tensor([3], device=cuda))
    kops.decode_attention_partial(q[:, 0], kv, kv,
                                  torch.tensor([11], device=cuda), 4)
    kops.paged_decode_attention(q[:, 0], kv, kv,
                                torch.zeros(1, 1, device=cuda),
                                torch.tensor([3], device=cuda))
    x = torch.rand(1, 8, 2, 16, device=cuda)
    kops.wkv6_op(x, x, x, x, torch.rand(2, 16, device=cuda),
                 torch.zeros(1, 2, 16, 16, device=cuda))
    torch.cuda.synchronize()
    assert kops.LAUNCHES == {"chunked_prefill_attention": 1,
                             "decode_attention": 1,
                             "decode_attention_partial": 1,
                             "paged_decode_attention": 1, "wkv6": 1}


def test_wrappers_count_one_launch_per_call_on_the_new_paths(cuda):
    """The bf16 tensor-core prefill path and a WKV6 call of several
    segments (three kernels from one C call) count one launch each."""
    kops.reset_launches()
    q = torch.randn(1, 64, 8, 64, device=cuda, dtype=torch.bfloat16)
    kv = torch.randn(1, 128, 2, 64, device=cuda, dtype=torch.bfloat16)
    kops.prefill_attention(q, kv, kv, torch.zeros(1, device=cuda),
                           torch.full((1,), 100, device=cuda))
    x = torch.rand(1, 1024, 40, 64, device=cuda)
    assert kops.wkv6_segment(1024, 1, 40, 16)[1] > 1
    kops.wkv6_op(x, x, x, x, torch.rand(40, 64, device=cuda),
                 torch.zeros(1, 40, 64, 64, device=cuda))
    torch.cuda.synchronize()
    assert kops.LAUNCHES == {"chunked_prefill_attention": 1,
                             "decode_attention": 0,
                             "decode_attention_partial": 0,
                             "paged_decode_attention": 0, "wkv6": 1}


def test_wrappers_raise_on_what_the_kernel_does_not_take(cuda):
    q = torch.randn(1, 4, 2, 24, device=cuda)
    kv = torch.randn(1, 8, 2, 24, device=cuda)
    with pytest.raises(ValueError):
        kops.prefill_attention(q, kv, kv, torch.zeros(1), torch.ones(1))
    q16 = torch.randn(1, 4, 2, 16, device=cuda, dtype=torch.float16)
    kv16 = torch.randn(1, 8, 2, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        kops.decode_attention_op(q16[:, 0], kv16, kv16, torch.zeros(1))
    x = torch.rand(1, 8, 2, 16, device=cuda)
    with pytest.raises(ValueError):              # WKV6 takes f32 only
        kops.wkv6_op(x.bfloat16(), x, x, x, torch.rand(2, 16, device=cuda),
                     torch.zeros(1, 2, 16, 16, device=cuda))
    with pytest.raises(ValueError):              # and contiguous tensors
        kops.wkv6_op(x.transpose(1, 2), x, x, x,
                     torch.rand(2, 16, device=cuda),
                     torch.zeros(1, 2, 16, 16, device=cuda))


@pytest.mark.parametrize("arch", ["llama31_8b", "qwen25_32b"])
def test_engine_on_card_matches_greedy(cuda, arch):
    """SMOKE model on the card: the convertible engine's tokens equal the
    port's own greedy generation, and both attention kernels ran."""
    from repro_torch import models as tm
    from repro_torch.serving import Engine, Request
    cfg = get_config(arch, smoke=True)
    model = tm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           cuda)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=(L,)).astype(np.int32)
               for L in (7, 12, 5, 20)]
    kops.reset_launches()
    eng = Engine(cfg, model, num_slots=2, max_len=64, chunk_size=8)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_drained()
    assert eng.mixed_steps > 0
    assert kops.LAUNCHES["chunked_prefill_attention"] > 0, kops.LAUNCHES
    assert kops.LAUNCHES["decode_attention"] > 0, kops.LAUNCHES
    for r, p in zip(reqs, prompts):
        want = tm.greedy_generate(cfg, model, p[None], [len(p)], 6)
        assert r.output == want[0].tolist(), r.rid


def test_rwkv_engine_on_card_matches_greedy(cuda):
    """rwkv6 SMOKE on the card: the convertible engine (chunks and reused
    slots) gives the port's own greedy tokens, through the WKV6 kernel."""
    from repro_torch import models as tm
    from repro_torch.serving import Engine, Request
    cfg = get_config("rwkv6_3b", smoke=True)
    model = tm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           cuda)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=(L,)).astype(np.int32)
               for L in (7, 12, 5, 20)]
    kops.reset_launches()
    eng = Engine(cfg, model, num_slots=2, max_len=64, chunk_size=8)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_drained()
    assert eng.mixed_steps > 0 and kops.LAUNCHES["wkv6"] > 0
    for r, p in zip(reqs, prompts):
        want = tm.greedy_generate(cfg, model, p[None], [len(p)], 6)
        assert r.output == want[0].tolist(), r.rid


# ---------------------------------------------------------------------------
# WKV6
# ---------------------------------------------------------------------------

def _wkv_inputs(cuda, B, S, H, K, seed, model_decay=False, s0_zero=False):
    """r, k, v ~ N(0, 1); w in (0, 1): the reference test's exp(-exp(
    N(-1, 0.5))), or with `model_decay` a model-like w0 in [-6, -1] across
    channels plus N(0, 0.5) noise; u ~ N(0, 1); s0 ~ N(0, 1) or 0."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    r, k, v = (_randn(g, B, S, H, K) for _ in range(3))
    z = _randn(g, B, S, H, K)
    if model_decay:
        w0 = -6.0 + 5.0 * torch.arange(H * K, device=cuda).reshape(H, K) \
            / (H * K - 1)
        w = torch.exp(-torch.exp(w0 + 0.5 * z))
    else:
        w = torch.exp(-torch.exp(0.5 * z - 1))
    u = _randn(g, H, K)
    s0 = torch.zeros(B, H, K, K, device=cuda) if s0_zero \
        else _randn(g, B, H, K, K)
    return r, k, v, w, u, s0


def _wkv_check(args, chunk=16, oracle=True):
    y, sT = kops.wkv6_op(*args, chunk=chunk)
    want_y, want_s = ref.wkv6_chunked(*args, chunk=chunk)
    _close(y, want_y, 2e-4)
    _close(sT, want_s, 2e-4)
    if oracle:
        r, k, v, w, u, s0 = args
        oy, os_ = ref.wkv6_ref(*(t.transpose(1, 2) for t in (r, k, v, w)),
                               u, s0)
        _close(y, oy.transpose(1, 2), 2e-4)
        _close(sT, os_, 2e-4)


@pytest.mark.parametrize("B,S,H,K,chunk", [
    (1, 16, 1, 8, 16), (2, 37, 2, 16, 16), (1, 64, 4, 32, 32),
    (2, 16, 2, 64, 8)])
def test_wkv6_kernel_reference_sweep(cuda, B, S, H, K, chunk):
    _wkv_check(_wkv_inputs(cuda, B, S, H, K, seed=B * 100 + S), chunk)


@pytest.mark.parametrize("S,s0_zero", [(1024, True), (256, False),
                                       (8, False)],
                         ids=["prompt1024", "chunk256", "tail8"])
def test_wkv6_kernel_main_path(cuda, S, s0_zero):
    """RWKV-6 3B heads (H=40, K=64) with model-like decays: a prompt from a
    zero state, a convertible chunk from a carried state, a ragged tail."""
    _wkv_check(_wkv_inputs(cuda, 1, S, 40, 64, seed=S, model_decay=True,
                           s0_zero=s0_zero), oracle=S <= 256)


WKV_SEGMENT_CASES = {
    # id: (B, S, H, K, chunk); the segments the wrapper picks for them
    "one-segment": (1, 8, 40, 64, 16),
    "two-segments": (2, 37, 2, 16, 16),
    "many-segments-ragged-last": (1, 1000, 40, 64, 16),
    "chunk-8": (2, 300, 4, 32, 8),
    "chunk-32": (1, 500, 3, 64, 32),
    "head-dim-8": (3, 129, 2, 8, 16),
    "long-4096": (1, 4096, 40, 64, 16),
}


@pytest.mark.parametrize("case", list(WKV_SEGMENT_CASES))
def test_wkv6_kernel_segment_cases(cuda, case):
    """One segment, two, many with a ragged last one, other chunk and head
    sizes, and a 4096-token prompt (64 segments): the kernel against the
    plain chunked version, its plain three-pass version at the wrapper's
    segment, and bit-equal to itself."""
    B, S, H, K, chunk = WKV_SEGMENT_CASES[case]
    args = _wkv_inputs(cuda, B, S, H, K, seed=S + K, model_decay=True)
    y, sT = kops.wkv6_op(*args, chunk=chunk)
    segment, nseg = kops.wkv6_segment(S, B, H, chunk)
    for want_y, want_s in (ref.wkv6_chunked(*args, chunk=chunk),
                           ref.wkv6_segmented(*args, chunk=chunk,
                                              segment=segment)):
        _close(y, want_y, 2e-4)
        _close(sT, want_s, 2e-4)
    y2, sT2 = kops.wkv6_op(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(sT, sT2)


def test_wkv6_kernel_zero_key_is_identity(cuda):
    """k = 0 across several segments: the state is s0 decayed, y = r-side
    reads of it only."""
    g = torch.Generator(device=cuda).manual_seed(11)
    B, S, H, K = 1, 200, 3, 16
    r, v = _randn(g, B, S, H, K), _randn(g, B, S, H, K)
    k = torch.zeros(B, S, H, K, device=cuda)
    w = torch.full((B, S, H, K), 0.97, device=cuda)
    u, s0 = _randn(g, H, K), _randn(g, B, H, K, K)
    assert kops.wkv6_segment(S, B, H, 16)[1] > 1
    _, sT = kops.wkv6_op(r, k, v, w, u, s0)
    _close(sT, s0 * 0.97 ** S, 1e-4)


def test_wkv6_kernel_state_carry_composes(cuda):
    r, k, v, w, u, s0 = _wkv_inputs(cuda, 1, 40, 2, 64, seed=7)
    y_full, sT_full = kops.wkv6_op(r, k, v, w, u, s0)
    h = 24
    y1, s_mid = kops.wkv6_op(*(t[:, :h].contiguous() for t in (r, k, v, w)),
                             u, s0)
    y2, sT = kops.wkv6_op(*(t[:, h:].contiguous() for t in (r, k, v, w)), u,
                          s_mid)
    _close(torch.cat([y1, y2], 1), y_full, 2e-4)
    _close(sT, sT_full, 2e-4)


# ---------------------------------------------------------------------------
# Paged decode attention
# ---------------------------------------------------------------------------

def _interleaved_pages(cuda, lens, n_blocks, bs=128):
    """Tables of a BlockAllocator that hands out one page to each request
    in turn, so every request's pages are non-contiguous."""
    from repro_torch.serving.paged import BlockAllocator
    al = BlockAllocator(n_blocks)
    need = [-(-n // bs) for n in lens]
    tables = np.full((len(lens), max(need)), -1, np.int32)
    for i in range(max(need)):
        for b, n in enumerate(need):
            if i < n:
                tables[b, i] = al.alloc(b)
    return torch.as_tensor(tables, device=cuda)


def _main_path_paged(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(5)
    cur = torch.tensor([0, 700, 1500, 2047], device=cuda)
    tables = _interleaved_pages(cuda, (cur + 1).tolist(), 40)
    q = _randn(g, 4, 32, 128, dtype=dtype)
    pk = _randn(g, 40, 128, 8, 128, dtype=dtype)
    pv = _randn(g, 40, 128, 8, 128, dtype=dtype)
    return q, pk, pv, tables, cur


@pytest.mark.parametrize("B,MB,NB,BS,Hq,Hkv,D", [
    (1, 2, 4, 16, 2, 1, 16), (3, 4, 12, 16, 4, 2, 32),
    (2, 3, 8, 32, 8, 8, 64)])
def test_paged_kernel_reference_cases(cuda, B, MB, NB, BS, Hq, Hkv, D):
    g = torch.Generator(device=cuda).manual_seed(B * 100 + MB)
    pk, pv = _randn(g, NB, BS, Hkv, D), _randn(g, NB, BS, Hkv, D)
    perm = torch.randperm(NB, generator=g, device=cuda)
    tables = torch.full((B, MB), -1, dtype=torch.int32, device=cuda)
    curs, j = [], 0
    for b in range(B):
        n = 1 + (b * 7 + MB) % MB
        tables[b, :n] = perm[j:j + n]
        j += n
        curs.append((b * 37 + 5) % (n * BS))
    cur = torch.tensor(curs, device=cuda)
    q = _randn(g, B, Hq, D)
    _close(kops.paged_decode_attention(q, pk, pv, tables, cur),
           ref.paged_decode_attention_ref(q, pk, pv, tables, cur), 2e-5)


PAGED_SPLIT_CASES = {
    # id: (BS, MB, NB, Hq, Hkv, D, cur_lens, holes): the cases of
    # tests/test_torch_split_decode.py; holes (request, table slot) are -1
    # pages inside the live range
    "bs16-hole": (16, 8, 20, 4, 2, 16, [100, 40], [(0, 2)]),
    "bs32-hole-split-edge": (32, 6, 16, 8, 2, 32, [130, 63, 64],
                             [(0, 1), (2, 0)]),
    "bs128-hole": (128, 3, 8, 4, 1, 16, [300, 127], [(0, 1)]),
    "bs16-group-of-5": (16, 6, 16, 10, 2, 16, [95, 17], []),
    "bs16-every-live-page-a-hole": (16, 4, 8, 4, 2, 32, [20, 40],
                                    [(0, 0), (0, 1)]),
}


@pytest.mark.parametrize("case", list(PAGED_SPLIT_CASES))
def test_paged_kernel_split_cases(cuda, case):
    BS, MB, NB, Hq, Hkv, D, curs, holes = PAGED_SPLIT_CASES[case]
    B = len(curs)
    g = torch.Generator(device=cuda).manual_seed(BS + MB)
    pk, pv = _randn(g, NB, BS, Hkv, D), _randn(g, NB, BS, Hkv, D)
    perm = torch.randperm(NB, generator=g, device=cuda)
    tables = torch.full((B, MB), -1, dtype=torch.int32, device=cuda)
    j = 0
    for b, c in enumerate(curs):
        n = c // BS + 1
        tables[b, :n] = perm[j:j + n]
        j += n
    for b, slot in holes:
        tables[b, slot] = -1
    cur = torch.tensor(curs, dtype=torch.int32, device=cuda)
    q = _randn(g, B, Hq, D)
    out = kops.paged_decode_attention(q, pk, pv, tables, cur)
    split, _ = kops.decode_split(MB * BS, B, Hkv, D, BS)
    _close(out, ref.paged_decode_attention_ref(q, pk, pv, tables, cur), 2e-5)
    _close(out, ref.paged_decode_attention_split_ref(q, pk, pv, tables, cur,
                                                     split), 2e-5)
    again = kops.paged_decode_attention(q, pk, pv, tables, cur)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_kernel_main_path(cuda, dtype):
    """Llama-3.1-8B heads over interleaved 128-token pages: the plain
    version, and bit for bit the contiguous decode kernel on the gathered
    KV (both kernels cut the keys into the same splits)."""
    q, pk, pv, tables, cur = _main_path_paged(cuda, dtype)
    out = kops.paged_decode_attention(q, pk, pv, tables, cur)
    want = ref.paged_decode_attention_ref(q, pk, pv, tables, cur)
    k = pk[tables.clamp(min=0).long()].reshape(4, -1, 8, 128)
    v = pv[tables.clamp(min=0).long()].reshape(4, -1, 8, 128)
    contiguous = kops.decode_attention_op(q, k, v, cur)
    if dtype == torch.bfloat16:
        _close(out, want, 3e-2)
        _within_bf16_steps(out, want)
    else:
        _close(out, want, 2e-5)
    assert torch.equal(out, contiguous)


def test_paged_kernel_never_reads_foreign_pages(cuda):
    q, pk, pv, tables, cur = _main_path_paged(cuda, torch.float32)
    want = kops.paged_decode_attention(q, pk, pv, tables, cur)
    used = set(tables[tables >= 0].tolist())
    foreign = [i for i in range(pk.shape[0]) if i not in used]
    pk[foreign] = float("nan")
    pv[foreign] = float("nan")
    out = kops.paged_decode_attention(q, pk, pv, tables, cur)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert torch.equal(out, want)


# ---------------------------------------------------------------------------
# Head dim 256 (Gemma, Gemma-2)
# ---------------------------------------------------------------------------

D256_PREFILL = {
    # id: (B, Sq, Skv, Hq, Hkv, window, softcap, offsets, lengths)
    "gemma2-prompt": (1, 512, 2048, 16, 8, 0, 50.0, [0], [512]),
    "gemma2-window-bites": (1, 256, 4864, 16, 8, 4096, 50.0, [4352],
                            [4600]),
    "gemma2-prompt-past-the-window": (1, 1280, 1280, 16, 8, 1024, 50.0,
                                      [0], [1200]),
    "gemma2-ragged-batch": (2, 96, 320, 16, 8, 64, 50.0, [100, 0],
                            [196, 60]),
    "gemma-2b-mqa": (2, 200, 512, 8, 1, 0, 0.0, [0, 300], [200, 500]),
    # rows 20.. of the window-8 layer see no key: the mean of v over Skv
    "row-without-visible-key": (1, 40, 96, 4, 2, 8, 50.0, [15], [20]),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(D256_PREFILL))
def test_prefill_kernel_d256(cuda, case, dtype):
    """Both prefill paths at D = 256 (bf16: prefill_wg_kernel, wgmma on K/V
    tiles loaded by TMA; f32: CUDA cores without the register prefetch), with
    Gemma-2's softcap, a window that bites, MQA and a row with no visible
    key: bf16 at 3e-2 and 2e-5 + 2 bf16 steps of the plain version and of
    the plain version with the kernel's rounding, f32 at 2e-5; two calls
    bit-equal."""
    B, Sq, Skv, Hq, Hkv, window, cap, offs, lens = D256_PREFILL[case]
    g = torch.Generator(device=cuda).manual_seed(Sq + Skv)
    q = _randn(g, B, Sq, Hq, 256, dtype=dtype)
    k = _randn(g, B, Skv, Hkv, 256, dtype=dtype)
    v = _randn(g, B, Skv, Hkv, 256, dtype=dtype)
    o = torch.tensor(offs, dtype=torch.int32, device=cuda)
    n = torch.tensor(lens, dtype=torch.int32, device=cuda)
    out = kops.prefill_attention(q, k, v, o, n, window=window, softcap=cap)
    want = ref.chunked_prefill_attention_ref(q, k, v, o, n, window=window,
                                             softcap=cap)
    if dtype == torch.bfloat16:
        for w in (want, ref.chunked_prefill_attention_split_p_ref(
                q, k, v, o, n, window=window, softcap=cap)):
            _close(out, w, 3e-2)
            _within_bf16_steps(out, w)
    else:
        _close(out, want, 2e-5)
    again = kops.prefill_attention(q, k, v, o, n, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


D256_DEAD_KEYS = {
    # id: (B, Sq, Skv, Hq, Hkv, window, softcap, offsets, lengths)
    "gemma2-chunk-past-the-window": (1, 256, 4864, 16, 8, 4096, 50.0,
                                     [4352], [4608]),
    "gemma2-ragged-edges": (2, 150, 700, 16, 8, 300, 50.0, [500, 37],
                            [650, 187]),
    "gemma-2b-mqa-past-lengths": (2, 130, 512, 8, 1, 0, 0.0, [200, 0],
                                  [330, 130]),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(D256_DEAD_KEYS))
def test_prefill_kernel_d256_nan_in_dead_keys(cuda, case, dtype):
    """NaN in K and V at every key no row can see (behind every row's
    window, at and past lengths) changes no bit of the output: the bf16
    kernel's TMA tiles copy those rows into shared memory, where they must
    weigh exactly 0.  Lengths and windows cut tiles of 64 keys in the
    middle; held to the plain version on the clean inputs as in
    test_prefill_kernel_d256."""
    B, Sq, Skv, Hq, Hkv, window, cap, offs, lens = D256_DEAD_KEYS[case]
    g = torch.Generator(device=cuda).manual_seed(Sq + Skv + 1)
    q = _randn(g, B, Sq, Hq, 256, dtype=dtype)
    k = _randn(g, B, Skv, Hkv, 256, dtype=dtype)
    v = _randn(g, B, Skv, Hkv, 256, dtype=dtype)
    o = torch.tensor(offs, dtype=torch.int32, device=cuda)
    n = torch.tensor(lens, dtype=torch.int32, device=cuda)
    args = dict(window=window, softcap=cap)
    clean = kops.prefill_attention(q, k, v, o, n, **args)
    want = ref.chunked_prefill_attention_ref(q, k, v, o, n, **args)
    for b, (off, ln) in enumerate(zip(offs, lens)):
        for t in (k, v):
            t[b, ln:] = float("nan")
            if window:
                t[b, :max(off - window + 1, 0)] = float("nan")
    dirty = kops.prefill_attention(q, k, v, o, n, **args)
    torch.cuda.synchronize()
    assert torch.isfinite(dirty).all()
    assert torch.equal(dirty, clean)
    if dtype == torch.bfloat16:
        _close(dirty, want, 3e-2)
        _within_bf16_steps(dirty, want)
    else:
        _close(dirty, want, 2e-5)


# ---------------------------------------------------------------------------
# bf16 prefill at head dims 16 to 128 on prefill_wg_kernel (wgmma + TMA;
# at 16, 32 and 112 rows padded to whole 64-column blocks by the TMA map)
# ---------------------------------------------------------------------------

WG_PREFILL = {
    # id: (B, Sq, Skv, Hq, Hkv, D, window, softcap, offsets, lengths)
    "llama-prompt": (1, 512, 2048, 32, 8, 128, 0, 0.0, [0], [512]),
    "llama-planned-chunk": (1, 2816, 4096, 32, 8, 128, 0, 0.0, [0], [2816]),
    "llama-last-chunk": (1, 1280, 4096, 32, 8, 128, 0, 0.0, [2816], [3540]),
    "qwen-group-of-5": (1, 512, 2048, 40, 8, 128, 0, 0.0, [0], [512]),
    "mqa-6-over-1": (2, 200, 512, 6, 1, 128, 0, 0.0, [0, 300], [200, 500]),
    "window-softcap": (1, 256, 384, 2, 2, 128, 64, 50.0, [100], [384]),
    "ragged-chunks": (2, 96, 320, 16, 2, 128, 64, 0.0, [100, 0], [196, 60]),
    "qwen2-0.5b-d64": (1, 512, 2048, 14, 2, 64, 0, 0.0, [0], [512]),
    "musicgen-d64-window-softcap": (2, 150, 700, 32, 32, 64, 300, 50.0,
                                    [500, 37], [650, 187]),
    # rows 20.. of the window-8 layer see no key: the mean of v over Skv
    "row-without-visible-key-d128": (1, 40, 96, 8, 2, 128, 8, 0.0, [15],
                                     [20]),
    "row-without-visible-key-d64": (1, 40, 96, 8, 2, 64, 8, 50.0, [15],
                                    [20]),
    "kimi-d112-prompt": (1, 512, 2048, 64, 8, 112, 0, 0.0, [0], [512]),
    "kimi-d112-chunk-window-softcap": (1, 256, 2048, 64, 8, 112, 1024, 50.0,
                                       [1536], [1700]),
    "d112-ragged-chunks": (2, 96, 320, 16, 2, 112, 64, 0.0, [100, 0],
                           [196, 60]),
    "d32-mqa-window-softcap": (2, 120, 400, 8, 1, 32, 48, 30.0, [150, 0],
                               [270, 100]),
    "d16-ragged-chunks": (2, 96, 320, 16, 2, 16, 64, 0.0, [100, 0],
                          [196, 60]),
}


def _wg_inputs(cuda, case, seed):
    B, Sq, Skv, Hq, Hkv, D, window, cap, offs, lens = WG_PREFILL[case]
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = _randn(g, B, Sq, Hq, D, dtype=torch.bfloat16)
    k = _randn(g, B, Skv, Hkv, D, dtype=torch.bfloat16)
    v = _randn(g, B, Skv, Hkv, D, dtype=torch.bfloat16)
    o = torch.tensor(offs, dtype=torch.int32, device=cuda)
    n = torch.tensor(lens, dtype=torch.int32, device=cuda)
    return q, k, v, o, n, dict(window=window, softcap=cap)


@pytest.mark.parametrize("case", list(WG_PREFILL))
def test_prefill_kernel_wg_d64_d128(cuda, case):
    """bf16 prefill at D = 16 to 128 runs prefill_wg_kernel: against the
    plain version and the plain version with the kernel's rounding (3e-2,
    and 2e-5 + 2 bf16 steps), two calls bit-equal, one launch a call."""
    q, k, v, o, n, args = _wg_inputs(cuda, case, seed=len(case))
    kops.reset_launches()
    out = kops.prefill_attention(q, k, v, o, n, **args)
    assert kops.LAUNCHES["chunked_prefill_attention"] == 1
    for want in (ref.chunked_prefill_attention_ref(q, k, v, o, n, **args),
                 ref.chunked_prefill_attention_split_p_ref(q, k, v, o, n,
                                                           **args)):
        _close(out, want, 3e-2)
        _within_bf16_steps(out, want)
    again = kops.prefill_attention(q, k, v, o, n, **args)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


@pytest.mark.parametrize("case", ["llama-last-chunk", "mqa-6-over-1",
                                  "window-softcap", "ragged-chunks",
                                  "musicgen-d64-window-softcap",
                                  "kimi-d112-chunk-window-softcap",
                                  "d112-ragged-chunks",
                                  "d32-mqa-window-softcap",
                                  "d16-ragged-chunks"])
def test_prefill_kernel_wg_d64_d128_nan_in_dead_keys(cuda, case):
    """NaN in K and V at every key no row can see (behind every row's
    window, at and past lengths; in the first and the last tile a block
    loads) changes no bit of the bf16 output at D = 16 to 128."""
    q, k, v, o, n, args = _wg_inputs(cuda, case, seed=len(case) + 1)
    clean = kops.prefill_attention(q, k, v, o, n, **args)
    want = ref.chunked_prefill_attention_ref(q, k, v, o, n, **args)
    window = args["window"]
    for b, (off, ln) in enumerate(zip(o.tolist(), n.tolist())):
        for t in (k, v):
            t[b, ln:] = float("nan")
            if window:
                t[b, :max(off - window + 1, 0)] = float("nan")
    dirty = kops.prefill_attention(q, k, v, o, n, **args)
    torch.cuda.synchronize()
    assert torch.isfinite(dirty).all()
    assert torch.equal(dirty, clean)
    _close(dirty, want, 3e-2)
    _within_bf16_steps(dirty, want)


D256_DECODE = {
    # id: (L, Hq, Hkv, window, softcap, cur_lens)
    "gemma2-window-bites": (5120, 16, 8, 4096, 50.0, [0, 700, 1500, 4600]),
    "gemma-2b-mqa": (1024, 8, 1, 0, 0.0, [1023, 0, 500]),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(D256_DECODE))
def test_decode_kernel_d256(cuda, case, dtype):
    """The split-KV decode kernel at D = 256 (bf16: 8 values a lane; f32:
    two 16-byte chunks a lane, 16-row tiles): against the plain version and
    the plain split-and-merge version, and bit-equal to itself."""
    L, Hq, Hkv, window, cap, curs = D256_DECODE[case]
    B = len(curs)
    g = torch.Generator(device=cuda).manual_seed(L + Hq)
    q = _randn(g, B, Hq, 256, dtype=dtype)
    k = _randn(g, B, L, Hkv, 256, dtype=dtype)
    v = _randn(g, B, L, Hkv, 256, dtype=dtype)
    cur = torch.tensor(curs, dtype=torch.int32, device=cuda)
    out = kops.decode_attention_op(q, k, v, cur, window=window, softcap=cap)
    split, nsplit = kops.decode_split(L, B, Hkv, 256)
    assert nsplit > 1
    for want in (ref.decode_attention_ref(q, k, v, cur, window=window,
                                          softcap=cap),
                 ref.decode_attention_split_ref(q, k, v, cur, split,
                                                window=window, softcap=cap)):
        if dtype == torch.bfloat16:
            _close(out, want, 3e-2)
            _within_bf16_steps(out, want)
        else:
            _close(out, want, 2e-5)
    again = kops.decode_attention_op(q, k, v, cur, window=window,
                                     softcap=cap)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_paged_kernel_d256(cuda, dtype):
    """Gemma-2-9B's heads (16 / 8, D = 256) over interleaved 128-token
    pages: the plain version, its split-and-merge form, and bit for bit the
    contiguous decode kernel on the gathered KV."""
    g = torch.Generator(device=cuda).manual_seed(256)
    cur = torch.tensor([0, 700, 1500, 2047], device=cuda)
    tables = _interleaved_pages(cuda, (cur + 1).tolist(), 40)
    q = _randn(g, 4, 16, 256, dtype=dtype)
    pk = _randn(g, 40, 128, 8, 256, dtype=dtype)
    pv = _randn(g, 40, 128, 8, 256, dtype=dtype)
    out = kops.paged_decode_attention(q, pk, pv, tables, cur)
    split, _ = kops.decode_split(tables.shape[1] * 128, 4, 8, 256, 128)
    for want in (ref.paged_decode_attention_ref(q, pk, pv, tables, cur),
                 ref.paged_decode_attention_split_ref(q, pk, pv, tables, cur,
                                                      split)):
        if dtype == torch.bfloat16:
            _close(out, want, 3e-2)
            _within_bf16_steps(out, want)
        else:
            _close(out, want, 2e-5)
    safe = tables.clamp(min=0).long()
    contiguous = kops.decode_attention_op(
        q, pk[safe].reshape(4, -1, 8, 256), pv[safe].reshape(4, -1, 8, 256),
        cur)
    torch.cuda.synchronize()
    assert torch.equal(out, contiguous)


# ---------------------------------------------------------------------------
# Head dim 112 (Kimi K2: d_model 7168 over 64 heads)
# ---------------------------------------------------------------------------

D112_PREFILL = {
    # id: (B, Sq, Skv, Hq, Hkv, window, softcap, offsets, lengths)
    "kimi-prompt": (1, 512, 2048, 64, 8, 0, 0.0, [0], [512]),
    "kimi-chunk-window-softcap": (1, 256, 1280, 64, 8, 512, 50.0, [896],
                                  [1100]),
    "ragged-batch": (2, 96, 320, 16, 2, 64, 50.0, [100, 0], [196, 60]),
    "mqa": (2, 200, 512, 8, 1, 0, 0.0, [0, 300], [200, 500]),
    # rows 20.. of the window-8 layer see no key: the mean of v over Skv
    "row-without-visible-key": (1, 40, 96, 16, 2, 8, 50.0, [15], [20]),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(D112_PREFILL))
def test_prefill_kernel_d112(cuda, case, dtype):
    """Both prefill paths at D = 112 (bf16: prefill_wg_kernel<112>, rows
    padded to 128 columns; f32: prefill_f32_kernel<112>, 7 columns a
    thread) at
    Kimi K2's heads (64 / 8), with offsets, a window and softcap, ragged
    lengths, MQA and a row with no visible key: bf16 at 3e-2 and 2e-5 + 2
    bf16 steps of the plain version and of the plain version with the
    kernel's rounding, f32 at 2e-5; one launch a call; two calls
    bit-equal."""
    B, Sq, Skv, Hq, Hkv, window, cap, offs, lens = D112_PREFILL[case]
    g = torch.Generator(device=cuda).manual_seed(Sq + Skv + 112)
    q = _randn(g, B, Sq, Hq, 112, dtype=dtype)
    k = _randn(g, B, Skv, Hkv, 112, dtype=dtype)
    v = _randn(g, B, Skv, Hkv, 112, dtype=dtype)
    o = torch.tensor(offs, dtype=torch.int32, device=cuda)
    n = torch.tensor(lens, dtype=torch.int32, device=cuda)
    kops.reset_launches()
    out = kops.prefill_attention(q, k, v, o, n, window=window, softcap=cap)
    assert kops.LAUNCHES["chunked_prefill_attention"] == 1
    want = ref.chunked_prefill_attention_ref(q, k, v, o, n, window=window,
                                             softcap=cap)
    if dtype == torch.bfloat16:
        for w in (want, ref.chunked_prefill_attention_split_p_ref(
                q, k, v, o, n, window=window, softcap=cap)):
            _close(out, w, 3e-2)
            _within_bf16_steps(out, w)
    else:
        _close(out, want, 2e-5)
    again = kops.prefill_attention(q, k, v, o, n, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


D112_DECODE = {
    # id: (L, Hq, Hkv, window, softcap, cur_lens)
    "kimi-heads": (2048, 64, 8, 0, 0.0, [0, 700, 1500, 2047]),
    "window-across-splits-softcap": (1024, 16, 2, 300, 50.0,
                                     [1023, 0, 500, 700]),
    "group-of-16": (1024, 32, 2, 0, 0.0, [1023, 129, 128, 5]),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(D112_DECODE))
def test_decode_kernel_d112(cuda, case, dtype):
    """The split-KV decode kernel at D = 112 (bf16: decode_tc_kernel<112>,
    7 k-steps and 7 m-tiles, Q^T in registers, one or two n-tiles of heads;
    f32: decode_split_kernel<112>, a row's 28 chunks on 28 lanes of a
    warp): against the plain version and the plain split-and-merge
    version, in bf16 also the kernel's arithmetic, and bit-equal to
    itself."""
    L, Hq, Hkv, window, cap, curs = D112_DECODE[case]
    B = len(curs)
    g = torch.Generator(device=cuda).manual_seed(L + Hq + 112)
    q = _randn(g, B, Hq, 112, dtype=dtype)
    k = _randn(g, B, L, Hkv, 112, dtype=dtype)
    v = _randn(g, B, L, Hkv, 112, dtype=dtype)
    cur = torch.tensor(curs, dtype=torch.int32, device=cuda)
    kops.reset_launches()
    out = kops.decode_attention_op(q, k, v, cur, window=window, softcap=cap)
    assert kops.LAUNCHES["decode_attention"] == 1
    split, nsplit = kops.decode_split(L, B, Hkv, 112)
    assert nsplit > 1
    wants = [ref.decode_attention_ref(q, k, v, cur, window=window,
                                      softcap=cap),
             ref.decode_attention_split_ref(q, k, v, cur, split,
                                            window=window, softcap=cap)]
    if dtype == torch.bfloat16:
        wants.append(ref.decode_attention_split_p_ref(
            q, k, v, cur, split, window=window, softcap=cap))
    for want in wants:
        if dtype == torch.bfloat16:
            _close(out, want, 3e-2)
            _within_bf16_steps(out, want)
        else:
            _close(out, want, 2e-5)
    again = kops.decode_attention_op(q, k, v, cur, window=window,
                                     softcap=cap)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_paged_kernel_d112(cuda, dtype):
    """Kimi K2's heads (64 / 8, D = 112) over interleaved 128-token pages:
    the plain version, its split-and-merge form, and bit for bit the
    contiguous decode kernel on the gathered KV; bit-equal to itself."""
    g = torch.Generator(device=cuda).manual_seed(112)
    cur = torch.tensor([0, 700, 1500, 2047], device=cuda)
    tables = _interleaved_pages(cuda, (cur + 1).tolist(), 40)
    q = _randn(g, 4, 64, 112, dtype=dtype)
    pk = _randn(g, 40, 128, 8, 112, dtype=dtype)
    pv = _randn(g, 40, 128, 8, 112, dtype=dtype)
    out = kops.paged_decode_attention(q, pk, pv, tables, cur)
    split, _ = kops.decode_split(tables.shape[1] * 128, 4, 8, 112, 128)
    for want in (ref.paged_decode_attention_ref(q, pk, pv, tables, cur),
                 ref.paged_decode_attention_split_ref(q, pk, pv, tables, cur,
                                                      split)):
        if dtype == torch.bfloat16:
            _close(out, want, 3e-2)
            _within_bf16_steps(out, want)
        else:
            _close(out, want, 2e-5)
    safe = tables.clamp(min=0).long()
    contiguous = kops.decode_attention_op(
        q, pk[safe].reshape(4, -1, 8, 112), pv[safe].reshape(4, -1, 8, 112),
        cur)
    again = kops.paged_decode_attention(q, pk, pv, tables, cur)
    torch.cuda.synchronize()
    assert torch.equal(out, contiguous)
    assert torch.equal(out, again)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_decode_partial_kernel_d112(cuda, dtype):
    """The rank-slice entry at Kimi K2's heads (64 / 8, D = 112), a
    2048-position cache in 4 slices with a window starting mid-slice: each
    slice's (o, lse) within 2e-5 of the plain version (-inf where it has
    it), bit-equal to itself; the slices merged against the one-pass plain
    decode."""
    L, n, window, curs = 2048, 4, 700, [2047, 1000, 512, 0]
    B, per = len(curs), 2048 // 4
    g = torch.Generator(device=cuda).manual_seed(1120)
    q = _randn(g, B, 64, 112, dtype=dtype)
    k = _randn(g, B, L, 8, 112, dtype=dtype)
    v = _randn(g, B, L, 8, 112, dtype=dtype)
    cur = torch.tensor(curs, dtype=torch.int32, device=cuda)
    os_, lses = [], []
    for i in range(n):
        ks = k[:, i * per:(i + 1) * per].contiguous()
        vs = v[:, i * per:(i + 1) * per].contiguous()
        o, lse = kops.decode_attention_partial(q, ks, vs, cur, i * per,
                                               window=window)
        wo, wl = ref.decode_attention_partial_ref(q, ks, vs, cur, i * per,
                                                  window=window)
        _close(o, wo, 2e-5)
        torch.testing.assert_close(torch.isneginf(lse), torch.isneginf(wl))
        live = torch.isfinite(wl)
        _close(lse[live], wl[live], 2e-5)
        again = kops.decode_attention_partial(q, ks, vs, cur, i * per,
                                              window=window)
        torch.cuda.synchronize()
        assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
        os_.append(o)
        lses.append(lse)
    merged = ref.merge_decode_partials(torch.stack(os_), torch.stack(lses))
    _close(merged, ref.decode_attention_ref(q.float(), k.float(), v.float(),
                                            cur, window=window), 2e-5)


@pytest.mark.parametrize("D", [64, 128, 256])
def test_decode_kernel_f32_other_head_dims(cuda, D):
    """The f32 decode kernel at the head dims whose lanes a row did not
    change when D = 112 was added (a power of two of chunks a row): against
    the plain version and the split-and-merge version at 2e-5, groups of 4
    and 8 (GMAX 4 and 8), a window and softcap."""
    g = torch.Generator(device=cuda).manual_seed(D)
    for Hq, Hkv in ((32, 8), (16, 2)):
        q = _randn(g, 3, Hq, D)
        k, v = _randn(g, 3, 1024, Hkv, D), _randn(g, 3, 1024, Hkv, D)
        cur = torch.tensor([1023, 300, 0], dtype=torch.int32, device=cuda)
        out = kops.decode_attention_op(q, k, v, cur, window=500, softcap=30.0)
        split, _ = kops.decode_split(1024, 3, Hkv, D)
        _close(out, ref.decode_attention_ref(q, k, v, cur, window=500,
                                             softcap=30.0), 2e-5)
        _close(out, ref.decode_attention_split_ref(
            q, k, v, cur, split, window=500, softcap=30.0), 2e-5)


def test_kimi_d112_train_gradients_through_the_kernel(cuda):
    """Kimi K2's SMOKE model at its published head dim (d_model 448 over
    4 / 2 heads of 112, f32): every leaf's loss gradient with the prefill
    kernel in the forward (the plain version's VJP as backward) within
    2e-4 of the leaf's largest |gradient| of the plain_kernels path's."""
    from repro_torch import models as tm
    from repro_torch import training as tt
    cfg = get_config("kimi_k2_1t_a32b", smoke=True).replace(d_model=448)
    assert cfg.head_dim_ == 112
    model = tm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           cuda)
    noise = torch.Generator(device=cuda).manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                p.copy_(0.05 * torch.randn(p.shape, generator=noise,
                                           device=cuda))
    model.requires_grad_(True)
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 96))
    labels = np.roll(toks, -1, 1)
    params = list(model.parameters())
    kops.reset_launches()
    got = torch.autograd.grad(tt.lm_loss(cfg, model, toks, labels)[0], params)
    assert kops.LAUNCHES["chunked_prefill_attention"] == cfg.num_layers
    want = torch.autograd.grad(
        tt.lm_loss(cfg, model, toks, labels, plain_kernels=True)[0], params)
    for a, b in zip(got, want):
        assert b.abs().max().item() > 0
        assert (a - b).abs().max().item() <= 2e-4 * b.abs().max().item()


@pytest.mark.parametrize("arch,over", [
    ("llama31_8b", {}), ("gemma2_9b", {}),
    ("gemma2_9b", {"head_dim": 256, "query_scale": 1.0 / 16.0})],
    ids=["llama", "gemma2", "gemma2-d256"])
def test_forward_train_on_card_matches_plain(cuda, arch, over):
    """forward_train's logits through the prefill kernel (offset 0, the
    rows' lengths; gemma2's window of 64 bites at 80 tokens) against the
    same model on the CPU, where attention runs the plain version, f32
    SMOKE weights: 2e-4."""
    import copy

    from repro_torch import models as tm
    cfg = get_config(arch, smoke=True).replace(**over)
    model = tm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           cuda)
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 80))
    lens = [80, 70]
    kops.reset_launches()
    got, _ = tm.forward_train(cfg, model, toks, lengths=lens)
    torch.cuda.synchronize()
    assert kops.LAUNCHES["chunked_prefill_attention"] == cfg.num_layers
    want, _ = tm.forward_train(cfg, copy.deepcopy(model).cpu(), toks,
                               lengths=lens)
    _close(got.cpu(), want, 2e-4)


@pytest.mark.parametrize("arch,over,lens,max_len,chunk", [
    ("gemma2_9b", {}, (70, 12, 90, 66), 112, 32),
    ("llama31_8b", {"kv_cache_dtype": "int8"}, (7, 12, 5, 20), 64, 8)],
    ids=["gemma2-window", "llama-int8"])
def test_dense_family_engine_on_card_matches_greedy(cuda, arch, over, lens,
                                                    max_len, chunk):
    """gemma2 SMOKE with prompts past its 64-token window, and the int8
    cache: the convertible engine's tokens equal the port's own greedy
    generation on the card, through both attention kernels."""
    from repro_torch import models as tm
    from repro_torch.serving import Engine, Request
    cfg = get_config(arch, smoke=True).replace(**over)
    model = tm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           cuda)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=(L,)).astype(np.int32)
               for L in lens]
    kops.reset_launches()
    eng = Engine(cfg, model, num_slots=2, max_len=max_len, chunk_size=chunk)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_drained()
    assert eng.mixed_steps > 0
    assert kops.LAUNCHES["chunked_prefill_attention"] > 0, kops.LAUNCHES
    assert kops.LAUNCHES["decode_attention"] > 0, kops.LAUNCHES
    for r, p in zip(reqs, prompts):
        want = tm.greedy_generate(cfg, model, p[None], [len(p)], 6)
        assert r.output == want[0].tolist(), r.rid


# ---------------------------------------------------------------------------
# the rest of the layer zoo (MLA, MoE, Mamba, cross-attention) on the card
# ---------------------------------------------------------------------------

def _zoo_model(cuda, arch):
    from repro_torch import models as tm
    cfg = get_config(arch, smoke=True)
    model = tm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           cuda)
    if cfg.num_vision_tokens:           # tanh(0) would silence the images
        for layer in model.layers:
            if layer.spec.mixer == "cross_attn":
                with torch.no_grad():
                    layer.gate.fill_(1.0)
    return cfg, model


def _zoo_images(cuda, cfg, n):
    g = torch.Generator(device=cuda).manual_seed(5)
    return torch.randn(n, cfg.num_vision_tokens, cfg.d_model, generator=g,
                       device=cuda)


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "kimi_k2_1t_a32b",
                                  "jamba_v0_1_52b"])
def test_zoo_engine_on_card_matches_greedy(cuda, arch):
    """SMOKE models on the card: the convertible engine (chunks of 8, 2
    slots, so a chunked request lands in a reused slot) gives the port's
    own greedy tokens.  Kimi's and Jamba's attention layers go through
    both attention kernels; DeepSeek's MLA through none, as in the
    reference."""
    from repro_torch import models as tm
    from repro_torch.serving import Engine, Request
    cfg, model = _zoo_model(cuda, arch)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=(L,)).astype(np.int32)
               for L in (7, 12, 5, 20)]
    kops.reset_launches()
    eng = Engine(cfg, model, num_slots=2, max_len=64, chunk_size=8)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_drained()
    assert eng.mixed_steps > 0
    attn = (kops.LAUNCHES["chunked_prefill_attention"],
            kops.LAUNCHES["decode_attention"])
    if cfg.kv_lora_rank:
        assert attn == (0, 0), kops.LAUNCHES
    else:
        assert min(attn) > 0, kops.LAUNCHES
    for r, p in zip(reqs, prompts):
        want = tm.greedy_generate(cfg, model, p[None], [len(p)], 6)
        assert r.output == want[0].tolist(), r.rid


def test_vision_engine_on_card_matches_greedy(cuda):
    """llama-vision SMOKE on the card, gate 1: an Engine (chunk_size 0)
    with an image per request gives the port's own greedy tokens, through
    both attention kernels on the self-attention layer; another image
    changes the tokens."""
    from repro_torch import models as tm
    from repro_torch.serving import Engine, Request
    cfg, model = _zoo_model(cuda, "llama_3_2_vision_11b")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=(L,)).astype(np.int32)
               for L in (7, 12, 5, 20)]
    ie = _zoo_images(cuda, cfg, len(prompts))
    kops.reset_launches()
    eng = Engine(cfg, model, num_slots=2, max_len=64)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6, image_embeds=ie[i])
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_drained()
    assert kops.LAUNCHES["chunked_prefill_attention"] > 0, kops.LAUNCHES
    assert kops.LAUNCHES["decode_attention"] > 0, kops.LAUNCHES
    for r, p in zip(reqs, prompts):
        want = tm.greedy_generate(cfg, model, p[None], [len(p)], 6,
                                  ie[r.rid:r.rid + 1])
        assert r.output == want[0].tolist(), r.rid
    other = tm.greedy_generate(cfg, model, prompts[3][None], [20], 6, ie[:1])
    assert other[0].tolist() != reqs[3].output


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "kimi_k2_1t_a32b",
                                  "jamba_v0_1_52b", "llama_3_2_vision_11b"])
def test_zoo_forward_train_on_card_matches_cpu(cuda, arch):
    """forward_train's logits and MoE aux on the card (attention through
    the prefill kernel, MLA / MoE / Mamba / cross-attention as torch ops)
    against the same model on the CPU, f32 SMOKE weights: 2e-4."""
    import copy

    from repro_torch import models as tm
    cfg, model = _zoo_model(cuda, arch)
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 40))
    ie = _zoo_images(cuda, cfg, 2) if cfg.num_vision_tokens else None
    got, aux = tm.forward_train(cfg, model, toks, ie, [40, 33])
    want, want_aux = tm.forward_train(
        cfg, copy.deepcopy(model).cpu(), toks,
        None if ie is None else ie.cpu(), [40, 33])
    _close(got.cpu(), want, 2e-4)
    _close(aux.cpu(), want_aux, 2e-4)


# ---------------------------------------------------------------------------
# training: the differentiable wrappers with the kernels in their forward
# ---------------------------------------------------------------------------

def _grads_both_ways(kernel, plain, inputs, cots):
    """Outputs and input gradients of sum(out * cot) through `kernel` (the
    wrapper's Function: kernel forward, the plain version's VJP) and
    through autograd of `plain`."""
    res = []
    for fn in (kernel, plain):
        xs = [x.detach().requires_grad_() for x in inputs]
        out = fn(*xs)
        out = out if isinstance(out, tuple) else (out,)
        res.append((out, torch.autograd.grad(out, xs, cots)))
    return res


@pytest.mark.parametrize("case", [
    # S, Hq, Hkv, D, window, softcap, dtype
    (2048, 32, 8, 128, 0, 0.0, torch.bfloat16),
    (2048, 32, 8, 128, 0, 0.0, torch.float32),
    (640, 16, 8, 256, 512, 50.0, torch.bfloat16),
    (640, 16, 8, 256, 512, 50.0, torch.float32)],
    ids=["llama-bf16", "llama-f32", "gemma2-d256-window-bf16",
         "gemma2-d256-window-f32"])
def test_prefill_attention_grads_through_the_kernel(cuda, case):
    """The forward launches the kernel, the gradients are the plain
    version's: dq, dk, dv equal autograd of the plain version (2e-5 f32,
    3e-2 bf16), nonzero and finite."""
    S, Hq, Hkv, D, window, cap, dt = case
    g = torch.Generator(device=cuda).manual_seed(5)
    q = _randn(g, 1, S, Hq, D, dtype=dt)
    k, v = _randn(g, 1, S, Hkv, D, dtype=dt), _randn(g, 1, S, Hkv, D, dtype=dt)
    off = torch.zeros(1, dtype=torch.int32, device=cuda)
    lens = torch.full((1,), S, dtype=torch.int32, device=cuda)
    kops.reset_launches()
    (ko, kg), (po, pg) = _grads_both_ways(
        lambda q, k, v: kops.prefill_attention(q, k, v, off, lens, window,
                                               cap),
        lambda q, k, v: ref.chunked_prefill_attention_ref(
            q, k, v, off, lens, window, cap),
        (q, k, v), (_randn(g, 1, S, Hq, D, dtype=dt),))
    assert kops.LAUNCHES["chunked_prefill_attention"] == 1
    tol = 2e-5 if dt == torch.float32 else 3e-2
    _close(ko[0], po[0], tol)
    for a, b in zip(kg, pg):
        _close(a, b, tol)
        assert bool(torch.isfinite(a).all()) and a.abs().max().item() > 0


@pytest.mark.parametrize("zero_state", [True, False], ids=["zero", "carried"])
def test_wkv6_grads_through_the_kernel(cuda, zero_state):
    """The same for WKV6 at RWKV-6 3B's heads (S=1024, f32, 2e-4): dr, dk,
    dv, dw, du and ds0."""
    g = torch.Generator(device=cuda).manual_seed(6)
    B, S, H, K = 1, 1024, 40, 64
    r, k, v = (_randn(g, B, S, H, K) for _ in range(3))
    w = torch.exp(-torch.exp(0.5 * _randn(g, B, S, H, K) - 1))
    u = _randn(g, H, K)
    s0 = torch.zeros(B, H, K, K, device=cuda) if zero_state \
        else _randn(g, B, H, K, K)
    kops.reset_launches()
    (ko, kg), (po, pg) = _grads_both_ways(
        kops.wkv6_op, ref.wkv6_chunked, (r, k, v, w, u, s0),
        (_randn(g, B, S, H, K), _randn(g, B, H, K, K)))
    assert kops.LAUNCHES["wkv6"] == 1
    for a, b in list(zip(ko, po)) + list(zip(kg, pg)):
        _close(a, b, 2e-4)
    for a in kg:
        assert bool(torch.isfinite(a).all()) and a.abs().max().item() > 0


@pytest.mark.parametrize("arch", ["llama31_8b", "gemma2_9b", "rwkv6_3b",
                                  "jamba_v0_1_52b"])
def test_train_step_gradients_on_card_match_plain(cuda, arch):
    """An f32 SMOKE model's loss gradient through the kernels equals the
    plain_kernels path's for every leaf (within 2e-4 of the leaf's largest
    |gradient|), and one train step on the card lowers nothing to the CPU:
    the step refuses a model on the other device."""
    from repro_torch import models as tm
    from repro_torch import training as tt
    cfg = get_config(arch, smoke=True)
    model = tm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           cuda)
    noise = torch.Generator(device=cuda).manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                p.copy_(0.05 * torch.randn(p.shape, generator=noise,
                                           device=cuda))
    model.requires_grad_(True)
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 96))
    labels = np.roll(toks, -1, 1)
    params = list(model.parameters())
    kops.reset_launches()
    got = torch.autograd.grad(tt.lm_loss(cfg, model, toks, labels)[0], params)
    assert kops.LAUNCHES["chunked_prefill_attention"] + \
        kops.LAUNCHES["wkv6"] > 0
    want = torch.autograd.grad(
        tt.lm_loss(cfg, model, toks, labels, plain_kernels=True)[0], params)
    for a, b in zip(got, want):
        assert b.abs().max().item() > 0
        assert (a - b).abs().max().item() <= 2e-4 * b.abs().max().item()
    opt_cfg = tt.AdamWConfig(warmup_steps=0, lr=1e-3)
    step = tt.make_train_step(cfg, opt_cfg)
    _, _, m = step(model, tt.adamw_init(model, opt_cfg), toks, labels)
    assert np.isfinite(float(m["loss"]))
    with pytest.raises(ValueError, match="cuda"):
        step(tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
             None, toks, labels)
