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
    "boundary-at-cur-1-cur-cur+1": (192, 8, 2, 32, 0, 0.0, [65, 64, 63]),
    "cur-0": (128, 4, 1, 16, 0, 0.0, [0, 0]),
    "window-inside-one-split": (256, 8, 2, 32, 20, 0.0, [100, 140]),
    "window-spans-two-splits": (256, 8, 2, 32, 50, 0.0, [80, 200]),
    "window-boundary-at-start": (256, 4, 2, 16, 37, 0.0, [100, 63]),
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
    split, _ = kops.decode_split(L, B, Hkv)
    _close(out, ref.decode_attention_ref(q, k, v, cur, window=window,
                                         softcap=cap), 2e-5)
    _close(out, ref.decode_attention_split_ref(q, k, v, cur, split,
                                               window=window, softcap=cap),
           2e-5)
    again = kops.decode_attention_op(q, k, v, cur, window=window,
                                     softcap=cap)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


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
    split, nsplit = kops.decode_split(2048, 4, 8)
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
    kops.paged_decode_attention(q[:, 0], kv, kv,
                                torch.zeros(1, 1, device=cuda),
                                torch.tensor([3], device=cuda))
    x = torch.rand(1, 8, 2, 16, device=cuda)
    kops.wkv6_op(x, x, x, x, torch.rand(2, 16, device=cuda),
                 torch.zeros(1, 2, 16, 16, device=cuda))
    torch.cuda.synchronize()
    assert kops.LAUNCHES == {"chunked_prefill_attention": 1,
                             "decode_attention": 1,
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
    split, _ = kops.decode_split(MB * BS, B, Hkv, BS)
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
    """Both prefill paths at D = 256 (bf16: tensor cores with Q's fragments
    from shared memory; f32: CUDA cores without the register prefetch), with
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
    split, nsplit = kops.decode_split(L, B, Hkv)
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
    split, _ = kops.decode_split(tables.shape[1] * 128, 4, 8, 128)
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
