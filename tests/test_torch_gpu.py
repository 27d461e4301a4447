"""The Hopper kernels on the card, against their plain PyTorch versions.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips when no
CUDA device is present (decided when the test runs, never at import).
On a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are the reference's: 2e-5 in f32, 3e-2 in bf16; at the
main-path shapes bf16 is also held to 2e-5 + 2 bf16 steps of the plain
value.
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
]


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
    torch.cuda.synchronize()
    assert kops.LAUNCHES == {"chunked_prefill_attention": 1,
                             "decode_attention": 1}


def test_wrappers_raise_on_what_the_kernel_does_not_take(cuda):
    q = torch.randn(1, 4, 2, 24, device=cuda)
    kv = torch.randn(1, 8, 2, 24, device=cuda)
    with pytest.raises(ValueError):
        kops.prefill_attention(q, kv, kv, torch.zeros(1), torch.ones(1))
    q16 = torch.randn(1, 4, 2, 16, device=cuda, dtype=torch.float16)
    kv16 = torch.randn(1, 8, 2, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        kops.decode_attention_op(q16[:, 0], kv16, kv16, torch.zeros(1))


@pytest.mark.parametrize("arch", ["llama31_8b", "qwen25_32b"])
def test_engine_on_card_matches_greedy(cuda, arch):
    """SMOKE model on the card: the convertible engine's tokens equal the
    port's own greedy generation, and both kernels ran."""
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
    assert all(n > 0 for n in kops.LAUNCHES.values()), kops.LAUNCHES
    for r, p in zip(reqs, prompts):
        want = tm.greedy_generate(cfg, model, p[None], [len(p)], 6)
        assert r.output == want[0].tolist(), r.rid
