"""The chunk-parallel WKV6 kernel's arithmetic on the CPU.

``kernels/ref.py wkv6_segmented`` computes WKV6 in the kernel's three passes
over segments (each segment's decay and state contribution, the scan over
segments, each segment's outputs from its entering state).  On inputs made
from a seed with numpy it is held against the reference package's Pallas
kernel in interpret mode and its sequential oracle at the reference's 2e-4
(1e-4 for the zero-key identity), at one segment, two, many and a ragged
last one.  The segment rule the wrapper uses is checked at the main-path
shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = 2e-4


def _inputs(B, S, H, K, seed):
    """tests/test_kernels.py's inputs: (B,S,H,K) r, k, v, w in (0, 1),
    u (H,K), s0 (B,H,K,K)."""
    rng = np.random.RandomState(seed)
    r = rng.randn(B, S, H, K).astype(np.float32)
    k = rng.randn(B, S, H, K).astype(np.float32)
    v = rng.randn(B, S, H, K).astype(np.float32)
    w = np.exp(-np.exp(rng.randn(B, S, H, K).astype(np.float32) * 0.5 - 1))
    u = rng.randn(H, K).astype(np.float32)
    s0 = rng.randn(B, H, K, K).astype(np.float32)
    return r, k, v, w, u, s0


def _bhsk(a):
    return np.asarray(a).transpose(0, 2, 1, 3)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


SEGMENT_CASES = {
    # id: (B, S, H, K, chunk, segment)
    "one-segment": (1, 16, 1, 8, 16, 64),
    "two-segments": (2, 32, 2, 16, 8, 16),
    "many-segments": (1, 128, 2, 32, 16, 16),
    "ragged-last-segment": (2, 37, 2, 16, 16, 16),
    "ragged-last-chunk": (1, 100, 1, 16, 8, 32),
    "chunk-32": (1, 64, 4, 32, 32, 32),
}


@pytest.mark.parametrize("case", list(SEGMENT_CASES))
def test_segmented_matches_reference_and_oracle(case):
    B, S, H, K, chunk, segment = SEGMENT_CASES[case]
    args = _inputs(B, S, H, K, seed=B * 100 + S)
    y, sT = tref.wkv6_segmented(*map(torch.from_numpy, args), chunk=chunk,
                                segment=segment)
    jy, jsT = jops.wkv6_op(*map(jnp.asarray, args), chunk=chunk)
    r, k, v, w, u, s0 = args
    oy, osT = jref.wkv6_ref(*(jnp.asarray(_bhsk(a)) for a in (r, k, v, w)),
                            jnp.asarray(u), jnp.asarray(s0))
    for got, want in ((y, jy), (sT, jsT), (y, _bhsk(oy)), (sT, osT)):
        _close(got.numpy(), want)


def test_segmented_rejects_a_segment_of_part_chunks():
    args = map(torch.from_numpy, _inputs(1, 32, 1, 8, seed=1))
    with pytest.raises(ValueError):
        tref.wkv6_segmented(*args, chunk=16, segment=24)


@pytest.mark.parametrize("b,s,h,k,segment", [(1, 40, 1, 8, 16),
                                             (2, 7, 2, 16, 16),
                                             (3, 70, 1, 16, 32)])
def test_segmented_zero_key_is_identity(b, s, h, k, segment):
    """k = 0 writes nothing: the state is the decayed initial state."""
    rng = np.random.RandomState(b * s)
    r = rng.randn(b, s, h, k).astype(np.float32)
    kk = np.zeros((b, s, h, k), np.float32)
    v = rng.randn(b, s, h, k).astype(np.float32)
    w = np.full((b, s, h, k), 0.5 ** (1 / 8), np.float32)
    u = rng.randn(h, k).astype(np.float32)
    s0 = rng.randn(b, h, k, k).astype(np.float32)
    _, sT = tref.wkv6_segmented(*map(torch.from_numpy, (r, kk, v, w, u, s0)),
                                chunk=8, segment=segment)
    _close(sT.numpy(), s0 * w[0, 0, 0, 0] ** s, 1e-4)


def test_segmented_state_carry_composes():
    """Two calls with the state carried == one call over the whole
    sequence, each cut into its own segments."""
    r, k, v, w, u, s0 = map(torch.from_numpy, _inputs(1, 96, 2, 16, seed=7))
    y_full, sT_full = tref.wkv6_segmented(r, k, v, w, u, s0, chunk=8,
                                          segment=32)
    y1, s_mid = tref.wkv6_segmented(r[:, :40], k[:, :40], v[:, :40],
                                    w[:, :40], u, s0, chunk=8, segment=16)
    y2, sT = tref.wkv6_segmented(r[:, 40:], k[:, 40:], v[:, 40:], w[:, 40:],
                                 u, s_mid, chunk=8, segment=16)
    _close(torch.cat([y1, y2], 1).numpy(), y_full.numpy())
    _close(sT.numpy(), sT_full.numpy())


@pytest.mark.parametrize("S,B,H,chunk,want", [
    (1024, 1, 40, 16, (64, 16)),    # an RWKV-6 3B prompt: 640 blocks
    (1536, 1, 40, 16, (64, 24)),    # a burst prompt
    (4096, 1, 40, 16, (64, 64)),    # a long prompt: the scan runs 64 long
    (256, 1, 40, 16, (16, 16)),     # a convertible chunk
    (8, 1, 40, 16, (16, 1)),        # a ragged tail: one segment
    (1024, 4, 40, 16, (64, 16)),
    (100, 1, 2, 37, (37, 3)),       # a chunk that is no power of two
])
def test_segment_rule_at_the_main_shapes(S, B, H, chunk, want):
    assert tops.wkv6_segment(S, B, H, chunk) == want


def test_segment_rule_depends_on_shapes_alone():
    """The rule takes integers only; its segment is a whole number of
    chunks, at most max(64, chunk), and its segments cover S."""
    for S in (1, 7, 16, 100, 1000, 5000):
        for B, H in ((1, 1), (1, 40), (4, 40), (16, 64)):
            for chunk in (1, 8, 16, 37, 64):
                seg, nseg = tops.wkv6_segment(S, B, H, chunk)
                assert seg % chunk == 0
                assert seg <= max(tops.WKV_SEG_MAX, chunk)
                assert (nseg - 1) * seg < S <= nseg * seg
                assert (seg, nseg) == tops.wkv6_segment(S, B, H, chunk)
