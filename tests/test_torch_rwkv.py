"""The port's RWKV-6 model against the reference package's, on the same
weights.

The reference's rwkv6 SMOKE parameters are carried across as numpy
arrays, after seeded noise (scale 0.01) on ``lora_B`` and ``decay_B``,
which init to zeros: so the data-dependent token-shift mix and decay paths
run.  The reference computes WKV6 by its default path (the chunked jnp
twin of its Pallas kernel); the port's CPU path runs the same chunked
version behind ``kernels.ops.wkv6_op``.  Tolerance: the reference's model
tolerance, 2e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_config as jget_config
from repro.models.params import model_leaves, state_leaves
from repro_torch import models as tm
from repro_torch.configs import LayerSpec, MambaConfig, MoEConfig, get_config
from repro_torch.models import params as tparams

ARCH = "rwkv6_3b"


def noisy_reference_params(jcfg, seed=0):
    """The reference's seeded parameters as numpy, with noise on the two
    zero-initialised lora outputs."""
    tree = jax.tree.map(np.asarray, jm.init_params(jcfg,
                                                   jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)
    blk = tree["blocks"]["p0"]
    for name in ("lora_B", "decay_B"):
        blk[name] = (blk[name] + 0.01 * rng.randn(*blk[name].shape)).astype(
            blk[name].dtype)
    return tree


@pytest.fixture(scope="module")
def pair():
    jcfg = jget_config(ARCH, smoke=True)
    tree = noisy_reference_params(jcfg)
    cfg = get_config(ARCH, smoke=True)
    model = tm.from_jax_params(cfg, tree, device="cpu")
    return cfg, model, jcfg, jax.tree.map(jnp.asarray, tree)


def _close(a, b, tol=2e-4):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               atol=tol, rtol=tol)


def _states_close(tst, jst):
    """Per-layer port state == the reference's stacked state."""
    for i, layer in enumerate(tst):
        for key, t in layer.items():
            _close(t.numpy(), np.asarray(jst["blocks"]["p0"][key][i]))


def test_prefill_then_decode_logits_and_states_match(pair):
    cfg, model, jcfg, jparams = pair
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    lens = np.array([16, 9], np.int32)                 # row 1 padded
    jst = jm.init_state(jcfg, 2, 40)
    jl, jst = jm.prefill(jcfg, jparams, jst, jnp.asarray(toks),
                         jnp.asarray(lens))
    tst = tm.init_state(cfg, 2, 40, "cpu")
    tl, tst = tm.prefill(cfg, model, tst, toks, lens)
    _close(tl, jl)
    _states_close(tst, jst)
    cur = lens.copy()
    last = np.asarray(jnp.argmax(jl, -1), np.int32)
    for _ in range(3):
        jl, jst = jm.decode_step(jcfg, jparams, jst, jnp.asarray(last),
                                 jnp.asarray(cur))
        tl, tst = tm.decode_step(cfg, model, tst, last, cur)
        _close(tl, jl)
        last = np.asarray(jnp.argmax(jl, -1), np.int32)
        cur = cur + 1
    _states_close(tst, jst)


def test_chunked_prefill_matches_reference_and_whole_prompt(pair):
    """Two chunks (start > 0, the second padded) carry the recurrent state:
    the reference's logits and states, and the whole prompt's logits."""
    cfg, model, jcfg, jparams = pair
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, cfg.vocab_size, size=(1, 14)).astype(np.int32)
    jst = jm.init_state(jcfg, 1, 32)
    tst = tm.init_state(cfg, 1, 32, "cpu")
    for a, b in [(0, 8), (8, 14)]:
        piece = np.zeros((1, 8), np.int32)
        piece[0, :b - a] = prompt[0, a:b]
        jl, jst = jm.prefill(jcfg, jparams, jst, jnp.asarray(piece),
                             jnp.array([b], jnp.int32),
                             start=jnp.array([a], jnp.int32))
        tl, tst = tm.prefill(cfg, model, tst, piece, [b], start=[a])
        _close(tl, jl)
    _states_close(tst, jst)
    whole_st = tm.init_state(cfg, 1, 32, "cpu")
    whole, whole_st = tm.prefill(cfg, model, whole_st, prompt, [14])
    _close(tl, whole)
    for got, want in zip(tst, whole_st):
        for key in got:
            _close(got[key], want[key])


def test_decode_matches_train_forward(pair):
    """Recurrent-state decode reproduces the reference's full causal forward
    position by position (the twin of tests/test_arch_smoke.py's)."""
    cfg, model, jcfg, jparams = pair
    rng = np.random.RandomState(2)
    B, S, P0 = 2, 16, 10
    toks = rng.randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    full, _ = jm.forward_train(jcfg, jparams, jnp.asarray(toks))
    st = tm.init_state(cfg, B, S + 4, "cpu")
    lens = np.full((B,), P0, np.int32)
    pl, st = tm.prefill(cfg, model, st, toks[:, :P0], lens)
    _close(pl, full[:, P0 - 1])
    cur = lens
    for t in range(P0, S):
        dl, st = tm.decode_step(cfg, model, st, toks[:, t], cur)
        cur = cur + 1
        _close(dl, full[:, t])


def test_plain_kernels_path_matches_kernel_path(pair):
    """prefill's plain-kernels option (the chunked WKV6 that chip_smoke.py
    holds the kernel's logits against on the card) equals the wrapper
    path."""
    cfg, model, _, _ = pair
    rng = np.random.RandomState(3)
    toks = rng.randint(0, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    a, sa = tm.prefill(cfg, model, tm.init_state(cfg, 2, 8, "cpu"), toks,
                       [24, 17])
    b, sb = tm.prefill(cfg, model, tm.init_state(cfg, 2, 8, "cpu"), toks,
                       [24, 17], plain_kernels=True)
    _close(a, b)
    _close(sa[1]["wkv"], sb[1]["wkv"])


@pytest.mark.parametrize("smoke", [True, False])
def test_leaves_and_state_match_reference(smoke):
    """Names, shapes and dtypes of every per-layer leaf (the stacked
    num_blocks dim split off) and of the per-layer state."""
    jcfg = jget_config(ARCH, smoke=smoke)
    cfg = get_config(ARCH, smoke=smoke)
    jleaves = model_leaves(jcfg)
    model = tm.Transformer(cfg, "meta")
    for name in ("embed", "final_norm", "lm_head"):
        assert tuple(getattr(model, name).shape) == jleaves[name].shape
    blk = jleaves["blocks"]["p0"]
    assert len(model.layers) == cfg.num_layers
    for layer in model.layers:
        assert set(layer.leaves) == set(blk)
        for name, lf in blk.items():
            p = getattr(layer, name)
            assert tuple(p.shape) == lf.shape[1:], name
            want = lf.dtype or jcfg.param_dtype
            assert p.dtype == tparams.DTYPES[want], name
            assert layer.leaves[name].init == lf.init, name
    jstate = state_leaves(jcfg, 3, 50)["blocks"]["p0"]
    for layer in tm.init_state(cfg, 3, 50, "meta"):
        assert set(layer) == set(jstate)
        for key, lf in jstate.items():
            assert tuple(layer[key].shape) == lf.shape[1:]
            assert layer[key].dtype == tparams.DTYPES[lf.dtype]


def test_bf16_model_keeps_f32_decay_and_bonus():
    cfg = get_config(ARCH, smoke=True).replace(dtype="bfloat16",
                                               param_dtype="bfloat16")
    model = tm.Transformer(cfg, "meta")
    layer = model.layers[0]
    assert layer.w0.dtype == torch.float32 and layer.u.dtype == torch.float32
    assert layer.wr.dtype == torch.bfloat16
    st = tm.init_state(cfg, 1, 8, "meta")[0]
    assert st["wkv"].dtype == torch.float32
    assert st["shift_t"].dtype == torch.bfloat16


def test_init_params_is_seeded_with_the_reference_tags():
    cfg = get_config(ARCH, smoke=True)
    a = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    jp = jax.tree.map(np.asarray, jm.init_params(
        jget_config(ARCH, smoke=True), jax.random.PRNGKey(0)))["blocks"]["p0"]
    layer = a.layers[1]
    # every non-random leaf equals the reference's exactly
    for name in ("mu_x", "mu_g", "mu_ck", "u", "w0", "lora_B", "decay_B",
                 "lnx_g", "lnx_b", "ln1", "ln2"):
        assert np.array_equal(getattr(layer, name).numpy(), jp[name][1]), name
    d = cfg.d_model
    assert float(layer.w0[0]) == -6.0 and float(layer.w0[d - 1]) == -1.0
    assert abs(layer.wr.std().item() * d ** 0.5 - 1) < 0.05


def test_unported_layers_still_name_a_later_slice():
    """Mamba and MoE layers are ported (they build beside RWKV-6's), and
    since ROADMAP A10 so is forward_train over RWKV-6 layers: an RWKV-6
    time-mix with an MoE FFN trains forward, with its aux loss."""
    cfg = get_config(ARCH, smoke=True).replace(
        mamba=MambaConfig(), moe=MoEConfig(num_experts=4, top_k=2,
                                           d_ff_expert=64))
    for spec in (LayerSpec("mamba", "dense"), LayerSpec("rwkv", "moe")):
        model = tm.Transformer(cfg.replace(block_pattern=(spec,)), "meta")
        assert model.layers[0].spec == spec
    cfg = cfg.replace(block_pattern=(spec,))
    model = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    logits, aux = tm.forward_train(cfg, model, np.ones((1, 4), np.int32))
    assert logits.shape == (1, 4, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()) and float(aux) > 0
