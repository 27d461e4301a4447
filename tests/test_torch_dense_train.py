"""``forward_train`` in the port against the reference package.

Every dense attention config the port has runs at its SMOKE size on the
reference's weights (``from_jax_params``): the port's full-sequence
forward equals the reference's within 2e-4, and the port's own prefill +
decode reproduce it position by position (the twin of
tests/test_arch_smoke.py's test_decode_matches_train_forward).  Also: the
leaves of every new config, and ``abstract_params`` on ``meta``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_config as jget_config
from repro.models.params import model_leaves
from repro_torch import models as tm
from repro_torch.configs import get_config

NEW = ["gemma2_9b", "gemma_2b", "yi_9b", "qwen2_0_5b", "musicgen_large"]
DENSE = ["llama31_8b", "qwen25_32b"] + NEW
TOL = 2e-4


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def _pair(arch):
    jcfg = jget_config(arch, smoke=True)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config(arch, smoke=True)
    model = tm.from_jax_params(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return cfg, model, jcfg, jparams


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    return _pair(request.param)


def test_train_forward_matches_reference_and_decode(pair):
    """The twin of tests/test_arch_smoke.py's
    test_decode_matches_train_forward: the port's forward_train equals the
    reference's, and the port's own prefill + decode reproduce its
    forward_train position by position."""
    cfg, model, jcfg, jparams = pair
    B, S, P0 = 2, 16, 10
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                                         cfg.vocab_size), np.int32)
    want, jaux = jm.forward_train(jcfg, jparams, jnp.asarray(toks))
    full, aux = tm.forward_train(cfg, model, toks)
    assert full.shape == (B, S, cfg.vocab_size) and full.dtype == torch.float32
    assert float(aux) == float(jaux) == 0.0
    _close(full, want)
    st = tm.init_state(cfg, B, S + 4, "cpu")
    lens = np.full((B,), P0, np.int32)
    pl, st = tm.prefill(cfg, model, st, toks[:, :P0], lens)
    _close(pl, full[:, P0 - 1])
    cur = lens
    for t in range(P0, S):
        dl, st = tm.decode_step(cfg, model, st, toks[:, t], cur)
        cur = cur + 1
        _close(dl, full[:, t])


@pytest.mark.parametrize("arch", ["gemma2_9b", "llama31_8b"])
def test_train_forward_with_lengths_matches_reference(arch):
    """lengths mask the keys at or past each row's valid length (gemma2's
    window of 64 bites at 80 tokens)."""
    cfg, model, jcfg, jparams = _pair(arch)
    rng = np.random.RandomState(4)
    toks = rng.randint(0, cfg.vocab_size, size=(2, 80)).astype(np.int32)
    lens = np.array([80, 70], np.int32)
    want, _ = jm.forward_train(jcfg, jparams, jnp.asarray(toks),
                               lengths=jnp.asarray(lens))
    got, _ = tm.forward_train(cfg, model, toks, lengths=lens)
    _close(got, want)


@pytest.mark.parametrize("arch", NEW)
def test_leaves_and_abstract_params_match_reference(arch):
    """abstract_params is the model on `meta` (no memory): its leaves are
    the reference's, stacked dim split off, tied embeddings without an
    lm_head and Gemma-2's post-norms included."""
    for smoke in (True, False):
        jleaves = model_leaves(jget_config(arch, smoke=smoke))
        cfg = get_config(arch, smoke=smoke)
        model = tm.abstract_params(cfg)
        assert model.embed.device.type == "meta"
        top = {"embed", "final_norm"} | (set() if cfg.tie_embeddings
                                         else {"lm_head"})
        assert set(model.leaves) == top
        for name in top:
            assert tuple(getattr(model, name).shape) == jleaves[name].shape
        blocks = jleaves["blocks"]
        for i, layer in enumerate(model.layers):
            blk = blocks[f"p{i % len(blocks)}"]
            assert set(layer.leaves) == set(blk)
            for name, lf in blk.items():
                assert tuple(getattr(layer, name).shape) == lf.shape[1:]
        if not smoke:
            n = tm.count_params(model)
            assert n == sum(int(np.prod(lf.shape)) for lf in
                            jax.tree.leaves(jleaves, is_leaf=lambda x:
                                            hasattr(x, "init")))
    if arch == "gemma2_9b":
        assert "ln1_post" in model.layers[0].leaves
        assert 9.0e9 < tm.count_params(model) < 9.5e9


def test_recurrent_models_are_refused():
    with pytest.raises(NotImplementedError, match="later slice"):
        tm.forward_train(get_config("rwkv6_3b", smoke=True),
                         tm.abstract_params(get_config("rwkv6_3b",
                                                       smoke=True)),
                         np.zeros((1, 4), np.int32))
