"""Gradients of the port's training loss against the reference package's,
for every architecture of its registry, on the CPU at SMOKE size in f32.

``lm_loss`` and the gradient of every leaf against
``jax.value_and_grad(repro.training.lm_loss)`` on the same weights: each
reference leaf within 2e-4 of its own largest |gradient| (the reference's
logit tolerance).  The leaves that start at zero (RWKV-6's lora and decay
up-projections, biases, the cross-attention gates, ...) get small noise,
so that every path carries a gradient; the vision model is given an
image.  Also: RWKV-6's ``forward_train`` (now ported) with and without
lengths, and activation checkpointing over the recurrent and MoE layers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro import training as jt
from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro_torch import models as tm
from repro_torch import training as tt
from repro_torch.configs import get_config
from repro_torch.models.params import reference_paths

TOL = 2e-4


def _setup(arch):
    """(cfg, model, reference cfg, reference params, tokens, labels,
    image or None), zero leaves given noise."""
    jcfg = jget_config(arch, smoke=True)
    rng = np.random.RandomState(7)
    tree = jax.tree.map(np.asarray, jm.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    tree = jax.tree.map(lambda a: (0.05 * rng.randn(*a.shape)).astype(
        a.dtype) if not a.any() else a, tree)
    cfg = get_config(arch, smoke=True)
    model = tm.from_jax_params(cfg, tree, device="cpu")
    toks = rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    img = rng.randn(2, cfg.num_vision_tokens, cfg.d_model).astype(
        np.float32) if cfg.num_vision_tokens else None
    return cfg, model, jcfg, jax.tree.map(jnp.asarray, tree), toks, labels, \
        img


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return np.asarray(tree)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_every_gradient_match_reference(arch):
    cfg, model, jcfg, jparams, toks, labels, img = _setup(arch)
    jimg = None if img is None else jnp.asarray(img)
    (jloss, jparts), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jt.lm_loss(jcfg, p, jnp.asarray(toks), jnp.asarray(labels),
                             jimg), has_aux=True))(jparams)
    model.requires_grad_(True)
    loss, parts = tt.lm_loss(cfg, model, toks, labels,
                             None if img is None else torch.from_numpy(img))
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    assert float(parts["aux"].detach()) == pytest.approx(
        float(jparts["aux"]), rel=1e-4, abs=1e-7)
    paths = reference_paths(model)
    assert len(paths) == len(jax.tree.leaves(jgrads))
    for path, (names, stacked) in paths.items():
        want = _leaf(jgrads, path)
        got = np.stack([grads[n].numpy() for n in names]) if stacked \
            else grads[names[0]].numpy()
        assert got.shape == want.shape, path
        scale = np.abs(want).max()
        assert scale > 0, f"{path}: no gradient in the reference"
        assert np.abs(got - want).max() <= TOL * scale, path


@pytest.mark.parametrize("lengths", [None, [16, 11]], ids=["full", "lengths"])
def test_rwkv_forward_train_matches_reference(lengths):
    """RWKV-6 in train mode: from a zero shift and state, nothing written;
    with lengths, no decay and no writes past each row's length."""
    cfg, model, jcfg, jparams, toks, _, _ = _setup("rwkv6_3b")
    want, _ = jm.forward_train(
        jcfg, jparams, jnp.asarray(toks),
        lengths=None if lengths is None else jnp.asarray(lengths))
    got, aux = tm.forward_train(cfg, model, toks, lengths=lengths)
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("arch", ["rwkv6_3b", "jamba_v0_1_52b",
                                  "deepseek_v2_lite_16b"])
def test_remat_keeps_loss_and_grads(arch):
    """Checkpointing each layer recomputes WKV6, Mamba's scan and the MoE
    router in the backward: the same loss and gradients."""
    cfg, model, _, _, toks, labels, _ = _setup(arch)
    model.requires_grad_(True)
    out = []
    for remat in (False, True):
        loss, parts = tt.lm_loss(cfg, model, toks, labels, remat=remat)
        out.append((float(loss.detach()), float(parts["aux"].detach()),
                    torch.autograd.grad(loss, list(model.parameters()))))
    assert out[0][:2] == out[1][:2]
    for a, b in zip(out[0][2], out[1][2]):
        assert torch.equal(a, b)
