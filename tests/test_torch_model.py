"""Port model against the reference package's, on the same weights.

The reference's parameters are carried across as numpy arrays through
``from_jax_params``; prefill and decode logits must agree within the
reference's model tolerance, 2e-4, on the SMOKE configs of the paper's two
evaluation models (Llama-3.1-8B, and Qwen-2.5-32B with its QKV bias and a
GQA group of 5).
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
from repro_torch.configs import LayerSpec, MambaConfig, get_config
from repro_torch.models import ops as tmops

ARCHS = ["llama31_8b", "qwen25_32b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg = jget_config(arch, smoke=True)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config(arch, smoke=True)
    model = tm.from_jax_params(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return cfg, model, jcfg, jparams


def _close(a, b, tol=2e-4):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               atol=tol, rtol=tol)


def test_prefill_then_decode_logits_match(pair):
    cfg, model, jcfg, jparams = pair
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    lens = np.array([16, 9], np.int32)
    jst = jm.init_state(jcfg, 2, 40)
    jl, jst = jm.prefill(jcfg, jparams, jst, jnp.asarray(toks),
                         jnp.asarray(lens))
    tst = tm.init_state(cfg, 2, 40, "cpu")
    tl, tst = tm.prefill(cfg, model, tst, toks, lens)
    _close(tl, jl)
    cur = lens.copy()
    last = np.asarray(jnp.argmax(jl, -1), np.int32)
    for _ in range(3):
        jl, jst = jm.decode_step(jcfg, jparams, jst, jnp.asarray(last),
                                 jnp.asarray(cur))
        tl, tst = tm.decode_step(cfg, model, tst, last, cur)
        _close(tl, jl)
        last = np.asarray(jnp.argmax(jl, -1), np.int32)
        cur = cur + 1
    # the caches themselves agree too
    jk = np.asarray(jst["blocks"]["p0"]["k"])          # (blocks, B, L, H, D)
    for i, layer in enumerate(tst):
        _close(layer["k"], jk[i])


def test_chunked_prefill_matches_whole_prompt(pair):
    """Prefilling a prompt in two chunks (start > 0, lengths absolute)
    gives the reference's logits and the whole-prompt logits."""
    cfg, model, jcfg, jparams = pair
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, cfg.vocab_size, size=(1, 14)).astype(np.int32)
    chunks = [(0, 8), (8, 14)]
    jst = jm.init_state(jcfg, 1, 32)
    tst = tm.init_state(cfg, 1, 32, "cpu")
    for a, b in chunks:
        piece = np.zeros((1, 8), np.int32)
        piece[0, :b - a] = prompt[0, a:b]
        jl, jst = jm.prefill(jcfg, jparams, jst, jnp.asarray(piece),
                             jnp.array([b], jnp.int32),
                             start=jnp.array([a], jnp.int32))
        tl, tst = tm.prefill(cfg, model, tst, piece, [b], start=[a])
        _close(tl, jl)
    whole, _ = tm.prefill(cfg, model, tm.init_state(cfg, 1, 32, "cpu"),
                          prompt, [14])
    _close(tl, whole)


def test_plain_attention_path_matches_kernel_path(pair):
    """prefill's plain-kernels option (the masked _sdpa: what chip_smoke.py
    holds the kernels' logits against on the card) equals the
    kernel-wrapper path."""
    cfg, model, _, _ = pair
    rng = np.random.RandomState(2)
    toks = rng.randint(0, cfg.vocab_size, size=(2, 8)).astype(np.int32)
    lens = [8, 5]
    a, _ = tm.prefill(cfg, model, tm.init_state(cfg, 2, 16, "cpu"), toks,
                      lens)
    b, _ = tm.prefill(cfg, model, tm.init_state(cfg, 2, 16, "cpu"), toks,
                      lens, plain_kernels=True)
    _close(a, b)


def test_greedy_generate_matches_reference(pair):
    cfg, model, jcfg, jparams = pair
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, cfg.vocab_size, size=(1, 6)).astype(np.int32)
    want = jm.greedy_generate(jcfg, jparams, jnp.asarray(prompt),
                              jnp.array([6], jnp.int32), 4)
    got = tm.greedy_generate(cfg, model, prompt, [6], 4)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_names_and_shapes_match_reference(arch):
    """Every per-layer module holds the reference's block leaves, with the
    stacked num_blocks dim split off."""
    jleaves = model_leaves(jget_config(arch, smoke=True))
    cfg = get_config(arch, smoke=True)
    model = tm.Transformer(cfg, "meta")
    for name in ("embed", "final_norm", "lm_head"):
        assert tuple(getattr(model, name).shape) == jleaves[name].shape
    blk = jleaves["blocks"]["p0"]
    assert len(model.layers) == cfg.num_layers
    for layer in model.layers:
        assert set(layer.leaves) == set(blk)
        for name, lf in blk.items():
            assert tuple(getattr(layer, name).shape) == lf.shape[1:]


def test_bf16_weights_cross_the_bridge():
    """bf16 leaves arrive as ml_dtypes.bfloat16, which torch.from_numpy
    rejects; the bridge passes them bit for bit through a uint16 view."""
    jcfg = jget_config("llama31_8b", smoke=True).replace(
        dtype="bfloat16", param_dtype="bfloat16")
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(1))
    tree = jax.tree.map(np.asarray, jparams)
    assert tree["embed"].dtype.name == "bfloat16"
    cfg = get_config("llama31_8b", smoke=True).replace(
        dtype="bfloat16", param_dtype="bfloat16")
    model = tm.from_jax_params(cfg, tree, device="cpu")
    assert model.embed.dtype == torch.bfloat16
    assert np.array_equal(model.embed.float().numpy(),
                          tree["embed"].astype(np.float32))
    assert np.array_equal(model.layers[1].w_down.float().numpy(),
                          tree["blocks"]["p0"]["w_down"][1].astype(
                              np.float32))


def test_init_params_is_seeded_and_scaled():
    cfg = get_config("llama31_8b", smoke=True)
    a = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    assert abs(a.embed.std().item() - 0.02) < 2e-3
    assert abs(a.layers[0].wq.std().item() * cfg.d_model ** 0.5 - 1) < 0.05
    assert torch.equal(a.layers[0].ln1, torch.ones(cfg.d_model))
    q = get_config("qwen25_32b", smoke=True)
    qm = tm.init_params(q, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(qm.layers[0].bk, torch.zeros(q.num_kv_heads
                                                    * q.head_dim_))


def test_cache_writes_are_checked():
    """The reference clamps an out-of-range cache write; the port refuses
    it."""
    cache = torch.zeros(1, 8, 1, 4)
    new = torch.ones(1, 4, 1, 4)
    rows = torch.arange(6, 10)[None]
    with pytest.raises(IndexError):
        tmops._update_cache(cache, new, np.array([6]), rows)
    tmops._update_cache(cache, new, np.array([4]), rows - 2)
    assert cache[0, 4:].eq(1).all() and cache[0, :4].eq(0).all()


def test_unported_layers_name_a_later_slice():
    """Every layer kind is ported, and since ROADMAP A10 forward_train runs
    over RWKV-6 layers too: nothing is left to refuse."""
    cfg = get_config("llama31_8b", smoke=True)
    tm.Transformer(cfg.replace(kv_lora_rank=64), "meta")
    tm.init_state(cfg.replace(block_pattern=(LayerSpec(mixer="mamba"),),
                              mamba=MambaConfig()), 1, 8, "meta")
    rwkv = get_config("rwkv6_3b", smoke=True)
    model = tm.init_params(rwkv, torch.Generator().manual_seed(0), "cpu")
    logits, _ = tm.forward_train(rwkv, model, [[1, 2, 3]])
    assert logits.shape == (1, 3, rwkv.vocab_size)
    assert bool(torch.isfinite(logits).all())
