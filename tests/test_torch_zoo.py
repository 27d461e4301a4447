"""The rest of the layer zoo in the port against the reference package:
MLA latent attention (DeepSeek-V2-Lite), MoE with shared experts and a
dense prefix layer (DeepSeek-V2-Lite, Kimi K2), Mamba + MoE + attention
(Jamba) and cross-attention to an image (Llama-3.2-Vision), at their SMOKE
size on the reference's weights carried across by ``from_jax_params``.

Tolerance: the reference's model tolerance, 2e-4 (atol and rtol), on the
logits of a padded prefill and three decode steps, on ``forward_train``'s
logits and on the MoE aux loss; on the layers alone (the router, the dense
MoE path, Mamba over a padded chunk from a carried state) 2e-5, the f32
kernel tolerance, since no model depth amplifies them.  The routing
choices (top-k indices) must be equal.  The zero-initialised leaves that
would hide a path get seeded noise on both sides: the cross-attention
``gate`` (tanh(0) silences the layer) and Mamba's ``conv_b``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_config as jget_config
from repro.models import ops as jops
from repro_torch import models as tm
from repro_torch.configs import get_config
from repro_torch.models import ops as tops

ZOO = ["deepseek_v2_lite_16b", "kimi_k2_1t_a32b", "jamba_v0_1_52b",
       "llama_3_2_vision_11b", "kimi-d112"]
#: cases of ZOO that are a config with overrides: Kimi K2's SMOKE model at
#: its published head dim, 112 (d_model 448 over its 4 / 2 heads)
VARIANTS = {"kimi-d112": ("kimi_k2_1t_a32b", {"d_model": 448})}
TOL = 2e-4
LAYER_TOL = 2e-5
NOISY = {"gate": 1.0, "conv_b": 0.1}   # leaf name -> noise scale


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def noisy_reference_tree(jcfg, seed=7):
    """The reference's init_params as numpy, with seeded noise on the
    leaves named in NOISY."""
    tree = jax.tree.map(np.array, jm.init_params(jcfg,
                                                 jax.random.PRNGKey(0)))
    rng = np.random.RandomState(seed)

    def visit(t):
        for name, leaf in t.items():
            if isinstance(leaf, dict):
                visit(leaf)
            elif name in NOISY:
                t[name] = (leaf + NOISY[name] * rng.standard_normal(
                    leaf.shape)).astype(leaf.dtype)
    visit(tree)
    return tree


def pair(arch, **over):
    jcfg = jget_config(arch, smoke=True).replace(**over)
    tree = noisy_reference_tree(jcfg)
    cfg = get_config(arch, smoke=True).replace(**over)
    model = tm.from_jax_params(cfg, tree, device="cpu")
    return cfg, model, jcfg, jax.tree.map(jnp.asarray, tree)


def images(cfg, B, seed=3):
    if not cfg.num_vision_tokens:
        return None
    return np.random.RandomState(seed).standard_normal(
        (B, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module", params=ZOO)
def zoo(request):
    arch, over = VARIANTS.get(request.param, (request.param, {}))
    return (arch, *pair(arch, **over))


def test_prefill_then_decode_logits_match(zoo):
    """A padded prefill (rows of 16 and 9 valid tokens in 16) and three
    greedy decode steps, logits compared at each; the states after them
    too."""
    arch, cfg, model, jcfg, jparams = zoo
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    lens = np.array([16, 9], np.int32)
    ie = images(cfg, 2)
    jst = jm.init_state(jcfg, 2, 40)
    jl, jst = jm.prefill(jcfg, jparams, jst, jnp.asarray(toks),
                         jnp.asarray(lens),
                         None if ie is None else jnp.asarray(ie))
    tst = tm.init_state(cfg, 2, 40, "cpu")
    tl, tst = tm.prefill(cfg, model, tst, toks, lens, ie)
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
    for i, layer in enumerate(tst):
        if i < cfg.first_k_dense:
            want = jst["prefix"][f"l{i}"]
        else:
            blk, j = divmod(i - cfg.first_k_dense, len(cfg.block_pattern))
            want = jax.tree.map(lambda a: a[blk], jst["blocks"][f"p{j}"])
        assert set(layer) == set(want)
        for key, leaf in layer.items():
            _close(leaf.float(), np.asarray(want[key], np.float32))


@pytest.mark.parametrize("lengths", [None, (16, 11)],
                         ids=["full", "lengths"])
def test_forward_train_logits_and_aux_match(zoo, lengths):
    """Every position's logits and the summed MoE aux loss (0 without
    MoE) of ``forward_train``, with and without per-row lengths."""
    arch, cfg, model, jcfg, jparams = zoo
    toks = np.random.RandomState(1).randint(
        0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    ie = images(cfg, 2)
    lens = None if lengths is None else np.array(lengths, np.int32)
    jl, jaux = jm.forward_train(
        jcfg, jparams, jnp.asarray(toks),
        image_embeds=None if ie is None else jnp.asarray(ie),
        lengths=None if lens is None else jnp.asarray(lens))
    tl, taux = tm.forward_train(cfg, model, toks, ie, lens)
    _close(tl, jl)
    _close(taux, jaux)
    assert (float(taux) > 0) == bool(cfg.moe)


def test_chunked_prefill_matches_whole(zoo):
    """The same prompt prefilled in chunks of 8 from its carried state
    (MLA's latent cache, Mamba's conv / ssm states) gives the reference's
    chunked logits at every chunk.  The vision model re-reads its image at
    every chunk, as the reference does."""
    arch, cfg, model, jcfg, jparams = zoo
    prompt = np.random.RandomState(2).randint(
        0, cfg.vocab_size, size=(1, 21)).astype(np.int32)
    ie = images(cfg, 1)
    jst = jm.init_state(jcfg, 1, 32)
    tst = tm.init_state(cfg, 1, 32, "cpu")
    for a in range(0, 21, 8):
        b = min(a + 8, 21)
        piece = np.zeros((1, 8), np.int32)
        piece[0, :b - a] = prompt[0, a:b]
        jl, jst = jm.prefill(jcfg, jparams, jst, jnp.asarray(piece),
                             jnp.array([b], jnp.int32),
                             None if ie is None else jnp.asarray(ie),
                             start=jnp.array([a], jnp.int32))
        tl, tst = tm.prefill(cfg, model, tst, piece, [b], ie, start=[a])
        _close(tl, jl)


# ---------------------------------------------------------------------------
# the layers alone
# ---------------------------------------------------------------------------

def _layer(arch, kind):
    """(cfg, the port's first layer whose spec has `kind`, the reference's
    leaves of it, jcfg)."""
    cfg, model, jcfg, jparams = pair(arch)
    for i, (spec, layer) in enumerate(zip(cfg.layer_specs, model.layers)):
        if kind in (spec.mixer, spec.ffn):
            blk, j = divmod(i - cfg.first_k_dense, len(cfg.block_pattern))
            p = jax.tree.map(lambda a: a[blk], jparams["blocks"][f"p{j}"])
            return cfg, layer, p, jcfg
    raise AssertionError(kind)


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "jamba_v0_1_52b"])
def test_router_and_dense_moe_path_match(arch):
    """`_router` (renormalised top-k probabilities, the same expert
    indices, the Switch aux loss) and `_moe_dense_path` on 3 x 10 tokens,
    then the whole `apply_moe_ffn` with its shared experts."""
    cfg, layer, p, jcfg = _layer(arch, "moe")
    h = np.random.RandomState(4).standard_normal(
        (3, 10, cfg.d_model)).astype(np.float32)
    jp, ji, jaux = jops._router(jcfg, p, jnp.asarray(h))
    tp, ti, taux = tops._router(cfg, layer, torch.from_numpy(h))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    _close(tp, jp, LAYER_TOL)
    _close(taux, jaux, LAYER_TOL)
    _close(tops._moe_dense_path(cfg, layer, torch.from_numpy(h), tp, ti),
           jops._moe_dense_path(jcfg, p, jnp.asarray(h), jp, ji), LAYER_TOL)
    got, got_aux = tops.apply_moe_ffn(cfg, layer, torch.from_numpy(h))
    want, want_aux = jops.apply_moe_ffn(jcfg, p, jnp.asarray(h))
    _close(got, want, LAYER_TOL)
    _close(got_aux, want_aux, LAYER_TOL)


def test_mamba_padded_chunk_from_a_carried_state():
    """A chunk of 8 at start 5 for two rows, from a random carried state:
    row 0 has 3 valid tokens in it (absolute length 8), row 1 all 8.
    Outputs, the ssm state and the conv state equal the reference's, and
    the conv state is the last d_conv - 1 valid inputs of the chunk (for
    row 0 the chunk's inputs 0..2, not its padding)."""
    cfg, layer, p, jcfg = _layer("jamba_v0_1_52b", "mamba")
    mc = cfg.mamba
    di, K = mc.expand * cfg.d_model, mc.d_conv
    rng = np.random.RandomState(5)
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    ssm = rng.standard_normal((2, di, mc.d_state)).astype(np.float32)
    conv = rng.standard_normal((2, K - 1, di)).astype(np.float32)
    pos = (5 + np.arange(8))[None].repeat(2, 0).astype(np.int32)
    lens = np.array([8, 13], np.int32)
    jout, jst = jops.apply_mamba(
        jcfg, p, jnp.asarray(x), {"ssm": jnp.asarray(ssm),
                                  "conv": jnp.asarray(conv)},
        jops.ApplyCtx(mode="prefill", positions=jnp.asarray(pos),
                      lengths=jnp.asarray(lens)))
    st = {"ssm": torch.from_numpy(ssm.copy()),
          "conv": torch.from_numpy(conv.copy())}
    tout, st = tops.apply_mamba(
        cfg, layer, torch.from_numpy(x), st,
        tops.ApplyCtx(mode="prefill", positions=torch.from_numpy(pos),
                      write_idx=pos[:, 0], lengths=torch.from_numpy(lens)))
    _close(tout, jout, LAYER_TOL)
    _close(st["ssm"], jst["ssm"], LAYER_TOL)
    _close(st["conv"], jst["conv"], LAYER_TOL)
    h = tops.rmsnorm(torch.from_numpy(x), layer.ln1)
    xi = (h @ layer.in_proj)[..., :di]
    assert torch.allclose(st["conv"][0], xi[0, 3 - (K - 1):3], atol=1e-6)
    assert torch.allclose(st["conv"][1], xi[1, 8 - (K - 1):8], atol=1e-6)


def test_mamba_decode_steps_continue_the_scan():
    """A prompt's Mamba layer run whole equals the same prompt run as a
    prefix and then one token at a time from the carried state (decode
    mode, no lengths)."""
    cfg, layer, _, _ = _layer("jamba_v0_1_52b", "mamba")
    mc = cfg.mamba
    di = mc.expand * cfg.d_model
    x = torch.from_numpy(np.random.RandomState(6).standard_normal(
        (1, 6, cfg.d_model)).astype(np.float32))

    def state():
        return {"ssm": torch.zeros(1, di, mc.d_state),
                "conv": torch.zeros(1, mc.d_conv - 1, di)}

    def ctx(mode, a, b):
        pos = np.arange(a, b)[None]
        return tops.ApplyCtx(mode=mode, positions=torch.from_numpy(pos),
                             write_idx=pos[:, 0])

    whole, _ = tops.apply_mamba(cfg, layer, x, state(), ctx("prefill", 0, 6))
    st = state()
    parts = [tops.apply_mamba(cfg, layer, x[:, :3], st,
                              ctx("prefill", 0, 3))[0]]
    for t in range(3, 6):
        parts.append(tops.apply_mamba(cfg, layer, x[:, t:t + 1], st,
                                      ctx("decode", t, t + 1))[0])
    _close(torch.cat(parts, 1), whole, LAYER_TOL)


def test_cross_attention_keeps_the_image_for_decode():
    """Prefill writes the image's normed keys and its values into the
    layer's state; decode reads them back; the output scales with
    tanh(gate) and changes with the image."""
    cfg, layer, p, jcfg = _layer("llama_3_2_vision_11b", "cross_attn")
    rng = np.random.RandomState(8)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    ie = images(cfg, 2)
    n, nkv, dh = cfg.num_vision_tokens, cfg.num_kv_heads, cfg.head_dim_
    st = {"xk": torch.zeros(2, n, nkv, dh), "xv": torch.zeros(2, n, nkv, dh)}
    pos = np.arange(5)[None].repeat(2, 0)
    ctx = tops.ApplyCtx(mode="prefill", positions=torch.from_numpy(pos),
                        write_idx=pos[:, 0], image_embeds=torch.from_numpy(ie))
    out, st = tops.apply_cross_attn(cfg, layer, torch.from_numpy(x), st, ctx)
    jctx = jops.ApplyCtx(mode="prefill", positions=jnp.asarray(pos),
                         image_embeds=jnp.asarray(ie))
    jout, jst = jops.apply_cross_attn(
        jcfg, p, jnp.asarray(x), {"xk": jnp.zeros((2, n, nkv, dh)),
                                  "xv": jnp.zeros((2, n, nkv, dh))}, jctx)
    _close(out, jout, LAYER_TOL)
    _close(st["xk"], jst["xk"], LAYER_TOL)
    _close(st["xv"], jst["xv"], LAYER_TOL)
    dctx = tops.ApplyCtx(mode="decode", positions=torch.full((2, 1), 5),
                         write_idx=np.full(2, 5))
    dout, _ = tops.apply_cross_attn(cfg, layer, torch.from_numpy(x[:, :1]),
                                    st, dctx)
    _close(dout, out[:, :1], LAYER_TOL)
    other = dict(ctx.__dict__, image_embeds=torch.from_numpy(images(cfg, 2,
                                                                    9)))
    out2, _ = tops.apply_cross_attn(cfg, layer, torch.from_numpy(x), None,
                                    tops.ApplyCtx(**other))
    assert (out2 - out).abs().max() > 1e-3
    with torch.no_grad():
        layer.gate.zero_()
    silent, _ = tops.apply_cross_attn(cfg, layer, torch.from_numpy(x), None,
                                      ctx)
    assert silent.abs().max() == 0
