"""The port's training substrate against the reference package's, on the
CPU, at SMOKE size in f32: the twins of tests/test_training.py (schedule,
the manual AdamW step, clipping, factored state, loss drop, the data
pipeline, checkpoints, restore-and-continue, remat), then parity with the
reference (``lr_at``, ``adamw_update`` at 1e-6 on the same params, grads
and state, ``global_norm``, a 5-step ``train`` from the same params within
1e-4), ``to_jax_params`` as the exact inverse of ``from_jax_params``,
checkpoints crossing between the packages both ways (bf16 included),
``torch.autograd.gradcheck`` of the two differentiable kernel wrappers in
f64, the launcher and the example.  The gradients of every config's loss
are in test_torch_train_zoo.py.
"""
import json
import os
import subprocess
import sys

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
from repro_torch.examples import train_small_model
from repro_torch.kernels import ops as kops
from repro_torch.training import (AdamWConfig, DataConfig, PackedDataset,
                                  adamw_init, adamw_update, lr_at, restore,
                                  save, train)

ROOT = os.path.join(os.path.dirname(__file__), "..")
BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")


def _pair(arch, **over):
    """(port cfg, port model, reference cfg, reference params) with the
    same weights."""
    jcfg = jget_config(arch, smoke=True).replace(**over)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config(arch, smoke=True).replace(**over)
    return cfg, tm.from_jax_params(cfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu"), jcfg, jparams


def _bits(a):
    """A leaf's raw bits: bf16 (ml_dtypes or |V2) as uint16."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name in ("bfloat16", "void16") \
        else a


def _equal_trees(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert np.asarray(x).shape == np.asarray(y).shape
        assert np.array_equal(_bits(x), _bits(y))


# ---------------------------------------------------------------------------
# twins of tests/test_training.py
# ---------------------------------------------------------------------------

def test_lr_schedule():
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    assert float(lr_at(cfg, 0)) == 0.0
    assert float(lr_at(cfg, 10)) == pytest.approx(1e-3, rel=1e-3)
    assert float(lr_at(cfg, 100)) == pytest.approx(1e-4, rel=1e-3)
    vals = [float(lr_at(cfg, s)) for s in range(10, 101, 10)]
    assert all(a >= b for a, b in zip(vals, vals[1:]))


def test_adamw_against_manual_step():
    cfg = AdamWConfig(lr=0.1, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                      grad_clip=0.0, warmup_steps=0, total_steps=1,
                      min_lr_ratio=1.0)
    p = {"w": torch.tensor([1.0, 2.0])}
    g = {"w": torch.tensor([0.5, -0.5])}
    opt = adamw_init(p, cfg)
    p2, opt2, m = adamw_update(cfg, g, opt, p)
    want = np.array([1.0, 2.0]) - 0.1 * np.sign([0.5, -0.5])
    np.testing.assert_allclose(p2["w"].numpy(), want, atol=1e-4)
    assert int(opt2.step) == 1


def test_grad_clip():
    cfg = AdamWConfig(lr=0.0, grad_clip=1.0)
    p = {"w": torch.ones(4)}
    g = {"w": torch.full((4,), 100.0)}
    opt = adamw_init(p, cfg)
    _, _, m = adamw_update(cfg, g, opt, p)
    assert float(m["grad_norm"]) == pytest.approx(200.0)


def test_factored_adamw_state_shapes():
    cfg = AdamWConfig(factored=True, moment_dtype="bfloat16")
    p = {"w": torch.zeros(4, 6, 8), "b": torch.zeros(5)}
    opt = adamw_init(p, cfg)
    vr, vc = opt.v["w"]
    assert vr.shape == (4, 6) and vc.shape == (4, 8)
    assert vr.dtype == torch.bfloat16
    assert opt.v["b"].shape == (5,)          # 1D stays unfactored
    g = {k: torch.ones_like(x) for k, x in p.items()}
    p2, opt2, _ = adamw_update(cfg, g, opt, p)
    assert p2["w"].shape == (4, 6, 8)
    assert opt2.v["w"][0].shape == (4, 6)


def test_loss_drops_on_synthetic_corpus():
    cfg = get_config("gemma_2b", smoke=True)
    _, res = train(cfg, steps=25, batch=8, seq_len=64, log_every=0,
                   device="cpu")
    assert res.losses[-1] < res.losses[0] - 0.2


def test_data_pipeline_deterministic_and_resumable():
    dc = DataConfig(vocab_size=512, seq_len=32, global_batch=4, seed=9)
    ds1, ds2 = PackedDataset(dc), PackedDataset(dc)
    t1, l1 = ds1.batch(17)
    t2, l2 = ds2.batch(17)
    assert np.array_equal(t1, t2) and np.array_equal(l1, l2)
    assert np.array_equal(t1[:, 1:], l1[:, :-1])
    assert t1.min() >= 0 and t1.max() < 512
    want = jt.PackedDataset(jt.DataConfig(512, 32, 4, 9)).batch(17)
    assert np.array_equal(t1, want[0]) and np.array_equal(l1, want[1])


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": {"b": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "c": [np.ones((4,), np.int32), np.zeros((2, 2))],
            "t": torch.arange(4, dtype=torch.bfloat16)}
    save(str(tmp_path / "ck"), tree, step=42)
    got, step = restore(str(tmp_path / "ck"), like=tree)
    assert step == 42
    np.testing.assert_array_equal(got["a"]["b"], tree["a"]["b"])
    np.testing.assert_array_equal(got["c"][0], tree["c"][0])
    assert got["t"].dtype == torch.bfloat16 and torch.equal(got["t"],
                                                            tree["t"])


def test_checkpoint_restores_training(tmp_path):
    cfg = get_config("qwen2_0_5b", smoke=True)
    params, res = train(cfg, steps=3, batch=2, seq_len=16, log_every=0,
                        device="cpu")
    save(str(tmp_path / "ck"), params, step=3)
    got, step = restore(str(tmp_path / "ck"), like=params)
    assert step == 3
    for (n, a), (m, b) in zip(params.named_parameters(),
                              got.named_parameters()):
        assert n == m and torch.equal(a.detach(), b)
    # and the next step from either gives the same loss
    opt_cfg = AdamWConfig(total_steps=10, warmup_steps=5)
    toks, labels = PackedDataset(DataConfig(cfg.vocab_size, 16, 2)).batch(3)
    step_fn = tt.make_train_step(cfg, opt_cfg, device="cpu")
    losses = [float(step_fn(p, adamw_init(p, opt_cfg), toks, labels)[2]
                    ["loss"]) for p in (params, got)]
    assert losses[0] == losses[1]


def test_remat_preserves_loss():
    """Activation checkpointing changes memory, not math."""
    cfg, model, _, _ = _pair("llama31_8b")
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 16))
    labels = np.roll(toks, -1, 1)
    model.requires_grad_(True)
    out = []
    for remat in (False, True):
        loss, _ = tt.lm_loss(cfg, model, toks, labels, remat=remat)
        out.append((loss.detach(), torch.autograd.grad(
            loss, list(model.parameters()))))
    assert float(abs(out[0][0] - out[1][0])) < 1e-5
    assert max(float((a - b).abs().max())
               for a, b in zip(out[0][1], out[1][1])) < 1e-4


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

def test_lr_at_matches_reference():
    for cfg in (AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100),
                AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=40,
                            min_lr_ratio=0.0)):
        jcfg = jt.AdamWConfig(**cfg.__dict__)
        got = np.array([float(lr_at(cfg, s)) for s in range(0, 121)])
        want = np.array([float(jt.lr_at(jcfg, s)) for s in range(0, 121)])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _leaves(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(3, 6, 8).astype(np.float32),
            "m": rng.randn(7, 5).astype(np.float32),
            "b": rng.randn(9).astype(np.float32),
            "s": np.float32(rng.randn())}


@pytest.mark.parametrize("over", [
    {}, {"moment_dtype": "bfloat16"},
    {"factored": True}, {"factored": True, "moment_dtype": "bfloat16"}],
    ids=["f32", "bf16-moments", "factored", "factored-bf16"])
def test_adamw_update_matches_reference(over):
    """Three steps of adamw_update from the same params, grads and state
    (the state after each step is the one each package made) at 1e-6; the
    grad norm exceeds the clip, so the clip scale is exercised."""
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, **over)
    jcfg = jt.AdamWConfig(**cfg.__dict__)
    p = {k: torch.tensor(v) for k, v in _leaves(0).items()}
    jp = {k: jnp.asarray(v) for k, v in _leaves(0).items()}
    opt, jopt = adamw_init(p, cfg), jt.adamw_init(jp, jcfg)
    for i in range(3):
        g = _leaves(1 + i)
        p, opt, m = adamw_update(cfg, {k: torch.tensor(v)
                                       for k, v in g.items()}, opt, p)
        jp, jopt, jm_ = jt.adamw_update(jcfg, {k: jnp.asarray(v) for k, v
                                               in g.items()}, jopt, jp)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm_["grad_norm"]), rel=1e-6)
        assert float(m["lr"]) == pytest.approx(float(jm_["lr"]), rel=1e-6)
        for k in p:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(opt.m[k].float().numpy(),
                                       np.asarray(jopt.m[k], np.float32),
                                       rtol=1e-6, atol=1e-6)
            for a, b in zip(jax.tree.leaves(opt.v[k]),
                            jax.tree.leaves(jopt.v[k])):
                np.testing.assert_allclose(a.float().numpy(),
                                           np.asarray(b, np.float32),
                                           rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("arch", ["llama31_8b", "deepseek_v2_lite_16b"])
def test_adamw_update_on_a_model_matches_reference(arch):
    """adamw_update on a port model (one tensor a layer) equals the
    reference's on its stacked tree, the factored moment included: a block
    leaf of one dim a layer is factored over (layer, channel) as the
    reference's stacked leaf is.  DeepSeek has an unstacked prefix layer."""
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                      factored=True)
    jcfg = jt.AdamWConfig(**cfg.__dict__)
    pcfg, model, _, jparams = _pair(arch)
    rng = np.random.RandomState(3)
    jgrads = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32),
                          jax.tree.map(np.asarray, jparams))
    grads = dict(tm.from_jax_params(pcfg, jgrads, "cpu").named_parameters())
    opt, jopt = adamw_init(model, cfg), jt.adamw_init(jparams, jcfg)
    jupdate = jax.jit(jt.adamw_update, static_argnums=0)
    for _ in range(2):
        model, opt, m = adamw_update(cfg, grads, opt, model)
        jparams, jopt, jm_ = jupdate(jcfg, jax.tree.map(jnp.asarray, jgrads),
                                     jopt, jparams)
    assert float(m["grad_norm"]) == pytest.approx(float(jm_["grad_norm"]),
                                                  rel=1e-6)
    got = tm.to_jax_params(pcfg, model)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)


def test_global_norm_matches_reference():
    leaves = _leaves(5)
    got = tt.global_norm({k: torch.tensor(v) for k, v in leaves.items()})
    want = jt.global_norm({k: jnp.asarray(v) for k, v in leaves.items()})
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    _, model, _, jparams = _pair("llama31_8b")
    assert float(tt.global_norm(model)) == pytest.approx(
        float(jt.global_norm(jparams)), rel=1e-6)


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "rwkv6_3b"])
def test_train_matches_reference(arch):
    """A 5-step train from the same params over the same batches: the
    losses within 1e-4 of the reference's."""
    cfg, model, jcfg, jparams = _pair(arch)
    _, want = jt.train(jcfg, steps=5, batch=2, seq_len=16, log_every=0,
                       params=jparams)
    _, got = train(cfg, steps=5, batch=2, seq_len=16, log_every=0,
                   params=model, device="cpu")
    assert got.steps == 5
    np.testing.assert_allclose(got.losses, want.losses, rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_to_jax_params_inverts_from_jax_params(arch):
    """Exactly the reference's tree back, in f32 and with bf16 leaves as
    their raw 2-byte values."""
    for over in ({}, BF16):
        cfg, model, _, jparams = _pair(arch, **over)
        back = tm.to_jax_params(cfg, model)
        _equal_trees(back, jax.tree.map(np.asarray, jparams))
        if over:
            assert back["embed"].dtype == np.dtype("V2")


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("over", [{}, BF16], ids=["f32", "bf16"])
def test_checkpoints_cross_between_packages(tmp_path, over):
    """The port's save read by the reference's restore, and the reference's
    save read by the port's restore(like=a model): the same keys, dtypes
    and weights, bit for bit, over several shards.  In f32 the reference
    restores with like=its params; its restore cannot cast the raw 2-byte
    bf16 values it writes back to bf16 (ROADMAP C), so in bf16 it reads
    the flat arrays."""
    cfg, model, _, jparams = _pair("deepseek_v2_lite_16b", **over)
    save(str(tmp_path / "port"), model, step=7, shard_bytes=1 << 18)
    with open(tmp_path / "port" / "index.json") as f:
        assert json.load(f)["n_shards"] > 1
    flat, step = jt.restore(str(tmp_path / "port"))
    assert step == 7
    want = _flat(jparams)
    assert set(flat) == set(want)
    for k in want:
        assert flat[k].dtype == (np.dtype("V2") if over else np.float32)
        assert np.array_equal(_bits(flat[k]), _bits(want[k])), k
    if not over:
        got, _ = jt.restore(str(tmp_path / "port"), like=jparams)
        _equal_trees(got, jax.tree.map(np.asarray, jparams))
    jt.save(str(tmp_path / "ref"), jparams, step=9, shard_bytes=1 << 18)
    back, step = restore(str(tmp_path / "ref"),
                         like=tm.Transformer(cfg, "cpu"))
    assert step == 9
    _equal_trees(tm.to_jax_params(cfg, back),
                 jax.tree.map(np.asarray, jparams))
    mine, _ = restore(str(tmp_path / "ref"))
    assert {k: a.dtype for k, a in mine.items()} == \
        {k: a.dtype for k, a in flat.items()}


def test_gradcheck_prefill_attention():
    """The Function's backward is the VJP of its forward (the plain version
    on the CPU), f64: offsets, lengths, a window and a softcap, G = 2."""
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64,
                           requires_grad=True)
    q, k, v = rnd(2, 5, 4, 8), rnd(2, 7, 2, 8), rnd(2, 7, 2, 8)
    off, lens = torch.tensor([2, 0]), torch.tensor([7, 4])
    assert torch.autograd.gradcheck(
        lambda q, k, v: kops.prefill_attention(q, k, v, off, lens, window=3,
                                               softcap=5.0), (q, k, v))


def test_gradcheck_wkv6():
    """The same for WKV6, with u and s0, over a ragged tail of chunks."""
    g = torch.Generator().manual_seed(1)
    B, S, H, K = 1, 21, 2, 4

    def rnd(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64)
    w = (0.4 + 0.5 * torch.rand(B, S, H, K, generator=g,
                                dtype=torch.float64))
    args = [rnd(B, S, H, K), rnd(B, S, H, K), rnd(B, S, H, K), w,
            rnd(H, K), rnd(B, H, K, K)]
    args = [a.requires_grad_() for a in args]
    assert torch.autograd.gradcheck(
        lambda *a: kops.wkv6_op(*a, chunk=8), tuple(args))


def test_train_refuses_a_model_on_another_device():
    """No fallback: a step asked to run on the card refuses a CPU model."""
    cfg = get_config("llama31_8b", smoke=True)
    model = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="cuda"):
        train(cfg, steps=1, batch=1, seq_len=8, params=model)


def test_train_cli(tmp_path):
    """The twin of tests/test_launch_cli.py::test_train_cli."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-0.5b", "--smoke", "--steps", "6", "--batch", "2",
         "--seq-len", "32", "--device", "cpu",
         "--checkpoint", str(tmp_path / "ck")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-1500:])
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["steps"] == 6
    assert rec["loss_last"] > 0
    assert (tmp_path / "ck" / "index.json").exists()
    got, step = jt.restore(str(tmp_path / "ck"))
    assert step == 6 and "blocks/p0/wq" in got


def test_train_small_model_example(capsys):
    """The twin of examples/train_small_model.py: phase 1, a checkpoint
    round trip, phase 2, and the loss improves."""
    train_small_model.main(["--device", "cpu", "--steps", "40", "--batch",
                            "4", "--seq-len", "64"])
    out = capsys.readouterr().out
    assert "[checkpoint] round-trip at step 20 OK" in out
    assert "done: loss improved across checkpoint boundary" in out
