"""Tensor parallelism for the rest of the zoo and FSDP of "embed" (ROADMAP
A18), under the reference's own rule tables (``launch.mesh.act_rules`` /
``param_rules``, unchanged), and the factored second moment of a sharded
leaf (ROADMAP C8): 8 gloo ranks on the CPU against

* the port's single process: SMOKE RWKV-6, Jamba, DeepSeek-V2-Lite (MLA),
  Kimi K2 and Llama-3.2-Vision (with images) on mesh ("data", "model") =
  (2, 4): a prefill under the prefill tables with FSDP ("embed" over
  "data") and 3 teacher-forced decode steps under the decode tables
  (every rank's logits of its rows, and its shard of every state leaf,
  within 2e-4 of the largest |value|), and ``forward_train`` under the
  train tables with FSDP (every leaf's gradient of <C, logits> + aux
  within 2e-4 of its largest |gradient|); two cut cases on (1, 8): RWKV-6
  with half a head a rank, Jamba with Mamba's [x | z] columns and the
  attention heads cut;
* the reference under its rules and mesh: ``repro``'s jitted ``prefill``
  / ``decode_step`` and ``jax.value_and_grad`` of the same objective, on
  8 host devices in one JAX subprocess;
* C8: one ``make_train_step`` with bf16 factored moments on Llama SMOKE in
  f32 under the train tables of (2, 4), without and with FSDP: every
  updated leaf within 2e-4 of its largest |value| of the single process's
  step and of the reference's jitted step under its mesh;
* a checkpoint of a model built under FSDP, byte for byte the whole
  model's save; ``params.whole_state`` of the ranks' states.

The world of ranks and the JAX subprocess run once for the module, side by
side (as ``tests/test_torch_moe_ep.py``); each rank saves what it computed.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile
import threading
import types
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from repro_torch import models as tm
from repro_torch.configs import InputShape, get_config
from repro_torch.launch.mesh import act_rules, param_rules
from repro_torch.sharding import axis_rules, local_slices, logical_to_pspec
from repro_torch.training.checkpoint import _flatten

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
AXES = ("data", "model")
#: (case, arch, mesh): the five archs on (2, 4), the two cut cases on (1, 8)
CASES = (("rwkv6_3b", "rwkv6_3b", (2, 4)),
         ("jamba_v0_1_52b", "jamba_v0_1_52b", (2, 4)),
         ("deepseek_v2_lite_16b", "deepseek_v2_lite_16b", (2, 4)),
         ("kimi_k2_1t_a32b", "kimi_k2_1t_a32b", (2, 4)),
         ("llama_3_2_vision_11b", "llama_3_2_vision_11b", (2, 4)),
         ("rwkv_head_cut", "rwkv6_3b", (1, 8)),
         ("jamba_xz_cut", "jamba_v0_1_52b", (1, 8)))
ARCHS = tuple(dict.fromkeys(c[1] for c in CASES))
B = 4
LENGTHS = [24, 17, 9, 21]    # the prompts, padded to 24
MAX_LEN = 32                 # 8 positions a rank of "model" = 4
DEC_STEPS = 3
S_TRAIN = 16
TOL = 2e-4
#: zero- or constant-initialised leaves given seeded noise, so that every
#: leaf moves the output (a zero gate silences cross-attention)
NOISY = {"gate": 1.0, "conv_b": 0.1, "lora_B": 0.05, "decay_B": 0.05}
#: C8's cases: the train tables of (2, 4) without and with FSDP
C8_CASES = {"tp": False, "tp_fsdp": True}
C8_ARCH = "llama31_8b"
C8_LR = 1e-2
#: the case whose gradients are also taken with remat, the backward run
#: where the rules are not active
REMAT_CASE = "jamba_v0_1_52b"

_JAX = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro import models as jm
from repro.configs import InputShape, get_config
from repro.launch.mesh import (act_rules, compat_make_mesh, compat_set_mesh,
                               param_rules)
from repro.models.params import param_axes
from repro.sharding import axis_rules, sharding_tree
from repro.training import AdamWConfig, adamw_init, make_train_step

src, out = sys.argv[1], sys.argv[2]
z = dict(np.load(src))
res = {}


def tree_of(prefix):
    params = {"prefix": {}, "blocks": {}}
    for key, leaf in z.items():
        if not key.startswith(prefix + "|"):
            continue
        *parents, name = key.split("|", 1)[1].split("/")
        node = params
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = jnp.asarray(leaf)
    return params


def cfg_of(arch):
    cfg = get_config(arch, smoke=True)
    if cfg.moe is not None:
        import dataclasses
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=100.0))
    return cfg


def placed(cfg, params, rules, mesh):
    return jax.device_put(params, sharding_tree(param_axes(cfg), params,
                                                mesh, rules))


def layers(cfg, st):
    out = []
    for i, spec in enumerate(cfg.layer_specs):
        if i < cfg.first_k_dense:
            out.append(st["prefix"][f"l{i}"])
        else:
            blk, j = divmod(i - cfg.first_k_dense, len(cfg.block_pattern))
            out.append(jax.tree.map(lambda a: a[blk], st["blocks"][f"p{j}"]))
    return out


toks, lens, dec = z["toks"], z["lens"], z["dec"]
ttoks, cot = z["train_toks"], z["cot"]
B, S = toks.shape
for case, arch, m0, m1 in [c.split(":") for c in str(z["cases"]).split(",")]:
    cfg = cfg_of(arch)
    mesh = compat_make_mesh((int(m0), int(m1)), ("data", "model"))
    params = tree_of(arch)
    L = int(z["max_len"])
    ie = jnp.asarray(z["images"][:, :cfg.num_vision_tokens, :cfg.d_model]) \
        if cfg.num_vision_tokens else None
    sp, sd = InputShape("prefill", L, B, "prefill"), \
        InputShape("decode", L, B, "decode")
    with axis_rules(act_rules(sp, False), mesh), compat_set_mesh(mesh):
        p = placed(cfg, params, param_rules(cfg, sp, False, fsdp=True), mesh)
        st = jm.init_state(cfg, B, L)
        logits, st = jax.jit(lambda p, s, t, l, i: jm.prefill(
            cfg, p, s, t, l, i))(p, st, jnp.asarray(toks), jnp.asarray(lens),
                                 ie)
    outs = [np.asarray(logits)]
    cur = jnp.asarray(lens)
    with axis_rules(act_rules(sd, False), mesh), compat_set_mesh(mesh):
        p = placed(cfg, params, param_rules(cfg, sd, False), mesh)
        step = jax.jit(lambda p, s, x, c: jm.decode_step(cfg, p, s, x, c))
        for t in range(dec.shape[0]):
            logits, st = step(p, st, jnp.asarray(dec[t]), cur)
            outs.append(np.asarray(logits))
            cur = cur + 1
    res[f"{case}|logits"] = np.stack(outs)
    for i, layer in enumerate(layers(cfg, st)):
        for name, leaf in layer.items():
            res[f"{case}|state|{i}|{name}"] = np.asarray(leaf, np.float32)
    st_ = InputShape("train", ttoks.shape[1], B, "train")
    c = jnp.asarray(cot[..., :cfg.vocab_size])

    def objective(p):
        logits, aux = jm.forward_train(cfg, p, jnp.asarray(ttoks),
                                       image_embeds=ie)
        return (logits * c).sum() + aux
    with axis_rules(act_rules(st_, False), mesh), compat_set_mesh(mesh):
        p = placed(cfg, params, param_rules(cfg, st_, False, fsdp=True),
                   mesh)
        _, g = jax.jit(jax.value_and_grad(objective))(p)
    flat = {}

    def walk(prefix, t):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = np.asarray(t)
    walk("", g)
    for path, a in flat.items():
        res[f"{case}|grad|{path}"] = a

# C8: one train step with bf16 factored moments under the train tables
cfg = get_config("llama31_8b", smoke=True)
mesh = compat_make_mesh((2, 4), ("data", "model"))
ocfg = AdamWConfig(lr=float(z["c8_lr"]), warmup_steps=0, total_steps=10,
                   factored=True, moment_dtype="bfloat16")
st_ = InputShape("train", ttoks.shape[1], B, "train")
for case, fsdp in (("tp", False), ("tp_fsdp", True)):
    params = tree_of("c8")
    with axis_rules(act_rules(st_, False), mesh), compat_set_mesh(mesh):
        p = placed(cfg, params, param_rules(cfg, st_, False, fsdp=fsdp),
                   mesh)
        opt = adamw_init(p, ocfg)
        p, opt, m = make_train_step(cfg, ocfg, donate=False)(
            p, opt, jnp.asarray(ttoks), jnp.asarray(z["c8_labels"]))
    flat = {}

    def walk(prefix, t):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = np.asarray(t)
    walk("", p)
    for path, a in flat.items():
        res[f"c8.{case}|{path}"] = a
    res[f"c8.{case}|loss"] = np.asarray(m["loss"])
np.savez(out, **res)
print("JAX_TP_ZOO_OK")
"""


def _cfg(arch):
    cfg = get_config(arch, smoke=True)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=100.0))
    return cfg


def _tree(arch):
    """The whole model's weights, in the reference's layout (numpy, flat
    paths): seed 0, with noise on the NOISY leaves."""
    cfg = _cfg(arch)
    model = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.RandomState(7)
    flat = _flatten(tm.to_jax_params(cfg, model))
    for path in sorted(flat):
        if path.rsplit("/", 1)[-1] in NOISY:
            a = flat[path]
            flat[path] = (a + NOISY[path.rsplit("/", 1)[-1]]
                          * rng.standard_normal(a.shape)).astype(a.dtype)
    return flat


def _inputs():
    """Prompts, teacher-forced decode tokens, images, the train batch and
    its cotangent: numpy, every SMOKE vocab is 512 and d_model at most
    320."""
    rng = np.random.RandomState(11)
    toks = np.zeros((B, max(LENGTHS)), np.int32)
    for b, n in enumerate(LENGTHS):
        toks[b, :n] = rng.randint(0, 512, n)
    return {"toks": toks, "lens": np.array(LENGTHS, np.int32),
            "dec": rng.randint(0, 512, (DEC_STEPS, B)).astype(np.int32),
            "images": rng.standard_normal((B, 64, 320)).astype(np.float32),
            "train_toks": rng.randint(0, 512, (B, S_TRAIN)).astype(np.int32),
            "cot": rng.standard_normal((B, S_TRAIN, 512)).astype(np.float32),
            "c8_labels": rng.randint(0, 512, (B, S_TRAIN)).astype(np.int32),
            "max_len": MAX_LEN, "c8_lr": C8_LR}


def _images(z, cfg):
    if not cfg.num_vision_tokens:
        return None
    return torch.from_numpy(z["images"][:, :cfg.num_vision_tokens,
                                        :cfg.d_model])


def _shapes():
    return (InputShape("prefill", MAX_LEN, B, "prefill"),
            InputShape("decode", MAX_LEN, B, "decode"),
            InputShape("train", S_TRAIN, B, "train"))


def _c8_opt():
    from repro_torch.training import AdamWConfig
    return AdamWConfig(lr=C8_LR, warmup_steps=0, total_steps=10,
                       factored=True, moment_dtype="bfloat16")


def _serve(cfg, tree, z, mesh=None, rows=slice(None)):
    """The prefill (FSDP'd model under the prefill tables) and the decode
    steps (the decode tables' model), on `rows`: (logits (1 + steps, rows,
    V), the state).  Without a mesh, the whole model on one process."""
    sp, sd, _ = _shapes()
    ie = _images(z, cfg)
    ie = None if ie is None else ie[rows]
    toks, lens = z["toks"][rows], z["lens"][rows]
    state = tm.init_state(cfg, B, MAX_LEN, "cpu")
    if mesh is None:
        model_p = model_d = tm.from_jax_params(cfg, tm.params.nest(tree),
                                               "cpu")
        state = [{n: t[rows] for n, t in st.items()} for st in state]
        rules_p = rules_d = {}
    else:
        rules_p, rules_d = act_rules(sp, False), act_rules(sd, False)
        model_p = tm.from_jax_params(cfg, tm.params.nest(tree), "cpu", mesh,
                                     param_rules(cfg, sp, False, fsdp=True))
        model_d = tm.from_jax_params(cfg, tm.params.nest(tree), "cpu", mesh,
                                     param_rules(cfg, sd, False))
        state = tm.params.shard_state(cfg, state, mesh, rules_p)
    with axis_rules(rules_p, mesh), torch.no_grad():
        logits, state = tm.prefill(cfg, model_p, state, toks, lens, ie)
    out = [logits]
    with axis_rules(rules_d, mesh), torch.no_grad():
        for t in range(DEC_STEPS):
            logits, state = tm.decode_step(cfg, model_d, state,
                                           z["dec"][t][rows],
                                           lens + t)
            out.append(logits)
    return torch.stack(out), state


def _backward_elsewhere(loss):
    """``loss.backward()`` run from another thread, where no
    ``axis_rules`` is active: as autograd runs a card's backward, on its
    device thread."""
    err = []

    def run():
        try:
            loss.backward()
        except BaseException as e:   # re-raised in the caller
            err.append(e)
    t = threading.Thread(target=run)
    t.start()
    t.join()
    if err:
        raise err[0]


def _grads(cfg, tree, z, mesh=None, rows=slice(None), n_data=2,
           remat=False):
    """Every leaf's gradient of <C, forward_train logits> + aux under the
    train tables with FSDP: on a mesh, the rank's rows, each leaf's
    gradient summed over the "data" ranks that do not split it; without,
    the whole batch's <C, logits> plus the mean of the `n_data` data
    shards' aux (the expert-parallel path's aux), on one process.  With
    `remat`, each block is rematerialised and the backward runs from
    another thread (``_backward_elsewhere``)."""
    _, _, st = _shapes()
    ie = _images(z, cfg)
    toks = torch.from_numpy(z["train_toks"]).long()
    cot = torch.from_numpy(z["cot"][..., :cfg.vocab_size])
    if mesh is None:
        model = tm.from_jax_params(cfg, tm.params.nest(tree), "cpu")
        model.requires_grad_(True)
        logits, _ = tm.forward_train(cfg, model, toks, ie)
        n = n_data
        per = B // n
        aux = sum(tm.forward_train(cfg, model, toks[i * per:(i + 1) * per],
                                   None if ie is None
                                   else ie[i * per:(i + 1) * per])[1]
                  for i in range(n)) / n
        ((logits * cot).sum() + aux).backward()
        return {k: q.grad for k, q in model.named_parameters()}
    model = tm.from_jax_params(cfg, tm.params.nest(tree), "cpu", mesh,
                               param_rules(cfg, st, False, fsdp=True))
    model.requires_grad_(True)
    with axis_rules(act_rules(st, False), mesh):
        logits, aux = tm.forward_train(cfg, model, toks[rows],
                                       None if ie is None else ie[rows],
                                       remat=remat)
        loss = (logits * cot[rows]).sum() + aux
        if not remat:
            loss.backward()
    if remat:
        _backward_elsewhere(loss)
    grads = {}
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    for (i, mod), prefix in zip(tm.params._leaf_modules(model),
                                [""] + [f"layers.{j}." for j in
                                        range(len(model.layers))]):
        for name in mod.leaves:
            g = getattr(mod, name).grad
            split = {a for dim in tm.params.built_axes(mod, name, mesh)
                     for a in dim}
            if "data" not in split and sizes["data"] > 1:
                dist.all_reduce(g, group=mesh.get_group("data"))
            grads[prefix + name] = g
    return grads


def _c8_step(mesh, fsdp, z, tree):
    """One ``make_train_step`` of Llama SMOKE with bf16 factored moments:
    the updated leaves (the rank's shards under a mesh) and the loss."""
    from repro_torch.training import adamw_init, make_train_step
    cfg = get_config(C8_ARCH, smoke=True)
    _, _, st = _shapes()
    toks = torch.from_numpy(z["train_toks"]).long()
    labels = torch.from_numpy(z["c8_labels"]).long()
    if mesh is None:
        model = tm.from_jax_params(cfg, tm.params.nest(tree), "cpu")
        rules = {}
    else:
        model = tm.from_jax_params(cfg, tm.params.nest(tree), "cpu", mesh,
                                   param_rules(cfg, st, False, fsdp=fsdp))
        rules = act_rules(st, False)
        rows = _rows(mesh, B)
        toks, labels = toks[rows], labels[rows]
    opt = adamw_init(model, _c8_opt())
    step = make_train_step(cfg, _c8_opt(), device="cpu")
    with axis_rules(rules, mesh):
        model, opt, m = step(model, opt, toks, labels)
    return {"params": {n: q.detach().clone()
                       for n, q in model.named_parameters()},
            "loss": m["loss"]}


def _rows(mesh, n):
    d = mesh.get_coordinate()[0]
    per = n // mesh.shape[0]
    return slice(d * per, (d + 1) * per)


def _rank_main(rank, tmpdir, ckpt_dir):
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmpdir, "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    try:
        z = dict(np.load(os.path.join(tmpdir, "inputs.npz")))
        trees = {a: dict(np.load(os.path.join(tmpdir, f"{a}.npz")))
                 for a in ARCHS + ("c8",)}
        meshes = {m: init_device_mesh("cpu", m, mesh_dim_names=AXES)
                  for m in dict.fromkeys(c[2] for c in CASES)}
        out = {}
        for case, arch, m in CASES:
            cfg, mesh = _cfg(arch), meshes[m]
            rows = _rows(mesh, B)
            out[f"{case}|serve"] = _serve(cfg, trees[arch], z, mesh, rows)
            out[f"{case}|whole_state"] = tm.params.whole_state(
                cfg, out[f"{case}|serve"][1], mesh,
                act_rules(_shapes()[1], False), B, MAX_LEN)
            out[f"{case}|grads"] = _grads(cfg, trees[arch], z, mesh, rows)
            if case == REMAT_CASE:
                out[f"{case}|grads_remat"] = _grads(cfg, trees[arch], z,
                                                    mesh, rows, remat=True)
        for case, fsdp in C8_CASES.items():
            out[f"c8.{case}"] = _c8_step(meshes[(2, 4)], fsdp, z,
                                         trees["c8"])
        # a checkpoint of Jamba built under the train tables with FSDP
        from repro_torch.training import checkpoint
        cfg = _cfg("jamba_v0_1_52b")
        model = tm.from_jax_params(
            cfg, tm.params.nest(trees["jamba_v0_1_52b"]), "cpu",
            meshes[(2, 4)], param_rules(cfg, _shapes()[2], False, fsdp=True))
        checkpoint.save(os.path.join(ckpt_dir, "jamba"), model, step=3)
        like = tm.init_params(cfg, torch.Generator().manual_seed(1), "cpu",
                              meshes[(2, 4)], model.shard_rules)
        got, step = checkpoint.restore(os.path.join(ckpt_dir, "jamba"),
                                       like=like)
        out["ckpt"] = (step, all(torch.equal(a, b) for a, b in zip(
            got.parameters(), model.parameters())),
            [tuple(q.shape) for q in model.parameters()])
        torch.save(out, os.path.join(tmpdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("fsdp_ckpt")


@pytest.fixture(scope="module")
def trees():
    out = {a: _tree(a) for a in ARCHS}
    cfg = get_config(C8_ARCH, smoke=True)
    out["c8"] = _flatten(tm.to_jax_params(cfg, tm.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu")))
    return out


@pytest.fixture(scope="module")
def world(trees, ckpt_dir):
    """The JAX subprocess and the 8 ranks side by side: (the reference's
    results, each rank's results)."""
    with tempfile.TemporaryDirectory() as tmpdir:
        z = _inputs()
        jz = dict(z, cases=",".join(f"{c}:{a}:{m[0]}:{m[1]}"
                                    for c, a, m in CASES))
        for name, flat in trees.items():
            np.savez(os.path.join(tmpdir, f"{name}.npz"), **flat)
            jz.update({f"{name}|{k}": v for k, v in flat.items()})
        np.savez(os.path.join(tmpdir, "inputs.npz"), **z)
        np.savez(os.path.join(tmpdir, "jax_in.npz"), **jz)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   PYTHONPATH=str(ROOT / "src"))
        ref = subprocess.Popen(
            [sys.executable, "-c", _JAX, os.path.join(tmpdir, "jax_in.npz"),
             os.path.join(tmpdir, "jax.npz")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            tmp.start_processes(_rank_main, args=(tmpdir, str(ckpt_dir)),
                                nprocs=WORLD, join=True,
                                start_method="spawn")
        finally:
            stdout, stderr = ref.communicate(timeout=900)
        assert ref.returncode == 0 and "JAX_TP_ZOO_OK" in stdout, \
            stderr[-3000:]
        jax_out = dict(np.load(os.path.join(tmpdir, "jax.npz")))
        ranks = [torch.load(os.path.join(tmpdir, f"rank{r}.pt"))
                 for r in range(WORLD)]
    return jax_out, ranks


@pytest.fixture(scope="module")
def single(trees):
    """The port's single process of each arch: the serving logits and
    state, and the gradients; and C8's step."""
    z = _inputs()
    out = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        out[arch] = (_serve(cfg, trees[arch], z), {
            n: _grads(cfg, trees[arch], z, n_data=n)
            for n in {m[0] for _, a, m in CASES if a == arch}})
    out["c8"] = _c8_step(None, False, z, trees["c8"])
    return out


def _coord(m, r):
    return dict(zip(AXES, divmod(r, m[1])))


def _spec_mesh(m):
    return types.SimpleNamespace(mesh_dim_names=AXES, shape=m)


def _cut(t, axes, rules, m, r):
    """Rank r's shard of the whole `t` of logical `axes` under `rules`."""
    sm = _spec_mesh(m)
    spec = logical_to_pspec(axes, rules, tuple(t.shape), sm)
    return t[local_slices(tuple(t.shape), spec, sm, _coord(m, r))]


def _state_ref(jax_out, case, i, name):
    return torch.from_numpy(jax_out[f"{case}|state|{i}|{name}"])


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_serving_matches_single_and_reference(world, single, case):
    """The prefill with FSDP under the prefill tables and 3 decode steps
    under the decode tables: every rank's logits (its rows) within 2e-4 of
    max |logit| of the single process's and of the reference's under its
    rules and mesh, and its shard of every state leaf (the cut the act
    tables give it: RWKV's wkv over "heads", Mamba's ssm / conv over "ff",
    MLA's latent cache over "ctx", the image keys over "kv_heads"; whole
    where that does not divide) within 2e-4 of the leaf's largest."""
    jax_out, ranks = world
    arch, m = {c[0]: c[1:] for c in CASES}[case]
    cfg = _cfg(arch)
    (want, want_state), _ = single[arch]
    ref = torch.from_numpy(jax_out[f"{case}|logits"])
    scale = want.abs().max().item()
    assert (want - ref).abs().max().item() <= TOL * scale
    rules = act_rules(_shapes()[1], False)
    axes = tm.params.state_axes(cfg)
    split = 0
    for r, out in enumerate(ranks):
        got, state = out[f"{case}|serve"]
        rows = _rows(types.SimpleNamespace(
            get_coordinate=lambda: divmod(r, m[1]), shape=m), B)
        err = (got - want[:, rows]).abs().max().item()
        assert err <= TOL * scale, (case, r, err, scale)
        for i, layer in enumerate(state):
            for name, leaf in layer.items():
                for whole in (want_state[i][name].float(),
                              _state_ref(jax_out, case, i, name)):
                    w = _cut(whole, axes[i][name], rules, m, r)
                    top = whole.abs().max().item()
                    assert leaf.shape == w.shape, (case, r, i, name)
                    assert (leaf.float() - w).abs().max().item() \
                        <= TOL * max(top, 1e-6), (case, r, i, name)
                split += tuple(leaf.shape) != tuple(want_state[i][name]
                                                    .shape)
    assert split > 0 or case == "rwkv_head_cut"


def test_whole_state_undoes_shard_state(world, single):
    """``params.whole_state`` of each rank's state after the decode steps
    (its cut under the decode tables) is the whole batch's state, on
    every rank alike: within 2e-4 of each leaf's largest |value| of the
    single process's."""
    _, ranks = world
    for case, arch, m in CASES:
        (_, want), _ = single[arch]
        for r, out in enumerate(ranks):
            got = out[f"{case}|whole_state"]
            for i, layer in enumerate(want):
                for name, w in layer.items():
                    g = got[i][name]
                    assert g.shape == w.shape, (case, r, i, name)
                    top = w.float().abs().max().item()
                    assert (g.float() - w.float()).abs().max().item() \
                        <= TOL * max(top, 1e-6), (case, r, i, name)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_gradients_match_single_and_reference(world, single, case):
    """``forward_train`` under the train tables with FSDP ("embed" over
    "data", "model" over the heads, d_ff, vocab and experts): every leaf's
    gradient of <C, logits> + aux, summed over "data" where the leaf is
    not split on it (an FSDP'd leaf's arrives summed by the reduce-scatter),
    is the rank's shard of the single process's and of the reference's
    ``jax.value_and_grad`` under its mesh, within 2e-4 of the leaf's
    largest |gradient|; some leaves are split over "data" (FSDP), none
    has a zero gradient."""
    jax_out, ranks = world
    arch, m = {c[0]: c[1:] for c in CASES}[case]
    cfg = _cfg(arch)
    want = single[arch][1][m[0]]
    rules = param_rules(cfg, _shapes()[2], False, fsdp=True)
    axes = tm.params.param_axes(cfg)
    paths = tm.params.reference_paths(tm.params.abstract_params(cfg))
    ref = {}
    for path, (names, stacked) in paths.items():
        a = torch.from_numpy(jax_out[f"{case}|grad|{path}"])
        for k, n in enumerate(names):
            ref[n] = a[k] if stacked else a
    fsdp = 0
    for r, out in enumerate(ranks):
        got = out[f"{case}|grads"]
        for name, g in want.items():
            top = g.abs().max().item()
            assert top > 0, (case, name)
            spec = logical_to_pspec(axes[name], rules, tuple(g.shape),
                                    _spec_mesh(m))
            fsdp += "data" in str(spec) and m[0] > 1
            for whole in (g, ref[name]):
                w = _cut(whole, axes[name], rules, m, r)
                err = (got[name] - w).abs().max().item()
                assert err <= TOL * top, (case, r, name, err, top)
    assert fsdp > 0 or m[0] == 1


def test_remat_recompute_runs_under_the_forwards_rules(world):
    """``forward_train(remat=True)`` under the train tables with FSDP, its
    backward run from a thread where no rules are active (as autograd runs
    a card's backward, on its device thread): the rematerialised blocks
    rerun under the rules of their forward (their FSDP gathers, the
    tensor-parallel layers), and every leaf's gradient equals the one
    without remat within 1e-5 of its largest |gradient|."""
    _, ranks = world
    for r, out in enumerate(ranks):
        want = out[f"{REMAT_CASE}|grads"]
        got = out[f"{REMAT_CASE}|grads_remat"]
        assert set(got) == set(want)
        for name, g in want.items():
            top = g.abs().max().item()
            err = (got[name] - g).abs().max().item()
            assert err <= 1e-5 * max(top, 1e-30), (r, name, err, top)


@pytest.mark.parametrize("case", list(C8_CASES))
def test_factored_moment_of_a_sharded_leaf(world, single, case):
    """C8: ``make_train_step`` with bf16 factored second moments under the
    train tables of (2, 4) (tensor parallelism, and FSDP in "tp_fsdp")
    updates every leaf as the single process's step and the reference's
    jitted step under its mesh do, within 2e-4 of the leaf's largest
    |value|: the row and column means are the whole leaf's, summed over
    the ranks that split its last two dims."""
    jax_out, ranks = world
    cfg = get_config(C8_ARCH, smoke=True)
    want = single["c8"]
    rules = param_rules(cfg, _shapes()[2], False, fsdp=C8_CASES[case])
    axes = tm.params.param_axes(cfg)
    paths = tm.params.reference_paths(tm.params.abstract_params(cfg))
    ref = {}
    for path, (names, stacked) in paths.items():
        a = torch.from_numpy(jax_out[f"c8.{case}|{path}"])
        for k, n in enumerate(names):
            ref[n] = a[k] if stacked else a
    np.testing.assert_allclose(float(jax_out[f"c8.{case}|loss"]),
                               float(want["loss"]), rtol=1e-5)
    m = (2, 4)
    for r, out in enumerate(ranks):
        got = out[f"c8.{case}"]
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=1e-5)
        for name, p in want["params"].items():
            top = p.abs().max().item()
            for whole in (p, ref[name]):
                w = _cut(whole, axes[name], rules, m, r)
                err = (got["params"][name] - w).abs().max().item()
                assert err <= TOL * top, (case, r, name, err, top)


def _npz_members(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def test_fsdp_checkpoint_is_the_whole_models(world, trees, ckpt_dir,
                                             tmp_path):
    """Jamba SMOKE built under the train tables with FSDP, saved from every
    rank: ``index.json`` and every array of every ``.npz`` byte for byte
    the whole model's save; restored into a model built under the same
    rules, every rank's leaves bit-equal at their shard shapes, which are
    not the whole ones."""
    from repro_torch.training import checkpoint
    _, ranks = world
    cfg = _cfg("jamba_v0_1_52b")
    whole = tm.from_jax_params(cfg, tm.params.nest(trees["jamba_v0_1_52b"]),
                               "cpu")
    checkpoint.save(str(tmp_path / "jamba"), whole, step=3)
    got, want = ckpt_dir / "jamba", tmp_path / "jamba"
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    assert (got / "index.json").read_bytes() \
        == (want / "index.json").read_bytes()
    for f in os.listdir(want):
        if f.endswith(".npz"):
            assert _npz_members(got / f) == _npz_members(want / f), f
    shapes = [tuple(q.shape) for q in whole.parameters()]
    for out in ranks:
        step, same, local = out["ckpt"]
        assert (step, same) == (3, True)
        assert local != shapes


def test_mamba_in_proj_shards_are_not_the_ranks_channels():
    """The [x | z] cut that ``ops.apply_mamba`` undoes: under the tables on
    (2, 4) and (1, 8) a rank's shard of ``in_proj``'s flattened columns
    holds only x or only z, never the x and z of the channels its
    ``conv_w`` holds."""
    cfg = _cfg("jamba_v0_1_52b")
    di = cfg.mamba.expand * cfg.d_model
    leaves = tm.params._mamba_leaves(cfg)
    rules = param_rules(cfg, _shapes()[2], False, fsdp=True)
    for m in ((2, 4), (1, 8)):
        z_only = 0
        for r in range(WORLD):
            sm, co = _spec_mesh(m), _coord(m, r)
            cols = local_slices(leaves["in_proj"].shape, logical_to_pspec(
                leaves["in_proj"].axes, rules, leaves["in_proj"].shape, sm),
                sm, co)[1]
            chans = local_slices(leaves["conv_w"].shape, logical_to_pspec(
                leaves["conv_w"].axes, rules, leaves["conv_w"].shape, sm),
                sm, co)[1]
            assert cols.stop <= di or cols.start >= di
            z_only += cols.start >= di
            assert chans.stop - chans.start == di // m[1]
        assert z_only == WORLD // 2
