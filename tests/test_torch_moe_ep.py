"""The port's expert-parallel MoE path (``models.ops._moe_ep_path``) over
``torch.distributed``: 8 gloo ranks on the CPU, mesh ("data", "model") =
(2, 4), against

* the port's dense path: ``forward_train`` of Kimi K2 SMOKE at capacity
  factor 100 (no pair dropped) within 1e-4, the reference EP test's bound
  (``tests/test_moe_ep.py``), and every leaf's gradient within 2e-4 of
  the leaf's largest |gradient|;
* the reference's own EP path: ``repro.models.ops.apply_moe_ffn`` under
  ``shard_map`` on 8 host devices, in one JAX subprocess, at a capacity
  factor where pairs are dropped, for S > 1 (tokens over "data") and the
  weight-stationary S == 1 (expert d_ff over "data"): outputs and aux
  within 1e-5 (f32);
* the single-process step of the whole batch: ``make_train_step`` under
  the mesh (Kimi K2 SMOKE on the EP path, built with expert d_ff over
  "data", and on the dense MoE path; a dense SMOKE config, data-parallel
  and tensor-parallel) reduces its gradients and clip norm to the global
  batch's (ROADMAP C6);
* tensor parallelism and the decode cache split over "ctx" (ROADMAP A18,
  ``models.ops._apply_attn_tp``): Llama, Qwen (bias, heads that do not
  divide 4) and Gemma-2 (a window across the cache's slices, softcaps)
  SMOKE under the reference's ``act_rules`` / ``param_rules``: prefill and
  greedy decode steps with the cache over "model", the B = 1 rule (the
  cache over ("data", "model")), a chunk at a later offset and Llama's
  int8 cache, against the port's single process and the reference's
  ``prefill`` / ``decode_step`` under the same rules and mesh, within
  2e-4 of max |logit|, tokens exact; ``forward_train`` gradients within
  2e-4 of each leaf's largest;
* checkpoints of sharded models (ROADMAP C7): Kimi K2 SMOKE with FSDP'd
  experts and Llama SMOKE under tensor parallelism, saved from all ranks,
  hold the whole model's bytes, the reference's ``restore`` reads them,
  and a restore into a sharded model gives each rank its shards.

One world of ranks (``torch.multiprocessing``, spawn, a FileStore in a
temp dir) and the JAX subprocess run once for the module, side by side;
each rank saves what it computed and the tests read it.  The gradients:
each rank backpropagates its own objective, <C, its logits> + the EP aux,
and then sums every leaf's gradient over the batch axis; the dense side
is <C, the whole batch's logits> + the mean of the batch shards' aux
losses, which is what the EP aux is (the reference's pmean).
"""
import dataclasses
import os
import subprocess
import sys
import tempfile
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from repro.configs import get_config as jget_config
from repro.models import ops as jops
from repro_torch import models as tm
from repro_torch.configs import get_config
from repro_torch.models import ops as tops
from repro_torch.sharding import axis_rules, local_slices, logical_to_pspec
from repro_torch.training.checkpoint import _flatten

ROOT = Path(__file__).resolve().parents[1]
ARCH = "kimi_k2_1t_a32b"
MESH = (2, 4)
AXES = ("data", "model")
WORLD = MESH[0] * MESH[1]
DROP_CF = 0.5        # cap = max(8, T k / E x 0.5) = 8 slots for 16 pairs
B, S = 4, 16         # forward_train / the S > 1 layer: 2 rows a data shard
B_DEC = 32           # the S == 1 layer: 16 rows a data shard, 32 gathered
LENGTHS = [16, 11, 5, 14]   # the served prompts, padded to 16
MAX_LEN = 24
NO_DROP_TOL = 1e-4
REF_TOL = 1e-5
GRAD_TOL = 2e-4
#: the layer tests' rules; the tensor-parallel axes stay replicated
RULES = {
    "token": {"batch": ("data",), "experts": ("model",), "expert_ff": ()},
    "stationary": {"batch": ("data",), "experts": ("model",),
                   "expert_ff": ("data",)},
}
LAYER_LEAVES = ("ln2", "router", "we_gate", "we_up", "we_down", "ws_gate",
                "ws_up", "ws_down")

_JAX = r"""
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.launch.mesh import compat_make_mesh, compat_set_mesh
from repro.models import ops
from repro.sharding import axis_rules

src, out = sys.argv[1], sys.argv[2]
z = dict(np.load(src))
cfg = get_config("kimi_k2_1t_a32b", smoke=True).replace(dtype="float32",
                                                         param_dtype="float32")
cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                          capacity_factor=float(z["cf"])))
p = {k[2:]: jnp.asarray(v) for k, v in z.items() if k.startswith("p_")}
mesh = compat_make_mesh((2, 4), ("data", "model"))
res = {}
for kind, x, ff in (("token", z["x_token"], ()),
                    ("stationary", z["x_stationary"], ("data",))):
    rules = {"batch": ("data",), "experts": ("model",), "expert_ff": ff}
    with axis_rules(rules, mesh), compat_set_mesh(mesh):
        y, aux = jax.jit(lambda p, x: ops.apply_moe_ffn(cfg, p, x))(
            p, jnp.asarray(x))
    res[f"y_{kind}"], res[f"aux_{kind}"] = np.asarray(y), np.asarray(aux)


def loss(p, x, cfg):
    y, aux = ops.apply_moe_ffn(cfg, p, x)
    return (y * z["c_token"]).sum() + aux


# the gradients of the token layout, with drops; then at capacity factor
# 100, the EP path's gradients of <C, y> against its dense path's
grad = jax.grad(loss, argnums=(0, 1))
x = jnp.asarray(z["x_token"])
no_drop = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=100.0))
rules = {"batch": ("data",), "experts": ("model",), "expert_ff": ()}
with axis_rules(rules, mesh), compat_set_mesh(mesh):
    gp, gx = jax.jit(grad, static_argnums=2)(p, x, cfg)
    ep_p, ep_x = jax.jit(jax.grad(lambda p, x: (ops.apply_moe_ffn(
        no_drop, p, x)[0] * z["c_token"]).sum(), argnums=(0, 1)))(p, x)
dn_p, dn_x = jax.grad(lambda p, x: (ops.apply_moe_ffn(
    no_drop, p, x)[0] * z["c_token"]).sum(), argnums=(0, 1))(p, x)
res["g_x"] = np.asarray(gx)
with axis_rules(rules, mesh), compat_set_mesh(mesh):
    ga_p, ga_x = jax.jit(jax.grad(lambda p, x: ops.apply_moe_ffn(
        cfg, p, x)[1], argnums=(0, 1)))(p, x)
res["ga_router"], res["ga_x"] = np.asarray(ga_p["router"]), np.asarray(ga_x)
# the dense path under the mesh, the batch over "data": its aux and the
# router's and the input's gradients of it
rules = {"batch": ("data",), "experts": (), "expert_ff": ()}
with axis_rules(rules, mesh), compat_set_mesh(mesh):
    aux_fn = lambda p, x: ops.apply_moe_ffn(cfg, p, x)[1]
    res["aux_dense"] = np.asarray(jax.jit(aux_fn)(p, x))
    gd_p, gd_x = jax.jit(jax.grad(aux_fn, argnums=(0, 1)))(p, x)
res["gd_router"], res["gd_x"] = np.asarray(gd_p["router"]), np.asarray(gd_x)
for k in p:
    res[f"g_{k}"] = np.asarray(gp[k])
    res[f"hazard_{k}"] = np.abs(np.asarray(ep_p[k]) - np.asarray(dn_p[k])
                                ).max() / np.abs(np.asarray(dn_p[k])).max()
res["hazard_x"] = np.abs(np.asarray(ep_x) - np.asarray(dn_x)).max() \
    / np.abs(np.asarray(dn_x)).max()

# tensor parallelism: the reference's prefill / decode_step of the dense
# SMOKE configs under its act rules on the (2, 4) mesh, greedy
from repro import models as jm
from repro.configs import InputShape
from repro.launch.mesh import act_rules
tp = dict(np.load(sys.argv[3]))
toks, lens = tp["toks"], tp["lens"]
B, S = toks.shape
for case, arch, kv8, batch, chunk in (
        ("llama31_8b", "llama31_8b", False, B, 0),
        ("qwen25_32b", "qwen25_32b", False, B, 0),
        ("gemma2_9b", "gemma2_9b", False, B, 0),
        ("llama_int8", "llama31_8b", True, B, 0),
        ("gemma2_9b_b1", "gemma2_9b", False, 1, 0),
        ("llama31_8b_chunk", "llama31_8b", False, B, int(tp["chunk"]))):
    jcfg = get_config(arch, smoke=True)
    if kv8:
        jcfg = jcfg.replace(kv_cache_dtype="int8")
    flat = {k.split("|", 1)[1]: v for k, v in tp.items()
            if k.startswith(arch + "|")}
    params = {"prefix": {}, "blocks": {}}
    for path, leaf in flat.items():
        *parents, name = path.split("/")
        node = params
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = jnp.asarray(leaf)
    rules = act_rules(InputShape("decode", int(tp["max_len"]), batch,
                                 "decode"), False)
    t, l = jnp.asarray(toks[:batch]), jnp.asarray(lens[:batch])
    steps = int(tp["chunk_steps"] if chunk else tp["steps"])
    with axis_rules(rules, mesh), compat_set_mesh(mesh):
        st = jm.init_state(jcfg, batch, int(tp["max_len"]))
        pre = jax.jit(lambda p, s, t, l, st0: jm.prefill(jcfg, p, s, t, l,
                                                         start=st0))
        if chunk:
            first = jnp.minimum(l, chunk)
            _, st = pre(params, st, t[:, :chunk], first,
                        jnp.zeros((batch,), jnp.int32))
            logits, st = pre(params, st, t[:, chunk:], l,
                             jnp.full((batch,), chunk, jnp.int32))
        else:
            logits, st = pre(params, st, t, l, jnp.zeros((batch,), jnp.int32))
        dec = jax.jit(lambda p, s, x, c: jm.decode_step(jcfg, p, s, x, c))
        outs, cur, seq = [np.asarray(logits)], l, []
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        for _ in range(steps):
            seq.append(np.asarray(tok))
            logits, st = dec(params, st, tok, cur)
            outs.append(np.asarray(logits))
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            cur = cur + 1
    res[f"tp_{case}"] = np.stack(outs)
    res[f"tp_{case}_tokens"] = np.stack(seq)
np.savez(out, **res)
print("JAX_EP_OK")
"""


def _moe_cfg(cf, f32=True):
    cfg = get_config(ARCH, smoke=True)
    if f32:
        cfg = cfg.replace(dtype="float32", param_dtype="float32")
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _layer_inputs(seed=0):
    """One MoE layer's weights and the two layers' inputs, numpy f32."""
    cfg = _moe_cfg(DROP_CF)
    rng = np.random.RandomState(seed)
    d, m = cfg.d_model, cfg.moe
    e, f, fs = m.num_experts, m.d_ff_expert, m.num_shared * m.d_ff_expert
    shapes = {"ln2": (d,), "router": (d, e), "we_gate": (e, d, f),
              "we_up": (e, d, f), "we_down": (e, f, d), "ws_gate": (d, fs),
              "ws_up": (d, fs), "ws_down": (fs, d)}
    z = {f"p_{k}": (rng.standard_normal(s) / np.sqrt(s[-2] if len(s) > 1
                                                      else 1)
                    + (1.0 if k == "ln2" else 0.0)).astype(np.float32)
         for k, s in shapes.items()}
    z["x_token"] = rng.standard_normal((B, S, d)).astype(np.float32)
    z["x_stationary"] = rng.standard_normal((B_DEC, 1, d)).astype(np.float32)
    z["c_token"] = rng.standard_normal((B, S, d)).astype(np.float32)
    z["cf"] = np.float32(DROP_CF)
    return z


def _mesh():
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", MESH, mesh_dim_names=AXES)


def _layer(cfg, z, mesh, rules):
    """This rank's shards of the layer's weights, a namespace as
    ``apply_moe_ffn`` reads them."""
    axes = {n: lf.axes for n, lf in tm.params._moe_ffn_leaves(cfg).items()}
    p = {}
    for n in LAYER_LEAVES:
        a = z[f"p_{n}"]
        cut = local_slices(a.shape, logical_to_pspec(axes[n], rules, a.shape,
                                                     mesh), mesh)
        p[n] = torch.from_numpy(np.ascontiguousarray(a[cut]))
    return types.SimpleNamespace(**p)


def _batch_rows(mesh, n_rows):
    d = mesh.get_coordinate()[0]
    per = n_rows // MESH[0]
    return slice(d * per, (d + 1) * per)


def _rank_main(rank, tmpdir, ckpt_dir):
    """One rank: the layer cases, then Kimi K2 SMOKE's forward_train and
    gradients, then a forward at capacity factor 0.1; saves them all."""
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmpdir, "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    try:
        mesh = _mesh()
        out = {}
        z = dict(np.load(os.path.join(tmpdir, "inputs.npz")))
        cfg = _moe_cfg(DROP_CF)
        for kind, rules in RULES.items():
            x = torch.from_numpy(z[f"x_{kind}"])
            x = x[_batch_rows(mesh, x.shape[0])]
            tops.reset_ep_pairs()
            with axis_rules(rules, mesh), torch.no_grad():
                y, aux = tops.apply_moe_ffn(cfg, _layer(cfg, z, mesh, rules),
                                            x)
            out[f"y_{kind}"], out[f"aux_{kind}"] = y, aux
            out[f"pairs_{kind}"] = torch.stack([
                torch.as_tensor(tops.EP_PAIRS[k]) for k in
                ("routed", "dropped")])
        # the token layout's gradients, with drops: weights summed over
        # the data axis, the input's own rows
        p = _layer(cfg, z, mesh, RULES["token"])
        x = torch.from_numpy(z["x_token"])[_batch_rows(mesh, B)]
        for q in (x, *vars(p).values()):
            q.requires_grad_(True)
        with axis_rules(RULES["token"], mesh):
            y, aux = tops.apply_moe_ffn(cfg, p, x)
            c = torch.from_numpy(z["c_token"])[_batch_rows(mesh, B)]
            ga = torch.autograd.grad(aux, (p.router, x), retain_graph=True)
            ((y * c).sum() + aux).backward()
        dist.all_reduce(ga[0], group=mesh.get_group("data"))
        out["ga_router"], out["ga_x"] = ga
        out["g_x"] = x.grad
        for n, q in vars(p).items():
            dist.all_reduce(q.grad, group=mesh.get_group("data"))
            out[f"g_{n}"] = q.grad
        # the dense path's aux over the batch's shards, and its router's
        # (summed over "data") and input's gradients
        p = _layer(cfg, z, mesh, DENSE_MOE)
        x = x.detach().requires_grad_(True)
        p.router.requires_grad_(True)
        with axis_rules(DENSE_MOE, mesh):
            _, aux = tops.apply_moe_ffn(cfg, p, x)
            gd = torch.autograd.grad(aux, (p.router, x))
        dist.all_reduce(gd[0], group=mesh.get_group("data"))
        out["aux_dense"] = aux.detach()
        out["gd_router"], out["gd_x"] = gd

        rules = {"batch": ("data",), "experts": ("model",),
                 "expert_ff": ()}
        cfg = _moe_cfg(100.0)
        model = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                               mesh=mesh, rules=rules)
        for q in model.parameters():
            q.requires_grad_(True)
        toks = _tokens(cfg)[_batch_rows(mesh, B)]
        with axis_rules(rules, mesh):
            logits, aux = tm.forward_train(cfg, model, toks)
            cot = _cotangent(cfg)[_batch_rows(mesh, B)]
            ((logits * cot).sum() + aux).backward()
        data = mesh.get_group("data")
        for name, q in model.named_parameters():
            dist.all_reduce(q.grad, group=data)
            out[f"grad.{name}"] = q.grad
        out["logits"], out["aux"] = logits.detach(), aux.detach()
        out.update(_serve_and_build(mesh))

        cfg = _moe_cfg(0.1)
        model = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                               mesh=mesh, rules=rules)
        tops.reset_ep_pairs()
        with axis_rules(rules, mesh), torch.no_grad():
            out["logits_cf01"], _ = tm.forward_train(cfg, model, toks)
        out["dropped_cf01"] = torch.as_tensor(tops.EP_PAIRS["dropped"])
        out.update(_sharded_train(mesh))
        out.update(_tp_serve(mesh, tmpdir))
        out.update(_tp_grads(mesh))
        out.update(_checkpoints(mesh, ckpt_dir))
        torch.save(out, os.path.join(tmpdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _serve_and_build(mesh):
    """Phase 13's path at SMOKE size: the whole batch's prefill with the
    experts over "model", then the state cut to this rank's rows and
    decode steps under the decode rules (weight-stationary: d_ff over
    "data"), the model rebuilt for them.  Also whether the sharded builds
    (``init_params``, and ``from_jax_params`` of the whole model's tree)
    hold exactly the whole model's values."""
    from repro_torch.configs import InputShape
    from repro_torch.launch.mesh import act_rules
    cfg = _moe_cfg(100.0)
    gen = torch.Generator()
    whole = tm.init_params(cfg, gen.manual_seed(0), "cpu")
    rules = {"prefill": {"batch": (), "experts": ("model",),
                         "expert_ff": ()},
             "decode": act_rules(InputShape("decode", MAX_LEN, B, "decode"),
                                 multi_pod=False)}
    out = {"same_values": True}
    axes = tm.params.param_axes(cfg)
    models = {}
    for kind, rl in rules.items():
        models[kind] = tm.init_params(cfg, gen.manual_seed(0), "cpu", mesh,
                                      rl)
        tree = tm.from_jax_params(cfg, tm.to_jax_params(cfg, whole), "cpu",
                                  mesh, rl)
        for (n, q), t in zip(whole.named_parameters(),
                             tree.parameters()):
            spec = logical_to_pspec(axes[n], rl, tuple(q.shape), mesh)
            want = q[local_slices(q.shape, spec, mesh)]
            out["same_values"] &= torch.equal(dict(
                models[kind].named_parameters())[n], want) \
                and torch.equal(t, want)
    toks, steps = _serve_inputs(cfg)
    # the same two layouts from models built under the other one's expert
    # d_ff: the prefill's weights split over "data" (gathered), the
    # decode's whole (each rank cuts its d_ff)
    other = {k: tm.init_params(cfg, gen.manual_seed(0), "cpu", mesh, {
        **rl, "expert_ff": () if k == "decode" else ("data",)})
        for k, rl in rules.items()}
    for key, built in (("serve", models), ("serve_resharded", other)):
        with axis_rules(rules["prefill"], mesh), torch.no_grad():
            logits, state = tm.prefill(cfg, built["prefill"], tm.init_state(
                cfg, B, MAX_LEN, "cpu"), toks, LENGTHS)
        out[key] = [logits]
        state = tm.params.shard_state(cfg, state, mesh, rules["decode"])
        rows = _batch_rows(mesh, B)
        with axis_rules(rules["decode"], mesh), torch.no_grad():
            for t in range(steps.shape[0]):
                logits, state = tm.decode_step(
                    cfg, built["decode"], state, steps[t][rows],
                    np.array(LENGTHS)[rows] + t)
                out[key].append(logits)
    return out


#: the train step under the mesh, in f32: Kimi K2 SMOKE at capacity
#: factor 100 with its experts over "model" ("ep"), built with their d_ff
#: over "data" too as the param rules' FSDP builds them ("fsdp": gathered
#: forward, reduce-scattered backward), and on the dense MoE path
#: ("dense": no "experts" axis); and a dense SMOKE config.  Each case:
#: (arch, the rules it is built under, the rules it runs under)
TRAIN_RULES = {"batch": ("data",), "experts": ("model",), "expert_ff": ()}
DENSE_MOE = {"batch": ("data",), "experts": (), "expert_ff": ()}
#: tensor parallelism over "model"
TP_TRAIN = {**TRAIN_RULES, "heads": ("model",), "kv_heads": ("model",),
            "ff": ("model",), "vocab": ("model",)}
TRAIN_CASES = {
    "ep": ("kimi_k2_1t_a32b", TRAIN_RULES, TRAIN_RULES),
    "fsdp": ("kimi_k2_1t_a32b", {**TRAIN_RULES, "expert_ff": ("data",)},
             TRAIN_RULES),
    "dense": ("kimi_k2_1t_a32b", DENSE_MOE, DENSE_MOE),
    "llama": ("llama31_8b", TRAIN_RULES, TRAIN_RULES),
    "llama_tp": ("llama31_8b", TP_TRAIN, TP_TRAIN),
    "qwen_tp": ("qwen25_32b", TP_TRAIN, TP_TRAIN),
    "gemma_tp": ("gemma2_9b", TP_TRAIN, TP_TRAIN),
}


def _train_cfg(arch):
    if arch == ARCH:
        return _moe_cfg(100.0)
    return get_config(arch, smoke=True).replace(dtype="float32",
                                                param_dtype="float32")


def _train_opt():
    from repro_torch.training import AdamWConfig
    return AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10)


def _train_batch(cfg):
    rng = np.random.RandomState(4)
    return (torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))),
            torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))))


def _sharded_train(mesh):
    """One ``make_train_step`` step of each of TRAIN_CASES on this rank's
    rows under the mesh: the gradients the step hands to
    ``adamw_update`` (its reduced ones), the metrics and the updated
    leaves."""
    from repro_torch.training import adamw_init, make_train_step, train_loop
    out = {}
    for case, (arch, built, rules) in TRAIN_CASES.items():
        cfg = _train_cfg(arch)
        model = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                               mesh, built)
        opt = adamw_init(model, _train_opt())
        step = make_train_step(cfg, _train_opt(), device="cpu")
        grads, update = {}, train_loop.adamw_update

        def spy(opt_cfg, g, *args, **kw):
            grads.update({n: x.clone() for n, x in g.items()})
            return update(opt_cfg, g, *args, **kw)
        toks, labels = (x[_batch_rows(mesh, B)] for x in _train_batch(cfg))
        train_loop.adamw_update = spy
        try:
            with axis_rules(rules, mesh):
                model, opt, m = step(model, opt, toks, labels)
        finally:
            train_loop.adamw_update = update
        out[f"train.{case}"] = {
            "grads": grads, "loss": m["loss"], "grad_norm": m["grad_norm"],
            "params": {n: q.detach().clone()
                       for n, q in model.named_parameters()}}
    return out


TP_CHUNK = 48                # the chunk case: [0, 48), then the rest
#: the tensor-parallel serving cases: (name, arch, int8 cache, the batch
#: of the rules (1: the cache over ("data", "model")), chunk start or 0)
TP_CASES = (("llama31_8b", "llama31_8b", False, B, 0),
            ("qwen25_32b", "qwen25_32b", False, B, 0),
            ("gemma2_9b", "gemma2_9b", False, B, 0),
            ("llama_int8", "llama31_8b", True, B, 0),
            ("gemma2_9b_b1", "gemma2_9b", False, 1, 0),
            ("llama31_8b_chunk", "llama31_8b", False, B, TP_CHUNK))
TP_ARCHS = ("llama31_8b", "qwen25_32b", "gemma2_9b")
#: prompts padded to 80: Gemma-2 SMOKE's 64-token window crosses the
#: cache's slices of 24 (12 under the B = 1 rule)
TP_LENGTHS = [80, 67, 41, 75]
TP_MAX_LEN = 96
TP_STEPS = 4                 # greedy decode steps
TP_CHUNK_STEPS = 2           # after the chunk at offset TP_CHUNK


def _tp_cfg(arch, kv8=False):
    cfg = get_config(arch, smoke=True)
    return cfg.replace(kv_cache_dtype="int8") if kv8 else cfg


def _tp_tokens():
    rng = np.random.RandomState(21)
    toks = np.zeros((B, max(TP_LENGTHS)), np.int64)
    for b, L in enumerate(TP_LENGTHS):
        toks[b, :L] = rng.randint(0, 512, L)     # every SMOKE vocab is 512
    return toks


def _tp_weights():
    """The JAX subprocess's inputs: each TP arch's weights (the port's
    whole model, seed 0, in the reference's layout), the prompts and the
    step counts."""
    out = {"toks": _tp_tokens().astype(np.int32),
           "lens": np.array(TP_LENGTHS, np.int32), "max_len": TP_MAX_LEN,
           "steps": TP_STEPS, "chunk": TP_CHUNK,
           "chunk_steps": TP_CHUNK_STEPS}
    for arch in TP_ARCHS:
        cfg = _tp_cfg(arch)
        model = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        for path, a in _flatten(tm.to_jax_params(cfg, model)).items():
            out[f"{arch}|{path}"] = a
    return out


def _tp_rules(cfg, batch):
    from repro_torch.configs import InputShape
    from repro_torch.launch.mesh import act_rules, param_rules
    shape = InputShape("decode", TP_MAX_LEN, batch, "decode")
    return act_rules(shape, False), param_rules(cfg, shape, False)


def _tp_run(cfg, model, toks, lens, chunk, steps, mesh=None, rules=None,
            batch=None):
    """Prefill (whole, or in two chunks at `chunk`) then greedy decode
    steps; under (`mesh`, `rules`) the cache of the global `batch` is cut
    by ``shard_state``: (logits (1 + steps, B, V), tokens (steps, B))."""
    B_ = toks.shape[0]
    if mesh is None:
        state = tm.init_state(cfg, B_, TP_MAX_LEN, "cpu")
    else:
        state = tm.params.shard_state(cfg, tm.init_state(
            cfg, batch, TP_MAX_LEN, "cpu"), mesh, rules)
    if chunk:
        _, state = tm.prefill(cfg, model, state, toks[:, :chunk],
                              np.minimum(lens, chunk))
        logits, state = tm.prefill(cfg, model, state, toks[:, chunk:], lens,
                                   start=np.full(B_, chunk))
    else:
        logits, state = tm.prefill(cfg, model, state, toks, lens)
    out, seq, cur = [logits], [], np.asarray(lens)
    tok = logits.argmax(-1)
    for _ in range(steps):
        seq.append(tok)
        logits, state = tm.decode_step(cfg, model, state, tok, cur)
        out.append(logits)
        tok = logits.argmax(-1)
        cur = cur + 1
    return torch.stack(out), torch.stack(seq)


def _tp_serve(mesh, tmpdir):
    """Each of TP_CASES on this rank: the model built under the param
    rules with tensor parallelism, the prompts of its rows (the first one
    only, on every rank, under the B = 1 rule), the cache cut by
    ``shard_state``."""
    from repro_torch.sharding import axis_rules
    out = {}
    toks = _tp_tokens()
    lens = np.array(TP_LENGTHS)
    for name, arch, kv8, batch, chunk in TP_CASES:
        cfg = _tp_cfg(arch, kv8)
        rules_a, rules_p = _tp_rules(cfg, batch)
        model = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                               mesh, rules_p)
        rows = _batch_rows(mesh, B) if batch > 1 else slice(0, 1)
        with axis_rules(rules_a, mesh), torch.no_grad():
            out[f"tp.{name}"] = _tp_run(
                cfg, model, toks[rows], lens[rows], chunk,
                TP_CHUNK_STEPS if chunk else TP_STEPS, mesh, rules_a, batch)
    return out


def _tp_grads(mesh):
    """``forward_train`` of each TP arch under the train rules with tensor
    parallelism: the logits of this rank's rows and every leaf's gradient
    of <C, logits> summed over "data"."""
    from repro_torch.configs import InputShape
    from repro_torch.launch.mesh import act_rules, param_rules
    from repro_torch.sharding import axis_rules
    out = {}
    shape = InputShape("train", S, B, "train")
    for arch in TP_ARCHS:
        cfg = _tp_cfg(arch)
        model = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                               mesh, param_rules(cfg, shape, False))
        model.requires_grad_(True)
        rows = _batch_rows(mesh, B)
        with axis_rules(act_rules(shape, False), mesh):
            logits, _ = tm.forward_train(cfg, model, _tokens(cfg)[rows])
            (logits * _cotangent(cfg)[rows]).sum().backward()
        grads = {}
        for name, q in model.named_parameters():
            dist.all_reduce(q.grad, group=mesh.get_group("data"))
            grads[name] = q.grad
        out[f"tp_grad.{arch}"] = {"logits": logits.detach(), "grads": grads}
    return out


#: C7's cases: Kimi K2 SMOKE built under the train param rules with FSDP
#: ("embed" and the experts' d_ff over "data", the experts, heads, d_ff
#: and vocab over "model"), Llama SMOKE under tensor parallelism
def _ckpt_cases():
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.launch.mesh import param_rules
    kimi, llama = _moe_cfg(100.0), _train_cfg("llama31_8b")
    return {"kimi": (kimi, param_rules(kimi, INPUT_SHAPES["train_4k"], False,
                                       fsdp=True)),
            "llama": (llama, TP_TRAIN)}


def _checkpoints(mesh, ckpt_dir):
    """Each C7 case saved from every rank at step 7, then restored into a
    model built under the same rules from other values: (the step, every
    leaf bit-equal to the saved model's shard, the leaves' local shapes)."""
    from repro_torch.training import checkpoint
    out = {}
    for name, (cfg, rules) in _ckpt_cases().items():
        model = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                               mesh, rules)
        path = os.path.join(ckpt_dir, name)
        checkpoint.save(path, model, step=7)
        like = tm.init_params(cfg, torch.Generator().manual_seed(1), "cpu",
                              mesh, rules)
        got, step = checkpoint.restore(path, like=like)
        out[f"ckpt.{name}"] = (step, all(
            torch.equal(a, b) for a, b in zip(got.parameters(),
                                              model.parameters())),
            [tuple(q.shape) for q in got.parameters()])
    return out


def _serve_inputs(cfg):
    rng = np.random.RandomState(3)
    toks = np.zeros((B, max(LENGTHS)), np.int64)
    for b, L in enumerate(LENGTHS):
        toks[b, :L] = rng.randint(0, cfg.vocab_size, L)
    return toks, rng.randint(0, cfg.vocab_size, (3, B))


def _tokens(cfg):
    return torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (B, S)))


def _cotangent(cfg):
    return torch.from_numpy(np.random.RandomState(2).standard_normal(
        (B, S, cfg.vocab_size)).astype(np.float32))


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """Where the ranks save their checkpoints (C7), kept for the tests."""
    return tmp_path_factory.mktemp("sharded_ckpt")


@pytest.fixture(scope="module")
def world(ckpt_dir):
    """Runs the JAX subprocess and the 8 ranks side by side; returns the
    JAX results, each rank's results and the rank's mesh coordinates."""
    with tempfile.TemporaryDirectory() as tmpdir:
        np.savez(os.path.join(tmpdir, "inputs.npz"), **_layer_inputs())
        np.savez(os.path.join(tmpdir, "tp_inputs.npz"), **_tp_weights())
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   PYTHONPATH=str(ROOT / "src"))
        ref = subprocess.Popen(
            [sys.executable, "-c", _JAX, os.path.join(tmpdir, "inputs.npz"),
             os.path.join(tmpdir, "jax.npz"),
             os.path.join(tmpdir, "tp_inputs.npz")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            tmp.start_processes(_rank_main, args=(tmpdir, str(ckpt_dir)),
                                nprocs=WORLD, join=True,
                                start_method="spawn")
        finally:
            stdout, stderr = ref.communicate(timeout=600)
        assert ref.returncode == 0 and "JAX_EP_OK" in stdout, stderr[-3000:]
        jax_out = dict(np.load(os.path.join(tmpdir, "jax.npz")))
        ranks = [torch.load(os.path.join(tmpdir, f"rank{r}.pt"))
                 for r in range(WORLD)]
    coords = [divmod(r, MESH[1]) for r in range(WORLD)]
    return jax_out, ranks, coords


@pytest.fixture(scope="module")
def dense():
    """The port's dense path on one process: the whole batch's logits, and
    the gradients of <C, logits> + the mean of the two batch shards' aux."""
    cfg = _moe_cfg(100.0)
    model = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for q in model.parameters():
        q.requires_grad_(True)
    toks = _tokens(cfg)
    logits, _ = tm.forward_train(cfg, model, toks)
    per = B // MESH[0]
    aux = sum(tm.forward_train(cfg, model, toks[i * per:(i + 1) * per])[1]
              for i in range(MESH[0])) / MESH[0]
    ((logits * _cotangent(cfg)).sum() + aux).backward()
    return cfg, model, logits.detach(), aux.detach()


def test_prefill_then_weight_stationary_decode_matches_dense(world):
    """The prefill with the experts over "model", then three decode steps
    on each rank's rows of the state under the decode rules: every rank's
    logits equal the dense path's within 1e-4."""
    _, ranks, coords = world
    cfg = _moe_cfg(100.0)
    model = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks, steps = _serve_inputs(cfg)
    logits, state = tm.prefill(cfg, model, tm.init_state(
        cfg, B, MAX_LEN, "cpu"), toks, LENGTHS)
    want = [logits]
    for t in range(steps.shape[0]):
        logits, state = tm.decode_step(cfg, model, state, steps[t],
                                       np.array(LENGTHS) + t)
        want.append(logits)
    for out, (d, _) in zip(ranks, coords):
        np.testing.assert_allclose(out["serve"][0], want[0],
                                   atol=NO_DROP_TOL, rtol=NO_DROP_TOL)
        for got, w in zip(out["serve"][1:], want[1:]):
            np.testing.assert_allclose(got, w[_rows(B, d)],
                                       atol=NO_DROP_TOL, rtol=NO_DROP_TOL)


def test_expert_weights_resharded_from_their_build(world):
    """The same prefill and decode steps from models built under the other
    layout's expert d_ff (the prefill's split over "data", as the param
    rules' FSDP builds them, and gathered; the decode's whole, and cut to
    the rank's d_ff): each rank's logits equal those of the models built
    in the layout they run in, within 1e-5 (f32; the same products, the
    same partial sums)."""
    _, ranks, _ = world
    for out in ranks:
        for got, want in zip(out["serve_resharded"], out["serve"]):
            np.testing.assert_allclose(got, want, atol=REF_TOL,
                                       rtol=REF_TOL)


def test_sharded_builds_hold_the_whole_models_values(world):
    """``init_params`` and ``from_jax_params`` under (mesh, rules) keep, on
    every rank, exactly the whole model's values of its shard of each
    leaf, in the prefill and the decode layouts."""
    _, ranks, _ = world
    assert all(out["same_values"] for out in ranks)


def _rows(n, d):
    per = n // MESH[0]
    return slice(d * per, (d + 1) * per)


def test_forward_train_matches_dense_without_drops(world, dense):
    """Each rank's logits (its data shard's rows) equal the dense path's
    within 1e-4, and its aux equals the mean of the shards' aux losses."""
    _, ranks, coords = world
    _, _, logits, aux = dense
    for out, (d, _) in zip(ranks, coords):
        np.testing.assert_allclose(out["logits"], logits[_rows(B, d)],
                                   atol=NO_DROP_TOL, rtol=NO_DROP_TOL)
        np.testing.assert_allclose(out["aux"], aux, atol=NO_DROP_TOL,
                                   rtol=NO_DROP_TOL)


def test_gradients_match_dense(world, dense):
    """Every leaf's gradient, summed over the data axis, is the dense
    path's (its expert slice for the expert leaves) within 2e-4 of the
    leaf's largest |gradient|; none is zero."""
    _, ranks, _ = world
    cfg, model, _, _ = dense
    rules = {"batch": ("data",), "experts": ("model",), "expert_ff": ()}
    axes = tm.params.param_axes(cfg)
    spec_mesh = types.SimpleNamespace(mesh_dim_names=AXES, shape=MESH)
    for r, out in enumerate(ranks):
        coord = dict(zip(AXES, divmod(r, MESH[1])))
        for name, q in model.named_parameters():
            want = q.grad
            spec = logical_to_pspec(axes[name], rules, tuple(want.shape),
                                    spec_mesh)
            want = want[local_slices(want.shape, spec, spec_mesh, coord)]
            got = out[f"grad.{name}"]
            scale = want.abs().max().item()
            assert scale > 0, name
            err = (got - want).abs().max().item()
            assert err <= GRAD_TOL * scale, (r, name, err, scale)


@pytest.mark.parametrize("kind", ["token", "stationary"])
def test_matches_reference_ep_path_with_drops(world, kind):
    """At capacity factor 0.5 (8 slots an expert for 16 pairs on average)
    pairs are dropped, and the port drops the reference's: each rank's
    rows of the layer's output and its aux equal the reference's
    ``shard_map`` path within 1e-5."""
    jax_out, ranks, coords = world
    y_ref = jax_out[f"y_{kind}"]
    k = get_config(ARCH, smoke=True).moe.top_k
    routed = sum(int(o[f"pairs_{kind}"][0]) for o in ranks)
    # every pair is routed to one EP rank of its data shard; the stationary
    # layout's data ranks each hold half of every expert's d_ff, all tokens
    assert routed == (B * S * k if kind == "token" else MESH[0] * B_DEC * k)
    assert sum(int(o[f"pairs_{kind}"][1]) for o in ranks) > 0, \
        "no pair was dropped"
    for out, (d, _) in zip(ranks, coords):
        np.testing.assert_allclose(out[f"y_{kind}"],
                                   y_ref[_rows(y_ref.shape[0], d)],
                                   atol=REF_TOL, rtol=REF_TOL)
        np.testing.assert_allclose(out[f"aux_{kind}"],
                                   jax_out[f"aux_{kind}"], atol=REF_TOL,
                                   rtol=REF_TOL)


def test_layer_gradients_match_reference_ep_path(world):
    """With pairs dropped (capacity factor 0.5), the gradients of <C, y> +
    aux through the token layout, the weights' summed over the data axis,
    equal ``jax.grad`` through the reference's ``shard_map`` path within
    2e-4 of each one's largest |gradient|: the input's rows of this rank's
    data shard, the experts' slice of this rank's EP index; and so do the
    router's and the input's gradients of the aux loss alone."""
    jax_out, ranks, coords = world
    cfg = _moe_cfg(DROP_CF)
    axes = {n: lf.axes for n, lf in tm.params._moe_ffn_leaves(cfg).items()}
    spec_mesh = types.SimpleNamespace(mesh_dim_names=AXES, shape=MESH)
    for out, (d, m) in zip(ranks, coords):
        want = jax_out["g_x"][_rows(B, d)]
        scale = np.abs(jax_out["g_x"]).max()
        assert np.abs(out["g_x"].numpy() - want).max() <= GRAD_TOL * scale
        for n in LAYER_LEAVES:
            g = jax_out[f"g_{n}"]
            spec = logical_to_pspec(axes[n], RULES["token"], g.shape,
                                    spec_mesh)
            want = g[local_slices(g.shape, spec, spec_mesh,
                                  {"data": d, "model": m})]
            err = np.abs(out[f"g_{n}"].numpy() - want).max()
            assert err <= GRAD_TOL * np.abs(g).max(), (n, d, m, err)
        # the aux loss alone: it is 0.01 of the rest, so held apart
        for n, rows in (("router", slice(None)), ("x", _rows(B, d))):
            g = jax_out[f"ga_{n}"]
            err = np.abs(out[f"ga_{n}"].numpy() - g[rows]).max()
            assert err <= GRAD_TOL * np.abs(g).max(), (n, d, m, err)


def test_dense_path_aux_is_the_whole_batchs(world):
    """Under the mesh with the batch over "data" and no "experts" axis, the
    dense path's aux is the reference's (jitted under the same mesh and
    rules): the Switch loss of the whole batch, not the mean of the
    shards' losses, which differs from it by far more than the tolerance.
    Its gradients agree too: the router's, summed over "data", and the
    input's rows of this rank's shard, within 2e-4 of each one's
    largest."""
    jax_out, ranks, coords = world
    cfg = _moe_cfg(DROP_CF)
    z = _layer_inputs()
    router = types.SimpleNamespace(router=torch.from_numpy(z["p_router"]))
    x = torch.from_numpy(z["x_token"])
    h = tops.rmsnorm(x, torch.from_numpy(z["p_ln2"]), cfg.norm_plus_one)
    shard_mean = sum(tops._router(cfg, router, h[_rows(B, d)])[2]
                     for d in range(MESH[0])) / MESH[0]
    want = float(jax_out["aux_dense"])
    assert abs(float(shard_mean) - want) > 100 * REF_TOL * abs(want)
    for out, (d, m) in zip(ranks, coords):
        np.testing.assert_allclose(float(out["aux_dense"]), want,
                                   rtol=REF_TOL)
        for n, rows in (("router", slice(None)), ("x", _rows(B, d))):
            g = jax_out[f"gd_{n}"]
            err = np.abs(out[f"gd_{n}"].numpy() - g[rows]).max()
            assert err <= GRAD_TOL * np.abs(g).max(), (n, d, m, err)


def test_reference_ep_gradients_equal_its_dense_ones(world):
    """The reference side: without drops, ``jax.grad`` through its
    ``shard_map`` EP path (``check_vma=False``) gives the dense path's
    gradients of <C, y> within 2e-4 of each one's largest (no gradient is
    counted once per EP rank)."""
    jax_out, _, _ = world
    for n in (*LAYER_LEAVES, "x"):
        assert jax_out[f"hazard_{n}"] <= GRAD_TOL, (n, jax_out[f"hazard_{n}"])


def test_capacity_drop_stays_finite(world):
    """The reference's capacity test, mirrored: at capacity factor 0.1 the
    dense path (no dropping there) and the EP path, which drops, give
    finite logits."""
    _, ranks, _ = world
    assert sum(int(o["dropped_cf01"]) for o in ranks) > 0
    assert all(torch.isfinite(o["logits_cf01"]).all() for o in ranks)
    cfg = _moe_cfg(0.1)
    model = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    logits, _ = tm.forward_train(cfg, model, _tokens(cfg)[:2])
    assert torch.isfinite(logits).all()


def test_router_aux_loss_increases_with_imbalance():
    """The reference's router test, mirrored, and the port's aux equal to
    the reference's on both routers."""
    cfg = get_config(ARCH, smoke=True)
    d, e = cfg.d_model, cfg.moe.num_experts
    rng = np.random.RandomState(0)
    # positive activations so the skewed column is dominant for EVERY token
    h = np.abs(rng.standard_normal((1, 32, d))).astype(np.float32)
    balanced = (1e-3 * rng.standard_normal((d, e))).astype(np.float32)
    skew = np.zeros((d, e), np.float32)
    skew[:, 0] = 5.0
    auxes = []
    for router in (balanced, skew):
        _, _, aux = tops._router(cfg, types.SimpleNamespace(
            router=torch.from_numpy(router)), torch.from_numpy(h))
        _, _, jaux = jops._router(jget_config(ARCH, smoke=True),
                                  {"router": jax.numpy.asarray(router)},
                                  jax.numpy.asarray(h))
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
        auxes.append(float(aux))
    assert auxes[1] > auxes[0]


@pytest.fixture(scope="module")
def train_reference():
    """The single-process step of the whole batch for each of TRAIN_CASES:
    the gradients of the global objective, then ``adamw_update``: its grad
    norm, loss and updated leaves.  The objective is the whole batch's
    mean CE plus the reference's aux under the mesh: on the EP path
    ("ep", "fsdp") the mean of the two batch shards' aux losses (its
    ``shard_map`` takes their ``pmean``), on the dense path ("dense") the
    whole batch's aux (no ``shard_map`` there); Llama has none."""
    from repro_torch.training import adamw_init, adamw_update, lm_loss
    out = {}
    for case, (arch, _, rules) in TRAIN_CASES.items():
        cfg = _train_cfg(arch)
        model = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        opt = adamw_init(model, _train_opt())
        toks, labels = _train_batch(cfg)
        model.requires_grad_(True)
        _, parts = lm_loss(cfg, model, toks, labels)
        aux = parts["aux"]
        if rules["experts"]:
            per = B // MESH[0]
            aux = sum(lm_loss(cfg, model, toks[i * per:(i + 1) * per],
                              labels[i * per:(i + 1) * per])[1]["aux"]
                      for i in range(MESH[0])) / MESH[0]
        loss = parts["ce"] + aux
        named = dict(model.named_parameters())
        grads = dict(zip(named, torch.autograd.grad(
            loss, list(named.values()), allow_unused=True,
            materialize_grads=True)))
        _, _, m = adamw_update(_train_opt(), grads, opt, model)
        out[case] = (cfg, grads, loss.detach(), m["grad_norm"],
                     {n: q.detach().clone() for n, q in named.items()})
    return out


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_sharded_train_step_is_the_global_batch_step(world, train_reference,
                                                     case):
    """``make_train_step`` under the mesh (2 batch shards x 4 EP ranks)
    takes the single-process step of the whole batch: every leaf's reduced
    gradient (its shard, as the model was built, for an expert leaf)
    within 2e-4 of the leaf's largest |gradient|, the loss and grad norm
    within 1e-5 relative, and the updated leaves.  The first AdamW step
    moves an element by lr g / (|g| + eps) (plus the decay, the same on
    both sides): where |g| is at least 1e-2 of the leaf's largest, the
    gradients' 2e-4 cannot change its sign and the move is lr within
    1e-6, so the leaves agree within 1e-5 there; elsewhere a gradient
    within the tolerance of zero may move either way, by at most 2 lr."""
    _, ranks, _ = world
    _, rules, _ = TRAIN_CASES[case]
    cfg, grads, loss, gnorm, params = train_reference[case]
    lr = float(_train_opt().lr)
    axes = tm.params.param_axes(cfg)
    spec_mesh = types.SimpleNamespace(mesh_dim_names=AXES, shape=MESH)
    for r, out in enumerate(ranks):
        got = out[f"train.{case}"]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], gnorm, rtol=1e-5)
        coord = dict(zip(AXES, divmod(r, MESH[1])))
        for name, want in grads.items():
            spec = logical_to_pspec(axes[name], rules, tuple(want.shape),
                                    spec_mesh)
            cut = local_slices(want.shape, spec, spec_mesh, coord)
            scale = want.abs().max().item()
            err = (got["grads"][name] - want[cut]).abs().max().item()
            assert err <= GRAD_TOL * scale, (case, r, name, err, scale)
            sure = want[cut].abs() >= 1e-2 * scale
            moved = (got["params"][name] - params[name][cut]).abs()
            assert (moved[sure] <= 1e-5).all(), (case, r, name)
            assert (moved <= 2 * lr + 1e-6).all(), (case, r, name)


# ---------------------------------------------------------------------------
# tensor parallelism and the context-split cache (A18), checkpoints (C7)
# ---------------------------------------------------------------------------

TP_TOL = 2e-4


@pytest.fixture(scope="module")
def tp_single():
    """The port's single process of each of TP_CASES, whole on the CPU."""
    out = {}
    toks, lens = _tp_tokens(), np.array(TP_LENGTHS)
    for name, arch, kv8, batch, chunk in TP_CASES:
        cfg = _tp_cfg(arch, kv8)
        model = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        with torch.no_grad():
            out[name] = _tp_run(cfg, model, toks[:batch], lens[:batch],
                                chunk, TP_CHUNK_STEPS if chunk else TP_STEPS)
    return out


@pytest.mark.parametrize("case", [c[0] for c in TP_CASES])
def test_tensor_parallel_serving_matches_single_and_reference(
        world, tp_single, case):
    """Prefill and greedy decode of each TP case (the cache over "ctx":
    over "model", or over ("data", "model") under the B = 1 rule; a chunk
    at offset 48; the int8 cache) on every rank: the logits of its rows
    within 2e-4 of max |logit| of the port's single process and of the
    reference's ``prefill`` / ``decode_step`` jitted under its act rules
    on the same mesh, and the greedy tokens equal to both."""
    jax_out, ranks, coords = world
    want, want_tok = tp_single[case]
    batch = dict((c[0], c[3]) for c in TP_CASES)[case]
    ref, ref_tok = jax_out[f"tp_{case}"], jax_out[f"tp_{case}_tokens"]
    scale = want.abs().max().item()
    assert np.abs(want.numpy() - ref).max() <= TP_TOL * scale
    np.testing.assert_array_equal(want_tok.numpy(), ref_tok)
    for out, (d, m) in zip(ranks, coords):
        got, tok = out[f"tp.{case}"]
        rows = _rows(B, d) if batch > 1 else slice(0, 1)
        err = (got - want[:, rows]).abs().max().item()
        assert err <= TP_TOL * scale, (case, d, m, err, scale)
        assert torch.equal(tok, want_tok[:, rows]), (case, d, m)


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_tensor_parallel_gradients_match_single(world, arch):
    """``forward_train`` under tensor parallelism: each rank's logits (its
    rows, whole vocab) within 2e-4 of the single process's, and every
    leaf's gradient of <C, logits>, summed over "data", within 2e-4 of the
    leaf's largest |gradient|: a split leaf's the rank's slice, a leaf
    replicated over "model" (norms) whole and bit-equal on the ranks of
    "model", none zero."""
    from repro_torch.configs import InputShape
    from repro_torch.launch.mesh import param_rules
    _, ranks, coords = world
    cfg = _tp_cfg(arch)
    model = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    model.requires_grad_(True)
    logits, _ = tm.forward_train(cfg, model, _tokens(cfg))
    (logits * _cotangent(cfg)).sum().backward()
    rules = param_rules(cfg, InputShape("train", S, B, "train"), False)
    axes = tm.params.param_axes(cfg)
    spec_mesh = types.SimpleNamespace(mesh_dim_names=AXES, shape=MESH)
    split = 0
    for r, (out, (d, m)) in enumerate(zip(ranks, coords)):
        got = out[f"tp_grad.{arch}"]
        scale = logits.abs().max().item()
        assert (got["logits"] - logits[_rows(B, d)].detach()).abs().max() \
            <= TP_TOL * scale
        for name, q in model.named_parameters():
            spec = logical_to_pspec(axes[name], rules, tuple(q.shape),
                                    spec_mesh)
            want = q.grad[local_slices(q.shape, spec, spec_mesh,
                                       {"data": d, "model": m})]
            g = got["grads"][name]
            top = q.grad.abs().max().item()
            assert top > 0, name
            assert (g - want).abs().max().item() <= GRAD_TOL * top, \
                (arch, r, name)
            if "model" not in str(spec):
                first = ranks[d * MESH[1]][f"tp_grad.{arch}"]["grads"][name]
                assert torch.equal(g, first), (arch, r, name)
            else:
                split += 1
    assert split > 0


def _npz_members(path):
    import zipfile
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


@pytest.mark.parametrize("name", ["kimi", "llama"])
def test_sharded_checkpoint_is_the_whole_models(world, ckpt_dir, tmp_path,
                                                name):
    """C7: the checkpoint every rank saved of a sharded model (Kimi K2
    SMOKE's experts over "model" and their d_ff over "data"; Llama SMOKE
    under tensor parallelism) holds the whole model's: ``index.json`` and
    every array of every ``.npz`` byte for byte equal to the whole
    model's ``save`` (the zip headers carry the writing time, so the
    members are compared); the reference's ``restore`` reads it into its
    own tree, with the whole model's values; and the restore into a model
    built under the same rules gave every rank its shards, bit-equal, at
    their local shapes."""
    from repro.models import init_params as jinit
    from repro.training.checkpoint import restore as jrestore
    from repro_torch.training import checkpoint
    _, ranks, coords = world
    cfg, rules = _ckpt_cases()[name]
    whole = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    checkpoint.save(str(tmp_path / name), whole, step=7)
    got, want = ckpt_dir / name, tmp_path / name
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    assert (got / "index.json").read_bytes() \
        == (want / "index.json").read_bytes()
    for f in os.listdir(want):
        if f.endswith(".npz"):
            assert _npz_members(got / f) == _npz_members(want / f), f
    jcfg = jget_config({"kimi": ARCH, "llama": "llama31_8b"}[name],
                       smoke=True).replace(dtype="float32",
                                           param_dtype="float32")
    tree, step = jrestore(str(got), like=jinit(jcfg, jax.random.PRNGKey(0)))
    assert step == 7
    theirs = _flatten(jax.tree.map(np.asarray, tree))
    for path, a in _flatten(tm.to_jax_params(cfg, whole)).items():
        np.testing.assert_array_equal(theirs[path], a)
    axes = tm.params.param_axes(cfg)
    spec_mesh = types.SimpleNamespace(mesh_dim_names=AXES, shape=MESH)
    shapes = [tuple(sl.stop - sl.start for sl in local_slices(
        q.shape, logical_to_pspec(axes[n], rules, tuple(q.shape), spec_mesh),
        spec_mesh, {"data": 0, "model": 0}))
        for n, q in whole.named_parameters()]
    assert shapes != [tuple(q.shape) for q in whole.parameters()]
    for out in ranks:
        step, same, local = out[f"ckpt.{name}"]
        assert (step, same, local) == (7, True, shapes)
