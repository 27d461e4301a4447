"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's (``repro.launch.roofline``):

* ``model_flops_estimate`` equals the reference's for every arch x input
  shape;
* ``count_step``'s FLOPs of one step on ``meta`` equal the reference's
  ``analyze_hlo`` count of the jitted step's optimized HLO, for four
  SMOKE configs (dense attention, MLA + MoE, RWKV-6, Jamba) at B = 2,
  S = 32: prefill and decode within 1%, the train step (remat) within 5%;
* a folded scan (``repro_torch.scan``: one step counted n times) counts
  what the eager loop of n steps counts;
* the collectives of one expert-parallel MoE layer under a ``fake``
  process group are the ones its shapes give.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCH_IDS, INPUT_SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import roofline as jroofline
from repro.models import decode_step as jdecode_step
from repro.models import prefill as jprefill
from repro.models.params import abstract_params as jabstract_params
from repro.models.params import abstract_state as jabstract_state
from repro.training import AdamWConfig as JAdamWConfig
from repro.training import adamw_init as jadamw_init
from repro.training import make_train_step as jmake_train_step
from repro_torch import scan
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch import roofline
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.models.params import abstract_state
from repro_torch.training import AdamWConfig, adamw_init, make_train_step

B, S = 2, 32
TOL = {"prefill": 0.01, "decode": 0.01, "train": 0.05}


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_estimate_equals_reference(arch, shape):
    assert roofline.model_flops_estimate(get_config(arch),
                                         INPUT_SHAPES[shape]) \
        == jroofline.model_flops_estimate(jget_config(arch), JSHAPES[shape])


def _hlo_flops(fn, *args) -> float:
    return jroofline.analyze_hlo(
        jax.jit(fn).lower(*args).compile().as_text()).flops


def _meta_ints(*shape):
    return torch.empty(shape, dtype=torch.int32, device="meta")


def _reference_flops(arch, kind):
    cfg = jget_config(arch, smoke=True)
    params = jabstract_params(cfg)
    ints = jax.ShapeDtypeStruct
    if kind == "train":
        opt = jax.eval_shape(lambda p: jadamw_init(p, JAdamWConfig()), params)
        step = jmake_train_step(cfg, JAdamWConfig(), donate=False,
                                remat=True)
        return _hlo_flops(lambda p, o, t, l: step(p, o, t, l), params, opt,
                          ints((B, S), jnp.int32), ints((B, S), jnp.int32))
    state = jabstract_state(cfg, B, S)
    if kind == "prefill":
        return _hlo_flops(lambda p, s, t, n: jprefill(cfg, p, s, t, n),
                          params, state, ints((B, S), jnp.int32),
                          ints((B,), jnp.int32))
    return _hlo_flops(lambda p, s, t, n: jdecode_step(cfg, p, s, t, n),
                      params, state, ints((B,), jnp.int32),
                      ints((B,), jnp.int32))


def _port_counts(arch, kind, S=S):
    cfg = get_config(arch, smoke=True)
    params = init_params(cfg, None, "meta")
    if kind == "train":
        step = make_train_step(cfg, AdamWConfig(), remat=True, device="meta",
                               plain_kernels=True)
        return roofline.count_step(step, params, adamw_init(params,
                                                            AdamWConfig()),
                                   _meta_ints(B, S), _meta_ints(B, S))
    state = abstract_state(cfg, B, S)
    if kind == "prefill":
        return roofline.count_step(
            lambda *a: prefill(cfg, *a, plain_kernels=True), params, state,
            _meta_ints(B, S), np.full(B, S))
    return roofline.count_step(
        lambda *a: decode_step(cfg, *a, plain_kernels=True), params, state,
        _meta_ints(B), np.full(B, S - 1))


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ["llama31_8b", "deepseek_v2_lite_16b",
                                  "rwkv6_3b", "jamba_v0_1_52b"])
def test_counted_flops_equal_reference_hlo(arch, kind):
    """The reference's dry-run compiles its jnp path (no Pallas), and the
    port's counts its plain path: the same matmuls, so the same 2 M N K
    FLOPs, where the reference reads them off the HLO (each ``dot`` times
    its loop's trip count) and the port off the dispatched ops (each scan
    folded).  The train step checkpoints each block in both."""
    want = _reference_flops(arch, kind)
    got = _port_counts(arch, kind).flops
    ratio = got / want
    assert abs(ratio - 1) <= TOL[kind], \
        f"{arch} {kind}: counted {got:.6g} / HLO {want:.6g} = {ratio:.5f}"


@contextlib.contextmanager
def _unfolded():
    """count_step with the scans run as their eager loops."""
    folding = roofline.scan.folding
    roofline.scan.folding = contextlib.nullcontext
    try:
        yield
    finally:
        roofline.scan.folding = folding


@pytest.mark.parametrize("arch", ["rwkv6_3b", "jamba_v0_1_52b"])
@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_folded_scan_counts_the_loop(arch, kind):
    """Folding a scan (one step counted n times) counts what the eager loop
    of n steps counts, at S = 64 (4 WKV6 chunks, 64 Mamba tokens): FLOPs
    within 1%, HBM bytes and peak bytes within 10%.  They are not exact:
    the folded backward takes the carry's gradient on every step (the loop
    skips it on the first, whose carry needs none), it sums the n steps'
    gradients of each sequence and constant in one stand-in add of n - 1
    times the bytes, and it holds n times one step's saved bytes in one
    block; the folded prefill keeps one step's output where the loop keeps
    a list of them until they are concatenated."""
    got, want = (_port_counts_at(arch, kind, 64, fold)
                 for fold in (True, False))
    assert abs(got.flops / want.flops - 1) <= 0.01, (got.flops, want.flops)
    assert abs(got.hbm_bytes / want.hbm_bytes - 1) <= 0.10, \
        (got.hbm_bytes, want.hbm_bytes)
    assert abs(got.memory["peak_bytes"] / want.memory["peak_bytes"] - 1) \
        <= 0.10, (got.memory, want.memory)


def _port_counts_at(arch, kind, seq, fold):
    with contextlib.nullcontext() if fold else _unfolded():
        return _port_counts(arch, kind, seq)


def test_scan_runs_the_loop_off_meta():
    """Folding changes nothing on a device with data: the same values as
    the loop, bit for bit."""
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(2, 12, 3, generator=g) for _ in range(2)]

    def step(c, x, w):
        c = c * 0.5 + x[0][:, 0] * w + x[1][:, 0]
        return c, c[:, None] * 2

    want = scan.scan(step, torch.zeros(2, 3), xs, 12, consts=(torch.ones(3),))
    with scan.folding():
        got = scan.scan(step, torch.zeros(2, 3), xs, 12,
                        consts=(torch.ones(3),))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_collectives_of_one_ep_moe_layer():
    """One expert-parallel MoE layer of Kimi K2 SMOKE (E = 8 over "model"
    of 4; 2 rows of 16 tokens a data shard) under a fake group of 8 ranks,
    mesh (2, 4), forward and backward.  The token layout: the outputs'
    all-reduce (T d), the aux's (1), and backward the tokens' and routing
    weights' entry into the group (T d, T k), all f32.  Built with expert
    d_ff over "data" (as the param rules' FSDP), each expert weight is
    gathered forward and its gradient reduce-scattered backward."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.models import ops
    from repro_torch.models.params import DecoderLayer, _set_leaf, built_axes
    from repro_torch.sharding import axis_rules, local_slices, logical_to_pspec
    cfg = get_config("kimi_k2_1t_a32b", smoke=True).replace(
        dtype="float32", param_dtype="float32")
    m = cfg.moe
    d, k, E, f = cfg.d_model, m.top_k, m.num_experts, m.d_ff_expert
    Bl, Sl = 2, 16
    T = Bl * Sl
    act = {"batch": ("data",), "experts": ("model",), "expert_ff": ()}
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data",
                                                               "model"))
        spec = next(s for s in cfg.layer_specs if s.ffn == "moe")
        got = {}
        for built in ({}, {"expert_ff": ("data",)}):
            rules = {**act, **built}
            layer = DecoderLayer(cfg, spec, "meta")
            for n, lf in layer.leaves.items():
                cut = local_slices(lf.shape, logical_to_pspec(
                    lf.axes, rules, lf.shape, mesh), mesh)
                _set_leaf(layer, n, torch.empty(lf.shape, device="meta")[cut])
            layer.shard_rules = rules
            assert built_axes(layer, "we_gate", mesh)[2] \
                == built.get("expert_ff", ())
            layer.requires_grad_(True)
            x = torch.empty(Bl, Sl, d, device="meta", requires_grad=True)

            def run():
                with axis_rules(act, mesh):
                    y, aux = ops.apply_moe_ffn(cfg, layer, x)
                torch.autograd.grad(y.sum() + aux, [x, *layer.parameters()],
                                    allow_unused=True)
            got[bool(built)] = roofline.count_step(run)
    finally:
        dist.destroy_process_group()
    token = {"all-reduce": 4 * (T * d + 1 + T * d + T * k)}
    assert got[False].collectives == token
    assert got[False].collective_counts == {"all-reduce": 4}
    shard = (E // 4) * d * (f // 2) * 4          # one rank's expert leaf
    assert got[True].collectives == {
        **token, "all-gather": 3 * 2 * shard, "reduce-scatter": 3 * shard}
    assert got[True].collective_counts == {"all-reduce": 4,
                                           "all-gather": 3,
                                           "reduce-scatter": 3}
    assert got[True].collective_bytes == sum(got[True].collectives.values())
