"""The port's sharding rules against the reference package's: the logical ->
mesh-axis mapping (``sharding.logical_to_pspec``), the parameters' and
state's logical axes (``models.params.param_axes`` / ``state_axes``), the
production rule tables and input shapes (``launch.mesh``,
``configs.input_specs``), and, on the production mesh over a ``fake``
process group of 256 / 512 ranks, each leaf's local shard against
DTensor's own arithmetic.  All exact.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro import sharding as jsharding
from repro.configs import base as jbase
from repro.launch import mesh as jmesh
from repro.models import params as jparams
from repro_torch import sharding
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, get_config,
                                 input_specs, long_context_variant)
from repro_torch.launch import mesh as tmesh
from repro_torch.models import params as tparams

LOGICAL = tuple(sharding.DEFAULT_RULES)
MESH_AXES = ("pod", "data", "model")


class _JaxMesh:
    """What the reference reads of a mesh: ``shape``, {axis: size}."""

    def __init__(self, sizes):
        self.shape = dict(sizes)


def _meshes(sizes):
    """The same mesh sizes as the reference and the port read them."""
    return _JaxMesh(sizes), types.SimpleNamespace(
        mesh_dim_names=tuple(sizes), shape=tuple(sizes.values()))


def _same(axes, rules, shape=None, sizes=None):
    jm, tm = _meshes(sizes) if sizes else (None, None)
    want = jsharding.logical_to_pspec(axes, rules, shape, jm)
    assert sharding.logical_to_pspec(axes, rules, shape, tm) == tuple(want)


def test_logical_to_pspec_reference_cases():
    """tests/test_sharding_and_roofline.py's three cases."""
    rules = {"batch": ("pod", "data"), "heads": ("model",), "embed": ()}
    assert sharding.logical_to_pspec(("batch", None, "heads"), rules) \
        == (("pod", "data"), None, "model")
    assert sharding.logical_to_pspec(("embed",), rules) == ()
    _same(("batch", None, "heads"), rules)
    _same(("embed",), rules)
    # 4 KV heads cannot shard over a 16-way model axis -> replicated
    for n in (4, 32):
        _same(("kv_heads",), {"kv_heads": ("model",)}, (n,), {"model": 16})
    # "data" already used by batch -> ctx keeps only "model"
    rules = {"batch": ("data",), "ctx": ("data", "model")}
    assert sharding.logical_to_pspec(("batch", "ctx"), rules) \
        == ("data", "model")


@pytest.mark.parametrize("seed", range(6))
def test_logical_to_pspec_sweep(seed):
    """Seeded axes, rules (ordered subsets of the mesh axes), shapes and
    mesh sizes, with and without the divisibility drop."""
    rng = np.random.RandomState(seed)
    for _ in range(60):
        rules = {}
        for name in LOGICAL:
            k = rng.randint(0, 3)
            rules[name] = tuple(rng.permutation(MESH_AXES)[:k].tolist())
        rank = rng.randint(0, 5)
        axes = tuple(None if rng.rand() < 0.25 else
                     str(rng.choice(LOGICAL)) for _ in range(rank))
        sizes = {a: int(rng.choice([1, 2, 3, 4, 16])) for a in MESH_AXES}
        shape = tuple(int(rng.choice([1, 2, 4, 6, 12, 32, 48]))
                      for _ in range(rank))
        _same(axes, rules)
        _same(axes, rules, shape, sizes)


def _reference_leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _is_axes(x):
    return isinstance(x, tuple)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_equal_reference(arch):
    """Each parameter's axes are the reference leaf's (with the stacked
    leaves' leading None), every reference leaf has them, and each leaf's
    axes count equals its rank."""
    cfg = get_config(arch, smoke=True)
    model = tparams.abstract_params(cfg)
    mine = tparams.param_axes(cfg)
    ref = jparams.param_axes(jbase.get_config(arch, smoke=True))
    paths = tparams.reference_paths(model)
    ref_paths = {"/".join(str(k.key) for k in kp) for kp, _ in
                 jax.tree_util.tree_flatten_with_path(ref,
                                                      is_leaf=_is_axes)[0]}
    assert set(paths) == ref_paths
    for path, (names, stacked) in paths.items():
        want = _reference_leaf(ref, path)
        for n in names:
            assert ((None, *mine[n]) if stacked else mine[n]) == want, path
    named = dict(model.named_parameters())
    assert set(mine) == set(named)
    for n, axes in mine.items():
        assert len(axes) == named[n].ndim, n


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_axes_equal_reference(arch):
    """The state's axes per layer are the reference's (prefix/l{i}, or
    blocks/p{j} stacked), and each leaf's axes count equals its rank."""
    cfg = get_config(arch, smoke=True)
    mine = tparams.state_axes(cfg, 2, 8)
    ref = jparams.state_axes(jbase.get_config(arch, smoke=True), 2, 8)
    P = len(cfg.block_pattern)
    for i, layer in enumerate(mine):
        if i < cfg.first_k_dense:
            want, lead = ref["prefix"][f"l{i}"], ()
        else:
            want, lead = ref["blocks"][f"p{(i - cfg.first_k_dense) % P}"], \
                (None,)
        assert {n: (*lead, *a) for n, a in layer.items()} == want, i
    for layer, st in zip(mine, tparams.abstract_state(cfg, 2, 8)):
        assert set(layer) == set(st)
        for n, axes in layer.items():
            assert len(axes) == st[n].ndim, n


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pspec_trees_equal_reference(arch):
    """``pspec_tree_from_logical`` of the published config's parameter axes
    under the train param rules on a 16 x 16 mesh (indivisible mappings
    dropped leaf by leaf): the reference's specs, a stacked leaf's with
    its leading None."""
    cfg, jcfg = get_config(arch), jbase.get_config(arch)
    rules = tmesh.param_rules(cfg, INPUT_SHAPES["train_4k"], False)
    jm, tm_ = _meshes({"data": 16, "model": 16})
    model = tparams.abstract_params(cfg)
    mine = sharding.pspec_tree_from_logical(
        tparams.param_axes(cfg), rules, dict(model.named_parameters()), tm_)
    ref = jsharding.pspec_tree_from_logical(
        jparams.param_axes(jcfg), rules, jparams.abstract_params(jcfg), jm)
    for path, (names, stacked) in tparams.reference_paths(model).items():
        want = tuple(_reference_leaf(ref, path))
        for n in names:
            assert ((None, *mine[n]) if stacked and mine[n]
                    else mine[n]) == want, (path, n)


_DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_and_input_specs_equal_reference(arch):
    """act_rules, param_rules, needs_fsdp, long_context_variant and
    input_specs of the published config, for every input shape, single-
    and multi-pod."""
    cfg, jcfg = get_config(arch), jbase.get_config(arch)
    lcv, jlcv = long_context_variant(cfg), jbase.long_context_variant(jcfg)
    assert (lcv is None) == (jlcv is None)
    if lcv is not None:
        assert dataclasses.asdict(lcv) == dataclasses.asdict(jlcv)
    for name, shape in INPUT_SHAPES.items():
        jshape = jbase.INPUT_SHAPES[name]
        assert dataclasses.asdict(shape) == dataclasses.asdict(jshape)
        assert tmesh.needs_fsdp(cfg, shape) == jmesh.needs_fsdp(jcfg, jshape)
        for mp in (False, True):
            assert tmesh.act_rules(shape, mp) == jmesh.act_rules(jshape, mp)
            assert tmesh.param_rules(cfg, shape, mp) \
                == jmesh.param_rules(jcfg, jshape, mp)
        specs = input_specs(cfg, shape)
        want = jbase.input_specs(jcfg, jshape)
        assert list(specs) == list(want)
        for k, t in specs.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == want[k].shape
            assert t.dtype == _DTYPES[want[k].dtype.type], k


@pytest.fixture(scope="module", params=[False, True],
                ids=["single_pod", "multi_pod"])
def production(request):
    """The production mesh over a fake process group, as rank 37."""
    world = 512 if request.param else 256
    dist.init_process_group("fake", store=FakeStore(), rank=37,
                            world_size=world)
    try:
        yield request.param, tmesh.make_production_mesh(
            "cpu", multi_pod=request.param)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["kimi_k2_1t_a32b", "deepseek_v2_lite_16b",
                                  "jamba_v0_1_52b", "qwen25_32b"])
def test_local_shards_on_the_production_mesh(production, arch):
    """For every leaf of the published config under the train and decode
    param rules: the local shard's shape is the leaf's shape divided by
    its spec's mesh-axis sizes, and its shape and offset are DTensor's for
    ``placements`` of that spec on this rank."""
    multi_pod, mesh = production
    assert mesh.mesh_dim_names == (("pod", "data", "model") if multi_pod
                                   else ("data", "model"))
    assert tuple(mesh.shape) == ((2, 16, 16) if multi_pod else (16, 16))
    sizes = sharding.mesh_axes(mesh)
    cfg = get_config(arch)
    named = dict(tparams.abstract_params(cfg).named_parameters())
    axes = tparams.param_axes(cfg)
    split = 0
    for kind in ("train_4k", "decode_32k"):
        rules = tmesh.param_rules(cfg, INPUT_SHAPES[kind], multi_pod)
        for n, t in named.items():
            shape = tuple(t.shape)
            spec = sharding.logical_to_pspec(axes[n], rules, shape, mesh)
            cut = sharding.local_slices(shape, spec, mesh)
            local = tuple(s.stop - s.start for s in cut)
            want = list(shape)
            for d, entry in enumerate(spec):
                for a in sharding._entry_axes(entry):
                    want[d] //= sizes[a]
            assert local == tuple(want), (n, spec)
            dt_shape, dt_offset = compute_local_shape_and_global_offset(
                shape, mesh, sharding.placements(spec, mesh))
            assert (tuple(dt_shape), tuple(dt_offset)) \
                == (local, tuple(s.start for s in cut)), (n, spec)
            split += local != shape
    assert split > 0
