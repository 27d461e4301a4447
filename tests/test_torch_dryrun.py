"""The port's dry-run (``repro_torch.launch.dryrun``) and its report
(``repro_torch.launch.roofline_report``) against the reference's
(``repro/launch/dryrun.py``, ``benchmarks/roofline_report.py``): one
rank's step on ``meta`` inside a ``fake`` process group of the production
mesh's size, made and destroyed around each use (``dryrun.fake_group``)."""
import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch.distributed as dist

from benchmarks import roofline_report as jreport
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import roofline_report as treport
from repro_torch.models.params import (DTYPES, _layer_state_leaves,
                                       param_axes, state_axes)
from repro_torch.sharding import local_slices, logical_to_pspec

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """``dryrun.main`` for qwen2_0_5b decode_32k on both meshes, then the
    yi_9b long_500k skip, appended to one records file."""
    out = tmp_path_factory.mktemp("dryrun") / "results.jsonl"
    rc = dryrun.main(["--arch", "qwen2_0_5b", "--shape", "decode_32k",
                      "--both-meshes", "--out", str(out)])
    rc_skip = dryrun.main(["--arch", "yi_9b", "--shape", "long_500k",
                           "--out", str(out)])
    assert not dist.is_initialized()
    return rc, rc_skip, [json.loads(line) for line in open(out)], out


def test_main_runs_qwen2_decode_32k(records):
    rc, _, recs, _ = records
    assert rc == 0
    single, multi = recs[:2]
    assert (single["status"], single["chips"], single["mesh"]) \
        == ("ok", 256, "16x16")
    assert (multi["status"], multi["chips"], multi["mesh"]) \
        == ("ok", 512, "2x16x16")
    for rec in (single, multi):
        for key in ("arch", "shape", "t_compute_s", "t_memory_s",
                    "t_collective_s", "t_trace_s", "bottleneck",
                    "model_flops", "flops_global", "useful_ratio",
                    "collective_bytes_per_chip", "collectives", "memory"):
            assert key in rec, key
        assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                      "temp_bytes"}
        # tensor parallelism over "model" and the cache over "ctx": per
        # layer the row-parallel outputs' all-reduces (attention, FFN) and
        # the all-gathers of q (14 heads do not split 16 ways), the new k
        # and v (to their owner), the slices' o and lse; the embedding's
        # all-reduce and the logits' all-gather once
        L = 24
        assert rec["collectives"]["all-reduce"]["count"] == 2 * L + 1
        assert rec["collectives"]["all-gather"]["count"] == 5 * L + 1
        assert set(rec["collectives"]) == {"all-reduce", "all-gather"}
        assert rec["collective_bytes_per_chip"] == sum(
            c["bytes"] for c in rec["collectives"].values()) > 0
        assert rec["flops_global"] > 0 and rec["bottleneck"] == "memory"


def _reference_skip_reason() -> str:
    """The reason string of the reference's skip record, read from its
    source (importing it would set XLA_FLAGS for this process)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "reason":
                    return ast.literal_eval(v)
    raise AssertionError("no skip reason in the reference")


def test_long_500k_skip_has_the_reference_reason(records):
    _, rc, recs, _ = records
    assert rc == 0
    skip = recs[2]
    assert skip == {"arch": "yi_9b", "shape": "long_500k", "mesh": "16x16",
                    "status": "skipped", "reason": _reference_skip_reason()}


def test_report_renders_as_the_reference(records):
    """The port's report is the reference's render, and renders the same
    records file to the same markdown."""
    path = str(records[3])
    assert treport.render(treport.load(path)) \
        == jreport.render(jreport.load(path))


def _shard_bytes(shape, axes, rules, mesh, dtype) -> int:
    spec = logical_to_pspec(axes, rules, tuple(shape), mesh)
    n = 1
    for sl in local_slices(tuple(shape), spec, mesh):
        n *= sl.stop - sl.start
    return n * dtype.itemsize


@pytest.mark.parametrize("arch", ["llama31_8b", "deepseek_v2_lite_16b",
                                  "qwen25_32b"])
def test_argument_bytes_are_the_local_shards(arch):
    """On the 256-rank mesh, decode_32k's argument bytes are the sum of
    each parameter's, cache leaf's and input's local shard bytes
    (``sharding.local_slices`` of its spec under the build's rules):
    DeepSeek-V2-Lite's experts split over "model" (and their d_ff over
    "data" for decode), the batch of 128 over "data"; Qwen-2.5-32B under
    tensor parallelism, every weight's flattened heads, d_ff or vocab over
    "model" and the cache over "ctx", 8.39 GB a rank where whole leaves
    and cache took 134.2 GB."""
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.launch.mesh import act_rules, param_rules, port_rules
    with dryrun.fake_group(False):
        fn, args, cfg, mesh, rules_a, shape = dryrun.build_dryrun(
            arch, "decode_32k", multi_pod=False)
        rules_p = port_rules(param_rules(cfg, INPUT_SHAPES["decode_32k"],
                                         False), cfg)
        assert rules_a == port_rules(act_rules(shape, False), cfg)
        model = args[0]
        dt = DTYPES[cfg.param_dtype]
        want = sum(
            _shard_bytes(lf.shape, param_axes(cfg)[n], rules_p, mesh,
                         DTYPES[lf.dtype] if lf.dtype else dt)
            for n, lf in ((n, _leaf(model, n)) for n, _ in
                          model.named_parameters()))
        for spec, axes in zip(cfg.layer_specs, state_axes(cfg)):
            for n, lf in _layer_state_leaves(cfg, spec, 128,
                                             32768).items():
                want += _shard_bytes(lf.shape, axes[n], rules_a, mesh,
                                     DTYPES[lf.dtype])
        want += (128 // 16) * 4                  # last_tokens, int32
        assert roofline.argument_bytes(*args) == want
        assert isinstance(args[3], np.ndarray)   # cur_lens: host ints
        if arch == "qwen25_32b":
            assert 8.0e9 < want < 8.6e9
    assert not dist.is_initialized()


def _leaf(model, name):
    *path, leaf = name.split(".")
    mod = model
    for p in path:
        mod = getattr(mod, p) if not p.isdigit() else mod[int(p)]
    return mod.leaves[leaf]


def test_build_refuses_a_group_of_another_size():
    """A group that the dry-run did not make is not replaced."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        with pytest.raises(RuntimeError, match="8 ranks"):
            dryrun.build_dryrun("qwen2_0_5b", "decode_32k", multi_pod=False)
    finally:
        dist.destroy_process_group()
