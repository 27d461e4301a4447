"""Multi-pod dry-run of the port: one rank's step of every (architecture x
input shape x mesh), run on the ``meta`` device, and its roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out results.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --jobs 6

The counterpart of the reference package's ``launch/dryrun.py``, which
lowers and compiles the global step over 256 or 512 placeholder devices
through XLA's SPMD pipeline.  PyTorch has no SPMD partitioner, and the
port's models compute on each rank's local shards with explicit
collectives (tensor parallelism and the context-split cache, FSDP of
"embed", expert parallelism, all under the reference's own rule tables),
so the port's dry-run runs one rank's step itself:

  * inside a ``fake`` process group of the production mesh's size (its
    collectives return at once and move nothing), made for the step and
    destroyed after it (``fake_group``);
  * with the parameters (``init_params(..., mesh, rules)`` under
    ``param_rules(...)``), the optimizer state
    (``adamw_init``), the caches (``abstract_state`` cut by
    ``shard_state``) and the inputs (``input_specs`` cut on the batch as
    the reference's ``_input_shardings`` cuts them) at the rank's shard
    shapes, all on ``meta``: nothing is allocated;
  * one ``prefill``, ``decode_step`` or ``make_train_step`` step under
    ``axis_rules(act_rules(...), mesh)``, counted by
    ``launch.roofline.count_step``.

The step runs the plain versions of the attention and WKV6 kernels
(``plain_kernels``): the reference's dry-run lowers its jnp path too (its
Pallas switch is off), and no kernel runs on ``meta``.  Lengths and cache
lengths are host values in the port (``models.transformer``): the
prefill's are the whole prompt's, and the decode's put the new token in
the cache's last slot.  A record keeps the reference's keys where they
mean the same; ``t_trace_s`` (the counted step's wall) takes the place of
``t_lower_s``, ``t_compile_s`` and ``hlo_bytes``, and the counted FLOPs
are ``flops_global``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from functools import partial
from typing import Optional

import numpy as np
import torch.distributed as dist

from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, ModelConfig,
                                 get_config, input_specs,
                                 long_context_variant)
from repro_torch.launch.mesh import (act_rules, batch_axes,
                                     make_production_mesh, param_rules)
from repro_torch.launch.roofline import (Roofline, count_step,
                                         model_flops_estimate)
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.models.params import abstract_state, shard_state
from repro_torch.sharding import axes_size, axis_rules
from repro_torch.training import AdamWConfig, adamw_init, make_train_step

SKIP_REASON = ("long_500k requires sub-quadratic attention "
               "(pure full-attention arch, see DESIGN.md)")

@contextlib.contextmanager
def fake_group(multi_pod: bool):
    """A ``fake`` process group of rank 0 of the production mesh's size for
    the block, made and destroyed here; none where a group is already
    initialised (``_mesh`` checks its size)."""
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi_pod else 256)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(multi_pod: bool):
    """The production mesh over the initialised process group."""
    n = 512 if multi_pod else 256
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise RuntimeError(f"a group of {have} ranks is initialised; the "
                           f"mesh needs {n} (``fake_group``)")
    return make_production_mesh("cpu", multi_pod=multi_pod)


def _local_inputs(specs: dict, n_batch: int, whole: bool) -> dict:
    """Each input at the rank's shape: cut on the batch where it divides,
    as the reference's ``_input_shardings`` shards it."""
    out = {}
    for k, v in specs.items():
        if whole or v.ndim == 0 or v.shape[0] % max(n_batch, 1) != 0:
            out[k] = v
        else:
            out[k] = v[:v.shape[0] // n_batch].clone()
    return out


def opt_config_for(cfg: ModelConfig) -> AdamWConfig:
    n = cfg.param_counts()["total"]
    if n > 2e11:
        # frontier-scale: bf16 + factored second moment (DESIGN.md)
        return AdamWConfig(moment_dtype="bfloat16", factored=True)
    return AdamWConfig()


def build_dryrun(arch: str, shape_name: str, multi_pod: bool,
                 fsdp: Optional[bool] = None,
                 rules_override: Optional[dict] = None,
                 remat: bool = True, kv8: bool = False):
    """Returns (fn, args, cfg, mesh, rules_a, shape) for one rank's step on
    ``meta``, or None if the (arch, shape) pair is skipped (long_500k on
    pure full-attention).  Runs, and the step runs, inside a process group
    of the mesh's size (``fake_group``)."""
    shape = INPUT_SHAPES[shape_name]
    cfg = get_config(arch)
    if kv8:
        cfg = cfg.replace(kv_cache_dtype="int8")
    if shape_name == "long_500k":
        cfg = long_context_variant(cfg)
        if cfg is None:
            return None
    mesh = _mesh(multi_pod)
    n_batch = axes_size(mesh, batch_axes(multi_pod))
    rules_a = act_rules(shape, multi_pod)
    rules_p = param_rules(cfg, shape, multi_pod, fsdp=fsdp)
    if rules_override:
        rules_a = {**rules_a, **rules_override.get("act", {})}
        rules_p = {**rules_p, **rules_override.get("param", {})}

    # on meta no values are drawn: the generator is not needed
    params = init_params(cfg, None, "meta", mesh, rules_p)
    ins = _local_inputs(input_specs(cfg, shape), n_batch,
                        shape.kind == "decode" and shape.global_batch == 1)
    image = [ins["image_embeds"]] if "image_embeds" in ins else []

    if shape.kind == "train":
        ocfg = opt_config_for(cfg)
        opt = adamw_init(params, ocfg)
        step = make_train_step(cfg, ocfg, remat=remat, device="meta",
                               plain_kernels=True)

        def fn(params, opt, tokens, labels, image_embeds=None):
            return step(params, opt, tokens, labels, image_embeds)

        args = (params, opt, ins["tokens"], ins["labels"], *image)
        return (fn, args, cfg, mesh, rules_a, shape)

    # serving shapes need the cache/state, cut to the rank's shard
    max_len = shape.seq_len
    state = shard_state(cfg, abstract_state(cfg, shape.global_batch,
                                            max_len), mesh, rules_a)
    if shape.kind == "prefill":
        lengths = np.full(ins["tokens"].shape[0], shape.seq_len)

        def fn(params, state, tokens, lengths, image_embeds=None):
            return prefill(cfg, params, state, tokens, lengths,
                           image_embeds=image_embeds, plain_kernels=True)

        args = (params, state, ins["tokens"], lengths, *image)
        return (fn, args, cfg, mesh, rules_a, shape)

    def fn(params, state, last_tokens, cur_lens):
        return decode_step(cfg, params, state, last_tokens, cur_lens,
                           plain_kernels=True)

    cur_lens = np.full(ins["last_tokens"].shape[0], max_len - 1)
    args = (params, state, ins["last_tokens"], cur_lens)
    return (fn, args, cfg, mesh, rules_a, shape)


def run_one(arch: str, shape_name: str, multi_pod: bool = False,
            fsdp: Optional[bool] = None, verbose: bool = True,
            rules_override: Optional[dict] = None,
            remat: bool = True, kv8: bool = False) -> Optional[dict]:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    try:
        with fake_group(multi_pod):
            built = build_dryrun(arch, shape_name, multi_pod, fsdp,
                                 rules_override, remat=remat, kv8=kv8)
            if built is not None:
                fn, args, cfg, mesh, rules_a, shape = built
                t0 = time.time()
                with axis_rules(rules_a, mesh):
                    counts = count_step(fn, *args)
                t_trace = time.time() - t0
        if built is None:
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                   "status": "skipped", "reason": SKIP_REASON}
        else:
            rf = Roofline(
                arch=arch, shape=shape_name, mesh=mesh_name,
                chips=mesh.size(),
                flops_per_chip=counts.flops,
                hbm_bytes_per_chip=counts.hbm_bytes,
                collective_bytes_per_chip=counts.collective_bytes,
                model_flops=model_flops_estimate(cfg, shape),
                memory_stats={k: counts.memory[k] for k in (
                    "argument_bytes", "output_bytes", "temp_bytes")},
                collectives={k: {"bytes": v,
                                 "count": counts.collective_counts[k]}
                             for k, v in counts.collectives.items()},
            )
            rec = {"status": "ok", "t_trace_s": round(t_trace, 2),
                   **rf.row()}
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
    if verbose:
        slim = {k: v for k, v in rec.items() if k != "trace"}
        print(json.dumps(slim, default=str))
    return rec


def _run_task(task, **kw) -> dict:
    arch, shape, multi_pod = task
    return run_one(arch, shape, multi_pod=multi_pod, **kw)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, help="architecture id")
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true",
                    help="2x16x16 (512 ranks) instead of 16x16 (256)")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) pair")
    ap.add_argument("--fsdp", default=None, choices=["on", "off", None])
    ap.add_argument("--no-remat", action="store_true",
                    help="disable activation checkpointing (train shapes)")
    ap.add_argument("--kv8", action="store_true",
                    help="int8 KV cache (beyond-paper decode optimization)")
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--jobs", type=int, default=1,
                    help="run the pairs in this many processes, each with "
                         "its own fake group (records keep their order)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    fsdp = {"on": True, "off": False, None: None}[args.fsdp]

    tasks = [(arch, shape, mp) for arch in archs for shape in shapes
             for mp in meshes]
    one = partial(_run_task, fsdp=fsdp, remat=not args.no_remat,
                  kv8=args.kv8)
    records = []
    with contextlib.ExitStack() as stack:
        if args.jobs > 1:
            pool = stack.enter_context(ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn")))
            done = pool.map(one, tasks)
        else:
            done = map(one, tasks)
        for rec in done:
            records.append(rec)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec, default=str) + "\n")
    n_err = sum(1 for r in records if r["status"] == "error")
    print(f"# {len(records)} runs, {n_err} errors", file=sys.stderr)
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
