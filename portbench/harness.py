"""One run of one cell: build, warm, fill the loop, time the window,
judge the served tokens against the plain reference.

The entry a cell drives (``workloads/<cell>.json`` ``"entry"``):

- ``engine``: one ``repro_torch.serving.Engine`` (a convertible decoder
  when ``chunk_size`` > 0), fed by ``add_request``; a step is
  ``Engine.step``.
- ``pd``: ``repro_torch.serving.disagg.PDCluster`` with one prefiller and
  one decoder, no convertible decoder and no autoscaling policy, fed by
  ``submit``; a step is ``PDCluster.step``.

Neither path reads a clock to decide anything, so a seed's run does the
same work step for step whatever the speed: the clients of the closed
loop send at step boundaries, each its next request as soon as its last
one finished, in the order the requests finished.

Timing is the harness's own ``perf_counter``, read after each call into
the program returns; every call ends in a device-to-host copy of logits
(or a device sync), so a stamp follows the device work.  A token is
stamped at the end of the call that produced it, and a request is sent at
the end of the call in which its client's previous request finished.
The harness wraps the program's model and transfer calls (``prefill``,
``decode_step``, ``kvtransfer.extract`` / ``insert`` as the serving
modules call them) to log each call's sizes, and, when tracing, to stamp
them as ``portbench::`` spans; the wrappers change nothing they pass on.
"""
from __future__ import annotations

import gc
import hashlib
import importlib
import json
import sys
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from portbench import flops, traffic, weights
from portbench.reference import common, family

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# A traced run profiles the last third of its `seconds`; the host-clock
# numbers come from the untraced stretch before it, which the profiler's
# cost a launch does not slow.
TRACED_SHARE = 1 / 3


def load(kind: str, name: str, root: Path = BENCH) -> dict:
    return json.loads((root / kind / f"{name}.json").read_text())


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict

    @classmethod
    def named(cls, name: str, root: Path = BENCH, **overrides) -> "Cell":
        wl = {**load("workloads", name, root), **overrides}
        return cls(name, wl, load("configs", wl["config"], root),
                   traffic.load_mix(wl["traffic"], root))


# ---------------------------------------------------------------------------
# The model under test and its weights
# ---------------------------------------------------------------------------

def port_config(cell: Cell, smoke: bool = False):
    mod = importlib.import_module(
        f"repro_torch.configs.{cell.config['port_config']}")
    return mod.SMOKE if smoke else mod.CONFIG


def published(cell: Cell, cfg, smoke: bool = False) -> dict:
    """The file's published keys; for a SMOKE run, the same keys read
    back from the SMOKE config through the family's ``PORT_KEYS``."""
    hf = dict(cell.config)
    if smoke:
        for attr, key in family(cell.config["family"]).PORT_KEYS.items():
            hf[key] = _attr(cfg, attr)
    return hf


def _attr(obj, path: str):
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def check_port_config(cfg, hf: dict, fam) -> list[str]:
    """Where the port's config disagrees with the file's keys."""
    return [f"{attr}={_attr(cfg, attr)} but {key}={hf[key]}"
            for attr, key in fam.PORT_KEYS.items()
            if _attr(cfg, attr) != hf[key]]


def build_model(cfg, leaves: list, w: dict, device):
    """The port's model with the benchmark's tensors as its weights (no
    copy); refuses a model whose parameters are not the leaves."""
    from torch import nn

    from repro_torch.models import Transformer
    model = Transformer(cfg, "meta")
    want = {n: tuple(s) for n, s, _ in leaves}
    have = {n: tuple(p.shape) for n, p in model.named_parameters()}
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()))[:6]
        raise RuntimeError(f"the port's parameters are not the reference's "
                           f"leaves: {diff}")
    for name, t in w.items():
        *path, leaf = name.split(".")
        mod = model
        for p in path:
            mod = getattr(mod, p) if not p.isdigit() else mod[int(p)]
        setattr(mod, leaf, nn.Parameter(t, requires_grad=False))
    return model


# ---------------------------------------------------------------------------
# Logs
# ---------------------------------------------------------------------------

@dataclass
class ReqLog:
    rid: int
    client: int
    prompt_len: int
    out_len: int
    send_t: float
    token_t: list = field(default_factory=list)
    req: object = None


@dataclass
class StepLog:
    k: int
    t0: float
    t1: float = 0.0
    in_window: bool = False
    calls: list = field(default_factory=list)
    traced: bool = False


@dataclass
class RunLog:
    """What a metric reader reads (``metrics/<name>.py``: ``read(run)``).
    The window (``t_w0`` .. ``t_w1``) is the untraced stretch: in a traced
    run the profiled steps follow it (``traced``), and ``trace`` holds
    what the profiler saw of them."""
    cell: str
    dims: dict
    peak: Optional[dict]
    t_w0: float = 0.0
    t_w1: float = 0.0
    setup_s: float = 0.0
    requests: list = field(default_factory=list)
    steps: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    trace: Optional[dict] = None

    @property
    def window_s(self) -> float:
        return self.t_w1 - self.t_w0

    def in_window(self, t: float) -> bool:
        return self.t_w0 < t <= self.t_w1

    def window_steps(self) -> list:
        return [s for s in self.steps if s.in_window]

    def window_calls(self, kind: str) -> list:
        return [c for s in self.window_steps() for c in s.calls
                if c["kind"] == kind]

    def traced_calls(self, kind: str) -> list:
        return [c for s in self.steps if s.traced for c in s.calls
                if c["kind"] == kind]


# ---------------------------------------------------------------------------
# Entries
# ---------------------------------------------------------------------------

def _decoding(eng) -> list[int]:
    """Slots of an Engine that decode a token this step."""
    pend = eng.pending_chunked
    return [s for s in range(eng.num_slots)
            if eng.active[s] and (pend is None or s != pend.slot)
            and eng.slot_req[s] is not None
            and eng.slot_req[s].prefill_done >= len(eng.slot_req[s].prompt)]


class EngineEntry:
    def __init__(self, cfg, model, wl: dict):
        from repro_torch.serving.engine import Engine
        self.eng = Engine(cfg, model, num_slots=wl["slots"],
                          max_len=wl["max_len"],
                          chunk_size=wl.get("chunk_size", 0))

    def decoder(self):
        return self.eng

    def step(self):
        self.eng.step()

    def submit(self, req):
        self.eng.add_request(req)

    def counters(self) -> dict:
        e = self.eng
        return {"decode_steps": e.decode_steps, "decode_wall_s":
                e.decode_wall_s, "mixed_steps": e.mixed_steps,
                "mixed_wall_s": e.mixed_wall_s}


class PDEntry:
    def __init__(self, cfg, model, wl: dict):
        from repro_torch.serving.disagg import PDCluster
        self.cl = PDCluster(cfg, model, policy=None, n_prefillers=1,
                            n_decoders=1, n_convertible=0,
                            slots_per_decoder=wl["slots"],
                            max_len=wl["max_len"])

    def decoder(self):
        return self.cl.decoders[0].eng

    def step(self):
        self.cl.step()

    def submit(self, req):
        self.cl.submit(req)

    def counters(self) -> dict:
        e, p, t = self.decoder(), self.cl.prefillers[0], self.cl.transfers
        return {"decode_steps": e.decode_steps, "decode_wall_s":
                e.decode_wall_s, "mixed_steps": e.mixed_steps,
                "mixed_wall_s": e.mixed_wall_s, "prefill_tokens":
                p.tokens_done, "prefill_wall_s": p.wall_s, "transfers":
                t.n_transfers, "transfer_wall_s": t.total_wall_s,
                "transfer_bytes": t.total_bytes}


ENTRIES = {"engine": EngineEntry, "pd": PDEntry}


# ---------------------------------------------------------------------------
# The recorder: wraps the program's calls as the serving modules make them
# ---------------------------------------------------------------------------

class Recorder:
    def __init__(self, trace: bool):
        self.trace = trace
        self.step: Optional[StepLog] = None
        self.decoder = None
        self.spans: list = []

    def span(self, name):
        """When tracing, a ``portbench::`` span stamped by the host's
        ``time.time_ns``, the clock of the profiler's timeline."""
        return self._timed(f"portbench::{name}") if self.trace \
            else nullcontext()

    @contextmanager
    def _timed(self, name):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))

    def _log(self, rec: dict):
        if self.step is not None:
            self.step.calls.append(rec)

    def wrap_prefill(self, fn):
        def prefill(cfg, params, state, tokens, lengths, *a, start=None,
                    **kw):
            s = 0 if start is None else int(np.asarray(start).reshape(-1)[0])
            end = int(np.asarray(lengths).reshape(-1)[0])
            self._log({"kind": "prefill", "padded": int(np.shape(tokens)[1]),
                       "start": s, "n": end - s})
            with self.span("prefill" if s == 0 else "chunk"):
                return fn(cfg, params, state, tokens, lengths, *a,
                          start=start, **kw)
        return prefill

    def wrap_decode(self, fn):
        def decode_step(cfg, params, state, last_tokens, cur_lens, **kw):
            eng = self.decoder
            dec = _decoding(eng) if eng is not None else []
            lens = np.asarray(cur_lens).reshape(-1)
            self._log({"kind": "decode", "keys": [int(c) + 1 for c in lens],
                       "decoding": [int(lens[s]) + 1 for s in dec]})
            with self.span("decode"):
                return fn(cfg, params, state, last_tokens, cur_lens, **kw)
        return decode_step

    def wrap_transfer(self, fn, what):
        def call(*a, **kw):
            self._log({"kind": what})
            with self.span(what):
                return fn(*a, **kw)
        return call

    @contextmanager
    def installed(self):
        from repro_torch.serving import disagg, engine, kvtransfer
        patches = [(engine, "prefill", self.wrap_prefill(engine.prefill)),
                   (engine, "decode_step", self.wrap_decode(
                       engine.decode_step)),
                   (disagg, "prefill", self.wrap_prefill(disagg.prefill)),
                   (kvtransfer, "extract", self.wrap_transfer(
                       kvtransfer.extract, "extract")),
                   (kvtransfer, "insert", self.wrap_transfer(
                       kvtransfer.insert, "insert"))]
        saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
        for m, n, f in patches:
            setattr(m, n, f)
        try:
            yield self
        finally:
            for m, n, f in saved:
                setattr(m, n, f)


# ---------------------------------------------------------------------------
# The closed loop
# ---------------------------------------------------------------------------

class Loop:
    def __init__(self, entry, stream: traffic.Stream, clients: int,
                 recorder: Recorder, log: RunLog, clock=time.perf_counter):
        self.entry = entry
        self.stream = stream
        self.rec = recorder
        self.log = log
        self.clock = clock
        self.inflight: dict[int, ReqLog] = {}
        self.finished: list[ReqLog] = []
        self.schedule = hashlib.sha256()
        self.k = 0
        self._done: list[int] = []
        t = clock()
        for c in range(clients):
            self._send(c, t)

    def _send(self, client: int, t: float):
        from repro_torch.serving.engine import Request
        spec = self.stream.next()
        req = Request(rid=spec.rid, prompt=self.stream.prompt(spec),
                      max_new_tokens=spec.out_len)
        r = ReqLog(spec.rid, client, spec.prompt_len, spec.out_len, t,
                   req=req)
        self.inflight[spec.rid] = r
        self.log.requests.append(r)
        with self.rec.span("submit"):
            self.entry.submit(req)
        self._after(self.clock())

    def _after(self, t: float):
        """Stamp the tokens that appeared by `t`; each client whose request
        finished sends its next one (in the order of the requests)."""
        done = []
        for r in list(self.inflight.values()):
            n = len(r.req.output)
            if n > len(r.token_t):
                r.token_t += [t] * (n - len(r.token_t))
            if n >= r.out_len:
                done.append(r)
                del self.inflight[r.rid]
        self.finished += done
        self._done += [r.rid for r in done]
        for r in sorted(done, key=lambda r: r.rid):
            self._send(r.client, t)

    def step(self, in_window: bool = False, traced: bool = False) -> StepLog:
        s = StepLog(self.k, self.clock(), in_window=in_window, traced=traced)
        self.rec.step = s
        self._done = []
        with self.rec.span("step"):
            self.entry.step()
            self._after(self.clock())
        s.t1 = self.clock()
        self.rec.step = None
        self.log.steps.append(s)
        self.schedule.update(repr((self.k, [(c["kind"], c.get("padded"),
                                            c.get("start"), c.get("n"),
                                            c.get("keys"))
                                           for c in s.calls],
                                   self._done)).encode())
        self.k += 1
        return s


# ---------------------------------------------------------------------------
# Correctness: served tokens against the plain reference
# ---------------------------------------------------------------------------

def sample(finished: list, seed: int, k: int) -> list:
    """`k` finished requests drawn from the seed, with the longest (prompt
    and output) and the one that served the most tokens among them."""
    if not finished:
        return []
    pool = sorted(finished, key=lambda r: r.rid)
    pick = {max(pool, key=lambda r: (r.prompt_len + r.out_len, r.rid)).rid,
            max(pool, key=lambda r: (r.out_len, r.rid)).rid}
    rest = [r for r in pool if r.rid not in pick]
    rng = np.random.default_rng([int(seed) % 2 ** 64, 3])
    n = max(0, min(k - len(pick), len(rest)))
    pick |= {rest[i].rid for i in rng.choice(len(rest), n, replace=False)}
    return [r for r in pool if r.rid in pick]


def judge(gaps, picked: list, limit: float) -> tuple[bool, Optional[float]]:
    """Correct where every sampled request served all its tokens and no
    served token's logit lies more than `limit` below the reference's
    best; and the widest gap."""
    widest = max((float(g.max()) for g in gaps), default=None)
    whole = all(len(r.req.output) == r.out_len for r in picked)
    return widest is not None and whole and widest <= limit, widest


def token_gaps(fam, dims, w, reqs, device, quant=None):
    """For each request: the reference's logits at each served token's
    position (prompt + served tokens but the last, causal), and per served
    token the gap by which its logit lies below the reference's best; with
    `quant`, the gap of the token the quantised control puts first."""
    seqs, pos, targets = [], [], []
    for r in reqs:
        out = [int(t) for t in r.req.output]
        ids = np.concatenate([r.req.prompt.astype(np.int64),
                              np.asarray(out[:-1], np.int64)])
        seqs.append(torch.as_tensor(ids, device=device))
        pos.append(torch.arange(r.prompt_len - 1, len(ids), device=device))
        targets.append(torch.as_tensor(out, device=device))
    ref = fam.logits(dims, w, seqs, pos)
    gaps = [(lg.max(-1).values - lg.gather(1, t[:, None])[:, 0])
            for lg, t in zip(ref, targets)]
    if quant is None:
        return gaps, None
    ctl = fam.logits(dims, w, seqs, pos, quant=quant)
    cgaps = [(lg.max(-1).values - lg.gather(1, c.argmax(-1)[:, None])[:, 0])
             for lg, c in zip(ref, ctl)]
    return gaps, cgaps


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------

def stderr(msg: str):
    print(msg, file=sys.stderr, flush=True)


def pads(max_len: int, lo: int) -> list[int]:
    """The power-of-two prefill pads of prompts of `lo` .. max_len tokens,
    capped at max_len (the program's rule for a whole prompt)."""
    out, p = [], 1 << (lo - 1).bit_length()
    while p < max_len:
        out.append(p)
        p *= 2
    return out + [max_len]


@torch.no_grad()
def warm(cell: Cell, cfg, model, entry, device):
    """Every shape of the cell's traffic once: the prefill pads, the chunk
    and the chunk at its offset, the decode batch."""
    from repro_torch.models import decode_step, init_state, prefill
    wl = cell.workload
    L, C = wl["max_len"], wl.get("chunk_size", 0)
    shapes = [(p, 0) for p in pads(L, cell.mix["in_lo"])]
    if C:
        shapes += [(C, 0), (min(C, L - C), C)]
    for p, start in shapes:
        st = init_state(cfg, 1, L, device)
        prefill(cfg, model, st, np.zeros((1, p), np.int32), [start + p],
                start=[start])
    eng = entry.decoder()
    decode_step(cfg, model, eng.state, np.zeros(eng.num_slots, np.int32),
                np.zeros(eng.num_slots, np.int32))
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, smoke: bool = False,
        clock=time.perf_counter, fill: Optional[int] = None,
        control: Optional[str] = None, resize: Optional[dict] = None) -> dict:
    """One run: the result line's object without its metrics, and under
    "log" the ``RunLog`` the metric readers read.  With `control`
    ("fp8"), also the control judged as the program is, on the same
    tokens, under "control".  `smoke`
    runs the config's SMOKE variant (changed by `resize`), for tests on
    the CPU."""
    wl = cell.workload
    fam = family(cell.config["family"])
    cfg = port_config(cell, smoke)
    if resize:
        cfg = cfg.replace(**resize)
    hf = published(cell, cfg, smoke)
    bad = check_port_config(cfg, hf, fam)
    if bad:
        raise RuntimeError(f"{cell.name}: the port's config departs from "
                           f"{wl['config']}.json: {bad}")
    dims = fam.dims(hf)
    phases = {}
    t = clock()
    if device.type == "cuda":
        from repro_torch.kernels import build
        phases["kernels_s"] = build.build_all()
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    phases["cuda_init_and_imports_s"] = t - t_start
    t = clock()
    leaves = fam.leaves(dims)
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        cfg.param_dtype]
    w = weights.make(leaves, dims["num_hidden_layers"], seed, dtype, device)
    model = build_model(cfg, leaves, w, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    phases["weights_s"] = clock() - t
    t = clock()
    entry = ENTRIES[wl["entry"]](cfg, model, wl)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    phases["state_s"] = clock() - t
    t = clock()
    warm(cell, cfg, model, entry, device)
    phases["warm_s"] = clock() - t
    peak_dev = flops.PEAKS.get(torch.cuda.get_device_name(device)) \
        if device.type == "cuda" else None
    log = RunLog(cell.name, dims, peak_dev)
    rec = Recorder(trace)
    rec.decoder = entry.decoder()
    stream = traffic.Stream(cell.mix, wl["max_len"], cfg.vocab_size, seed)
    prof = None
    with rec.installed():
        t = clock()
        loop = Loop(entry, stream, wl["clients"], rec, log, clock)
        while len(loop.finished) < (wl["clients"] if fill is None else fill):
            loop.step()
        phases["fill_s"] = clock() - t
        schedule = loop.schedule.hexdigest()
        c0 = entry.counters()
        gc.collect()
        gc.freeze()
        untraced = seconds * (1 - TRACED_SHARE) if trace else seconds
        log.t_w0 = clock()
        while clock() - log.t_w0 < untraced:
            loop.step(in_window=True)
        log.t_w1 = log.steps[-1].t1
        c1 = entry.counters()
        if trace:
            from portbench import trace as tr
            prof = tr.profiler()
            prof.__enter__()
            with rec.span("window"):
                while clock() - log.t_w0 < seconds:
                    loop.step(traced=True)
            prof.__exit__(None, None, None)
    gc.unfreeze()
    log.setup_s = log.t_w0 - t_start
    log.counters = {k: c1[k] - c0[k] for k in c0}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if prof is not None:
        from portbench import trace as tr
        log.trace = tr.read(prof, rec.spans)
        del prof
    stderr(f"[setup] {json.dumps({k: round(v, 3) for k, v in phases.items()})}"
           f" setup_s {log.setup_s:.3f}")
    cache = flops.kv_bytes_per_token(dims) * wl["slots"] * wl["max_len"]
    stderr(f"[memory] peak {peak / 2 ** 30:.2f} GiB; the decoder's cache "
           f"{cache / 2 ** 30:.2f} GiB ({wl['slots']} slots of "
           f"{wl['max_len']} positions)")
    stderr(f"[schedule] fill {schedule[:16]}, {loop.k} steps, "
           f"{len(log.window_steps())} in the window")
    done = [r for r in loop.finished if log.in_window(r.token_t[-1])]
    picked = sample(done, seed, wl["sample"])
    del entry, loop, rec, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    common.no_tf32()
    t = clock()
    gaps, cgaps = token_gaps(fam, dims, w, picked, device, control)
    ref_s = clock() - t
    served = sum(len(g) for g in gaps)
    limit = wl["limits"]["logit_gap"]
    correct, widest = judge(gaps, picked, limit)
    stderr(f"[reference] {len(picked)} requests, {served} served tokens, "
           f"{sum(r.prompt_len for r in picked)} prompt tokens, {ref_s:.1f} s")
    sent = [r for r in log.requests if log.in_window(r.send_t)]
    out = {"correct": correct, "attempted": len(sent), "failed": 0,
           "metrics": {},
           "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                      "kind": (torch.cuda.get_device_name(device)
                               if device.type == "cuda" else "cpu"),
                      "count": 1, "memory_peak_bytes": int(peak)},
           "schedule": schedule, "log": log}
    if log.trace is not None:
        out["device"]["busy_s"] = log.trace["busy_s"]
        out["device"]["window_s"] = log.trace["window_s"]
    if cgaps is not None:
        ccorrect, cwidest = judge(cgaps, picked, limit)
        out["control"] = {"correct": ccorrect, "logit_gap": cwidest}
    out["compared"] = {"logit_gap": {"value": widest, "limit": limit}}
    return out
