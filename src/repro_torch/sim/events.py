"""Discrete-event PD-disaggregated cluster simulator.

Same cluster, same roofline, same *unmodified* control plane as the fluid
engine (``sim.cluster.Cluster``) — but time advances on an event heap
instead of fixed dt ticks, so request-level tail behavior is exact:

  * decode runs per-iteration continuous batching: each decoder iteration
    is one event whose length is the shared roofline ``Decoder.iter_time``;
    every resident request emits exactly one token per iteration, and
    admissions join at iteration boundaries (the mechanism DistServe/
    DynaServe show dominates tail latency);
  * prefill is serialized per prefiller (batch ~1): one completion event
    per request at ``in_len / v_prefill``;
  * KVC transfers complete at interconnect-bandwidth delay events;
  * instance startup/conversion appears as wake events at ``ready_t``;
  * autoscaling fires every ``scale_interval`` as in the fluid engine.

TTFT/TPOT therefore come out strictly per-request (non-smeared): admission
and finish happen at exact event timestamps and ``generated`` advances in
whole tokens.  The differential suite (tests/test_sim_differential.py)
asserts this engine and the fluid engine agree on throughput, mean
TTFT/TPOT, and scaling decisions for every trace x policy; the
heterogeneous/multi-model variants are in tests/test_fleet_api.py.

Pools: every instance this engine wakes, kicks, or completes belongs to
a named pool (``sim.instances.Pool``); per-iteration events carry the
instance, so mixed fleets (different chips/TP per pool, several models)
need no event-engine-specific handling — pool membership and per-model
routing live in the shared ``ClusterBase``.

Performance (DESIGN.md "Performance"): the hot loop is O(1) amortized per
event —

  * arrivals feed lazily from the sorted trace (which may be a streaming
    iterator, ``sim.traces.stream_trace``): the heap holds only *live*
    events, never the whole trace, and ties resolve arrivals-first in
    trace order exactly as the historical eager pre-push did (arrivals
    were pushed before every other event, so their sequence numbers were
    strictly smaller);
  * iteration membership uses admission-generation stamps
    (``SimRequest._res_gen`` vs the ``_iter_gen`` recorded when the
    iteration was scheduled) instead of snapshotting the batch into the
    event and rebuilding an ``id()`` set on completion — a request gets
    this iteration's token iff it was admitted before the iteration
    started and hasn't been evicted (or evicted + re-admitted) since,
    which is the same predicate the (resident, n_evictions) snapshot
    encoded;
  * instance liveness is the O(1) ``Instance.live`` flag, not an
    ``inst in self.decoders + self.convertibles`` list-concat probe;
  * the piecewise-constant GPU integral caches the fleet size between
    scale events (the only place the fleet changes).

Fidelity choices and the fluid-vs-event comparison are documented in
DESIGN.md.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Iterable, Optional

from repro_torch.sim.instances import ClusterBase, Decoder, Prefiller, SimReport, \
    SimRequest
from repro_torch.sim.traces import TraceRequest

# granularity cap for prefill-only convertible iterations: with no decode
# batch resident there is no natural iteration boundary, so progress is
# checkpointed at least this often (the TPOT-SLO-scale chunk cadence)
_CONV_PREFILL_QUANTUM = 0.05


class EventCluster(ClusterBase):
    """Event-driven engine over the shared instance/control-plane layer."""

    engine = "events"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._heap: list[tuple[float, int, str, tuple]] = []
        self._seq = itertools.count()
        self._snap_every = 0.2
        self.n_events = 0        # processed events (benchmarks/perf.py)

    # ------------------------------------------------------------------
    def _push(self, t: float, kind: str, *data):
        heapq.heappush(self._heap, (t, next(self._seq), kind, data))

    # ------------------------------------------------------------------
    def run(self, trace: "list[TraceRequest] | Iterable[TraceRequest]",
            duration: Optional[float] = None) -> SimReport:
        """Drive the cluster over ``trace``.  A list is sorted here (the
        historical contract); any other iterable is consumed lazily and
        must already be in arrival-time order (streaming traces), in which
        case ``duration`` is required."""
        if isinstance(trace, (list, tuple)):
            trace = sorted(trace, key=lambda r: r.t)
            t_end = duration or (trace[-1].t + 60.0 if trace else 60.0)
        else:
            if duration is None:
                raise ValueError(
                    "streaming traces need an explicit duration")
            t_end = duration
        arrivals = iter(trace)
        nxt = next(arrivals, None)
        self._snap_every = self._snapshot_every(t_end)
        if self.obs is not None:
            self.obs.meta.setdefault("duration", t_end)
        self._push(0.0, "scale")
        self._push(0.0, "snapshot")
        # chaos engine: the pre-drawn schedule becomes exact heap events
        # (faults off: no schedule, no events, byte-identical heap order)
        self._faults_begin(t_end)
        for item in self._fault_work:
            self._push(item[0], "fault", item)
        self._fault_work = []
        t_cur = 0.0
        heap = self._heap
        # the fleet only changes inside scale events: cache the GPU count
        # for the piecewise-constant integral instead of recounting pools
        # on every event
        gpus = self._gpu_count(t_cur)
        while heap or nxt is not None:
            # lazy arrival feed: an arrival fires when it is no later than
            # the earliest heap event (ties arrival-first, in trace order —
            # byte-identical to the historical eager pre-push, whose
            # arrival sequence numbers were strictly smaller than every
            # other event's)
            if nxt is not None and (not heap or nxt.t <= heap[0][0]):
                if nxt.t >= t_end:
                    nxt = None
                    continue
                te = nxt.t
                if te < t_cur:
                    # unreachable for a sorted trace (arrivals fire before
                    # any later heap event); an unsorted streaming
                    # iterator must fail loudly, not corrupt the
                    # piecewise-constant GPU integral
                    raise ValueError(
                        f"trace not sorted by arrival time: request "
                        f"{nxt.rid} at t={te} after t={t_cur}")
                self.gpu_seconds += gpus * (te - t_cur)
                t_cur = te
                self.n_events += 1
                self._ev_arrival(te, SimRequest(nxt))
                nxt = next(arrivals, None)
                continue
            te, _, kind, data = heapq.heappop(heap)
            if te >= t_end:
                break
            # integrate GPU-seconds over the piecewise-constant fleet
            self.gpu_seconds += gpus * (te - t_cur)
            t_cur = te
            self.n_events += 1
            getattr(self, "_ev_" + kind)(te, *data)
            if kind == "scale" or kind == "fault":
                # faults change the fleet outside scale events (crash
                # billing husks, reaps swapping in replacements)
                gpus = self._gpu_count(te)
        self.gpu_seconds += gpus * (t_end - t_cur)
        return self._report(t_end)

    # ------------------------------------------------------------------
    # event handlers
    # ------------------------------------------------------------------
    def _ev_arrival(self, t: float, req: SimRequest):
        self._on_arrival(req, t)

    def _ev_scale(self, t: float):
        self._scale(t)
        self._drain_wait_queue(t)
        self._admit_pending(t)
        self._push(t + self.scale_interval, "scale")

    def _ev_snapshot(self, t: float):
        self.timeline.append(self._snapshot(t))
        self._push(t + self._snap_every, "snapshot")

    def _ev_wake(self, t: float, inst):
        """A provisioned instance finished booting."""
        inst._wake_scheduled = False
        if not inst.live:
            return
        if isinstance(inst, Prefiller):
            self._drain_wait_queue(t)
            self._kick_prefiller(inst, t)
        else:
            self._drain_wait_queue(t)
            self._admit_pending(t)
            self._kick_decoder(inst, t)

    def _ev_prefill_done(self, t: float, p: Prefiller, req: SimRequest):
        p._busy = False
        if not p.live:
            # the instance died mid-flight (chaos-engine crash, or the
            # defensive scale-down path): pull the head off the dead
            # box's queue so it is owned by exactly one place, then
            # requeue it on the central queue — re-prefilled exactly once
            if p.queue and p.queue[0][0] is req:
                p.queue.pop(0)
                p._inflight_cache = None
            self._wait_add(req)
            self._drain_wait_queue(t)
            return
        if p.queue and p.queue[0][0] is req:
            p.queue.pop(0)
            p._inflight_cache = None
        res = self._to_network(req, t, p.pool)   # sets t_prefill_end
        if res is not None:
            self._push(res[0], "kv_ready")
        # res None: KVC link outage exhausted the retry ladder and the
        # prompt fell back to the central queue — re-routed just below
        self._drain_wait_queue(t)          # prefill capacity freed (§IV-E)
        self._kick_prefiller(p, t)

    def _ev_kv_ready(self, t: float):
        self._admit_pending(t)

    def _ev_swap_done(self, t: float):
        """A preempted victim's swap/recompute (or a prefix hit's swap-in /
        migration) completed *exactly now*; retry admission.  The fluid
        engine approximates the same completion at tick granularity via
        its per-tick ``_admit_pending`` ready-time check (DESIGN.md
        "KV-tier fidelity")."""
        self._admit_pending(t)

    def _ev_replica_done(self, t: float):
        """A hot-prefix replication's interconnect transfer completed
        *exactly now*: install the copy on its target (the fluid engine
        approximates the same completion at tick granularity)."""
        self._service_gateway(t)

    def _ev_fault(self, t: float, item: tuple):
        """One chaos-engine work item fires *exactly now* (injection,
        straggler/swap window end, or husk reap).  Derived items go back
        on the heap as further fault events; work the fault displaced
        (crash requeues) re-enters the pipeline immediately."""
        for derived in self._fault_fire(t, item):
            self._push(derived[0], "fault", derived)
        self._drain_wait_queue(t)
        self._admit_pending(t)

    def _ev_iter_done(self, t: float, d: Decoder, it: float):
        d._iter_pending = False
        if not d.live:
            return
        # one token per request resident *since the iteration started*:
        # the admission-generation stamp (set by Decoder.admit, monotonic
        # per decoder) filters both mid-iteration admissions and victims
        # evicted-and-re-admitted before the iteration completed — the
        # predicate the historical (batch snapshot, n_evictions) pair
        # encoded, without materializing a list per iteration
        gen = d._iter_gen
        finished = []
        if d.active:
            d._invalidate()                # resident lengths advance
            fin_append = self.finished.append
            granted = 0
            for r in d.active:
                if r.t_finish >= 0 or r._res_gen > gen:
                    continue
                g_new = r.generated + 1.0
                r.generated = g_new
                r.decode_time += it
                granted += 1
                if r.t_first_token < 0:
                    # TTFT is exact: the first token exists when the first
                    # decode iteration containing the request *completes*
                    r.t_first_token = t
                if g_new >= r.src.out_len:
                    r.t_finish = t
                    d._kv_release(r, t)
                    fin_append(r)
                    finished.append(r)
            # one whole token per granted request: keeps the decoder's
            # exact-integer context sum in step with the batch
            d._ctx_sum += granted
            if self.obs is not None:
                # exact decode-token odometer (the fluid engine's
                # counterpart is the Decoder.tick pre-pass)
                self.obs.decode_tokens_done += granted
        if finished:
            d.active = [r for r in d.active if r.t_finish < 0]
            for r in finished:
                d._count_remove(r)
        # co-scheduled prefill progress
        if d.chunking:
            # chunked mode: the iteration executed exactly the chunk that
            # was planned when it was scheduled — the queue advances by
            # that budget and nothing else, so every chunk boundary is an
            # exact event timestamp
            chunk = d._iter_chunk
            d._iter_chunk = 0.0
            if chunk > 0 and d.prefill_q:
                if self.obs is not None:
                    # exact chunk boundary: this iteration advanced the
                    # co-scheduled prompt queue by precisely ``chunk``
                    self.obs.on_chunk(t, d, chunk)
                d.advance_prefill(chunk, t)
        elif d.is_convertible and d.prefill_q and d.conv:
            # legacy wholesale conversion (Eq. 5 restricted rate)
            d.advance_prefill(d.conv.v_prefill * it, t)
        if d.lazy and d.active:
            # allocate-on-generate: each surviving resident's next token
            # needs a backed block before the next iteration is scheduled;
            # failures land in oom_pending and are resolved inside the
            # _admit_pending call below (exact mid-decode OOM preemption)
            d.grow_lazy(t)
        self._admit_pending(t)             # memory freed by completions
        self._kick_decoder(d, t)

    # ------------------------------------------------------------------
    # scheduling helpers
    # ------------------------------------------------------------------
    def _kick_prefiller(self, p: Prefiller, t: float):
        if getattr(p, "_busy", False) or not p.queue:
            return
        if not p.ready(t):
            self._schedule_wake(p)
            return
        req, rem = p.queue[0]
        p._busy = True
        self._push(t + rem / max(p.v_p, 1e-9), "prefill_done", p, req)

    def _kick_decoder(self, d: Decoder, t: float):
        if getattr(d, "_iter_pending", False):
            return
        if not d.ready(t):
            self._schedule_wake(d)
            return
        if d.active:
            if d.chunking and d.prefill_q:
                # mixed iteration: plan the chunk that fits Eq. 5's TPOT
                # headroom *now* and stretch this iteration by exactly its
                # roofline cost — the chunk lands at the iteration boundary
                chunk = d.plan_chunk()
                d._iter_chunk = chunk
                it = d.mixed_iter_time(chunk) if chunk > 0 else d.iter_time()
            else:
                it = d.iter_time()
            d._iter_pending = True
            d._iter_gen = d._admit_seq     # membership cutoff stamp
            self._push(t + it, "iter_done", d, it)
        elif d.chunking and d.prefill_q:
            # chunk-only iteration: no decode batch, so the chunk itself
            # paces the event — each boundary is exact (no quantum)
            chunk = d.plan_chunk()
            d._iter_chunk = chunk
            it = d.mixed_iter_time(chunk)
            d._iter_pending = True
            d._iter_gen = d._admit_seq
            self._push(t + it, "iter_done", d, it)
        elif d.is_convertible and d.prefill_q and d.conv:
            # prefill-only "iteration": no decode batch to pace it, so
            # checkpoint progress at the chunk cadence
            head_rem = d.prefill_q[0][1]
            v = max(d.conv.v_prefill, 1e-9)
            it = min(head_rem / v, _CONV_PREFILL_QUANTUM)
            d._iter_pending = True
            d._iter_gen = d._admit_seq
            self._push(t + it, "iter_done", d, it)

    def _schedule_wake(self, inst):
        if not getattr(inst, "_wake_scheduled", False):
            inst._wake_scheduled = True
            self._push(inst.ready_t, "wake", inst)

    def _after_scale(self, t: float):
        for pool in self.pools.values():
            for inst in pool.instances:
                if not inst.ready(t):
                    self._schedule_wake(inst)

    # ------------------------------------------------------------------
    # control-plane hooks
    # ------------------------------------------------------------------
    def _submit_prefill_work(self, tgt, kind: str, req: SimRequest, t: float):
        super()._submit_prefill_work(tgt, kind, req, t)
        if kind == "prefiller":
            self._kick_prefiller(tgt, t)
        else:
            self._kick_decoder(tgt, t)

    def _after_admit(self, d: Decoder, t: float):
        self._kick_decoder(d, t)           # the request joins the next
                                           # iteration boundary

    def _on_requeue(self, entry):
        # a preempted victim (or penalized prefix hit) re-enters
        # pending_decode; retry admission exactly when its recompute /
        # swap delay elapses — the swap-completion event
        self._push(entry[0], "swap_done")

    def _on_replication(self, job):
        # hot-prefix copy completes exactly when its interconnect
        # transfer does
        self._push(job.t_done, "replica_done")
