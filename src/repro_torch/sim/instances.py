"""Shared simulator substrate: instances, roofline costs, metrics, control
plane.

Both cluster engines — the dt-stepped *fluid* model (``sim.cluster``) and
the discrete-*event* model (``sim.events``) — are thin loops over this
module.  Everything here is engine-agnostic:

  * ``ModelCost``     — cached roofline constants per model (one cost model);
  * ``Prefiller`` / ``Decoder`` — instance state, memory accounting,
    iteration-time roofline, convertible-prefill progress;
  * ``SimRequest`` / ``SimReport`` — per-request timestamps and the SLO
    metrics pipeline (one metrics pipeline);
  * ``ClusterBase``   — the control-plane glue that executes the *real*
    TokenScale implementation (``core.autoscaler``, ``core.router``,
    ``core.convertible``) unmodified: arrival routing (Alg. 1), wait-queue
    re-evaluation (§IV-E), Observation construction, and scaling.

Engines differ only in how they advance time (see DESIGN.md).

Performance (DESIGN.md "Performance"): the hot-path aggregates on
``Decoder``/``Prefiller`` (``mem_used``, ``iter_time``, inflight-token
totals, per-bucket/per-class resident counts) are *cached with dirty-flag
invalidation*, never incrementally-drifted floats: a cache is dropped on
any membership/length change and the next read re-runs the identical
from-scratch reduction, so every value is bit-for-bit what the seed code
computed (the golden fixtures pin this).  Integer counters (bucket/class
residency) are maintained incrementally because integer arithmetic is
exact.  ``check_aggregates`` re-derives everything from first principles
— the perf-invariant fuzz (tests/test_perf_invariants.py) calls it after
every operation, mirroring ``KVAllocator.check``.
"""
from __future__ import annotations

import heapq
from bisect import bisect_right, insort
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import hardware as hw
from repro_torch.core.autoscaler import Observation, Policy, TokenScalePolicy
from repro_torch.core.convertible import ConvertibleConfig
from repro_torch.core.fleet import (FleetObservation, FleetPolicy, GatewayStats,
                              PerModelFleetPolicy, PoolSnapshot, PoolSpec,
                              flat_observation)
from repro_torch.core.gateway import (Gateway, GatewayConfig, RoutingStats,
                                prefix_chain)
from repro_torch.core.hardware import InstanceSpec
from repro_torch.core.predictor import OutputPredictor
from repro_torch.core.router import (PRIORITY_STANDARD, BurstDetector, Router,
                               tpot_slo, ttft_slo)
from repro_torch.core.velocity import (BUCKET_OUTPUT, VelocityProfile, bucket_of,
                                 chunked_prefill_velocity,
                                 deflected_prefill_rate,
                                 headroom_chunk_tokens)
from repro_torch.sim.faults import (FaultConfig, FaultStats, HealthMonitor,
                              build_schedule, pick_target)
from repro_torch.sim.kvcache import KVAllocator, KVStats, KVTierConfig

#: chunked prefill: minimum per-iteration progress (tokens) once a chunk
#: queue exists on a decoder whose batch has no Eq. 5 headroom left — the
#: DynaServe-style starvation guard; without it a saturated batch could
#: park deflected prompts indefinitely.  Kept small so the TPOT overshoot
#: it can cause is bounded by ~64 tokens' roofline cost per iteration.
MIN_DEFLECT_CHUNK = 64


@dataclass(slots=True)
class SimRequest:
    src: "TraceRequest"  # noqa: F821  (sim.traces.TraceRequest)
    bucket_pred: str = ""
    t_prefill_start: float = -1.0
    t_prefill_end: float = -1.0
    t_kv_ready: float = -1.0
    t_first_token: float = -1.0
    t_decode_start: float = -1.0
    t_finish: float = -1.0
    generated: float = 0.0
    decode_time: float = 0.0
    n_evictions: int = 0       # times preempted out of a decoder
    # ---- KV-tier state (sim.kvcache; all None/0 when tiers are off) ----
    kv_hit_tokens: int = 0     # prompt tokens reused from a cached prefix
    kv_prefix: Optional[tuple] = None   # (owner decoder, tokens, tier) pin
    kv_swap: Optional[object] = None    # allocator holding our DRAM ticket
    # Alg. 1 round 2b: the decoder this prompt was deflected to.  Its KV
    # is produced on that box, so admission stays there (deflection
    # affinity in ``_admit_pending``) instead of re-entering bucket-aware
    # load balancing; cleared if the target leaves the fleet.
    deflect_tgt: Optional[object] = None
    # ---- hot-path caches (immutable trace facts, resolved once: the
    # preemption scans touch .priority millions of times per run) ----
    priority: int = field(init=False, repr=False, compare=False, default=1)
    session: int = field(init=False, repr=False, compare=False, default=-1)
    model: str = field(init=False, repr=False, compare=False, default="")
    # admission-generation stamp issued by Decoder.admit: the event engine
    # grants an iteration's token only to requests admitted before the
    # iteration started (and not evicted/re-admitted since)
    _res_gen: int = field(init=False, repr=False, compare=False, default=0)

    def __post_init__(self):
        src = self.src
        self.priority = getattr(src, "priority", PRIORITY_STANDARD)
        self.session = getattr(src, "session", -1)
        # "" = the fleet's default model
        self.model = getattr(src, "model", "")

    @property
    def prefill_tokens(self) -> float:
        """Prompt tokens the prefill stage must actually compute (the
        cached-prefix hit is served from the KV tier)."""
        return float(self.src.in_len - self.kv_hit_tokens)

    @property
    def ttft(self) -> float:
        return self.t_first_token - self.src.t

    @property
    def tpot(self) -> float:
        if self.src.out_len <= 1 or self.t_finish < 0:
            return 0.0
        return self.decode_time / max(self.src.out_len, 1)

    @property
    def bucket_true(self) -> str:
        return bucket_of(self.src.in_len, self.src.out_len)


@dataclass
class ModelCost:
    """Cached per-model roofline constants for the hot loop."""
    flops_tok: float
    kv_tok: float
    state_fix: float
    w_bytes: float
    aw_bytes: float
    attn_coef: float          # 4*H*Dh summed over attn layers

    @classmethod
    def of(cls, cfg: ModelConfig):
        return cls(
            flops_tok=hw.flops_per_token(cfg),
            kv_tok=hw.kv_bytes_per_token(cfg),
            state_fix=hw.state_bytes_fixed(cfg),
            w_bytes=hw.weight_bytes(cfg),
            aw_bytes=hw.active_weight_bytes(cfg),
            attn_coef=hw.attn_flops_per_token(cfg, 1.0))


# Backwards-compatible alias (pre-refactor name in sim.cluster).
_ModelCost = ModelCost


@dataclass(frozen=True)
class PreemptionPolicy:
    """Decode-side HBM backpressure handling (DESIGN.md §1).

      none          — KV-ready requests wait in ``pending_decode`` until a
                      decoder frees memory (the pre-priority behavior);
      evict-lowest  — the lowest-priority resident request is evicted, its
                      KV dropped; re-admission pays a full recomputation of
                      the context at prefill velocity;
      evict-least-slack — SLO-aware victim selection (the ROADMAP's
                      deadline-based preemption): the victim is the
                      resident with the lowest deadline slack — arrival +
                      per-class TTFT/TPOT SLO budget, minus the estimated
                      remaining decode time — i.e. the request most likely
                      to miss its SLO anyway; KV dropped like evict-lowest;
      pause-requeue — the victim's KV is swapped out and restored on
                      re-admission: to the host-DRAM tier at the chip's
                      swap bandwidth when the pool runs the paged KV
                      subsystem (``sim.kvcache``; recompute fallback when
                      the tier is full), over the interconnect otherwise.

    Victims are always *strictly* lower priority than the request being
    admitted, so high-priority work is never displaced by lower classes.
    """

    mode: str = "none"

    MODES = ("none", "evict-lowest", "evict-least-slack", "pause-requeue")

    def __post_init__(self):
        if self.mode not in self.MODES:
            raise ValueError(
                f"unknown preemption mode {self.mode!r}; "
                f"expected one of {self.MODES}")

    @property
    def enabled(self) -> bool:
        return self.mode != "none"

    @classmethod
    def of(cls, x) -> "PreemptionPolicy":
        return x if isinstance(x, cls) else cls(x or "none")


def _entry_priority(entry: tuple) -> int:
    return entry[0].priority


def _priority_insert(queue: list, entry: tuple):
    """Insert a (request, remaining) entry behind the (possibly
    in-progress) head, ahead of queued work of strictly lower priority.
    Within a class the order stays FIFO.

    The tail ``queue[1:]`` is always sorted by priority (head-protected
    inserts keep it that way, and only heads are ever popped), so the
    historical linear scan is a bisect: the insertion point it finds is
    identical, at O(log n) comparisons instead of O(n)."""
    j = bisect_right(queue, entry[0].priority, lo=1 if queue else 0,
                     key=_entry_priority)
    queue.insert(j, entry)


class Instance:
    def __init__(self, iid: int, inst: InstanceSpec, cost: ModelCost,
                 ready_t: float):
        self.iid = iid
        self.spec = inst
        self.cost = cost
        self.ready_t = ready_t
        self.draining = False
        # True while the instance belongs to a pool; cleared on scale-down
        # removal.  Replaces the historical ``inst in self.decoders +
        # self.convertibles`` list-concat membership probes on the event
        # hot path (O(pools + instances) per event) with an O(1) flag.
        self.live = True
        # flight recorder (repro_torch.obs.FlightRecorder) or None = telemetry
        # off.  Set by ClusterBase._spawn / attach_obs; the tick paths
        # only ever test it for None, so disabled telemetry costs one
        # attribute test and cannot perturb float math or event order.
        self.obs = None
        # effective-velocity multiplier (sim.faults straggler windows);
        # 1.0 = nominal chip.  Decoders fold it into the iteration
        # roofline (guarded, so the nominal path is bitwise unchanged);
        # prefillers scale v_p directly and keep this as the marker the
        # fleet observation reads (PoolSnapshot.eff_perf).
        self.perf = 1.0

    def ready(self, t: float) -> bool:
        return t >= self.ready_t


class Prefiller(Instance):
    def __init__(self, iid, inst, cost, ready_t, v_prefill: float):
        super().__init__(iid, inst, cost, ready_t)
        self.v_p = v_prefill
        self.queue: list[tuple[SimRequest, float]] = []   # (req, remaining)
        self._inflight_cache: Optional[float] = None

    def inflight_tokens(self) -> float:
        # cached, invalidated on any queue mutation; the recompute runs
        # the identical reduction, so the value is bit-for-bit stable
        v = self._inflight_cache
        if v is None:
            v = self._inflight_cache = sum(r for _, r in self.queue)
        return v

    def prefill_velocity(self) -> float:
        return self.v_p

    def submit(self, req: SimRequest, t: float):
        if req.t_prefill_start < 0:
            req.t_prefill_start = t
        _priority_insert(self.queue, (req, req.prefill_tokens))
        self._inflight_cache = None

    def advance(self, budget: float) -> list[SimRequest]:
        """Serialized head-of-line progress by `budget` tokens; returns
        requests whose prefill completed."""
        done = []
        if self.queue and budget > 0:
            self._inflight_cache = None
        while self.queue and budget > 0:
            req, rem = self.queue[0]
            take = min(rem, budget)
            rem -= take
            budget -= take
            if rem <= 1e-9:
                self.queue.pop(0)
                done.append(req)
            else:
                self.queue[0] = (req, rem)
        return done

    def tick(self, t: float, dt: float) -> list[SimRequest]:
        """Fluid engine: advance by dt; return completed prefills."""
        if not self.ready(t):
            return []
        return self.advance(self.v_p * dt)

    def check_aggregates(self):
        """Invariant audit (mirrors ``KVAllocator.check``): the cached
        inflight-token total must equal the from-scratch reduction."""
        if self._inflight_cache is not None:
            expect = sum(r for _, r in self.queue)
            if self._inflight_cache != expect:
                raise AssertionError(
                    f"prefiller {self.iid}: inflight cache drift "
                    f"{self._inflight_cache} != {expect}")
        tail = [e[0].priority for e in self.queue[1:]]
        if tail != sorted(tail):
            raise AssertionError(
                f"prefiller {self.iid}: queue tail not priority-sorted")

    @property
    def idle(self) -> bool:
        return not self.queue


class Decoder(Instance):
    is_convertible = False

    def __init__(self, iid, inst, cost, ready_t,
                 conv: Optional[ConvertibleConfig] = None):
        super().__init__(iid, inst, cost, ready_t)
        self.active: list[SimRequest] = []
        self.conv = conv
        self.prefill_q: list[tuple[SimRequest, float]] = []
        # chunked prefill (PoolSpec.prefill_chunking, set by _spawn):
        # tokens-per-chunk cap; 0 = legacy wholesale conversion.  The
        # event engine records the chunk it planned for the in-flight
        # iteration in _iter_chunk and advances the queue by exactly that
        # budget when the iteration completes (exact chunk boundaries).
        self.chunking = 0
        self._iter_chunk = 0.0
        # KV-tier state (sim.kvcache): None keeps the legacy flat byte
        # counter byte-for-byte; ClusterBase._spawn attaches an allocator
        # when the pool sets block_size > 0
        self.kv: Optional[KVAllocator] = None
        self.hbm_frac = 0.9
        # on-box convertible completions that found no blocks free wait
        # here for the shared pending_decode path (kv mode only)
        self.kv_spill: list[tuple[float, SimRequest]] = []
        # ---- gateway / lazy paging (PoolSpec.gateway / kv_alloc) ----
        # lazy: admission reserves context + 1 token instead of the full
        # predicted output; blocks grow per generated token (grow_lazy)
        self.lazy = False
        self.gateway: Optional[Gateway] = None      # model group's gateway
        self.gw_stats: Optional[RoutingStats] = None
        # residents whose per-token block grow found no HBM free: the
        # cluster resolves them (retry / preempt) in _admit_pending
        self.oom_pending: list[SimRequest] = []
        # ---- hot-path aggregates (DESIGN.md "Performance") ----
        # float aggregates are dirty-flag caches over the identical
        # from-scratch reduction (bitwise-stable); integer residency
        # counters are maintained incrementally (integer math is exact)
        self._mem_cache: Optional[float] = None     # mem_used (legacy path)
        self._iter_cache: Optional[float] = None    # iter_time
        self._pq_cache: Optional[float] = None      # inflight prefill toks
        self._cap_cache: Optional[float] = None     # mem_cap (constant)
        self._bucket_counts: dict[str, int] = {}    # bucket -> residents
        self._prio_counts: dict[int, int] = {}      # class -> residents
        # Σ (in_len + generated) over the batch, maintained incrementally
        # while every contribution is a whole number (always true in the
        # event engine: prompts are ints, tokens land one at a time) —
        # integer-valued float adds are exact and order-independent, so
        # this equals the sequential reduction bit-for-bit.  The first
        # fractional fluid tick flips ``_ctx_exact`` and iter_time falls
        # back to the cached from-scratch sum.
        self._ctx_sum = 0.0
        self._ctx_exact = True
        # admission-generation stamps (event engine's iteration membership)
        self._admit_seq = 0
        self._iter_gen = 0

    # ---- aggregate bookkeeping ----
    def _invalidate(self):
        """Drop the float caches: active membership or a resident's
        context length changed."""
        self._mem_cache = None
        self._iter_cache = None

    def _count_add(self, req: SimRequest):
        bc = self._bucket_counts
        bc[req.bucket_pred] = bc.get(req.bucket_pred, 0) + 1
        pc = self._prio_counts
        pc[req.priority] = pc.get(req.priority, 0) + 1
        if self._ctx_exact:
            c = req.src.in_len + req.generated
            if float(c).is_integer():
                self._ctx_sum += c
            else:
                self._ctx_exact = False

    def _count_remove(self, req: SimRequest):
        bc = self._bucket_counts
        n = bc.get(req.bucket_pred, 0) - 1
        if n <= 0:
            bc.pop(req.bucket_pred, None)
        else:
            bc[req.bucket_pred] = n
        pc = self._prio_counts
        n = pc.get(req.priority, 0) - 1
        if n <= 0:
            pc.pop(req.priority, None)
        else:
            pc[req.priority] = n
        if self._ctx_exact:
            c = req.src.in_len + req.generated
            if float(c).is_integer():
                self._ctx_sum -= c
            else:
                self._ctx_exact = False

    def remove_active(self, req: SimRequest):
        """The one sanctioned way to pull a resident request out of the
        batch (preemption): keeps the residency counters and caches in
        step with ``active``."""
        self.active.remove(req)
        self._count_remove(req)
        self._invalidate()

    def max_resident_priority(self) -> int:
        """Lowest-urgency (highest-value) priority class resident right
        now, or -1 with an empty batch — the preemption fast path skips
        decoders with no strictly-lower-priority victims without scanning
        the batch."""
        pc = self._prio_counts
        return max(pc) if pc else -1

    def check_aggregates(self):
        """Invariant audit (mirrors ``KVAllocator.check``): every cached
        aggregate must equal its from-scratch recomputation."""
        c = self.cost
        if self.kv is None and self._mem_cache is not None:
            expect = sum((r.src.in_len + r.generated) * c.kv_tok
                         + c.state_fix for r in self.active)
            if self._mem_cache != expect:
                raise AssertionError(
                    f"decoder {self.iid}: mem_used cache drift "
                    f"{self._mem_cache} != {expect}")
        if self._pq_cache is not None:
            expect = sum(rem for _, rem in self.prefill_q)
            if self._pq_cache != expect:
                raise AssertionError(
                    f"decoder {self.iid}: inflight-token cache drift "
                    f"{self._pq_cache} != {expect}")
        if self._ctx_exact:
            expect = sum(r.src.in_len + r.generated for r in self.active)
            if self._ctx_sum != expect:
                raise AssertionError(
                    f"decoder {self.iid}: ctx-sum drift "
                    f"{self._ctx_sum} != {expect}")
        if self._iter_cache is not None:
            cached = self._iter_cache
            self._iter_cache = None
            fresh = self.iter_time()
            if cached != fresh:
                raise AssertionError(
                    f"decoder {self.iid}: iter_time cache drift "
                    f"{cached} != {fresh}")
        for bucket in {r.bucket_pred for r in self.active}:
            expect_n = sum(1 for r in self.active
                           if r.bucket_pred == bucket)
            if self._bucket_counts.get(bucket, 0) != expect_n:
                raise AssertionError(
                    f"decoder {self.iid}: bucket count drift for "
                    f"{bucket!r}")
        if sum(self._bucket_counts.values()) != len(self.active):
            raise AssertionError(
                f"decoder {self.iid}: bucket counts don't cover the batch")
        prio_expect: dict[int, int] = {}
        for r in self.active:
            prio_expect[r.priority] = prio_expect.get(r.priority, 0) + 1
        if self._prio_counts != prio_expect:
            raise AssertionError(
                f"decoder {self.iid}: priority counts drift "
                f"{self._prio_counts} != {prio_expect}")

    # ---- memory ----
    def mem_used(self) -> float:
        if self.kv is not None:
            return self.kv.used_bytes()
        m = self._mem_cache
        if m is None:
            c = self.cost
            m = self._mem_cache = sum(
                (r.src.in_len + r.generated) * c.kv_tok + c.state_fix
                for r in self.active)
        return m

    def mem_cap(self) -> float:
        # constant once the decoder is provisioned (hbm_frac/convertible
        # role are assigned before first use); computed lazily once
        v = self._cap_cache
        if v is None:
            reserve = self.conv.mem_reserved if (self.is_convertible
                                                 and self.conv) else 0.0
            v = self._cap_cache = self.spec.hbm_cap * self.hbm_frac \
                - self.cost.w_bytes - reserve
        return v

    def mem_util(self) -> float:
        return min(self.mem_used() / max(self.mem_cap(), 1.0), 1.5)

    def _need_bytes(self, req: SimRequest) -> float:
        """Full-length KV reservation for one request."""
        c = self.cost
        return (req.src.in_len + req.src.out_len) * c.kv_tok + c.state_fix

    def _admit_bytes(self, req: SimRequest) -> float:
        """Admission-time KV reservation: the full-length reservation, or
        — under allocate-on-generate paging (``PoolSpec.kv_alloc="lazy"``)
        — just the context so far plus one token's slack; the rest grows
        per generated token (``grow_lazy``) and exhaustion is handled by
        mid-decode preemption instead of being reserved away up front."""
        if not self.lazy:
            return self._need_bytes(req)
        c = self.cost
        return (req.src.in_len + req.generated + 1.0) * c.kv_tok \
            + c.state_fix

    def can_admit(self, req: SimRequest) -> bool:
        if self.kv is not None:
            return self.kv.can_admit(req.src.rid, self._admit_bytes(req))
        return self.mem_used() + self._admit_bytes(req) <= self.mem_cap()

    def inflight_of_bucket(self, bucket: str) -> int:
        # incrementally-maintained integer residency counter (exact)
        return self._bucket_counts.get(bucket, 0)

    # ---- convertible prefill (Alg. 1 round 2 target) ----
    def inflight_tokens(self) -> float:
        v = self._pq_cache
        if v is None:
            v = self._pq_cache = sum(rem for _, rem in self.prefill_q)
        return v

    def prefill_velocity(self) -> float:
        return self.conv.v_prefill if self.conv else 0.0

    def submit_prefill(self, req: SimRequest, t: float):
        if req.t_prefill_start < 0:
            req.t_prefill_start = t
        _priority_insert(self.prefill_q, (req, req.prefill_tokens))
        self._pq_cache = None
        self._iter_cache = None    # mixed-iteration term keys off prefill_q

    def advance_prefill(self, budget: float, t: float) -> list[SimRequest]:
        """Restricted-velocity convertible prefill (Eq. 5); completed
        requests transition seamlessly to decode on the same instance.
        Returns the requests that completed prefill.  With the paged KV
        subsystem the on-box admission is no longer unconditional: when no
        blocks are free the request spills to ``pending_decode`` (drained
        by ``ClusterBase._admit_pending``) instead of overcommitting."""
        done = []
        if self.prefill_q and budget > 0:
            self._pq_cache = None
            self._iter_cache = None
        while self.prefill_q and budget > 0:
            req, rem = self.prefill_q[0]
            take = min(rem, budget)
            rem -= take
            budget -= take
            if rem <= 1e-9:
                self.prefill_q.pop(0)
                req.t_prefill_end = t
                req.t_kv_ready = t        # on-box: no KVC transfer
                done.append(req)
                if self.obs is not None:
                    # on-box prefill completion odometer (prefiller-side
                    # completions are counted in ClusterBase._to_network)
                    self.obs.prefill_tokens_done += req.prefill_tokens
                if self.kv is not None and not self.can_admit(req):
                    self.kv_spill.append((t, req))
                else:
                    self.admit(req, t)
            else:
                self.prefill_q[0] = (req, rem)
        return done

    # ---- decode ----
    def admit(self, req: SimRequest, t: float):
        # t_decode_start survives preemption round-trips; t_first_token is
        # stamped by the engines when the first decode iteration *completes*
        # (end of first iter_done / first tick), not at admission — stamping
        # here would make TTFT one full iteration optimistic
        if req.t_decode_start < 0:
            req.t_decode_start = t
        if req.kv_swap is not None:
            # the paused victim is back in HBM: release its DRAM ticket on
            # whichever allocator swapped it out
            req.kv_swap.swap_in_release(req.src.rid)
            req.kv_swap = None
        kp = req.kv_prefix
        if kp is not None and (kp[0] is not self or self.kv is None
                               or kp[2] != "hbm"):
            # admitted away from the prefix owner without passing through
            # the cluster's penalty path (on-box convertible admission):
            # migrate the prefix over the owner's interconnect, the stall
            # charged to decode time (DESIGN.md "KV-tier fidelity")
            owner, tokens, _tier = kp
            if owner.kv is not None:
                owner.kv.unpin(req.src.rid)
                req.decode_time += owner.kv.migration_stall(
                    tokens, owner.spec.chip.net_bw)
            req.kv_prefix = None
        if self.kv is not None:
            # consumes this request's pin (CoW-shared prefix blocks), if
            # the pin lives on this decoder
            self.kv.admit(req.src.rid, self._admit_bytes(req))
            req.kv_prefix = None
        self.active.append(req)
        self._admit_seq += 1
        req._res_gen = self._admit_seq
        self._count_add(req)
        self._invalidate()

    def _kv_release(self, req: SimRequest, t: float):
        """Free the finished request's blocks, leaving its prompt+output
        prefix cached under its session for follow-up reuse.  With the
        gateway on, the shared system prompt is additionally aliased under
        its fleet-wide key (cross-session reuse) and this decoder is
        marked as a holder in the fleet's prefix hashtrie."""
        if self.kv is None:
            return
        gw = self.gateway
        src = req.src
        ctx = int(src.in_len + req.generated)
        if gw is not None:
            shid = getattr(src, "shared_id", -1)
            shlen = getattr(src, "shared_len", 0)
            if shid >= 0 and shlen > 0:
                # alias before release: the allocation's blocks are live
                self.kv.cache_alias(("sys", shid), src.rid, shlen, t)
        self.kv.release(src.rid, req.session, ctx, t)
        if gw is not None:
            chain = prefix_chain(
                getattr(src, "shared_id", -1),
                getattr(src, "shared_len", 0),
                req.session, ctx, gw.block_size)
            if chain:
                gw.trie.insert(chain, self, t, gw.block_size)

    def grow_lazy(self, t: float):
        """Allocate-on-generate: after an iteration's tokens land, extend
        each resident's blocks to cover its next token.  A resident whose
        grow finds no HBM (even after reclaiming cached prefixes) joins
        ``oom_pending`` for the cluster to resolve — the model carries at
        most one unbacked token per resident until then (the event engine
        resolves it before the next iteration is scheduled; the fluid
        engine at tick granularity)."""
        kv, st = self.kv, self.gw_stats
        for r in self.active:
            if r.t_finish >= 0:
                continue
            added = kv.try_grow(r.src.rid, self._admit_bytes(r))
            if added is None:
                st.grow_failures += 1
                if r not in self.oom_pending:
                    self.oom_pending.append(r)
            elif added:
                st.block_grows += added

    def iter_time(self) -> float:
        it = self._iter_cache
        if it is None:
            it = self._iter_cache = self._iter_time_fresh()
        return it

    def _iter_terms(self) -> tuple[float, float]:
        """(FLOPs, bytes) of one decode-only iteration over the current
        batch — the roofline numerators shared by ``_iter_time_fresh`` and
        the chunked-prefill mixed-iteration math."""
        b = len(self.active)
        c = self.cost
        if b == 0:
            return 0.0, c.aw_bytes
        if self._ctx_exact:
            # integer-exact running total == the sequential sum, bitwise
            avg_ctx = self._ctx_sum / b
        else:
            avg_ctx = sum(r.src.in_len + r.generated
                          for r in self.active) / b
        mem = c.aw_bytes + b * (c.kv_tok * avg_ctx + c.state_fix)
        f = b * (c.flops_tok + c.attn_coef * avg_ctx)
        return f, mem

    def _iter_time_fresh(self) -> float:
        b = len(self.active)
        if b == 0:
            return 0.0
        f, mem = self._iter_terms()
        if self.is_convertible and self.prefill_q and self.conv \
                and not self.chunking:
            # legacy wholesale conversion — mixed iteration: the chunk
            # occupies (chunk - batch) extra slots.  (Chunked mode charges
            # the actually-planned chunk via mixed_iter_time instead.)
            c = self.cost
            chunk = self.conv.chunk_size
            f += max(chunk - b, 0) * c.flops_tok
            mem += max(chunk - b, 0) * c.kv_tok
        it = max(mem / self.spec.hbm_bw, f / self.spec.flops)
        if self.perf != 1.0:
            # straggler chip (sim.faults): the whole roofline slows by
            # the effective-velocity factor for the window's duration
            it /= self.perf
        return it

    # ---- chunked prefill (per-iteration co-scheduling) ----
    def mixed_iter_time(self, chunk_tok: float) -> float:
        """Iteration time with ``chunk_tok`` prefill tokens co-scheduled
        next to the current decode batch (the chunk streams its KV writes
        and linear FLOPs through the same roofline).  With an empty batch
        this is the chunk-only iteration: weights still stream once."""
        if not self.active and chunk_tok <= 0:
            return 0.0
        c = self.cost
        f, mem = self._iter_terms()
        f += chunk_tok * c.flops_tok
        mem += chunk_tok * c.kv_tok
        it = max(mem / self.spec.hbm_bw, f / self.spec.flops)
        if self.perf != 1.0:
            it /= self.perf
        return it

    def _tpot_budget(self) -> float:
        """Eq. 5's TPOT budget for the *strictest* resident class (the
        chunk must not push any resident past its own SLO); the global
        default paces chunk-only iterations so admissions never wait
        longer than one TPOT-scale boundary."""
        pc = self._prio_counts
        return tpot_slo(min(pc)) if pc else tpot_slo()

    def _headroom_chunk(self) -> float:
        """Online Eq. 5: the largest chunk (whole tokens, capped by the
        pool's configured chunk size) the next iteration can co-schedule
        while staying within ``_tpot_budget``.  0 when the batch alone
        already exceeds the budget."""
        cap = float(self.chunking)
        if self.conv is not None:
            cap = min(cap, float(self.conv.chunk_size))
        if cap <= 0:
            return 0.0
        c = self.cost
        f, mem = self._iter_terms()
        return headroom_chunk_tokens(
            f, mem, c.flops_tok, c.kv_tok, self.spec.flops,
            self.spec.hbm_bw, self._tpot_budget(), cap)

    def plan_chunk(self) -> float:
        """The chunk the next iteration will actually execute: Eq. 5
        headroom, floored at ``MIN_DEFLECT_CHUNK`` (starvation guard —
        queued prompts always make progress, even against a batch with no
        headroom) and capped by the work actually queued."""
        if not self.chunking or not self.prefill_q:
            return 0.0
        c = max(self._headroom_chunk(), float(MIN_DEFLECT_CHUNK))
        return min(c, self.inflight_tokens())

    def deflect_velocity(self) -> float:
        """Mixed-iteration slack as an absorption rate (tok/s): the Eq. 5
        headroom chunk over the mixed iteration that would execute it.
        Advertises 0 when the batch has less than the minimum chunk of
        headroom — the router never *adds* deflected work to a decoder
        that could only serve it through the starvation floor."""
        if not self.chunking:
            return 0.0
        c = self._headroom_chunk()
        if c < MIN_DEFLECT_CHUNK:
            return 0.0
        return chunked_prefill_velocity(c, self.mixed_iter_time(c))

    #: batches at least this large take the vectorized fluid-tick path;
    #: numpy's per-call overhead beats the Python loop beyond it.  Both
    #: paths run the identical per-element IEEE-double operations, so the
    #: results are bitwise equal either way (goldens + differential pin it)
    _VEC_MIN_BATCH = 24

    def tick(self, t: float, dt: float) -> list[SimRequest]:
        """Fluid engine: advance decode (and convertible prefill) by dt.
        Returns finished requests.  ``generated`` is clamped at ``out_len``
        (no memory-accounting overshoot) and the final tick is prorated, so
        a request finishing mid-tick is billed only the fraction of the
        tick it actually decoded.  Large batches advance through numpy
        (elementwise, same float ops as the scalar loop)."""
        if not self.ready(t):
            return []
        finished: list[SimRequest] = []
        it_mix = 0.0
        if self.chunking and self.prefill_q:
            # per-tick approximation of chunk-interleaved execution: one
            # planned chunk per mixed iteration, so queued prefill advances
            # at chunk/iter tok/s while decode is paced by the same mixed
            # iteration (the event engine runs the exact chunk boundaries)
            chunk = self.plan_chunk()
            if chunk > 0:
                it_mix = self.mixed_iter_time(chunk)
                if it_mix > 0:
                    self.advance_prefill(chunk * dt / it_mix, t)
        elif self.is_convertible and self.prefill_q and self.conv:
            self.advance_prefill(self.conv.v_prefill * dt, t)
        it = it_mix if it_mix > 0 else self.iter_time()
        if it <= 0:
            return finished
        rate = dt / it                     # tokens per request this tick
        b = len(self.active)
        if self.obs is not None and rate > 0:
            # decode-token odometer: read-only pre-pass over the residents
            # *before* the grant loop mutates ``generated`` — telemetry-on
            # only, so the default path pays one attribute test per tick
            self.obs.decode_tokens_done += sum(
                min(rate, max(r.src.out_len - r.generated, 0.0))
                for r in self.active)
        self._invalidate()                 # every resident's length moves
        self._ctx_exact = False            # fluid grants fractional tokens
        if b >= self._VEC_MIN_BATCH:
            out_len = np.fromiter((r.src.out_len for r in self.active),
                                  np.float64, b)
            gen = np.fromiter((r.generated for r in self.active),
                              np.float64, b)
            remaining = np.maximum(out_len - gen, 0.0)
            take = np.minimum(rate, remaining)
            frac = take / rate if rate > 0 else np.zeros(b)
            dt_spent = dt * frac
            new_gen = gen + take
            first = new_gen >= 1.0 - 1e-9
            done = (remaining - take) <= 1e-9
            t_evt = t + dt_spent
            for i, r in enumerate(self.active):
                r.generated = float(new_gen[i])
                r.decode_time += float(dt_spent[i])
                if r.t_first_token < 0 and first[i]:
                    r.t_first_token = float(t_evt[i])
                if done[i]:
                    r.generated = float(r.src.out_len)
                    r.t_finish = float(t_evt[i])
                    finished.append(r)
        else:
            for r in self.active:
                remaining = max(r.src.out_len - r.generated, 0.0)
                take = min(rate, remaining)
                frac = take / rate if rate > 0 else 0.0
                r.generated += take
                r.decode_time += dt * frac
                if r.t_first_token < 0 and r.generated >= 1.0 - 1e-9:
                    # end of the tick in which the first token completed
                    r.t_first_token = t + dt * frac
                if remaining - take <= 1e-9:
                    r.generated = float(r.src.out_len)
                    r.t_finish = t + dt * frac
                    finished.append(r)
        for r in finished:
            self._kv_release(r, r.t_finish)
        if finished:
            self.active = [r for r in self.active if r.t_finish < 0]
            for r in finished:
                self._count_remove(r)
        if self.lazy and self.kv is not None and self.active:
            self.grow_lazy(t)
        return finished

    @property
    def idle(self) -> bool:
        # a decoder whose prefix cache is pinned by in-flight arrivals is
        # not scale-down-safe even with no resident work
        return not self.active and not self.prefill_q and not self.kv_spill \
            and not (self.kv is not None and self.kv.busy)


# ---------------------------------------------------------------------------
# Pools & fleets (runtime side of core.fleet's declarative specs)
# ---------------------------------------------------------------------------

@dataclass
class Pool:
    """One named pool of identical instances, with its spec resolved to
    runtime objects: model config, instance spec, velocity profile, cost
    constants, and (for convertible pools) the Eq. 5-6 restriction."""
    spec: PoolSpec
    cfg: ModelConfig
    inst: InstanceSpec
    prof: VelocityProfile
    conv_cfg: Optional[ConvertibleConfig] = None
    cost: Optional[ModelCost] = None
    instances: list = field(default_factory=list)

    def __post_init__(self):
        if self.cost is None:
            self.cost = ModelCost.of(self.cfg)


class ModelGroup:
    """One model's pools (at least one prefill + one decode — same-role
    pool *sets* — and at most one convertible) plus its own router/burst-
    detector: burst detection and Alg. 1 routing are per model, so one
    tenant's spike never routes another tenant's traffic to the wrong
    Convertible Decoders.

    The first-declared pool of each role is the model's *primary* pool
    (``self.prefill`` / ``self.decode``): per-model policy plumbing and
    the legacy single-pool aliases see exactly that one, so single-pool
    fleets behave byte-identically.  Routing and admission candidates
    span the full sets."""

    def __init__(self, model: str, prefill_pools: list[Pool],
                 decode_pools: list[Pool], convertible: Optional[Pool]):
        self.model = model
        self.prefill_pools = list(prefill_pools)
        self.decode_pools = list(decode_pools)
        self.prefill = self.prefill_pools[0]
        self.decode = self.decode_pools[0]
        self.convertible = convertible
        self.router = Router(BurstDetector())
        # locality gateway (core.gateway) — built by ClusterBase when any
        # of this model's decode-side pools sets PoolSpec.gateway
        self.gateway: Optional[Gateway] = None
        # deflection (Alg. 1 round 2b) is enabled per model by a decode
        # pool's chunking knob; convertible pools with chunking keep their
        # round-2 slot but execute chunk-interleaved instead of wholesale
        self.deflect_on = any(p.spec.prefill_chunking > 0
                              for p in self.decode_pools)
        # decode_instances() is probed per (pending request, pass) on the
        # admission path; pool membership only changes inside
        # ClusterBase._scale, which drops these caches
        self._decode_cache: Optional[list] = None
        self._prefill_cache: Optional[list] = None

    def conv_instances(self) -> list:
        return self.convertible.instances if self.convertible else []

    def prefill_instances(self) -> list:
        """All prefill-role instances across the pool set.  Single-pool
        groups return the pool's own (live) list — the historical
        aliasing — multi-pool groups a cached flattening."""
        if len(self.prefill_pools) == 1:
            return self.prefill.instances
        v = self._prefill_cache
        if v is None:
            v = self._prefill_cache = [i for p in self.prefill_pools
                                       for i in p.instances]
        return v

    def deflect_instances(self) -> list:
        """Round-2b candidates: instances of decode pools with chunking on
        (the convertibles are already round-2 targets)."""
        if not self.deflect_on:
            return []
        if len(self.decode_pools) == 1:
            return self.decode.instances
        return [i for p in self.decode_pools
                if p.spec.prefill_chunking > 0 for i in p.instances]

    def decode_instances(self) -> list:
        v = self._decode_cache
        if v is None:
            if len(self.decode_pools) == 1:
                v = self.decode.instances + self.conv_instances()
            else:
                v = [i for p in self.decode_pools for i in p.instances] \
                    + self.conv_instances()
            self._decode_cache = v
        return v


class Fleet:
    """Runtime fleet: named ``Pool``s in declaration order + per-model
    groups.  ``sim.runner.build_fleet`` resolves a declarative
    ``core.fleet.FleetSpec`` into one of these; the legacy single-pool
    constructor path builds one inline."""

    def __init__(self, pools: list[Pool]):
        self.pools: dict[str, Pool] = {}
        for p in pools:
            if p.spec.name in self.pools:
                raise ValueError(f"duplicate pool name {p.spec.name!r}")
            self.pools[p.spec.name] = p
        models: list[str] = []
        for p in pools:
            if p.spec.model not in models:
                models.append(p.spec.model)
        self.groups: dict[str, ModelGroup] = {}
        for m in models:
            mine = [p for p in pools if p.spec.model == m]
            pre = [p for p in mine if p.spec.role == "prefill"]
            dec = [p for p in mine if p.spec.role == "decode"]
            conv = [p for p in mine if p.spec.role == "convertible"]
            if not pre or not dec or len(conv) > 1:
                raise ValueError(
                    f"model {m!r}: need at least one prefill and one decode "
                    f"pool and at most one convertible pool, got "
                    f"{[p.spec.name for p in mine]}")
            self.groups[m] = ModelGroup(m, pre, dec,
                                        conv[0] if conv else None)
        self.default_model = models[0]

    def role_pools(self, role: str) -> list[Pool]:
        return [p for p in self.pools.values() if p.spec.role == role]


# ---------------------------------------------------------------------------
# Metrics pipeline (§V) — shared by both engines
# ---------------------------------------------------------------------------

@dataclass
class SimReport:
    name: str
    requests: list[SimRequest]
    gpu_seconds: float
    duration: float
    timeline: list[dict] = field(default_factory=list)
    engine: str = "fluid"
    # (t, victim_priority, preemptor_priority, victim_generated) rows
    preemptions: list[tuple] = field(default_factory=list)
    # KV-tier counters (sim.kvcache.KVStats.summary(); {} when tiers off)
    kv: dict = field(default_factory=dict)
    # gateway routing/replication/lazy-paging counters
    # (core.gateway.RoutingStats.summary(); {} when no pool enables the
    # gateway or lazy paging — kept separate from ``kv`` so the kvtiers
    # golden's pinned schema never changes)
    gw: dict = field(default_factory=dict)
    # chaos-engine injection/recovery counters
    # (sim.faults.FaultStats.summary(); {} when faults are off)
    faults: dict = field(default_factory=dict)
    # events processed by the run (event engine; 0 for fluid) — the
    # perf-bench suite's events/sec numerator (benchmarks/perf.py)
    n_events: int = 0
    # prompts the router deflected to regular decoders (Alg. 1 round 2b;
    # 0 with chunking off)
    n_deflected: int = 0
    # dollar-weighted billing integral (ChipSpec.cost_per_hour x TP per
    # provisioned instance-second — the weighted analog of gpu_seconds)
    # and its per-pool breakdown; the --bench=pareto cost axis
    cost_dollars: float = 0.0
    pool_cost: dict = field(default_factory=dict)
    # flight recorder (repro_torch.obs.FlightRecorder) carrying the run's span
    # trace / metrics samples / decision log; None unless the run was
    # built with ExperimentSpec.telemetry on
    obs: Optional[object] = None

    # ---- SLO metrics (§V) ----
    # Every metric optionally restricts to one priority class and/or one
    # model (multi-model fleets) and/or the preempted slice; SLO targets
    # are per-class (core.router.ttft_slo / tpot_slo).
    # Filtered views and per-metric value vectors are memoized per filter
    # key (reports are read-only once a run ends): bench tables that probe
    # many percentiles over the same slice extract and sort each slice
    # once instead of per metric.

    def _pool(self, priority: Optional[int] = None,
              model: Optional[str] = None,
              preempted: Optional[bool] = None) -> list[SimRequest]:
        cache = self.__dict__.setdefault("_pool_cache", {})
        key = (priority, model, preempted)
        reqs = cache.get(key)
        if reqs is None:
            reqs = self.requests
            if priority is not None:
                reqs = [r for r in reqs if r.priority == priority]
            if model is not None:
                reqs = [r for r in reqs if r.model == model]
            if preempted is not None:
                reqs = [r for r in reqs if (r.n_evictions > 0) == preempted]
            cache[key] = reqs
        return reqs

    def _finished_vals(self, what: str, priority: Optional[int],
                       model: Optional[str], preempted: Optional[bool]
                       ) -> tuple[np.ndarray, np.ndarray]:
        """(values-in-request-order, sorted-values) for one metric over
        one filtered slice.  ``mean`` consumes the former (numpy's pairwise
        sum is order-sensitive, and the seed code averaged in request
        order); percentiles consume the latter — an order statistic is
        order-blind, so sorting once per (metric, slice) is free."""
        cache = self.__dict__.setdefault("_vals_cache", {})
        key = (what, priority, model, preempted)
        out = cache.get(key)
        if out is None:
            vals = [getattr(r, what)
                    for r in self._pool(priority, model, preempted)
                    if r.t_finish >= 0 and getattr(r, what) >= 0]
            arr = np.asarray(vals, dtype=np.float64)
            out = cache[key] = (arr, np.sort(arr))
        return out

    def priority_classes(self) -> list[int]:
        return sorted({r.priority for r in self.requests})

    def models(self) -> list[str]:
        """Distinct models served, in per-model SLO accounting order."""
        return sorted({r.model for r in self.requests})

    def slo_attainment(self, priority: Optional[int] = None,
                       model: Optional[str] = None) -> float:
        reqs = self._pool(priority, model)
        ok = [1.0 if (r.ttft <= ttft_slo(r.src.in_len, r.priority)
                      and r.tpot <= tpot_slo(r.priority)) else 0.0
              for r in reqs if r.t_finish >= 0]
        unfinished = sum(1 for r in reqs if r.t_finish < 0)
        total = len(ok) + unfinished
        return sum(ok) / max(total, 1)

    def ttft_attainment(self, priority: Optional[int] = None,
                        model: Optional[str] = None) -> float:
        reqs = self._pool(priority, model)
        done = [r for r in reqs if r.t_first_token >= 0]
        ok = sum(1 for r in done
                 if r.ttft <= ttft_slo(r.src.in_len, r.priority))
        return ok / max(len(reqs), 1)

    def tpot_attainment(self, priority: Optional[int] = None,
                        model: Optional[str] = None) -> float:
        reqs = self._pool(priority, model)
        done = [r for r in reqs if r.t_finish >= 0]
        ok = sum(1 for r in done if r.tpot <= tpot_slo(r.priority))
        return ok / max(len(reqs), 1)

    def avg_gpus(self) -> float:
        return self.gpu_seconds / max(self.duration, 1e-9)

    def cost_summary(self) -> dict:
        """Dollar-billing view (the weighted analog of ``avg_gpus``): the
        exact piecewise-constant cost integral, its hourly rate, and the
        per-pool breakdown — the DistServe goodput-per-dollar axis that
        ``--bench=pareto`` plots against SLO attainment."""
        return {
            "cost_dollars": self.cost_dollars,
            "cost_per_hour": self.cost_dollars
            / max(self.duration, 1e-9) * 3600.0,
            "pool_cost": dict(self.pool_cost),
        }

    def throughput(self, model: Optional[str] = None) -> float:
        """Finished requests per second over the horizon."""
        done = sum(1 for r in self._pool(model=model) if r.t_finish >= 0)
        return done / max(self.duration, 1e-9)

    def mean(self, what: str, priority: Optional[int] = None,
             model: Optional[str] = None,
             preempted: Optional[bool] = None) -> float:
        vals, _ = self._finished_vals(what, priority, model, preempted)
        return float(np.mean(vals)) if len(vals) else float("nan")

    def percentile(self, what: str, q: float,
                   priority: Optional[int] = None,
                   model: Optional[str] = None,
                   preempted: Optional[bool] = None) -> float:
        _, svals = self._finished_vals(what, priority, model, preempted)
        return float(np.percentile(svals, q)) if len(svals) \
            else float("nan")

    # ---- canonical metric schemas (golden fixtures + regen share these,
    # so the regenerator and the regression test can never drift apart) --
    def summary(self) -> dict:
        return {
            "n_requests": len(self.requests),
            "slo_attainment": self.slo_attainment(),
            "ttft_attainment": self.ttft_attainment(),
            "tpot_attainment": self.tpot_attainment(),
            "avg_gpus": self.avg_gpus(),
            "throughput": self.throughput(),
            "ttft_mean": self.mean("ttft"),
            "tpot_mean": self.mean("tpot"),
            "ttft_p99": self.percentile("ttft", 99),
            "tpot_p99": self.percentile("tpot", 99),
            "ttft_p999": self.percentile("ttft", 99.9),
        }

    def class_summary(self, priority: int) -> dict:
        n = len(self._pool(priority))
        if n == 0:
            # stable zero-valued schema for absent classes instead of
            # NaN percentiles (the *_summary degradation contract)
            return {"n": 0, "slo_attainment": 0.0,
                    "ttft_p99": 0.0, "tpot_p99": 0.0}
        return {
            "n": n,
            "slo_attainment": self.slo_attainment(priority),
            "ttft_p99": self.percentile("ttft", 99, priority=priority),
            "tpot_p99": self.percentile("tpot", 99, priority=priority),
        }

    def model_summary(self, model: str) -> dict:
        """Per-model SLO accounting for multi-model fleets (same schema
        contract as ``summary``/``class_summary``: goldens and their
        regenerator share it)."""
        n = len(self._pool(model=model))
        if n == 0:
            # stable zero-valued schema for unknown models (see
            # class_summary)
            return {"n": 0, "slo_attainment": 0.0, "ttft_attainment": 0.0,
                    "tpot_attainment": 0.0, "throughput": 0.0,
                    "ttft_p99": 0.0}
        return {
            "n": n,
            "slo_attainment": self.slo_attainment(model=model),
            "ttft_attainment": self.ttft_attainment(model=model),
            "tpot_attainment": self.tpot_attainment(model=model),
            "throughput": self.throughput(model=model),
            "ttft_p99": self.percentile("ttft", 99, model=model),
        }

    def kv_summary(self) -> dict:
        """KV-tier metrics (prefix hit rate, offload bytes, swap stalls,
        blocks-in-use watermarks) plus the preempted-request tail slice —
        the schema the ``kvtiers`` golden and its regenerator share.
        When the fleet runs the legacy flat byte counter the same key
        set comes back zero-valued (the *_summary degradation contract:
        stable schema, no empty-dict/KeyError special cases)."""
        if not self.kv:
            out = KVStats().summary()
            out["n_preempted"] = 0
            out["preempted_ttft_p99"] = 0.0
            out["preempted_tpot_p99"] = 0.0
            return out
        out = dict(self.kv)
        out["n_preempted"] = len(self._pool(preempted=True))
        out["preempted_ttft_p99"] = self.percentile("ttft", 99,
                                                    preempted=True)
        out["preempted_tpot_p99"] = self.percentile("tpot", 99,
                                                    preempted=True)
        return out

    def gw_summary(self) -> dict:
        """Gateway metrics: routing-decision breakdown (affinity hit /
        replica hit / load-balanced fallback), replication traffic, and
        lazy-paging counters — the schema the ``gateway_locality`` golden
        and its regenerator share.  When no pool enables the gateway or
        lazy paging the same key set comes back zero-valued (see
        ``kv_summary``)."""
        if not self.gw:
            return RoutingStats().summary()
        return dict(self.gw)

    def fault_summary(self) -> dict:
        """Chaos-engine counters: injections by kind, crash restarts,
        requeued work, KVC retry/backoff totals — the schema the
        ``chaos_recovery`` golden and its regenerator share.  When faults
        are off the same key set comes back zero-valued (see
        ``kv_summary``)."""
        if not self.faults:
            return FaultStats().summary()
        return dict(self.faults)


# ---------------------------------------------------------------------------
# Control plane glue — shared by both engines
# ---------------------------------------------------------------------------

class ClusterBase:
    """PD-disaggregated cluster state + the unmodified TokenScale control
    plane, executing ``FleetPlan``s against named pools (mixed chips/TP,
    multiple models).  Subclasses implement ``run`` (how time advances)
    and may hook ``_submit_prefill_work`` / ``_after_scale`` to schedule
    work.

    Two construction paths share one body:

      * pool-centric — ``Engine(fleet, policy=fleet_policy)`` with a
        runtime ``Fleet`` and a ``FleetPolicy`` (what ``sim.runner
        .run_spec`` builds from an ``ExperimentSpec``);
      * legacy — ``Engine(cfg, inst_spec, profile, policy, ...)``: the
        historical single-(model, chip, tp) signature, desugared into a
        one-model fleet (pools "prefill"/"decode"/"convertible") with the
        per-model ``Policy`` adapted by ``PerModelFleetPolicy`` — every
        decision it makes is byte-identical to the pre-pool control
        plane (the golden fixtures enforce this).
    """

    engine = "base"

    def __init__(self, cfg: "ModelConfig | Fleet",
                 inst_spec: Optional[InstanceSpec] = None,
                 profile: Optional[VelocityProfile] = None,
                 policy: "Policy | FleetPolicy | None" = None,
                 predictor: Optional[OutputPredictor] = None,
                 conv_cfg: Optional[ConvertibleConfig] = None,
                 n_convertible: int = 0,
                 init_prefillers: int = 1, init_decoders: int = 1,
                 dt: float = 0.025, scale_interval: float = 1.0,
                 max_instances: int = 64,
                 preemption: "PreemptionPolicy | str" = "none",
                 snapshot_interval: Optional[float] = None,
                 faults: "FaultConfig | dict | None" = None):
        if isinstance(cfg, Fleet):
            fleet = cfg
            fpolicy = policy if policy is not None else inst_spec
            if not isinstance(fpolicy, FleetPolicy):
                raise TypeError("fleet construction needs a FleetPolicy")
        else:
            if inst_spec is None or profile is None or policy is None:
                raise TypeError(
                    "legacy construction needs (cfg, inst_spec, profile, "
                    "policy)")
            fleet = self._single_pool_fleet(
                cfg, inst_spec, profile, conv_cfg,
                init_prefillers, init_decoders, n_convertible)
            fpolicy = policy if isinstance(policy, FleetPolicy) \
                else PerModelFleetPolicy({cfg.name: policy})
        self.fleet = fleet
        self.pools = fleet.pools
        self.policy = fpolicy
        self.predictor = predictor or OutputPredictor(0.85)
        self.preemption = PreemptionPolicy.of(preemption)
        # (t, victim_priority, preemptor_priority, victim_generated) audit
        # trail — the preemption property tests assert over it
        self.preemption_log: list[tuple[float, int, int, float]] = []
        self.dt = dt
        self.scale_interval = scale_interval
        self.max_instances = max_instances
        # timeline snapshot cadence; None = adaptive (the historical 0.2 s
        # up to ~13-minute horizons, then stretched to cap the timeline at
        # ~4000 rows so multi-hour traces don't grow it unboundedly)
        self.snapshot_interval = snapshot_interval
        # KV-tier subsystem (sim.kvcache): one stats sink shared by every
        # decoder's allocator; enabled per pool via PoolSpec.block_size
        self.kv_stats = KVStats()
        self._kv_on = any(
            p.spec.block_size > 0 and p.spec.role != "prefill"
            and p.cost.kv_tok > 0 for p in self.pools.values())
        # ---- locality gateway + lazy paging (core.gateway) ----
        # one counter sink across all model groups' gateways; per-group
        # Gateway objects own the trie (placement is per model).  _gw_on
        # gates every gateway/lazy hook so legacy fleets stay byte-
        # identical (the six pre-gateway goldens pin this).
        self.gw_stats = RoutingStats()
        self._gw_jobs: list = []      # pending ReplicationJobs, by t_done
        self._gw_on = any(p.spec.kv_alloc == "lazy"
                          for p in self.pools.values())
        for g in fleet.groups.values():
            gpools = [p for p in g.decode_pools if p.spec.gateway]
            if g.convertible is not None and g.convertible.spec.gateway:
                gpools.append(g.convertible)
            if gpools:
                g.gateway = Gateway(GatewayConfig(),
                                    gpools[0].spec.block_size,
                                    self.gw_stats)
                self._gw_on = True
        # flight recorder (repro_torch.obs): None = telemetry off.  Every hook
        # below is guarded by ``self.obs is not None`` and the recorder
        # is a pure observer, so the disabled path is byte-identical and
        # the enabled path cannot perturb event ordering.  Set before the
        # initial spawns so ``_spawn`` can propagate it unconditionally.
        self.obs = None
        self._iid = 0
        for pool in self.pools.values():     # declaration order = iid order
            for _ in range(pool.spec.init):
                pool.instances.append(self._spawn(pool, 0.0))
        # legacy aliases for the default model group (single-pool callers)
        g = fleet.groups[fleet.default_model]
        self.cfg = g.prefill.cfg
        self.spec = g.prefill.inst
        self.prof = g.prefill.prof
        self.cost = g.decode.cost
        self.conv_cfg = g.convertible.conv_cfg if g.convertible else None
        self.router = g.router
        # (ready_t, req) entries, kept sorted by the admission key
        # (priority, ready_t, rid) — ``_admit_pending`` historically
        # re-sorted the whole list on every call; bisect inserts keep the
        # identical order with O(log n) per entry instead
        self.pending_decode: list[tuple[float, SimRequest]] = []
        # kept sorted by (priority, arrival t, rid) — the §IV-E drain's
        # historical per-call sort key — via bisect inserts
        self.wait_queue: list[SimRequest] = []
        self.finished: list[SimRequest] = []
        self.gpu_seconds = 0.0
        # dollar-weighted billing: a segment-based integral advanced at
        # every fleet-membership change (see _cost_advance) — exact with
        # zero per-tick/per-event cost, unlike gpu_seconds' cached-rate
        # accumulation in the engines' run loops
        self.cost_dollars = 0.0
        self.pool_cost = {name: 0.0 for name in self.pools}
        self._cost_t0 = 0.0
        self.n_deflected = 0     # prompts routed to decoders (round 2b)
        self.timeline: list[dict] = []
        # rolling 1-s gateway counters (deque: the 5 s window expires from
        # the left instead of rebuilding the list on every arrival)
        self._arrivals: deque[tuple[float, SimRequest]] = deque()
        # ---- chaos engine (sim.faults): None = faults off — no schedule
        # is built, every per-tick/per-event hook fast-paths out, and the
        # pre-chaos goldens stay byte-identical ----
        self.faults: Optional[FaultConfig] = None if not faults else (
            faults if isinstance(faults, FaultConfig)
            else FaultConfig.from_dict(dict(faults)))
        self.fault_stats = FaultStats()
        self._fault_work: list[tuple] = []   # (t, kind, *payload), sorted
        self._link_down_until = -1.0         # KVC link-outage window end
        self._monitor = HealthMonitor(self.faults.detect_s) \
            if self.faults is not None else None
        # measured effective velocity feeds Eq. 2-4 only on the
        # self-healing path (the observation stays byte-stable otherwise)
        self._fault_eff = self.faults is not None and self.faults.recovery

    # ---- flight-recorder attachment (repro_torch.obs) ----------------------
    def attach_obs(self, rec):
        """Attach a ``FlightRecorder`` to this run (idempotent per
        recorder).  Wires the per-group router/gateway trace hooks and
        propagates the recorder to already-spawned instances; instances
        spawned later inherit it via ``_spawn``."""
        self.obs = rec
        rec.engine = self.engine
        for g in self.fleet.groups.values():
            g.router.trace_hook = rec.router_hook(g.model)
            if g.gateway is not None:
                g.gateway.trace_hook = rec.gateway_hook(g.model)
        for pool in self.pools.values():
            for i in pool.instances:
                i.obs = rec
        return rec

    # ------------------------------------------------------------------
    @staticmethod
    def _single_pool_fleet(cfg, inst_spec, profile, conv_cfg,
                           init_prefillers, init_decoders,
                           n_convertible) -> Fleet:
        """The legacy signature desugared: one model, one chip, one TP."""
        chip, tp = inst_spec.chip.name, inst_spec.tp
        mk = lambda name, role, init: Pool(      # noqa: E731
            PoolSpec(name, role, cfg.name, chip, tp, init=init),
            cfg, inst_spec, profile,
            conv_cfg=conv_cfg if role == "convertible" else None)
        return Fleet([mk("prefill", "prefill", init_prefillers),
                      mk("decode", "decode", init_decoders),
                      mk("convertible", "convertible", n_convertible)])

    def _spawn(self, pool: Pool, ready_t: float):
        self._iid += 1
        if pool.spec.role == "prefill":
            i: "Prefiller | Decoder" = Prefiller(
                self._iid, pool.inst, pool.cost, ready_t,
                pool.prof.v_prefill)
        else:
            conv = pool.spec.role == "convertible"
            i = Decoder(self._iid, pool.inst, pool.cost, ready_t,
                        conv=pool.conv_cfg if conv else None)
            i.is_convertible = conv
            i.hbm_frac = pool.spec.hbm_frac
            i.chunking = pool.spec.prefill_chunking
            if pool.spec.block_size > 0 and pool.cost.kv_tok > 0:
                i.kv = self._make_allocator(pool, i)
            i.lazy = pool.spec.kv_alloc == "lazy" and i.kv is not None
            i.gw_stats = self.gw_stats
            if pool.spec.gateway:
                i.gateway = self.fleet.groups[pool.spec.model].gateway
        i.pool = pool
        i.obs = self.obs
        return i

    def _make_allocator(self, pool: Pool, d: Decoder) -> KVAllocator:
        """Resolve the pool's tier knobs against the decoder's usable HBM
        (after weights and the Eq. 6 convertible reserve) and the chip's
        host-DRAM constants (``offload_gb=None`` = chip default, 0 = tier
        off)."""
        bs = pool.spec.block_size
        bb = bs * pool.cost.kv_tok
        n_hbm = max(int(max(d.mem_cap(), 0.0) // bb), 1)
        off = pool.spec.offload_gb
        off_bytes = pool.inst.host_dram_cap if off is None else off * 1e9
        cfg = KVTierConfig(
            block_size=bs, block_bytes=bb, n_hbm=n_hbm,
            n_dram=int(max(off_bytes, 0.0) // bb),
            swap_bw=pool.inst.swap_bw or pool.inst.chip.net_bw,
            prefix_cache=pool.spec.prefix_cache)
        return KVAllocator(cfg, self.kv_stats)

    # ---- flat views + legacy factories (compat surface) --------------
    def _role_view(self, role: str) -> list:
        """All instances of one role, flattened across pools.  Always a
        copy — mutating it is a silent no-op regardless of fleet shape,
        so callers that grow/shrink the fleet must go through the pool's
        own ``instances`` list (as ``_scale`` does)."""
        return [i for p in self.fleet.role_pools(role)
                for i in p.instances]

    @property
    def prefillers(self) -> list:
        return self._role_view("prefill")

    @property
    def decoders(self) -> list:
        return self._role_view("decode")

    @property
    def convertibles(self) -> list:
        return self._role_view("convertible")

    def _new_prefiller(self, ready_t: float) -> Prefiller:
        g = self.fleet.groups[self.fleet.default_model]
        return self._spawn(g.prefill, ready_t)

    def _new_decoder(self, ready_t: float, convertible: bool = False
                     ) -> Decoder:
        g = self.fleet.groups[self.fleet.default_model]
        pool = g.convertible if convertible else g.decode
        return self._spawn(pool, ready_t)

    # ---- model routing -----------------------------------------------
    def _group_of(self, req: SimRequest) -> ModelGroup:
        model = req.model or self.fleet.default_model
        try:
            return self.fleet.groups[model]
        except KeyError:
            raise ValueError(
                f"request {req.src.rid} targets model {model!r} but the "
                f"fleet serves {sorted(self.fleet.groups)}")

    # ---- queue maintenance -------------------------------------------
    @staticmethod
    def _pending_key(entry: tuple[float, "SimRequest"]) -> tuple:
        return (entry[1].priority, entry[0], entry[1].src.rid)

    @staticmethod
    def _wait_key(req: "SimRequest") -> tuple:
        return (req.priority, req.src.t, req.src.rid)

    def _pending_add(self, entry: tuple[float, "SimRequest"]):
        insort(self.pending_decode, entry, key=self._pending_key)

    def _wait_add(self, req: "SimRequest"):
        insort(self.wait_queue, req, key=self._wait_key)

    # ------------------------------------------------------------------
    def _submit_prefill_work(self, tgt, kind: str, req: SimRequest, t: float):
        """Hand a routed request to its prefill target.  Engines override to
        additionally schedule completion events.  Deflected requests share
        the convertible on-box path (``Decoder.submit_prefill``): chunks
        execute inside the target's decode iterations and the finished
        prompt admits without a KVC transfer."""
        if self.obs is not None:
            self.obs.on_routed(req, t, kind, tgt)
            if kind == "deflect":
                self.obs.on_deflect(req, t, tgt)
        if kind == "prefiller":
            tgt.submit(req, t)
        else:
            if kind == "deflect":
                self.n_deflected += 1
                req.deflect_tgt = tgt
            tgt.submit_prefill(req, t)

    def _on_arrival(self, req: SimRequest, t: float):
        g = self._group_of(req)
        g.router.burst.observe(t, req.src.in_len)
        req.bucket_pred = self.predictor.predict_bucket(
            req.src.in_len, req.src.out_len)
        if self._kv_on:
            if g.gateway is not None:
                self._gw_lookup(g, req, t)
            else:
                self._kv_lookup(g, req, t)
        arrivals = self._arrivals
        arrivals.append((t, req))
        while t - arrivals[0][0] > 5.0:
            arrivals.popleft()
        is_ts = isinstance(self.policy.model_policy(g.model),
                           TokenScalePolicy)
        convs = g.conv_instances()
        burst = is_ts and convs and g.router.burst.is_burst(t)
        if self.obs is not None:
            self.obs.on_arrival(req, t, burst=bool(burst))
        if burst:
            # burst traffic goes straight to the Convertible Decoders (§IV-A)
            tgt, kind = g.router.route_prefill(
                req.src.in_len, [], self._ready(convs, t), t,
                priority=req.priority)
            if tgt is not None:
                self._submit_prefill_work(tgt, "convertible", req, t)
                return
        tgt, kind = g.router.route_prefill(
            req.src.in_len, self._ready(g.prefill_instances(), t),
            self._ready(convs, t) if is_ts else [], t,
            priority=req.priority,
            deflectables=self._ready(g.deflect_instances(), t))
        if kind is not None:
            self._submit_prefill_work(tgt, kind, req, t)
        else:
            # Alg.1 line 15: central queue, re-evaluated as load changes
            if self.obs is not None:
                self.obs.on_routed(req, t, None, None)
            self._wait_add(req)

    def _ready(self, insts, t: float):
        return [i for i in insts if i.ready(t) and not i.draining]

    def _drain_wait_queue(self, t: float):
        """§IV-E: as load changes (scale-ups, drained convertibles), pending
        prefill tasks are re-evaluated and re-assigned — higher priority
        classes first, FIFO within a class, each within its own model's
        pools.  ``wait_queue`` is maintained in exactly that order
        (``_wait_add``), so the historical per-call sort is gone.

        Failure short-circuit (O(1) amortized per queued request): within
        one pass nothing a failing request observes improves — successful
        submissions only *add* in-flight prefill work, ready/draining
        states are frozen at ``t``, and an idle prefiller cannot appear
        mid-pass — so once a request of some model fails both routing
        rounds with no idle fallback, every later request of that model
        with an equal-or-tighter TTFT budget must fail identically.  Those
        skip straight to the carry-over without re-scanning the pools
        (the historical full scan made overload quadratic in queue
        length).  The ready-candidate lists are likewise frozen per pass
        and computed once per model.  Deflection (round 2b) preserves the
        monotonicity: its acceptance is a pure SLO test, and mid-pass
        submissions only grow the deflected queues (the batches — and so
        each decoder's absorption velocity — cannot change inside the
        pass), so a failed budget still implies failure for every
        equal-or-tighter one."""
        if not self.wait_queue:
            return
        still = []
        ready_cache: dict[str, tuple[list, list]] = {}
        failed_slo: dict[str, float] = {}   # model -> widest failed budget
        for req in list(self.wait_queue):
            g = self._group_of(req)
            m = g.model
            slo = ttft_slo(req.src.in_len, req.priority)
            f = failed_slo.get(m)
            if f is not None and slo <= f:
                still.append(req)
                continue
            cached = ready_cache.get(m)
            if cached is None:
                is_ts = isinstance(self.policy.model_policy(m),
                                   TokenScalePolicy)
                cached = ready_cache[m] = (
                    self._ready(g.prefill_instances(), t),
                    self._ready(g.conv_instances(), t) if is_ts else [],
                    self._ready(g.deflect_instances(), t))
            pres, convs, defl = cached
            tgt, kind = g.router.route_prefill(
                req.src.in_len, pres, convs, t, priority=req.priority,
                deflectables=defl)
            if kind is not None:
                self._submit_prefill_work(tgt, kind, req, t)
            else:
                # work conservation: an idle prefiller always takes work,
                # even if the SLO is already forfeited
                idle = [p for p in pres if p.idle]
                if idle:
                    self._submit_prefill_work(idle[0], "prefiller", req, t)
                else:
                    still.append(req)
                    if f is None or slo > f:
                        failed_slo[m] = slo
        self.wait_queue = still

    def _kv_lookup(self, g: ModelGroup, req: SimRequest, t: float):
        """Arrival-time prefix-cache probe: find the decoder holding the
        longest cached prefix of this request's session and pin it.  A hit
        shrinks the prefill work and the KVC transfer to the uncached
        suffix; the pin keeps the blocks resident until admission."""
        cands = [d for d in g.decode_instances()
                 if d.kv is not None and d.ready(t) and not d.draining]
        if not cands:
            return
        st = self.kv_stats
        st.lookups += 1
        st.prompt_tokens += req.src.in_len
        sid = req.session
        if sid < 0 or req.src.prefix_len <= 0:
            return
        best, best_tok, best_tier = None, 0, ""
        for d in cands:
            tok, tier = d.kv.lookup(sid, req.src.prefix_len)
            # longest prefix wins; at equal coverage prefer the HBM copy
            if tok > best_tok or (tok == best_tok and tier == "hbm"
                                  and best_tier == "dram"):
                best, best_tok, best_tier = d, tok, tier
        if best is None or best_tok <= 0:
            return
        bs = best.kv.cfg.block_size
        # keep at least one uncached token so prefill/TTFT stay defined
        usable = (min(best_tok, req.src.in_len - 1) // bs) * bs
        if usable <= 0:
            return
        best.kv.pin(req.src.rid, sid, usable, t)
        req.kv_hit_tokens = usable
        req.kv_prefix = (best, usable, best_tier)
        st.hits += 1
        st.hit_tokens += usable

    # ---- locality gateway (core.gateway; DESIGN.md "Routing fidelity") --
    def _gw_lookup(self, g: ModelGroup, req: SimRequest, t: float):
        """Gateway placement: map the arrival's block-label chain through
        the fleet prefix hashtrie, score holders by ``cached_suffix_savings
        - alpha * queue_depth``, and pin the winner's prefix — session
        chains, cross-session shared prompts, and hot-prefix replicas all
        route through this one mechanism (it replaces the session-only
        owner steering of ``_kv_lookup`` for gateway pools).  No usable
        holder — or a score the least-loaded candidate beats — falls
        through to the share-of-capacity balancer in ``_admit_pending``,
        exactly like a cache miss."""
        gw = g.gateway
        cands = [d for d in g.decode_instances()
                 if d.kv is not None and d.ready(t) and not d.draining]
        if not cands:
            return
        st = self.kv_stats
        st.lookups += 1
        st.prompt_tokens += req.src.in_len
        chain = gw.chain_of(req.src)
        if not chain:
            gw.stats.balanced += 1
            return
        best = gw.best_holder(
            chain, t,
            lambda h: h.live and h.kv is not None and h.ready(t)
            and not h.draining)
        for job in gw.plan_replication(chain, t, cands):
            self._gw_dispatch(gw, job, t)
        if best is None:
            gw.stats.balanced += 1
            return
        holder, node, depth, replica, score = best
        q_min = min(len(d.active) for d in cands)
        if score <= -gw.cfg.alpha * q_min:
            # locality discounted by queue depth loses to the balancer's
            # least-loaded pick: don't steer
            gw.stats.balanced += 1
            return
        # the trie is advisory — validate against the holder's allocator
        # (the ground truth) and round to its own block geometry
        key = gw.cache_key(node.label, req.session)
        tok, tier = holder.kv.lookup(key, depth)
        bs = holder.kv.cfg.block_size
        usable = (min(tok, depth, req.src.in_len - 1) // bs) * bs
        if usable <= 0:
            node.holders.pop(holder, None)     # stale marking: drop it
            gw.stats.balanced += 1
            return
        holder.kv.pin(req.src.rid, key, usable, t)
        req.kv_hit_tokens = usable
        req.kv_prefix = (holder, usable, tier)
        st.hits += 1
        st.hit_tokens += usable
        gw.stats.steered_tokens += usable
        if replica:
            gw.stats.replica_hits += 1
        else:
            gw.stats.affinity_hits += 1

    def _gw_dispatch(self, gw: Gateway, job, t: float):
        """Stamp a planned hot-prefix copy with its interconnect cost —
        the ``migration_stall`` formula (prefix bytes over the origin
        chip's net bandwidth) — and queue it for completion."""
        src = job.source
        stall = src.kv.token_bytes(job.tokens) \
            / max(src.spec.chip.net_bw, 1e-9)
        job.t_done = t + stall
        job.gw = gw
        gw.stats.replica_stall_s += stall
        if self.obs is not None:
            self.obs.on_replication(
                t, "dispatch", tokens=job.tokens, stall=stall,
                source=getattr(src, "iid", None),
                target=getattr(job.target, "iid", None))
        insort(self._gw_jobs, job, key=lambda j: j.t_done)
        self._on_replication(job)

    def _on_replication(self, job):
        """Engine hook: the event engine schedules the exact replica_done
        event; the fluid engine completes due jobs at tick granularity
        via the ``_admit_pending`` preamble."""

    def _service_gateway(self, t: float):
        """Complete due hot-prefix replications and resolve lazy-paging
        OOMs.  Runs in the ``_admit_pending`` preamble: every tick in the
        fluid engine; on each admission-relevant event — plus the exact
        replica_done events — in the event engine."""
        jobs = self._gw_jobs
        while jobs and jobs[0].t_done <= t:
            job = jobs.pop(0)
            job.node.pending = False
            gw, src, tgt = job.gw, job.source, job.target
            if not (src.live and src.kv is not None and tgt.live
                    and tgt.kv is not None and not tgt.draining):
                continue
            tok, tier = src.kv.lookup(job.key, job.tokens)
            if tok < job.tokens or tier != "hbm":
                continue               # origin lost the prefix mid-flight
            if tgt.kv.install(job.key, job.tokens, t):
                gw.trie.insert(job.chain, tgt, t, gw.block_size,
                               replica=True)
                gw.stats.replications += 1
                gw.stats.replica_bytes += tgt.kv.token_bytes(job.tokens)
                if self.obs is not None:
                    self.obs.on_replication(
                        t, "done", tokens=job.tokens,
                        source=getattr(src, "iid", None),
                        target=getattr(tgt, "iid", None))
        for pool in self.pools.values():
            if pool.spec.kv_alloc != "lazy":
                continue
            for d in pool.instances:
                if d.oom_pending:
                    self._service_oom(d, t)

    def _service_oom(self, d: Decoder, t: float):
        """Mid-decode OOM (allocate-on-generate): a resident's per-token
        block grow found no HBM free.  Retry first (completions since the
        failure may have freed blocks); then preempt strictly-lower-
        priority residents through the existing ``PreemptionPolicy``
        machinery; as the last resort the starved request itself is
        evicted (recompute/swap like any other victim) — decode never
        deadlocks on an unbacked token."""
        pend, d.oom_pending = d.oom_pending, []
        st = self.gw_stats
        for r in pend:
            if r.t_finish >= 0 or r not in d.active:
                continue
            if d.kv.try_grow(r.src.rid, d._admit_bytes(r)) is not None:
                continue
            if self.obs is not None:
                self.obs.on_oom(r, t, d)
            victims = self._victim_order(
                [v for v in d.active
                 if v is not r and v.t_finish < 0
                 and v.priority > r.priority], d, t) \
                if self.preemption.enabled else []
            grown = False
            for v in victims:
                self._evict(d, v, r, t)
                st.oom_preemptions += 1
                if d.kv.try_grow(r.src.rid, d._admit_bytes(r)) is not None:
                    grown = True
                    break
            if not grown:
                self._evict(d, r, r, t)
                st.oom_preemptions += 1

    def _to_network(self, req: SimRequest, t: float,
                    pool: Optional[Pool] = None
                    ) -> Optional[tuple[float, SimRequest]]:
        """Ship the finished prefill's KV over the interconnect; returns
        the ``pending_decode`` entry — or None when a KVC link outage
        exhausted the retry ladder and the prompt fell back to the central
        queue for a recompute (``sim.faults``; chaos runs only)."""
        req.t_prefill_end = t
        # the KVC leaves over the *completing* prefiller's interconnect —
        # engines pass its pool, so heterogeneous prefill pool sets charge
        # each chip's own network (single-pool fleets: identical to the
        # model's primary pool)
        if pool is None:
            pool = self._group_of(req).prefill
        # a prefix-cache hit only ships the uncached suffix (the shared
        # blocks already live on the decode side)
        delay = hw.kvc_transfer_time(pool.cfg, pool.inst,
                                     req.src.in_len - req.kv_hit_tokens)
        if self.faults is not None and t < self._link_down_until:
            wait = self._link_wait(t)
            if wait is None:
                # retry ladder exhausted inside the outage window: fall
                # back to recomputing the prompt at the prefill stage
                self.fault_stats.kvc_fallbacks += 1
                if self.obs is not None:
                    self.obs.on_fault(t, "kvc_fallback", rid=req.src.rid)
                self._wait_add(req)
                return None
            delay += wait
        if self.obs is not None:
            # prefiller-side completion odometer + the transfer event
            # (on-box completions are counted in Decoder.advance_prefill)
            self.obs.prefill_tokens_done += req.prefill_tokens
            self.obs.on_transfer(req, t, delay)
        entry = (t + delay, req)
        self._pending_add(entry)
        return entry

    def _admit_pending(self, t: float):
        """Route KV-ready requests to decoders in priority order; on
        backpressure they stay pending and are retried (each tick in the
        fluid engine; on the next kv_ready/iter_done/scale event in the
        event engine).  If preemption is enabled, a request that fits
        nowhere may instead evict/pause strictly-lower-priority resident
        work (the fluid engine reaches this via its per-tick retry; the
        event engine via exact admission events).  Candidates are always
        the request's own model's decode + convertible pools.

        ``pending_decode`` is maintained in admission order
        (priority, ready_t, rid) — see ``_pending_add`` — so each pass
        walks it without the historical per-call sort.

        Failure short-circuit (legacy byte-counter fleets): within one
        pass decoder memory only shrinks — admissions consume it, nothing
        completes mid-pass — so once a request fails on every candidate,
        any later same-model request reserving at least as many bytes
        must fail identically and skips the candidate scan.  The pass
        walks most-urgent-first, so a later request's preemption victims
        are a subset of an earlier one's, preserving the implication for
        the eviction path too; a successful preemption can leave its host
        with *more* free memory than before, so it resets the
        short-circuit.  Paged-KV fleets skip the fast path: prefix pins
        make the reservation per-decoder."""
        if self._gw_on:
            # due hot-prefix replications + lazy-paging OOM resolution
            self._service_gateway(t)
        if self._kv_on:
            # on-box convertible completions that found no blocks free
            for pool in self.pools.values():
                if pool.spec.role == "prefill":
                    continue
                for x in pool.instances:
                    if x.kv_spill:
                        for e in x.kv_spill:
                            self._pending_add(e)
                        x.kv_spill = []
        if not self.pending_decode:
            return
        rest = []
        queue = self.pending_decode
        self.pending_decode = []      # evicted victims re-enter here
        fast = not self._kv_on
        failed_need: dict[str, float] = {}   # model -> min failed bytes
        for ready_t, req in queue:
            if ready_t > t:
                rest.append((ready_t, req))
                continue
            g = self._group_of(req)
            kp = req.kv_prefix
            need = 0.0
            preempted = False
            if kp is not None:
                # prefix affinity: the hit is only free on the owner with
                # the blocks in HBM; anything else pays a one-time stall
                # (swap-in / migration / recompute) and retries
                owner = kp[0]
                if kp[2] == "hbm" and owner.live and owner.ready(t) \
                        and not owner.draining and owner.can_admit(req):
                    d: Optional[Decoder] = owner
                else:
                    self._kv_prefix_penalty(req, t)
                    continue
            elif req.deflect_tgt is not None and req.deflect_tgt.live \
                    and not req.deflect_tgt.draining:
                # deflection affinity (Alg. 1 round 2b follow-through):
                # the prompt's KV was produced on-box, so it decodes on
                # its deflection target — rerouting through bucket-aware
                # load balancing would ship the KV to another decoder
                # without charging any transfer.  Only the paged-KV spill
                # path reaches here (non-paged deflections admit
                # unconditionally in advance_prefill); if the target
                # can't admit yet the request waits for *it*, not for
                # the pool
                tgt = req.deflect_tgt
                if tgt.ready(t) and tgt.can_admit(req):
                    d = tgt
                else:
                    rest.append((ready_t, req))
                    continue
            else:
                # target torn down or draining: rejoin the shared path
                req.deflect_tgt = None
                if fast:
                    c = g.decode.cost
                    need = (req.src.in_len + req.src.out_len) * c.kv_tok \
                        + c.state_fix
                    f = failed_need.get(g.model)
                    if f is not None and need >= f:
                        rest.append((ready_t, req))
                        continue
                cands = [x for x in g.decode_instances()
                         if x.ready(t) and not x.draining
                         and x.can_admit(req)]
                d = g.router.route_decode(req.bucket_pred, cands)
                if d is None and self.preemption.enabled:
                    n_log = len(self.preemption_log)
                    d = self._preempt_for(req, t)
                    preempted = len(self.preemption_log) > n_log
            if d is None:
                rest.append((ready_t, req))
                if fast and not preempted:
                    f = failed_need.get(g.model)
                    if f is None or need < f:
                        failed_need[g.model] = need
            else:
                if req.t_kv_ready < 0:     # keep the first KV-ready stamp
                    req.t_kv_ready = ready_t   # across preemption re-entries
                d.admit(req, t)
                self._after_admit(d, t)
            if preempted:
                # evictions can leave the host with more free memory than
                # before the pass saw it: re-arm the scan
                failed_need.pop(g.model, None)
        # merge the survivors (an ordered subsequence of the sorted pass)
        # with entries requeued during it (penalties / evicted victims,
        # already insort-ordered) — the list stays admission-ordered
        if self.pending_decode:
            rest = list(heapq.merge(rest, self.pending_decode,
                                    key=self._pending_key))
        self.pending_decode = rest

    def _kv_prefix_penalty(self, req: SimRequest, t: float):
        """The cached prefix is not immediately usable: its owner can't
        admit right now, or the copy lives in the host-DRAM tier.  Charge
        the one-time stall — swap-in at the tier's bandwidth, migration
        over the owner's interconnect, or a recompute if the copy is gone
        — then requeue; afterwards the request admits anywhere with a full
        allocation (the prefill savings already happened)."""
        owner, tokens, tier = req.kv_prefix
        st = self.kv_stats
        kv = owner.kv
        if tier == "dram":
            delay = kv.token_bytes(tokens) / max(kv.cfg.swap_bw, 1e-9)
            st.swap_stall_s += delay
        elif req.src.rid in kv.pins:
            delay = kv.migration_stall(tokens, owner.spec.chip.net_bw)
        else:                           # pin lost (owner torn down)
            g = self._group_of(req)
            delay = tokens / max(g.prefill.prof.v_prefill, 1e-9)
            st.prefix_recomputes += 1
        kv.unpin(req.src.rid)
        req.kv_prefix = None
        entry = (t + delay, req)
        self._pending_add(entry)
        self._on_requeue(entry)

    def _after_admit(self, d: Decoder, t: float):
        """Engine hook: the event engine wakes the decoder's iteration."""

    # ---- preemption (tentpole; DESIGN.md §1) -------------------------
    def _slack(self, v: SimRequest, d: Decoder, t: float) -> float:
        """Deadline slack in seconds: time until the victim's end-to-end
        SLO deadline (arrival + per-class TTFT budget + per-class TPOT
        budget x output length) minus its estimated remaining decode time
        at the decoder's current iteration rate.  Negative = already
        doomed — evicting it forfeits the least attainment."""
        deadline = v.src.t + ttft_slo(v.src.in_len, v.priority) \
            + tpot_slo(v.priority) * v.src.out_len
        remaining = max(v.src.out_len - v.generated, 0.0) * d.iter_time()
        return deadline - t - remaining

    def _victim_order(self, victims: list, d: Decoder, t: float) -> list:
        """evict-lowest/pause-requeue: lowest-class-first, least-progress-
        first (least wasted work).  evict-least-slack: lowest deadline
        slack first — the request most likely to miss its SLO anyway."""
        if self.preemption.mode == "evict-least-slack":
            return sorted(victims,
                          key=lambda v: (self._slack(v, d, t), v.src.rid))
        return sorted(victims,
                      key=lambda v: (-v.priority, v.generated,
                                     v.t_decode_start))

    def _preempt_for(self, req: SimRequest, t: float) -> Optional[Decoder]:
        """HBM backpressure: free memory for ``req`` by preempting
        strictly-lower-priority resident requests.  Returns the decoder
        that can now admit ``req``, or None if no eligible victims exist.
        Host choice: the decoder whose most-expendable victim has the
        lowest class (evict-least-slack: the lowest deadline slack);
        victims are then evicted in ``_victim_order``.  Memory estimates
        use blocks when the decoder runs the paged KV subsystem, bytes
        otherwise."""
        g = self._group_of(req)
        c = g.decode.cost
        slackful = self.preemption.mode == "evict-least-slack"
        best, best_key = None, None
        for d in g.decode_instances():
            if not d.ready(t) or d.draining:
                continue
            # fast path: the residency-class counter says whether any
            # strictly-lower-priority victim exists before scanning the
            # batch — most retries during a burst fail here
            if d.max_resident_priority() <= req.priority:
                continue
            victims = [v for v in d.active
                       if v.t_finish < 0 and v.priority > req.priority]
            if not victims:
                continue
            if d.kv is not None:
                need: float = d.kv.need_blocks(req.src.rid,
                                               d._admit_bytes(req))
                free: float = d.kv.available()
                evictable: float = sum(d.kv.owned_blocks(v.src.rid)
                                       for v in victims)
            else:
                need = (req.src.in_len + req.src.out_len) * c.kv_tok \
                    + c.state_fix
                free = d.mem_cap() - d.mem_used()
                evictable = sum((v.src.in_len + v.generated) * c.kv_tok
                                + c.state_fix for v in victims)
            if free + evictable < need:
                continue
            if slackful:
                key = (-min(self._slack(v, d, t) for v in victims),
                       free + evictable)
            else:
                key = (max(v.priority for v in victims), free + evictable)
            if best_key is None or key > best_key:
                best, best_key = d, key
        if best is None:
            return None
        victims = self._victim_order(
            [v for v in best.active
             if v.t_finish < 0 and v.priority > req.priority], best, t)
        for v in victims:
            if best.can_admit(req):
                break
            self._evict(best, v, req, t)
        return best if best.can_admit(req) else None

    def _evict(self, d: Decoder, victim: SimRequest, preemptor: SimRequest,
               t: float):
        """Remove ``victim`` from decode; it re-enters ``pending_decode``
        after its KV recomputation (evict-lowest / evict-least-slack) or
        swap (pause-requeue) delay, which is also charged to its decode
        time.  With the paged KV subsystem, pause-requeue is a *real*
        swap: owned blocks move to the host-DRAM tier (swap-out overlapped
        with the preemptor; the stall is the swap-in at the tier's
        bandwidth) and fall back to a recompute only when the tier is
        full."""
        d.remove_active(victim)
        victim.n_evictions += 1
        ctx = int(victim.src.in_len + victim.generated)
        g = self._group_of(victim)
        recompute = ctx / max(g.prefill.prof.v_prefill, 1e-9)
        if d.kv is not None:
            # KV-subsystem fidelity: a recomputation runs at the prefill
            # stage, which is exactly what's backlogged during the burst
            # that caused the backpressure — charge the least-loaded ready
            # prefiller's backlog on top of the service time.  (The legacy
            # byte-counter path below keeps the optimistic constant, which
            # the priority_preemption golden pins.)
            backlogs = [p.inflight_tokens() / max(p.prefill_velocity(), 1e-9)
                        for p in self._ready(g.prefill_instances(), t)]
            recompute += min(backlogs) if backlogs else 0.0
            if self.preemption.mode == "pause-requeue":
                kind, nbytes = d.kv.swap_out(victim.src.rid)
                if kind == "swap":
                    delay = nbytes / max(d.kv.cfg.swap_bw, 1e-9)
                    self.kv_stats.swap_stall_s += delay
                    victim.kv_swap = d.kv
                else:                      # host tier full: KV discarded
                    self.kv_stats.swap_fallbacks += 1
                    delay = recompute
            else:
                d.kv.drop(victim.src.rid)
                delay = recompute
        elif self.preemption.mode == "pause-requeue":
            # legacy counter: KV swapped over the decoder's interconnect
            delay = hw.kvc_transfer_time(g.decode.cfg, d.pool.inst, ctx)
        else:                                # KV dropped, full recompute
            delay = recompute
        victim.decode_time += delay
        if self.obs is not None:
            swapped = self.preemption.mode == "pause-requeue" and (
                d.kv is None or victim.kv_swap is not None)
            self.obs.on_preempt(victim, t, d,
                                "swap" if swapped else "recompute", delay)
        self.preemption_log.append(
            (t, victim.priority, preemptor.priority, victim.generated))
        entry = (t + delay, victim)
        self._pending_add(entry)
        self._on_requeue(entry)

    def _on_requeue(self, entry: tuple[float, SimRequest]):
        """Engine hook: the event engine schedules a retry at the victim's
        re-entry ready time."""

    # ---- chaos engine (sim.faults; DESIGN.md "Fault fidelity") --------
    def _faults_begin(self, t_end: float):
        """Draw the run's injection schedule — a pure function of the
        fault config and the horizon, from its own RNG substream.  The
        fluid engine drains it at tick granularity (``_faults_tick``);
        the event engine converts it to exact heap events
        (``_ev_fault``)."""
        if self.faults is None:
            self._fault_work = []
            return
        self._fault_work = [(ev.t, "inject", ev)
                            for ev in build_schedule(self.faults, t_end)]

    def _faults_tick(self, t: float) -> bool:
        """Fluid engine: fire every due fault work item.  Returns True
        when anything fired, so the caller refreshes its cached GPU
        count (crashes/reaps change the fleet outside ``_scale``)."""
        w = self._fault_work
        if not w or w[0][0] > t:
            return False
        while w and w[0][0] <= t:
            item = w.pop(0)
            for derived in self._fault_fire(t, item):
                insort(w, derived, key=lambda x: x[0])
        return True

    def _fault_candidates(self, role: str, t: float) -> list:
        return [i for p in self.fleet.role_pools(role)
                for i in p.instances
                if i.live and i.ready(t) and not i.draining]

    def _fault_fire(self, t: float, item: tuple) -> list[tuple]:
        """Apply one fault work item; returns derived items (window
        ends, husk reaps) for the engine to schedule.  Shared verbatim
        by both engines, so a given schedule produces the same state
        transitions — only the timing granularity differs."""
        kind = item[1]
        if kind == "inject":
            return self._fault_inject(t, item[2])
        if kind == "straggler_end":
            inst, orig_v = item[2], item[3]
            inst.perf = 1.0
            if isinstance(inst, Prefiller):
                inst.v_p = orig_v
            else:
                inst._iter_cache = None
            if self.obs is not None:
                self.obs.on_recovery(t, "straggler_end",
                                     instance=inst.iid)
            return []
        if kind == "swap_restore":
            inst, orig_cfg = item[2], item[3]
            if inst.kv is not None:
                inst.kv.cfg = orig_cfg
            if self.obs is not None:
                self.obs.on_recovery(t, "swap_restore",
                                     instance=inst.iid)
            return []
        if kind == "reap":
            return self._fault_reap(t, item[2], item[3], item[4])
        raise ValueError(f"unknown fault work item {item!r}")

    def _fault_inject(self, t: float, ev) -> list[tuple]:
        st = self.fault_stats
        if ev.kind == "link_down":
            st.link_down_windows += 1
            self._link_down_until = max(self._link_down_until, t + ev.dur)
            if self.obs is not None:
                self.obs.on_fault(t, "link_down", until=t + ev.dur)
            return []
        if ev.kind == "crash":
            inst = pick_target(ev, self._fault_candidates(ev.role, t))
            if inst is None:
                st.skipped += 1
                return []
            return self._fault_crash(t, inst, ev)
        if ev.kind == "straggler":
            inst = pick_target(ev, self._fault_candidates(ev.role, t))
            if inst is None:
                st.skipped += 1
                return []
            st.straggler_windows += 1
            orig_v = 0.0
            inst.perf = ev.factor
            if isinstance(inst, Prefiller):
                orig_v = inst.v_p
                inst.v_p *= ev.factor
            else:
                inst._iter_cache = None
            if self.obs is not None:
                self.obs.on_fault(t, "straggler", instance=inst.iid,
                                  factor=ev.factor, dur=ev.dur)
            return [(t + ev.dur, "straggler_end", inst, orig_v)]
        if ev.kind == "swap_degrade":
            cands = [d for d in self._fault_candidates("decode", t)
                     if getattr(d, "kv", None) is not None]
            inst = pick_target(ev, cands)
            if inst is None:
                st.skipped += 1
                return []
            st.swap_degrade_windows += 1
            # per-instance KVTierConfig (built by _make_allocator), so
            # swapping the frozen cfg object degrades just this box
            orig_cfg = inst.kv.cfg
            inst.kv.cfg = replace(orig_cfg,
                                  swap_bw=orig_cfg.swap_bw * ev.factor)
            if self.obs is not None:
                self.obs.on_fault(t, "swap_degrade", instance=inst.iid,
                                  factor=ev.factor, dur=ev.dur)
            return [(t + ev.dur, "swap_restore", inst, orig_cfg)]
        raise ValueError(f"unknown fault kind {ev.kind!r}")

    def _fault_crash(self, t: float, inst, ev) -> list[tuple]:
        """Instance crash: queued work is lost, on-box KV is gone, the
        box is a dead husk.  With recovery on, the health monitor
        notices at its next probe tick, the husk leaves the books and a
        warm replacement boots (``startup_s`` x jitter) — the planner's
        Eq. 2-4 view counts the lost capacity as missing supply
        immediately.  With recovery off the husk stays on the books —
        counted by the planner, billed, skipped by routing only via
        ``draining`` — the lagging-signal contrast ``--bench=chaos``
        measures."""
        st = self.fault_stats
        st.crashes += 1
        # fleet state mutates outside _scale/_report: settle billing over
        # the closing constant segment first (see _cost_advance)
        self._cost_advance(t)
        pool = inst.pool
        inst.live = False
        inst.draining = True   # _ready() filters draining, not live
        if self.obs is not None:
            self.obs.on_fault(t, "crash", instance=inst.iid,
                              pool=pool.spec.name, role=pool.spec.role)
        if isinstance(inst, Prefiller):
            # in the event engine the head's completion event is already
            # in flight; its handler sees ``not live`` and requeues the
            # head exactly once — everything else requeues here
            keep = 1 if getattr(inst, "_busy", False) else 0
            lost = inst.queue[keep:]
            del inst.queue[keep:]
            inst._inflight_cache = None
            for req, _rem in lost:
                st.prefill_requeued += 1
                self._wait_add(req)
        else:
            self._fault_crash_decoder(t, inst)
        for g in self.fleet.groups.values():
            g._decode_cache = None
            g._prefill_cache = None
        if not self.faults.recovery:
            return []
        t_detect = self._monitor.detect_at(t)
        t_ready = self._monitor.restart_at(
            t_detect, pool.inst.chip.startup_s, ev.jitter)
        return [(t_detect, "reap", pool, inst, t_ready)]

    def _fault_crash_decoder(self, t: float, d):
        """Decode-side crash teardown: purge the paged KV store (audited
        clean), restart lost prefill work from the central queue, and
        re-enter residents exactly once — with recovery on after
        detection + a re-prefill shrunk by any surviving prefix-cache
        copy; with recovery off only after the client timeout, with the
        full context recomputed."""
        st = self.fault_stats
        cfg = self.faults
        g = self.fleet.groups[d.pool.spec.model]
        victims = list(d.active)
        for r in victims:
            d.remove_active(r)
        requeue_prefill = [r for r, _ in d.prefill_q] \
            + [r for _, r in d.kv_spill]
        d.prefill_q = []
        d._pq_cache = None
        d._iter_cache = None
        d.kv_spill = []
        d.oom_pending = []        # subset of active: already pulled out
        if d.kv is not None:
            d.kv.purge()
            d.kv.check()          # a crash must leave the books clean
        # prompts whose prefill/KV died on-box restart from the central
        # queue: the KV is gone, so their pipeline genuinely re-runs
        # (kv_ready is re-stamped at the *new* transfer completion)
        for r in requeue_prefill:
            r.deflect_tgt = None
            r.t_kv_ready = -1.0
            st.prefill_requeued += 1
            self._wait_add(r)
        v_pre = max(g.prefill.prof.v_prefill, 1e-9)
        for r in victims:
            r.n_evictions += 1
            if r.kv_swap is d.kv:
                r.kv_swap = None      # ticket died with the allocator
            ctx = int(r.src.in_len + r.generated)
            if cfg.recovery:
                # self-healing re-entry: re-probe surviving decoders'
                # prefix caches (the dead box is already non-ready) so
                # the recompute only covers the uncached suffix
                r.kv_prefix = None
                r.kv_hit_tokens = 0
                hit = 0
                if self._kv_on:
                    self._kv_lookup(g, r, t)
                    hit = r.kv_hit_tokens
                delay = cfg.detect_s + max(ctx - hit, 0) / v_pre
            else:
                delay = cfg.client_timeout_s + ctx / v_pre
            r.decode_time += delay
            st.residents_requeued += 1
            entry = (t + delay, r)
            self._pending_add(entry)
            self._on_requeue(entry)

    def _fault_reap(self, t: float, pool, inst, t_ready: float
                    ) -> list[tuple]:
        """Health-monitor detection fired: the husk leaves the books and
        its warm replacement starts booting — the lost capacity shows up
        in the planner's very next observation as missing supply instead
        of waiting for queue backlog to build."""
        self._cost_advance(t)
        if inst in pool.instances:
            pool.instances.remove(inst)
        repl = self._spawn(pool, t_ready)
        pool.instances.append(repl)
        self.fault_stats.restarts += 1
        for g in self.fleet.groups.values():
            g._decode_cache = None
            g._prefill_cache = None
        if self.obs is not None:
            self.obs.on_recovery(t, "restart", instance=inst.iid,
                                 replacement=repl.iid, ready_t=t_ready,
                                 pool=pool.spec.name)
        self._after_scale(t)      # event engine schedules the wake
        return []

    def _link_wait(self, t: float) -> Optional[float]:
        """KVC transfer attempted during a link outage.  Recovery on:
        bounded retry with exponential backoff — the transfer departs at
        the first retry past the window's end; None when the ladder is
        exhausted inside the window (recompute-at-prefill fallback).
        Recovery off: the sender is blind — the transfer vanishes into
        the dead link and is retransmitted only on client timeout, so the
        wait is whole timeout multiples, not the oracle remainder."""
        cfg = self.faults
        st = self.fault_stats
        until = self._link_down_until
        if not cfg.recovery:
            wait = cfg.client_timeout_s
            while t + wait < until:
                wait += cfg.client_timeout_s
            return wait
        wait = 0.0
        for i in range(cfg.max_retries):
            st.kvc_retries += 1
            wait += cfg.backoff0_s * (2.0 ** i)
            if t + wait >= until:
                st.kvc_retry_backoff_s += wait
                return wait
        return None

    # ------------------------------------------------------------------
    def _fleet_observation(self, t: float) -> FleetObservation:
        """Per-pool snapshots + per-model gateway aggregates: what the
        metrics plane reports each interval."""
        snaps: dict[str, PoolSnapshot] = {}
        for name, pool in self.pools.items():
            insts = pool.instances
            ready = [i for i in insts if i.ready(t)]
            snap = PoolSnapshot(name, pool.spec.role, pool.spec.model,
                                count=len(insts), ready=len(ready))
            snap.idle = sum(1 for i in ready if i.idle and not i.draining)
            snap.draining = sum(1 for i in insts if i.draining)
            if self._fault_eff:
                # measured effective velocity under straggler windows —
                # surfaced only on the self-healing path so the default
                # observation stays byte-stable
                perfs = [i.perf for i in ready if not i.draining]
                if perfs:
                    snap.eff_perf = float(sum(perfs) / len(perfs))
            if pool.spec.role == "prefill":
                snap.queue_requests = sum(len(p.queue) for p in insts)
                snap.inflight_tokens = sum(p.inflight_tokens()
                                           for p in insts)
            else:
                snap.inflight = sum(len(d.active) for d in insts)
                snap.inflight_tokens = sum(d.inflight_tokens()
                                           for d in insts)
                utils = [d.mem_util() for d in ready]
                snap.mem_util = float(np.mean(utils)) if utils else 0.0
                if pool.spec.prefill_chunking > 0:
                    # chunked absorption in progress: Eq. 2 discounts it
                    snap.deflected_rate = deflected_prefill_rate(ready)
            snaps[name] = snap
        win = [(ts, r) for ts, r in self._arrivals if t - ts <= 1.0]
        gateway: dict[str, GatewayStats] = {}
        for model in self.fleet.groups:
            mwin = [r for _, r in win
                    if (r.model or self.fleet.default_model) == model]
            by_bucket: dict[str, float] = {}
            for r in mwin:
                lam = r.src.in_len + _pred_out(r)
                by_bucket[r.bucket_pred] = by_bucket.get(r.bucket_pred, 0) \
                    + lam
            queued = sum(
                1 for r in self.wait_queue
                if (r.model or self.fleet.default_model) == model)
            g = self.fleet.groups[model]
            gateway[model] = GatewayStats(
                token_rate_in=sum(r.src.in_len for r in mwin) / 1.0,
                token_rate_by_bucket=by_bucket, rps=len(mwin) / 1.0,
                queued=queued,
                # is_burst is idempotent for monotone t (the windows only
                # trim), so observing it here never perturbs the per-
                # arrival detector state the routing path reads
                burst=bool(g.router.burst.is_burst(t)))
        return FleetObservation(t=t, pools=snaps, gateway=gateway)

    def _observation(self, t: float) -> Observation:
        """Legacy flat snapshot of the default model group."""
        return flat_observation(self.fleet.default_model,
                                self._fleet_observation(t))

    def _scale(self, t: float):
        """Execute the policy's ``FleetPlan`` pool by pool, in declaration
        order.  Convertible pools are fixed (§IV-C2) outside explicit
        ``plan.spills`` and pools the plan does not target are left alone.

        Scale-down: pools named in ``plan.drain`` drain — victims are
        marked ``draining`` (no new work, residents finish, billed until
        removal) and reaped once idle — while legacy plans keep the
        historical idle-only immediate eviction byte-for-byte.  Both
        respect the pool's ``min`` floor."""
        obs = self._fleet_observation(t)
        plan = self.policy.plan(obs)
        if self.obs is not None:
            # decision log: observation + plan + the policy's Eq. 2-4
            # intermediates, before execution mutates the fleet
            self.obs.on_plan(t, obs, plan, self.policy.last_debug)
        # fleet membership changes only below: settle the cost integral
        # over the closing constant segment first
        self._cost_advance(t)
        for name, pool in self.pools.items():
            if pool.spec.role == "convertible" or name not in plan.targets:
                continue
            startup = 0.0 if name in plan.live \
                else pool.inst.chip.startup_s
            want = min(plan.targets[name], self.max_instances)
            if name in plan.drain:
                self._scale_drain(pool, want, t, startup)
                continue
            while len(pool.instances) < want:
                pool.instances.append(self._spawn(pool, t + startup))
            while len(pool.instances) > max(want, pool.spec.min):
                idle = [i for i in pool.instances if i.idle]
                if not idle:
                    break
                idle[-1].live = False
                pool.instances.remove(idle[-1])
        for src, dst, n in plan.spills:
            self._execute_spill(src, dst, n, t)
        for g in self.fleet.groups.values():
            g._decode_cache = None
            g._prefill_cache = None
        self._after_scale(t)

    def _scale_drain(self, pool: Pool, want: int, t: float, startup: float):
        """Drain-based resize: reap drained-and-idle victims, then close
        the gap to ``want`` counting only *active* (non-draining)
        instances — scale-up cancels drains first (instant capacity, the
        box never left), scale-down marks the idlest actives draining."""
        for i in [x for x in pool.instances if x.draining and x.idle]:
            i.live = False
            pool.instances.remove(i)
        active = [i for i in pool.instances if not i.draining]
        want = max(want, pool.spec.min)
        if len(active) < want:
            for i in pool.instances:
                if i.draining:
                    i.draining = False
                    active.append(i)
                    if len(active) >= want:
                        break
            while len(active) < want:
                i = self._spawn(pool, t + startup)
                pool.instances.append(i)
                active.append(i)
        elif len(active) > want:
            # idle victims first (they reap on the next pass); busy ones
            # keep iterating — and billing — until their residents finish
            excess = len(active) - want
            victims = [i for i in reversed(active) if i.idle][:excess]
            if len(victims) < excess:
                busy = [i for i in reversed(active) if not i.idle]
                victims += busy[:excess - len(victims)]
            for i in victims:
                i.draining = True
                if self.obs is not None:
                    self.obs.on_drain(t, pool.spec.name, i)

    def _execute_spill(self, src: str, dst: str, n: int, t: float):
        """Move up to ``n`` idle instances from convertible pool ``src``
        to ``dst`` (cross-model loan/return): the box is re-imaged with
        the destination model's weights, so it leaves immediately and
        joins the destination pool after its chip's startup latency."""
        sp, dp = self.pools.get(src), self.pools.get(dst)
        if sp is None or dp is None or n <= 0:
            return
        movable = [i for i in sp.instances
                   if i.ready(t) and i.idle and not i.draining]
        moved = movable[:n]
        for i in moved:
            i.live = False
            sp.instances.remove(i)
            dp.instances.append(self._spawn(dp, t + dp.inst.chip.startup_s))
        if moved and self.obs is not None:
            self.obs.on_spill(t, src, dst, len(moved))

    def _cost_advance(self, t: float):
        """Advance the dollar-billing integral to ``t``.  Exact because
        fleet membership only changes inside ``_scale`` (which settles
        the closing segment before touching any pool), ``_report`` (the
        final segment), and the chaos engine's crash/reap transitions
        (``_fault_crash``/``_fault_reap``, which likewise settle before
        mutating): between those points the per-pool cost rate is
        constant, so one multiply per pool per scale interval replaces
        any per-tick/per-event accumulation."""
        dt = t - self._cost_t0
        if dt > 0.0:
            pc = self.pool_cost
            total = 0.0
            for name, pool in self.pools.items():
                rate = sum(i.spec.cost_rate for i in pool.instances)
                if rate > 0.0:
                    c = rate * dt
                    pc[name] += c
                    total += c
            self.cost_dollars += total
        self._cost_t0 = t

    def _after_scale(self, t: float):
        """Engine hook: schedule wake-ups for newly provisioned instances."""

    def _snapshot_every(self, t_end: float) -> float:
        """Timeline snapshot cadence: the explicit ``snapshot_interval``
        knob, else the historical 0.2 s stretched so a run never records
        more than ~4000 rows (multi-hour traces previously grew the
        timeline unboundedly)."""
        si = self.snapshot_interval
        if si is None:
            si = max(0.2, t_end / 4000.0)
        return si

    # ------------------------------------------------------------------
    def _gpu_count(self, t: float) -> int:
        """Billing: every *provisioned* instance — booting or ready — burns
        GPUs; instances removed by scale-down stop billing because they
        leave their pool."""
        del t
        return sum(i.spec.gpus for pool in self.pools.values()
                   for i in pool.instances)

    def _unfinished(self):
        out = []
        for d in self.decoders + self.convertibles:
            out += d.active
            out += [r for r, _ in d.prefill_q]
            out += [r for _, r in d.kv_spill]
        for p in self.prefillers:
            out += [r for r, _ in p.queue]
        out += [r for _, r in self.pending_decode]
        out += self.wait_queue
        return out

    def _snapshot(self, t: float) -> dict:
        prefillers, decoders = self.prefillers, self.decoders
        snap = {
            "t": t,
            "prefillers": len(prefillers),
            "decoders": len(decoders),
            "convertibles": len(self.convertibles),
            "queue": sum(len(p.queue) for p in prefillers),
            "inflight": sum(len(d.active)
                            for d in decoders + self.convertibles),
            "mem_util": float(np.mean([d.mem_util() for d in decoders]))
            if decoders else 0.0,
            "pools": {name: len(pool.instances)
                      for name, pool in self.pools.items()},
        }
        if self.obs is not None:
            # samples the metrics registry on the timeline cadence and
            # adds one additive "obs" key (velocities, occupancy, cost
            # rate) — the stock keys above never change
            self.obs.on_snapshot(snap, self)
        return snap

    def _report(self, t_end: float) -> SimReport:
        self._cost_advance(t_end)      # settle the final billing segment
        requests = self.finished + self._unfinished()
        if self.obs is not None:
            self.obs.finalize(requests, t_end)
        return SimReport(self.policy.name, requests,
                         self.gpu_seconds, t_end, self.timeline,
                         engine=self.engine,
                         preemptions=list(self.preemption_log),
                         kv=self.kv_stats.summary() if self._kv_on else {},
                         gw=self.gw_stats.summary() if self._gw_on else {},
                         faults=self.fault_stats.summary()
                         if self.faults is not None else {},
                         n_events=getattr(self, "n_events", 0),
                         n_deflected=self.n_deflected,
                         cost_dollars=self.cost_dollars,
                         pool_cost=dict(self.pool_cost),
                         obs=self.obs)


def _pred_out(req: SimRequest) -> int:
    return BUCKET_OUTPUT[req.bucket_pred.split("-")[1]]
