"""Routing & load balancing (§IV-E) + the burst detector (§IV-A).

Alg. 1 (prefill): two rounds — regular prefillers first, Convertible
Decoders second, else queue.  Feasibility = estimated waiting time
(in-flight tokens / stage velocity) within the request's TTFT SLO.

Decode: predict the request's bucket, route to the decoder with the fewest
in-flight requests *of that bucket*; Convertible Decoders are excluded once
their memory utilization crosses a threshold, and prioritize decode over
prefill on-box.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Protocol


#: request priority classes (lower value = more urgent).  Interactive and
#: standard traffic share the paper's SLO targets; batch traffic tolerates
#: a relaxed multiple of them (mixed-criticality serving, DynaServe-style).
PRIORITY_INTERACTIVE = 0
PRIORITY_STANDARD = 1
PRIORITY_BATCH = 2
PRIORITY_TTFT_SCALE = {PRIORITY_INTERACTIVE: 1.0, PRIORITY_STANDARD: 1.0,
                       PRIORITY_BATCH: 4.0}
PRIORITY_TPOT_SCALE = {PRIORITY_INTERACTIVE: 1.0, PRIORITY_STANDARD: 1.0,
                       PRIORITY_BATCH: 4.0}


def ttft_slo(in_len: int, priority: int = PRIORITY_STANDARD) -> float:
    """SLO standards from §V (DynamoLLM/MLPerf): 250/400/2000 ms, scaled
    per priority class."""
    if in_len < 256:
        base = 0.25
    elif in_len < 1024:
        base = 0.40
    else:
        base = 2.0
    return base * PRIORITY_TTFT_SCALE.get(priority, 1.0)


TPOT_SLO = 0.1


def tpot_slo(priority: int = PRIORITY_STANDARD) -> float:
    return TPOT_SLO * PRIORITY_TPOT_SCALE.get(priority, 1.0)


class PrefillTarget(Protocol):
    def inflight_tokens(self) -> float: ...
    def prefill_velocity(self) -> float: ...


@dataclass
class BurstDetector:
    """Short-window rate vs long-window running average (§II-C methodology:
    spikes above the running average are bursts).

    Both windows are maintained *incrementally* over deques: ``observe``
    and ``rates`` are O(1) amortized instead of rebuilding/re-summing the
    long window per arrival (which made the gateway O(window) per request
    — the first quadratic wall on million-request traces).  The running
    sums stay bit-for-bit equal to the historical from-scratch reductions
    because observed token counts are integers (prompt lengths): every
    partial sum is an exactly-representable integer, so float addition
    and subtraction are exact and order-independent here."""
    short_s: float = 1.0
    long_s: float = 60.0
    factor: float = 1.5
    min_events: int = 3        # no "burst" before any baseline exists
    _events: deque = field(default_factory=deque)
    _short: deque = field(default_factory=deque)
    _long_sum: float = 0.0
    _short_sum: float = 0.0

    def observe(self, t: float, tokens: float):
        e = (t, tokens)
        self._events.append(e)
        self._long_sum += tokens
        self._short.append(e)
        self._short_sum += tokens
        events = self._events
        while events and t - events[0][0] > self.long_s:
            self._long_sum -= events.popleft()[1]
        self._trim_short(t)

    def _short_h(self, t: float) -> float:
        # the short window never covers more than half the observed
        # horizon, so the short/long comparison always measures a rate
        # *contrast*: with both windows over the same elapsed interval the
        # ratio would be a pure normalization artifact (always-burst before
        # the fix's symmetric-elapsed variant, never-burst under the
        # original per-window normalization)
        return min(self.short_s, max(t / 2.0, 1e-3))

    def _trim_short(self, t: float):
        # t - _short_h(t) is non-decreasing in t, so the short window's
        # left edge only ever moves right — expiry is monotone
        h = self._short_h(t)
        short = self._short
        while short and t - short[0][0] > h:
            self._short_sum -= short.popleft()[1]

    def rates(self, t: float) -> tuple[float, float]:
        """Both windows are normalized over their *observed* horizon, so an
        opening spike (t < short_s) is detectable against the brief
        baseline that preceded it; past 2x short_s this reduces to the
        nominal short_s/elapsed normalization."""
        self._trim_short(t)
        short = self._short_sum / self._short_h(t)
        long_h = min(self.long_s, max(t, 1e-3))
        long = self._long_sum / long_h
        return short, long

    def is_burst(self, t: float) -> bool:
        # a burst is a spike *above a baseline*: until a few observations
        # exist the ratio is a one-sample artifact, never a burst signal.
        # The count guard is on total history, not the short window — a
        # single huge request against an established baseline IS a burst
        # (the paper's few-requests/many-tokens case, Fig. 6 T2)
        if len(self._events) < self.min_events:
            return False
        short, long = self.rates(t)
        return short > self.factor * max(long, 1e-9)


def _decode_capacity(d, bucket: str) -> float:
    """SLO-feasible batch for ``bucket`` on this decoder's chip, from its
    pool's velocity profile (``VelocityProfile.max_batch``).  Bare
    decoders (unit tests, no pool backref) report 1.0 — with every
    candidate equal the capacity never matters."""
    prof = getattr(getattr(d, "pool", None), "prof", None)
    if prof is None:
        return 1.0
    mb = prof.max_batch
    return float(mb.get(bucket) or max(mb.values(), default=1) or 1)


def _by_velocity(targets: list) -> list:
    """Candidates in descending prefill-velocity order.  ``sorted`` is
    stable, so a homogeneous pool (all velocities equal) keeps its
    original order — single-pool routing is unchanged.  That common case
    is detected up front and skips the sort (and its key tuples)
    entirely: a stable sort on all-equal keys is the identity."""
    if len(targets) < 2:
        return targets
    v0 = targets[0].prefill_velocity()
    if all(x.prefill_velocity() == v0 for x in targets[1:]):
        return targets
    return sorted(targets, key=lambda x: -x.prefill_velocity())


class Router:
    """Alg. 1 + decode load balancing."""

    def __init__(self, burst_detector: Optional[BurstDetector] = None):
        self.burst = burst_detector or BurstDetector()
        # flight-recorder tap (repro_torch.obs): when set, every route_prefill
        # outcome is reported as hook(t, kind, target, in_len, priority,
        # slo).  None (the default) keeps the hot path decision-free
        # beyond one attribute test — telemetry-off runs are byte- and
        # order-identical.
        self.trace_hook = None

    # ---- Alg. 1 ------------------------------------------------------
    def route_prefill(self, in_len: int, prefillers: list,
                      convertibles: list, now: float,
                      priority: int = PRIORITY_STANDARD,
                      deflectables: list = ()):
        """Returns (target, kind) with kind in {"prefiller", "convertible",
        "deflect", None}; None means queue (line 15).  Feasibility is
        judged against the request's per-class TTFT SLO, so batch traffic
        accepts busier targets instead of competing for the rapid-response
        path.

        Heterogeneous fleets: candidates may span pools of differing
        prefill velocity (mixed chips/TP).  Feasibility is per-target —
        estimated wait = that instance's in-flight tokens / *its own*
        velocity — and each round scans faster targets first (a stable
        sort, so homogeneous fleets keep the historical first-feasible
        order byte-for-byte).

        ``deflectables`` (round 2b, chunked-prefill pools only): regular
        decoders whose iterations can co-schedule prompt chunks.  Reached
        only when the prefill queue already threatens the per-class TTFT
        SLO (rounds 1-2 failed); the decision weighs that queue delay
        against each decoder's mixed-iteration slack — its Eq. 5 headroom
        expressed as an absorption velocity — and deflects to the decoder
        that finishes the prompt soonest, provided that still lands within
        the SLO.  Decoders with no TPOT headroom advertise zero velocity
        and are never chosen, so deflection cannot form on an overloaded
        decode pool."""
        out = self._route_prefill(in_len, prefillers, convertibles,
                                  priority, deflectables)
        hook = self.trace_hook
        if hook is not None:
            hook(now, out[1], out[0], in_len, priority,
                 ttft_slo(in_len, priority))
        return out

    def _route_prefill(self, in_len: int, prefillers: list,
                       convertibles: list, priority: int,
                       deflectables: list = ()):
        slo = ttft_slo(in_len, priority)
        for p in _by_velocity(prefillers):        # round 1 (lines 1-7)
            wait = p.inflight_tokens() / max(p.prefill_velocity(), 1e-9)
            if wait <= slo:
                return p, "prefiller"
        for d in _by_velocity(convertibles):      # round 2 (lines 8-14)
            wait = d.inflight_tokens() / max(d.prefill_velocity(), 1e-9)
            if wait <= slo:
                return d, "convertible"
        if deflectables:                          # round 2b: deflection
            best, best_eta = None, float("inf")
            for d in deflectables:
                v = d.deflect_velocity()
                if v <= 0.0:
                    continue
                eta = (d.inflight_tokens() + in_len) / v
                if eta < best_eta:
                    best, best_eta = d, eta
            if best is not None and best_eta <= slo:
                return best, "deflect"
        return None, None                         # line 15: enqueue

    # ---- decode load balancing ----------------------------------------
    def route_decode(self, bucket: str, decoders: list,
                     mem_threshold: float = 0.9):
        """Fewest in-flight requests of `bucket`; convertibles excluded
        above the memory threshold.

        Candidates spanning heterogeneous decode pools (same-role pool
        sets on mixed chips) are balanced by *share of capacity* —
        in-flight count over the pool profile's SLO-feasible batch for
        the bucket — so a small-batch chip (l40s) is not loaded to the
        same absolute residency as an h100.  The capacity divide is
        applied only when the candidates' capacities actually differ:
        with all capacities equal it is a constant positive rescaling of
        the integer count (order-preserving, no float collapse at sim
        batch sizes), so homogeneous fleets keep the historical key
        byte-for-byte — the same guarded-specialization idiom as
        ``_by_velocity``."""
        candidates = [d for d in decoders
                      if not (getattr(d, "is_convertible", False)
                              and d.mem_util() > mem_threshold)]
        if not candidates:
            candidates = decoders
        if not candidates:
            return None
        caps = [_decode_capacity(d, bucket) for d in candidates]
        if any(c != caps[0] for c in caps[1:]):
            return min(zip(candidates, caps),
                       key=lambda dc: (dc[0].inflight_of_bucket(bucket)
                                       / max(dc[1], 1.0),
                                       dc[0].mem_util()))[0]
        return min(candidates,
                   key=lambda d: (d.inflight_of_bucket(bucket),
                                  d.mem_util()))
