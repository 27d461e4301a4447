"""Time-stepped (fluid) PD-disaggregated cluster simulator.

This is the stand-in for the paper's 4/16-node GPU clusters: instances are
modeled with the same analytic roofline step-latency model the offline
profiler uses (``core.hardware``), and the control plane under test is the
*real* TokenScale implementation (``core.*``) — policies, router, burst
detector, convertible planning all execute unmodified.

Fidelity choices (documented in DESIGN.md):
  * dt-stepped fluid model (default 25 ms) rather than per-iteration events
    (for faithful per-request tails use ``sim.events.EventCluster``, which
    drives the same instances/control plane with a discrete-event heap);
  * decoders process all resident requests at the batch's iteration time;
  * prefillers serialize requests (batch ~1, §II-C1);
  * KVC transfer delays from interconnect bandwidth;
  * instance startup latency hidden for BlitzScale scale-ups ("ideal live
    autoscaling", §V Baselines).

The instance/roofline/metrics layer shared with the event engine lives in
``sim.instances``, which also holds the pool layer: the ``prefillers``/
``decoders``/``convertibles`` views this loop iterates flatten the
fleet's named pools, so the same tick loop drives heterogeneous
(mixed-chip/TP) and multi-model fleets — per-pool scaling happens in the
shared ``ClusterBase._scale`` executing the policy's ``FleetPlan``.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.sim.instances import (  # noqa: F401  (re-exported for compat)
    ClusterBase, Decoder, Instance, ModelCost, Prefiller, SimReport,
    SimRequest, _ModelCost, _pred_out)
from repro_torch.sim.traces import TraceRequest


class Cluster(ClusterBase):
    """Fluid engine: advances the whole cluster in fixed dt steps, smearing
    queueing and batching across ticks."""

    engine = "fluid"

    def run(self, trace: list[TraceRequest],
            duration: Optional[float] = None) -> SimReport:
        trace = sorted(trace, key=lambda r: r.t)
        t_end = duration or (trace[-1].t + 60.0 if trace else 60.0)
        ti = 0
        t = 0.0
        tick = 0        # exact tick index; float-accumulated t drifts, so
                        # deriving the index as int(t / dt) skips or
                        # duplicates snapshot rows on long traces
        next_scale = 0.0
        # snapshot cadence (0.2 s historically; adaptive past ~13 min so
        # multi-hour traces cap the timeline length — DESIGN.md §Perf)
        snap_mod = max(int(self._snapshot_every(t_end) / self.dt), 1)
        # the fleet only changes inside _scale, so the per-tick GPU count
        # is a cached constant between scale executions
        gpus = self._gpu_count(t)
        if self.obs is not None:
            # trace consumers need the tick granularity to interpret
            # fluid timestamps: arrivals are batched and completions
            # quantized to dt, unlike the event engine's exact stamps
            self.obs.meta.setdefault("dt", self.dt)
            self.obs.meta.setdefault("duration", t_end)
        self._faults_begin(t_end)
        while t < t_end:
            # ---- chaos engine: due fault injections, tick granularity
            # (the event engine schedules them as exact events) ----
            if self._faults_tick(t):
                gpus = self._gpu_count(t)
            # ---- arrivals ----
            while ti < len(trace) and trace[ti].t <= t:
                self._on_arrival(SimRequest(trace[ti]), t)
                ti += 1
            # ---- stage ticks ----
            for pool in self.fleet.role_pools("prefill"):
                for p in pool.instances:
                    for req in p.tick(t, self.dt):
                        self._to_network(req, t, pool)
            for role in ("decode", "convertible"):
                for pool in self.fleet.role_pools(role):
                    for d in pool.instances:
                        self.finished += d.tick(t, self.dt)
            # ---- network -> decoder admission ----
            # (priority-ordered; under HBM backpressure this is also where
            # the fluid approximation of preemption fires: victims leave
            # decode between ticks and re-enter pending_decode after their
            # recompute/swap-in delay.  KV-tier swap completions and
            # prefix-penalty stalls are likewise approximated here at tick
            # granularity — the event engine schedules them as exact
            # swap_done events; DESIGN.md "KV-tier fidelity")
            self._admit_pending(t)
            # ---- retry queued prefills (§IV-E re-evaluation) ----
            self._drain_wait_queue(t)
            # ---- autoscaling ----
            if t >= next_scale:
                self._scale(t)
                next_scale = t + self.scale_interval
                gpus = self._gpu_count(t)
            # ---- accounting ----
            self.gpu_seconds += gpus * self.dt
            if tick % snap_mod == 0:
                self.timeline.append(self._snapshot(t))
            tick += 1
            t += self.dt
        return self._report(t_end)
