"""Flight recorder: per-request spans, point events, scaling decisions.

One ``FlightRecorder`` instance is attached to a cluster engine via
``ClusterBase.attach_obs`` when ``ExperimentSpec.telemetry`` is on.  Every
engine-side hook is guarded by ``self.obs is not None`` so the default-off
path costs a single attribute test and never touches RNG, float math, or
event ordering — goldens stay byte-identical by construction.

The recorder is a pure *observer*: it reads simulation state (timestamps
already stamped on ``SimRequest``, plans already produced by the policy)
and never feeds anything back into the engines.

Span model
----------
A request's life is covered by a gap-free chain of spans derived from the
timestamps the engines already maintain:

    queue_wait    arrival          -> prefill start
    prefill       prefill start    -> prefill end (chunk boundaries are
                                      point events, exact on the event
                                      engine)
    kvc_transfer  prefill end      -> KV ready on the decode side
                                      (zero-width for on-box prefill)
    decode_wait   KV ready         -> decode admission
    decode_first  decode admission -> first token
    decode_rest   first token      -> done

Adjacent spans share a boundary timestamp, so for every finished request
the span durations sum *exactly* (same floats, no re-derivation) to its
recorded TTFT (first five spans) and E2E (all six) — the conservation
property pinned by ``tests/test_obs.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from .metrics import MetricsRegistry

#: span names in lifecycle order; the first five sum to TTFT.
SPAN_ORDER = ("queue_wait", "prefill", "kvc_transfer",
              "decode_wait", "decode_first", "decode_rest")

#: spans that can dominate a TTFT violation, mapped to the attribution
#: label the explainer reports (§ queueing vs prefill vs transfer vs
#: decode backpressure).
TTFT_STAGE_LABELS = {
    "queue_wait": "queueing",
    "prefill": "prefill",
    "kvc_transfer": "transfer",
    "decode_wait": "decode-backpressure",
    "decode_first": "decode",
}


def jsonable(obj):
    """Best-effort conversion of recorder payloads to strict-JSON values:
    dataclasses -> dicts, sets/tuples -> sorted/ordinary lists, non-finite
    floats -> None, non-string dict keys -> str."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return jsonable(dataclasses.asdict(obj))
    if isinstance(obj, dict):
        return {str(k): jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    if isinstance(obj, (set, frozenset)):
        return sorted(str(v) for v in obj)
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, (int, str, bool)) or obj is None:
        return obj
    return str(obj)


def request_spans(req) -> list[dict]:
    """Build the span chain for one ``SimRequest`` from its timestamps.
    Unreached stages (-1 sentinels) truncate the chain, so in-flight
    requests yield a valid prefix instead of negative-duration garbage."""
    marks = (("queue_wait", req.src.t, req.t_prefill_start),
             ("prefill", req.t_prefill_start, req.t_prefill_end),
             ("kvc_transfer", req.t_prefill_end, req.t_kv_ready),
             ("decode_wait", req.t_kv_ready, req.t_decode_start),
             ("decode_first", req.t_decode_start, req.t_first_token),
             ("decode_rest", req.t_first_token, req.t_finish))
    spans = []
    for name, a, b in marks:
        if a < 0 or b < 0:
            break
        spans.append({"name": name, "t0": a, "t1": b, "dur": b - a})
    return spans


class FlightRecorder:
    """Collects spans, point events, metrics samples, and scaling
    decisions for one engine run.  See module docstring for the span
    model; ``obs.export`` turns the collected state into JSONL and
    Chrome-trace JSON."""

    def __init__(self, meta: Optional[dict] = None):
        self.meta: dict = dict(meta or {})
        self.engine: str = ""
        self.t_end: float = 0.0
        self.metrics = MetricsRegistry()
        self.requests: list[dict] = []    # finished-request records
        self.events: list[dict] = []      # point events (preempt/oom/...)
        self.decisions: list[dict] = []   # FleetPlan + Eq. 2-4 inputs
        # per-rid routing annotations (arrival decision + requeues)
        self.routes: dict[int, list[dict]] = {}
        # hot-path token odometers (mirrored into the registry on sample)
        self.prefill_tokens_done = 0.0    # prompt tokens fully prefilled
        self.decode_tokens_done = 0.0     # decode tokens granted
        # previous-sample state for rate derivation
        self._last_sample_t: Optional[float] = None
        self._last_prefill = 0.0
        self._last_decode = 0.0
        self._last_cost = 0.0

    # ------------------------------------------------------------------
    # request lifecycle hooks (called from ClusterBase, obs-guarded)
    # ------------------------------------------------------------------
    def on_arrival(self, req, t: float, burst: bool = False):
        self.metrics.inc("arrivals")
        if burst:
            self.metrics.inc("burst_arrivals")
        self.routes[req.src.rid] = [{"t": t, "step": "arrival",
                                     "burst": burst}]

    def on_routed(self, req, t: float, kind: Optional[str], target):
        """One routing decision for ``req``: ``kind`` is the Alg. 1 round
        that won ("prefiller"/"convertible"/"deflect") or "queue" when no
        capacity was found and the request joined the wait queue."""
        kind = kind or "queue"
        steps = self.routes.setdefault(req.src.rid, [])
        steps.append({"t": t, "step": "route", "kind": kind,
                      "target": getattr(target, "iid", None)})
        self.metrics.inc("route_" + kind)

    def on_transfer(self, req, t: float, delay: float):
        self.metrics.inc("kvc_transfers")
        self.metrics.inc("kvc_transfer_s", delay)

    def on_preempt(self, req, t: float, decoder, mode: str,
                   delay: float = 0.0):
        """A resident was evicted: ``mode`` is "swap" (DRAM ticket held,
        restore pays swap-in) or "recompute" (KV dropped)."""
        self.event(t, "preempt", rid=req.src.rid, priority=req.priority,
                   decoder=getattr(decoder, "iid", None), mode=mode,
                   delay=delay)
        self.metrics.inc("preemptions")
        if mode == "swap":
            self.metrics.inc("swap_outs")

    def on_oom(self, req, t: float, decoder):
        self.event(t, "oom", rid=req.src.rid,
                   decoder=getattr(decoder, "iid", None))
        self.metrics.inc("oom_preemptions")

    def on_deflect(self, req, t: float, target):
        self.event(t, "deflect", rid=req.src.rid,
                   target=getattr(target, "iid", None))
        self.metrics.inc("deflections")

    def on_chunk(self, t: float, decoder, tokens: float):
        """One chunked-prefill iteration boundary on a decode box (exact
        on the event engine; the fluid engine reports per-tick totals)."""
        self.event(t, "chunk", decoder=getattr(decoder, "iid", None),
                   tokens=tokens)

    def on_replication(self, t: float, kind: str, **fields):
        """Gateway replication lifecycle: kind is "planned" / "dispatch"
        / "done"."""
        self.event(t, "replication_" + kind, **fields)
        self.metrics.inc("replication_" + kind)

    def on_drain(self, t: float, pool: str, instance):
        self.event(t, "drain", pool=pool,
                   instance=getattr(instance, "iid", None))
        self.metrics.inc("drains")

    def on_spill(self, t: float, src: str, dst: str, n: int):
        self.event(t, "spill", src=src, dst=dst, n=n)
        self.metrics.inc("spills", n)

    def on_fault(self, t: float, kind: str, **fields):
        """One chaos-engine injection (sim.faults): kind is "crash" /
        "straggler" / "swap_degrade" / "link_down" / "kvc_fallback"."""
        self.event(t, "fault_" + kind, **fields)
        self.metrics.inc("fault_" + kind)

    def on_recovery(self, t: float, kind: str, **fields):
        """One self-healing action: kind is "restart" (husk reaped, warm
        replacement provisioned) / "straggler_end" / "swap_restore"."""
        self.event(t, "recovery_" + kind, **fields)
        self.metrics.inc("recovery_" + kind)

    def event(self, t: float, kind: str, **fields):
        """Generic point event."""
        rec = {"type": "event", "t": t, "kind": kind}
        rec.update(fields)
        self.events.append(rec)

    # ------------------------------------------------------------------
    # scaling decisions (the explainer's raw material)
    # ------------------------------------------------------------------
    def on_plan(self, t: float, obs, plan, debug: Optional[dict]):
        """Record one planner interval: the full ``FleetObservation``
        (per-pool snapshots + per-model gateway windows), the resulting
        ``FleetPlan``, and the policy's ``last_debug`` Eq. 2-4
        intermediates (rates, effective velocities, cost ranking,
        convertible absorption)."""
        self.decisions.append({
            "type": "decision", "t": t,
            "observation": jsonable(obs),
            "plan": jsonable(plan),
            "inputs": jsonable(debug) if debug is not None else {},
        })
        self.metrics.inc("plans")

    # ------------------------------------------------------------------
    # timeline sampling (piggybacks on ClusterBase._snapshot)
    # ------------------------------------------------------------------
    def on_snapshot(self, snap: dict, cluster) -> dict:
        """Sample the registry on the engines' snapshot cadence and add
        the per-stage velocity / occupancy / cost-rate block to the
        timeline row under a single additive ``"obs"`` key."""
        t = snap["t"]
        m = self.metrics
        m.set("queue_depth", snap.get("queue", 0))
        m.set("inflight", snap.get("inflight", 0))
        m.set("mem_util", snap.get("mem_util", 0.0))
        m.set("deflected_total", getattr(cluster, "n_deflected", 0))
        draining = sum(1 for pool in cluster.pools.values()
                       for i in pool.instances if i.draining)
        m.set("draining", draining)
        cost = getattr(cluster, "cost_dollars", 0.0)
        prefill_rate = decode_rate = cost_rate = 0.0
        if self._last_sample_t is not None and t > self._last_sample_t:
            dt = t - self._last_sample_t
            prefill_rate = (self.prefill_tokens_done
                            - self._last_prefill) / dt
            decode_rate = (self.decode_tokens_done - self._last_decode) / dt
            cost_rate = (cost - self._last_cost) / dt * 3600.0
        self._last_sample_t = t
        self._last_prefill = self.prefill_tokens_done
        self._last_decode = self.decode_tokens_done
        self._last_cost = cost
        m.set("prefill_tok_rate", prefill_rate)
        m.set("decode_tok_rate", decode_rate)
        m.set("cost_rate_per_hour", cost_rate)
        m.counter("prefill_tokens").value = self.prefill_tokens_done
        m.counter("decode_tokens").value = self.decode_tokens_done
        row = m.sample(t)
        # additive: the stock snapshot keys are untouched; telemetry-on
        # runs gain exactly one new key
        snap["obs"] = {k: v for k, v in row.items() if k != "t"}
        return snap

    # ------------------------------------------------------------------
    # router / gateway hook factories
    # ------------------------------------------------------------------
    def router_hook(self, model: str):
        """Build the ``Router.trace_hook`` callable for one model group:
        aggregate routing-outcome counters + SLO-budget histogram."""
        def hook(t, kind, target, in_len, priority, slo):
            self.metrics.inc("route_eval_" + (kind or "queue"))
            self.metrics.observe("route_slo_budget", slo)
        return hook

    def gateway_hook(self, model: str):
        """Build the ``Gateway.trace_hook`` callable: replication-plan
        point events tagged with the owning model group."""
        def hook(t, kind, **fields):
            self.on_replication(t, kind, model=model, **fields)
        return hook

    # ------------------------------------------------------------------
    # finalization
    # ------------------------------------------------------------------
    def request_record(self, req, ttft_slo_fn=None) -> dict:
        spans = request_spans(req)
        rec = {
            "type": "request",
            "rid": req.src.rid,
            "model": req.model,
            "priority": req.priority,
            "t_arrival": req.src.t,
            "in_len": req.src.in_len,
            "out_len": req.src.out_len,
            "generated": req.generated,
            "kv_hit_tokens": req.kv_hit_tokens,
            "n_evictions": req.n_evictions,
            "deflected": req.deflect_tgt is not None,
            "finished": req.t_finish >= 0,
            "ttft": req.ttft if req.t_first_token >= 0 else None,
            "tpot": req.tpot,
            "e2e": (req.t_finish - req.src.t) if req.t_finish >= 0 else None,
            "route": self.routes.get(req.src.rid, []),
            "spans": spans,
        }
        if ttft_slo_fn is not None:
            rec["ttft_slo"] = ttft_slo_fn(req.src.in_len, req.priority)
        return rec

    def finalize(self, requests, t_end: float):
        """Emit one record per finished request and the final registry
        sample.  Called once from ``ClusterBase._report``."""
        from repro_torch.core.router import ttft_slo
        self.t_end = t_end
        for req in requests:
            self.requests.append(self.request_record(req, ttft_slo))
            if req.t_first_token >= 0:
                self.metrics.observe("ttft", req.ttft)
            for s in request_spans(req):
                self.metrics.observe("span_" + s["name"], s["dur"])
        self.metrics.counter("prefill_tokens").value = \
            self.prefill_tokens_done
        self.metrics.counter("decode_tokens").value = self.decode_tokens_done
