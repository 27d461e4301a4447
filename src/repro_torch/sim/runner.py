"""Experiment runner: execute a declarative ``ExperimentSpec`` (fleet +
trace routing + policy + engine + preemption) end-to-end, the way §V
configures its experiments.

``run_spec`` is the single entry point: it resolves the spec's pools into
runtime ``Fleet`` objects (velocity profile per (model, chip, tp) pool,
Eq. 5-6 convertible plan per convertible pool), generates one trace per
model route, builds the policy per model group through the string-keyed
registry (``core.autoscaler.build_policy``), and drives either engine.
Heterogeneous fleets (mixed chips/TP across pools) and multi-model
serving are just specs; the legacy single-pool helpers ``run_policy`` /
``make_policy`` survive as thin shims over one-pool specs and remain
byte-stable with the pre-pool control plane (the golden fixtures enforce
this).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs import get_config
from repro_torch.core import (CHIPS, ExperimentSpec, InstanceSpec, OutputPredictor,
                        PerModelFleetPolicy, build_policy,
                        default_convertible_plan, profile_for,
                        single_pool_fleet)
from repro_torch.core.fleet import (FLEET_POLICY_REGISTRY, FleetSpec, PoolSpec,
                              TraceRoute, build_fleet_policy)
from repro_torch.core.velocity import VelocityProfile
from repro_torch.sim.cluster import Cluster, SimReport
from repro_torch.sim.events import EventCluster
from repro_torch.sim.instances import Fleet, Pool
from repro_torch.sim.traces import TraceRequest, get_trace, trace_stats

#: engine name -> cluster class; both drive the identical control plane.
ENGINES = {"fluid": Cluster, "events": EventCluster}

#: seed decorrelation between a spec's model routes (route 0 keeps the
#: spec seed verbatim so one-route specs reproduce legacy traces exactly)
_ROUTE_SEED_STRIDE = 7919


def get_engine(name: str):
    try:
        return ENGINES[name]
    except KeyError:
        raise ValueError(
            f"unknown engine {name!r}; expected one of {sorted(ENGINES)}")


# ---------------------------------------------------------------------------
# Spec resolution
# ---------------------------------------------------------------------------

def build_fleet(fs: FleetSpec,
                profiles: Optional[dict[str, VelocityProfile]] = None,
                max_decoders: Optional[int] = None) -> Fleet:
    """Resolve a declarative ``FleetSpec`` into a runtime ``Fleet``: each
    pool gets its own model config, instance spec, (cached) velocity
    profile, and — for convertible pools — an Eq. 5-6 restriction planned
    against that pool's own hardware.  ``profiles`` overrides profiling
    per pool name (e.g. the int8-KV what-if in ``benchmarks.run.kv8``);
    ``max_decoders`` feeds the §IV-C2 offline pool sizing (defaults to
    the historical 8-decoder fleet when the caller has no scale cap)."""
    pools = []
    for ps in fs.pools:
        cfg = get_config(ps.model)
        inst = InstanceSpec(CHIPS[ps.chip], tp=ps.tp)
        prof = (profiles or {}).get(ps.name) \
            or profile_for(ps.model, ps.chip, ps.tp,
                           hbm_frac=ps.hbm_frac)
        conv = default_convertible_plan(
            cfg, inst, prof, max_decoders=max_decoders or 8) \
            if ps.role == "convertible" else None
        pools.append(Pool(ps, cfg, inst, prof, conv_cfg=conv))
    return Fleet(pools)


def build_traces(spec: ExperimentSpec) -> list[TraceRequest]:
    """One trace per model route, each request tagged with its model.
    Route 0 uses the spec seed verbatim (single-route specs reproduce the
    legacy ``run_policy`` arrivals byte-for-byte); later routes draw from
    decorrelated seed streams.  Multi-route traces are merged by arrival
    time and renumbered like the paper's Mixed workload."""
    if not spec.fleet.routes:
        raise ValueError("ExperimentSpec needs at least one TraceRoute")
    parts = []
    for i, route in enumerate(spec.fleet.routes):
        part = get_trace(route.trace, spec.duration, route.rps,
                         spec.seed + _ROUTE_SEED_STRIDE * i,
                         priority_mix=route.priority_mix,
                         session_prob=route.session_prob,
                         shared_prefix_prob=route.shared_prefix_prob,
                         shared_prefix_len=route.shared_prefix_len,
                         shared_prefix_count=route.shared_prefix_count)
        for r in part:
            r.model = route.model
        parts.append(part)
    if len(parts) == 1:
        return parts[0]
    merged = [r for part in parts for r in part]
    merged.sort(key=lambda r: r.t)
    for i, r in enumerate(merged):
        r.rid = i
    return merged


def run_spec(spec: ExperimentSpec,
             profiles: Optional[dict[str, VelocityProfile]] = None
             ) -> SimReport:
    """The pool-centric entry point: heterogeneous fleets and multi-model
    serving run end-to-end on either engine from one declarative spec."""
    fleet = build_fleet(spec.fleet, profiles,
                        max_decoders=spec.max_instances)
    trace = build_traces(spec)
    if spec.policy in FLEET_POLICY_REGISTRY:
        # fleet-native planner: sees the whole spec + one profile per
        # pool, plans all pools jointly (same-role pool sets, cross-model
        # spill, drain-based scale-down)
        fpolicy = build_fleet_policy(
            spec.policy, spec.fleet,
            {name: pool.prof for name, pool in fleet.pools.items()},
            **spec.policy_options)
    else:
        policies = {}
        for model, g in fleet.groups.items():
            stats = trace_stats(
                [r for r in trace
                 if (r.model or fleet.default_model) == model])
            policies[model] = build_policy(
                spec.policy, g.prefill.prof, decode_prof=g.decode.prof,
                mean_in=stats.mean_in, mean_out=stats.mean_out,
                n_convertible=g.convertible.spec.init if g.convertible
                else 0,
                **spec.policy_options)
        fpolicy = PerModelFleetPolicy(policies)
    cl = get_engine(spec.engine)(
        fleet, policy=fpolicy,
        predictor=OutputPredictor(spec.predictor_accuracy, spec.seed),
        dt=spec.dt, preemption=spec.preemption,
        max_instances=spec.max_instances,
        snapshot_interval=spec.snapshot_interval,
        faults=spec.faults)
    if spec.telemetry:
        # flight recorder (repro_torch.obs): pure observer attached before the
        # run so every hook site sees it; the default-off path above never
        # imports the package
        from repro_torch.obs import FlightRecorder
        cl.attach_obs(FlightRecorder(meta={
            "policy": spec.policy, "seed": spec.seed,
            "preemption": spec.preemption,
            "routes": [{"model": r.model, "trace": r.trace, "rps": r.rps}
                       for r in spec.fleet.routes],
        }))
    return cl.run(trace, spec.duration + spec.extra_horizon)


def hetero_demo_spec(duration: float = 30.0, rps: float = 6.0,
                     seed: int = 0, engine: str = "fluid",
                     policy: str = "tokenscale") -> ExperimentSpec:
    """The canonical heterogeneous-fleet scenario (shared by the smoke
    bench, the golden fixture regenerator, and the differential tests):
    a100-TP2 prefillers feed h100-TP1 decoders plus one h100 Convertible
    Decoder — prefill and decode pools with different chips, TP degrees,
    and therefore different Token Velocities."""
    return ExperimentSpec(
        fleet=FleetSpec(
            pools=(
                PoolSpec("pre-a100", "prefill", "llama31_8b", "a100", tp=2),
                PoolSpec("dec-h100", "decode", "llama31_8b", "h100", tp=1),
                PoolSpec("conv-h100", "convertible", "llama31_8b", "h100",
                         tp=1, init=1),
            ),
            routes=(TraceRoute("llama31_8b", "azure_conv", rps=rps),)),
        policy=policy, engine=engine, duration=duration, seed=seed)


# ---------------------------------------------------------------------------
# Legacy single-pool shims (thin wrappers over one-pool specs)
# ---------------------------------------------------------------------------

def make_policy(name: str, prof: VelocityProfile, n_convertible: int = 1,
                mean_in: Optional[float] = None,
                mean_out: Optional[float] = None,
                trace: Optional[list[TraceRequest]] = None):
    """§V Baselines, via the policy registry.  Threshold derivations
    follow Table I's recipes: request-based thresholds = stage capacity /
    mean request size, with the safety factors the respective papers use
    (which is exactly why they overprovision after bursts, §VI-A).

    ``mean_in``/``mean_out`` must come from the *actual* workload — pass
    them explicitly or pass ``trace=`` to derive them here
    (``sim.traces.trace_stats``); the historical hardcoded 1024/240
    defaults mis-calibrated baselines on skewed traces."""
    if trace is not None:
        stats = trace_stats(trace)
        mean_in = stats.mean_in if mean_in is None else mean_in
        mean_out = stats.mean_out if mean_out is None else mean_out
    if mean_in is None or mean_out is None:
        raise ValueError(
            "make_policy needs the workload's request-size stats: pass "
            "mean_in/mean_out or trace= (see sim.traces.trace_stats)")
    return build_policy(name, prof, decode_prof=prof, mean_in=mean_in,
                        mean_out=mean_out, n_convertible=n_convertible)


def run_policy(policy_name: str, trace_name: str = "mixed",
               model: str = "llama31_8b", chip: str = "a100", tp: int = 1,
               duration: float = 120.0, rps: float = 8.0, seed: int = 0,
               n_convertible: int = 1, predictor_accuracy: float = 0.85,
               dt: float = 0.025,
               prof: Optional[VelocityProfile] = None,
               engine: str = "fluid",
               preemption: str = "none",
               priority_mix: Optional[dict] = None,
               max_instances: int = 64,
               session_prob: float = 0.0,
               block_size: int = 0,
               hbm_frac: float = 0.9,
               offload_gb: Optional[float] = None,
               prefix_cache: bool = False,
               prefill_chunking: int = 0,
               gateway: bool = False,
               kv_alloc: str = "reserve",
               shared_prefix_prob: float = 0.0,
               shared_prefix_len: int = 512,
               shared_prefix_count: int = 8,
               telemetry: bool = False,
               faults: Optional[dict] = None) -> SimReport:
    """The classic single-pool experiment, desugared to a one-pool spec.
    Kept byte-stable with the pre-pool control plane (golden fixtures).
    The KV-tier knobs (``block_size``/``hbm_frac``/``offload_gb``/
    ``prefix_cache``, sim.kvcache), the multi-turn ``session_prob``, the
    chunked-prefill/deflection knob ``prefill_chunking``, the locality
    gateway (``gateway``/``kv_alloc``, core.gateway) and the Zipf shared-
    prompt workload knobs (``shared_prefix_*``, sim.traces) default to
    the legacy flat-byte-counter, single-turn, wholesale-conversion,
    owner-steered behavior.  ``faults`` (a ``sim.faults.FaultConfig``
    dict) arms the chaos engine; None keeps the run fault-free and
    byte-identical."""
    n_conv = n_convertible if policy_name == "tokenscale" else 0
    fleet_spec = single_pool_fleet(model, chip, tp, trace=trace_name,
                                   rps=rps, n_convertible=n_conv,
                                   priority_mix=priority_mix,
                                   session_prob=session_prob,
                                   block_size=block_size,
                                   hbm_frac=hbm_frac,
                                   offload_gb=offload_gb,
                                   prefix_cache=prefix_cache,
                                   prefill_chunking=prefill_chunking,
                                   gateway=gateway,
                                   kv_alloc=kv_alloc,
                                   shared_prefix_prob=shared_prefix_prob,
                                   shared_prefix_len=shared_prefix_len,
                                   shared_prefix_count=shared_prefix_count)
    spec = ExperimentSpec(
        fleet=fleet_spec, policy=policy_name, engine=engine,
        preemption=preemption, duration=duration, seed=seed, dt=dt,
        predictor_accuracy=predictor_accuracy, max_instances=max_instances,
        telemetry=telemetry, faults=faults)
    profiles = {p.name: prof for p in fleet_spec.pools} if prof else None
    return run_spec(spec, profiles=profiles)


def compare_policies(trace_name: str = "mixed", model: str = "llama31_8b",
                     chip: str = "a100", tp: int = 1,
                     duration: float = 120.0, rps: float = 8.0,
                     seed: int = 0,
                     engine: str = "fluid") -> dict[str, SimReport]:
    prof = profile_for(model, chip, tp)
    out = {}
    for name in ["tokenscale", "distserve", "aibrix", "blitzscale"]:
        out[name] = run_policy(name, trace_name, model, chip, tp,
                               duration, rps, seed, prof=prof, engine=engine)
    return out


def compare_engines(policy_name: str, trace_name: str = "mixed",
                    duration: float = 60.0, rps: float = 8.0,
                    seed: int = 0, **kw) -> dict[str, SimReport]:
    """Differential validation helper: the same trace + policy through both
    engines (tests/test_sim_differential.py asserts their agreement)."""
    return {name: run_policy(policy_name, trace_name, duration=duration,
                             rps=rps, seed=seed, engine=name, **kw)
            for name in ENGINES}
