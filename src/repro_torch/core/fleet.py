"""Pool-centric control-plane API (heterogeneous fleets, multi-model).

TokenScale's velocity metric is defined per (model, chip, tp) instance
tuple, but the original control plane baked in exactly one: flat
``prefillers``/``decoders`` counts in ``Observation``/``ScaleDecision``
and a single ``VelocityProfile`` threaded through everything.  This
module redesigns that surface around **pools**:

  * ``PoolSpec``        — one named pool of identical instances: a role
                          (prefill | decode | convertible), a model, a
                          chip, a TP degree, and an initial size;
  * ``FleetSpec``       — the declarative fleet: a list of pools plus
                          per-model trace routing (``TraceRoute``);
  * ``ExperimentSpec``  — a full experiment (fleet + policy + engine +
                          preemption + horizon), JSON-round-trippable so
                          scenarios are files, not kwarg soup;
  * ``FleetObservation``— per-pool ``PoolSnapshot``s plus per-model
                          gateway aggregates (``GatewayStats``);
  * ``FleetPlan``       — pool name -> target instance count (the pool-
                          centric successor of ``ScaleDecision``);
  * ``FleetPolicy``     — consumes a ``FleetObservation``, emits a
                          ``FleetPlan``; ``PerModelFleetPolicy`` adapts
                          the existing per-model ``Policy`` classes
                          (TokenScale Eq. 2-4 and the §V baselines)
                          unchanged onto heterogeneous pools.

The sim engines execute ``FleetPlan``s against mixed pools (e.g.
a100-TP2 prefillers + h100-TP1 decoders, or two models sharing a
cluster); the old single-pool entry points survive as thin shims over
one-pool specs (``sim.runner.run_policy``).  See DESIGN.md §1b.
"""
from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass, field
from typing import Callable, Optional

from repro_torch.core.autoscaler import (Observation, Policy, ScaleDecision,
                                   TokenScalePolicy, _DownHysteresis)
from repro_torch.core.convertible import spill_compatible
from repro_torch.core.velocity import (VelocityProfile, decode_tokens_per_dollar,
                                 prefill_tokens_per_dollar)

#: valid pool roles
ROLES = ("prefill", "decode", "convertible")


# ---------------------------------------------------------------------------
# Declarative specs (JSON-round-trippable)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PoolSpec:
    """One named pool of identical (model, chip, tp) instances."""
    name: str
    role: str                      # prefill | decode | convertible
    model: str = "llama31_8b"
    chip: str = "a100"
    tp: int = 1
    init: int = 1                  # initial (convertible: fixed) size
    min: int = 1                   # scale-down floor (non-convertible)
    # scale-up ceiling for fleet-native planners (0 = uncapped).  Per-model
    # adapted policies ignore it (they predate pool sets); the coordinated
    # planner apportions demand across same-role pools up to this cap, so
    # an elastic overflow pool is expressed as ``min=0, max=N``.
    max: int = 0
    # ---- KV-cache tiering (sim.kvcache; decode/convertible roles) ----
    # block_size > 0 switches the pool's decoders from the legacy flat
    # byte counter to the paged two-tier allocator (tokens per block);
    # 0 keeps the pre-KV-subsystem accounting byte-for-byte.
    block_size: int = 0
    # usable fraction of HBM after allocator/runtime overheads (the
    # historical hardcoded 0.9, now a knob)
    hbm_frac: float = 0.9
    # host-DRAM offload tier capacity in GB per instance; None = the
    # chip's own host_dram_cap, 0 = tier disabled (swap falls back to
    # recompute)
    offload_gb: Optional[float] = None
    # retain finished requests' prompt+output blocks in a per-decoder
    # prefix tree for copy-on-write reuse by same-session follow-ups
    prefix_cache: bool = False
    # ---- chunked prefill / deflection (decode/convertible roles) ----
    # > 0 switches the pool's decoders from whole-instance conversion to
    # per-iteration chunked prefill: prompts split into chunks of at most
    # this many tokens, each co-scheduled inside a decode iteration and
    # re-capped online against Eq. 5's TPOT headroom.  On decode pools it
    # additionally makes the instances deflection targets (Alg. 1 round
    # 2b).  0 keeps the legacy wholesale-conversion path byte-for-byte.
    prefill_chunking: int = 0
    # ---- KV-locality gateway (core.gateway; decode/convertible roles) ----
    # route this pool's decode placements through the fleet-level prefix
    # hashtrie gateway: block-granular cross-session prefix matching, a
    # cached_suffix_savings - alpha*queue_depth locality score, and
    # hot-prefix replication across decoders.  Requires the paged
    # allocator with prefix_cache.  False keeps the session-cache owner-steering
    # lookup byte-for-byte.
    gateway: bool = False
    # KV allocation mode for the pool's decoders: "reserve" books the
    # full predicted output length at admission (legacy, byte-identical);
    # "lazy" allocates-on-generate — admission books prompt + one output
    # block and owned blocks grow per generated token, with mid-decode
    # OOM preemption through the existing PreemptionPolicy on exhaustion.
    kv_alloc: str = "reserve"

    def __post_init__(self):
        if self.role not in ROLES:
            raise ValueError(
                f"pool {self.name!r}: unknown role {self.role!r}; "
                f"expected one of {ROLES}")
        if self.max < 0:
            raise ValueError(
                f"pool {self.name!r}: max must be >= 0 (0 = uncapped)")
        if self.max > 0 and self.max < max(self.min, self.init):
            raise ValueError(
                f"pool {self.name!r}: max={self.max} below min={self.min}/"
                f"init={self.init}")
        if self.block_size < 0:
            raise ValueError(
                f"pool {self.name!r}: block_size must be >= 0")
        if not 0.0 < self.hbm_frac <= 1.0:
            raise ValueError(
                f"pool {self.name!r}: hbm_frac must be in (0, 1]")
        if self.prefill_chunking < 0:
            raise ValueError(
                f"pool {self.name!r}: prefill_chunking must be >= 0")
        if self.prefill_chunking > 0 and self.role == "prefill":
            raise ValueError(
                f"pool {self.name!r}: prefill_chunking applies to decode-"
                "side pools (prefillers always run whole prompts)")
        if self.kv_alloc not in ("reserve", "lazy"):
            raise ValueError(
                f"pool {self.name!r}: kv_alloc must be 'reserve' or "
                f"'lazy' (got {self.kv_alloc!r})")
        if self.kv_alloc == "lazy" and self.block_size <= 0:
            raise ValueError(
                f"pool {self.name!r}: kv_alloc='lazy' needs the paged "
                "allocator (block_size > 0)")
        if self.gateway:
            if self.role == "prefill":
                raise ValueError(
                    f"pool {self.name!r}: gateway applies to decode-side "
                    "pools (placement of decode admissions)")
            if self.block_size <= 0 or not self.prefix_cache:
                raise ValueError(
                    f"pool {self.name!r}: gateway needs the paged prefix "
                    "cache (block_size > 0, prefix_cache=True)")

    @property
    def key(self) -> tuple[str, str, int]:
        """The velocity-profile identity (§III-B: per model, chip, tp)."""
        return (self.model, self.chip, self.tp)


@dataclass(frozen=True)
class TraceRoute:
    """Per-model trace routing: which workload a model's pools serve.

    ``session_prob`` turns the workload conversational: each arrival is a
    same-session follow-up with this probability, its prompt extending the
    session's shared prefix (``sim.traces.assign_sessions``; the draw uses
    an independent RNG stream, so arrivals stay byte-identical).

    ``shared_prefix_prob`` adds Zipf-popular system prompts shared
    *across* sessions (``sim.traces.assign_shared_prefixes``): each
    conversation opener starts from one of ``shared_prefix_count``
    catalog prompts with this probability, and follow-ups inherit the
    opener's prompt.  Again an independent RNG stream — arrivals (and
    the session draw) stay byte-identical."""
    model: str
    trace: str = "mixed"
    rps: float = 8.0
    priority_mix: Optional[dict[int, float]] = None
    session_prob: float = 0.0
    shared_prefix_prob: float = 0.0
    shared_prefix_len: int = 512
    shared_prefix_count: int = 8


@dataclass(frozen=True)
class FleetSpec:
    """A list of pools + per-model trace routing.

    Constraints (validated here, relied on by the engines): every model
    has at least one prefill and one decode pool (possibly several of
    each — same-role pool *sets*, planned jointly by fleet-native
    policies) and at most one convertible pool; pool names are unique;
    every route names a model that has pools.  The first-declared pool of
    each role is the model's *primary* pool: per-model adapted policies
    and legacy single-pool shims see exactly that one.
    """
    pools: tuple[PoolSpec, ...]
    routes: tuple[TraceRoute, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "pools", tuple(self.pools))
        object.__setattr__(self, "routes", tuple(self.routes))
        names = [p.name for p in self.pools]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate pool names: {names}")
        for m in self.models():
            roles = [p.role for p in self.pools_of(m)]
            if roles.count("prefill") < 1 or roles.count("decode") < 1:
                raise ValueError(
                    f"model {m!r} needs at least one prefill and one decode "
                    f"pool (got roles {roles})")
            if roles.count("convertible") > 1:
                raise ValueError(
                    f"model {m!r} has {roles.count('convertible')} "
                    "convertible pools; at most one is supported (§IV-C2: "
                    "the pool is sized offline, not scaled)")
        for r in self.routes:
            if r.model not in self.models():
                raise ValueError(f"route for unknown model {r.model!r}")

    def models(self) -> list[str]:
        seen: list[str] = []
        for p in self.pools:
            if p.model not in seen:
                seen.append(p.model)
        return seen

    def pools_of(self, model: str) -> list[PoolSpec]:
        return [p for p in self.pools if p.model == model]


def single_pool_fleet(model: str = "llama31_8b", chip: str = "a100",
                      tp: int = 1, trace: str = "mixed", rps: float = 8.0,
                      n_convertible: int = 0,
                      priority_mix: Optional[dict[int, float]] = None,
                      init_prefillers: int = 1,
                      init_decoders: int = 1,
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
                      shared_prefix_count: int = 8) -> FleetSpec:
    """The classic homogeneous PD fleet as a one-model spec — what the
    legacy ``run_policy(policy, trace, model, chip, tp, ...)`` signature
    desugars to.  The KV-tier, ``prefill_chunking``, and gateway knobs
    apply to the decode-side pools; the defaults keep the legacy
    flat-byte-counter, wholesale-conversion, owner-steering behavior."""
    kv = dict(block_size=block_size, hbm_frac=hbm_frac,
              offload_gb=offload_gb, prefix_cache=prefix_cache,
              prefill_chunking=prefill_chunking, gateway=gateway,
              kv_alloc=kv_alloc)
    pools = [
        PoolSpec("prefill", "prefill", model, chip, tp, init=init_prefillers,
                 hbm_frac=hbm_frac),
        PoolSpec("decode", "decode", model, chip, tp, init=init_decoders,
                 **kv),
        PoolSpec("convertible", "convertible", model, chip, tp,
                 init=n_convertible, **kv),
    ]
    return FleetSpec(tuple(pools),
                     (TraceRoute(model, trace, rps, priority_mix,
                                 session_prob=session_prob,
                                 shared_prefix_prob=shared_prefix_prob,
                                 shared_prefix_len=shared_prefix_len,
                                 shared_prefix_count=shared_prefix_count),))


@dataclass(frozen=True)
class ExperimentSpec:
    """A declarative, JSON-round-trippable experiment: fleet + policy +
    engine + preemption + horizon.  ``sim.runner.run_spec`` executes it
    end-to-end on either engine."""
    fleet: FleetSpec
    policy: str = "tokenscale"
    engine: str = "fluid"
    preemption: str = "none"
    duration: float = 120.0
    seed: int = 0
    dt: float = 0.025
    predictor_accuracy: float = 0.85
    max_instances: int = 64
    extra_horizon: float = 30.0    # drain time past the last arrival
    # timeline snapshot cadence in seconds; None = adaptive (the engines'
    # historical 0.2 s, stretched on multi-hour horizons so the timeline
    # length stays bounded — see ClusterBase._snapshot_every)
    snapshot_interval: Optional[float] = None
    policy_options: dict = field(default_factory=dict)
    # attach a flight recorder (repro_torch.obs) to the run: per-request span
    # tracing + metrics registry + scaling-decision log on the resulting
    # SimReport.obs.  Off by default — the engines' telemetry hooks are
    # no-ops and the run is byte-identical to a pre-telemetry build.
    telemetry: bool = False
    # chaos engine (sim.faults.FaultConfig as a dict): a seeded,
    # deterministic fault schedule — instance crashes with warm restart,
    # straggler chips, degraded swap bandwidth, KVC link outages — plus
    # the self-healing control plane gated by its ``recovery`` key.  None
    # (default) builds no schedule and the run is byte-identical to a
    # pre-chaos build.
    faults: Optional[dict] = None

    # ---- JSON round trip -------------------------------------------------
    def to_dict(self) -> dict:
        d = asdict(self)
        if d.get("snapshot_interval") is None:
            # keep the serialized form of specs that don't set the knob
            # identical to the pre-knob schema (the hetero golden records
            # a spec dict and must reproduce byte-for-byte)
            d.pop("snapshot_interval")
        if not d.get("telemetry"):
            # same schema-stability rule for the telemetry knob
            d.pop("telemetry", None)
        if not d.get("faults"):
            # ...and for the chaos knob
            d.pop("faults", None)
        for p in d["fleet"]["pools"]:
            # same schema-stability rule for the chunking knob: pools that
            # keep the legacy wholesale-conversion default serialize
            # exactly as they did before the knob existed
            if not p.get("prefill_chunking"):
                p.pop("prefill_chunking", None)
            # ...and for the pool-set scale-up cap (0 = uncapped = the
            # pre-cap schema)
            if not p.get("max"):
                p.pop("max", None)
            # ...and for the gateway knobs (off/reserve = the pre-gateway
            # schema)
            if not p.get("gateway"):
                p.pop("gateway", None)
            if p.get("kv_alloc") == "reserve":
                p.pop("kv_alloc", None)
        for r in d["fleet"]["routes"]:
            # shared-prefix knobs off -> the pre-knob route schema
            if not r.get("shared_prefix_prob"):
                r.pop("shared_prefix_prob", None)
                r.pop("shared_prefix_len", None)
                r.pop("shared_prefix_count", None)
        return d

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 2)
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentSpec":
        d = dict(d)
        f = d.pop("fleet")
        pools = tuple(PoolSpec(**p) for p in f.get("pools", ()))
        routes = []
        for r in f.get("routes", ()):
            r = dict(r)
            mix = r.get("priority_mix")
            if mix is not None:
                # JSON stringifies int keys; undo that on the way back in
                r["priority_mix"] = {int(k): float(v) for k, v in mix.items()}
            routes.append(TraceRoute(**r))
        return cls(fleet=FleetSpec(pools, tuple(routes)), **d)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))

    @classmethod
    def load(cls, path: str) -> "ExperimentSpec":
        with open(path) as f:
            return cls.from_dict(json.load(f))


# ---------------------------------------------------------------------------
# Runtime observation / plan types
# ---------------------------------------------------------------------------

@dataclass
class PoolSnapshot:
    """What the metrics plane reports for one pool each interval."""
    name: str
    role: str
    model: str
    count: int                     # provisioned instances (booting included)
    ready: int                     # past their startup latency
    queue_requests: int = 0        # queued/in-progress prefill requests
    inflight_tokens: float = 0.0   # prefill tokens not yet processed
    inflight: int = 0              # resident decode requests
    mem_util: float = 0.0          # mean HBM utilization of ready instances
    # prefill tok/s this decode-side pool absorbs via chunked deflection
    # (0 with chunking off or no queued chunk work)
    deflected_rate: float = 0.0
    # ready instances with no resident work (spill donors / drain-reapable)
    idle: int = 0
    # instances marked draining: finishing residents, billed, no new work
    draining: int = 0
    # measured effective velocity of the pool's serving instances as a
    # fraction of nominal (mean per-instance multiplier; < 1.0 under
    # straggler windows).  Filled only by the chaos engine's self-healing
    # path — stays 1.0 otherwise, and planners treat 1.0 as "no signal".
    eff_perf: float = 1.0


@dataclass
class GatewayStats:
    """Per-model gateway aggregates over the rolling 1 s window."""
    token_rate_in: float = 0.0
    token_rate_by_bucket: dict[str, float] = field(default_factory=dict)
    rps: float = 0.0
    queued: int = 0                # centrally queued requests (Alg.1 line 15)
    burst: bool = False            # §IV-A detector state at observation time


@dataclass
class FleetObservation:
    """Per-pool snapshots + per-model gateway aggregates: the pool-centric
    successor of the flat ``Observation``."""
    t: float
    pools: dict[str, PoolSnapshot]
    gateway: dict[str, GatewayStats]

    def pools_of(self, model: str, role: Optional[str] = None
                 ) -> list[PoolSnapshot]:
        return [s for s in self.pools.values()
                if s.model == model and (role is None or s.role == role)]


@dataclass
class FleetPlan:
    """Pool name -> target instance count.  Pools absent from ``targets``
    are left alone (convertible pools are fixed, §IV-C2).  ``live`` pools
    skip startup latency on scale-up (BlitzScale's ideal live scaling).

    Drain semantics (fleet-native planners only): pools named in
    ``drain`` scale down by *draining* — victims stop taking new work,
    finish their residents (billed the whole time), and are reaped only
    once idle — instead of the legacy idle-only immediate eviction.
    Plans that leave ``drain`` empty execute byte-identically to the
    pre-drain control plane.

    ``spills`` are cross-model convertible loans: ``(src, dst, n)`` moves
    up to ``n`` idle instances from convertible pool ``src`` to ``dst``
    (same chip/TP — ``core.convertible.spill_compatible``), paying the
    destination chip's startup for the weight swap."""
    targets: dict[str, int] = field(default_factory=dict)
    live: set[str] = field(default_factory=set)
    drain: set[str] = field(default_factory=set)
    spills: list[tuple[str, str, int]] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Fleet policies
# ---------------------------------------------------------------------------

def flat_observation(model: str, obs: FleetObservation) -> Observation:
    """The legacy flat view of one model's pools — byte-identical to the
    pre-pool ``ClusterBase._observation`` when the fleet has a single
    model group."""
    pres = obs.pools_of(model, "prefill")
    decs = obs.pools_of(model, "decode")
    if len(pres) != 1 or len(decs) != 1:
        raise ValueError(
            f"model {model!r} has {len(pres)} prefill / {len(decs)} decode "
            "pools; the flat per-model view needs exactly one of each — "
            "multi-pool fleets need a fleet-native policy (e.g. "
            "'tokenscale-coord')")
    (pre,), (dec,) = pres, decs
    conv = obs.pools_of(model, "convertible")
    gw = obs.gateway.get(model, GatewayStats())
    return Observation(
        t=obs.t, token_rate_in=gw.token_rate_in,
        token_rate_by_bucket=gw.token_rate_by_bucket, rps=gw.rps,
        prefill_queue=pre.queue_requests + gw.queued,
        decode_inflight=dec.inflight + sum(c.inflight for c in conv),
        mem_util=dec.mem_util,
        cur_prefillers=pre.count, cur_decoders=dec.count,
        deflected_rate=dec.deflected_rate
        + sum(c.deflected_rate for c in conv))


class FleetPolicy:
    """Pool-centric policy interface: one ``FleetPlan`` per interval."""
    name = "fleet-base"
    #: per-model Eq. 2-4 intermediates of the most recent ``plan`` call
    #: ({"models": {model: {...}}}), read by the flight recorder's
    #: decision log (obs.explain); None when the planner doesn't expose
    #: its arithmetic.
    last_debug: Optional[dict] = None

    def plan(self, obs: FleetObservation) -> FleetPlan:  # pragma: no cover
        raise NotImplementedError

    def model_policy(self, model: str) -> Optional[Policy]:
        """The per-model legacy ``Policy`` driving this model's pools, if
        any — the engines use it to keep policy-conditional routing
        (burst traffic to Convertible Decoders for TokenScale only)
        byte-identical with the pre-pool control plane."""
        return None


class PerModelFleetPolicy(FleetPolicy):
    """Adapts per-model ``Policy`` objects (TokenScale Eq. 2-4 and the §V
    baselines, unmodified) onto named pools: each model's policy sees a
    flat ``Observation`` reconstructed from its own pools' snapshots and
    gateway aggregates, and its ``ScaleDecision`` maps onto that model's
    prefill/decode pool targets."""

    def __init__(self, policies: dict[str, Policy]):
        if not policies:
            raise ValueError("need at least one per-model policy")
        self.policies = policies
        names = sorted({p.name for p in policies.values()})
        self.name = names[0] if len(names) == 1 else "+".join(names)

    def model_policy(self, model: str) -> Optional[Policy]:
        return self.policies.get(model)

    def plan(self, obs: FleetObservation) -> FleetPlan:
        plan = FleetPlan()
        debug: dict = {}
        for model, pol in self.policies.items():
            dec: ScaleDecision = pol.decide(flat_observation(model, obs))
            (pre_pool,) = obs.pools_of(model, "prefill")
            (dec_pool,) = obs.pools_of(model, "decode")
            tp, td = dec.prefillers, dec.decoders
            # measured effective velocity (chaos self-healing path):
            # straggling boxes deliver eff_perf * nominal tokens/s, so
            # Eq. 2-4's instance counts are inflated to restore the
            # provisioned token velocity.  eff_perf is 1.0 outside fault
            # windows — these branches never fire on a healthy fleet.
            if pre_pool.eff_perf < 1.0:
                tp = math.ceil(tp / max(pre_pool.eff_perf, 0.1))
            if dec_pool.eff_perf < 1.0:
                td = math.ceil(td / max(dec_pool.eff_perf, 0.1))
            plan.targets[pre_pool.name] = tp
            plan.targets[dec_pool.name] = td
            if dec.live:
                plan.live |= {pre_pool.name, dec_pool.name}
            if pol.last_debug is not None:
                gw = obs.gateway.get(model)
                debug[model] = dict(pol.last_debug,
                                    burst=gw.burst if gw else False)
        self.last_debug = {"models": debug} if debug else None
        return plan


class CoordinatedTokenScalePolicy(FleetPolicy):
    """Fleet-native TokenScale: Eq. 2-4 generalized over same-role pool
    *sets*, planned globally across models.

    Apportionment (the pool-set generalization of Eq. 2-3): each model's
    residual prefill token rate (Eq. 2's ``token_rate_in - deflected``)
    and per-bucket decode rate vector (Eq. 3) are walked down that
    model's same-role pools ranked by *cost-normalized velocity*
    (tokens/s/$, ``core.velocity``) — the DistServe goodput-per-GPU axis.
    Each pool absorbs demand at its own profiled velocity up to its
    ``PoolSpec.max`` cap; only the last pool touched ceils, so the pool
    set provisions no more than a single merged pool would.  The fixed
    convertible pool absorbs decode demand first at its *current* size
    (Eq. 4 net of borrowed/lent boxes), then floors and per-pool
    down-hysteresis apply exactly as in the per-model policy.

    Scale-down is drain-based (every planned pool is named in
    ``FleetPlan.drain``): victims finish residents before leaving, so a
    lower target never evicts KV state mid-decode.

    Cross-model spill: when a model's gateway is in burst and its
    convertible pool has no idle box, idle convertibles are borrowed from
    non-bursting models' ``spill_compatible`` pools (same chip/TP — the
    loan is a weight swap, paying startup).  Loans are inferred from pool
    sizes relative to ``PoolSpec.init`` — no planner-side ledger — and
    reverse automatically once the borrower's burst subsides and the
    borrowed boxes idle."""

    name = "tokenscale-coord"

    def __init__(self, fleet: FleetSpec, profiles: dict[str, VelocityProfile],
                 down_delay: float = 5.0, spill: bool = True,
                 headroom: float = 0.9):
        missing = [p.name for p in fleet.pools if p.name not in profiles]
        if missing:
            raise ValueError(f"no velocity profile for pools {missing}")
        if not 0.0 < headroom <= 1.0:
            raise ValueError(f"headroom must be in (0, 1], got {headroom}")
        self.fleet = fleet
        self.profiles = profiles
        self.spill = spill
        # utilization guard-band: demand is apportioned against
        # headroom * velocity, so pools run below saturation.  The per-
        # instance first-iteration time grows with resident batch, so a
        # pool planned to 100% of its TPOT-capped batch serves marginal
        # TTFTs late even when aggregate throughput keeps up.
        self.headroom = headroom
        self.hyst = _DownHysteresis(down_delay)
        # per-model TokenScale instances: never asked to decide() — they
        # exist so the engines' policy-conditional routing (burst traffic
        # to Convertible Decoders for TokenScale only) sees this planner
        # as TokenScale for every model it serves
        self._model_pols: dict[str, Policy] = {}
        for m in fleet.models():
            by_role = {r: [p for p in fleet.pools_of(m) if p.role == r]
                       for r in ROLES}
            conv = by_role["convertible"]
            self._model_pols[m] = TokenScalePolicy(
                profiles[by_role["prefill"][0].name],
                convertible=conv[0].init if conv else 0,
                decode_profile=profiles[by_role["decode"][0].name],
                down_delay=down_delay)

    def model_policy(self, model: str) -> Optional[Policy]:
        return self._model_pols.get(model)

    # ---- pool-set apportionment (Eq. 2-3 over ranked pools) -----------
    def _rank(self, pools: list[PoolSpec], dollar_velocity) -> list[PoolSpec]:
        """Descending tokens/s/$; ``sorted`` is stable, so equal-cost pools
        keep declaration order (the primary pool wins ties)."""
        return sorted(pools,
                      key=lambda p: -dollar_velocity(self.profiles[p.name]))

    def _settle(self, plan: FleetPlan, obs: FleetObservation,
                spec: PoolSpec, take: int, burst: bool = False):
        snap = obs.pools[spec.name]
        tgt = max(take, spec.min)
        if snap.eff_perf < 1.0:
            # stragglers deliver eff_perf * nominal velocity: inflate the
            # pool's target so provisioned token velocity is restored
            # (chaos self-healing path; 1.0 — i.e. never — otherwise)
            tgt = math.ceil(tgt / max(snap.eff_perf, 0.1))
        active = snap.count - snap.draining
        if burst:
            # §IV-A gate: while the model's burst detector is hot, never
            # drain below the active size — the inter-sub-burst lull that
            # momentarily shrinks the token rate is exactly when released
            # capacity would have to be bought back at startup latency
            tgt = max(tgt, active)
        plan.targets[spec.name] = self.hyst.apply(spec.name, active, tgt,
                                                  obs.t)

    def _apportion_prefill(self, plan: FleetPlan, obs: FleetObservation,
                           pools: list[PoolSpec], rate: float,
                           burst: bool = False):
        remaining = rate
        for spec in self._rank(pools, prefill_tokens_per_dollar):
            prof = self.profiles[spec.name]
            v = max(min(prof.v_prefill, prof.v_network) * self.headroom,
                    1e-9)                                        # Eq. 2
            cap = spec.max if spec.max > 0 else float("inf")
            frac = remaining / v
            if frac > cap:
                take = int(cap)
                remaining -= cap * v
            else:
                take = min(math.ceil(frac), int(min(cap, 1 << 30)))
                remaining = 0.0
            self._settle(plan, obs, spec, take, burst)

    def _decode_need(self, prof: VelocityProfile,
                     rem: dict[str, float]) -> float:
        return sum(r / max(prof.v_decode.get(b, 1e9) * self.headroom, 1e-9)
                   for b, r in rem.items())                       # Eq. 3

    def _apportion_decode(self, plan: FleetPlan, obs: FleetObservation,
                          pools: list[PoolSpec], rem: dict[str, float],
                          burst: bool = False):
        for spec in self._rank(pools, decode_tokens_per_dollar):
            prof = self.profiles[spec.name]
            need = self._decode_need(prof, rem)
            cap = spec.max if spec.max > 0 else float("inf")
            if need > cap:
                take = int(cap)
                f = cap / need
                for b in rem:
                    rem[b] *= (1.0 - f)
            else:
                take = min(math.ceil(need), int(min(cap, 1 << 30)))
                for b in rem:
                    rem[b] = 0.0
            self._settle(plan, obs, spec, take, burst)

    # ---- cross-model convertible spill --------------------------------
    def _plan_spills(self, plan: FleetPlan, obs: FleetObservation):
        convs = {m: next((p for p in self.fleet.pools_of(m)
                          if p.role == "convertible"), None)
                 for m in self.fleet.models()}
        lent: dict[str, int] = {}      # boxes committed within this plan
        for m, cp in convs.items():
            if cp is None:
                continue
            snap = obs.pools.get(cp.name)
            if snap is None:
                continue
            gw = obs.gateway.get(m, GatewayStats())
            if gw.burst and snap.idle == 0:
                # saturated convertibles under a detected burst: borrow
                for m2, dp in convs.items():
                    if m2 == m or dp is None or not spill_compatible(dp, cp):
                        continue
                    if obs.gateway.get(m2, GatewayStats()).burst:
                        continue
                    ds = obs.pools.get(dp.name)
                    if ds is None:
                        continue
                    out = lent.get(dp.name, 0)
                    # lend idle boxes only, never the donor's last one
                    n = min(ds.idle - out, ds.count - out - 1)
                    if n <= 0:
                        continue
                    plan.spills.append((dp.name, cp.name, n))
                    lent[dp.name] = out + n
            elif not gw.burst and snap.count > cp.init and snap.idle > 0:
                # burst over: return borrowed boxes to shrunken donors
                idle = snap.idle
                for m2, dp in convs.items():
                    if idle <= 0:
                        break
                    if m2 == m or dp is None or not spill_compatible(cp, dp):
                        continue
                    ds = obs.pools.get(dp.name)
                    if ds is None or ds.count >= dp.init:
                        continue
                    n = min(idle, snap.count - cp.init, dp.init - ds.count)
                    if n <= 0:
                        continue
                    plan.spills.append((cp.name, dp.name, n))
                    idle -= n

    # ---- the plan -----------------------------------------------------
    def plan(self, obs: FleetObservation) -> FleetPlan:
        plan = FleetPlan()
        debug: dict = {}
        for m in self.fleet.models():
            by_role = {r: [p for p in self.fleet.pools_of(m) if p.role == r]
                       for r in ROLES}
            gw = obs.gateway.get(m, GatewayStats())
            # Eq. 2 residual: chunk-deflected work is owed by the decode
            # side, never double-provisioned (summed across the pool set)
            deflected = sum(
                obs.pools[p.name].deflected_rate
                for p in by_role["decode"] + by_role["convertible"]
                if p.name in obs.pools)
            rate = max(gw.token_rate_in - deflected, 0.0)
            self._apportion_prefill(plan, obs, by_role["prefill"], rate,
                                    gw.burst)
            # Eq. 4 first: the convertible pool absorbs decode demand at
            # its *current* size (loans included) before regular pools
            rem = dict(gw.token_rate_by_bucket)
            conv = by_role["convertible"]
            conv_dbg = {"convertible": 0, "absorbed_frac": 0.0}
            if conv and rem:
                snap = obs.pools.get(conv[0].name)
                n_conv = snap.count if snap is not None else conv[0].init
                cprof = self.profiles[conv[0].name]
                need = self._decode_need(cprof, rem)
                conv_dbg["convertible"] = n_conv
                if need > 0.0:
                    f = min(n_conv / need, 1.0)
                    conv_dbg["absorbed_frac"] = f
                    for b in rem:
                        rem[b] *= (1.0 - f)
            self._apportion_decode(plan, obs, by_role["decode"], rem,
                                   gw.burst)
            # flight-recorder breadcrumb (pool-set Eq. 2-4 inputs + the
            # cost ranking that ordered the apportionment), read by
            # obs.explain via ``FlightRecorder.on_plan``
            debug[m] = {
                "policy": self.name, "burst": gw.burst,
                "eq2": {"token_rate_in": gw.token_rate_in,
                        "deflected_rate": deflected, "rate": rate,
                        "headroom": self.headroom},
                "eq3": {"rate_by_bucket": dict(gw.token_rate_by_bucket)},
                "eq4": conv_dbg,
                "prefill_rank": [
                    (p.name, prefill_tokens_per_dollar(self.profiles[p.name]))
                    for p in self._rank(by_role["prefill"],
                                        prefill_tokens_per_dollar)],
                "decode_rank": [
                    (p.name, decode_tokens_per_dollar(self.profiles[p.name]))
                    for p in self._rank(by_role["decode"],
                                        decode_tokens_per_dollar)],
            }
        self.last_debug = {"models": debug}
        # drain-based scale-down for every pool this planner owns
        plan.drain = set(plan.targets)
        if self.spill:
            self._plan_spills(plan, obs)
        return plan


# ---------------------------------------------------------------------------
# Fleet-policy registry: string-keyed construction of fleet-native planners
# ---------------------------------------------------------------------------

#: name -> factory(fleet_spec, {pool name -> VelocityProfile}, **options)
FLEET_POLICY_REGISTRY: dict[str, Callable[..., FleetPolicy]] = {}


def register_fleet_policy(name: str):
    """Register a fleet-native policy factory.  Unlike ``@register_policy``
    (per-model, adapted through ``PerModelFleetPolicy``), these factories
    see the whole ``FleetSpec`` and one profile per pool, and plan all
    pools jointly.  ``sim.runner.run_spec`` checks this registry first, so
    an ``ExperimentSpec.policy`` string resolves to a fleet-native planner
    when one exists under that name."""
    def deco(factory):
        FLEET_POLICY_REGISTRY[name] = factory
        factory.policy_name = name
        return factory
    return deco


def build_fleet_policy(name: str, fleet: FleetSpec,
                       profiles: dict[str, VelocityProfile],
                       **options) -> FleetPolicy:
    try:
        factory = FLEET_POLICY_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown fleet policy {name!r}; registered: "
            f"{sorted(FLEET_POLICY_REGISTRY)}")
    return factory(fleet, profiles, **options)


@register_fleet_policy("tokenscale-coord")
def _build_tokenscale_coord(fleet, profiles, **kw):
    return CoordinatedTokenScalePolicy(fleet, profiles, **kw)


def __getattr__(name: str):
    # Lazy re-export of the chaos-engine control-plane pieces (the health
    # monitor conceptually belongs to the fleet layer, but the
    # implementation lives with the fault machinery).  Lazy because an
    # eager ``core.fleet -> sim.faults`` import would cycle through
    # ``repro_torch.sim.__init__`` back into this module.
    if name in ("FaultConfig", "FaultStats", "HealthMonitor"):
        from repro_torch.sim import faults
        return getattr(faults, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
