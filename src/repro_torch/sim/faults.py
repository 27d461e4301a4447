"""Seeded, deterministic fault injection for the sim engines.

ROADMAP item 5: failure injection as first-class events — instance crash
+ warm-restart, straggler chips, degraded swap bandwidth, KVC-transfer
link loss — so Token Velocity's leading-indicator claim is tested on a
fleet that silently loses capacity, not just a healthy one.

Determinism contract
--------------------
The schedule is drawn *before* the run from one independent RNG
substream (``sim.traces.substream(seed, SALT_FAULTS)``), so:

  * arrivals (and every other decorator stream) stay byte-identical
    whether faults are on or off — same construction as the priority/
    session/shared-prefix streams;
  * the same ``FaultConfig`` yields the same ``FaultEvent`` list on both
    engines.  Events carry a unit-interval ``pick`` instead of a concrete
    instance id: the *target* is resolved at fire time against the live
    fleet (which may legitimately differ between engines mid-run), and
    the resolution is a pure function of the sorted candidate list — no
    RNG is consumed during the run.

The events engine injects each ``FaultEvent`` as an exact heap event
(``_ev_fault``); the fluid engine drains due events at tick granularity
(DESIGN.md "Fault fidelity").  Everything is default-off: with
``ExperimentSpec.faults`` unset no schedule exists, no per-event work
runs, and goldens reproduce byte-identically.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Optional

from repro_torch.sim.traces import SALT_FAULTS, substream

#: fault kinds, in schedule-draw order (stable tiebreaker for same-t draws)
FAULT_KINDS = ("crash", "straggler", "swap_degrade", "link_down")


@dataclass
class FaultEvent:
    """One scheduled injection.  ``pick`` selects the target at fire time:
    index = int(pick * len(candidates)) over the live, ready, non-draining
    instances of ``role`` sorted by instance id."""
    t: float
    kind: str                  # one of FAULT_KINDS
    role: str = "decode"       # target role ("prefill" | "decode")
    pick: float = 0.0          # uniform [0, 1) target selector
    dur: float = 0.0           # window length (straggler/swap/link)
    factor: float = 1.0        # velocity / bandwidth multiplier
    jitter: float = 1.0        # warm-restart startup_s multiplier (crash)


@dataclass(frozen=True)
class FaultConfig:
    """The ``ExperimentSpec.faults`` knob, JSON-round-trippable.

    Counts are draws over the injection window ``[t0, t1]`` (``t1``
    defaults to 60% of the horizon so recovery is observable before the
    drain tail).  ``recovery`` gates the *entire* self-healing path:
    health-monitor detection + warm replacement, KVC retry/backoff with
    recompute fallback, crash-resident prefix reuse, and measured
    effective velocity feeding Eq. 2-4.  With it off, faults still fire
    but the control plane is blind — crashed capacity stays on the books
    (the lagging-signal contrast ``--bench=chaos`` measures)."""
    seed: int = 0
    crashes: int = 0
    stragglers: int = 0
    straggler_factor: float = 0.5
    straggler_dur: float = 10.0
    swap_degrades: int = 0
    swap_factor: float = 0.25
    swap_dur: float = 10.0
    link_outages: int = 0
    link_dur: float = 2.0
    t0: float = 5.0
    t1: Optional[float] = None
    recovery: bool = True
    #: health-monitor probe cadence: a crash is *detected* at the next
    #: probe tick, and the replacement boots startup_s * jitter later
    detect_s: float = 1.0
    #: recovery-off client abandon time: crash-lost residents re-enter
    #: the system only after their client times out and resubmits
    client_timeout_s: float = 10.0
    #: KVC-transfer retry ladder during a link outage (recovery on)
    max_retries: int = 4
    backoff0_s: float = 0.25
    #: crash/straggler target roles, in draw order
    roles: tuple = ("prefill", "decode")

    def __post_init__(self):
        for name in ("crashes", "stragglers", "swap_degrades",
                     "link_outages"):
            if getattr(self, name) < 0:
                raise ValueError(f"faults.{name} must be >= 0")
        if not 0.0 < self.straggler_factor <= 1.0:
            raise ValueError("faults.straggler_factor must be in (0, 1]")
        if not 0.0 < self.swap_factor <= 1.0:
            raise ValueError("faults.swap_factor must be in (0, 1]")
        bad = [r for r in self.roles if r not in ("prefill", "decode")]
        if bad:
            raise ValueError(f"faults.roles: unknown roles {bad}")
        object.__setattr__(self, "roles", tuple(self.roles))

    @classmethod
    def from_dict(cls, d: dict) -> "FaultConfig":
        known = {f.name for f in fields(cls)}
        bad = sorted(set(d) - known)
        if bad:
            raise ValueError(f"unknown fault-config keys {bad}; "
                             f"expected a subset of {sorted(known)}")
        return cls(**d)


def build_schedule(cfg: FaultConfig, duration: float) -> list[FaultEvent]:
    """Draw the full, time-sorted injection schedule for one run.  Pure
    function of (config, horizon): one substream, category draws in a
    fixed order, stable sort — both engines replay the identical list."""
    rng = substream(cfg.seed, SALT_FAULTS)
    t1 = cfg.t1 if cfg.t1 is not None else max(cfg.t0, 0.6 * duration)
    span = max(t1 - cfg.t0, 0.0)

    def draw_t() -> float:
        return cfg.t0 + float(rng.random_sample()) * span

    events: list[FaultEvent] = []
    for _ in range(cfg.crashes):
        role = cfg.roles[int(rng.random_sample() * len(cfg.roles))]
        events.append(FaultEvent(
            t=draw_t(), kind="crash", role=role,
            pick=float(rng.random_sample()),
            jitter=0.75 + 0.5 * float(rng.random_sample())))
    for _ in range(cfg.stragglers):
        role = cfg.roles[int(rng.random_sample() * len(cfg.roles))]
        events.append(FaultEvent(
            t=draw_t(), kind="straggler", role=role,
            pick=float(rng.random_sample()),
            dur=cfg.straggler_dur, factor=cfg.straggler_factor))
    for _ in range(cfg.swap_degrades):
        events.append(FaultEvent(
            t=draw_t(), kind="swap_degrade", role="decode",
            pick=float(rng.random_sample()),
            dur=cfg.swap_dur, factor=cfg.swap_factor))
    for _ in range(cfg.link_outages):
        events.append(FaultEvent(
            t=draw_t(), kind="link_down", dur=cfg.link_dur))
    events.sort(key=lambda e: (e.t, FAULT_KINDS.index(e.kind)))
    return events


def pick_target(ev: FaultEvent, candidates: list) -> Optional[object]:
    """Resolve an event's target against the current fleet: the
    ``pick``-indexed entry of the candidate list sorted by instance id.
    Deterministic per engine; ``None`` when no instance is eligible (the
    injection is skipped, counted in ``FaultStats.skipped``)."""
    if not candidates:
        return None
    ordered = sorted(candidates, key=lambda i: i.iid)
    return ordered[min(int(ev.pick * len(ordered)), len(ordered) - 1)]


@dataclass
class FaultStats:
    """Injection + recovery odometers, surfaced as
    ``SimReport.fault_summary()``.  The zero-valued instance defines the
    stable faults-off schema (the recorder's degradation contract)."""
    crashes: int = 0
    restarts: int = 0
    residents_requeued: int = 0
    prefill_requeued: int = 0
    kvc_retries: int = 0
    kvc_retry_backoff_s: float = 0.0
    kvc_fallbacks: int = 0
    straggler_windows: int = 0
    swap_degrade_windows: int = 0
    link_down_windows: int = 0
    skipped: int = 0

    def summary(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}


@dataclass
class HealthMonitor:
    """Snapshot-cadence failure detector: a crash at ``t`` is *noticed*
    at the next probe tick (quantized up, never the same instant), at
    which point the husk leaves the pool books and its warm replacement
    is provisioned — so the autoscaler's Eq. 2-4 view counts the lost
    capacity as demand immediately instead of waiting for queue backlog
    to build (the lagging-signal failure mode ``--bench=chaos`` pins)."""
    cadence: float = 1.0
    detections: int = 0

    def detect_at(self, t_crash: float) -> float:
        k = int(t_crash / self.cadence) + 1
        self.detections += 1
        return k * self.cadence

    def restart_at(self, t_detect: float, startup_s: float,
                   jitter: float) -> float:
        return t_detect + startup_s * jitter
