"""Autoscaling policies: TokenScale (§IV-C) and the three baselines (§V).

All policies consume the same ``Observation`` snapshot (what a metrics
plane would report each interval) and output desired instance counts; the
cluster simulator executes them with realistic startup latency.

  * TokenScale  — velocity-ratio scaling, Eq.(2)-(4)
  * DistServe   — RPS thresholds for both stages (Table I)
  * AIBrix      — concurrency-based prefiller + GPU-memory-utilization
                  (Knative KPA-style) decoder
  * BlitzScale  — request-count thresholds for both stages + "live" scaling
                  (scale-up start latency removed, §V Baselines)

Policies are constructed uniformly through a string-keyed registry
(``@register_policy`` / ``build_policy``): every factory takes the
prefill pool's ``VelocityProfile``, the decode pool's (they differ on
heterogeneous fleets), and the trace's request-size statistics for the
baselines' Table I threshold derivations.  ``core.fleet`` adapts the
resulting per-model policies onto named pools.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core.velocity import BUCKETS, VelocityProfile


@dataclass
class Observation:
    """Rolling-window metrics snapshot handed to a policy every interval."""
    t: float
    # arrival-side (gateway measurements)
    token_rate_in: float                 # input tok/s (1 s window)
    token_rate_by_bucket: dict[str, float]  # in+predicted-out tok/s per bucket
    rps: float                           # requests/s (1 s window)
    # system-side
    prefill_queue: int                   # requests queued/being prefilled
    decode_inflight: int                 # requests in decode
    mem_util: float                      # mean decoder HBM utilization [0,1]
    ttft_p99: float = 0.0
    tpot_p99: float = 0.0
    cur_prefillers: int = 1
    cur_decoders: int = 1
    # prefill tok/s the decode side is absorbing itself via chunked
    # deflection — the fraction of the arrival rate that partially-
    # prefilled requests no longer owe the prefill pool (0 with the
    # legacy wholesale-conversion path)
    deflected_rate: float = 0.0


@dataclass
class ScaleDecision:
    prefillers: int
    decoders: int
    live: bool = False    # BlitzScale: hide startup latency on scale-up


class Policy:
    name = "base"
    #: Eq. 2-4 intermediates of the most recent ``decide`` call, for the
    #: flight recorder's decision log (obs.explain).  Policies that don't
    #: expose their arithmetic leave it None; the recorder degrades to
    #: plan-only records.
    last_debug: Optional[dict] = None

    def decide(self, obs: Observation) -> ScaleDecision:  # pragma: no cover
        raise NotImplementedError


class _DownHysteresis:
    """Scale down only after the lower target persists for `delay` s."""
    def __init__(self, delay: float = 5.0):
        self.delay = delay
        self._since: dict[str, float] = {}
        self._pending: dict[str, int] = {}

    def apply(self, key: str, cur: int, target: int, t: float) -> int:
        if target >= cur:
            # scale-up (or hold): clear any stale countdown so the next
            # downscale starts a fresh timer
            self._since.pop(key, None)
            self._pending.pop(key, None)
            return target
        if self._pending.get(key) != target:
            # any *change* of the pending target — deeper or shallower —
            # restarts the countdown: a fleet may only drop to a target
            # that persisted for the full delay
            self._since[key] = t
            self._pending[key] = target
        if t - self._since[key] >= self.delay:
            return target
        return cur


# ---------------------------------------------------------------------------
# TokenScale (Eq. 2-4)
# ---------------------------------------------------------------------------

class TokenScalePolicy(Policy):
    name = "tokenscale"

    def __init__(self, profile: VelocityProfile, convertible: int = 1,
                 min_prefillers: int = 1, min_decoders: int = 1,
                 down_delay: float = 5.0,
                 decode_profile: Optional[VelocityProfile] = None):
        # `profile` is the prefill pool's velocity profile; on heterogeneous
        # fleets the decode pool runs a different (model, chip, tp) tuple
        # and supplies its own profile for Eq. (3)
        self.prof = profile
        self.dprof = decode_profile or profile
        self.convertible = convertible
        self.min_p, self.min_d = min_prefillers, min_decoders
        self.hyst = _DownHysteresis(down_delay)

    def decide(self, obs: Observation) -> ScaleDecision:
        # Eq. (2): prefillers from the input token arrival rate vs the
        # slower of prefill/network velocity.  Chunk-deflected work is
        # subtracted first: a partially-prefilled request contributes only
        # the tokens the prefill pool still owes, so the decode side's own
        # absorption never provisions phantom prefillers (with chunking
        # off deflected_rate is 0.0 and this is the historical expression)
        v_eff = min(self.prof.v_prefill, self.prof.v_network)
        rate = max(obs.token_rate_in - obs.deflected_rate, 0.0)
        i_p_raw = math.ceil(rate / max(v_eff, 1e-9))
        # Eq. (3): decoders summed per bucket, at the decode pool's velocity
        i_d_f = sum(rate / max(self.dprof.v_decode.get(b, 1e9), 1e-9)
                    for b, rate in obs.token_rate_by_bucket.items())
        i_d = math.ceil(i_d_f)
        # Eq. (4): regular decoders net of the fixed convertible pool
        i_d_reg_raw = max(i_d - self.convertible, 0)
        i_p = max(i_p_raw, self.min_p)
        i_d_reg = max(i_d_reg_raw, self.min_d)
        i_p = self.hyst.apply("p", obs.cur_prefillers, i_p, obs.t)
        i_d_reg = self.hyst.apply("d", obs.cur_decoders, i_d_reg, obs.t)
        # flight-recorder breadcrumb: the full Eq. 2-4 arithmetic of this
        # interval, read (never fed back) by obs.explain via
        # ``FlightRecorder.on_plan``
        self.last_debug = {
            "policy": self.name,
            "eq2": {"token_rate_in": obs.token_rate_in,
                    "deflected_rate": obs.deflected_rate, "rate": rate,
                    "v_prefill": self.prof.v_prefill,
                    "v_network": self.prof.v_network, "v_eff": v_eff,
                    "i_p": i_p_raw},
            "eq3": {"rate_by_bucket": dict(obs.token_rate_by_bucket),
                    "v_decode": dict(self.dprof.v_decode), "i_d": i_d},
            "eq4": {"convertible": self.convertible,
                    "i_d_regular": i_d_reg_raw},
            "final": {"prefillers": i_p, "decoders": i_d_reg,
                      "cur_prefillers": obs.cur_prefillers,
                      "cur_decoders": obs.cur_decoders},
        }
        return ScaleDecision(i_p, i_d_reg)


# ---------------------------------------------------------------------------
# DistServe: RPS thresholds (Table I)
# ---------------------------------------------------------------------------

class DistServePolicy(Policy):
    name = "distserve"

    def __init__(self, rps_per_prefiller: float = 14.0,
                 rps_per_decoder: float = 28.0, down_delay: float = 5.0):
        self.rp, self.rd = rps_per_prefiller, rps_per_decoder
        self.hyst = _DownHysteresis(down_delay)

    def decide(self, obs: Observation) -> ScaleDecision:
        i_p = max(math.ceil(obs.rps / self.rp), 1)
        i_d = max(math.ceil(obs.rps / self.rd), 1)
        i_p = self.hyst.apply("p", obs.cur_prefillers, i_p, obs.t)
        i_d = self.hyst.apply("d", obs.cur_decoders, i_d, obs.t)
        return ScaleDecision(i_p, i_d)


# ---------------------------------------------------------------------------
# AIBrix: concurrency prefiller + memory-utilization decoder (Table I)
# ---------------------------------------------------------------------------

class AIBrixPolicy(Policy):
    name = "aibrix"

    def __init__(self, conc_per_prefiller: float = 7.0,
                 mem_util_target: float = 0.7, window_s: float = 5.0,
                 down_delay: float = 10.0):
        self.cp = conc_per_prefiller
        self.target = mem_util_target
        self.window_s = window_s
        self._hist: list[tuple[float, float, float]] = []
        self.hyst = _DownHysteresis(down_delay)

    def decide(self, obs: Observation) -> ScaleDecision:
        # sliding-window average of concurrency and utilization — this is
        # precisely why AIBrix lags bursts (§II-D)
        self._hist.append((obs.t, float(obs.prefill_queue), obs.mem_util))
        self._hist = [h for h in self._hist if obs.t - h[0] <= self.window_s]
        conc = sum(h[1] for h in self._hist) / len(self._hist)
        util = sum(h[2] for h in self._hist) / len(self._hist)
        i_p = max(math.ceil(conc / self.cp), 1)
        # KPA: desired = ceil(current * util / target)
        i_d = max(math.ceil(obs.cur_decoders * util / self.target), 1)
        i_p = self.hyst.apply("p", obs.cur_prefillers, i_p, obs.t)
        i_d = self.hyst.apply("d", obs.cur_decoders, i_d, obs.t)
        return ScaleDecision(i_p, i_d)


# ---------------------------------------------------------------------------
# BlitzScale: request-count thresholds + live scaling (Table I)
# ---------------------------------------------------------------------------

class ComboPolicy(Policy):
    """Ablation helper (§VI-D): prefiller decisions from one policy,
    decoder decisions from another (B, B+P, B+P+D configurations)."""

    def __init__(self, p_policy: Policy, d_policy: Policy, name: str):
        self.p_policy = p_policy
        self.d_policy = d_policy
        self.name = name

    def decide(self, obs: Observation) -> ScaleDecision:
        p = self.p_policy.decide(obs)
        d = self.d_policy.decide(obs)
        return ScaleDecision(p.prefillers, d.decoders,
                             live=p.live or d.live)


class BlitzScalePolicy(Policy):
    name = "blitzscale"

    def __init__(self, req_per_prefiller: float = 7.0,
                 req_per_decoder: float = 45.0, window_s: float = 2.0,
                 down_delay: float = 10.0):
        self.rp, self.rd = req_per_prefiller, req_per_decoder
        self.window_s = window_s
        self._hist: list[tuple[float, float, float]] = []
        self.hyst = _DownHysteresis(down_delay)

    def decide(self, obs: Observation) -> ScaleDecision:
        self._hist.append((obs.t, float(obs.prefill_queue),
                           float(obs.decode_inflight)))
        self._hist = [h for h in self._hist if obs.t - h[0] <= self.window_s]
        conc_p = sum(h[1] for h in self._hist) / len(self._hist)
        conc_d = sum(h[2] for h in self._hist) / len(self._hist)
        i_p = max(math.ceil(conc_p / self.rp), 1)
        i_d = max(math.ceil(conc_d / self.rd), 1)
        i_p = self.hyst.apply("p", obs.cur_prefillers, i_p, obs.t)
        i_d = self.hyst.apply("d", obs.cur_decoders, i_d, obs.t)
        return ScaleDecision(i_p, i_d, live=True)


# ---------------------------------------------------------------------------
# Policy registry: uniform, string-keyed construction
# ---------------------------------------------------------------------------

#: name -> factory(prof, decode_prof, mean_in, mean_out, n_convertible, **kw)
POLICY_REGISTRY: dict[str, Callable[..., Policy]] = {}


def register_policy(name: str):
    """Register a policy factory under ``name`` so TokenScale, the §V
    baselines, and future policies are constructed uniformly from a
    declarative ``ExperimentSpec`` (``core.fleet``).  Factories receive
    the prefill pool's profile, the decode pool's profile (they differ on
    heterogeneous fleets), the trace's mean request sizes (Table I
    threshold derivations), and the convertible pool size."""
    def deco(factory):
        POLICY_REGISTRY[name] = factory
        factory.policy_name = name
        return factory
    return deco


def build_policy(name: str, prof: VelocityProfile,
                 decode_prof: Optional[VelocityProfile] = None,
                 mean_in: Optional[float] = None,
                 mean_out: Optional[float] = None,
                 n_convertible: int = 0, **options) -> Policy:
    """Construct a registered policy.  ``mean_in``/``mean_out`` are
    required and must be the *actual* trace's request-size statistics
    (``sim.traces.trace_stats``) — the baselines derive their Table I
    thresholds from them, and the historical hardcoded 1024/240 defaults
    mis-calibrated baselines on skewed traces."""
    try:
        factory = POLICY_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r}; registered policies: "
            f"{sorted(POLICY_REGISTRY)}")
    if mean_in is None or mean_out is None:
        raise ValueError(
            "build_policy needs the workload's request-size stats "
            "(mean_in/mean_out; see sim.traces.trace_stats) — hardcoded "
            "defaults mis-calibrate baseline thresholds on skewed traces")
    return factory(prof, decode_prof=decode_prof or prof,
                   mean_in=mean_in, mean_out=mean_out,
                   n_convertible=n_convertible, **options)


@register_policy("tokenscale")
def _build_tokenscale(prof, decode_prof, mean_in, mean_out,
                      n_convertible, **kw):
    del mean_in, mean_out     # velocity-native: no size-derived thresholds
    return TokenScalePolicy(prof, convertible=n_convertible,
                            decode_profile=decode_prof, **kw)


@register_policy("distserve")
def _build_distserve(prof, decode_prof, mean_in, mean_out,
                     n_convertible, **kw):
    # "uses a simulator to determine scaling thresholds" — capacity/size
    # with a 0.7 safety factor (which is exactly why it overprovisions
    # after bursts, §VI-A)
    del n_convertible
    return DistServePolicy(
        rps_per_prefiller=max(0.7 * prof.v_prefill / mean_in, 0.5),
        rps_per_decoder=max(
            0.5 * decode_prof.v_decode_mean() / (mean_in + mean_out), 0.5),
        **kw)


@register_policy("aibrix")
def _build_aibrix(prof, decode_prof, mean_in, mean_out,
                  n_convertible, **kw):
    # Table I: concurrency threshold = max prefill throughput / average
    # prefill length (in requests); decoder fixed at 70% memory util
    del decode_prof, mean_out, n_convertible
    return AIBrixPolicy(
        conc_per_prefiller=max(prof.v_prefill / mean_in * 0.5, 1.0),
        mem_util_target=0.7, **kw)


@register_policy("blitzscale")
def _build_blitzscale(prof, decode_prof, mean_in, mean_out,
                      n_convertible, **kw):
    # Table I: prefiller = avg prefill length / max prefill throughput;
    # decoder = available KVC memory / per-request footprint
    del mean_out, n_convertible
    return BlitzScalePolicy(
        req_per_prefiller=max(prof.v_prefill / mean_in * 0.5, 1.0),
        req_per_decoder=max(decode_prof.max_batch.get("M-M", 45) * 0.6, 4.0),
        **kw)
