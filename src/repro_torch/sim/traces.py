"""Synthetic production-like traces (§V Workload Generation).

The paper replays Azure LLM inference traces [35] and BurstGPT [38].  Those
datasets are not available offline, so we generate traces with the published
summary statistics:

  * burstiness: the system is in a burst ~47% of operational time, mean
    burst duration 2.3 s (§I) — modeled as an ON/OFF modulated Poisson
    process (OFF ~ Exp(2.6 s), ON ~ Exp(2.3 s), ON rate multiplier 2-6x);
  * Azure *Conversation*: medium prompts / medium outputs;
  * Azure *Code*: long prompts / short outputs;
  * BurstGPT 1/2: shorter prompts, heavier burst multipliers;
  * *Mixed*: equal-rate mixture (the paper's third workload).

Lengths are lognormal, clipped to the Table II bucket range [32, 8192] /
[16, 640].  Everything is deterministic in the seed.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator

import numpy as np


#: priority classes (lower = more urgent); canonical scales live in
#: core.router.  The default mix models a mixed-criticality production
#: tenant: a latency-critical slice, a standard bulk, and batch traffic.
PRIORITY_CLASSES = {"interactive": 0, "standard": 1, "batch": 2}
DEFAULT_PRIORITY_MIX = {0: 0.2, 1: 0.6, 2: 0.2}


@dataclass(slots=True)
class TraceRequest:
    rid: int
    t: float
    in_len: int
    out_len: int
    priority: int = 1          # PRIORITY_CLASSES["standard"]
    model: str = ""            # "" = the fleet's default model; multi-model
                               # fleets tag each request with its route's
                               # model (core.fleet.TraceRoute)
    session: int = -1          # conversation id (-1 = single-turn); set by
                               # assign_sessions
    prefix_len: int = 0        # leading prompt tokens shared with the
                               # session's context (prior prompt + output) —
                               # what the KV prefix cache can reuse
    shared_id: int = -1        # catalog id of the Zipf-popular system
                               # prompt this request opens with (-1 = none);
                               # set by assign_shared_prefixes
    shared_len: int = 0        # leading prompt tokens covered by that
                               # shared system prompt — reusable *across*
                               # sessions (what the gateway hashtrie sees)


@dataclass(frozen=True)
class TraceStats:
    """Request-size statistics of an actual trace — what the baseline
    policies' Table I threshold derivations must be calibrated from
    (hardcoded means mis-calibrate them on skewed traces)."""
    mean_in: float
    mean_out: float
    n: int


def trace_stats(reqs: list[TraceRequest],
                default_in: float = 1024.0,
                default_out: float = 240.0) -> TraceStats:
    """Mean prompt/output lengths of ``reqs`` (falling back to the
    historical Table II-ish defaults only for an empty trace)."""
    mean_in = (sum(r.in_len for r in reqs) / max(len(reqs), 1)) \
        or default_in
    mean_out = (sum(r.out_len for r in reqs) / max(len(reqs), 1)) \
        or default_out
    return TraceStats(mean_in=mean_in, mean_out=mean_out, n=len(reqs))


@dataclass(frozen=True)
class TraceSpec:
    name: str
    in_mean: float            # lognormal mean of prompt tokens
    in_sigma: float
    out_mean: float
    out_sigma: float
    burst_mult_lo: float = 2.0
    burst_mult_hi: float = 6.0
    burst_on_mean: float = 2.3     # §I: mean burst duration
    burst_off_mean: float = 2.6    # -> ~47% of time bursting


TRACES: dict[str, TraceSpec] = {
    "azure_conv": TraceSpec("azure_conv", in_mean=1024, in_sigma=0.9,
                            out_mean=240, out_sigma=0.7),
    "azure_code": TraceSpec("azure_code", in_mean=2048, in_sigma=0.8,
                            out_mean=80, out_sigma=0.6,
                            burst_mult_lo=2.0, burst_mult_hi=4.0),
    "burstgpt1": TraceSpec("burstgpt1", in_mean=512, in_sigma=1.0,
                           out_mean=300, out_sigma=0.8,
                           burst_mult_lo=3.0, burst_mult_hi=8.0),
    "burstgpt2": TraceSpec("burstgpt2", in_mean=640, in_sigma=1.1,
                           out_mean=350, out_sigma=0.9,
                           burst_mult_lo=4.0, burst_mult_hi=10.0),
}


def _lognormal(rng, mean, sigma, lo, hi, size):
    mu = np.log(mean) - sigma ** 2 / 2.0
    return np.clip(rng.lognormal(mu, sigma, size), lo, hi).astype(int)


#: prime salts for the independent RNG substreams layered over a seeded
#: trace.  Each decorating pass (and the fault injector) derives its own
#: stream from the base seed + a distinct prime, so turning any knob on
#: never perturbs the arrival times or lengths — nor any *other* knob's
#: draws — of an existing trace.
SALT_PRIORITY = 104729
SALT_SESSION = 15485863
SALT_SHARED_PREFIX = 2750159
SALT_FAULTS = 6291469


def substream(seed: int, salt: int) -> np.random.RandomState:
    """An RNG stream independent of the base trace stream (and of every
    other salt's stream): ``RandomState((seed + salt) % 2**31)``.  The
    construction is part of the byte-identical-goldens contract — all
    existing decorator streams were built exactly this way, so routing
    them through this helper changes no draw."""
    return np.random.RandomState((seed + salt) % (2 ** 31))


def assign_priorities(reqs: list[TraceRequest],
                      priority_mix: dict[int, float] | None,
                      seed: int = 0) -> list[TraceRequest]:
    """Draw per-request priority classes in place.  The draw uses an
    *independent* RNG stream, so adding a mix never perturbs the arrival
    times or lengths of an existing seeded trace."""
    if not priority_mix:
        return reqs
    classes = sorted(priority_mix)
    w = np.array([priority_mix[c] for c in classes], dtype=float)
    w /= w.sum()
    rng = substream(seed, SALT_PRIORITY)
    draws = rng.choice(len(classes), size=len(reqs), p=w)
    for r, k in zip(reqs, draws):
        r.priority = int(classes[k])
    return reqs


def assign_sessions(reqs: list[TraceRequest], session_prob: float,
                    seed: int = 0, think_s: float = 2.0,
                    max_open: int = 64) -> list[TraceRequest]:
    """Group arrivals into multi-turn sessions in place (§V conversational
    workloads): each request joins an open session with probability
    ``session_prob`` — its prompt then *extends the shared prefix* (prior
    prompt + response), recorded as ``prefix_len`` — or opens a new one.

    Only ``session``/``prefix_len`` are written: arrival times and lengths
    stay byte-identical, and the draw uses an *independent* RNG stream
    (like ``assign_priorities``), so adding the knob never perturbs an
    existing seeded trace.  A session is joinable once its previous turn is
    at least ``think_s`` old (user think time); at most ``max_open``
    sessions stay joinable (oldest retired first)."""
    if session_prob <= 0.0:
        return reqs
    rng = substream(seed, SALT_SESSION)
    open_sessions: list[list] = []   # [sid, last_t, kv_len]
    next_sid = 0
    for r in sorted(reqs, key=lambda r: (r.t, r.rid)):
        ready = [s for s in open_sessions if r.t - s[1] >= think_s]
        if ready and rng.uniform() < session_prob:
            s = ready[rng.randint(len(ready))]
            r.session = s[0]
            # the follow-up prompt extends the session context; a shorter
            # drawn prompt is simply fully covered by it
            r.prefix_len = min(s[2], r.in_len)
        else:
            r.session, r.prefix_len = next_sid, 0
            next_sid += 1
            open_sessions.append([r.session, r.t, 0])
            if len(open_sessions) > max_open:
                open_sessions.pop(0)
            s = open_sessions[-1]
        # next turn's shared context = this prompt + this response
        s[1], s[2] = r.t, r.in_len + r.out_len
    return reqs


def assign_shared_prefixes(reqs: list[TraceRequest], prob: float,
                           seed: int = 0, prefix_len: int = 512,
                           n_prompts: int = 8,
                           zipf_a: float = 1.2) -> list[TraceRequest]:
    """Mark arrivals as opening with a Zipf-popular system prompt in place
    — the cross-session prefix reuse today's per-session chains cannot
    express (one hot system prompt shared by *many* conversations, the
    workload the KV-locality gateway routes on).

    A catalog of ``n_prompts`` system prompts is drawn once (lengths
    around ``prefix_len``); each conversation opener (or sessionless
    arrival) starts from catalog prompt ``k`` with probability ``prob``,
    ``k`` Zipf-distributed with exponent ``zipf_a`` so a couple of
    prompts dominate.  Follow-up turns inherit their opener's prompt (a
    conversation keeps its system prompt).  Only ``shared_id`` /
    ``shared_len`` are written, and the draw uses an *independent* RNG
    stream (like ``assign_priorities`` / ``assign_sessions``), so adding
    the knob never perturbs an existing seeded trace."""
    if prob <= 0.0:
        return reqs
    rng = substream(seed, SALT_SHARED_PREFIX)
    lens = rng.randint(max(prefix_len // 2, 1),
                       prefix_len + prefix_len // 2 + 1, size=n_prompts)
    w = 1.0 / np.arange(1, n_prompts + 1) ** zipf_a
    w /= w.sum()
    by_session: dict[int, tuple[int, int]] = {}   # sid -> (pid, eff_len)
    for r in sorted(reqs, key=lambda r: (r.t, r.rid)):
        if r.session >= 0 and r.session in by_session:
            pid, eff = by_session[r.session]      # follow-up: inherit
        elif rng.uniform() < prob:
            pid = int(rng.choice(n_prompts, p=w))
            eff = int(lens[pid])
        else:
            pid, eff = -1, 0
        if r.session >= 0 and r.session not in by_session:
            by_session[r.session] = (pid, eff)
        if pid >= 0:
            r.shared_id = pid
            r.shared_len = min(eff, r.in_len)
    return reqs


def burst_phases(spec: TraceSpec, duration_s: float,
                 rng) -> list[tuple[float, float, float]]:
    """The ON/OFF burst timeline as (start, end, rate-multiplier) phases.
    Long-run ON duty cycle is on_mean / (on_mean + off_mean) — ~47% with
    the paper's 2.3 s / 2.6 s constants (§I)."""
    t, phases = 0.0, []
    while t < duration_s:
        off = rng.exponential(spec.burst_off_mean)
        on = rng.exponential(spec.burst_on_mean)
        mult = rng.uniform(spec.burst_mult_lo, spec.burst_mult_hi)
        phases.append((t, t + off, 1.0))
        phases.append((t + off, t + off + on, mult))
        t += off + on
    return phases


def generate(spec: TraceSpec, duration_s: float, rps: float,
             seed: int = 0,
             priority_mix: dict[int, float] | None = None,
             session_prob: float = 0.0,
             shared_prefix_prob: float = 0.0,
             shared_prefix_len: int = 512,
             shared_prefix_count: int = 8
             ) -> list[TraceRequest]:
    """ON/OFF modulated Poisson arrivals with lognormal lengths."""
    rng = np.random.RandomState(seed)
    phases = burst_phases(spec, duration_s, rng)
    # thinning: draw at the max rate, accept by local multiplier
    max_mult = spec.burst_mult_hi
    base = rps / (1.0 + 0.47 * (spec.burst_mult_lo + spec.burst_mult_hi) / 2.0
                  - 0.47)  # normalize so the long-run average ~= rps
    base = max(base, 0.1)
    lam = base * max_mult
    n_candidates = rng.poisson(lam * duration_s)
    times = np.sort(rng.uniform(0, duration_s, n_candidates))
    mults = np.ones_like(times)
    for (s, e, m) in phases:
        mults[(times >= s) & (times < e)] = m
    accept = rng.uniform(0, max_mult, len(times)) < mults
    times = times[accept]
    n = len(times)
    ins = _lognormal(rng, spec.in_mean, spec.in_sigma, 32, 8192, n)
    outs = _lognormal(rng, spec.out_mean, spec.out_sigma, 16, 640, n)
    reqs = [TraceRequest(i, float(times[i]), int(ins[i]), int(outs[i]))
            for i in range(n)]
    assign_priorities(reqs, priority_mix, seed)
    assign_sessions(reqs, session_prob, seed)
    return assign_shared_prefixes(reqs, shared_prefix_prob, seed,
                                  prefix_len=shared_prefix_len,
                                  n_prompts=shared_prefix_count)


def generate_mixed(duration_s: float, rps: float, seed: int = 0,
                   priority_mix: dict[int, float] | None = None,
                   session_prob: float = 0.0,
                   shared_prefix_prob: float = 0.0,
                   shared_prefix_len: int = 512,
                   shared_prefix_count: int = 8
                   ) -> list[TraceRequest]:
    """The paper's Mixed trace: conv + code + BurstGPT 1/2 at equal rates."""
    parts = []
    for i, name in enumerate(["azure_conv", "azure_code",
                              "burstgpt1", "burstgpt2"]):
        parts += generate(TRACES[name], duration_s, rps / 4.0, seed + i,
                          priority_mix=priority_mix)
    parts.sort(key=lambda r: r.t)
    for i, r in enumerate(parts):
        r.rid = i
    # sessions (and shared prompts) are drawn over the merged arrival order
    # (conversations are a property of the workload, not of one component
    # trace)
    assign_sessions(parts, session_prob, seed)
    return assign_shared_prefixes(parts, shared_prefix_prob, seed,
                                  prefix_len=shared_prefix_len,
                                  n_prompts=shared_prefix_count)


def get_trace(name: str, duration_s: float = 120.0, rps: float = 8.0,
              seed: int = 0,
              priority_mix: dict[int, float] | None = None,
              session_prob: float = 0.0,
              shared_prefix_prob: float = 0.0,
              shared_prefix_len: int = 512,
              shared_prefix_count: int = 8
              ) -> list[TraceRequest]:
    kw = dict(priority_mix=priority_mix, session_prob=session_prob,
              shared_prefix_prob=shared_prefix_prob,
              shared_prefix_len=shared_prefix_len,
              shared_prefix_count=shared_prefix_count)
    if name == "mixed":
        return generate_mixed(duration_s, rps, seed, **kw)
    return generate(TRACES[name], duration_s, rps, seed, **kw)


def stream_trace(name: str, duration_s: float, rps: float, seed: int = 0,
                 chunk_s: float = 300.0,
                 priority_mix: dict[int, float] | None = None
                 ) -> Iterator[TraceRequest]:
    """Yield arrivals in time order without materializing the whole trace.

    Million-request, multi-hour workloads (``benchmarks/perf.py``'s
    perfscale suite) would hold the entire request list — and, with the
    historical eager pre-push, the entire event heap — in memory at once.
    This generator produces the workload in ``chunk_s``-long windows:
    each chunk is an independent seeded ``generate`` (seed stream
    ``seed + 31 * i``) shifted to its window start, so the stream is
    deterministic in ``seed``, has the same ON/OFF burst structure and
    lognormal lengths per window, and the consumer (``EventCluster.run``
    feeds arrivals lazily) keeps only live requests resident.

    Request ids are globally sequential.  Note the chunk boundary resets
    the burst phase (each window draws its own ON/OFF timeline) — fine
    for throughput/scale benches; use ``generate`` when a single
    continuous burst process matters."""
    spec = TRACES[name]
    rid = 0
    t0 = 0.0
    i = 0
    while t0 < duration_s:
        horizon = min(chunk_s, duration_s - t0)
        part = generate(spec, horizon, rps, seed + 31 * i,
                        priority_mix=priority_mix)
        for r in part:
            r.rid = rid
            r.t += t0
            rid += 1
            yield r
        t0 += horizon
        i += 1


def varying_rate_trace(segments: list[tuple[float, float]],
                       spec: TraceSpec = TRACES["azure_conv"],
                       seed: int = 0,
                       priority_mix: dict[int, float] | None = None,
                       session_prob: float = 0.0,
                       shared_prefix_prob: float = 0.0,
                       shared_prefix_len: int = 512,
                       shared_prefix_count: int = 8
                       ) -> list[TraceRequest]:
    """Piecewise-rate workload (large-scale load swings; used by the
    provisioned-vs-required correlation study, Fig. 11)."""
    out: list[TraceRequest] = []
    t0 = 0.0
    for i, (dur, rps) in enumerate(segments):
        part = generate(spec, dur, rps, seed + 7 * i)
        for r in part:
            r.t += t0
        out += part
        t0 += dur
    out.sort(key=lambda r: r.t)
    for i, r in enumerate(out):
        r.rid = i
    assign_priorities(out, priority_mix, seed)
    assign_sessions(out, session_prob, seed)
    return assign_shared_prefixes(out, shared_prefix_prob, seed,
                                  prefix_len=shared_prefix_len,
                                  n_prompts=shared_prefix_count)


def step_trace(duration_s: float, base_rps: float, burst_rps: float,
               burst_start: float, burst_len: float,
               spec: TraceSpec = TRACES["azure_conv"],
               seed: int = 0,
               priority_mix: dict[int, float] | None = None,
               session_prob: float = 0.0,
               shared_prefix_prob: float = 0.0,
               shared_prefix_len: int = 512,
               shared_prefix_count: int = 8
               ) -> list[TraceRequest]:
    """Deterministic-rate step trace (Fig. 10: 1 -> 10 RPS at t=10 s)."""
    rng = np.random.RandomState(seed)
    reqs, t, rid = [], 0.0, 0
    while t < duration_s:
        rate = burst_rps if burst_start <= t < burst_start + burst_len \
            else base_rps
        t += rng.exponential(1.0 / rate)
        if t >= duration_s:
            break
        in_len = int(_lognormal(rng, spec.in_mean, spec.in_sigma,
                                32, 8192, 1)[0])
        out_len = int(_lognormal(rng, spec.out_mean, spec.out_sigma,
                                 16, 640, 1)[0])
        reqs.append(TraceRequest(rid, t, in_len, out_len))
        rid += 1
    assign_priorities(reqs, priority_mix, seed)
    assign_sessions(reqs, session_prob, seed)
    return assign_shared_prefixes(reqs, shared_prefix_prob, seed,
                                  prefix_len=shared_prefix_len,
                                  n_prompts=shared_prefix_count)
