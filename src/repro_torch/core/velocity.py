"""Token Velocity (§III-B) and the Offline Profiler (§IV-B).

Token Velocity = the maximum number of tokens an instance can *release* per
second under its current resources.  Per stage:

  * V_P  prefill velocity   — GPU-compute bound, constant per (model, chip)
  * V_N  network velocity   — KVC transfer rate over the interconnect
  * V_D  decode velocity    — rate at which decoders free memory as requests
                              complete; Eq.(1): V_D = sum_r L_r / TPOT,
                              profiled per request bucket (Table II)

The profiler reproduces the paper's methodology: sweep the request rate
against an instance until the output rate saturates; the saturation point is
the stage velocity.  Our "instance" is the analytic step-latency model in
``core.hardware`` (same roofline the JAX dry-run reports), and optionally a
real ``serving.Engine`` on CPU for reduced models.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

from repro_torch.configs.base import ModelConfig
from repro_torch.core import hardware as hw
from repro_torch.core.hardware import InstanceSpec

# ---------------------------------------------------------------------------
# Request buckets (Table II): input x output length classes
# ---------------------------------------------------------------------------

BUCKET_INPUT = {"S": 256, "M": 1024, "L": 8192}
BUCKET_OUTPUT = {"S": 100, "M": 350, "L": 610}
BUCKETS = [f"{i}-{o}" for i in "SML" for o in "SML"]


def bucket_of(in_len: int, out_len: int) -> str:
    i = "S" if in_len <= 256 else ("M" if in_len <= 1024 else "L")
    o = "S" if out_len <= 100 else ("M" if out_len <= 350 else "L")
    return f"{i}-{o}"


def bucket_lengths(bucket: str) -> tuple[int, int]:
    i, o = bucket.split("-")
    return BUCKET_INPUT[i], BUCKET_OUTPUT[o]


@dataclass(frozen=True)
class VelocityProfile:
    """Offline-profiled Token Velocities for one (model, instance) pair."""
    model: str
    chip: str
    tp: int
    v_prefill: float                    # tok/s
    v_network: float                    # tok/s
    v_decode: dict[str, float]          # bucket -> tok/s (Eq. 1)
    max_batch: dict[str, int]           # bucket -> HBM-bound batch
    tpot: dict[str, float]              # bucket -> iteration time at peak

    def v_decode_mean(self) -> float:
        return sum(self.v_decode.values()) / len(self.v_decode)


# ---------------------------------------------------------------------------
# Offline profiler
# ---------------------------------------------------------------------------

def profile_prefill_velocity(cfg: ModelConfig, inst: InstanceSpec,
                             probe_tokens: int = 8192) -> float:
    """Saturation sweep: raise the offered token rate until the instance's
    completion rate stops following it; that plateau is V_P."""
    t = hw.prefill_time(cfg, inst, probe_tokens)
    peak = probe_tokens / t
    # sweep (paper methodology): offered rate doubles until completion
    # rate saturates at `peak`
    offered, completed = probe_tokens / 4.0, 0.0
    while True:
        completed = min(offered, peak)
        if completed < offered:
            return completed
        offered *= 2.0


def profile_network_velocity(cfg: ModelConfig, inst: InstanceSpec) -> float:
    """Max token transmission rate prefiller -> decoder (KVC bytes/s /
    bytes-per-token)."""
    per_tok = hw.kv_bytes_per_token(cfg)
    if per_tok <= 0.0:
        # attention-free (SSM): only the O(1) recurrent state crosses the
        # wire — network velocity is effectively unbounded; return the rate
        # at which whole-request states can stream assuming 1k-token reqs.
        st = hw.state_bytes_fixed(cfg)
        return inst.chip.net_bw / max(st, 1.0) * 1000.0
    return inst.chip.net_bw / per_tok


def profile_decode_velocity(cfg: ModelConfig, inst: InstanceSpec,
                            bucket: str, tpot_slo: float = 0.1,
                            hbm_frac: float = 0.9) -> tuple[float, int, float]:
    """Per-bucket V_D (Eq. 1) at the largest SLO-feasible batch.

    Sweeps batch (the request-rate sweep's steady-state equivalent) until
    either HBM is exhausted or TPOT crosses the SLO; returns
    (v_decode, batch, tpot).  L_r counts the tokens whose memory a
    completion releases (input + output).  ``hbm_frac`` is the pool's
    usable-HBM fraction — the profiled capacity bound must match what the
    pool's decoders actually enforce."""
    in_len, out_len = bucket_lengths(bucket)
    avg_ctx = in_len + out_len / 2.0
    b_mem = hw.max_batch(cfg, inst, in_len + out_len, hbm_frac=hbm_frac)
    best = (0.0, 0, 0.0)
    b = 1
    while b <= max(b_mem, 1):
        tpot = hw.decode_iter_time(cfg, inst, b, avg_ctx)
        if tpot > tpot_slo and best[1] > 0:
            break
        # steady state: b/out_len completions per iteration, each releasing
        # (in+out) tokens => V_D = b * (in+out) / (out * TPOT)
        v = b * (in_len + out_len) / (out_len * max(tpot, 1e-9))
        best = (v, b, tpot)
        b = b * 2 if b < 64 else b + 64
    return best


def profile(cfg: ModelConfig, inst: InstanceSpec,
            tpot_slo: float = 0.1, hbm_frac: float = 0.9) -> VelocityProfile:
    v_d, mb, tp = {}, {}, {}
    for b in BUCKETS:
        v, batch, tpot = profile_decode_velocity(cfg, inst, b, tpot_slo,
                                                 hbm_frac)
        v_d[b], mb[b], tp[b] = v, batch, tpot
    return VelocityProfile(
        model=cfg.name, chip=inst.chip.name, tp=inst.tp,
        v_prefill=profile_prefill_velocity(cfg, inst),
        v_network=profile_network_velocity(cfg, inst),
        v_decode=v_d, max_batch=mb, tpot=tp)


@lru_cache(maxsize=None)
def profile_for(model: str, chip: str, tp: int = 1,
                tpot_slo: float = 0.1,
                hbm_frac: float = 0.9) -> VelocityProfile:
    """Cached profiler entry by pool key — Token Velocity is defined per
    (model, chip, tp) tuple (§III-B), and a heterogeneous fleet profiles
    each of its pools once, not once per experiment.  ``hbm_frac`` joins
    the cache key so a pool with a non-default usable-HBM fraction gets a
    profile whose Eq. 1/Eq. 3 capacity bounds match its own decoders."""
    from repro_torch.configs import get_config
    from repro_torch.core.hardware import CHIPS
    return profile(get_config(model), InstanceSpec(CHIPS[chip], tp=tp),
                   tpot_slo, hbm_frac)


# ---------------------------------------------------------------------------
# Convertible-decoder quantities (§III-D, Eq. 5-6)
# ---------------------------------------------------------------------------

def convertible_chunk_size(cfg: ModelConfig, inst: InstanceSpec,
                           decode_batch: int, avg_ctx: float,
                           tpot_slo: float = 0.1,
                           align: int = 128) -> int:
    """Largest prefill chunk a Convertible Decoder can co-schedule while the
    mixed iteration stays within the TPOT SLO (profiled by growing the chunk
    until violation, as §III-D)."""
    lo = 0
    c = align
    while True:
        t = mixed_iter_time(cfg, inst, decode_batch, avg_ctx, c)
        if t > tpot_slo:
            return lo
        lo = c
        c += align
        if c > 65536:
            return lo


def mixed_iter_time(cfg: ModelConfig, inst: InstanceSpec, decode_batch: int,
                    avg_ctx: float, chunk: int) -> float:
    """One co-located iteration: decode batch + `chunk` prefill tokens."""
    f = (decode_batch * (hw.flops_per_token(cfg)
                         + hw.attn_flops_per_token(cfg, avg_ctx))
         + chunk * (hw.flops_per_token(cfg)
                    + hw.attn_flops_per_token(cfg, chunk / 2)))
    mem = (hw.active_weight_bytes(cfg)
           + decode_batch * (hw.kv_bytes_per_token(cfg) * avg_ctx
                             + hw.state_bytes_fixed(cfg))
           + chunk * hw.kv_bytes_per_token(cfg))
    return max(f / inst.flops, mem / inst.hbm_bw)


def convertible_prefill_velocity(chunk_size: int, decode_batch: int,
                                 tpot_slo: float = 0.1) -> float:
    """Eq. (5): V_D^{P'} = (chunk_size - batch_size) / TPOT_SLO."""
    return max(chunk_size - decode_batch, 0) / tpot_slo


def reserved_memory(v_dp: float, mem_per_token: float,
                    ttft_slo: float) -> float:
    """Eq. (6): Mem_reserved = V_D^{P'} * Mem_T * TTFT_SLO."""
    return v_dp * mem_per_token * ttft_slo


# ---------------------------------------------------------------------------
# Chunked prefill / deflection quantities (§III-D at iteration granularity)
# ---------------------------------------------------------------------------

def headroom_chunk_tokens(f_iter: float, mem_iter: float,
                          flops_tok: float, kv_tok: float,
                          flops: float, hbm_bw: float,
                          tpot_budget: float, cap: float) -> float:
    """Eq. 5's headroom evaluated *online* against the live batch: the
    largest prefill chunk (whole tokens) a decoder can co-schedule in its
    next iteration while the mixed iteration stays within ``tpot_budget``.

    ``f_iter``/``mem_iter`` are the decode-only iteration's roofline terms
    (FLOPs, bytes); each chunk token adds ``flops_tok`` FLOPs and
    ``kv_tok`` KV-write bytes, so the roofline bound
    ``max((mem_iter + c*kv_tok)/hbm_bw, (f_iter + c*flops_tok)/flops)`` is
    monotone in ``c`` and the budget inverts in closed form — no profiling
    sweep on the hot path."""
    c_fl = (tpot_budget * flops - f_iter) / max(flops_tok, 1e-12)
    if kv_tok > 0:
        c_mem = (tpot_budget * hbm_bw - mem_iter) / kv_tok
    else:                       # attention-free: no KV bytes per token
        c_mem = float("inf")
    return float(int(max(min(cap, c_fl, c_mem), 0.0)))


def chunked_prefill_velocity(chunk_tokens: float, mixed_iter_t: float
                             ) -> float:
    """Steady-state absorption rate (tok/s) of chunk-interleaved prefill:
    one chunk per mixed iteration.  This is the per-iteration analogue of
    Eq. 5's V_D^{P'} (which assumes the iteration takes exactly TPOT_SLO)."""
    if chunk_tokens <= 0 or mixed_iter_t <= 0:
        return 0.0
    return chunk_tokens / mixed_iter_t


# ---------------------------------------------------------------------------
# Cost-normalized velocity (tokens per dollar) — the placement metric the
# coordinated fleet planner ranks heterogeneous pools by: among pools that
# can serve the same demand, the one releasing the most tokens per dollar
# absorbs first (DistServe's goodput-per-GPU framing, priced per chip).
# ---------------------------------------------------------------------------

def instance_cost_rate(chip: str, tp: int) -> float:
    """$/s of one (chip, tp) instance — ``ChipSpec.cost_per_hour`` times
    the TP degree, the same weighting the billing integral applies."""
    from repro_torch.core.hardware import CHIPS
    return CHIPS[chip].cost_per_hour * tp / 3600.0


def prefill_tokens_per_dollar(prof: VelocityProfile) -> float:
    """Cost-normalized effective prefill velocity (tokens per dollar):
    Eq. 2's min(V_P, V_N) divided by the instance's $/s rate."""
    rate = instance_cost_rate(prof.chip, prof.tp)
    return min(prof.v_prefill, prof.v_network) / max(rate, 1e-12)


def decode_tokens_per_dollar(prof: VelocityProfile,
                             bucket: str = None) -> float:
    """Cost-normalized decode velocity (tokens per dollar), per bucket or
    averaged across Table II's buckets when ``bucket`` is None."""
    rate = instance_cost_rate(prof.chip, prof.tp)
    v = prof.v_decode[bucket] if bucket else prof.v_decode_mean()
    return v / max(rate, 1e-12)


def deflected_prefill_rate(decoders, window_s: float = 1.0) -> float:
    """Aggregate prefill-token rate (tok/s) the decode side is absorbing
    through chunked deflection right now: for each decoder with queued
    chunk work, the smaller of its absorption velocity and the work it
    actually holds (a queue of 40 tokens cannot absorb 4000 tok/s for the
    whole window).  ``TokenScalePolicy.decide`` subtracts this from Eq. 2's
    arrival rate so partially-prefilled requests contribute only the
    fraction the prefill pool still owes."""
    total = 0.0
    for d in decoders:
        if not d.prefill_q:
            continue
        v = d.deflect_velocity()
        if v > 0:
            total += min(v, d.inflight_tokens() / max(window_s, 1e-9))
    return total
