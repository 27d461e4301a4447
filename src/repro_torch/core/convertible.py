"""Convertible Decoder management (§III-D, §IV-D).

A Convertible Decoder is a decoder whose gateway routing can flip to accept
prefill work in <1 ms (weights are shared).  The *restriction* that protects
the co-located decode pool:

  * chunk size     — largest chunk keeping mixed-iteration TPOT within SLO
                     (profiled offline; ``velocity.convertible_chunk_size``)
  * prefill speed  — Eq. (5): V_D^{P'} = (chunk - batch) / TPOT_SLO
  * reserved HBM   — Eq. (6): Mem_R = V_D^{P'} * Mem_T * TTFT_SLO
  * pool size      — offline: ceil(max decoders over the trace x burst
                     ratio); NOT dynamically scaled (§IV-C2)
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig
from repro_torch.core import hardware as hw
from repro_torch.core.hardware import InstanceSpec
from repro_torch.core.velocity import (convertible_chunk_size,
                                 convertible_prefill_velocity,
                                 reserved_memory)


@dataclass(frozen=True)
class ConvertibleConfig:
    chunk_size: int
    v_prefill: float          # Eq. (5)
    mem_reserved: float       # Eq. (6), bytes
    pool_size: int            # number of convertible decoders (fixed)


def plan_convertible(cfg: ModelConfig, inst: InstanceSpec,
                     expected_decode_batch: int, avg_ctx: float,
                     burst_ratio: float, max_decoders: int,
                     tpot_slo: float = 0.1,
                     ttft_slo: float = 0.4) -> ConvertibleConfig:
    """Offline planning for the convertible pool (§IV-C2 + §III-D)."""
    chunk = convertible_chunk_size(cfg, inst, expected_decode_batch,
                                   avg_ctx, tpot_slo)
    v_dp = convertible_prefill_velocity(chunk, expected_decode_batch,
                                        tpot_slo)
    mem_t = hw.kv_bytes_per_token(cfg)
    mem_r = reserved_memory(v_dp, mem_t, ttft_slo)
    pool = max(int(math.ceil(max_decoders * burst_ratio)), 1)
    return ConvertibleConfig(chunk_size=chunk, v_prefill=v_dp,
                             mem_reserved=mem_r, pool_size=pool)


def default_convertible_plan(cfg: ModelConfig, inst: InstanceSpec,
                             prof, max_decoders: int = 8
                             ) -> ConvertibleConfig:
    """The standard offline plan used by the experiment runner: expected
    decode batch = half the M-M SLO-feasible batch from the pool's own
    velocity profile, a mid-range context, and the §II-C burst-ratio
    constant the paper's evaluation uses.  Each convertible pool plans
    against *its own* (model, chip, tp) profile, so heterogeneous fleets
    restrict each pool correctly (Eq. 5-6).  ``max_decoders`` is the
    fleet's actual decode-pool ceiling (§IV-C2 sizes the pool as
    ceil(max decoders x burst ratio)); ``sim.runner.build_fleet`` plumbs
    the experiment's instance cap through, and the historical 8 remains
    the default for direct callers."""
    return plan_convertible(
        cfg, inst,
        expected_decode_batch=max(prof.max_batch.get("M-M", 16) // 2, 1),
        avg_ctx=1200.0, burst_ratio=0.2, max_decoders=max_decoders)


def spill_compatible(donor, recipient) -> bool:
    """Can idle boxes move between these two convertible pools?

    §IV-C2 sizes each convertible pool offline; a cross-model *loan*
    re-images a compatible box with the borrower's weights (paying the
    chip's startup latency) instead of provisioning a fresh instance.
    Compatibility is hardware identity — same chip and TP degree — so the
    borrower's offline Eq. 5-6 restriction plan applies to the borrowed
    box unchanged.  Duck-typed over ``chip``/``tp`` so both ``PoolSpec``
    and runtime pools qualify."""
    return (donor.chip == recipient.chip and donor.tp == recipient.tp
            and donor is not recipient)


def burst_ratio_of_trace(arrivals, window_s: float = 60.0,
                         factor: float = 1.0) -> float:
    """Fraction of tokens arriving above the running-average trendline
    (the §II-C burst definition, used to size the pool offline).

    The baseline for second *i* is the mean of the preceding ``window_s``
    seconds, *excluding* second i itself: a spike that joins its own
    trendline dampens the very signal it should trigger (a 10x second
    over a window of 10 raises its own baseline by ~2x).  Second 0 has no
    history and is never counted as burst.  Evaluated with cumulative
    sums — O(n) over the trace span instead of the historical
    O(n * window) Python loop (tests/test_bugfixes.py pins both the
    vectorization and the self-exclusion against a brute-force
    reference)."""
    import numpy as np
    arrivals = sorted(arrivals, key=lambda r: r[0])
    if not arrivals:
        return 0.0
    ts = np.array([a[0] for a in arrivals])
    toks = np.array([a[1] for a in arrivals], dtype=np.float64)
    t_end = ts.max() + 1e-9
    grid = np.arange(0.0, t_end + 1.0, 1.0)
    per_sec = np.zeros(len(grid))
    idx = np.clip(np.searchsorted(grid, ts, side="right") - 1, 0,
                  len(grid) - 1)
    np.add.at(per_sec, idx, toks)
    n = len(grid)
    i = np.arange(n)
    lo = np.maximum(0, i - int(window_s))
    # prefix[k] = per_sec[:k].sum(); baseline window is [lo, i) — strictly
    # before second i
    prefix = np.concatenate(([0.0], np.cumsum(per_sec)))
    count = (i - lo).astype(np.float64)
    avg = np.where(count > 0,
                   (prefix[i] - prefix[lo]) / np.maximum(count, 1.0),
                   np.inf)             # no history -> never above baseline
    burst_tok = float(np.maximum(per_sec - factor * avg, 0.0).sum())
    return float(burst_tok / max(toks.sum(), 1e-9))
