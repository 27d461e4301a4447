"""Streaming metrics registry: counters, gauges, log-bucketed histograms.

The flight recorder (``obs.recorder``) owns one registry per run and
samples it on the engines' existing timeline cadence (every
``ClusterBase._snapshot``), so the metrics plane shares the snapshot
clock instead of inventing its own.  Nothing here is wired into the hot
path unless telemetry is on: the engines only touch the registry through
``FlightRecorder`` hooks that are guarded by ``cluster.obs is not None``.

All three instrument kinds are append-only and allocation-light:

  * ``Counter``   — monotonic float total (token velocities, drain counts);
  * ``Gauge``     — last-write-wins level (queue depth, KV occupancy);
  * ``Histogram`` — log2-bucketed value distribution (per-request TTFT,
    span durations) with exact count/sum, so means stay exact while the
    shape is O(#buckets) regardless of run length.
"""
from __future__ import annotations

import math


class Counter:
    """Monotonic total.  ``rate(t)`` windows are the caller's business:
    the registry snapshots raw totals and the sampler derives deltas."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, by: float = 1.0):
        self.value += by


class Gauge:
    """Last-write-wins level."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float):
        self.value = float(value)


class Histogram:
    """Log2-bucketed distribution over positive values.

    Bucket ``i`` covers ``[base * 2**i, base * 2**(i+1))``; values at or
    below ``base`` land in bucket 0's underflow.  Exact ``count``/``sum``
    ride along so means are not quantized."""

    __slots__ = ("base", "buckets", "count", "sum")

    def __init__(self, base: float = 1e-3):
        if base <= 0:
            raise ValueError("histogram base must be > 0")
        self.base = base
        self.buckets: dict[int, int] = {}
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float):
        self.count += 1
        self.sum += value
        i = 0
        if value > self.base:
            i = int(math.log2(value / self.base)) + 1
        self.buckets[i] = self.buckets.get(i, 0) + 1

    def quantile(self, q: float) -> float:
        """Upper edge of the bucket holding the q-quantile (0 with no
        observations) — a bounded-error order statistic, good enough for
        dashboards; exact tails come from the span records."""
        if not self.count:
            return 0.0
        target = max(int(math.ceil(q * self.count)), 1)
        seen = 0
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if seen >= target:
                return self.base * (2.0 ** i)
        return self.base * (2.0 ** max(self.buckets))

    def to_dict(self) -> dict:
        return {"count": self.count, "sum": self.sum,
                "base": self.base,
                "buckets": {str(k): v
                            for k, v in sorted(self.buckets.items())}}


class MetricsRegistry:
    """Name-keyed instruments + the timeline sampler.

    ``sample(t)`` appends one row per call: every counter's running total
    and every gauge's level, keyed by instrument name.  Rows are plain
    dicts so the exporter can stream them to JSONL unchanged."""

    def __init__(self):
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}
        self.samples: list[dict] = []

    # ---- instrument accessors (create-on-first-use) -------------------
    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge()
        return g

    def histogram(self, name: str, base: float = 1e-3) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(base)
        return h

    # ---- convenience mutators -----------------------------------------
    def inc(self, name: str, by: float = 1.0):
        self.counter(name).inc(by)

    def set(self, name: str, value: float):
        self.gauge(name).set(value)

    def observe(self, name: str, value: float):
        self.histogram(name).observe(value)

    # ---- sampling ------------------------------------------------------
    def sample(self, t: float) -> dict:
        row: dict = {"t": t}
        for name, c in self.counters.items():
            row[name] = c.value
        for name, g in self.gauges.items():
            row[name] = g.value
        self.samples.append(row)
        return row

    def totals(self) -> dict:
        """Final counter totals + histogram summaries (the run-level
        rollup the exporter appends after the last sample)."""
        out: dict = {name: c.value for name, c in self.counters.items()}
        for name, h in self.histograms.items():
            out[name] = h.to_dict()
        return out
