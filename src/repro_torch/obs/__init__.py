"""Flight-recorder observability layer.

Default-off: engines carry a single ``obs = None`` attribute and every
hook is guarded by an ``is not None`` test, so disabled telemetry is
byte-identical and effectively zero-overhead.  Enable per run with
``ExperimentSpec(telemetry=True)`` or ``benchmarks/run.py
--trace-out=PATH``; see README "Observability" for the quickstart.
"""
from .explain import explain, render_report
from .export import (chrome_trace, load_jsonl, trace_records,
                     validate_jsonl, validate_trace_lines,
                     write_chrome_trace, write_jsonl)
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .recorder import (SPAN_ORDER, TTFT_STAGE_LABELS, FlightRecorder,
                       jsonable, request_spans)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "FlightRecorder", "SPAN_ORDER", "TTFT_STAGE_LABELS",
    "jsonable", "request_spans",
    "trace_records", "write_jsonl", "load_jsonl",
    "chrome_trace", "write_chrome_trace",
    "validate_jsonl", "validate_trace_lines",
    "explain", "render_report",
]
