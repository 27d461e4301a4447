"""Trace exporters + the hand-rolled JSONL schema validator.

Two output shapes from one ``FlightRecorder``:

  * JSONL (``write_jsonl``) — one strict-JSON object per line, typed by a
    ``"type"`` field: ``meta``, ``decision``, ``event``, ``request``,
    ``metrics``, ``totals``.  This is the machine-readable form the
    explainer and the tests consume.
  * Chrome trace-event JSON (``write_chrome_trace``) — ``{"traceEvents":
    [...]}`` with complete ("X") span slices per request, instant ("i")
    point events, and counter ("C") tracks from the metrics samples.
    Loadable directly in Perfetto (https://ui.perfetto.dev) or
    ``chrome://tracing``; timestamps are microseconds of sim time.

``validate_jsonl`` / ``validate_trace_lines`` implement the schema check
without third-party dependencies (no jsonschema in the image): required
keys, value types, span-name vocabulary, per-request span-chain
contiguity (adjacent spans share their boundary timestamp).
"""
from __future__ import annotations

import json
import os
from typing import Iterable

from .recorder import SPAN_ORDER, FlightRecorder

TRACE_TYPES = ("meta", "decision", "event", "request", "metrics", "totals")


# ---------------------------------------------------------------------------
# JSONL
# ---------------------------------------------------------------------------

def trace_records(rec: FlightRecorder) -> list[dict]:
    """The full, deterministic record stream for one run: meta first,
    then decisions, point events, per-request records (arrival order),
    metrics samples, and the final totals rollup."""
    meta = {"type": "meta", "engine": rec.engine, "t_end": rec.t_end}
    meta.update(rec.meta)
    out = [meta]
    out.extend(rec.decisions)
    out.extend(rec.events)
    out.extend(sorted(rec.requests, key=lambda r: (r["t_arrival"],
                                                   r["rid"])))
    for row in rec.metrics.samples:
        m = {"type": "metrics"}
        m.update(row)
        out.append(m)
    out.append({"type": "totals", **rec.metrics.totals()})
    return out


def write_jsonl(rec: FlightRecorder, path: str) -> int:
    """Write the JSONL trace; returns the number of lines written."""
    records = trace_records(rec)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r, allow_nan=False) + "\n")
    return len(records)


def load_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------------------------------------------------------
# Chrome trace-event JSON (Perfetto)
# ---------------------------------------------------------------------------

_US = 1e6          # sim seconds -> trace microseconds

# process ids grouping the trace tracks in the Perfetto UI
_PID_REQUESTS = 1
_PID_EVENTS = 2
_PID_DECISIONS = 3
_PID_METRICS = 4


def chrome_trace(rec: FlightRecorder) -> dict:
    ev: list[dict] = []
    for pid, name in ((_PID_REQUESTS, "requests"),
                      (_PID_EVENTS, "point events"),
                      (_PID_DECISIONS, "scaling decisions"),
                      (_PID_METRICS, "metrics")):
        ev.append({"ph": "M", "name": "process_name", "pid": pid,
                   "args": {"name": name}})
    for r in rec.requests:
        for s in r["spans"]:
            ev.append({"ph": "X", "name": s["name"], "cat": "request",
                       "ts": s["t0"] * _US, "dur": s["dur"] * _US,
                       "pid": _PID_REQUESTS, "tid": r["rid"],
                       "args": {"rid": r["rid"], "model": r["model"],
                                "priority": r["priority"]}})
    for e in rec.events:
        args = {k: v for k, v in e.items() if k not in ("type", "t",
                                                        "kind")}
        ev.append({"ph": "i", "name": e["kind"], "cat": "event",
                   "ts": e["t"] * _US, "pid": _PID_EVENTS, "tid": 0,
                   "s": "g", "args": args})
    for d in rec.decisions:
        ev.append({"ph": "i", "name": "fleet_plan", "cat": "decision",
                   "ts": d["t"] * _US, "pid": _PID_DECISIONS, "tid": 0,
                   "s": "g", "args": {"plan": d["plan"]}})
    for row in rec.metrics.samples:
        for k, v in row.items():
            if k == "t" or not isinstance(v, (int, float)):
                continue
            ev.append({"ph": "C", "name": k, "ts": row["t"] * _US,
                       "pid": _PID_METRICS, "args": {k: v}})
    return {"traceEvents": ev, "displayTimeUnit": "ms"}


def write_chrome_trace(rec: FlightRecorder, path: str) -> int:
    doc = chrome_trace(rec)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, allow_nan=False)
    return len(doc["traceEvents"])


# ---------------------------------------------------------------------------
# schema validation (hand-rolled; no external deps)
# ---------------------------------------------------------------------------

def _num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _check_request(r: dict, where: str, errors: list[str]):
    for key, pred in (("rid", _num), ("t_arrival", _num),
                      ("in_len", _num), ("out_len", _num),
                      ("spans", lambda v: isinstance(v, list)),
                      ("finished", lambda v: isinstance(v, bool))):
        if key not in r or not pred(r[key]):
            errors.append(f"{where}: request missing/invalid {key!r}")
            return
    prev_t1 = None
    prev_idx = -1
    for s in r["spans"]:
        if (not isinstance(s, dict) or s.get("name") not in SPAN_ORDER
                or not _num(s.get("t0")) or not _num(s.get("t1"))):
            errors.append(f"{where}: malformed span {s!r}")
            return
        if s["t1"] < s["t0"]:
            errors.append(f"{where}: span {s['name']} has t1 < t0")
        idx = SPAN_ORDER.index(s["name"])
        if idx <= prev_idx:
            errors.append(f"{where}: span {s['name']} out of "
                          f"lifecycle order")
        if prev_t1 is not None and s["t0"] != prev_t1:
            errors.append(f"{where}: span chain gap before {s['name']} "
                          f"({s['t0']} != {prev_t1})")
        prev_t1, prev_idx = s["t1"], idx


def validate_trace_lines(records: Iterable[dict]) -> list[str]:
    """Validate parsed JSONL records; returns a list of human-readable
    schema violations (empty = valid)."""
    errors: list[str] = []
    records = list(records)
    if not records:
        return ["empty trace"]
    if records[0].get("type") != "meta":
        errors.append("line 1: first record must be type 'meta'")
    for i, r in enumerate(records):
        where = f"line {i + 1}"
        if not isinstance(r, dict):
            errors.append(f"{where}: not a JSON object")
            continue
        t = r.get("type")
        if t not in TRACE_TYPES:
            errors.append(f"{where}: unknown type {t!r}")
            continue
        if t == "meta":
            if not isinstance(r.get("engine"), str) or not _num(
                    r.get("t_end")):
                errors.append(f"{where}: meta needs engine:str, "
                              f"t_end:number")
        elif t == "decision":
            if (not _num(r.get("t"))
                    or not isinstance(r.get("plan"), dict)
                    or not isinstance(r.get("observation"), dict)
                    or not isinstance(r.get("inputs"), dict)):
                errors.append(f"{where}: decision needs t:number + "
                              f"plan/observation/inputs dicts")
        elif t == "event":
            if not _num(r.get("t")) or not isinstance(r.get("kind"), str):
                errors.append(f"{where}: event needs t:number, kind:str")
        elif t == "request":
            _check_request(r, where, errors)
        elif t == "metrics":
            if not _num(r.get("t")):
                errors.append(f"{where}: metrics sample needs t:number")
            else:
                bad = [k for k, v in r.items()
                       if k != "type" and not _num(v)]
                if bad:
                    errors.append(f"{where}: non-numeric metrics {bad}")
    return errors


def validate_jsonl(path: str) -> list[str]:
    """Parse + validate a JSONL trace file; returns schema violations
    (empty = valid).  JSON parse errors are reported per line instead of
    raising."""
    records: list[dict] = []
    errors: list[str] = []
    with open(path) as f:
        for i, line in enumerate(f):
            if not line.strip():
                continue
            try:
                records.append(json.loads(line))
            except ValueError as e:
                errors.append(f"line {i + 1}: invalid JSON ({e})")
    return errors + validate_trace_lines(records)
