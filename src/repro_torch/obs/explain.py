"""Scaling-decision explainer + SLO-violation attribution.

Consumes a flight-recorder JSONL trace (``obs.export.write_jsonl``) and
answers the two questions the paper's evaluation keeps asking:

  1. *Why did the planner scale pool P to N at time t?*  Every recorded
     decision carries the full Eq. 2-4 inputs (observed token rates,
     deflected rate, effective velocities, per-bucket decode needs,
     convertible loans, cost ranking), so the report reconstructs the
     arithmetic instead of guessing from aggregates.
  2. *Which stage made request R miss its TTFT SLO?*  Each violating
     request is attributed to its dominant TTFT-side span: queueing vs
     prefill vs KVC transfer vs decode backpressure.

Usage:

    PYTHONPATH=src python -m repro_torch.obs.explain trace.jsonl
    PYTHONPATH=src python -m repro_torch.obs.explain trace.jsonl --json
"""
from __future__ import annotations

import argparse
import json
import math
from typing import Optional

from .recorder import TTFT_STAGE_LABELS


# ---------------------------------------------------------------------------
# machine-readable report
# ---------------------------------------------------------------------------

def _model_inputs(inputs: dict, model: str) -> dict:
    """The Eq. 2-4 debug block for one model, from a policy
    ``last_debug`` payload (flat and coordinated policies both nest
    per-model blocks under "models")."""
    models = inputs.get("models")
    if isinstance(models, dict):
        return models.get(model, models.get("", {})) or {}
    return inputs


def scale_changes(records: list[dict]) -> list[dict]:
    """Every pool whose planned target differs from its observed
    provisioned count, with the decision's Eq. 2-4 inputs attached."""
    out = []
    for d in records:
        if d.get("type") != "decision":
            continue
        pools = d.get("observation", {}).get("pools", {})
        inputs = d.get("inputs", {})
        for pool, target in d.get("plan", {}).get("targets", {}).items():
            snap = pools.get(pool, {})
            cur = snap.get("count")
            if cur is None or target == cur:
                continue
            model = snap.get("model", "")
            out.append({
                "t": d["t"], "pool": pool, "model": model,
                "role": snap.get("role", ""),
                "from": cur, "to": target,
                "direction": "up" if target > cur else "down",
                "live": pool in d.get("plan", {}).get("live", []),
                "drain": pool in d.get("plan", {}).get("drain", []),
                "spills": d.get("plan", {}).get("spills", []),
                "inputs": _model_inputs(inputs, model),
            })
    return out


def ttft_violations(records: list[dict]) -> list[dict]:
    """Finished requests whose TTFT exceeds their SLO, attributed to the
    dominant TTFT-side span."""
    out = []
    for r in records:
        if r.get("type") != "request" or not r.get("finished"):
            continue
        ttft, slo = r.get("ttft"), r.get("ttft_slo")
        if ttft is None or slo is None or ttft <= slo:
            continue
        ttft_spans = {s["name"]: s["dur"] for s in r["spans"]
                      if s["name"] in TTFT_STAGE_LABELS}
        if not ttft_spans:
            continue
        dominant = max(ttft_spans, key=lambda k: ttft_spans[k])
        out.append({"rid": r["rid"], "model": r.get("model", ""),
                    "priority": r.get("priority"),
                    "t_arrival": r["t_arrival"],
                    "ttft": ttft, "slo": slo,
                    "dominant": dominant,
                    "stage": TTFT_STAGE_LABELS[dominant],
                    "spans": ttft_spans})
    return out


def explain(records: list[dict]) -> dict:
    meta = records[0] if records and records[0].get("type") == "meta" \
        else {}
    changes = scale_changes(records)
    violations = ttft_violations(records)
    by_stage: dict[str, int] = {}
    for v in violations:
        by_stage[v["stage"]] = by_stage.get(v["stage"], 0) + 1
    n_req = sum(1 for r in records if r.get("type") == "request")
    return {
        "engine": meta.get("engine", ""),
        "t_end": meta.get("t_end"),
        "n_decisions": sum(1 for r in records
                           if r.get("type") == "decision"),
        "n_requests": n_req,
        "scale_ups": [c for c in changes if c["direction"] == "up"],
        "scale_downs": [c for c in changes if c["direction"] == "down"],
        "violations": violations,
        "violations_by_stage": by_stage,
    }


# ---------------------------------------------------------------------------
# human-readable rendering
# ---------------------------------------------------------------------------

def _fmt(v, nd=1) -> str:
    if isinstance(v, float):
        return f"{v:.{nd}f}" if math.isfinite(v) else "nan"
    return str(v)


def _render_eq_inputs(inputs: dict, lines: list[str], indent="    "):
    eq2 = inputs.get("eq2")
    if eq2:
        lines.append(
            f"{indent}Eq.2  rate = in {_fmt(eq2.get('token_rate_in'))} - "
            f"deflected {_fmt(eq2.get('deflected_rate'))} = "
            f"{_fmt(eq2.get('rate'))} tok/s; "
            f"v_eff = min(v_prefill {_fmt(eq2.get('v_prefill'))}, "
            f"v_network {_fmt(eq2.get('v_network'))}) = "
            f"{_fmt(eq2.get('v_eff'))} -> i_p = {eq2.get('i_p')}")
    eq3 = inputs.get("eq3")
    if eq3:
        per_b = ", ".join(
            f"{b}:{_fmt(r)}" for b, r in sorted(
                (eq3.get("rate_by_bucket") or {}).items()))
        lines.append(f"{indent}Eq.3  per-bucket rates [{per_b}] over "
                     f"v_decode -> i_d = {eq3.get('i_d')}")
    eq4 = inputs.get("eq4")
    if eq4:
        lines.append(
            f"{indent}Eq.4  convertible loan {eq4.get('convertible')} "
            f"absorbs burst -> regular decoders = "
            f"{eq4.get('i_d_regular')}")
    if inputs.get("burst") is not None:
        lines.append(f"{indent}burst detector: "
                     f"{'ACTIVE' if inputs['burst'] else 'inactive'}")
    rank = inputs.get("prefill_rank") or inputs.get("rank")
    if rank:
        order = " > ".join(f"{name} ({_fmt(v, 2)} tok/s/$)"
                           for name, v in rank)
        lines.append(f"{indent}cost ranking (prefill): {order}")


def render_report(report: dict, max_rows: int = 10) -> str:
    lines = [f"# flight-recorder explainer "
             f"(engine={report['engine'] or '?'}, "
             f"t_end={_fmt(report.get('t_end') or 0.0)}s)",
             f"decisions recorded: {report['n_decisions']}; requests "
             f"traced: {report['n_requests']}", ""]
    ups = report["scale_ups"]
    lines.append(f"## scale-ups ({len(ups)})")
    for c in ups[:max_rows]:
        tag = " [live]" if c["live"] else ""
        lines.append(f"  t={_fmt(c['t'])}s pool={c['pool']} "
                     f"(model={c['model'] or 'default'}, role={c['role']})"
                     f": {c['from']} -> {c['to']}{tag}")
        _render_eq_inputs(c.get("inputs", {}), lines)
    if len(ups) > max_rows:
        lines.append(f"  ... {len(ups) - max_rows} more")
    downs = report["scale_downs"]
    lines.append("")
    lines.append(f"## scale-downs ({len(downs)})")
    for c in downs[:max_rows]:
        tag = " [drain]" if c["drain"] else ""
        lines.append(f"  t={_fmt(c['t'])}s pool={c['pool']}: "
                     f"{c['from']} -> {c['to']}{tag}")
    if len(downs) > max_rows:
        lines.append(f"  ... {len(downs) - max_rows} more")
    lines.append("")
    vio = report["violations"]
    lines.append(f"## TTFT SLO violations ({len(vio)})")
    for stage, n in sorted(report["violations_by_stage"].items(),
                           key=lambda kv: -kv[1]):
        lines.append(f"  dominant stage {stage}: {n}")
    for v in vio[:max_rows]:
        spans = ", ".join(f"{k}={_fmt(d, 3)}s"
                          for k, d in v["spans"].items())
        lines.append(f"  rid={v['rid']} ttft={_fmt(v['ttft'], 3)}s "
                     f"(slo {_fmt(v['slo'], 3)}s) <- {v['stage']} "
                     f"[{spans}]")
    if len(vio) > max_rows:
        lines.append(f"  ... {len(vio) - max_rows} more")
    return "\n".join(lines) + "\n"


def main(argv: Optional[list] = None) -> int:
    from .export import load_jsonl, validate_trace_lines
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace", help="flight-recorder JSONL trace path")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable report instead of "
                         "the text rendering")
    ap.add_argument("--validate", action="store_true",
                    help="schema-validate the trace first; exit 1 on "
                         "violations")
    args = ap.parse_args(argv)
    records = load_jsonl(args.trace)
    if args.validate:
        errors = validate_trace_lines(records)
        if errors:
            for e in errors:
                print("schema:", e)
            return 1
    report = explain(records)
    if args.json:
        print(json.dumps(report, indent=2, allow_nan=False))
    else:
        print(render_report(report), end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
