"""The port's copy of the flight recorder against the reference's, on the
CPU: for the same run, the JSONL and Chrome-trace exports are the same
bytes, and the explainer (library and ``python -m ... obs`` CLI) prints
the same report."""
import pytest

import repro.obs as jobs
import repro_torch.obs as tobs
from repro.obs.__main__ import main as jmain
from repro.sim import runner as jrunner
from repro_torch.obs.__main__ import main as tmain
from repro_torch.sim import runner as trunner

#: traced runs that reach the recorder's hooks: scale-ups on a burst,
#: preemption under a priority mix, deflected chunks, the gateway's
#: replication and the chaos engine's faults
SCENARIOS = {
    "burst": dict(trace_name="burstgpt1", duration=20.0, rps=10.0),
    "preemption": dict(trace_name="burstgpt2", model="qwen25_32b", tp=2,
                       duration=18.0, rps=8.0, max_instances=2,
                       preemption="evict-lowest",
                       priority_mix={0: 0.2, 1: 0.6, 2: 0.2}),
    "deflection": dict(trace_name="burstgpt1", duration=15.0, rps=40.0,
                       max_instances=6, prefill_chunking=2048),
    "gateway": dict(trace_name="azure_code", model="qwen25_32b", tp=2,
                    duration=12.0, rps=7.0, max_instances=2, block_size=16,
                    gateway=True, kv_alloc="lazy", prefix_cache=True,
                    session_prob=0.4, shared_prefix_prob=0.7,
                    shared_prefix_len=1024, shared_prefix_count=2),
    "chaos": dict(trace_name="burstgpt1", duration=20.0, rps=12.0,
                  block_size=16, prefix_cache=True,
                  faults=dict(seed=0, crashes=2, stragglers=1,
                              link_outages=1, t0=4.0, recovery=True)),
}
#: a point-event kind each scenario must record
EVENT = {"burst": None, "preemption": "preempt", "deflection": "deflect",
         "gateway": "replication_planned", "chaos": "fault_crash"}


def _exports(runner, obs, main, kw, engine, out, capsys):
    """The run's JSONL and Chrome trace (bytes), the explainer's report
    and the CLI's text and --json output."""
    rep = runner.run_policy("tokenscale", engine=engine, seed=0,
                            telemetry=True, **kw)
    out.mkdir()
    jsonl, chrome = out / "trace.jsonl", out / "trace.json"
    obs.write_jsonl(rep.obs, str(jsonl))
    obs.write_chrome_trace(rep.obs, str(chrome))
    report = obs.explain(obs.load_jsonl(str(jsonl)))
    capsys.readouterr()
    assert main([str(jsonl), "--validate"]) == 0
    text = capsys.readouterr().out
    assert main([str(jsonl), "--json"]) == 0
    as_json = capsys.readouterr().out
    return (jsonl.read_bytes(), chrome.read_bytes(), report,
            obs.render_report(report), text, as_json)


@pytest.mark.parametrize("engine", ["fluid", "events"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_exports_and_report_equal_reference(scenario, engine, tmp_path,
                                            capsys):
    kw = SCENARIOS[scenario]
    mine = _exports(trunner, tobs, tmain, kw, engine, tmp_path / "port",
                    capsys)
    want = _exports(jrunner, jobs, jmain, kw, engine,
                    tmp_path / "reference", capsys)
    names = ("jsonl", "chrome trace", "report", "rendered report",
             "CLI text", "CLI --json")
    for name, a, b in zip(names, mine, want):
        assert a == b, name
    report = mine[2]
    assert report["scale_ups"] and report["violations"]
    if EVENT[scenario]:
        assert f'"kind": "{EVENT[scenario]}"'.encode() in mine[0]
    assert not tobs.validate_jsonl(str(tmp_path / "port" / "trace.jsonl"))
