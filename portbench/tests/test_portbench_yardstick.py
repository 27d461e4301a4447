"""The yardstick on hand-made inputs: metric arithmetic over step logs,
FLOP and byte counts against hand sums, the trace's reduction, the mix's
sizes, the import rules, and that new cells, mixes and metrics are found
by their files alone."""
import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import flops, harness, trace, traffic
from portbench.metrics import reader

BENCH = Path(harness.__file__).resolve().parent
ROOT = BENCH.parent


def _log(step_s=0.1, n=40, stall=None):
    """A window of `n` steps of `step_s` seconds from t = 0; request i
    is sent at step i and gets a token at each of its next 3 steps;
    `stall` (k0, k1, s) makes steps k0 .. k1 - 1 last `s` seconds
    more."""
    log = harness.RunLog("hand", {}, None)
    t, ends = 0.0, []
    for k in range(n):
        t += step_s + (stall[2] if stall and stall[0] <= k < stall[1]
                       else 0.0)
        ends.append(t)
        log.steps.append(harness.StepLog(k, t - step_s, t, True, [
            {"kind": "prefill", "padded": 128, "start": 0, "n": 100}]))
    log.t_w0, log.t_w1 = 0.0, ends[-1]
    for i in range(n - 3):
        r = harness.ReqLog(i, i % 4, 100, 3, ends[i])
        r.token_t = ends[i + 1:i + 4]
        log.requests.append(r)
    return log


def test_percentiles_take_every_request():
    log = _log()
    assert reader("ttft_p90_ms")(log) == pytest.approx(100.0)
    assert reader("itl_p90_ms")(log) == pytest.approx(100.0)
    ttft = [r.token_t[0] - r.send_t for r in log.requests]
    assert reader("ttft_p90_ms")(log) == pytest.approx(
        np.percentile(ttft, 90) * 1e3)


def test_tok_s_is_over_the_window():
    log = _log()
    prompt = 100 * len(log.requests)
    out = 3 * len(log.requests)
    assert reader("tok_s")(log) == pytest.approx((prompt + out) / 4.0)


def test_a_stall_moves_tails_and_rate():
    """Five steps of 40 stall for 0.5 s each: the window holds the same
    work in more time, and the requests waiting on them (an eighth of
    all) reach the 90th percentiles."""
    base, stalled = _log(), _log(stall=(20, 25, 0.5))
    assert reader("tok_s")(stalled) < 0.7 * reader("tok_s")(base)
    for m in ("ttft_p90_ms", "itl_p90_ms"):
        assert reader(m)(stalled) > reader(m)(base)


def test_step_share_and_padding():
    log = _log()
    log.steps[3].calls = [{"kind": "decode", "keys": [5], "decoding": [5]}]
    assert reader("prefill_step_share")(log) == pytest.approx(100 * 39 / 40)
    assert reader("prefill_useful_share")(log) == pytest.approx(100 / 1.28)
    assert reader("cluster_step_ms")(log) == pytest.approx(100.0)


def test_counters_are_means_over_the_window():
    log = _log()
    log.counters = {"decode_steps": 4, "decode_wall_s": 0.5,
                    "mixed_steps": 0, "mixed_wall_s": 0.0,
                    "transfers": 2, "transfer_wall_s": 0.01,
                    "prefill_tokens": 3000, "prefill_wall_s": 0.5}
    assert reader("decode_step_ms")(log) == pytest.approx(125.0)
    assert reader("mixed_step_ms")(log) is None
    assert reader("kv_transfer_ms")(log) == pytest.approx(5.0)
    assert reader("prefill_tok_s")(log) == pytest.approx(6000.0)


QWEN = {"hidden_size": 5120, "num_hidden_layers": 64,
        "num_attention_heads": 40, "num_key_value_heads": 8,
        "intermediate_size": 27648, "vocab_size": 152064, "head_dim": 128}
DSV2 = {"hidden_size": 2048, "num_hidden_layers": 27,
        "num_attention_heads": 16, "intermediate_size": 10944,
        "vocab_size": 102400, "first_k_dense_replace": 1,
        "kv_lora_rank": 512, "qk_rope_head_dim": 64, "qk_nope_head_dim": 128,
        "v_head_dim": 128, "n_routed_experts": 64, "num_experts_per_tok": 6,
        "n_shared_experts": 2, "moe_intermediate_size": 1408}


def test_active_weights_by_hand():
    attn = 5120 * 5120 * 2 + 5120 * 1024 * 2
    assert flops.layer_active(QWEN, 0) == attn + 3 * 5120 * 27648
    assert flops.body_active(QWEN) == 64 * (attn + 3 * 5120 * 27648)
    mla = (2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048)
    assert flops.layer_active(DSV2, 0) == mla + 3 * 2048 * 10944
    assert flops.layer_active(DSV2, 1) == mla + 8 * 3 * 2048 * 1408 + \
        2048 * 64
    # the port's counts: 31.2 B of Qwen's layers, 2.4 B DeepSeek's active
    assert 31.2e9 < flops.body_active(QWEN) < 31.3e9
    assert 2.0e9 < flops.body_active(DSV2) + flops.head_weights(DSV2) < 2.5e9


def test_model_flops_by_hand():
    assert flops.causal_pairs(0, 3) == 6
    assert flops.causal_pairs(10, 2) == 10 * 2 + 3
    body, head = flops.body_active(QWEN), flops.head_weights(QWEN)
    pair = 4 * 40 * 128
    assert flops.prefill_model_flops(QWEN, 0, 3) == pytest.approx(
        2 * body * 3 + 2 * head + pair * 6 * 64)
    assert flops.decode_model_flops(QWEN, [5, 7]) == pytest.approx(
        2 * 2 * (body + head) + pair * 12 * 64)
    assert flops.pair_flops(DSV2) == 2 * 16 * (128 + 64 + 128)


def test_kernel_bounds_by_hand():
    f, b = flops.prefill_attn(QWEN, 2048, 100)
    assert f == 4 * 40 * 128 * (100 * 2048 + 100 * 101 // 2)
    assert b == (2 * 100 * 40 * 128 + 2 * 2148 * 8 * 128) * 2
    f, b = flops.decode_attn(QWEN, [10, 20, 1])
    assert f == 4 * 40 * 128 * 31
    assert b == (2 * 3 * 40 * 128 + 2 * 31 * 8 * 128) * 2
    peak = flops.PEAKS["NVIDIA H100 80GB HBM3"]
    assert flops.bound_s(989e12, 1.0, peak) == pytest.approx(1.0)
    assert flops.bound_s(1.0, 3.35e12, peak) == pytest.approx(1.0)
    assert flops.kv_bytes_per_token(QWEN) == 262144
    assert flops.kv_bytes_per_token(DSV2) == 31104


def test_trace_reduction_by_hand():
    ms = 1_000_000
    evs = [("portbench::window", False, 0, 100 * ms),
           ("portbench::step", False, 0, 50 * ms),
           ("cudaLaunchKernel", False, 5 * ms, 12 * ms),
           ("portbench::step", False, 55 * ms, 100 * ms),
           ("portbench::decode", False, 60 * ms, 80 * ms),
           ("kern_c", True, 2 * ms, 6 * ms),
           ("kern_a", True, 10 * ms, 30 * ms),
           ("kern_b", True, 20 * ms, 52 * ms),
           ("kern_a", True, 60 * ms, 70 * ms),
           ("kern_a", True, 95 * ms, 120 * ms)]
    r = trace.reduce(evs)
    assert r["window_s"] == pytest.approx(0.1)
    assert r["busy_s"] == pytest.approx(0.061)
    assert r["kernel_s"] == pytest.approx({"kern_a": 0.035, "kern_b": 0.032,
                                           "kern_c": 0.004})
    assert r["idle_by_host"] == pytest.approx(
        {"portbench::step": 0.002, "portbench::step/cudaLaunchKernel": 0.004,
         "portbench::host": 0.008, "portbench::decode": 0.025})
    assert trace.top({"a": 1.0, "b": 3.0, "c": 2.0}, 2) == [["b", 3.0],
                                                          ["c", 2.0]]
    assert trace.short("void ns::(anonymous namespace)::k<128, false>(int, "
                       "float)") == "ns::k<128, false>"


def test_every_seed_serves_the_same_sizes():
    mix = traffic.load_mix("code")
    ins, outs = traffic.block_sizes(mix, 3072)
    assert ins.min() >= 128 and ins.max() <= 3072 - 128
    assert outs.min() >= 4 and outs.max() <= 128
    a = traffic.Stream(mix, 3072, 1000, 5)
    b = traffic.Stream(mix, 3072, 1000, 2 ** 31 + 99)
    sa = [a.next() for _ in range(2 * mix["block"])]
    sb = [b.next() for _ in range(2 * mix["block"])]
    for k in range(2):
        blk = slice(k * mix["block"], (k + 1) * mix["block"])
        assert sorted((s.prompt_len, s.out_len) for s in sa[blk]) == \
            sorted((s.prompt_len, s.out_len) for s in sb[blk])
    assert [s.prompt_len for s in sa] != [s.prompt_len for s in sb]
    assert np.array_equal(a.prompt(sa[3]), traffic.Stream(
        mix, 3072, 1000, 5).prompt(sa[3]))


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & set(harness.FORBIDDEN), path
    for path in (BENCH / "reference").glob("*.py"):
        assert "repro_torch" not in _imports(path), path


def test_a_run_loads_no_jax(tmp_path):
    """The harness and the port it drives, in a fresh process: nothing
    whose top-level name is jax, jaxlib, flax or repro gets loaded (the
    names compared whole: repro_torch is not repro)."""
    code = (
        "import itertools, sys, torch\n"
        "torch.set_num_threads(1)\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from portbench import harness\n"
        "ticks = itertools.count(0.0, 1e-3)\n"
        "cell = harness.Cell.named('qwen25-32b.conv-code', slots=2,"
        " max_len=256, chunk_size=128, clients=3, sample=1)\n"
        "out = harness.run(cell, 3, 0.2, False, torch.device('cpu'), 0.0,"
        " smoke=True, clock=lambda: next(ticks))\n"
        "assert out['correct']\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & set(harness.FORBIDDEN)), 'repro_torch' in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[] True"


def test_no_result_without_a_card(tmp_path):
    res = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "qwen25-32b.conv-code", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=240,
        cwd=tmp_path, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES":
                           ""})
    assert res.returncode != 0 and res.stdout == ""


def test_a_mix_with_a_key_nothing_reads_is_refused(tmp_path):
    (tmp_path / "traffic").mkdir()
    mix = traffic.load_mix("code")
    for name, change in (("think", {"think_s": 2}),
                         ("short", {"in_sigma": None})):
        bad = {k: v for k, v in {**mix, **change}.items() if v is not None}
        (tmp_path / "traffic" / f"{name}.json").write_text(json.dumps(bad))
        with pytest.raises(ValueError, match=name):
            traffic.load_mix(name, tmp_path)


def test_new_files_are_found_without_edits(tmp_path):
    """A new mix, cell and metric are picked up from their files."""
    for d in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(BENCH / d, tmp_path / d)
    mix = json.loads((tmp_path / "traffic" / "code.json").read_text())
    mix.update(name="chat", in_mean=1024.0, out_mean=240.0)
    (tmp_path / "traffic" / "chat.json").write_text(json.dumps(mix))
    wl = json.loads((tmp_path / "workloads" /
                     "qwen25-32b.conv-code.json").read_text())
    wl.update(traffic="chat")
    (tmp_path / "workloads" / "qwen25-32b.chat.json").write_text(
        json.dumps(wl))
    (tmp_path / "metrics" / "steps_in_window.py").write_text(
        "def read(run):\n    return len(run.window_steps()) or None\n")
    cell = harness.Cell.named("qwen25-32b.chat", root=tmp_path)
    assert cell.mix["name"] == "chat" and cell.config["name"] == "qwen25-32b"
    assert reader("steps_in_window", tmp_path / "metrics")(_log()) == 40
    ins, _ = traffic.block_sizes(cell.mix, 3072)
    assert ins.mean() < traffic.block_sizes(traffic.load_mix("code"),
                                            3072)[0].mean()


def test_benchmark_names_its_readers_and_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
        assert set(m.get("workloads", cells)) <= cells
    for w in bench["workloads"]:
        cell = harness.Cell.named(w["name"])
        assert cell.workload["config"] == w["config"]
        assert cell.workload["traffic"] == w["traffic"]
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists()
