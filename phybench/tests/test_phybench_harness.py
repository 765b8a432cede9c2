"""The harness finds every cell's parts by name, and a new configuration,
traffic mix and metric are files and BENCHMARK.json entries alone."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from phybench import harness, trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_every_cell_finds_its_parts():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        cfg, trf = harness.config(w["config"]), harness.traffic(w["traffic"])
        assert cfg["name"] == w["config"]
        ent = harness.entry(trf["kind"])
        assert hasattr(ent, "build") and hasattr(ent, "end_to_end")
        e2e = harness.cell_metrics(bench, "end_to_end", w["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert harness.cell_metrics(bench, "per_layer", w["name"])
        for key in ("keep_share", "keep_max", "trace_calls"):
            assert key in trf
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for m in bench["per_layer"]:
        assert callable(harness.metric(m["name"]).read)


def test_readers_return_nothing_without_a_trace():
    empty = trace.Trace(0.1, [], [], [])
    ctx = dict(trace=empty, counts=dict(calls=0, packets=0, steps=0,
                                        triggers=0, fcs_ok=0,
                                        viterbi_steps=0))
    for m in harness.benchmark()["per_layer"]:
        assert harness.metric(m["name"]).read(ctx) is None


def test_readers_read_a_trace():
    tr = trace.Trace(0.01, [("viterbi_r4_kernel<4>", 0.0, 1000.0),
                            ("k", 2000.0, 500.0)],
                     [(0.0, 1000.0), (500.0, 1500.0), (2000.0, 2500.0)], [])
    ctx = dict(trace=tr, counts=dict(calls=2, packets=4, steps=2,
                                     triggers=5, fcs_ok=4,
                                     viterbi_steps=1e6))
    read = {m["name"]: harness.metric(m["name"]).read(ctx)
            for m in harness.benchmark()["per_layer"]}
    assert read["trigger_yield.stream"] == 0.8
    assert read["kernels_per_packet.stream"] == 0.5
    assert read["kernels_per_step.batch"] == 1.0
    assert read["device_idle.stream"] == pytest.approx(1 - 0.002 / 0.01)
    # 1e6 steps x 64 states x 4 ops at 3.35e13 over 1 ms of kernel
    assert read["viterbi_roofline.batch"] == pytest.approx(
        100 * 2.56e8 / 3.35e13 / 1e-3)


def test_idle_gaps_name_the_host():
    tr = trace.Trace(1.0, [], [(0.0, 10.0), (50.0, 60.0), (61.0, 62.0)],
                     [("aten::cat", 20.0, 40.0), ("outer", 0.0, 100.0)])
    (n0, g0), (n1, g1) = tr.idle_gaps()
    assert (n0, n1) == ("aten::cat", "outer")
    assert (g0, g1) == (pytest.approx(40e-6), pytest.approx(1e-6))
    assert tr.busy_s() == pytest.approx(21e-6)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ieee80211_tpu_torch_x", sys)
    assert harness.forbidden_modules() == [] or all(
        m.split(".")[0] in harness.FORBIDDEN
        for m in harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "ieee80211_tpu.rx", sys)
    assert "ieee80211_tpu.rx" in harness.forbidden_modules()


ADD_ONE = r'''
import json, sys, time, torch
sys.path.insert(0, ".")
from phybench import harness, run
assert harness.config("siso20_copy")["name"] == "siso20_copy"
assert harness.traffic("short_burst")["captures_per_call"] == 1
line, checks, loaded = run.run_cell(
    "siso20_copy.short_burst", 2 ** 33 + 1, 0.2, False,
    torch.device("cpu"), time.time(),
    overrides=dict(capture_samples=1 << 15, distinct_bursts=1))
assert line["correct"] and "stream_msps" in line["metrics"], line
assert not loaded, loaded
tr = __import__("phybench.trace", fromlist=["Trace"]).Trace(1.0, [], [], [])
ctx = dict(trace=tr, counts=dict(packets=3))
assert harness.metric("packets_in_slice.stream").read(ctx) == 3
print("added")
'''


def test_a_cell_mix_and_metric_are_files_and_entries_alone(tmp_path):
    """Copy phybench/, add a configuration, a traffic mix and a metric as
    new files and their BENCHMARK.json entries, change no file the copy
    holds, and run the new cell (on the CPU, small)."""
    dst = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "phybench"), dst / "phybench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (dst / "phybench").rglob("*")
              if p.is_file()}
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cfg = json.load(open(dst / "phybench/configs/siso20.json"))
    cfg["name"] = "siso20_copy"
    (dst / "phybench/configs/siso20_copy.json").write_text(json.dumps(cfg))
    trf = json.load(open(dst / "phybench/traffic/stream_ampdu_4095.json"))
    trf.update(captures_per_call=1, keep_share=1.0)
    (dst / "phybench/traffic/short_burst.json").write_text(json.dumps(trf))
    (dst / "phybench/metrics/packets_in_slice.stream.py").write_text(
        "def read(ctx):\n    return ctx['counts'].get('packets') or None\n")
    bench["configs"].append({"name": "siso20_copy", "source": "x",
                             "file": "phybench/configs/siso20_copy.json",
                             "reduced": [], "why": "a copy"})
    bench["workloads"].append({"name": "siso20_copy.short_burst",
                               "config": "siso20_copy",
                               "traffic": "short_burst", "chips": 1,
                               "why": "one capture a call"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "stream" in m["name"]:
            m["workloads"].append("siso20_copy.short_burst")
    bench["per_layer"].append({"name": "packets_in_slice.stream",
                               "unit": "packets", "better": "higher",
                               "source": "program_counter",
                               "layer": "sync and trigger",
                               "moves": "stream_msps",
                               "workloads": ["siso20_copy.short_burst"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", ADD_ONE], cwd=dst, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "added" in out.stdout
    after = {p: p.read_bytes() for p in before}
    assert after == before
