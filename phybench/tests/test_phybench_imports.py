"""Nothing a run imports has the top-level name jax, jaxlib, flax or
ieee80211_tpu (compared whole: ieee80211_tpu_torch is the program)."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

PROBE = r'''
import sys, time, torch
sys.path.insert(0, ".")
from phybench import harness, run
for cell, over in (("siso20.stream_ampdu_4095",
                    dict(capture_samples=1 << 15, distinct_bursts=1,
                         captures_per_call=1)),
                   ("siso20.batch_vht7", dict(rows=2, distinct_batches=1))):
    line, checks, loaded = run.run_cell(cell, 5, 0.1, False,
                                        torch.device("cpu"), time.time(),
                                        overrides=over)
    assert line["correct"], (cell, line)
    assert loaded == [], loaded
import phybench.readings, phybench.trace
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "ieee80211_tpu"))
assert bad == [], bad
assert "ieee80211_tpu_torch" in sys.modules
print("clean")
'''


def test_a_run_loads_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "clean" in out.stdout


def test_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "phybench/run.py", "--workload",
                          "siso20.batch_vht7", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_a_checkout_without_the_program_prints_no_result(tmp_path):
    import shutil
    shutil.copytree(os.path.join(ROOT, "phybench"), tmp_path / "phybench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "phybench/run.py", "--workload",
                          "siso20.batch_vht7", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
