"""The benchmark of ieee80211_tpu_torch: one cell, one run, one JSON line.

    python3 phybench/run.py --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

From the root of a checkout that holds ieee80211_tpu_torch/ beside
phybench/ and BENCHMARK.json. The cell names a configuration
(phybench/configs/) and a traffic mix (phybench/traffic/); the mix's
`kind` names the adapter (phybench/entries/) that drives the program.

A run makes its inputs from the seed, builds the program's objects and
warms every distinct input once (set-up, `setup_s`, counted from the
process's start), then measures a closed loop for `--seconds`. With
`--trace 1` a few steady calls of the window run under torch.profiler and
the cell's per-layer metrics are read from them. Once the window has
closed, the device's memory peak is read, the program's state freed, and
the plain reference (phybench/ref.py) decodes the same inputs on the host;
the kept calls' outputs are judged against it (phybench/compare.py).

Without CUDA, or with fewer cards than the cell asks for, it exits 2 and
prints no result; if a module named jax, jaxlib, flax or ieee80211_tpu
(the top-level name, compared whole) was loaded by the time the window
closed, it exits 3 and prints no result. The last line of stdout is the
result; the numbers compared, each with its limit, are stderr's last lines.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from phybench import compare, harness  # noqa: E402


def mark(msg: str) -> None:
    print(f"[phybench] {msg}", file=sys.stderr, flush=True)


def card(dev) -> dict:
    import torch
    if dev.type != "cuda":
        return {"kind": "cpu", "power_limit": None}
    line = subprocess.run(
        ["nvidia-smi", f"--id={dev.index or 0}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    return {"kind": torch.cuda.get_device_name(dev),
            "power_limit": line.rsplit(",", 1)[-1].strip() if line else None}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             started: float, bench: dict = None, overrides: dict = None):
    """One run of cell `name` on `device`. Returns (result line, checks,
    loaded forbidden modules). overrides update the traffic's parameters
    (the CPU tests' small sizes)."""
    import torch
    bench = bench or harness.benchmark()
    w = harness.workload(bench, name)
    cfg = harness.config(w["config"])
    trf = dict(harness.traffic(w["traffic"]), **(overrides or {}))
    ent = harness.entry(trf["kind"])
    mark(f"set-up {name} seed {seed}: {time.time() - started:.3f} s in")
    cell = ent.build(cfg, trf, seed, device)
    mark(f"inputs and the program's objects: {time.time() - started:.3f} s in")
    cell.warm()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.time() - started
    mark(f"set-up done in {setup_s:.3f} s; window {seconds} s")
    win = harness.Window(seconds, float(trf["keep_share"]),
                         int(trf["keep_max"]), seed)
    tracer = None
    calls = None
    if trace:
        from phybench.trace import Tracer
        tracer = Tracer(cell)
        calls = range(*trf["trace_calls"])
    win.run(cell.call, calls, tracer)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    loaded = harness.forbidden_modules()
    mark(f"window: {len(win.latency)} calls in {win.elapsed:.6f} s, median "
         f"{win.median() * 1e3:.3f} ms, kept {len(cell.kept)}")
    info = card(device)
    e2e = dict(ent.end_to_end(win), setup_s=setup_s)
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    metrics = {}
    dev_out = {"platform": "gpu" if device.type == "cuda" else "cpu",
               "kind": info["kind"], "count": 1, "memory_peak_bytes": peak}
    breakdown = None
    if trace:
        tr = tracer.read()
        ctx = dict(trace=tr, counts=cell.slice_counts(), config=cfg,
                   traffic=trf)
        for m in harness.cell_metrics(bench, "per_layer", name):
            v = harness.metric(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
        dev_out.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        mark(f"traced slice {tr.window_s:.6f} s, busy {tr.busy_s():.6f} s, "
             f"{len(tr.kernels)} kernels, counts {ctx['counts']}")
    else:
        for m in harness.cell_metrics(bench, "end_to_end", name):
            metrics[m["name"]] = {"value": e2e[m["name"]],
                                  "unit": units[m["name"]]}
    cell.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = cell.numbers(cell.reference())
    mark(f"reference and comparison in {time.perf_counter() - t_ref:.3f} s")
    missing = compare.missing_limits(numbers, cfg["limits"])
    if missing:
        raise KeyError(f"configuration {w['config']} states no limit for "
                       f"{missing}")
    checks = compare.judged(numbers, cfg["limits"])
    line = {"correct": harness.correct(checks),
            "attempted": len(win.latency), "failed": 0,
            "metrics": metrics, "device": dev_out}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["power_limit"] = info["power_limit"]
    line["checks"] = harness.checks_line(checks)
    return line, checks, loaded


def main(argv=None) -> int:
    started = harness.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    bench = harness.benchmark()
    chips = int(harness.workload(bench, args.workload)["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"phybench: cell {args.workload} needs {chips} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    line, checks, loaded = run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        torch.device("cuda", 0), started, bench)
    if loaded:
        print(f"phybench: modules of JAX or the JAX package were loaded: "
              f"{loaded}", file=sys.stderr)
        return 3
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
