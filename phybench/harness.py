"""The benchmark's registry and window: everything is found by name.

  BENCHMARK.json              cells, metrics, bounds (the repo's root)
  phybench/configs/<c>.json   a deployment: receiver, options, guarantees,
                              the comparison's limits
  phybench/traffic/<t>.json   a traffic mix (data only); its `kind` names
  phybench/entries/<k>.py     the adapter that drives the program with it
  phybench/metrics/<m>.py     one per-layer metric's reader: read(ctx)

A later cell, mix or metric is a new file and a new entry in
BENCHMARK.json; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# top-level module names that no run may have loaded once its window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "ieee80211_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = REPO) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(ROOT / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(ROOT / "traffic" / f"{name}.json")


def _module(path: Path, tag: str) -> ModuleType:
    """A module loaded from its file (metric names hold dots, so they are
    not import paths)."""
    spec = importlib.util.spec_from_file_location(f"phybench_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(kind: str) -> ModuleType:
    return _module(ROOT / "entries" / f"{kind}.py", f"entry_{kind}")


def metric(name: str) -> ModuleType:
    return _module(ROOT / "metrics" / f"{name}.py",
                   "metric_" + name.replace(".", "_"))


def cell_metrics(bench: dict, section: str, cell: str) -> List[dict]:
    """The metrics of a section that this cell reports: those that list it
    under `workloads`, and those with no such list."""
    return [m for m in bench[section]
            if cell in m.get("workloads", [cell])]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: ieee80211_tpu_torch is not ieee80211_tpu."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def process_start() -> float:
    """The wall-clock time this process started (Linux /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f
                         if ln.startswith("btime"))
        import os
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


class Window:
    """The measured window of a closed loop from one client: calls follow
    each other for `seconds`, the last one finishing past the close. Every
    call's host-clock latency and work are recorded; `keep(i)` says which
    calls' outputs the comparison will judge (a sample drawn from the
    seed)."""

    def __init__(self, seconds: float, keep_share: float, keep_max: int,
                 seed: int):
        self.seconds = seconds
        self.rng = np.random.default_rng([int(seed) & 0xFFFFFFFF,
                                          int(seed) >> 32, 7])
        self.keep_share, self.keep_max = keep_share, keep_max
        self.latency: List[float] = []
        self.work: List[int] = []
        self.kept = 0
        self.elapsed = 0.0

    def keep(self, i: int) -> bool:
        take = i == 0 or self.rng.random() < self.keep_share
        if take and self.kept < self.keep_max:
            self.kept += 1
            return True
        return False

    def run(self, call, trace_calls: Optional[range] = None, tracer=None):
        """call(i, keep) runs call i to its results on the host and returns
        its work (samples). tracer(start | stop) brackets trace_calls."""
        t_start = time.perf_counter()
        i = 0
        while True:
            if tracer is not None and trace_calls is not None \
                    and i == trace_calls.start:
                tracer("start")
            t0 = time.perf_counter()
            w = call(i, self.keep(i))
            t1 = time.perf_counter()
            if tracer is not None and trace_calls is not None \
                    and i == trace_calls.stop - 1:
                tracer("stop")
            self.latency.append(t1 - t0)
            self.work.append(w)
            i += 1
            if t1 - t_start >= self.seconds and (
                    trace_calls is None or i >= trace_calls.stop):
                break
        self.elapsed = t1 - t_start

    def rate(self) -> float:
        """All the work of the window over all its time, per second."""
        return sum(self.work) / self.elapsed

    def p95(self) -> float:
        """The 95th percentile of every call's latency (linear)."""
        return float(np.percentile(self.latency, 95))

    def median(self) -> float:
        return statistics.median(self.latency)


def checks_line(checks: Dict[str, tuple]) -> Dict[str, list]:
    """The numbers compared, each beside its limit: {name: [value, limit]}."""
    return {k: [v, lim] for k, (v, lim) in checks.items()}


def correct(checks: Dict[str, tuple]) -> bool:
    return all(v is not None and v <= lim for v, lim in checks.values())
