"""The traced slice of a `--trace 1` run: torch.profiler over a few steady
calls inside the window, read back from its exported chrome trace.

Device operations are the trace's `kernel`, `gpu_memcpy` and `gpu_memset`
events; busy time is the union of their intervals, so overlapping streams
count once. The slice's length is the host clock from a synchronize before
its first call to a synchronize after its last.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


@dataclasses.dataclass
class Trace:
    window_s: float
    kernels: List[Tuple[str, float, float]]    # (name, start us, dur us)
    device_ops: List[Tuple[float, float]]      # (start us, end us)
    host_ops: List[Tuple[str, float, float]]   # (name, start us, end us)

    def busy_s(self) -> float:
        return sum(e - s for s, e in merged(self.device_ops)) * 1e-6

    def kernel_s(self, part: str) -> float:
        """Summed device time of the kernels whose name contains `part`."""
        return sum(d for n, _, d in self.kernels if part in n) * 1e-6

    def top_ops(self, k: int = 10) -> List[list]:
        tot = defaultdict(float)
        for n, _, d in self.kernels:
            tot[n[:120]] += d * 1e-6
        return [[n, s] for n, s in sorted(tot.items(),
                                          key=lambda t: -t[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The k longest gaps between device operations, each named by the
        innermost host operation running at its middle."""
        iv = merged(self.device_ops)
        gaps = sorted(((iv[j + 1][0] - iv[j][1], iv[j][1], iv[j + 1][0])
                       for j in range(len(iv) - 1)), reverse=True)[:k]
        out = []
        for dur, s, e in gaps:
            mid = (s + e) / 2
            covering = [(he - hs, n) for n, hs, he in self.host_ops
                        if hs <= mid <= he]
            name = min(covering)[1] if covering else "host python"
            out.append([name[:120], dur * 1e-6])
        return out


def merged(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[list] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Tracer:
    """Called with "start" before the slice's first call and "stop" after
    its last; `cell.tracing` is on in between."""

    def __init__(self, cell):
        self.cell = cell
        self.prof = None

    def __call__(self, what: str) -> None:
        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.synchronize()
        if what == "start":
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            self.cell.tracing = True
            self.t0 = time.perf_counter()
            return
        self.window = time.perf_counter() - self.t0
        self.cell.tracing = False
        self.prof.__exit__(None, None, None)

    def read(self) -> "Trace":
        """The slice's trace, read once the window has closed."""
        return read(self.prof, self.window)


def read(prof, window_s: float) -> Trace:
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    kernels, dev, host = [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, ts, dur = ev.get("cat", ""), float(ev["ts"]), float(
            ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            if cat == "kernel":
                kernels.append((ev.get("name", ""), ts, dur))
        elif cat in HOST_CATS:
            host.append((ev.get("name", ""), ts, ts + dur))
    return Trace(window_s, kernels, dev, host)
