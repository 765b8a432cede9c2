"""CUDA-event timing of a callable on the card, the host's time to issue
it, and one call's time on the card or, for the CPU tests, the host."""
from __future__ import annotations

import time

import numpy as np
import torch

ITERS = 10
WARMUP = 2
HOST_ITERS = 1000
HOST_SYNC_EVERY = 50


def host_us(fn, iters: int = HOST_ITERS,
            sync_every: int = HOST_SYNC_EVERY) -> float:
    """The host's time to issue fn() in microseconds: the median of `iters`
    calls' `time.perf_counter_ns`, with no synchronize inside a timed call.
    The card is synchronized every `sync_every` calls, outside the timing,
    so the launch queue never fills and blocks a call."""
    for _ in range(sync_every):
        fn()
    torch.cuda.synchronize()
    times = np.empty(iters, dtype=np.int64)
    clock = time.perf_counter_ns
    for i in range(iters):
        t0 = clock()
        fn()
        times[i] = clock() - t0
        if i % sync_every == sync_every - 1:
            torch.cuda.synchronize()
    return float(np.median(times)) / 1e3


def cuda_ms(fn, iters: int = ITERS, warmup: int = WARMUP) -> float:
    """Median time of fn() in ms over `iters` runs after `warmup` runs, each
    between two CUDA events on the current stream (the host's launch cost is
    inside it)."""
    return cuda_ms_turns([fn], iters, warmup)[0]


def cuda_ms_turns(fns, iters: int = ITERS, warmup: int = WARMUP) -> list:
    """cuda_ms of each callable of `fns`, timed in turns: one call of each
    per round, so that a drift of the host or the card between rounds
    falls on all of them alike."""
    for _ in range(warmup):
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(iters):
        for t, fn in zip(times, fns):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            t.append(start.elapsed_time(stop))
    return [float(np.median(t)) for t in times]


def device_ms(fn, iters: int = ITERS, warmup: int = WARMUP) -> float:
    """The card's own time of fn() in ms: CUDA events around `iters`
    back-to-back calls, divided by `iters`, after `warmup` calls. The card
    first spins (torch.cuda._sleep) long enough for the host to queue every
    call, so the launches run back to back and the host's launch cost is
    not in the time; the spin doubles until the host finished queueing
    before the card finished spinning."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = 1 << 21   # cycles: ~1 ms at 2 GHz
    while True:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(iters):
            fn()
        queued_in_time = not start.query()
        stop.record()
        stop.synchronize()
        if queued_in_time or spin >= 1 << 30:
            return start.elapsed_time(stop) / iters
        spin <<= 1


def kernels_ms(fn, iters: int = ITERS, warmup: int = WARMUP):
    """The card's busy time in ms per call of fn(): the durations of all
    the CUDA kernels it launches, summed over `iters` calls from
    torch.profiler's device events. None when the profiler recorded no
    whole number of launches per call (it can drop events)."""
    return kernels(fn, iters, warmup)[0]


def kernels(fn, iters: int = ITERS, warmup: int = WARMUP):
    """(kernels_ms, device launches per call): both None when the profiler
    recorded no whole number of launches per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA]
    if not us or len(us) % iters:
        return None, None
    return sum(us) / iters / 1e3, len(us) // iters


def median_ms(fn, dev: torch.device, iters: int = ITERS,
              warmup: int = WARMUP) -> float:
    """cuda_ms on the card; on the CPU (the tests' runs, never a device
    metric) the median of `iters` calls on the host clock."""
    if dev.type == "cuda":
        return cuda_ms(fn, iters, warmup)
    for _ in range(warmup):
        fn()
    return float(np.median([call_ms(fn, dev)[0] for _ in range(iters)]))


def call_ms(fn, dev: torch.device):
    """One call of fn(): (its time in ms, its result). On the card between
    two CUDA events on the current stream; on the CPU (the tests' runs,
    never a device metric) on the host clock."""
    if dev.type != "cuda":
        t = time.perf_counter()
        out = fn()
        return (time.perf_counter() - t) * 1e3, out
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop), out


def host_s(fn, dev: torch.device):
    """One call of fn() on the host clock, ending with the work that it
    queued on `dev` finished (a synchronize on the card; on the CPU every
    op has returned its result): (seconds, its result)."""
    t = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t, out
