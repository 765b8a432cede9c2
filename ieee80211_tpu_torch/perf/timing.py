"""CUDA-event timing of a callable on the card."""
from __future__ import annotations

import numpy as np
import torch

ITERS = 10
WARMUP = 2


def cuda_ms(fn, iters: int = ITERS, warmup: int = WARMUP) -> float:
    """Median time of fn() in ms over `iters` runs after `warmup` runs, each
    between two CUDA events on the current stream (the host's launch cost is
    inside it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


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
        return None
    return sum(us) / iters / 1e3
