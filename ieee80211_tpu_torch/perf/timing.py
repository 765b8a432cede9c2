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
