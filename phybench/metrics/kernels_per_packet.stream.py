"""CUDA kernels in the traced slice per packet it decoded: the host
dispatch's launches, from the profiler's kernel events."""


def read(ctx):
    n = len(ctx["trace"].kernels)
    p = ctx["counts"].get("packets")
    return n / p if n and p else None
