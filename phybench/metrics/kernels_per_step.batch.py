"""CUDA kernels in the traced slice per `RxPipeline.step` call in it, from
the profiler's kernel events."""


def read(ctx):
    n = len(ctx["trace"].kernels)
    s = ctx["counts"].get("steps")
    return n / s if n and s else None
