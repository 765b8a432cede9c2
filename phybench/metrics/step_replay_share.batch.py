"""The share of the traced slice's `RxPipeline.step` calls that replayed
the step's CUDA graph: `step.replay` spans over the steps in the slice. A
program whose step records no such span gives none."""
from phybench.metrics import spans


def read(ctx):
    rep = spans.named(spans.recorded() or (), "step.replay")
    n = spans.counts(ctx).get("steps")
    if not rep or not n:
        return None
    return len(rep) / n
