"""The host's issue time of one `RxPipeline.step`, in ms: the summed `step`
spans (the nine stages' launches, from the call's entry to its return)
over the steps in the traced slice."""
from phybench.metrics import spans


def read(ctx):
    st = spans.named(spans.recorded() or (), "step")
    n = spans.counts(ctx).get("steps")
    if not st or not n:
        return None
    return spans.total_s(st) * 1e3 / n
