"""The share of the traced slice in which the main thread waited for the
ingest lane: summed `rx.ingest_wait` spans over the slice's `window_s`."""
from phybench.metrics import spans


def read(ctx):
    w = spans.named(spans.recorded() or (), "rx.ingest_wait")
    win = spans.window_s(ctx)
    if not w or not win:
        return None
    return spans.total_s(w) / win
