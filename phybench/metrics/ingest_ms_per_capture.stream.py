"""The ingest lane's time per capture, in ms: the summed `rx.ingest` spans
of the traced slice (a capture's trigger scan, quantization and upload, on
the receiver's worker thread) over the captures in the slice (calls x
`captures_per_call`)."""
from phybench.metrics import spans


def read(ctx):
    sp = spans.recorded()
    ing = spans.named(sp or (), "rx.ingest")
    caps = (spans.counts(ctx).get("calls", 0)
            * int((ctx.get("traffic") or {}).get("captures_per_call", 0)))
    if not ing or not caps:
        return None
    return spans.total_s(ing) * 1e3 / caps
