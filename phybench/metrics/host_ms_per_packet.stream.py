"""The main thread's own work per packet, in ms: the self time (duration
less child spans, so less waits and decoder builds) of the `rx.sig_dispatch`,
`rx.plan`, `rx.data_dispatch` and `rx.assemble` spans on the threads of
the `rx.call` spans, over the packets decoded in the traced slice."""
from phybench.metrics import spans

HOST = ("rx.sig_dispatch", "rx.plan", "rx.data_dispatch", "rx.assemble")


def read(ctx):
    sp = spans.recorded()
    pk = spans.counts(ctx).get("packets")
    t = spans.self_s(sp, HOST, "rx.call") if sp else None
    if t is None or not pk:
        return None
    return t * 1e3 / pk
