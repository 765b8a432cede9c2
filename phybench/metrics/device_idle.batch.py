"""1 - (the union of the device operations' intervals / the traced slice's
length): the share of the slice in which the card ran nothing."""


def read(ctx):
    tr = ctx["trace"]
    busy = tr.busy_s()
    return 1.0 - busy / tr.window_s if busy > 0 and tr.window_s > 0 else None
