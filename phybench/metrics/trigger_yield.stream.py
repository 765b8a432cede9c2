"""Packets decoded with a good FCS per STF trigger in the traced calls, from
the receiver's DecodeStats (`fcs_ok / triggers`): the share of the sync and
trigger layer's work that ends in a delivered packet."""


def read(ctx):
    c = ctx["counts"]
    return c["fcs_ok"] / c["triggers"] if c.get("triggers") else None
