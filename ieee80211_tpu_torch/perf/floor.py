"""The streaming receivers' host floor, bracketed.

    python -m ieee80211_tpu_torch.perf.floor [--reps N]

Port of perf_ab_r5.py::floor_bracket (:185-233), on bench.py's stream
captures (the input functions of perf/bench.py). For each lane, three
passes over every capture, each on the host clock and ending with its work
on the card finished:

  ingest  the receiver's ingest alone: trigger scan, quantize, upload
          (`SisoReceiver._ingest`; `_ingest_device` for the device trigger,
          whose trigger scan runs on the card; `MimoReceiver._ingest` over
          both chains)
  sig     ingest, then the SIG parse's dispatch and its packed-meta fetch
          (`_dispatch_sigs`, `_finish_sigs`)
  full    `decode_captures`, every packet gated to its MPDU

Lanes: the SISO stream with the host trigger and with the device trigger,
and the dual-chain stream through `MimoReceiver` (detector "auto"). The
passes run in turns, REPS times, after one gated warm pass of each lane.
The gap from ingest to sig, and from sig to full, says where a stream's
ceiling sits. Ingest here runs on the main thread, where decode_captures
runs it on a worker thread one capture ahead. Runs on the card;
`bracket(device="cpu", sizes=...)` runs the CPU tests' small version.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..rx import MimoReceiver, SisoReceiver
from ..utils.device import entry_device
from .bench import (FULL, Sizes, api_capture, card_info, check, gate_packets,
                    mimo_stream_captures, stream_captures)
from .timing import host_s

REPS = 3
PASSES = ("ingest", "sig", "full")


def _sig_pass(rx, ingest, caps, device_trigger: bool):
    """Ingest, SIG dispatch and packed-meta fetch for every capture."""
    pending = []
    for c in caps:
        if device_trigger:
            fetch, cap_dev, npad = ingest(c)
            t0s = rx._trigger_starts(fetch)
        else:
            t0s, cap_dev, npad = ingest(c)
        if len(t0s):
            pending.append(rx._dispatch_sigs(cap_dev, npad, t0s))
    return [rx._finish_sigs(packed, t_clamp) for packed, t_clamp in pending]


def lanes(dev, sizes: Sizes = FULL):
    """[(lane, receiver, captures, samples per pass, packets' MPDUs per
    capture, device trigger)]: bench.py's SISO stream twice, its
    dual-chain stream once (samples per chain)."""
    caps = stream_captures(sizes)
    want = api_capture(sizes)[1] * sizes.n_copy
    mcaps, _, seg = mimo_stream_captures(sizes)
    mwant = tuple(mp for _, mp in seg) * sizes.n_mimo_rep
    n = sum(len(c) for c in caps)
    return [("siso host trigger", SisoReceiver(device=dev), caps, n, want,
             False),
            ("siso device trigger", SisoReceiver(trigger="device",
                                                 device=dev), caps, n, want,
             True),
            ("mimo auto", MimoReceiver(device=dev), mcaps,
             sum(c.shape[1] for c in mcaps), mwant, False)]


def bracket(reps: int = REPS, *, device=None, sizes: Sizes = FULL) -> dict:
    """{lane: {"samples": per pass, pass: [seconds per rep]}} after one
    gated warm pass per lane; every full pass is gated too."""
    dev = entry_device(device)
    runs = lanes(dev, sizes)

    def gate(stream, name, caps, want):
        check(len(stream) == len(caps), f"floor {name}: one result per "
                                        f"capture")
        for k, res in enumerate(stream):
            gate_packets(res, want, f"floor {name} capture {k}")

    out = {}
    for name, rx, caps, n, want, _ in runs:
        gate(rx.decode_captures(caps), name, caps, want)
        out[name] = {"samples": n, **{p: [] for p in PASSES}}
    for _ in range(reps):
        for name, rx, caps, n, want, dev_trig in runs:
            ingest = rx._ingest_device if dev_trig else rx._ingest
            passes = {   # the ingest pass keeps every upload to its end
                "ingest": lambda: [ingest(c) for c in caps],
                "sig": lambda: _sig_pass(rx, ingest, caps, dev_trig),
                "full": lambda: rx.decode_captures(caps)}
            for p, fn in passes.items():
                s, res = host_s(fn, dev)
                if p == "full":
                    gate(res, name, caps, want)
                del res
                out[name][p].append(s)
    return out


def summary(out: dict) -> dict:
    """Per lane and pass: the median seconds and samples/s over reps."""
    return {name: {p: {"ms": float(np.median(r[p])) * 1e3,
                       "samples_per_s": r["samples"] / float(np.median(
                           r[p]))} for p in PASSES}
            for name, r in out.items()}


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    dev = entry_device(device)
    card = card_info(dev)
    out = bracket(args.reps, device=dev)
    tag = f"({card['name']}, {card['power_limit']})"
    for name, r in out.items():
        for i in range(args.reps):
            print(f"[floor rep{i}] {name}: " + " | ".join(
                f"{p} {r['samples'] / r[p][i]:.6g} samples/s "
                f"({r[p][i] * 1e3:.4f} ms)" for p in PASSES) + f" {tag}")
    print(json.dumps({"device": card, "reps": out,
                      "median": summary(out)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
