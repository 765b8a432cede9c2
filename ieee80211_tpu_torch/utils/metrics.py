"""Decode observability: per-MCS counters, and spans of the host's work.

`DecodeStats` is a copy of ieee80211_tpu/utils/metrics.py's, which cannot
be imported where there is no jax (ieee80211_tpu/utils/__init__.py imports
riq.py, which imports jax); tests/test_torch_receiver.py holds the two to
the same counters. Counters are keyed by (format, mcs).

The span recorder names what the host does inside the port's public calls
(the receivers' decodes, `RxStep.forward`). It records only while
torch.profiler records on the thread that made the call, decided once at
the call's entry (`call_span`); otherwise `span` is one boolean check that
returns a shared no-op context. While it records:

  * `SPANS` keeps the finished spans of the latest profiled stretch (a run
    of public calls that found the profiler on), at most SPAN_CAP of them,
    counting the rest in `SPANS.dropped`. Each holds its name, start and
    end (`time.perf_counter_ns`), native thread id, span id, parent span
    id, call id and attributes;
  * every span on the calling thread also enters
    `torch.profiler.record_function(name)`, so that the exported chrome
    trace shows it as a `user_annotation` on the kernels' clock, and names
    the device's idle gaps by what the host was doing;
  * a worker task submitted through `on_lane` records on its own thread,
    under the span open where it was submitted. The profiler does not
    record ranges opened on such threads: `SPANS.events(trace)` returns
    every span as a chrome-trace event on the profiler's clock, through
    the `phy.clock` range entered at the stretch's start, and
    `SPANS.append_to(path)` adds the worker lanes to an exported trace.

Attributes are set on the open span (`with span(name) as sp: if sp:
sp.attrs[...] = ...`), so that nothing is computed while the recorder is
off.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import threading
import time
from typing import Dict, List, NamedTuple, Tuple, Union

import torch
from torch.autograd.profiler import record_function


@dataclasses.dataclass
class DecodeStats:
    n_trigger: int = 0
    n_sig_ok: int = 0
    n_decoded: int = 0
    n_fcs_ok: int = 0
    n_mu: int = 0        # downlink MU own-stream decodes (fcs-ok)
    n_ndp: int = 0       # NDP channel captures surfaced
    per_mcs_ok: Dict[Tuple[str, int], int] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(int))
    per_mcs_fail: Dict[Tuple[str, int], int] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(int))

    def record(self, fmt_name: str, mcs: int, ok: bool, mu: bool = False):
        self.n_decoded += 1
        if ok:
            self.n_fcs_ok += 1
            self.per_mcs_ok[(fmt_name, mcs)] += 1
            if mu:
                self.n_mu += 1
        else:
            self.per_mcs_fail[(fmt_name, mcs)] += 1

    def summary(self) -> dict:
        return {
            "triggers": self.n_trigger,
            "sig_ok": self.n_sig_ok,
            "decoded": self.n_decoded,
            "fcs_ok": self.n_fcs_ok,
            "mu_ok": self.n_mu,
            "ndp": self.n_ndp,
            "per_mcs_ok": {f"{f}{m}": v
                           for (f, m), v in sorted(self.per_mcs_ok.items())},
            "per_mcs_fail": {f"{f}{m}": v
                             for (f, m), v in
                             sorted(self.per_mcs_fail.items())},
        }


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

SPAN_CAP = 1 << 20
CLOCK = "phy.clock"    # the range that ties perf_counter_ns to the trace
CLOCK_READS = 3         # phy.clock ranges a stretch picks its anchor from


class Span(NamedTuple):
    name: str
    start: int          # time.perf_counter_ns
    end: int
    tid: int            # native thread id, as the profiler's trace has it
    span_id: int
    parent: int         # 0 for a call's root
    call: int
    attrs: dict


class SpanStore:
    """The finished spans of the latest profiled stretch."""

    def __init__(self, cap: int = SPAN_CAP):
        self.cap = cap
        self.spans: List[Span] = []
        self.dropped = 0
        self.anchor = None      # perf_counter_ns read as `phy.clock` opens
        self.anchor_at = -1     # its range among the trace's phy.clock events
        self.anchor_tid = None
        self._live = False      # the last public call found the profiler on

    def __len__(self) -> int:
        return len(self.spans)

    def __iter__(self):
        return iter(list(self.spans))

    def clear(self) -> None:
        """Empty the store and end the stretch: the next public call that
        finds the profiler on begins a new one (between two profiles that
        no unprofiled call separates)."""
        self.spans = []
        self.dropped = 0
        self.anchor = self.anchor_tid = None
        self._live = False

    def _begin(self) -> None:
        """A new stretch: an empty store, and the clock's anchor. The first
        range of a profile takes 0.1-0.4 ms longer than later ones to read
        its timestamp, so a first `phy.clock` range bears that; of the
        `CLOCK_READS` ranges after it, the anchor is the start read just
        before the range that opened soonest after its read (a thread
        descheduled between the two makes one range late, not all), and
        `anchor_at` that range's place among the trace's `phy.clock`
        events."""
        self.clear()
        with record_function(CLOCK):
            pass
        reads = []
        for _ in range(CLOCK_READS):
            t0 = time.perf_counter_ns()
            rf = record_function(CLOCK)
            rf.__enter__()
            reads.append((time.perf_counter_ns() - t0, t0))
            rf.__exit__(None, None, None)
        k = min(range(CLOCK_READS), key=lambda i: reads[i][0])
        self.anchor = reads[k][1]
        self.anchor_at = k - CLOCK_READS
        self.anchor_tid = threading.get_native_id()

    def _add(self, s: Span) -> None:
        if len(self.spans) < self.cap:
            self.spans.append(s)
        else:
            self.dropped += 1

    def events(self, trace: Union[str, dict]) -> List[dict]:
        """Every span as a chrome-trace "X" event on the profiler's clock
        of `trace` (the exported file's path, or its JSON), which must hold
        this stretch's `phy.clock` range; one tid per thread. [] without
        one."""
        if isinstance(trace, str):
            with open(trace) as f:
                trace = json.load(f)
        clock = sorted((e for e in trace.get("traceEvents", [])
                        if e.get("name") == CLOCK and e.get("ph") == "X"),
                       key=lambda e: float(e["ts"]))
        if self.anchor is None or len(clock) < -self.anchor_at:
            return []
        c = clock[self.anchor_at]
        off = float(c["ts"]) - self.anchor / 1e3
        return [{"ph": "X", "cat": "phy_span", "name": s.name,
                 "pid": c["pid"], "tid": s.tid, "ts": off + s.start / 1e3,
                 "dur": (s.end - s.start) / 1e3,
                 "args": dict(s.attrs, span=s.span_id, parent=s.parent,
                              call=s.call)}
                for s in list(self.spans)]

    def append_to(self, path: str) -> int:
        """Append the spans that the profiler did not record (those of the
        worker threads) to the chrome trace exported at `path`. Returns
        how many."""
        with open(path) as f:
            trace = json.load(f)
        add = [e for e in self.events(trace) if e["tid"] != self.anchor_tid]
        trace.setdefault("traceEvents", []).extend(add)
        with open(path, "w") as f:
            json.dump(trace, f)
        return len(add)


SPANS = SpanStore()
_NOOP = contextlib.nullcontext()
_TLS = threading.local()
_IDS = itertools.count(1)
_CALLS = itertools.count(1)
_LOCK = threading.Lock()
_ACTIVE = 0             # recording public calls open in the process


class _Call:
    __slots__ = ("id", "counts")

    def __init__(self):
        self.id = next(_CALLS)
        self.counts: Dict[str, int] = {}


class _Ctx:
    """One thread's part in a recording call: its open spans, and whether
    they are mirrored into the profiler (the calling thread's are)."""
    __slots__ = ("call", "stack", "mirror", "tid")

    def __init__(self, call: _Call, parent: int, mirror: bool):
        self.call, self.stack, self.mirror = call, [parent], mirror
        self.tid = threading.get_native_id()


class _Open:
    """A recording span. `n`: how many spans of its name the call opened
    before it; `attrs`: its attributes. Its start and end bracket its
    `record_function`, so that the mirror's cost lies inside the span and
    the start is read as the anchor is, just before a range opens."""
    __slots__ = ("name", "ctx", "attrs", "id", "parent", "n", "rf", "t0")

    def __init__(self, name: str, ctx: _Ctx):
        self.name, self.ctx, self.attrs = name, ctx, {}

    def __enter__(self):
        ctx = self.ctx
        self.id = next(_IDS)
        self.parent = ctx.stack[-1]
        counts = ctx.call.counts
        self.n = counts.get(self.name, 0)
        counts[self.name] = self.n + 1
        ctx.stack.append(self.id)
        self.rf = None
        self.t0 = time.perf_counter_ns()
        if ctx.mirror:
            self.rf = record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        t1 = time.perf_counter_ns()
        ctx = self.ctx
        ctx.stack.pop()
        SPANS._add(Span(self.name, self.t0, t1, ctx.tid, self.id,
                        self.parent, ctx.call.id, self.attrs))
        return False


class _Root(_Open):
    """A public call's root span: the call's context on this thread."""
    __slots__ = ()

    def __init__(self, name: str):
        super().__init__(name, _Ctx(_Call(), 0, True))

    def __enter__(self):
        global _ACTIVE
        if not SPANS._live:
            SPANS._begin()
        SPANS._live = True
        with _LOCK:
            _ACTIVE += 1
        _TLS.ctx = self.ctx
        return super().__enter__()

    def __exit__(self, *exc):
        global _ACTIVE
        try:
            return super().__exit__(*exc)
        finally:
            _TLS.ctx = None
            with _LOCK:
                _ACTIVE -= 1


def span(name: str):
    """A span of the current call on this thread; the shared no-op context
    (which enters as None) while nothing records here."""
    if not _ACTIVE:
        return _NOOP
    ctx = getattr(_TLS, "ctx", None)
    return _NOOP if ctx is None else _Open(name, ctx)


def call_span(name: str):
    """The root span of a public call: it records exactly while
    torch.profiler records on this thread, checked here once. Inside a call
    that records, a plain span."""
    if getattr(_TLS, "ctx", None) is not None:
        return span(name)
    if not torch.autograd._profiler_enabled():
        SPANS._live = False
        return _NOOP
    return _Root(name)


def on_lane(fn):
    """fn, bound to record on the thread that runs it under the span open
    here, when the current call records; else fn itself."""
    if not _ACTIVE:
        return fn
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None:
        return fn
    call, parent = ctx.call, ctx.stack[-1]

    def run(*args, **kwargs):
        prev = getattr(_TLS, "ctx", None)
        _TLS.ctx = _Ctx(call, parent, False)
        try:
            return fn(*args, **kwargs)
        finally:
            _TLS.ctx = prev
    return run


# The first record_function of a process takes ~1 ms more than later ones,
# around its event's timestamp; taken here, while nothing is profiled, it
# does not shift the first stretch's anchor.
if not torch.autograd._profiler_enabled():
    with record_function(CLOCK):
        pass
