"""The port's span recorder (ieee80211_tpu_torch/utils/metrics.py) inside
its receivers and its receive step, on the CPU.

Off (no profiler running) a decode records nothing and never enters
torch.profiler.record_function. Under torch.profiler a public call records
its root (`rx.call`, `step`) and every span named in the module docstrings,
all under one call id, each under its parent; the ingest runs on a lane of
its own; every `rx.fetch_wait` is one of the `n_waits`; a decoder built
inside the call shows as `rx.decoder_build`; the calling thread's spans are
the trace's `user_annotation` events, and `SPANS.events` puts them within
100 us of those. The outputs are the same with the profiler on and off.
"""
import json
import time
from collections import Counter

import numpy as np
import pytest
import torch

from ieee80211_tpu_torch import specs
from ieee80211_tpu_torch.models import RxPipeline
from ieee80211_tpu_torch.rx import MimoReceiver, SisoReceiver
from ieee80211_tpu_torch.rx import mimo, receiver
from ieee80211_tpu_torch.utils import metrics
from ieee80211_tpu_torch.utils.metrics import SPANS
from test_dual_chain_universal import _mixed_capture
from torch_parity import mixed_capture

RX_NAMES = {"rx.call", "rx.ingest", "rx.ingest.scan", "rx.ingest.upload",
            "rx.ingest_wait", "rx.sig_dispatch", "rx.fetch_wait", "rx.plan",
            "rx.data_dispatch", "rx.assemble", "rx.decoder_build"}
STAGES = ("sync_front", "window", "derotate", "grids", "lsig", "chan_est",
          "data_llrs", "viterbi", "descramble")
LANE = {"rx.ingest", "rx.ingest.scan", "rx.ingest.upload"}


@pytest.fixture(scope="module")
def siso_caps():
    return [mixed_capture(seed=3, n=4)[0], mixed_capture(seed=4, n=2)[0],
            mixed_capture(seed=5, n=2)[0]]


@pytest.fixture(scope="module")
def dual_caps():
    cap, _ = _mixed_capture()
    return [np.concatenate([np.zeros((2, 64 + 32 * k), np.complex64), cap],
                           axis=1) for k in range(3)]


@pytest.fixture(autouse=True)
def _empty_store():
    SPANS.clear()
    yield
    SPANS.clear()


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _same_results(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert [vars(r) for r in x] == [vars(r) for r in y]


def _check_tree(spans, root):
    """One call id; every parent a span of the call, enclosing its child;
    the root's parent 0."""
    by_id = {s.span_id: s for s in spans}
    roots = [s for s in spans if s.parent == 0]
    assert [s.name for s in roots] == [root]
    assert {s.call for s in spans} == {roots[0].call}
    for s in spans:
        if s.parent:
            p = by_id[s.parent]
            assert p.start <= s.start and s.end <= p.end, (s, p)
    return roots[0], by_id


def _mirrored(spans, prof, tmp_path, tol_us=None):
    """Every span of the calling thread is a user_annotation of the trace;
    with tol_us, SPANS.events puts each within tol_us of its event."""
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    ua = [e for e in trace["traceEvents"]
          if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    main = SPANS.anchor_tid
    mine = [e for e in SPANS.events(trace) if e["tid"] == main]
    assert Counter(e["name"] for e in mine) == Counter(
        e["name"] for e in ua if e["name"] != metrics.CLOCK)
    if tol_us is not None:
        for name in {e["name"] for e in mine}:
            got = sorted(e["ts"] for e in mine if e["name"] == name)
            want = sorted(float(e["ts"]) for e in ua if e["name"] == name)
            assert np.max(np.abs(np.subtract(got, want))) <= tol_us, name
    return trace, mine


def test_off_records_nothing_and_enters_no_record_function(siso_caps,
                                                           monkeypatch):
    entered = []

    class Counting(metrics.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()
    monkeypatch.setattr(metrics, "record_function", Counting)
    rx = SisoReceiver(ingest="int8", device="cpu")
    rx.decode_captures(siso_caps)
    rx.decode_capture_full(siso_caps[0])
    pipe = RxPipeline(specs.Mod(specs.F.VHT, 7, specs.BW.BW20, 1), 8, 100,
                      device="cpu")
    pipe.step(torch.zeros(2, pipe.window_len(), 2),
              torch.zeros(2, dtype=torch.int32))
    assert len(SPANS) == 0 and SPANS.anchor is None and entered == []
    assert metrics.span("x") is metrics._NOOP


@pytest.mark.parametrize("trigger", ["host", "device"])
def test_siso_stream_records_every_span(siso_caps, trigger, tmp_path):
    receiver._cached_decoder.cache_clear()
    rx = SisoReceiver(ingest="int8", trigger=trigger, device="cpu")
    w0 = rx.n_waits
    got, prof = _profiled(lambda: rx.decode_captures(siso_caps))
    spans = list(SPANS)
    names = Counter(s.name for s in spans)
    assert set(names) == RX_NAMES
    assert names["rx.fetch_wait"] == rx.n_waits - w0
    assert names["rx.ingest"] == names["rx.ingest_wait"] == len(siso_caps)
    root, by_id = _check_tree(spans, "rx.call")
    assert root.attrs["captures"] == len(siso_caps)
    main = root.tid
    lane = [s for s in spans if s.name in LANE]
    assert main not in {s.tid for s in lane}
    assert all(s.tid == main for s in spans if s.name not in LANE)
    ingest = sorted((s for s in spans if s.name == "rx.ingest"),
                    key=lambda s: s.start)
    assert [s.attrs["k"] for s in ingest] == list(range(len(siso_caps)))
    assert all(s.parent == root.span_id and s.attrs["mode"] == "int8"
               for s in ingest)
    assert all(by_id[s.parent].name == "rx.ingest" for s in lane
               if s.name != "rx.ingest")
    whats = Counter(s.attrs["what"] for s in spans
                    if s.name == "rx.fetch_wait")
    assert whats["meta"] == len(siso_caps) and whats["data"] >= 1
    assert whats["trigger"] == (len(siso_caps) if trigger == "device" else 0)
    assert all(by_id[s.parent].name == "rx.data_dispatch"
               for s in spans if s.name == "rx.decoder_build")
    dd = [s for s in spans if s.name == "rx.data_dispatch"]
    assert all(s.attrs["rows"] <= s.attrs["padded_rows"] for s in dd)
    _mirrored(spans, prof, tmp_path)
    # a second profiled call builds no decoder; a call that finds the
    # profiler off records nothing and leaves the stretch in the store
    again, _ = _profiled(lambda: rx.decode_captures(siso_caps))
    second = [s for s in SPANS if s.call != root.call]
    assert second and "rx.decoder_build" not in {s.name for s in second}
    n = len(SPANS)
    off = rx.decode_captures(siso_caps)
    assert len(SPANS) == n
    _same_results(got, again)
    _same_results(got, off)


def test_decode_capture_full_spans_sit_on_the_trace(siso_caps, tmp_path):
    rx = SisoReceiver(device="cpu")
    want = rx.decode_capture_full(siso_caps[0])
    got, prof = _profiled(lambda: rx.decode_capture_full(siso_caps[0]))
    assert [vars(r) for r in got[0]] == [vars(r) for r in want[0]]
    spans = list(SPANS)
    root, _ = _check_tree(spans, "rx.call")
    assert {s.tid for s in spans} == {root.tid}
    assert {"rx.ingest", "rx.ingest.scan", "rx.ingest.upload",
            "rx.sig_dispatch", "rx.fetch_wait", "rx.plan",
            "rx.data_dispatch", "rx.assemble"} <= {s.name for s in spans}
    trace, mine = _mirrored(spans, prof, tmp_path, tol_us=100.0)
    assert len(mine) == len(spans)
    # the profiler's trace lacks no lane here: nothing to append
    path = str(tmp_path / "trace.json")
    assert SPANS.append_to(path) == 0


def test_a_new_stretch_clears_the_store(siso_caps):
    rx = SisoReceiver(device="cpu")
    _profiled(lambda: rx.decode_capture(siso_caps[1]))
    first = {s.call for s in SPANS}
    anchor = SPANS.anchor
    rx.decode_capture(siso_caps[1])                # the stretch ends
    _profiled(lambda: rx.decode_capture(siso_caps[2]))
    second = {s.call for s in SPANS}
    assert len(first) == len(second) == 1 and first != second
    assert SPANS.anchor != anchor and SPANS.dropped == 0
    # two profiles back to back: clear() ends the stretch between them
    SPANS.clear()
    _profiled(lambda: rx.decode_capture(siso_caps[1]))
    third = {s.call for s in SPANS}
    assert len(third) == 1 and third != second
    assert SPANS.anchor is not None


def test_a_late_clock_range_is_not_the_anchor(monkeypatch, tmp_path):
    """A `phy.clock` range that opens 3 ms after its read (its thread
    descheduled between the two) is passed over: the spans stay on their
    mirrors."""
    late = iter([False] * metrics.CLOCK_READS + [True])

    class Late(metrics.record_function):
        def __enter__(self):
            if self.name == metrics.CLOCK and next(late, False):
                time.sleep(0.003)
            return super().__enter__()
    monkeypatch.setattr(metrics, "record_function", Late)

    def call():
        with metrics.call_span("rx.call"):
            with metrics.span("rx.plan"):
                pass
    _, prof = _profiled(call)
    assert SPANS.anchor_at != -1
    _mirrored(list(SPANS), prof, tmp_path, tol_us=100.0)


def test_the_store_counts_what_it_drops(siso_caps, monkeypatch):
    monkeypatch.setattr(SPANS, "cap", 5)
    rx = SisoReceiver(device="cpu")
    _profiled(lambda: rx.decode_captures(siso_caps))
    assert len(SPANS) == 5 and SPANS.dropped > 0


def test_step_records_its_nine_stages(tmp_path):
    mod = specs.Mod(specs.F.VHT, 7, specs.BW.BW20, 1)
    pipe = RxPipeline(mod, 8, 100, device="cpu")
    g = torch.Generator().manual_seed(7)
    x2 = torch.randn(3, pipe.window_len(), 2, generator=g) * 0.1
    t0 = torch.full((3,), 8, dtype=torch.int32)
    want = pipe.step(x2, t0)
    got, prof = _profiled(lambda: pipe.step(x2, t0))
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   equal_nan=True)
    spans = list(SPANS)
    root, _ = _check_tree(spans, "step")
    kids = sorted((s for s in spans if s.parent == root.span_id),
                  key=lambda s: s.start)
    assert [s.name for s in kids] == [f"step.{n}" for n in STAGES]
    assert len(spans) == 10
    _mirrored(spans, prof, tmp_path, tol_us=100.0)


@pytest.mark.parametrize("ingest", ["int8", "f32"])
def test_mimo_stream_records_every_span(dual_caps, ingest, tmp_path):
    mimo._cached_mrc.cache_clear()
    mimo._cached_mimo.cache_clear()
    rx = MimoReceiver(ingest=ingest, device="cpu")
    w0 = rx.n_waits
    got, prof = _profiled(lambda: rx.decode_captures(dual_caps))
    spans = list(SPANS)
    names = Counter(s.name for s in spans)
    assert set(names) == RX_NAMES
    assert names["rx.fetch_wait"] == rx.n_waits - w0
    root, by_id = _check_tree(spans, "rx.call")
    ingest_sp = [s for s in spans if s.name == "rx.ingest"]
    assert len(ingest_sp) == len(dual_caps)
    assert all(s.parent == root.span_id and s.tid != root.tid
               for s in ingest_sp)
    scans = [s for s in spans if s.name == "rx.ingest.scan"]
    assert all(by_id[s.parent].name == "rx.ingest" for s in scans)
    if ingest == "int8":
        # each chain scans on a lane of its own
        assert len(scans) == 2 * len(dual_caps)
        assert all(Counter(s.attrs["chain"] for s in scans
                           if s.parent == i.span_id) == {0: 1, 1: 1}
                   for i in ingest_sp)
        assert root.tid not in {s.tid for s in scans}
        assert {s.tid for s in scans}.isdisjoint({s.tid for s in ingest_sp})
    kinds = {s.attrs["kind"] for s in spans if s.name == "rx.decoder_build"}
    assert "mrc" in kinds and "mimo_zf" in kinds
    _mirrored(spans, prof, tmp_path)
    path = str(tmp_path / "trace.json")
    lanes = sum(s.tid != root.tid for s in spans)
    assert SPANS.append_to(path) == lanes > 0
    with open(path) as f:
        assert sum(e.get("cat") == "phy_span"
                   for e in json.load(f)["traceEvents"]) == lanes
    off = MimoReceiver(ingest=ingest, device="cpu").decode_captures(
        dual_caps)
    _same_results(got, off)


def test_mimo_decode_capture_full(dual_caps, tmp_path):
    rx = MimoReceiver(device="cpu")
    want = rx.decode_capture_full(dual_caps[0])
    got, prof = _profiled(lambda: rx.decode_capture_full(dual_caps[0]))
    assert [vars(r) for r in got[0]] == [vars(r) for r in want[0]]
    assert len(got[1]) == len(want[1]) == 1
    spans = list(SPANS)
    root, _ = _check_tree(spans, "rx.call")
    assert RX_NAMES - {"rx.ingest_wait", "rx.decoder_build"} <= {
        s.name for s in spans}
    _mirrored(spans, prof, tmp_path, tol_us=100.0)


def test_mu_lanes_record_their_spans():
    """With mu_gid set, the MU SIG-B lane and the MU DATA groups run under
    the same names: their SIG-B fetch is an `rx.fetch_wait` of its own and
    their decoders' builds show."""
    from ieee80211_tpu.mac import build_udp_mpdu
    from ieee80211_tpu_torch.mu import sounding
    from test_mu_stream import CFG, GID, _build_mixed_capture
    from torch_parity import add_noise
    mpdus = [build_udp_mpdu(p, CFG) for p in (
        b"su packet payload for the stream",
        b"mu user zero stream payload 0000",
        b"mu user one stream payload 1111")]
    cap = add_noise(_build_mixed_capture(None, *mpdus), 30.0, seed=12)
    caps = [cap, np.concatenate([np.zeros(96, np.complex64), cap])]
    sounding._cached_data.cache_clear()
    sounding._cached_sigb_tables.cache_clear()
    rx = SisoReceiver(mu_pos=0, mu_gid=GID, device="cpu")
    w0 = rx.n_waits
    got, _ = _profiled(lambda: rx.decode_captures(caps))
    assert all(any(r.mu and r.fcs_ok for r in out) for out in got)
    spans = list(SPANS)
    _check_tree(spans, "rx.call")
    names = Counter(s.name for s in spans)
    assert names["rx.fetch_wait"] == rx.n_waits - w0
    whats = Counter(s.attrs["what"] for s in spans
                    if s.name == "rx.fetch_wait")
    assert whats["mu_sigb"] == len(caps)
    # per capture: the SU plan, the MU candidates and the MU plans
    assert names["rx.plan"] == 3 * len(caps)
    assert names["rx.sig_dispatch"] == 2 * len(caps)
    kinds = {s.attrs["kind"] for s in spans if s.name == "rx.decoder_build"}
    assert {"mu_sigb", "mu_data"} <= kinds
    off = SisoReceiver(mu_pos=0, mu_gid=GID, device="cpu").decode_captures(
        caps)
    _same_results(got, off)
