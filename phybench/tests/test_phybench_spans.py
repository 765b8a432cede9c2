"""The readers of the program's spans: known sums on a synthetic span set,
and a traced CPU run of each cell (small), which reports its own span
metrics and none of the other cell's."""
import time

import pytest
import torch

from phybench import harness, run, trace
from ieee80211_tpu_torch.utils.metrics import SPANS, Span

STREAM = ("ingest_ms_per_capture.stream", "ingest_wait.stream",
          "fetch_wait.stream", "host_ms_per_packet.stream")
BATCH = ("step_host_ms.batch",)
SMALL = {
    "siso20.stream_ampdu_4095": dict(capture_samples=1 << 16,
                                     captures_per_call=2, distinct_bursts=1),
    "siso20.batch_vht7": dict(rows=8, distinct_batches=1),
}
MS = 1_000_000     # ns


@pytest.fixture(autouse=True)
def _empty_store():
    SPANS.clear()
    yield
    SPANS.clear()


def _read(ctx):
    return {m: harness.metric(m).read(ctx) for m in STREAM + BATCH}


def test_the_readers_sum_what_they_should(monkeypatch):
    main, lane = 11, 22
    # (name, start ms, end ms, tid, id, parent)
    rows = [("rx.call", 0, 100, main, 1, 0),
            ("rx.ingest", 0, 30, lane, 2, 1),
            ("rx.ingest.scan", 0, 20, lane, 3, 2),
            ("rx.ingest", 30, 50, lane, 4, 1),
            ("rx.ingest_wait", 0, 30, main, 5, 1),
            ("rx.sig_dispatch", 30, 32, main, 6, 1),
            ("rx.plan", 32, 40, main, 7, 1),
            ("rx.fetch_wait", 32, 37, main, 8, 7),
            ("rx.data_dispatch", 40, 46, main, 9, 1),
            ("rx.decoder_build", 41, 45, main, 10, 9),
            ("rx.fetch_wait", 46, 50, main, 11, 1),
            ("rx.assemble", 50, 53, main, 12, 1),
            ("step", 200, 204, main, 13, 0),
            ("step.viterbi", 201, 203, main, 14, 13),
            ("step", 300, 302, main, 15, 0)]
    monkeypatch.setattr(SPANS, "spans", [
        Span(n, a * MS, b * MS, t, i, p, 1, {}) for n, a, b, t, i, p in rows])
    ctx = dict(trace=trace.Trace(0.5, [], [], []),
               counts=dict(calls=2, packets=4, steps=2),
               traffic=dict(captures_per_call=2))
    got = _read(ctx)
    assert got["ingest_ms_per_capture.stream"] == pytest.approx(50 / 4)
    assert got["ingest_wait.stream"] == pytest.approx(0.030 / 0.5)
    assert got["fetch_wait.stream"] == pytest.approx(0.009 / 0.5)
    # self time: 2 + (8 - 5) + (6 - 4) + 3 ms over 4 packets
    assert got["host_ms_per_packet.stream"] == pytest.approx(10 / 4)
    assert got["step_host_ms.batch"] == pytest.approx(6 / 2)
    # no window, no counts, no spans: nothing
    assert set(_read(dict(trace=None, counts={})).values()) == {None}
    monkeypatch.setattr(SPANS, "spans", [])
    assert set(_read(ctx).values()) == {None}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_traced_run_reports_its_span_metrics(name):
    line, _, _ = run.run_cell(name, 2 ** 33 + 3, 0.1, True,
                              torch.device("cpu"), time.time(),
                              overrides=SMALL[name])
    mine, other = (STREAM, BATCH) if "stream" in name else (BATCH, STREAM)
    units = {m["name"]: m["unit"] for m in harness.benchmark()["per_layer"]}
    assert line["correct"]
    for m in mine:
        assert line["metrics"][m]["value"] > 0
        assert line["metrics"][m]["unit"] == units[m]
    assert not set(other) & set(line["metrics"])
    # the other cell's readers find nothing of theirs in these spans
    ctx = dict(trace=trace.Trace(1.0, [], [], []),
               counts=dict(calls=1, packets=1, steps=1),
               traffic=dict(captures_per_call=1))
    assert {harness.metric(m).read(ctx) for m in other} == {None}
    # the root spans cover the traced calls
    roots = [s for s in SPANS if s.parent == 0]
    assert {s.name for s in roots} == {"rx.call" if "stream" in name
                                       else "step"}
