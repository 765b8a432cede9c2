"""`RxStep.forward`'s CUDA graphs (ieee80211_tpu_torch/models/pipeline.py).

On the CPU: a CPU step runs op by op, records its nine stage spans and
never captures; the graph key separates device, shapes, dtypes and
inference mode; the dispatch (eager at a key's first sight, capture at
the second, replay after) and its least-recently-used cap, driven through
a stand-in graph that replays the eager stages on the CPU; the
benchmark's reader of `step_replay_share.batch`.

On the card (marked `card`, skipped without one): replays equal the eager
path bit for bit at perf/bench.py's headline and wideband shapes, a held
result survives the next call, GRAPH_REPLAYS counts the replays, and a
capture beside another thread's CUDA work does not raise. This file
imports neither JAX nor the JAX package, so on the card it runs without
the test directory's conftest:

    python -m pytest tests/test_torch_step_graph.py -q --noconftest
"""
import contextlib
import threading

import pytest
import torch

from ieee80211_tpu_torch import specs
from ieee80211_tpu_torch.models import RxPipeline, pipeline
from ieee80211_tpu_torch.perf import bench
from ieee80211_tpu_torch.utils.metrics import SPANS, Span

STAGES = ("sync_front", "window", "derotate", "grids", "lsig", "chan_est",
          "data_llrs", "viterbi", "descramble")
COUNTERS = ("GRAPH_CAPTURES", "GRAPH_REPLAYS", "EAGER_STEPS")
KEYS = ("bits", "ltf_start", "cfo", "snr", "lsig_ok")


def _counts():
    return {c: getattr(pipeline, c) for c in COUNTERS}


def _small(batch: int = 3, device="cpu", seed: int = 7):
    """A VHT MCS7 step of 8 symbols and `batch` rows of seeded noise."""
    mod = specs.Mod(specs.F.VHT, 7, specs.BW.BW20, 1)
    pipe = RxPipeline(mod, 8, 100, device=device)
    g = torch.Generator().manual_seed(seed)
    x2 = torch.randn(batch, pipe.window_len(), 2, generator=g) * 0.1
    t0 = torch.full((batch,), 8, dtype=torch.int32)
    return pipe, x2.to(device), t0.to(device)


def _same(a: dict, b: dict) -> None:
    assert list(a) == list(b) == list(KEYS)
    for k in KEYS:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.fixture(autouse=True)
def _empty_store():
    SPANS.clear()
    yield
    SPANS.clear()


# -- the CPU ----------------------------------------------------------------

def test_cpu_step_never_captures():
    pipe, x2, t0 = _small()
    before = _counts()
    first = pipe.step(x2, t0)
    again = pipe.step(x2, t0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        third = pipe.step(x2, t0)
    assert _counts() == before
    assert not pipe.step._graphs and not pipe.step._seen
    _same(first, again)
    _same(first, third)
    spans = list(SPANS)
    root = [s for s in spans if s.parent == 0]
    assert [s.name for s in root] == ["step"]
    kids = sorted((s for s in spans if s.parent == root[0].span_id),
                  key=lambda s: s.start)
    assert [s.name for s in kids] == [f"step.{n}" for n in STAGES]
    assert len(spans) == 10


def _variants():
    """(what changes, x2, t0, inference mode) beside the base inputs."""
    x2 = torch.zeros(4, 16, 2)
    t0 = torch.zeros(4, dtype=torch.int32)
    meta = torch.device("meta")
    return [("x2 shape", torch.zeros(5, 16, 2), t0, False),
            ("x2 window", torch.zeros(4, 17, 2), t0, False),
            ("t0 shape", x2, torch.zeros(5, dtype=torch.int32), False),
            ("x2 dtype", x2.double(), t0, False),
            ("t0 dtype", x2, t0.long(), False),
            ("x2 device", x2.to(meta), t0, False),
            ("t0 device", x2, t0.to(meta), False),
            ("inference mode", x2, t0, True)]


@pytest.mark.parametrize("case", range(len(_variants())),
                         ids=[v[0] for v in _variants()])
def test_graph_key_separates(case):
    x2 = torch.zeros(4, 16, 2)
    t0 = torch.zeros(4, dtype=torch.int32)
    base = pipeline.graph_key(x2, t0)
    _, vx, vt, inference = _variants()[case]
    ctx = torch.inference_mode() if inference else contextlib.nullcontext()
    with ctx:
        key = pipeline.graph_key(vx, vt)
    assert key != base
    assert hash(key) is not None


def test_graph_key_ignores_values():
    x2 = torch.zeros(4, 16, 2)
    t0 = torch.zeros(4, dtype=torch.int32)
    assert (pipeline.graph_key(x2, t0)
            == pipeline.graph_key(x2 + 1.0, t0 + 3)
            == pipeline.graph_key(x2[:, :, :].clone(), t0.clone()))


def test_remember_keeps_the_last_four():
    import collections
    lru = collections.OrderedDict()
    for k in range(pipeline.GRAPH_CAP):
        pipeline._remember(lru, k, k)
    lru.move_to_end(0)           # key 0 used again: key 1 is now the oldest
    pipeline._remember(lru, "new", None)
    assert list(lru) == [2, 3, 0, "new"]
    assert len(lru) == pipeline.GRAPH_CAP == 4


class _Stream:
    def wait_event(self, event):
        pass


class _Event:
    def record(self, stream=None):
        pass


class _Graph:
    """A stand-in CUDA graph: replay runs the eager stages on the static
    inputs and writes the static outputs in place, as a replay does."""

    def __init__(self, step, g):
        self.step, self.g = step, g

    def replay(self):
        out = self.step._eager(self.g.x2, self.g.t0)
        for k, v in out.items():
            self.g.out[k].copy_(v)


@pytest.fixture
def cpu_graphs(monkeypatch):
    """Drive RxStep's graph path on the CPU: no card calls, captures by
    `_Graph`. Yields the list of keys captured."""
    captured = []

    def capture(step, x2, t0):
        g = pipeline._Graphed()
        g.x2, g.t0 = x2.clone(), t0.clone()
        g.out = step._eager(g.x2, g.t0)
        g.graph = _Graph(step, g)
        g.done = _Event()
        captured.append(pipeline.graph_key(x2, t0))
        pipeline.GRAPH_CAPTURES += 1
        return g

    monkeypatch.setattr(pipeline.RxStep, "_capture", capture)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _Stream())
    yield captured


def test_first_sight_eager_then_capture_then_replay(cpu_graphs):
    pipe, x2, t0 = _small()
    step = pipe.step
    want = step._eager(x2, t0)
    before = _counts()
    outs = [step._graphed(x2, t0) for _ in range(4)]
    got = _counts()
    assert got["EAGER_STEPS"] - before["EAGER_STEPS"] == 1
    assert got["GRAPH_CAPTURES"] - before["GRAPH_CAPTURES"] == 1
    assert got["GRAPH_REPLAYS"] - before["GRAPH_REPLAYS"] == 3
    assert len(cpu_graphs) == 1 and list(step._graphs) == cpu_graphs
    assert not step._seen
    g = step._graphs[cpu_graphs[0]]
    for out in outs:
        _same(out, want)
        # fresh tensors: none is a static output of the graph
        assert all(out[k].data_ptr() != g.out[k].data_ptr() for k in KEYS)


def test_a_held_result_survives_the_next_replay(cpu_graphs):
    pipe, x2, t0 = _small()
    _, y2, _ = _small(seed=8)
    step = pipe.step
    step._graphed(x2, t0)
    step._graphed(x2, t0)
    held = step._graphed(x2, t0)
    kept = {k: v.clone() for k, v in held.items()}
    other = step._graphed(y2, t0)
    _same(held, kept)
    _same(other, step._eager(y2, t0))
    assert not torch.equal(other["cfo"], held["cfo"])


def test_a_fifth_key_evicts_the_least_recently_used(cpu_graphs):
    pipe, _, _ = _small()
    step = pipe.step
    inputs = [_small(batch=b)[1:] for b in range(1, pipeline.GRAPH_CAP + 2)]
    for x2, t0 in inputs[:-1]:
        step._graphed(x2, t0)
        step._graphed(x2, t0)
    step._graphed(*inputs[0])    # key 0 replayed: key 1 is the oldest
    x2, t0 = inputs[-1]
    step._graphed(x2, t0)
    step._graphed(x2, t0)
    keys = [pipeline.graph_key(*xt) for xt in inputs]
    assert list(step._graphs) == [keys[2], keys[3], keys[0], keys[4]]
    assert len(cpu_graphs) == pipeline.GRAPH_CAP + 1
    # the dropped key starts again from its first sight
    before = _counts()
    step._graphed(*inputs[1])
    assert _counts()["EAGER_STEPS"] == before["EAGER_STEPS"] + 1
    assert keys[1] in step._seen and keys[1] not in step._graphs


def test_moving_the_step_drops_its_graphs(cpu_graphs):
    pipe, x2, t0 = _small()
    step = pipe.step
    step._graphed(x2, t0)
    step._graphed(x2, t0)
    assert step._graphs
    step.to("cpu")
    assert not step._graphs and not step._seen


def test_threads_share_a_step(cpu_graphs, monkeypatch):
    """More threads than cores call one step at once, with a short switch
    interval: each call returns its own input's result, and every call is
    counted once, on one path. The stages are stood in for by a cheap
    function of the inputs, so that the threads contend on the dispatch."""
    import os
    import sys

    def stages(step, x2, t0):
        s = x2.sum(dim=(1, 2))
        return {k: s + i for i, k in enumerate(KEYS)}

    monkeypatch.setattr(pipeline.RxStep, "_eager", stages)
    pipe, _, t0 = _small()
    step = pipe.step
    inputs = [_small(seed=s)[1] for s in range(4)]
    want = [step._eager(x, t0) for x in inputs]
    n_threads = min(2 * len(os.sched_getaffinity(0)) + 2, 130)
    calls = 20
    before = _counts()
    bad, done = [], []

    def work(i):
        for c in range(calls):
            j = (i + c) % len(inputs)
            out = step._graphed(inputs[j], t0)
            if not all(torch.equal(out[k], want[j][k]) for k in KEYS):
                bad.append((i, c))
        done.append(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=240)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert bad == [] and sorted(done) == list(range(n_threads))
    got = {c: _counts()[c] - before[c] for c in COUNTERS}
    assert got == {"EAGER_STEPS": 1, "GRAPH_CAPTURES": 1,
                   "GRAPH_REPLAYS": n_threads * calls - 1}


def test_the_replay_share_reads_replays_over_steps(monkeypatch):
    from phybench import harness
    read = harness.metric("step_replay_share.batch").read
    ms = 1_000_000
    # (name, start ms, end ms, id, parent): a replayed step, a capture
    # call (which replays too) and an eager step
    rows = [("step", 0, 2, 1, 0), ("step.replay", 0, 1, 2, 1),
            ("step", 3, 9, 3, 0), ("step.capture", 3, 8, 4, 3),
            ("step.replay", 8, 9, 5, 3),
            ("step", 10, 15, 6, 0), ("step.viterbi", 11, 12, 7, 6)]
    monkeypatch.setattr(SPANS, "spans", [
        Span(n, a * ms, b * ms, 1, i, p, i, {}) for n, a, b, i, p in rows])
    assert read(dict(counts=dict(steps=3))) == pytest.approx(2 / 3)
    assert read(dict(counts={})) is None
    monkeypatch.setattr(SPANS, "spans", [Span("step", 0, 1, 1, 1, 0, 1, {})])
    assert read(dict(counts=dict(steps=1))) is None


# -- the card ---------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _bench_inputs(cell: dict, dev, noise: float, seed: int):
    """perf/bench.py's rows of `cell` on the card, each with its own
    seeded noise, and the step."""
    b = bench.rx_batch(**cell)
    pipe = RxPipeline(b.mod, b.n_sym, b.psdu_len, device=dev)
    x2 = torch.from_numpy(b.x2).to(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    x2 = x2 + noise * torch.randn(x2.shape, generator=g, device=dev)
    return pipe, x2, torch.from_numpy(b.t0).to(dev)


@pytest.mark.card
@pytest.mark.parametrize("cell", ["headline", "wideband"])
def test_replay_equals_eager_on_the_card(card, cell):
    cfg = {"headline": bench.HEADLINE, "wideband": bench.WIDEBAND}[cell]
    pipe, x2, t0 = _bench_inputs(cfg, card, 0.01, 16)
    _, y2, _ = _bench_inputs(cfg, card, 0.01, 17)
    with torch.inference_mode():
        want = [pipe.step._eager(x, t0) for x in (x2, y2)]
        before = _counts()
        outs = [pipe.step(x, t0) for x in (x2, y2, x2, y2)]
        torch.cuda.synchronize()
    got = _counts()
    assert got["EAGER_STEPS"] - before["EAGER_STEPS"] == 1
    assert got["GRAPH_CAPTURES"] - before["GRAPH_CAPTURES"] == 1
    assert got["GRAPH_REPLAYS"] - before["GRAPH_REPLAYS"] == 3
    for i, out in enumerate(outs):
        _same(out, want[i % 2])


@pytest.mark.card
def test_a_held_result_survives_the_next_call_on_the_card(card):
    pipe, x2, t0 = _bench_inputs(bench.HEADLINE, card, 0.01, 18)
    _, y2, _ = _bench_inputs(bench.HEADLINE, card, 0.02, 19)
    pipe.step(x2, t0)
    pipe.step(x2, t0)
    held = pipe.step(x2, t0)
    kept = {k: v.clone() for k, v in held.items()}
    other = pipe.step(y2, t0)
    torch.cuda.synchronize()
    _same(held, kept)
    assert not torch.equal(other["cfo"], held["cfo"])


@pytest.mark.card
def test_graph_replays_are_counted_on_the_card(card):
    from ieee80211_tpu_torch.ops.cuda import viterbi as kv
    pipe, x2, t0 = _small(batch=64, device=card)
    pipe.step(x2, t0)
    pipe.step(x2, t0)
    before, launches = _counts(), kv.LAUNCHES
    for _ in range(5):
        pipe.step(x2, t0)
    torch.cuda.synchronize()
    got = _counts()
    assert got["GRAPH_REPLAYS"] - before["GRAPH_REPLAYS"] == 5
    assert got["GRAPH_CAPTURES"] == before["GRAPH_CAPTURES"]
    assert got["EAGER_STEPS"] == before["EAGER_STEPS"]
    # a replay calls no kernel wrapper
    assert kv.LAUNCHES == launches


@pytest.mark.card
def test_a_capture_beside_a_busy_thread_on_the_card(card):
    pipe, x2, t0 = _bench_inputs(bench.HEADLINE, card, 0.01, 20)
    stop, errors, rounds = threading.Event(), [], [0]

    def busy():
        try:
            side = torch.cuda.Stream(card)
            host = torch.randn(1 << 20).pin_memory()
            # a generator of its own: PyTorch ties the default CUDA
            # generator to every capture, and it raises in other threads
            # while one is underway
            gen = torch.Generator(device=card).manual_seed(3)
            with torch.cuda.stream(side):
                while not stop.is_set():
                    a = torch.randn(512, 512, device=card, generator=gen)
                    b = (a @ a).sum() + host.to(card, non_blocking=True)[0]
                    torch.empty(1 << 22, device=card).fill_(1.0)
                    side.synchronize()
                    del b
                    rounds[0] += 1
        except Exception as e:          # noqa: BLE001 - reported below
            errors.append(e)

    th = threading.Thread(target=busy)
    th.start()
    try:
        want = pipe.step(x2, t0)         # first sight: eager
        outs = [pipe.step(x2, t0) for _ in range(3)]   # capture, replays
        torch.cuda.current_stream(card).synchronize()
    finally:
        stop.set()
        th.join()
    assert errors == [] and rounds[0] > 0
    for out in outs:
        _same(out, want)
