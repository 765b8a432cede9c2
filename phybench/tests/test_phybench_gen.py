"""The traffic generator: the same seed gives the same inputs."""
import numpy as np
import pytest

from phybench import gen, harness

SEED = 2 ** 33 + 12345   # above 32 bits: seeds may be


def small_stream(name, **kw):
    t = dict(harness.traffic(name), captures_per_call=2,
             capture_samples=1 << 15, distinct_bursts=1)
    t.update(kw)
    return t


@pytest.mark.parametrize("name", ["stream_mcs_sweep", "stream_mixed",
                                  "stream_ampdu_4095"])
def test_stream_repeats_from_its_seed(name):
    t = small_stream(name)
    a, b = gen.make_stream(t, SEED), gen.make_stream(t, SEED)
    for ca, cb in zip(a.bursts[0], b.bursts[0]):
        np.testing.assert_array_equal(ca, cb)
    assert a.packets == b.packets
    c = gen.make_stream(t, SEED + 1)
    assert not np.array_equal(a.bursts[0][0], c.bursts[0][0])


def test_batch_repeats_from_its_seed():
    t = dict(harness.traffic("batch_vht7"), rows=4, distinct_batches=2)
    a, b = gen.make_batch(t, SEED), gen.make_batch(t, SEED)
    for xa, xb in zip(a.x, b.x):
        np.testing.assert_array_equal(xa, xb)
    assert a.packets == b.packets
    assert a.packets[0] != a.packets[1]       # distinct batches


@pytest.mark.parametrize("name", ["stream_mcs_sweep", "stream_mixed",
                                  "stream_ampdu_4095"])
def test_every_seed_does_the_same_work(name):
    """Every capture of every seed holds the same packets (rate set, MPDU
    lengths), in an order of its own."""
    t = small_stream(name, capture_samples=1 << 18)

    def work(pk):
        return sorted((p.fmt, p.mcs, p.nss, tuple(map(len, p.mpdus)))
                      for p in pk)
    a, b = gen.make_stream(t, 1), gen.make_stream(t, 2 ** 40 + 3)
    caps = a.packets[0] + b.packets[0]
    assert all(work(pk) == work(caps[0]) for pk in caps)
    assert caps[0] != caps[-1]
    if name == "stream_mcs_sweep":      # L MCS0-7, HT MCS0-7, VHT MCS0-8
        assert len({(p.fmt, p.mcs) for p in caps[0]}) == 25


def test_packets_fit_and_do_not_overlap():
    t = small_stream("stream_ampdu_4095", capture_samples=1 << 17)
    st = gen.make_stream(t, SEED)
    for cap, pk in zip(st.bursts[0], st.packets[0]):
        starts = [p.start for p in pk]
        assert starts == sorted(starts)
        assert all(len(b"".join(p.mpdus)) < 4095 for p in pk)
        assert np.all(cap[:starts[0] - 16] == 0)
