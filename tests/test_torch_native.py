"""The port's copy of the native host runtime (ieee80211_tpu_torch/native/,
built from its own phyrt.cc into ieee80211_tpu_torch/_build/) gives the
JAX package's results: trigger scan, fused scan + int8 quantization, int8
quantization, CRC-32, bit packing and the A-MPDU delimiter walk.

The port's scan and quantization run wide; the captures of `CASES` hold
them bit-equal to the JAX package's plain loops where the arithmetic is at
its edges: exact .5 ties, the far ends of the float range, zeros, NaN and
inf samples, lengths on both sides of the vector width and of the scan's
blocks, long silences in which the rolling sums drift, and the benchmark's
2^20-sample A-MPDU capture.
"""
import functools
import json
import threading
from pathlib import Path

import numpy as np
import pytest

from ieee80211_tpu import native as jnative
from ieee80211_tpu.mac import MacConfig, aggregate_ht, aggregate_vht
from ieee80211_tpu.mac import build_udp_mpdu
from ieee80211_tpu_torch import native
from ieee80211_tpu_torch.native import lib
from torch_parity import MAC, mixed_capture

REPO = Path(__file__).resolve().parents[1]


def test_library_is_built_in_the_ports_build_directory():
    assert native.available() and jnative.available()
    so = Path(lib._SO)
    assert so.parent == REPO / "ieee80211_tpu_torch" / "_build"
    assert so.is_file()
    assert Path(lib._SRC) == REPO / "ieee80211_tpu_torch" / "native" / (
        "phyrt.cc")


@functools.lru_cache(maxsize=None)
def _ampdu_capture() -> np.ndarray:
    """One capture of the benchmark's stream_ampdu_4095 traffic: 2^20
    samples, 105 VHT MCS7 / MCS8 A-MPDUs at 30 dB with zeros between."""
    from phybench.gen import make_stream
    traffic = json.loads((REPO / "phybench" / "traffic" /
                          "stream_ampdu_4095.json").read_text())
    traffic.update(distinct_bursts=1, captures_per_call=1)
    return make_stream(traffic, seed=5000001901).bursts[0][0]


def _with(cap, at, values):
    cap = cap.copy()
    cap[np.asarray(at)] = values
    return cap


def _ties():
    """Peak exactly 126, so the scale is 1.0 and every value on a half
    step: a fourth of them scale onto exact .5 ties."""
    cap = _capture(41)
    iq = cap.view(np.float32)
    iq *= np.float32(126.0) / np.abs(iq).max()
    iq[:] = np.round(iq * 2) / 2
    iq[5000] = -126.0
    return cap


def _far_range():
    """The peak near the float32 maximum beside subnormal values: the
    scale and the scan's sums at the ends of the float range."""
    cap = _capture(42) * np.float32(1e-40)
    return _with(cap, [7000, 9000], [3.0e38 - 2.9e38j, 1e-45 + 1e-45j])


def _drift():
    """Bursts apart by long exact silences, in which the rolling sums
    drift below zero."""
    a, b = _capture(43), _capture(44)
    z = np.zeros(150_000, np.complex64)
    return np.concatenate([a, z, b, z[:70_001], a * np.float32(0.01)])


def _crop(n):
    return lambda: _ampdu_capture()[:n].copy()


CASES = {
    "ties": _ties,
    "far_range": _far_range,
    "zeros": lambda: np.zeros(70_003, np.complex64),
    # NaN late in the capture, and in the last sample of every lane of the
    # peak's wide loop
    "nan": lambda: _with(_capture(41), [9000, 9001, 9002, *range(-16, 0)],
                         [complex(np.nan, 0.0), complex(0.0, np.nan),
                          complex(np.nan, np.nan), *[np.nan] * 16]),
    "inf": lambda: _with(_capture(42), [9000, 9002, 9999],
                         [complex(np.inf, 0.0), complex(0.0, -np.inf),
                          complex(-np.inf, np.inf)]),
    # (inf, NaN) inside a packet: std::complex's multiply turns its NaN
    # product into an infinite one, and that fires a trigger
    "inf_nan": lambda: _with(_capture(42), [5000], [complex(np.inf, np.nan)]),
    "len31": _crop(31),
    "len33": _crop(33),
    "len1001": _crop(1001),
    # at lag 16: one block of 256 scan positions, then two and one more
    "len287": _crop(287),
    "len544": _crop(544),
    "len262181": _crop((1 << 18) + 37),
    "drift": _drift,
    "ampdu_2e20": lambda: _ampdu_capture(),
}


def _capture(case):
    """A seeded mixed capture behind 300 zeros (int case), or a capture of
    `CASES`."""
    if isinstance(case, str):
        return CASES[case]()
    cap, _ = mixed_capture(seed=case, n=4)
    return np.concatenate([np.zeros(300, np.complex64), cap])


def _scan_quantize_equal(cap, **kw):
    """Both libraries' fused pass: the same triggers, scale and int8."""
    got_q, want_q = (np.full((len(cap), 2), 99, np.int8) for _ in range(2))
    (t_got, s_got), (t_want, s_want) = (
        native.scan_quantize(cap, got_q, **kw),
        jnative.scan_quantize(cap, want_q, **kw))
    np.testing.assert_array_equal(t_got, t_want)
    assert s_got == s_want
    np.testing.assert_array_equal(got_q, want_q)
    return t_got, s_got, got_q


@pytest.mark.parametrize("case", [41, 42, *CASES])
@pytest.mark.parametrize("lag", [16, 32, 64])
def test_find_triggers_equals_jax(case, lag):
    cap = _capture(case)
    for thresh, plateau, min_gap in ((0.5, 20, 400), (0.3, 10, 100)):
        kw = dict(thresh=thresh, plateau=plateau, min_gap=min_gap, lag=lag)
        got = native.find_triggers(cap, **kw)
        want = jnative.find_triggers(cap, **kw)
        np.testing.assert_array_equal(got, want)
        _scan_quantize_equal(cap, **kw)
    # max_out reached early
    for max_out in (1, 2):
        np.testing.assert_array_equal(
            native.find_triggers(cap, lag=lag, max_out=max_out),
            jnative.find_triggers(cap, lag=lag, max_out=max_out))
        _scan_quantize_equal(cap, lag=lag, max_out=max_out)
    # a capture that is not complex64 goes through a float32 copy
    wide = cap.astype(np.complex128)
    np.testing.assert_array_equal(native.find_triggers(wide, lag=lag),
                                  jnative.find_triggers(wide, lag=lag))


@pytest.mark.parametrize("case", [43, 44, *CASES])
def test_quantization_equals_jax(case):
    cap = _capture(case)
    got_q, want_q = (np.empty((len(cap), 2), np.int8) for _ in range(2))
    assert native.quantize_int8(cap, got_q) == jnative.quantize_int8(
        cap, want_q)
    np.testing.assert_array_equal(got_q, want_q)
    _, _, fused_q = _scan_quantize_equal(cap)
    np.testing.assert_array_equal(fused_q, got_q)
    _scan_quantize_equal(cap, max_out=1)


def test_scan_quantize_on_two_threads_at_once():
    """Two Python threads in scan_quantize at once, as MimoReceiver's two
    chains run it, give what each call gives alone."""
    caps = [_ampdu_capture(), _capture("len262181")[::-1].copy()]
    alone = [_scan_quantize_equal(c) for c in caps]
    for _ in range(3):
        outs = [np.zeros((len(c), 2), np.int8) for c in caps]
        res = [None, None]
        start = threading.Barrier(2)

        def run(k):
            start.wait(timeout=60)
            res[k] = native.scan_quantize(caps[k], outs[k])

        threads = [threading.Thread(target=run, args=(k,)) for k in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        for k, (trig, scale, q) in enumerate(alone):
            np.testing.assert_array_equal(res[k][0], trig)
            assert res[k][1] == scale
            np.testing.assert_array_equal(outs[k], q)


def test_crc32_and_pack_bits_equal_jax():
    rng = np.random.default_rng(45)
    for n in (0, 1, 3, 64, 1501):
        data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        assert native.crc32(data) == jnative.crc32(data)
        bits = rng.integers(0, 2, 8 * n).astype(np.uint8)
        assert native.pack_bits(bits) == jnative.pack_bits(bits)


@pytest.mark.parametrize("vht", [True, False], ids=["vht", "ht"])
def test_deagg_equals_jax(vht):
    rng = np.random.default_rng(46)
    mpdus = [build_udp_mpdu(bytes(rng.integers(0, 256, int(n),
                                               dtype=np.uint8)),
                            MacConfig(seq=int(n), **MAC))
             for n in (10, 333, 57)]
    psdu = (aggregate_vht if vht else aggregate_ht)(mpdus)
    bad = bytearray(psdu)
    bad[40] ^= 1
    for p in (psdu, bytes(bad), psdu[:100], b""):
        for max_sub in (64, 2):
            assert native.deagg(p, vht=vht, max_sub=max_sub) == (
                jnative.deagg(p, vht=vht, max_sub=max_sub))
