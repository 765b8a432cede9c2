"""The port's copy of the native host runtime (ieee80211_tpu_torch/native/,
built from its own phyrt.cc into ieee80211_tpu_torch/_build/) gives the
JAX package's results: trigger scan, fused scan + int8 quantization, int8
quantization, CRC-32, bit packing and the A-MPDU delimiter walk.
"""
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


def _capture(seed):
    cap, _ = mixed_capture(seed=seed, n=4)
    return np.concatenate([np.zeros(300, np.complex64), cap])


@pytest.mark.parametrize("seed", [41, 42])
@pytest.mark.parametrize("lag", [16, 32])
def test_find_triggers_equals_jax(seed, lag):
    cap = _capture(seed)
    for thresh, plateau, min_gap in ((0.5, 20, 400), (0.3, 10, 100)):
        kw = dict(thresh=thresh, plateau=plateau, min_gap=min_gap, lag=lag)
        got = native.find_triggers(cap, **kw)
        want = jnative.find_triggers(cap, **kw)
        np.testing.assert_array_equal(got, want)
    # a capture that is not complex64 goes through a float32 copy
    wide = cap.astype(np.complex128)
    np.testing.assert_array_equal(native.find_triggers(wide, lag=lag),
                                  jnative.find_triggers(wide, lag=lag))


@pytest.mark.parametrize("seed", [43, 44])
def test_quantization_equals_jax(seed):
    cap = _capture(seed)
    got_q, want_q = (np.empty((len(cap), 2), np.int8) for _ in range(2))
    assert native.quantize_int8(cap, got_q) == jnative.quantize_int8(
        cap, want_q)
    np.testing.assert_array_equal(got_q, want_q)
    got_q[:] = 0
    want_q[:] = 0
    (t_got, s_got), (t_want, s_want) = (
        native.scan_quantize(cap, got_q), jnative.scan_quantize(cap, want_q))
    np.testing.assert_array_equal(t_got, t_want)
    assert s_got == s_want
    np.testing.assert_array_equal(got_q, want_q)


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
