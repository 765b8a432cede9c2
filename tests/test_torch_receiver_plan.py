"""The streaming receiver's host-side planner and byte tail
(ieee80211_tpu_torch/rx/receiver.py) against the JAX package's.

The port carries numpy copies of `_plan_batch`, `_plan_one`,
`parse_ht_sig`, `parse_vht_siga`, `group_pad`, `_bucket` and
`assemble_psdu`, because their JAX module imports jax. Here both packages
plan the same packed meta, from real captures and from random meta made
from a seed, and must give the same plans field for field.
"""
import dataclasses

import numpy as np
import pytest

from ieee80211_tpu.rx import receiver as jrx
from ieee80211_tpu.specs import BW, F, Mod
from ieee80211_tpu_torch.rx import receiver as rx
from torch_parity import mixed_capture

RATES = [20e6, 40e6, 80e6]


def _random_meta(rng, n: int, bw: BW):
    """Packed-meta fields that reach every branch of the planner: legacy,
    HT and VHT picks, NDPs, MU group ids, mismatched bandwidths, SGI,
    multi-stream MCSs, lengths around the limits, and windows near the
    capture's end."""
    l_mcs = np.where(rng.random(n) < 0.6, 0, rng.integers(0, 8, n))
    ht = rng.integers(0, 2, (n, 48))
    ht[:, 0:7] = np.where(rng.random((n, 1)) < 0.7,
                          rng.integers(0, 2, (n, 7)) * [1, 1, 1, 0, 0, 0, 0],
                          ht[:, 0:7])
    ht_len = rng.integers(0, 5000, n)
    ht[:, 8:24] = (ht_len[:, None] >> np.arange(16)) & 1
    ht[:, 7] = np.where(rng.random(n) < 0.7, int(bw == BW.BW40), ht[:, 7])
    ht[:, 31] = rng.random(n) < 0.1
    vht = rng.integers(0, 2, (n, 48))
    vbw = np.where(rng.random(n) < 0.7, int(bw), rng.integers(0, 3, n))
    vht[:, 0], vht[:, 1] = vbw & 1, vbw >> 1
    gid = np.where(rng.random(n) < 0.8, rng.choice([0, 63], n),
                   rng.integers(0, 64, n))
    vht[:, 4:10] = (gid[:, None] >> np.arange(6)) & 1
    nsts = np.where(rng.random(n) < 0.8, 0, rng.integers(0, 8, n))
    vht[:, 10:13] = (nsts[:, None] >> np.arange(3)) & 1
    vht[:, 24] = rng.random(n) < 0.1
    vht[:, 28:32] = rng.integers(0, 2, (n, 4)) * [1, 1, 1, 0]
    ws = rng.integers(0, 200000, n)
    return {
        "lsig_ok": (rng.random(n) < 0.9).astype(np.int32),
        "snr": rng.normal(15, 10, n).astype(np.float32),
        "win_start": ws.astype(np.int32),
        "ltf_start": rng.integers(180, 300, n).astype(np.int32),
        "cfo": rng.normal(0, 0.01, n).astype(np.float32),
        "l_mcs": l_mcs.astype(np.int32),
        "l_len": np.where(rng.random(n) < 0.1, rng.integers(0, 40, n),
                          rng.integers(0, 4200, n)).astype(np.int32),
        # no HT packet exists at 80 MHz; there an HT-SIG passing its CRC
        # plans Mod(F.HT, mcs, BW80), which raises in both packages
        "ht_ok": ((rng.random(n) < 0.5) & (bw != BW.BW80)).astype(np.int32),
        "vht_ok": (rng.random(n) < 0.5).astype(np.int32),
        "nl1_imag_dom": (rng.random(n) < 0.5).astype(np.int32),
        "ht_bits": ht.astype(np.int32),
        "vht_bits": vht.astype(np.int32),
    }


def _assert_plans_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            assert int(g[0]) == int(w[0])
            g, w = g[1], w[1]
        assert dataclasses.asdict(g) == dataclasses.asdict(w)


@pytest.mark.parametrize("fs", RATES, ids=["20MHz", "40MHz", "80MHz"])
def test_plan_batch_and_plan_one_equal_jax_on_random_meta(fs):
    port = rx.SisoReceiver(sample_rate_hz=fs, device="cpu")
    ref = jrx.SisoReceiver(sample_rate_hz=fs)
    rng = np.random.default_rng(int(fs // 1e6))
    n, cap_len = 3000, 150000
    meta = _random_meta(rng, n, port.bw)
    got, got_ndp = port._plan_batch(cap_len, meta, n)
    want, want_ndp = ref._plan_batch(cap_len, meta, n)
    assert len(want) > 10 and len(want_ndp) > 5   # the gates pass some
    _assert_plans_equal(got, want)
    _assert_plans_equal(got_ndp, want_ndp)
    fmts = {p.mod.fmt for _, p in want}
    assert fmts == ({F.L, F.HT, F.VHT} if fs == 20e6 else {F.HT, F.VHT}
                    if fs == 40e6 else {F.VHT})
    for i in range(0, n, 7):
        g, w = port._plan_one(cap_len, meta, i), ref._plan_one(cap_len,
                                                               meta, i)
        assert (g is None) == (w is None)
        if w is not None:
            assert dataclasses.asdict(g) == dataclasses.asdict(w)


def test_plan_batch_equals_jax_on_a_real_capture():
    cap, _ = mixed_capture(seed=31, n=6)
    port = rx.SisoReceiver(device="cpu")
    t0s, cap_dev, npad = port._ingest(cap)
    meta = port._parse_sigs(cap_dev, npad, t0s)
    got, _ = port._plan_batch(len(cap), meta, len(t0s))
    want, _ = jrx.SisoReceiver()._plan_batch(len(cap), meta, len(t0s))
    assert len(want) == 6
    _assert_plans_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 3, 100, 256, 257, 720, 1000])
def test_group_pad_and_bucket(n):
    assert rx.group_pad(n) == jrx.group_pad(n)
    assert rx._bucket(n) == jrx._bucket(n)
    assert rx.next_pow2(n, lo=32) == jrx.next_pow2(n, lo=32)


def test_sig_field_parsers_equal_jax():
    rng = np.random.default_rng(4)
    for bits in rng.integers(0, 2, (200, 48)):
        assert rx.parse_ht_sig(bits) == jrx.parse_ht_sig(bits)
        if bits[0] and bits[1]:              # bandwidth 3 does not exist
            with pytest.raises(ValueError):
                rx.parse_vht_siga(bits)
            with pytest.raises(ValueError):
                jrx.parse_vht_siga(bits)
        else:
            assert rx.parse_vht_siga(bits) == jrx.parse_vht_siga(bits)


@pytest.mark.parametrize("fmt,ampdu", [(F.L, False), (F.HT, False),
                                       (F.HT, True), (F.VHT, True)])
def test_assemble_psdu_equals_jax(fmt, ampdu):
    from ieee80211_tpu.mac import (MacConfig, aggregate_ht, aggregate_vht,
                                   build_udp_mpdu)
    mpdu = build_udp_mpdu(b"assemble" * 9, MacConfig(subtype=8))
    psdu = {F.VHT: aggregate_vht, F.HT: aggregate_ht}.get(
        fmt, lambda m: m[0])([mpdu]) if ampdu else mpdu
    mod = Mod(fmt, 3)
    mid = len(psdu) // 2
    for data in (psdu, psdu[:mid] + bytes([psdu[mid] ^ 1]) + psdu[mid + 1:]):
        got = rx.assemble_psdu(fmt, mod, data, ampdu, 1.5, 20.0, 25.0,
                               sigb_ok=True)
        want = jrx.assemble_psdu(fmt, mod, data, ampdu, 1.5, 20.0, 25.0,
                                 sigb_ok=True)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.fcs_ok is False and want.fcs_ok is False
