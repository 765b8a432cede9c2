"""The port's downlink MU lanes in both streaming receivers
(`SisoReceiver(mu_gid=...)`, `MimoReceiver(mu_gid=...)`) against the JAX
package's, on the captures of tests/test_mu_stream.py: a mixed SU + MU
stream, a station at the other position, a group it is not in, a 4-user
group, 40 and 80 MHz, and the dual-chain receiver at 20 and 40 MHz.

Both packages must give the same packet list: (trigger order, format, MCS,
MU flag, FCS, SIG-B flag, MPDUs) exactly, CFO, SNR and EVM SNR within the
tolerances of `torch_parity.assert_same_packets_all`. The JAX receiver
decodes at radix 3 on the CPU and the port at radix 4; these captures are
noiseless or at 30 dB, where both radices give the transmitted bits. The
numpy MU planner copies (`_plan_mu_batch`, `_plan_mu_data`) are pinned to
the JAX ones field for field on random SIG metadata and words.
"""
import dataclasses

import numpy as np
import pytest
import torch

from ieee80211_tpu.mac import aggregate_vht, build_udp_mpdu
from ieee80211_tpu.rx import SisoReceiver as JaxSisoReceiver
from ieee80211_tpu.rx import receiver as jrx
from ieee80211_tpu.rx.mimo import MimoReceiver as JaxMimoReceiver
from ieee80211_tpu.specs import BW, F, Mod
from ieee80211_tpu.tx import finalize, gen_ampdu, gen_ampdu_mu
from ieee80211_tpu_torch.ops.cuda import gather as kg
from ieee80211_tpu_torch.ops.cuda import viterbi as kv
from ieee80211_tpu_torch.rx import MimoReceiver, SisoReceiver
from ieee80211_tpu_torch.rx import receiver as rx
from test_mu_stream import CFG, GID, _build_mixed_capture, _mu_wave
from test_torch_receiver_plan import _assert_plans_equal, _random_meta
from torch_parity import (CFO_HZ_TOL, EVM_TOL, add_noise,
                          assert_same_packets_all, snr_tol_db)


def _same(got, want):
    """The two packages' packet lists: fields exactly, metrics within the
    stated tolerances (EVM SNR only where noise sets it: a noiseless
    packet's EVM SNR measures float32 rounding)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.fmt, g.mcs, g.mu, g.fcs_ok, g.sigb_ok, g.psdu, g.mpdus,
                len(g.sssnr)) == (w.fmt, w.mcs, w.mu, w.fcs_ok, w.sigb_ok,
                                  w.psdu, w.mpdus, len(w.sssnr))
        assert abs(g.cfo_hz - w.cfo_hz) <= CFO_HZ_TOL
        assert abs(g.snr_db - w.snr_db) <= snr_tol_db(w.snr_db)
        if w.evm_snr_db < 60.0:
            assert abs(g.evm_snr_db - w.evm_snr_db) <= EVM_TOL


def _mpdus():
    return (build_udp_mpdu(b"su packet payload for the stream", CFG),
            build_udp_mpdu(b"mu user zero stream payload 0000", CFG),
            build_udp_mpdu(b"mu user one stream payload 1111", CFG))


@pytest.fixture(scope="module")
def mixed():
    """test_mu_stream's mixed SU + MU capture at 30 dB, three offsets."""
    m_su, m0, m1 = _mpdus()
    cap = add_noise(_build_mixed_capture(None, m_su, m0, m1), 30.0, seed=12)
    caps = [np.concatenate([np.zeros(64 + 32 * k, np.complex64), cap])
            for k in range(3)]
    return caps, (m_su, m0, m1)


def test_mu_stream_equals_jax(mixed):
    """decode_captures: the MU packet surfaces from the same pipelined
    dispatch as the SU traffic, as in JAX."""
    caps, (_, m0, _) = mixed
    prx = SisoReceiver(mu_pos=0, mu_gid=GID, device="cpu")
    stream = prx.decode_captures(caps)
    jstream = JaxSisoReceiver(mu_pos=0, mu_gid=GID).decode_captures(caps)
    for got, want in zip(stream, jstream):
        _same(got, want)
        assert [(r.mu, r.fcs_ok) for r in got] == [(False, True),
                                                   (True, True),
                                                   (False, True)]
        assert got[1].mcs == 4 and got[1].sigb_ok and m0 in got[1].mpdus


def test_mu_decode_capture_and_stats_equal_jax(mixed):
    caps, _ = mixed
    prx = SisoReceiver(mu_pos=0, mu_gid=GID, device="cpu")
    jrx_ = JaxSisoReceiver(mu_pos=0, mu_gid=GID)
    pkts, ndps = prx.decode_capture_full(caps[1])
    jpkts, jndps = jrx_.decode_capture_full(caps[1])
    _same(pkts, jpkts)
    assert ndps == jndps == []
    assert prx.stats.summary() == jrx_.stats.summary()


def test_mu_other_position_equals_jax():
    """User 1's station (identity Q: stream 1 on chain 1) decodes its own
    MPDU and nobody else's."""
    _, m0, m1 = _mpdus()
    mu1 = _mu_wave([m0, m1], [Mod(F.VHT, 4, BW.BW20, 1),
                              Mod(F.VHT, 2, BW.BW20, 1)])
    cap = np.concatenate([np.zeros(700, np.complex64), mu1[1],
                          np.zeros(700, np.complex64)])
    got = SisoReceiver(mu_pos=1, mu_gid=GID, device="cpu").decode_captures(
        [cap])[0]
    _same(got, JaxSisoReceiver(mu_pos=1, mu_gid=GID).decode_captures(
        [cap])[0])
    ok = [r for r in got if r.mu and r.fcs_ok]
    assert len(ok) == 1 and ok[0].mpdus == [m1] and ok[0].mcs == 2


@pytest.mark.parametrize("gid", [GID, 5])
def test_mu_group_membership_equals_jax(gid):
    """A receiver of another group plans no MU decode of the PPDU (and the
    SU lanes do not mis-decode it); with the right group it decodes."""
    m0 = build_udp_mpdu(b"group five user zero payload", CFG)
    m1 = build_udp_mpdu(b"group five user one payload!", CFG)
    mu = _mu_wave([m0, m1], [Mod(F.VHT, 3, BW.BW20, 1),
                             Mod(F.VHT, 3, BW.BW20, 1)], gid=5)
    cap = np.concatenate([np.zeros(700, np.complex64), mu[0],
                          np.zeros(700, np.complex64)])
    got = SisoReceiver(mu_pos=0, mu_gid=gid, device="cpu").decode_captures(
        [cap])[0]
    _same(got, JaxSisoReceiver(mu_pos=0, mu_gid=gid).decode_captures(
        [cap])[0])
    assert [r.mpdus for r in got if r.fcs_ok] == ([[m0]] if gid == 5 else [])


@pytest.mark.parametrize("pos", [0, 3])
def test_mu_four_user_group_equals_jax(pos):
    mpdus = [build_udp_mpdu(bytes([65 + u]) * 40 + b" user payload", CFG)
             for u in range(4)]
    mods = [Mod(F.VHT, m, BW.BW20, 1) for m in (0, 2, 4, 1)]
    mu = _mu_wave(mpdus, mods, n_sts=4)
    cap = np.concatenate([np.zeros(700, np.complex64), mu[pos],
                          np.zeros(700, np.complex64)])
    got = SisoReceiver(mu_pos=pos, mu_gid=GID,
                       device="cpu").decode_captures([cap])[0]
    _same(got, JaxSisoReceiver(mu_pos=pos, mu_gid=GID).decode_captures(
        [cap])[0])
    ok = [r for r in got if r.mu and r.fcs_ok]
    assert len(ok) == 1 and ok[0].mpdus == [mpdus[pos]]
    assert ok[0].mcs == mods[pos].mcs


@pytest.mark.parametrize("bw,fs,nfft", [(BW.BW40, 40e6, 128),
                                        (BW.BW80, 80e6, 256)])
def test_mu_wideband_stream_equals_jax(bw, fs, nfft):
    m0 = build_udp_mpdu(b"wideband mu user zero payload!", CFG)
    m1 = build_udp_mpdu(b"wideband mu user one payload!!", CFG)
    qi = np.tile(np.eye(2, dtype=np.complex64)[None], (nfft, 1, 1))
    tx = gen_ampdu_mu([aggregate_vht([m0]), aggregate_vht([m1])],
                      [Mod(F.VHT, 4, bw, 1), Mod(F.VHT, 2, bw, 1)],
                      bfq=qi, group_id=GID)
    wave = finalize(tx.waveform, multiplier=0.2, cfo_hz=-20000.0, gap=False)
    su = finalize(gen_ampdu(aggregate_vht([m0]), Mod(F.VHT, 7, bw,
                                                     1)).waveform,
                  multiplier=0.2, cfo_hz=30000.0, gap=False)[0]
    cap = add_noise(np.concatenate([
        np.zeros(2000, np.complex64), wave[0], np.zeros(2000, np.complex64),
        su, np.zeros(2000, np.complex64)]), 30.0, seed=int(fs // 1e6))
    got = SisoReceiver(sample_rate_hz=fs, mu_pos=0, mu_gid=GID,
                       device="cpu").decode_captures([cap])[0]
    _same(got, JaxSisoReceiver(sample_rate_hz=fs, mu_pos=0,
                               mu_gid=GID).decode_captures([cap])[0])
    assert [(r.mu, r.fcs_ok, r.mpdus) for r in got] == [(True, True, [m0]),
                                                        (False, True, [m0])]
    assert got[0].mcs == 4 and got[0].sigb_ok


def _dual_chain_capture(bw: BW):
    """test_mu_stream's dual-chain captures: our stream reaches both RX
    antennas (the interferer's nulled); at 20 MHz mixed with a 2x2 SU
    A-MPDU."""
    q = {BW.BW20: 1, BW.BW40: 2}[bw]
    m0 = build_udp_mpdu(b"dual chain mu user0 payload xyz", CFG)
    m1 = build_udp_mpdu(b"dual chain mu user1 payload abc", CFG)
    m_su = build_udp_mpdu(b"dual chain su 2x2 payload qrstu", CFG)
    qi = np.tile(np.eye(2, dtype=np.complex64)[None], (64 * q, 1, 1))
    mcs0 = 4 if q == 1 else 5
    tx = gen_ampdu_mu([aggregate_vht([m0]), aggregate_vht([m1])],
                      [Mod(F.VHT, mcs0, bw, 1), Mod(F.VHT, 2, bw, 1)],
                      bfq=qi, group_id=GID)
    wave = finalize(tx.waveform, multiplier=0.2,
                    cfo_hz=-7000.0 if q == 1 else 15000.0, gap=False)
    g = np.array([0.9 - 0.2j, 0.6 + 0.7j])
    parts = [np.zeros((2, 900 * q), np.complex64), g[:, None] * wave[0],
             np.zeros((2, 900 * q), np.complex64)]
    if q == 1:
        su = finalize(gen_ampdu(aggregate_vht([m_su]),
                                Mod(F.VHT, 3, BW.BW20, 2)).waveform,
                      multiplier=0.2, cfo_hz=9000.0, gap=False)
        h22 = np.array([[1.0 + 0.1j, 0.3 - 0.4j], [-0.2 + 0.5j, 0.8]])
        parts += [h22 @ su, np.zeros((2, 900), np.complex64)]
    cap = add_noise(np.concatenate(parts, axis=1), 30.0, seed=100 + q)
    return cap, m0, m_su


@pytest.mark.parametrize("bw", [BW.BW20, BW.BW40])
@pytest.mark.parametrize("detector", ["auto", "zf"])
def test_mu_dual_chain_equals_jax(bw, detector):
    """MimoReceiver: the station's stream MRC-combined over both chains,
    mixed with 2x2 SU traffic; the auto detector's ML retry leaves the MU
    packet alone."""
    cap, m0, m_su = _dual_chain_capture(bw)
    fs = 20e6 * (2 if bw == BW.BW40 else 1)
    prx = MimoReceiver(sample_rate_hz=fs, mu_pos=0, mu_gid=GID,
                       detector=detector, device="cpu")
    pkts, _ = prx.decode_capture_full(cap)
    jpkts, _ = JaxMimoReceiver(sample_rate_hz=fs, mu_pos=0, mu_gid=GID,
                               detector=detector).decode_capture_full(cap)
    assert_same_packets_all(pkts, jpkts)
    mu = [r for r in pkts if r.mu and r.fcs_ok]
    su = [r for r in pkts if not r.mu and r.fcs_ok]
    assert len(mu) == 1 and mu[0].mpdus == [m0] and mu[0].sigb_ok
    assert [r.mpdus for r in su] == ([[m_su]] if bw == BW.BW20 else [])
    (stream,) = prx.decode_captures([cap])
    assert_same_packets_all(stream, pkts)


def test_cpu_mu_lanes_launch_no_kernel(mixed):
    caps, _ = mixed
    before = (kv.LAUNCHES, kg.LAUNCHES, kg.SHARED_LAUNCHES,
              kg.MULTI_LAUNCHES)
    res = SisoReceiver(mu_pos=0, mu_gid=GID,
                       device="cpu").decode_capture(caps[0])
    assert sum(r.mu and r.fcs_ok for r in res) == 1
    assert (kv.LAUNCHES, kg.LAUNCHES, kg.SHARED_LAUNCHES,
            kg.MULTI_LAUNCHES) == before


# ---------------------------------------------------------------------------
# the numpy MU planner copies, pinned field by field
# ---------------------------------------------------------------------------


def _mu_meta(rng, n: int, bw: BW):
    """Random packed-meta fields that reach every gate of _plan_mu_batch:
    group ids around the configured one, per-user NSTS fields of 0-3
    streams (absent users, multi-stream users, groups above 4 streams),
    bandwidths, SGI, L-SIG MCS and lengths (NDP-sized included), and
    windows near the capture's end."""
    meta = _random_meta(rng, n, bw)
    vht = meta["vht_bits"]
    gid = np.where(rng.random(n) < 0.7, GID, rng.integers(0, 64, n))
    vht[:, 4:10] = (gid[:, None] >> np.arange(6)) & 1
    for u in range(4):
        nsts = np.where(rng.random(n) < 0.6, 1, rng.integers(0, 4, n))
        vht[:, 10 + 3 * u:13 + 3 * u] = (nsts[:, None] >> np.arange(3)) & 1
    meta["vht_bits"] = vht
    meta["vht_ok"] = (rng.random(n) < 0.8).astype(np.int32)
    meta["l_len"] = rng.integers(0, 3000, n).astype(np.int32)
    return meta


@pytest.mark.parametrize("fs", [20e6, 40e6, 80e6],
                         ids=["20MHz", "40MHz", "80MHz"])
@pytest.mark.parametrize("pos", [0, 2])
def test_plan_mu_batch_equals_jax(fs, pos):
    port = rx.SisoReceiver(sample_rate_hz=fs, mu_pos=pos, mu_gid=GID,
                           device="cpu")
    ref = jrx.SisoReceiver(sample_rate_hz=fs, mu_pos=pos, mu_gid=GID)
    rng = np.random.default_rng(int(fs // 1e6) + pos)
    n, cap_len = 2000, 150000
    meta = _mu_meta(rng, n, port.bw)
    got = port._plan_mu_batch(cap_len, meta, n)
    want = ref._plan_mu_batch(cap_len, meta, n)
    assert len(want) > 20
    assert {c.n_sts_tot for _, c in want} >= {3, 4}
    assert len(got) == len(want)
    for (gi, g), (wi, w) in zip(got, want):
        assert int(gi) == int(wi)
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
    assert rx.SisoReceiver(sample_rate_hz=fs, device="cpu")._plan_mu_batch(
        cap_len, meta, n) == []


@pytest.mark.parametrize("fs", [20e6, 80e6], ids=["20MHz", "80MHz"])
def test_plan_mu_data_equals_jax(fs):
    """Random SIG-B words (invalid MCSs, every length) through both
    packages' `_plan_mu_data`: the same MU plans, CRC-8 included."""
    port = rx.SisoReceiver(sample_rate_hz=fs, mu_pos=0, mu_gid=GID,
                           device="cpu")
    ref = jrx.SisoReceiver(sample_rate_hz=fs, mu_pos=0, mu_gid=GID)
    rng = np.random.default_rng(7)
    n, cap_len = 2000, 400000
    meta = _mu_meta(rng, n, port.bw)
    cands = ref._plan_mu_batch(cap_len, meta, n)
    words = rng.integers(0, 1 << 23, len(cands)).astype(np.int32)
    got = port._plan_mu_data([(cands, rx._Fetch(torch.from_numpy(words)))])
    want = ref._plan_mu_data([(cands, words)])
    assert len(want) > 5
    _assert_plans_equal(got, want)
    assert all(p.mu for _, p in got)


def test_su_results_unchanged_without_a_group(mixed):
    """mu_gid=None: the MU PPDU is not planned (its SIG-A group is not SU),
    and the SU packets are those of the receiver with a group."""
    caps, (m_su, _, _) = mixed
    got = SisoReceiver(device="cpu").decode_capture(caps[0])
    with_mu = SisoReceiver(mu_pos=0, mu_gid=GID,
                           device="cpu").decode_capture(caps[0])
    assert [r.mpdus for r in got] == [[m_su], [m_su]]
    _same(got, [r for r in with_mu if not r.mu])
