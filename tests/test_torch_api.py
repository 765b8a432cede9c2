"""The port's MAC<->PHY API (ieee80211_tpu_torch/api/) against the JAX
package's: the copy of the wire format (descriptors.py) gives the same
bytes, and `PhyService` over the port's receivers (on the CPU) gives the
JAX service's records for the same requests and captures.

Waveforms come from the golden TX in both services and are equal bit for
bit. Data records are byte-identical. A channel report carries the NDP's
CFO-corrected LTF samples as float32, rotated by a CFO that each package
sums in its own order: its header is identical and its samples agree within
1e-5 (tests/test_torch_receiver.py holds the NDP capture to the same
bound).
"""
import socket
import threading

import numpy as np
import pytest

from ieee80211_tpu.api import PhyService as JaxPhyService
from ieee80211_tpu.api import descriptors as jd
from ieee80211_tpu.mac import MacConfig, aggregate_vht, build_udp_mpdu
from ieee80211_tpu.mu import (map_q_to_grid, ndp_ltf_channel,
                              vht_channel_feedback, zf_q)
from ieee80211_tpu.specs import BW, F, GRF, Mod
from ieee80211_tpu_torch.api import PhyService
from ieee80211_tpu_torch.api import descriptors as d
from torch_parity import MAC, port_mod

CFG = MacConfig(subtype=8, seq=2704, **MAC)
LTF_TOL = 1e-5


def _service(**kw):
    return PhyService(device="cpu", **kw), JaxPhyService(**kw)


def _assert_same_records(got, want):
    """Data records byte for byte; channel reports' headers byte for byte
    and their samples within LTF_TOL."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:3] == w[:3]
        if w[0] == GRF.NDP.value:
            np.testing.assert_allclose(
                d.unpack_rx_record(g).ltf_iq, jd.unpack_rx_record(w).ltf_iq,
                rtol=0, atol=LTF_TOL)
        else:
            assert g == w


# ---------------------------------------------------------------------------
# the wire format copy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt,mcs,nsts", [(F.L, 3, 1), (F.HT, 5, 1),
                                          (F.VHT, 4, 1), (F.VHT, 7, 2)])
def test_data_descriptors_equal_jax(fmt, mcs, nsts):
    mpdu = b"\x01\x02payload bytes\x03" * 7
    mod = Mod(fmt, mcs, BW.BW20, nsts)
    msg = d.pack_data(mpdu, port_mod(mod))
    assert msg == jd.pack_data(mpdu, mod)
    got, want = d.unpack_request(msg), jd.unpack_request(msg)
    assert type(got).__name__ == type(want).__name__ == "DataRequest"
    assert vars(got) == vars(want)
    rec = d.pack_rx_record(fmt.value, mpdu, mcs)
    assert rec == jd.pack_rx_record(fmt.value, mpdu, mcs)
    assert vars(d.unpack_rx_record(rec)) == vars(jd.unpack_rx_record(rec))
    assert d.unpack_request(b"") is None and d.unpack_rx_record(b"\x01") \
        is None


@pytest.mark.parametrize("n", [2, 3, 4])
def test_mu_bfq_ndp_descriptors_equal_jax(n):
    rng = np.random.default_rng(n)
    q = (rng.standard_normal((64, n, n))
         + 1j * rng.standard_normal((64, n, n))).astype(np.complex64)
    msg = d.pack_bfq(q)
    assert msg == jd.pack_bfq(q)
    np.testing.assert_array_equal(d.unpack_request(msg).q,
                                  jd.unpack_request(msg).q)
    m0, m1 = b"user zero" * 5, b"user one!" * 9
    mods = (Mod(F.VHT, 2, BW.BW20, n - 1), Mod(F.VHT, 0, BW.BW20, 1))
    mu = d.pack_mu_data(m0, port_mod(mods[0]), m1, port_mod(mods[1]), 5)
    assert mu == jd.pack_mu_data(m0, mods[0], m1, mods[1], 5)
    assert vars(d.unpack_request(mu)) == vars(jd.unpack_request(mu))
    assert d.pack_ndp() == jd.pack_ndp()
    assert vars(d.unpack_request(d.pack_ndp())) == vars(
        jd.unpack_request(jd.pack_ndp()))
    ltf = (rng.standard_normal(128)
           + 1j * rng.standard_normal(128)).astype(np.complex64)
    rep = d.pack_channel_report(ltf)
    assert rep == jd.pack_channel_report(ltf)
    np.testing.assert_array_equal(d.unpack_rx_record(rep).ltf_iq,
                                  jd.unpack_rx_record(rep).ltf_iq)


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------


def test_handle_request_equals_jax():
    """Every request kind gives the JAX service's waveform bit for bit."""
    svc, jsvc = _service(mugid=0)
    mpdu = build_udp_mpdu(b"service request payload", CFG)
    qi = np.tile(np.eye(3, dtype=np.complex64)[None], (64, 1, 1))
    msgs = [jd.pack_data(aggregate_vht([mpdu]), Mod(F.VHT, 5)),
            jd.pack_data(mpdu, Mod(F.HT, 12, BW.BW20, 2)),
            jd.pack_data(mpdu, Mod(F.L, 6)), jd.pack_ndp(),
            jd.pack_bfq(qi),
            jd.pack_mu_data(aggregate_vht([mpdu]), Mod(F.VHT, 2, BW.BW20, 2),
                            aggregate_vht([mpdu[:40]]), Mod(F.VHT, 0), 5)]
    for msg in msgs:
        got, want = svc.handle_request(msg), jsvc.handle_request(msg)
        if want is None:
            assert got is None
            continue
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(svc.bfq, jsvc.bfq)
    with pytest.raises(ValueError, match="totals 2 streams"):
        svc.handle_request(jd.pack_mu_data(b"a" * 30, Mod(F.VHT, 0), b"b" * 30,
                                           Mod(F.VHT, 0), 2))
    with pytest.raises(ValueError, match="BFQ"):
        PhyService(mugid=0, device="cpu").handle_request(
            jd.pack_mu_data(b"a" * 30, Mod(F.VHT, 0), b"b" * 30,
                            Mod(F.VHT, 0), 2))


def test_su_loopback_equals_jax():
    svc, jsvc = _service(mugid=0)
    mpdu = build_udp_mpdu(b"service loopback payload", CFG)
    wave = svc.handle_request(d.pack_data(aggregate_vht([mpdu]),
                                          port_mod(Mod(F.VHT, 5))))
    recs = svc.rx_capture(wave[0])
    assert recs == jsvc.rx_capture(wave[0])
    rec = d.unpack_rx_record(recs[0])
    assert (rec.fmt, rec.mcs, rec.payload) == (F.VHT.value, 5, mpdu)


def test_sounding_loop_equals_jax():
    """tests/test_api.py's AP/STA closed loop over the wire API: an NDP,
    the stations' channel reports, the AP's feedback, ZF Q and BFQ, an MU
    data request; each station's records equal the JAX station's."""
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
    h += 2.0 * np.eye(2)
    ap, jap = _service(mugid=0)
    stas = [_service(mupos=u, mugid=2) for u in range(2)]
    ndp_wave = ap.handle_request(d.pack_ndp())
    ltfs = []
    for u, (sta, jsta) in enumerate(stas):
        rx = (h[u] @ ndp_wave).astype(np.complex64)
        recs = sta.rx_capture(rx)
        _assert_same_records(recs, jsta.rx_capture(rx))
        (rep,) = [r for r in map(d.unpack_rx_record, recs)
                  if isinstance(r, d.ChannelReport)]
        ltfs.append(rep.ltf_iq)
    q = map_q_to_grid(zf_q([vht_channel_feedback(ndp_ltf_channel(x),
                                                 BW.BW20, 2, 1)
                            for x in ltfs])).astype(np.complex64)
    for svc in (ap, jap):
        assert svc.handle_request(d.pack_bfq(q)) is None
    m = [build_udp_mpdu(b"1234567 packet for station 000", CFG),
         build_udp_mpdu(b"7654321 packet for station 111", CFG)]
    msg = d.pack_mu_data(aggregate_vht([m[0]]), port_mod(Mod(F.VHT, 0)),
                         aggregate_vht([m[1]]), port_mod(Mod(F.VHT, 0)), 2)
    mu_wave = ap.handle_request(msg)
    np.testing.assert_array_equal(mu_wave, jap.handle_request(msg))
    for u, (sta, jsta) in enumerate(stas):
        rx = (h[u] @ mu_wave).astype(np.complex64)
        recs = sta.rx_capture(rx)
        assert recs == jsta.rx_capture(rx)
        assert [r.payload for r in map(d.unpack_rx_record, recs)] == [m[u]]


def _stream_capture(ap):
    m_su = build_udp_mpdu(b"streaming service su payload", CFG)
    m_mu = build_udp_mpdu(b"streaming service mu payload", CFG)
    wave_su = ap.handle_request(d.pack_data(aggregate_vht([m_su]),
                                            port_mod(Mod(F.VHT, 4))))[0]
    ndp_wave = ap.handle_request(d.pack_ndp())[0]
    qi = np.tile(np.eye(2, dtype=np.complex64)[None], (64, 1, 1))
    assert ap.handle_request(d.pack_bfq(qi)) is None
    wave_mu = ap.handle_request(d.pack_mu_data(
        aggregate_vht([m_mu]), port_mod(Mod(F.VHT, 2)),
        aggregate_vht([m_su]), port_mod(Mod(F.VHT, 0)), 2))[0]
    z = np.zeros(700, np.complex64)
    return (np.concatenate([z, wave_su, z, ndp_wave, z, wave_mu, z]),
            m_su, m_mu)


def test_streaming_rx_equals_jax():
    """rx_captures: SU, MU and the NDP's channel report inline, per
    capture, as the JAX service gives them."""
    svc, jsvc = _service(mupos=0, mugid=2)
    cap, m_su, m_mu = _stream_capture(PhyService(mugid=0, device="cpu"))
    got = svc.rx_captures([cap, cap])
    want = jsvc.rx_captures([cap, cap])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_same_records(g, w)
        parsed = [d.unpack_rx_record(r) for r in g]
        assert [r.payload for r in parsed
                if isinstance(r, d.RxRecord)] == [m_su, m_mu]
        assert sum(isinstance(r, d.ChannelReport) for r in parsed) == 1
    _assert_same_records(svc.rx_capture(cap), jsvc.rx_capture(cap))
    assert svc.rx_captures([]) == []


def test_dual_chain_rx_equals_jax():
    """A [2, N] capture takes the dual-chain receiver: the SU packet by
    MRC, the MU packet's own stream, and one channel report per chain."""
    svc, jsvc = _service(mupos=0, mugid=2)
    cap, m_su, m_mu = _stream_capture(PhyService(mugid=0, device="cpu"))
    cap2 = np.stack([(0.9 - 0.2j) * cap, (0.6 + 0.7j) * cap]).astype(
        np.complex64)
    got, want = svc.rx_capture(cap2), jsvc.rx_capture(cap2)
    _assert_same_records(got, want)
    parsed = [d.unpack_rx_record(r) for r in got]
    assert [r.payload for r in parsed if isinstance(r, d.RxRecord)] == [
        m_su, m_mu]
    assert sum(isinstance(r, d.ChannelReport) for r in parsed) == 2
    (g,), (w,) = svc.rx_captures([cap2]), jsvc.rx_captures([cap2])
    _assert_same_records(g, w)


def _free_udp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_udp_endpoints_on_localhost():
    """serve_udp turns a request datagram into the waveform the in-process
    call gives; send_records sends each record as one datagram."""
    svc = PhyService(mugid=0, device="cpu")
    port = _free_udp_port()
    waves, stop = [], threading.Event()
    th = threading.Thread(target=svc.serve_udp, args=(waves.append,),
                          kwargs=dict(tx_addr=("127.0.0.1", port),
                                      stop_event=stop))
    th.start()
    try:
        msg = d.pack_data(build_udp_mpdu(b"udp request", CFG),
                          port_mod(Mod(F.L, 2)))
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            for _ in range(200):
                s.sendto(msg, ("127.0.0.1", port))
                th.join(0.05)
                if waves:
                    break
    finally:
        stop.set()
        th.join(5)
    assert not th.is_alive() and waves
    np.testing.assert_array_equal(waves[0], svc.handle_request(msg))
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as rx:
        rx.bind(("127.0.0.1", 0))
        rx.settimeout(5)
        recs = [d.pack_rx_record(0, b"abc", 3), d.pack_rx_record(2, b"de", 7)]
        svc.send_records(recs, rx.getsockname())
        assert [rx.recvfrom(65535)[0] for _ in recs] == recs
