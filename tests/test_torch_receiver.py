"""The port's SISO streaming receiver (ieee80211_tpu_torch.rx.SisoReceiver)
end to end on the CPU, against the JAX package's SisoReceiver.

On every packet that JAX decodes with a good FCS the port must give the
same format, MCS, PSDU, MPDUs and SIG-B flag, and it must have no
good-FCS packet that JAX lacks; CFO, SNR and EVM SNR are float32 results
of sums taken in another order: CFO within 1 Hz (1e-6 rad/sample x fs /
2pi at 80 MHz is 13 Hz; the measured differences are under 0.01 Hz), SNR
within 5e-3 dB and EVM SNR within 1e-3 dB. The captures carry white noise
at 30 dB: a noiseless packet's EVM SNR measures float32 rounding (~130 dB)
and would differ by dB. The JAX receiver decodes at radix 3 on the CPU and
the port at radix 4; a good packet's bits are the transmitted ones at
either radix.
"""
import dataclasses

import numpy as np
import pytest

from ieee80211_tpu.mac import MacConfig, aggregate_vht, build_udp_mpdu
from ieee80211_tpu.rx import SisoReceiver as JaxSisoReceiver
from ieee80211_tpu.specs import BW, F, Mod
from ieee80211_tpu.tx import finalize, gen_ampdu, gen_mpdu
from ieee80211_tpu_torch.ops.cuda import gather as kg
from ieee80211_tpu_torch.ops.cuda import viterbi as kv
from ieee80211_tpu_torch.rx import SisoReceiver
from torch_parity import MAC, add_noise, mixed_capture

CFO_HZ_TOL = 1.0
SNR_TOL = 5e-3
EVM_TOL = 1e-3

# the MPDU of the reference's own SISO capture (tests/test_rx_reference_bin.py)
KNOWN_MPDU = (b'\x08\x01n\x00\xf4i\xd5\x80\x0f\xa0\x00\xc0\xca\xb1[\xe1\xf4i'
              b'\xd5\x80\x0f\xa0\x00\xa9\xaa\xaa\x03\x00\x00\x00\x08\x00E\x00'
              b'\x00:\xab\x02@\x00@\x11{\x96\n\n\x00\x06\n\n\x00\x01\x99\xd3"'
              b'\xb9\x00&\x10\xec123456789012345678901234567890\xa3]\xee\xec')
PAYLOAD = b"123456789012345678901234567890"


def assert_same_packets(got, ref, cfo_tol=CFO_HZ_TOL, snr_tol=SNR_TOL,
                        evm_tol=EVM_TOL):
    good = [r for r in ref if r.fcs_ok]
    assert len(good) > 0
    assert [r.psdu for r in got if r.fcs_ok] == [r.psdu for r in good]
    by_psdu = {r.psdu: r for r in got}
    for r in good:
        g = by_psdu[r.psdu]
        assert (g.fmt, g.mcs, g.mpdus, g.fcs_ok, g.sigb_ok, g.mu) == (
            r.fmt, r.mcs, r.mpdus, r.fcs_ok, r.sigb_ok, r.mu)
        assert abs(g.cfo_hz - r.cfo_hz) <= cfo_tol
        assert abs(g.snr_db - r.snr_db) <= snr_tol
        assert abs(g.evm_snr_db - r.evm_snr_db) <= evm_tol
        assert len(g.sssnr) == 1 and g.sssnr[0] == g.evm_snr_db


def test_known_mpdu_decodes():
    """The reference capture's MPDU (L MCS0), made by the golden TX."""
    cap = finalize(gen_mpdu(KNOWN_MPDU, Mod(F.L, 0)).waveform,
                   multiplier=0.2, cfo_hz=-7000.0, gap=True,
                   gap_len=1200)[0]
    cap = add_noise(cap, 30.0, seed=1)
    res = SisoReceiver(device="cpu").decode_capture(cap)
    assert len(res) == 1
    r = res[0]
    assert r.fmt == F.L and r.mcs == 0 and r.fcs_ok and r.sigb_ok is None
    assert r.mpdus == [KNOWN_MPDU]
    assert_same_packets(res, JaxSisoReceiver().decode_capture(cap))


@pytest.mark.parametrize("fmt,mcs,cfo", [(F.L, 7, 232111.0),
                                         (F.HT, 7, 11000.0),
                                         (F.VHT, 8, -21000.0)])
def test_loopback_equals_jax(fmt, mcs, cfo):
    """L and HT MPDUs and a VHT A-MPDU, as tests/test_loopback_siso.py."""
    mpdu = build_udp_mpdu(PAYLOAD, MacConfig(subtype=8 if fmt == F.VHT
                                             else 0, seq=2704, **MAC))
    tx = (gen_ampdu(aggregate_vht([mpdu]), Mod(fmt, mcs)) if fmt == F.VHT
          else gen_mpdu(mpdu, Mod(fmt, mcs)))
    cap = add_noise(finalize(tx.waveform, multiplier=0.2, cfo_hz=cfo,
                             gap=True, gap_len=1200)[0], 30.0, seed=mcs)
    rx = SisoReceiver(device="cpu")
    res = rx.decode_capture(cap)
    assert len(res) == 1 and res[0].fmt == fmt and res[0].mcs == mcs
    assert res[0].fcs_ok and res[0].mpdus[0] == mpdu
    assert res[0].sigb_ok is (True if fmt == F.VHT else None)
    jrx = JaxSisoReceiver()
    assert_same_packets(res, jrx.decode_capture(cap))
    assert rx.stats.summary() == jrx.stats.summary()


@pytest.fixture(scope="module")
def mixed():
    """Two mixed HT/VHT captures and JAX's decode of each, per ingest."""
    caps = [mixed_capture(seed=3, n=6)[0], mixed_capture(seed=4, n=4)[0]]
    ref = {}
    for ingest in ("f32", "int8"):
        jrx = JaxSisoReceiver(ingest=ingest)
        ref[ingest] = ([jrx.decode_capture(c) for c in caps],
                       jrx.stats.summary())
    return caps, ref


@pytest.mark.parametrize("ingest", ["f32", "int8"])
def test_decode_capture_equals_jax(mixed, ingest):
    caps, ref = mixed
    rx = SisoReceiver(ingest=ingest, device="cpu")
    for cap, want in zip(caps, ref[ingest][0]):
        got = rx.decode_capture(cap)
        assert all(r.fcs_ok for r in got) and len(got) == len(want)
        assert_same_packets(got, want)
    assert rx.stats.summary() == ref[ingest][1]


@pytest.mark.parametrize("ingest", ["f32", "int8"])
@pytest.mark.parametrize("trigger", ["host", "device"])
def test_decode_captures_equals_jax(mixed, ingest, trigger):
    """The pipelined stream (three passes over the two captures, so that
    every stage of the pipeline runs) gives decode_capture's packets. The
    device trigger may place a window a sample or two off the host's, so
    CFO and SNR are held to the stated tolerances there too."""
    caps, ref = mixed
    rx = SisoReceiver(ingest=ingest, trigger=trigger, device="cpu")
    stream = rx.decode_captures(caps * 3)
    assert len(stream) == 6
    for k, got in enumerate(stream):
        assert_same_packets(got, ref[ingest][0][k % 2])
    s = rx.stats.summary()
    assert s["fcs_ok"] == 3 * ref[ingest][1]["fcs_ok"] == s["decoded"]
    # one meta fetch per capture, one per decode group, one trigger fetch
    # per capture on the device trigger
    assert rx.n_waits >= 6 * (2 + (trigger == "device"))


def test_wideband_80mhz_equals_jax():
    mods = [Mod(F.VHT, m, BW.BW80, 1) for m in (9, 4)]
    mpdus = [build_udp_mpdu(bytes([k]) * 400, MacConfig(subtype=8, seq=k,
                                                        **MAC))
             for k in range(2)]
    cap = add_noise(np.concatenate([
        finalize(gen_ampdu(aggregate_vht([m]), mod).waveform,
                 multiplier=0.18, cfo_hz=28000.0, gap=True,
                 gap_len=1024)[0] for m, mod in zip(mpdus, mods)]),
        30.0, seed=80)
    res = SisoReceiver(sample_rate_hz=80e6, device="cpu").decode_capture(cap)
    assert [(r.fmt, r.mcs, r.fcs_ok) for r in res] == [(F.VHT, 9, True),
                                                       (F.VHT, 4, True)]
    assert [r.mpdus[0] for r in res] == mpdus
    assert_same_packets(res, JaxSisoReceiver(
        sample_rate_hz=80e6).decode_capture(cap))


def test_ndp_surfaces_as_in_jax():
    ndp = gen_ampdu(b"", Mod(F.VHT, 0, BW.BW20, 2))
    rng = np.random.default_rng(11)
    h = rng.standard_normal(2) + 1j * rng.standard_normal(2)
    cap = (h @ finalize(ndp.waveform, multiplier=0.3, cfo_hz=4000.0,
                        gap=True, gap_len=600)).astype(np.complex64)
    pkts, ndps = SisoReceiver(device="cpu").decode_capture_full(cap)
    jpkts, jndps = JaxSisoReceiver().decode_capture_full(cap)
    assert pkts == [] == jpkts and len(ndps) == 1 == len(jndps)
    assert set(dataclasses.asdict(ndps[0])) == set(dataclasses.asdict(
        jndps[0]))
    np.testing.assert_allclose(ndps[0].ltf_iq, jndps[0].ltf_iq, atol=1e-5)
    assert abs(ndps[0].cfo_rad - jndps[0].cfo_rad) <= 1e-6
    (stream,), (sndps,) = SisoReceiver(
        device="cpu").decode_captures_full([cap])
    assert stream == [] and len(sndps) == 1
    np.testing.assert_array_equal(sndps[0].ltf_iq, ndps[0].ltf_iq)


def test_cpu_receiver_launches_no_kernel():
    before = (kv.LAUNCHES, kg.LAUNCHES, kg.SHARED_LAUNCHES)
    cap, mpdus = mixed_capture(seed=5, n=2)
    res = SisoReceiver(device="cpu").decode_capture(cap)
    assert [r.mpdus[0] for r in res] == mpdus
    assert (kv.LAUNCHES, kg.LAUNCHES, kg.SHARED_LAUNCHES) == before


def test_options_are_checked():
    rx = SisoReceiver(mu_pos=1, mu_gid=7, device="cpu")
    assert (rx.mu_pos, rx.mu_gid) == (1, 7)
    assert SisoReceiver(device="cpu").mu_gid is None
    with pytest.raises(ValueError):
        SisoReceiver(sample_rate_hz=60e6, device="cpu")
    with pytest.raises(ValueError):
        SisoReceiver(ingest="int4", device="cpu")
    with pytest.raises(ValueError):
        SisoReceiver(trigger="radio", device="cpu")
