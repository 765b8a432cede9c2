"""The port's dual-chain DATA decoders (ieee80211_tpu_torch/rx/mimo.py:
`MimoDataDecoder` with the "zf" and "ml" detectors, `MrcDataDecoder`)
against the JAX package's, on the captures of tests/test_loopback_mimo.py
and tests/test_wideband_mimo.py.

Each bandwidth's packets go into one dual-chain capture: at 20 MHz the six
2x2 loopbacks (HT MCS 8 through the identity and a mixing channel, HT MCS15
and VHT MCS 0/7/8 through mixing channels); at 40 MHz HT MCS 8/12/15 and
VHT MCS 0/5/9 2x2, and VHT MCS 4/9 SISO on two chains (MRC); at 80 MHz VHT
MCS 0/7/9 2x2, of which MCS 7 and 9 have two BCC encoders (nES = 2), and
VHT MCS 7/9 SISO. The port decodes each with every detector; JAX's "auto"
decode is the reference. Format, MCS, PSDU, MPDUs, FCS and SIG-B flags must
be equal; CFO, SNR and EVM SNRs within `torch_parity`'s tolerances (the EVM
is taken from the ZF-equalized tones, whatever the detector). The JAX
receiver decodes at radix 3 on the CPU and the port at radix 4; a good
packet's bits are the transmitted ones at either radix.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ieee80211_tpu.mac import aggregate_vht, build_udp_mpdu
from ieee80211_tpu.ops import sync as jsync
from ieee80211_tpu.rx.mimo import MimoDataDecoder as JaxMimoDataDecoder
from ieee80211_tpu.rx.mimo import MimoReceiver as JaxMimoReceiver
from ieee80211_tpu.specs import BW, F, Mod
from ieee80211_tpu.specs.modulation import ppdu_params_nonaggregate
from ieee80211_tpu.tx import finalize, gen_ampdu, gen_mpdu
from ieee80211_tpu_torch.ops import sync
from ieee80211_tpu_torch.rx import MimoDataDecoder, MimoReceiver
from ieee80211_tpu_torch.rx.receiver import SigTables
import test_loopback_mimo as lb
import test_wideband_mimo as wb
from torch_parity import assert_same_packets_all, port_mod

Q = {BW.BW20: 1, BW.BW40: 2, BW.BW80: 4}


def _loopbacks():
    """test_loopback_mimo.py's six captures: [(capture, fmt, mcs, nss,
    mpdu)]."""
    out = []
    for mcs, mix in [(8, False), (8, True), (15, True)]:
        mpdu = build_udp_mpdu(lb.PAYLOAD, lb.MAC_CFG)
        cap = finalize(gen_mpdu(mpdu, Mod(F.HT, mcs, BW.BW20, 2)).waveform,
                       multiplier=0.2, cfo_hz=9000.0, num=1, gap=True,
                       gap_len=1200)
        out.append((lb._mix(cap) if mix else cap, F.HT, mcs, 2, mpdu))
    for mcs in (0, 7, 8):
        mpdu = build_udp_mpdu(lb.PAYLOAD, lb.MAC_CFG_QOS)
        cap = finalize(gen_ampdu(aggregate_vht([mpdu]),
                                 Mod(F.VHT, mcs, BW.BW20, 2)).waveform,
                       multiplier=0.2, cfo_hz=-7000.0, num=1, gap=True,
                       gap_len=1200)
        out.append((lb._mix(cap, seed=mcs), F.VHT, mcs, 2, mpdu))
    return out


def _wideband(bw: BW):
    """test_wideband_mimo.py's captures at one bandwidth."""
    q = Q[bw]
    out = []
    if bw == BW.BW40:
        for mcs in (8, 12, 15):
            mpdu = build_udp_mpdu(wb.PAYLOAD, wb.CFG)
            cap = finalize(gen_mpdu(mpdu, Mod(F.HT, mcs, bw, 2)).waveform,
                           multiplier=0.2, cfo_hz=9000.0 * q, num=1,
                           gap=True, gap_len=400 * q)
            out.append((wb._mix(cap, seed=mcs), F.HT, mcs, 2, mpdu))
    for mcs in ((0, 5, 9) if bw == BW.BW40 else (0, 7, 9)):
        mpdu = build_udp_mpdu(wb.PAYLOAD, wb.CFG_QOS)
        cap = finalize(gen_ampdu(aggregate_vht([mpdu]),
                                 Mod(F.VHT, mcs, bw, 2)).waveform,
                       multiplier=0.2, cfo_hz=-7000.0 * q, num=1, gap=True,
                       gap_len=400 * q)
        out.append((wb._mix(cap, seed=10 * mcs + q), F.VHT, mcs, 2, mpdu))
    for mcs in ((4, 9) if bw == BW.BW40 else (7, 9)):
        mpdu = build_udp_mpdu(wb.PAYLOAD, wb.CFG_QOS)
        wave = finalize(gen_ampdu(aggregate_vht([mpdu]),
                                  Mod(F.VHT, mcs, bw, 1)).waveform,
                        multiplier=0.2, cfo_hz=7000.0 * q, num=1, gap=True,
                        gap_len=400 * q)[0]
        rng = np.random.default_rng(mcs + 3)
        h = rng.standard_normal(2) + 1j * rng.standard_normal(2)
        h /= np.abs(h).max()
        cap = np.stack([h[0] * wave, h[1] * wave])
        cap += (rng.standard_normal(cap.shape)
                + 1j * rng.standard_normal(cap.shape)) * 1e-5
        out.append((cap, F.VHT, mcs, 1, mpdu))
    return out


@pytest.fixture(scope="module", params=[BW.BW20, BW.BW40, BW.BW80],
                ids=["20MHz", "40MHz", "80MHz"])
def capture(request):
    """One capture per bandwidth, its expected packets, and JAX's decode."""
    bw = request.param
    parts = _loopbacks() if bw == BW.BW20 else _wideband(bw)
    cap = np.concatenate([c for c, *_ in parts], axis=1).astype(np.complex64)
    want = [p[1:] for p in parts]
    fs = 20e6 * Q[bw]
    return fs, cap, want, JaxMimoReceiver(sample_rate_hz=fs).decode_capture(
        cap)


@pytest.mark.parametrize("detector", ["zf", "ml", "auto"])
def test_decoders_equal_jax(capture, detector):
    fs, cap, want, ref = capture
    got = MimoReceiver(sample_rate_hz=fs, detector=detector,
                       device="cpu").decode_capture(cap)
    # 2x2 packets report one EVM SNR per stream, SISO packets one
    assert [(r.fmt, r.mcs, len(r.sssnr), r.mpdus[0] if r.mpdus else None)
            for r in got] == want
    assert all(r.fcs_ok for r in got)
    assert all(r.sigb_ok is (True if r.fmt == F.VHT else None) for r in got)
    assert_same_packets_all(got, ref)
    # two BCC encoders (two Viterbi lanes) exactly where the 80 MHz capture
    # has VHT MCS 7 and 9 on two streams
    bw = {20e6: BW.BW20, 40e6: BW.BW40, 80e6: BW.BW80}[fs]
    n_es = [Mod(fmt, mcs, bw, nss).nES for fmt, mcs, nss, _ in want]
    assert n_es.count(2) == (2 if fs == 80e6 else 0)


@pytest.fixture(scope="module")
def hard_channel():
    """test_ml_beats_zf_on_hard_channel's input: HT MCS15 40 MHz through
    seed 15's cond-11 mixing channel at noise 4e-5, as (capture, windows
    [1, 2, W, 2], mod, n_sym, expected bits, mpdu)."""
    q = 2
    mpdu = build_udp_mpdu(wb.PAYLOAD * 4, wb.CFG)
    psdu_bits = np.unpackbits(np.frombuffer(mpdu, np.uint8),
                              bitorder="little")
    exp = np.concatenate([np.zeros(16, np.uint8), psdu_bits])
    mod = Mod(F.HT, 15, BW.BW40, 2)
    pp = ppdu_params_nonaggregate(mod, len(mpdu))
    mrng = np.random.default_rng(15)
    hm = (mrng.standard_normal((2, 2))
          + 1j * mrng.standard_normal((2, 2))) + 2.5 * np.eye(2)
    assert np.linalg.cond(hm) > 10
    cap = finalize(gen_mpdu(mpdu, mod).waveform, multiplier=0.2,
                   cfo_hz=9000.0 * q, num=1, gap=True, gap_len=400 * q)
    nrng = np.random.default_rng(7777)
    cap = hm @ cap
    cap += (nrng.standard_normal(cap.shape)
            + 1j * nrng.standard_normal(cap.shape)) * 4e-5
    cap = cap.astype(np.complex64)
    t = int(jsync.find_triggers_np(cap[0], q=q)[0])
    need = 500 + (448 + 160 + 160 + pp.n_sym * 80) * q + 100
    w = np.zeros((1, 2, need, 2), np.float32)
    seg = cap[:, t:t + need]
    w[0, :, :seg.shape[1], 0] = seg.real
    w[0, :, :seg.shape[1], 1] = seg.imag
    return cap, w, mod, pp.n_sym, exp, mpdu


def test_ml_beats_zf_on_hard_channel_in_both(hard_channel):
    """ML decodes the cond-11 channel bit for bit and ZF does not, in the
    port's decoder as in JAX's."""
    _, w, mod, n_sym, exp, _ = hard_channel
    x = torch.from_numpy(w)
    ls, cfo, _ = sync.sync_front_iq(x[:, 0], torch.zeros(1, dtype=torch.int32),
                                    SigTables(2).band, q=2)
    jls, jcfo, _ = jsync.sync_front_iq(jnp.asarray(w[:, 0]),
                                       jnp.zeros(1, jnp.int32), q=2)
    assert int(ls[0]) == int(jls[0])
    errs = {}
    for det in ("ml", "zf"):
        bits, _ = MimoDataDecoder(port_mod(mod), n_sym, det).decode(x, ls,
                                                                    cfo)
        jbits, _ = JaxMimoDataDecoder(mod, n_sym, det).decode(
            jnp.asarray(w), jls, jcfo)
        errs[det] = (int(np.sum(bits[0, :len(exp)] != exp)),
                     int(np.sum(np.asarray(jbits)[0, :len(exp)] != exp)))
    assert errs["ml"] == (0, 0)
    assert errs["zf"][0] > 0 and errs["zf"][1] > 0


def test_auto_retry_recovers_what_zf_loses(hard_channel):
    """Through the receiver, ZF fails the FCS on the hard channel; "auto"
    re-dispatches that packet through ML and decodes it, equal to JAX's
    "auto" decode."""
    cap, _, mod, _, _, mpdu = hard_channel
    zf = MimoReceiver(sample_rate_hz=40e6, detector="zf",
                      device="cpu").decode_capture(cap)
    assert [(r.mcs, r.fcs_ok) for r in zf] == [(15, False)]
    got = MimoReceiver(sample_rate_hz=40e6, device="cpu").decode_capture(cap)
    assert [(r.mcs, r.fcs_ok) for r in got] == [(15, True)]
    assert got[0].mpdus == [mpdu]
    assert_same_packets_all(got, JaxMimoReceiver(
        sample_rate_hz=40e6).decode_capture(cap))
