"""The port's PDR harness (ieee80211_tpu_torch/perf/pdr.py) against the JAX
package's (ieee80211_tpu/perf/pdr.py) on the CPU.

The packet builders are numpy in both packages and must match exactly:
waveforms, MPDUs, PPDU parameters. `MimoRxPipeline`'s window length equals
JAX's for every 2-stream configuration the acceptance sweep runs. Its
packed-byte step decodes one numpy noise batch to the same bytes as JAX's
at 30 dB, and to ok-counts within 1 of 20 at a waterfall SNR (the port's
Viterbi takes radix-3 tables there, as the JAX CPU decoder runs). The
sweeps run on device="cpu" at the sizes of tests/test_pdr.py and
tests/test_pdr_acceptance.py.
"""
import numpy as np
import pytest
import torch

from ieee80211_tpu.perf import pdr as jpdr
from ieee80211_tpu.specs import BW, F
from ieee80211_tpu_torch.perf import mimo_pdr_sweep, pdr, pdr_sweep
from torch_parity import assert_packed_parity, packed_both, port_mod, radix3

PAYLOAD = 100


def _same_packet(got, ref):
    (mod, pp, mpdu, wave), (jmod, jpp, jmpdu, jwave) = got, ref
    assert mod == port_mod(jmod)
    assert (pp.n_sym, pp.psdu_len) == (jpp.n_sym, jpp.psdu_len)
    assert mpdu == jmpdu
    assert wave.dtype == jwave.dtype and wave.shape == jwave.shape
    np.testing.assert_array_equal(wave, jwave)


@pytest.mark.parametrize("fmt,mcs", [(F.L, 0), (F.L, 7), (F.HT, 3),
                                     (F.VHT, 8)])
def test_build_packet_equal_jax(fmt, mcs):
    _same_packet(pdr._build_packet(fmt, mcs, 500, 0),
                 jpdr._build_packet(fmt, mcs, 500, 0))


@pytest.mark.parametrize("fmt,mcs", [(F.HT, 8), (F.HT, 15), (F.VHT, 4)])
def test_build_mimo_packet_equal_jax(fmt, mcs):
    _same_packet(pdr._build_mimo_packet(fmt, mcs, 500, 3),
                 jpdr._build_mimo_packet(fmt, mcs, 500, 3))


@pytest.mark.parametrize("bw,mcs", [(BW.BW40, 0), (BW.BW80, 9)])
def test_build_packet_bw_equal_jax(bw, mcs):
    _same_packet(pdr._build_packet_bw(bw)(F.VHT, mcs, 500, 1),
                 jpdr._build_packet_bw(bw)(F.VHT, mcs, 500, 1))


@pytest.mark.parametrize("bw,fmt,mcs", [(BW.BW40, F.HT, 12),
                                        (BW.BW40, F.VHT, 9),
                                        (BW.BW80, F.VHT, 7)])
def test_build_mimo_packet_bw_equal_jax(bw, fmt, mcs):
    _same_packet(pdr._build_mimo_packet_bw(bw)(fmt, mcs, 500, 2),
                 jpdr._build_mimo_packet_bw(bw)(fmt, mcs, 500, 2))


# every 2-stream row of the acceptance sweep: (bandwidth, format, MCSs)
MIMO_ROWS = [(BW.BW20, F.HT, range(8, 16)), (BW.BW20, F.VHT, range(9)),
             (BW.BW40, F.HT, range(8, 16)), (BW.BW40, F.VHT, range(10)),
             (BW.BW80, F.VHT, range(10))]


@pytest.mark.parametrize("bw,fmt,mcss", MIMO_ROWS,
                         ids=[f"{f.name}{b.name}" for b, f, _ in MIMO_ROWS])
def test_mimo_window_len_equal_jax(bw, fmt, mcss):
    """At the sweep's 500 B payload, from the sweep's own builders."""
    for mcs in mcss:
        mod, pp, _, _ = pdr._build_mimo_packet_bw(bw)(fmt, mcs, 500, 0)
        jmod = jpdr._build_mimo_packet_bw(bw)(fmt, mcs, 500, 0)[0]
        pipe = pdr.MimoRxPipeline(mod, pp.n_sym, pp.psdu_len, device="cpu")
        assert pipe.window_len() == jpdr.MimoRxPipeline(
            jmod, pp.n_sym, pp.psdu_len).window_len()


@pytest.mark.parametrize("snr_db,waterfall", [(30.0, False), (5.0, True)],
                         ids=["30dB", "waterfall"])
def test_mimo_packed_step_matches_jax(snr_db, waterfall):
    """HT MCS9 2x2, 100 B, 20 packets of one numpy noise batch."""
    mod, pp, mpdu, wave = pdr._build_mimo_packet(F.HT, 9, PAYLOAD, 0)
    jmod = jpdr._build_mimo_packet(F.HT, 9, PAYLOAD, 0)[0]
    pipe = radix3(pdr.MimoRxPipeline(mod, pp.n_sym, pp.psdu_len,
                                     device="cpu"))
    jpipe = jpdr.MimoRxPipeline(jmod, pp.n_sym, pp.psdu_len)
    x2 = pdr.noisy_batch(pdr.rx_window(wave, pipe.window_len()), 20,
                         snr_db, seed=7)
    ref, got = packed_both(jpipe._step, pipe, x2)
    assert_packed_parity(ref, got,
                         lambda b: pdr._count_ok(b, pp.psdu_len, mpdu, False),
                         waterfall, f"MimoRxPipeline HT9 {snr_db} dB")


def test_mimo_step_keys_and_device():
    mod, pp, _, wave = pdr._build_mimo_packet(F.VHT, 2, PAYLOAD, 0)
    pipe = pdr.MimoRxPipeline(mod, pp.n_sym, pp.psdu_len, device="cpu")
    assert {b.device.type for b in pipe.buffers()} == {"cpu"}
    assert pipe._dec.detector == "ml"
    x2 = torch.from_numpy(pdr.rx_window(wave, pipe.window_len())[None])
    with torch.inference_mode():
        out = pipe.step(x2, torch.zeros(1, dtype=torch.int32))
    assert set(out) == {"bits", "ltf_start", "cfo", "snr"}
    assert out["bits"].shape == (1, pp.n_sym * mod.nDBPS)


def test_pdr_curve_shape():
    """tests/test_pdr.py's sweep and assertions, on device="cpu"."""
    curves = pdr_sweep(F.L, mcs_list=[0, 7], snr_db=[-2.0, 12.0, 30.0],
                       n_pkt=20, payload_len=100, device="cpu")
    assert curves[0][1] > 0.9 and curves[0][2] > 0.9
    assert curves[7][0] < 0.2
    assert curves[7][2] > 0.9
    assert curves[7][2] >= curves[7][0]


def test_mimo_pdr_sweep_shape():
    curves = mimo_pdr_sweep(F.HT, mcs_list=[8], snr_db=[-5.0, 30.0],
                            n_pkt=4, payload_len=100, device="cpu")
    assert curves == {8: [0.0, 1.0]}


def test_awgn_draws_on_the_generator():
    """The same seed gives the same noise; noise_amp 0 leaves x2 as is."""
    x2 = torch.zeros(3, 50, 2)
    g = pdr.noise_generator(4, torch.device("cpu"))
    a = pdr.awgn(x2, 0.5, g)
    b = pdr.awgn(x2, 0.5, pdr.noise_generator(4, torch.device("cpu")))
    assert torch.equal(a, b) and not torch.equal(a, pdr.awgn(x2, 0.5, g))
    np.testing.assert_allclose(float(a.std()), 0.5 / np.sqrt(2), rtol=0.15)
    assert torch.equal(pdr.awgn(x2 + 1.0, 0.0, g), x2 + 1.0)
