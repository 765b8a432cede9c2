"""The port's whole receive slice (ieee80211_tpu_torch RxPipeline.step)
against the JAX RxPipeline.step on the CPU: `bits`, `ltf_start` and
`lsig_ok` identical, the same keys and dtypes, CFO within 1e-6 rad/sample
and SNR within 1e-3 dB, and every packet decoding to the exact MPDU with a
good FCS.

Configs: bench.py's headline input (VHT MCS7 20 MHz), the driver entry's
example batch (L MCS7), and VHT MCS7 at 40 and 80 MHz as in
tests/test_wideband_rx.py. The JAX CPU step decodes at radix 3 and the
port at radix 4: on these noiseless packets both give the true bits. The
unweighted demap (csi_weight=False) is held to JAX's on the same packets
through a two-path channel at 30 dB SNR, the port at radix 3 there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import bench
import chip_smoke
from ieee80211_tpu.mac import MacConfig, aggregate_vht, build_udp_mpdu
from ieee80211_tpu.models import RxPipeline as JaxRxPipeline
from ieee80211_tpu.specs import BW, F, Mod
from ieee80211_tpu.specs.modulation import ppdu_params_aggregate
from ieee80211_tpu.tx import finalize, gen_ampdu
from ieee80211_tpu_torch.models import RxPipeline
from ieee80211_tpu_torch.utils import c2r
from torch_parity import add_noise, mpdu_decoded, port_mod, radix_tensors

CFO_TOL = 1e-6   # rad/sample: float32 rounding of the angle sums
SNR_TOL = 1e-3   # dB (noiseless packets sit at the 60 dB clamp)


def _bench():
    return bench.build_batch(4)


def _entry():
    """__graft_entry__._example_batch's packets and the MPDU they carry."""
    pipe, _, _, x, t0 = __graft_entry__._example_batch()
    mpdu = build_udp_mpdu(b"123456789012345678901234567890",
                          MacConfig(addr1="f4:69:d5:80:0f:a0",
                                    addr2="00:c0:ca:b1:5b:e1",
                                    addr3="f4:69:d5:80:0f:a0", seq=2704))
    return pipe, x, t0, mpdu


def _wideband(bw):
    """tests/test_wideband_rx.py::test_wideband_rx_pipeline_jit's input."""
    q = {BW.BW40: 2, BW.BW80: 4}[bw]
    cfg = MacConfig(addr1="f4:69:d5:80:0f:a0", addr2="00:c0:ca:b1:5b:e1",
                    addr3="f4:69:d5:80:0f:a0", seq=7)
    mpdu = build_udp_mpdu(b"wideband RX beyond the reference envelope " * 2,
                          cfg)
    mod = Mod(F.VHT, 7, bw, 1)
    ampdu = aggregate_vht([mpdu])
    pp = ppdu_params_aggregate(mod, len(ampdu))
    wave = finalize(gen_ampdu(ampdu, mod).waveform, multiplier=0.2,
                    cfo_hz=15000.0 * q, gap=True, gap_len=64 * q)[0]
    pipe = JaxRxPipeline(mod, pp.n_sym, pp.psdu_len)
    w = pipe.window_len()
    seg = wave[(64 - 8) * q:]
    x = np.zeros((2, w), np.complex64)
    x[:, :min(w, len(seg))] = seg[:min(w, len(seg))]
    return pipe, c2r(x), np.zeros(2, np.int32), mpdu


@pytest.mark.parametrize("make", [
    _bench, _entry, lambda: _wideband(BW.BW40), lambda: _wideband(BW.BW80)],
    ids=["bench_vht7_20", "entry_l7_20", "vht7_40", "vht7_80"])
def test_rx_step_matches_jax(make):
    jpipe, x, t0, mpdu = make()
    ref = {k: np.asarray(v) for k, v in
           jpipe.step(jnp.asarray(x), jnp.asarray(t0)).items()}
    pipe = RxPipeline(port_mod(jpipe.mod), jpipe.n_sym, jpipe.psdu_len,
                      device="cpu")
    assert pipe.window_len() == jpipe.window_len() == x.shape[1]
    with torch.inference_mode():
        out = pipe.step(torch.from_numpy(x), torch.from_numpy(t0))
    out = {k: v.numpy() for k, v in out.items()}
    assert set(out) == set(ref)
    for k in out:
        assert out[k].dtype == ref[k].dtype and out[k].shape == ref[k].shape
    for k in ("bits", "ltf_start", "lsig_ok"):
        np.testing.assert_array_equal(out[k], ref[k])
    np.testing.assert_allclose(out["cfo"], ref["cfo"], rtol=0, atol=CFO_TOL)
    np.testing.assert_allclose(out["snr"], ref["snr"], rtol=0, atol=SNR_TOL)
    assert out["lsig_ok"].all()
    for row in out["bits"]:
        assert mpdu_decoded(row, pipe.psdu_len, mpdu, pipe.mod.fmt)


def test_chip_smoke_input_is_bench_input():
    """chip_smoke.py builds bench.py's headline input without JAX."""
    jpipe, x, t0, mpdu = bench.build_batch(3)
    cell = dict(chip_smoke.HEADLINE, batch=3)
    pipe, x_s, t0_s, mpdu_s = chip_smoke.make_batch(**cell, device="cpu")
    assert pipe.mod == port_mod(jpipe.mod)
    assert (pipe.n_sym, pipe.psdu_len) == (jpipe.n_sym, jpipe.psdu_len)
    np.testing.assert_array_equal(x_s, x)
    np.testing.assert_array_equal(t0_s, t0)
    assert mpdu_s == mpdu


@pytest.mark.parametrize("make", [_bench, lambda: _wideband(BW.BW80)],
                         ids=["bench_vht7_20", "vht7_80"])
def test_unweighted_rx_step_matches_jax(make):
    """RxPipeline(csi_weight=False) against JAX's on packets through a
    two-path channel (a 0.4 echo 4q samples late) with white noise at
    30 dB: bits, ltf_start and lsig_ok identical, every packet decodes."""
    jpipe, x, t0, mpdu = make()
    q = {BW.BW20: 1, BW.BW40: 2, BW.BW80: 4}[jpipe.mod.bw]
    xc = x[..., 0] + 1j * x[..., 1]
    echo = np.zeros_like(xc)
    echo[:, 4 * q:] = 0.4j * xc[:, :-4 * q]
    xc = add_noise(xc + echo, 30.0, seed=q)
    x = np.stack([xc.real, xc.imag], -1).astype(np.float32)
    jref = JaxRxPipeline(jpipe.mod, jpipe.n_sym, jpipe.psdu_len,
                         csi_weight=False)
    ref = {k: np.asarray(v) for k, v in
           jref.step(jnp.asarray(x), jnp.asarray(t0)).items()}
    pipe = RxPipeline(port_mod(jpipe.mod), jpipe.n_sym, jpipe.psdu_len,
                      csi_weight=False, device="cpu")
    assert pipe.step.csi_weight is False
    pipe.step.vit_w0, pipe.step.vit_w1 = radix_tensors(3)
    with torch.inference_mode():
        out = {k: v.numpy() for k, v in pipe.step(
            torch.from_numpy(x), torch.from_numpy(t0)).items()}
    for k in ("bits", "ltf_start", "lsig_ok"):
        np.testing.assert_array_equal(out[k], ref[k])
    for row in out["bits"]:
        assert mpdu_decoded(row, pipe.psdu_len, mpdu, pipe.mod.fmt)
