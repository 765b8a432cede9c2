"""The port's batched transmitters (ieee80211_tpu_torch/tx/torch_tx.py)
against the JAX package's (ieee80211_tpu/tx/jax_tx.py) and the golden TX.

The same PSDUs (and the same Q for the MU transmitter) go through both
packages on the CPU; every waveform must lie within 2e-6 of JAX's and of
the golden complex128 waveform, the bound the JAX package holds its own TX
to (tests/test_jax_tx.py). The JAX `TxPipeline` raises at 40 and 80 MHz
(its DATA window is 80 samples at every bandwidth) and no 20 MHz config
has two BCC encoders, so the wideband and nES = 2 cases are held to the
golden TX alone. The constants the port carries as buffers equal the JAX
transmitter's, element for element.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ieee80211_tpu.mac import MacConfig, aggregate_vht, build_udp_mpdu
from ieee80211_tpu.specs import BW, F, Mod
from ieee80211_tpu.specs.modulation import (ppdu_params_aggregate,
                                            ppdu_params_nonaggregate)
from ieee80211_tpu.tx import gen_ampdu, gen_ampdu_mu, gen_mpdu
from ieee80211_tpu.tx import jax_tx
from ieee80211_tpu.utils import c2r
from ieee80211_tpu_torch.ops.cuda import gather as kg
from ieee80211_tpu_torch.ops.cuda import viterbi as kv
from ieee80211_tpu_torch.specs import modulation as pmodulation
from ieee80211_tpu_torch.tx import (MuTxPipeline, TxPipeline,
                                    get_tx_pipeline)
from torch_parity import MAC, port_mod

TOL = 2e-6
PAYLOAD = b"123456789012345678901234567890"
CFG = MacConfig(seq=2704, **MAC)
CFG_QOS = MacConfig(subtype=8, seq=2704, **MAC)


def _as_c(w2):
    return w2[..., 0] + 1j * w2[..., 1]


def _port_pp(pp):
    return pmodulation.PpduParams(**{k: (port_mod(v) if k == "mod" else v)
                                     for k, v in vars(pp).items()})


def _port_tx(mod, pp):
    return TxPipeline(port_mod(mod), _port_pp(pp), device="cpu")


def _rows(data: bytes, b: int) -> np.ndarray:
    return np.tile(np.frombuffer(data, np.uint8), (b, 1))


@pytest.mark.parametrize("fmt,mcs,nsts", [
    (F.L, 0, 1), (F.L, 7, 1), (F.HT, 7, 1), (F.HT, 12, 2), (F.HT, 3, 1)])
def test_tx_mpdu_equals_jax_and_golden(fmt, mcs, nsts):
    mpdu = build_udp_mpdu(PAYLOAD, CFG)
    mod = Mod(fmt, mcs, BW.BW20, nsts)
    want = gen_mpdu(mpdu, mod).waveform
    pp = ppdu_params_nonaggregate(mod, len(mpdu))
    psdu = _rows(mpdu, 3)
    ref = np.asarray(jax_tx.TxPipeline(mod, pp).step(jnp.asarray(psdu)))
    got = _port_tx(mod, pp).step(torch.from_numpy(psdu)).numpy()
    assert got.shape == ref.shape == (3, mod.nSS, want.shape[-1], 2)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    for row in got:
        np.testing.assert_allclose(_as_c(row), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("mcs,nsts", [(0, 1), (8, 1), (7, 2), (4, 2)])
def test_tx_vht_equals_jax_and_golden(mcs, nsts):
    ampdu = aggregate_vht([build_udp_mpdu(PAYLOAD, CFG_QOS)])
    mod = Mod(F.VHT, mcs, BW.BW20, nsts)
    want = gen_ampdu(ampdu, mod).waveform
    pp = ppdu_params_aggregate(mod, len(ampdu))
    psdu = _rows(ampdu, 2)
    ref = np.asarray(jax_tx.TxPipeline(mod, pp).step(jnp.asarray(psdu)))
    got = _port_tx(mod, pp).step(torch.from_numpy(psdu)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(_as_c(got[1]), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("fmt,mcs,bw,nsts", [
    (F.VHT, 9, BW.BW40, 1), (F.VHT, 9, BW.BW80, 2), (F.VHT, 7, BW.BW80, 2),
    (F.HT, 15, BW.BW40, 2), (F.VHT, 4, BW.BW40, 2)])
def test_wideband_and_two_encoders_equal_golden(fmt, mcs, bw, nsts):
    """40/80 MHz, and VHT MCS 7/9 at 80 MHz with 2 streams: two BCC
    encoders whose outputs the stream parser interleaves (nES = 2)."""
    mod = Mod(fmt, mcs, bw, nsts)
    mpdu = build_udp_mpdu(PAYLOAD * 3, CFG_QOS if fmt == F.VHT else CFG)
    if fmt == F.VHT:
        data = aggregate_vht([mpdu])
        want = gen_ampdu(data, mod).waveform
        pp = ppdu_params_aggregate(mod, len(data))
    else:
        data = mpdu
        want = gen_mpdu(data, mod).waveform
        pp = ppdu_params_nonaggregate(mod, len(data))
    assert mod.nES == (2 if bw == BW.BW80 else 1)
    got = _port_tx(mod, pp).step(torch.from_numpy(_rows(data, 2))).numpy()
    assert got.shape == (2, mod.nSS, want.shape[-1], 2)
    for row in got:
        np.testing.assert_allclose(_as_c(row), want, rtol=0, atol=TOL)


def _mu_case(n_user: int, bw: BW, seed: int):
    rng = np.random.default_rng(seed)
    ampdus = [aggregate_vht([build_udp_mpdu(
        bytes(rng.integers(0, 256, 30 + 25 * u, dtype=np.uint8)), CFG_QOS)])
        for u in range(n_user)]
    mods = [Mod(F.VHT, m, bw, 1) for m in (3, 1, 4, 0)[:n_user]]
    nfft = {BW.BW20: 64, BW.BW40: 128, BW.BW80: 256}[bw]
    q, _ = np.linalg.qr(rng.normal(size=(nfft, n_user, n_user))
                        + 1j * rng.normal(size=(nfft, n_user, n_user)))
    return ampdus, mods, q


@pytest.mark.parametrize("n_user,bw", [(2, BW.BW20), (4, BW.BW20),
                                       (2, BW.BW80)])
def test_mu_tx_equals_jax_and_golden(n_user, bw):
    ampdus, mods, q = _mu_case(n_user, bw, seed=n_user)
    want = gen_ampdu_mu(ampdus, mods, q, group_id=3).waveform
    q2 = c2r(q.astype(np.complex64))
    psdus = [_rows(a, 2) for a in ampdus]
    ref = np.asarray(jax_tx.MuTxPipeline(
        mods, [len(a) for a in ampdus], group_id=3).step(
            tuple(jnp.asarray(p) for p in psdus), jnp.asarray(q2)))
    mu = MuTxPipeline([port_mod(m) for m in mods], [len(a) for a in ampdus],
                      group_id=3, device="cpu")
    got = mu.step([torch.from_numpy(p) for p in psdus],
                  torch.from_numpy(q2)).numpy()
    assert got.shape == ref.shape == (2, n_user, want.shape[-1], 2)
    assert mu.n_samp == want.shape[-1]
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    for row in got:
        np.testing.assert_allclose(_as_c(row), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("fmt,mcs,nsts", [(F.HT, 12, 2), (F.VHT, 7, 2),
                                          (F.L, 5, 1)])
def test_tx_buffers_are_the_jax_constants(fmt, mcs, nsts):
    mod = Mod(fmt, mcs, BW.BW20, nsts)
    pp = (ppdu_params_aggregate(mod, 120) if fmt == F.VHT
          else ppdu_params_nonaggregate(mod, 120))
    ref = jax_tx.TxPipeline(mod, pp)
    bufs = {k: v.numpy() for k, v in _port_tx(mod, pp).named_buffers()}
    for name in ("preamble", "prbs", "service", "fixed_tail", "punct_idx",
                 "es_idx", "bit_idx", "tx_perms", "window"):
        np.testing.assert_array_equal(bufs[name], getattr(ref, name),
                                      err_msg=name)
    np.testing.assert_array_equal(bufs["pilots"],
                                  ref.pilots.astype(np.complex64))
    np.testing.assert_array_equal(bufs["csd"], ref.csd)
    np.testing.assert_array_equal(bufs["qam"].real, ref.qam_r)
    np.testing.assert_array_equal(bufs["qam"].imag, ref.qam_i)


def test_mu_tx_buffers_are_the_jax_constants():
    ampdus, mods, _ = _mu_case(2, BW.BW20, seed=5)
    lens = [len(a) for a in ampdus]
    ref = jax_tx.MuTxPipeline(mods, lens, group_id=2)
    mu = MuTxPipeline([port_mod(m) for m in mods], lens, group_id=2,
                      device="cpu")
    np.testing.assert_array_equal(mu.preamble.numpy(), ref.preamble)
    for name in ("stf_grid", "ltf_grids", "sigb_grid"):
        np.testing.assert_array_equal(
            getattr(mu, name).numpy(),
            getattr(ref, name).astype(np.complex64), err_msg=name)
    for u, ru in zip(mu.users, ref.users):
        for name in ("prbs", "service", "fixed_tail", "punct_idx",
                     "tx_perms"):
            np.testing.assert_array_equal(getattr(u, name).numpy(),
                                          getattr(ru, name), err_msg=name)
    assert (mu.n_sym, mu.n_sts, mu.n_samp) == (ref.n_sym, ref.n_sts,
                                               ref.n_samp)
    assert [list(c) for c in mu.sigb_crcs] == [list(c)
                                               for c in ref.sigb_crcs]


@pytest.mark.parametrize("fmt,mcs,ampdu", [(F.L, 0, False), (F.HT, 5, True),
                                           (F.HT, 5, False),
                                           (F.VHT, 7, True)])
def test_get_tx_pipeline_equals_jax(fmt, mcs, ampdu):
    mod = Mod(fmt, mcs)
    ref = jax_tx.get_tx_pipeline(mod, 200, ampdu)
    got = get_tx_pipeline(port_mod(mod), 200, ampdu, device="cpu")
    assert got is get_tx_pipeline(port_mod(mod), 200, ampdu, "cpu")
    assert vars(got.pp).keys() == vars(ref.pp).keys()
    assert all(getattr(got.pp, k) == getattr(ref.pp, k)
               for k in vars(ref.pp) if k != "mod")
    assert (got.in_len, got.n_samp) == (ref.in_len, ref.n_samp)


def test_cpu_tx_launches_no_kernel_and_checks_options():
    before = (kv.LAUNCHES, kg.LAUNCHES, kg.SHARED_LAUNCHES)
    test_tx_vht_equals_jax_and_golden(7, 2)
    assert (kv.LAUNCHES, kg.LAUNCHES, kg.SHARED_LAUNCHES) == before
    mod = port_mod(Mod(F.VHT, 0, BW.BW20, 2))
    pp = pmodulation.ppdu_params_aggregate_mu(mod, 100, 10)
    with pytest.raises(ValueError, match="MuTxPipeline"):
        TxPipeline(mod, pp, device="cpu")
