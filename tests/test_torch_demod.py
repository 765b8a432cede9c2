"""The port's SISO demod ops (ieee80211_tpu_torch/ops/demod.py) against the
JAX package. Slicing is exact; everything downstream of the DFT matmuls is
float32 arithmetic summed in another order, so it is held to a relative
tolerance: 1e-5 of the largest magnitude for grids and channels, 1e-4 of
max |LLR| for LLRs (the divisions by the channel and the pilot phasor
amplify the rounding), 1e-4 dB for EVM SNRs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ieee80211_tpu.ops import demod as jdemod
from ieee80211_tpu.specs import BW, F, M, Mod, tables
from ieee80211_tpu.specs import interleaver as ilv
from ieee80211_tpu_torch.ops import demod
from torch_parity import port_mod

GRID_RTOL = 1e-5
LLR_RTOL = 1e-4
EVM_TOL = 1e-4    # dB


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _close(got, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * float(np.max(np.abs(ref))))


def _dft(n):
    return tuple(torch.from_numpy(m) for m in demod._dft_mats(n))


@pytest.mark.parametrize("n", [64, 128, 256])
def test_fft_syms_close(n):
    rng = np.random.default_rng(n)
    x = _cplx(rng, (3, 5, n))
    ref = jdemod.fft_syms(jnp.asarray(x))
    got = demod.fft_syms(torch.from_numpy(x), *_dft(n))
    _close(got.numpy(), ref, GRID_RTOL)
    # the shifted grid is the centred FFT
    _close(got.numpy(), np.fft.fftshift(np.fft.fft(x, axis=-1), axes=-1),
           GRID_RTOL)


def test_static_symbol_windows_exact():
    rng = np.random.default_rng(2)
    z = _cplx(rng, (2, 1200))
    for off, n_sym, stride in [(0, 2, 64), (144, 1, None), (448, 7, None)]:
        ref = jdemod.static_symbol_windows(jnp.asarray(z), off, n_sym,
                                           nfft=64, gi=16, shift=4,
                                           stride=stride)
        got = demod.static_symbol_windows(torch.from_numpy(z), off, n_sym,
                                          nfft=64, gi=16, shift=4,
                                          stride=stride)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mod", [M.BPSK, M.QBPSK, M.QPSK, M.QAM16, M.QAM64,
                                 M.QAM256])
def test_demap_llr_close(mod):
    rng = np.random.default_rng(int(mod))
    eq = _cplx(rng, (2, 3, 52))
    ref = jdemod.demap_llr(jnp.asarray(eq), mod)
    got = demod.demap_llr(torch.from_numpy(eq), mod)
    assert tuple(got.shape) == np.asarray(ref).shape
    _close(got.numpy(), ref, GRID_RTOL)


@pytest.mark.parametrize("bw", [BW.BW20, BW.BW40, BW.BW80])
def test_channel_estimates_close(bw):
    n = tables.NFFT[bw]
    rng = np.random.default_rng(n + 1)
    ltf = _cplx(rng, (3, 2, n))
    ref_l = torch.from_numpy(demod.ltf_ref_grid(bw, True).astype(np.complex64))
    ref_nl = torch.from_numpy(
        demod.ltf_ref_grid(bw, False).astype(np.complex64))
    got = demod.legacy_chan_est(torch.from_numpy(ltf), ref_l)
    _close(got.numpy(), jdemod.legacy_chan_est(jnp.asarray(ltf), bw),
           GRID_RTOL)
    got = demod.nonlegacy_chan_est_siso(torch.from_numpy(ltf[:, 0]), ref_nl)
    _close(got.numpy(),
           jdemod.nonlegacy_chan_est_siso(jnp.asarray(ltf[:, 0]), bw),
           GRID_RTOL)


@pytest.mark.parametrize("mod", [Mod(F.VHT, 7), Mod(F.L, 7), Mod(F.HT, 0),
                                 Mod(F.VHT, 9, BW.BW40, 1),
                                 Mod(F.VHT, 9, BW.BW80, 1)])
def test_demod_data_siso_close(mod):
    """CSI-weighted LLRs of random grids through a random channel."""
    n_sym = 3
    pidx0 = {F.L: 1, F.HT: 3, F.VHT: 4}[mod.fmt]
    n = tables.NFFT[mod.bw]
    rng = np.random.default_rng(n + mod.mcs)
    grids = _cplx(rng, (2, n_sym, n))
    chan = _cplx(rng, (2, n)) + 1.5
    ref = jdemod.demod_data_siso(jnp.asarray(grids), jnp.asarray(chan), mod,
                                 n_sym, pidx0)
    key = (mod.bw, mod.fmt == F.L)
    got = demod.demod_data_siso(
        torch.from_numpy(grids), torch.from_numpy(chan), port_mod(mod),
        torch.from_numpy(demod.pilot_refs(port_mod(mod), n_sym, pidx0)
                         .astype(np.float32)),
        torch.from_numpy(tables.PILOT_GRID[key].astype(np.int64)),
        torch.from_numpy(tables.DATA_GRID[key].astype(np.int64)),
        torch.from_numpy(ilv.rx_perm(mod, 0)))
    assert tuple(got.shape) == (2, n_sym * mod.nCBPS)
    _close(got.numpy(), ref, LLR_RTOL)


@pytest.mark.parametrize("q,n_sym,stride,shift", [
    (1, 2, 64, 8), (1, 1, None, 8), (1, 2, None, 8), (4, 2, 256, 32),
    (4, 2, None, 32), (1, 3, None, 4)])
def test_extract_symbol_windows_exact(q, n_sym, stride, shift):
    """Per-packet windows, starts near the end included (clipped to
    N - span as jax.lax.dynamic_slice clips them)."""
    nfft, gi = 64 * q, 16 * q
    rng = np.random.default_rng(q * 10 + n_sym)
    n = 1100 * q
    x = _cplx(rng, (5, n))
    start = np.array([0, 17 * q, 300 * q, n - 100 * q, n - 1], np.int32)
    kw = dict(nfft=nfft, gi=gi, shift=shift, stride=stride)
    ref = jdemod.extract_symbol_windows(jnp.asarray(x), jnp.asarray(start),
                                        n_sym, **kw)
    got = demod.extract_symbol_windows(torch.from_numpy(x),
                                       torch.from_numpy(start), n_sym, **kw)
    assert tuple(got.shape) == (5, n_sym, nfft)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _points(rng, mod: M, shape):
    """Random constellation points of `mod` (the golden TX's table)."""
    tab = tables.QAM_TAB[mod]
    return tab[rng.integers(0, len(tab), shape)]


@pytest.mark.parametrize("mod", [M.BPSK, M.QBPSK, M.QPSK, M.QAM16, M.QAM64,
                                 M.QAM256])
def test_evm_snr_db_close(mod):
    """Noisy constellation points, over all symbols and with a symbol
    mask that leaves out NaN symbols (as past a packet's end)."""
    rng = np.random.default_rng(int(mod) + 50)
    eq = (_points(rng, mod, (3, 5, 52)) + 0.03 * _cplx(rng, (3, 5, 52))
          ).astype(np.complex64)
    ref = jdemod.evm_snr_db(jnp.asarray(eq), mod)
    got = demod.evm_snr_db(torch.from_numpy(eq), mod)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=EVM_TOL)
    mask = np.arange(5)[None, :] < np.array([5, 3, 1])[:, None]
    eq[1, 3:] = np.nan
    ref = jdemod.evm_snr_db(jnp.asarray(eq), mod, sym_mask=jnp.asarray(mask))
    got = demod.evm_snr_db(torch.from_numpy(eq), mod,
                           sym_mask=torch.from_numpy(mask))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=EVM_TOL)


@pytest.mark.parametrize("mod", [Mod(F.VHT, 7), Mod(F.HT, 5), Mod(F.L, 3),
                                 Mod(F.VHT, 9, BW.BW80, 1)])
def test_demod_data_siso_n_valid_close(mod):
    """A bucket of 6 symbols holding packets of 6, 4 and 1 true symbols:
    LLRs past each packet's end are exactly 0, and the EVM SNR leaves them
    out."""
    n_sym = 6
    pidx0 = {F.L: 1, F.HT: 3, F.VHT: 4}[mod.fmt]
    n = tables.NFFT[mod.bw]
    key = (mod.bw, mod.fmt == F.L)
    rng = np.random.default_rng(n + mod.mcs + 7)
    chan = _cplx(rng, (3, n)) + 1.5
    eq = np.zeros((3, n_sym, n), np.complex64)
    eq[..., tables.DATA_GRID[key]] = _points(rng, mod.mod,
                                             (3, n_sym, mod.nSD))
    eq[..., tables.PILOT_GRID[key]] = demod.pilot_refs(port_mod(mod), n_sym,
                                                       pidx0)
    grids = ((eq + 0.02 * _cplx(rng, eq.shape)) * chan[:, None]).astype(
        np.complex64)
    nv = np.array([6, 4, 1], np.int32)
    ref_llr, ref_evm = jdemod.demod_data_siso(
        jnp.asarray(grids), jnp.asarray(chan), mod, n_sym, pidx0,
        with_snr=True, n_valid_sym=jnp.asarray(nv))
    llr, evm = demod.demod_data_siso(
        torch.from_numpy(grids), torch.from_numpy(chan), port_mod(mod),
        torch.from_numpy(demod.pilot_refs(port_mod(mod), n_sym, pidx0)
                         .astype(np.float32)),
        torch.from_numpy(tables.PILOT_GRID[key].astype(np.int64)),
        torch.from_numpy(tables.DATA_GRID[key].astype(np.int64)),
        torch.from_numpy(ilv.rx_perm(mod, 0)), with_snr=True,
        n_valid_sym=torch.from_numpy(nv))
    _close(llr.numpy(), ref_llr, LLR_RTOL)
    per = llr.numpy().reshape(3, n_sym, -1)
    assert not per[1, 4:].any() and not per[2, 1:].any()
    assert per[2, 0].any()
    np.testing.assert_allclose(evm.numpy(), np.asarray(ref_evm), rtol=0,
                               atol=EVM_TOL)
    assert (evm.numpy() > 25).all()


def _multipath(rng, shape, n):
    """Frequency responses [*shape, n] of random 9-tap channels (a direct
    path and decaying complex reflections), on the centred FFT grid."""
    taps = _cplx(rng, shape + (9,)) * (0.6 ** np.arange(9))
    taps[..., 0] += 1.0
    return np.fft.fftshift(np.fft.fft(taps, n, axis=-1), axes=-1).astype(
        np.complex64)


def _tables(mod, n_sym):
    pidx0 = {F.L: 1, F.HT: 3, F.VHT: 4}[mod.fmt]
    key = (mod.bw, mod.fmt == F.L)
    return pidx0, (
        torch.from_numpy(demod.pilot_refs(port_mod(mod), n_sym, pidx0)
                         .astype(np.float32)),
        torch.from_numpy(tables.PILOT_GRID[key].astype(np.int64)),
        torch.from_numpy(tables.DATA_GRID[key].astype(np.int64)),
        torch.from_numpy(ilv.rx_perm(mod, 0)))


def _multipath_grids(rng, mod, n_sym, batch):
    """Noisy constellation points with the packet's pilots through random
    multipath channels: (grids [batch, n_sym, nfft], chan [batch, nfft])."""
    n = tables.NFFT[mod.bw]
    key = (mod.bw, mod.fmt == F.L)
    pidx0 = {F.L: 1, F.HT: 3, F.VHT: 4}[mod.fmt]
    eq = np.zeros((batch, n_sym, n), np.complex64)
    eq[..., tables.DATA_GRID[key]] = _points(rng, mod.mod,
                                             (batch, n_sym, mod.nSD))
    eq[..., tables.PILOT_GRID[key]] = demod.pilot_refs(port_mod(mod), n_sym,
                                                       pidx0)
    chan = _multipath(rng, (batch,), n)
    grids = (chan[..., None, :] * eq
             + 0.05 * _cplx(rng, (batch, n_sym, n))).astype(np.complex64)
    return grids, chan


@pytest.mark.parametrize("mod", [Mod(F.VHT, 7), Mod(F.L, 5), Mod(F.HT, 3),
                                 Mod(F.VHT, 7, BW.BW80, 1), Mod(F.VHT, 4),
                                 Mod(F.L, 3), Mod(F.VHT, 9, BW.BW40, 1)])
def test_demod_data_siso_unweighted_close(mod):
    """csi_weight=False (the reference's unweighted demap) on multipath
    grids, with the EVM SNR and a bucket of 4 symbols holding packets of 4,
    2 and 1: LLRs and EVM of both packages within LLR_RTOL / EVM_TOL, the
    LLRs past each packet's end zero, and unlike the weighted ones."""
    n_sym = 4
    rng = np.random.default_rng(tables.NFFT[mod.bw] + mod.mcs + 21)
    grids, chan = _multipath_grids(rng, mod, n_sym, 3)
    nv = np.array([4, 2, 1], np.int32)
    pidx0, tabs = _tables(mod, n_sym)
    ref_llr, ref_evm = jdemod.demod_data_siso(
        jnp.asarray(grids), jnp.asarray(chan), mod, n_sym, pidx0,
        with_snr=True, n_valid_sym=jnp.asarray(nv), csi_weight=False)
    args = (torch.from_numpy(grids), torch.from_numpy(chan), port_mod(mod),
            *tabs)
    kw = dict(with_snr=True, n_valid_sym=torch.from_numpy(nv))
    llr, evm = demod.demod_data_siso(*args, **kw, csi_weight=False)
    _close(llr.numpy(), ref_llr, LLR_RTOL)
    np.testing.assert_allclose(evm.numpy(), np.asarray(ref_evm), rtol=0,
                               atol=EVM_TOL)
    per = llr.numpy().reshape(3, n_sym, -1)
    assert not per[1, 2:].any() and not per[2, 1:].any()
    weighted, _ = demod.demod_data_siso(*args, **kw)
    assert not np.allclose(weighted.numpy(), llr.numpy(), rtol=0.1)
