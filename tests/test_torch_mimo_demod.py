"""The port's 2x2 MIMO and multi-chain MRC demod ops
(ieee80211_tpu_torch/ops/demod.py) against the JAX package's.

Everything here is float32 complex arithmetic summed in another order than
XLA's, so it is held to a tolerance relative to the largest magnitude of
the reference: 1e-5 for channel estimates and MRC grids, 1e-4 for ZF
outputs (the 2x2 Gram inverse divides by its determinant), 1e-4 for LLRs
(each is a difference of two minimum distances), 1e-4 dB for EVM SNRs.
The ML LLRs must also have equal signs wherever their magnitude exceeds
that tolerance. The nearest-grid slice is exact: it rounds half to even in
both packages.
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
ZF_RTOL = 1e-4
LLR_RTOL = 1e-4
EVM_TOL = 1e-4    # dB
MODS = [M.BPSK, M.QPSK, M.QAM16, M.QAM64, M.QAM256]


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _close(got, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=rtol * float(np.max(np.abs(ref))))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ref_nl(bw):
    return _t(demod.ltf_ref_grid(bw, False).astype(np.complex64))


P_LTF = _t(tables.P_LTF_4[:2, :2].astype(np.float32))


@pytest.mark.parametrize("vht", [False, True], ids=["HT", "VHT"])
@pytest.mark.parametrize("bw", [BW.BW20, BW.BW40, BW.BW80])
def test_mimo_chan_est_2x2_close(bw, vht):
    n = tables.NFFT[bw]
    rng = np.random.default_rng(n + vht)
    ltf = _cplx(rng, (3, 2, 2, n))
    ref = jdemod.mimo_chan_est_2x2(jnp.asarray(ltf), bw, vht=vht)
    got = demod.mimo_chan_est_2x2(_t(ltf), _ref_nl(bw), P_LTF)
    assert tuple(got.shape) == (3, n, 2, 2) == np.asarray(ref).shape
    _close(got.numpy(), ref, GRID_RTOL)
    null = demod.ltf_ref_grid(bw, False) == 0
    assert not got.numpy()[:, null].any()


def test_mimo_equalize_2x2_close_with_det_floor():
    """Random channels, one tone where H is singular (det exactly 0) and one
    scaled far down (Gram determinant |det H|^2 ~ 4e-15): both take the
    1e-12 floor."""
    rng = np.random.default_rng(5)
    n = 64
    h = _cplx(rng, (2, n, 2, 2)) + 2.0 * np.eye(2, dtype=np.complex64)
    h[0, 10, :, 1] = h[0, 10, :, 0]           # singular
    h[1, 20] *= 1e-4
    grids = _cplx(rng, (2, 2, 3, n))
    det = np.linalg.det(h.astype(np.complex128))
    assert abs(det[0, 10]) == 0 and abs(det[1, 20]) ** 2 < 1e-12
    ref = np.asarray(jdemod.mimo_equalize_2x2(jnp.asarray(grids),
                                              jnp.asarray(h)))
    got = demod.mimo_equalize_2x2(_t(grids), _t(h)).numpy()
    assert got.shape == (2, 2, 3, n)
    _close(got, ref, ZF_RTOL)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[0, :, :, 10], 0)
    # the floored tone is not the true inverse (which would be ~1e4 larger)
    true = np.linalg.solve(h[1, 20].astype(np.complex128),
                           grids[1, :, :, 20])
    assert np.max(np.abs(got[1, :, :, 20])) < 1e-2 * np.max(np.abs(true))


def _ml_inputs(rng, mod, b=2, s=3, nsd=52, noise=0.1):
    """Received tones of random points of `mod` on both streams through a
    random well-conditioned channel, plus noise."""
    tab = tables.QAM_TAB[mod]
    x = tab[rng.integers(0, len(tab), (b, 2, s, nsd))]
    h = (_cplx(rng, (b, nsd, 2, 2))
         + 2.0 * np.eye(2, dtype=np.complex64)).astype(np.complex64)
    y = np.einsum("bkrs,bsSk->brSk", h, x) + noise * _cplx(rng, (b, 2, s,
                                                                  nsd))
    return y.astype(np.complex64), h


def _ml_tensors(mod):
    pts, masks = demod._ml_candidates(mod)
    return _t(pts), _t(masks)


@pytest.mark.parametrize("mod", MODS)
def test_ml_detect_llr_2x2_close(mod):
    rng = np.random.default_rng(int(mod) + 30)
    y, h = _ml_inputs(rng, mod)
    ref = np.asarray(jdemod.ml_detect_llr_2x2(jnp.asarray(y), jnp.asarray(h),
                                              mod))
    got = demod.ml_detect_llr_2x2(_t(y), _t(h), mod, *_ml_tensors(mod))
    got = got.numpy()
    assert got.shape == ref.shape == (2, 2, 3, 52 * max(1, int(
        np.log2(len(tables.QAM_TAB[mod])))))
    tol = LLR_RTOL * float(np.max(np.abs(ref)))
    _close(got, ref, LLR_RTOL)
    big = np.abs(ref) > tol
    assert big.mean() > 0.9
    np.testing.assert_array_equal(np.sign(got[big]), np.sign(ref[big]))


@pytest.mark.parametrize("mod", [M.QAM16, M.QAM256])
def test_ml_detect_chunks_change_nothing(mod):
    """A candidate budget of one symbol per chunk gives the same LLRs, bit
    for bit, as one chunk: every minimum is per (packet, symbol, tone)."""
    rng = np.random.default_rng(int(mod) + 40)
    y, h = _ml_inputs(rng, mod, s=5)
    args = (_t(y), _t(h), mod, *_ml_tensors(mod))
    whole = demod.ml_detect_llr_2x2(*args)
    chunked = demod.ml_detect_llr_2x2(*args, chunk_bytes=1)
    assert torch.equal(whole, chunked)


@pytest.mark.parametrize("mod", MODS)
def test_ml_candidates_equal_jax(mod):
    pts, masks = demod._ml_candidates(mod)
    jpts, jmasks = jdemod._ml_candidates(mod)
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(masks, jmasks)


def test_round_is_half_to_even_in_both():
    v = np.array([-3.5, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5], np.float32)
    want = np.array([-4, -2, -2, -0, 0, 2, 2, 4], np.float32)
    np.testing.assert_array_equal(torch.round(_t(v)).numpy(), want)
    np.testing.assert_array_equal(np.asarray(jnp.round(jnp.asarray(v))),
                                  want)


@pytest.mark.parametrize("mod", [M.BPSK, M.QBPSK, M.QPSK, M.QAM16, M.QAM64,
                                 M.QAM256])
def test_slice_to_grid_on_half_way_points(mod):
    """Points whose scaled axes lie on even integers, half-way between two
    odd grid levels, beyond the outer level, and at random: equal to JAX,
    every one a constellation point (up to the float32 rounding of the
    division by kmod)."""
    kmod = float(tables.KMOD[mod]) if mod not in (M.BPSK, M.QBPSK) else 1.0
    lv = np.arange(-18, 19, 2, dtype=np.float32)
    re, im = np.meshgrid(lv, lv)
    z = ((re + 1j * im) / kmod).astype(np.complex64).ravel()
    z = np.concatenate([z, _cplx(np.random.default_rng(3), 200) * 2])
    ref = np.asarray(jdemod._slice_to_grid(jnp.asarray(z), mod))
    got = demod._slice_to_grid(_t(z), mod).numpy()
    np.testing.assert_array_equal(got, ref)
    if mod not in (M.BPSK, M.QBPSK):
        pts = tables.QAM_TAB[mod].astype(np.complex64)
        assert (np.abs(got[:, None] - pts[None]).min(axis=1) < 1e-6).all()


def test_mrc_combine_close():
    rng = np.random.default_rng(8)
    grids = _cplx(rng, (3, 2, 4, 128))
    chan = _cplx(rng, (3, 2, 128))
    chan[1, 0, 5:9] = 0                      # a dead chain on a few tones
    ref = jdemod.mrc_combine(jnp.asarray(grids), jnp.asarray(chan))
    got = demod.mrc_combine(_t(grids), _t(chan))
    assert tuple(got.shape) == (3, 4, 128)
    _close(got.numpy(), ref, GRID_RTOL)


@pytest.mark.parametrize("mod", [Mod(F.L, 3), Mod(F.HT, 5), Mod(F.VHT, 7),
                                 Mod(F.VHT, 9, BW.BW80, 1)])
@pytest.mark.parametrize("n_valid", [False, True], ids=["all", "n_valid"])
def test_demod_data_mrc_close(mod, n_valid):
    """Noisy constellation points on two chains through random channels,
    with and without a bucket of 6 symbols holding packets of 6, 4 and 1."""
    n_sym = 6
    pidx0 = {F.L: 1, F.HT: 3, F.VHT: 4}[mod.fmt]
    n = tables.NFFT[mod.bw]
    key = (mod.bw, mod.fmt == F.L)
    rng = np.random.default_rng(n + mod.mcs + 11)
    tab = tables.QAM_TAB[mod.mod]
    eq = np.zeros((3, n_sym, n), np.complex64)
    eq[..., tables.DATA_GRID[key]] = tab[rng.integers(
        0, len(tab), (3, n_sym, mod.nSD))]
    eq[..., tables.PILOT_GRID[key]] = demod.pilot_refs(port_mod(mod), n_sym,
                                                       pidx0)
    chan = _cplx(rng, (3, 2, n)) + 1.0
    grids = (chan[:, :, None] * eq[:, None]
             + 0.03 * _cplx(rng, (3, 2, n_sym, n))).astype(np.complex64)
    nv = np.array([6, 4, 1], np.int32) if n_valid else None
    ref_llr, ref_evm = jdemod.demod_data_mrc(
        jnp.asarray(grids), jnp.asarray(chan), mod, n_sym, pidx0,
        with_snr=True, n_valid_sym=None if nv is None else jnp.asarray(nv))
    llr, evm = demod.demod_data_mrc(
        _t(grids), _t(chan), port_mod(mod),
        _t(demod.pilot_refs(port_mod(mod), n_sym, pidx0)
           .astype(np.float32)),
        _t(tables.PILOT_GRID[key].astype(np.int64)),
        _t(tables.DATA_GRID[key].astype(np.int64)),
        _t(ilv.rx_perm(mod, 0)), with_snr=True,
        n_valid_sym=None if nv is None else _t(nv))
    assert tuple(llr.shape) == (3, n_sym * mod.nCBPS)
    _close(llr.numpy(), ref_llr, LLR_RTOL)
    np.testing.assert_allclose(evm.numpy(), np.asarray(ref_evm), rtol=0,
                               atol=EVM_TOL)
    assert (evm.numpy() > 20).all()
    if n_valid:
        per = llr.numpy().reshape(3, n_sym, -1)
        assert not per[1, 4:].any() and not per[2, 1:].any()
