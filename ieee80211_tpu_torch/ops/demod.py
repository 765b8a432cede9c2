"""Batched OFDM demodulation ops (PyTorch): DFT, symbol windows, channel
estimates, ZF equalize, pilot tracking, LLR demap, EVM SNR, deinterleave,
and the 2x2 MIMO and multi-chain MRC half.

Port of ieee80211_tpu/ops/demod.py (`fft_syms` :42,
`extract_symbol_windows` :58, `static_symbol_windows` :91, `pilot_refs`
:113, `pilot_phase` :119, `demap_llr` :138, `evm_snr_db` :162,
`ltf_ref_grid` :216, `legacy_chan_est` :227, `nonlegacy_chan_est_siso`
:236, `equalize` :245, `mimo_chan_est_2x2` :255, `mimo_equalize_2x2` :274,
`_ml_candidates` :302, `_slice_to_grid` :315, `ml_detect_llr_2x2` :333,
`_demod_data_tail` :393, `demod_data_siso` :437, `mrc_combine` :463,
`demod_data_mrc` :476).
Constant tables come in as tensors on the data's device (the receive
modules hold them as buffers), so a call copies nothing from the host.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..specs import BW, M, Mod, tables
from ..utils.riq import r2c, r_of
from . import sync

# ---------------------------------------------------------------------------
# FFT (shifted-grid convention, matching specs/tables.py)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _dft_mats(n: int):
    """Shifted-output DFT as real matrices (W_re, W_im), each [n, n]:
    X_shifted = x @ W^T with W[k', t] = exp(-2j*pi*(k'-n/2)*t/n)."""
    k = np.arange(n) - n // 2
    t = np.arange(n)
    w = np.exp(-2j * np.pi * np.outer(k, t) / n)
    return (np.ascontiguousarray(np.real(w).T.astype(np.float32)),
            np.ascontiguousarray(np.imag(w).T.astype(np.float32)))


def fft_syms(x: torch.Tensor, wr: torch.Tensor,
             wi: torch.Tensor) -> torch.Tensor:
    """Time symbols [..., N] complex -> shifted-order frequency grid
    [..., N], as a DFT matmul with (wr, wi) = `_dft_mats(N)` (whether cuFFT
    serves better on the card is left to measurement)."""
    xr, xi = x.real, x.imag
    out_r = torch.matmul(xr, wr) - torch.matmul(xi, wi)
    out_i = torch.matmul(xr, wi) + torch.matmul(xi, wr)
    return torch.complex(out_r, out_i)


def extract_symbol_windows(x: torch.Tensor, start: torch.Tensor,
                           n_sym: int, nfft: int = 64, gi: int = 16,
                           shift: int = 8,
                           stride: Optional[int] = None) -> torch.Tensor:
    """Per-packet OFDM symbol windows of x [B, N] complex64; start [B] is the
    first symbol's GI. Each symbol's data window is taken `shift` samples
    into its GI; stride is the symbol spacing (gi + nfft by default, nfft for
    the legacy LTF's two repetitions). Returns [B, n_sym, nfft].

    One window slice per packet of the span the JAX function slices, through
    `sync.batch_slice_iq` on the I/Q view (the slice kernel on the card;
    starts clipped to [0, N - span] as jax.lax.dynamic_slice clips them),
    then static slicing: the span padded by the last symbol's unused tail
    reshapes to [n_sym, stride].
    """
    sym = stride if stride is not None else (nfft + gi)
    total = gi - shift + sym * (n_sym - 1) + nfft
    first = start + (0 if gi - shift >= 0 else gi - shift)
    base = max(gi - shift, 0)
    seg = r2c(sync.batch_slice_iq(r_of(x.contiguous()), first, total))
    seg = F.pad(seg, (0, base + sym * n_sym - total))[:, base:]
    return seg.reshape(x.shape[0], n_sym, sym)[..., :nfft]


def static_symbol_windows(z: torch.Tensor, off: int, n_sym: int,
                          nfft: int = 64, gi: int = 16, shift: int = 8,
                          stride: Optional[int] = None) -> torch.Tensor:
    """OFDM symbol windows of a packet-aligned window z [B, Z]: symbol i
    starts at off + i*stride (stride defaults to gi + nfft; the legacy LTF's
    two repetitions use stride = nfft) and its data window is taken `shift`
    samples into the GI. Pure static slicing. Returns [B, n_sym, nfft]."""
    sym = stride if stride is not None else (nfft + gi)
    s0 = off + gi - shift
    seg = z[:, s0:s0 + sym * n_sym]
    return seg.reshape(z.shape[0], n_sym, sym)[..., :nfft]


# ---------------------------------------------------------------------------
# pilot tracking
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def pilot_refs(mod: Mod, n_sym: int, pidx0: int, iss: int = 0) -> np.ndarray:
    """Expected pilot values per symbol [n_sym, nSP] (polarity + rotation)."""
    from ..tx.golden import pilot_sequence
    return pilot_sequence(mod, n_sym, iss, pidx0=pidx0)


def pilot_phase(sym_grid: torch.Tensor, pilot_ref: torch.Tensor,
                pilot_bins: torch.Tensor) -> torch.Tensor:
    """Common-phase unit phasor per symbol from pilot tones.

    sym_grid: [B, S, nfft] equalized grids; pilot_ref: [S, nP];
    pilot_bins: [nP] int64. Returns [B, S] unit phasors.
    """
    pil = sym_grid[..., pilot_bins]                       # [B, S, nP]
    acc = torch.sum(pil * torch.conj(pilot_ref)[None], dim=-1)
    mag = torch.abs(acc)
    return acc / torch.where(mag > 0, mag, 1.0)


# ---------------------------------------------------------------------------
# LLR demap (piecewise-linear folds)
# ---------------------------------------------------------------------------

_AXIS_BITS = {M.QPSK: 1, M.QAM16: 2, M.QAM64: 3, M.QAM256: 4, M.QAM1024: 5}
_KMOD = {M.QPSK: np.sqrt(2.0), M.QAM16: np.sqrt(10.0),
         M.QAM64: np.sqrt(42.0), M.QAM256: np.sqrt(170.0),
         M.QAM1024: np.sqrt(682.0)}


def demap_llr(eq: torch.Tensor, mod: M) -> torch.Tensor:
    """Equalized data tones [..., nSD] -> soft bits [..., nSD*nBPSCS]."""
    if mod == M.BPSK:
        return eq.real
    if mod == M.QBPSK:
        return eq.imag
    nb_axis = _AXIS_BITS[mod]
    v = eq * float(_KMOD[mod])
    levels = []
    for axis in (v.real, v.imag):
        lv = axis
        levels.append(lv)
        for k in range(1, nb_axis):
            lv = (1 << (nb_axis - k)) - torch.abs(lv)
            levels.append(lv)
    # bit order: I-axis bits then Q-axis bits per subcarrier
    stacked = torch.stack(levels, dim=-1)                 # [..., nSD, 2*nb]
    return stacked.reshape(tuple(eq.shape[:-1]) + (-1,))


def evm_snr_db(eq: torch.Tensor, mod: M, sym_mask: Optional[torch.Tensor]
               = None) -> torch.Tensor:
    """EVM SNR in dB of equalized data tones eq [..., S, nSD] against their
    per-axis hard decisions, over the last two axes; sym_mask [..., S]
    (bool) leaves out the symbols where it is False."""
    if mod in (M.BPSK, M.QBPSK):
        kmod = 1.0
        levels = 1
    else:
        kmod = float(_KMOD[mod])
        levels = 1 << (_AXIS_BITS[mod] - 1)
    v = eq * kmod
    if mod == M.QBPSK:
        re = torch.zeros_like(v.real)
        im = torch.sign(v.imag)
    elif mod == M.BPSK:
        re = torch.sign(v.real)
        im = torch.zeros_like(re)
    else:
        def quant(a):
            return torch.clamp(2 * torch.round((a - 1) / 2) + 1,
                               -(2 * levels - 1), 2 * levels - 1)
        re = quant(v.real)
        im = quant(v.imag)
    err = (v.real - re) ** 2 + (v.imag - im) ** 2
    sig = re ** 2 + im ** 2
    if sym_mask is None:
        p_err = torch.mean(err, dim=(-2, -1))
        p_sig = torch.mean(sig, dim=(-2, -1))
    else:
        # where, not a product: symbols past a packet's end can be NaN
        m = sym_mask[..., None].expand(err.shape)
        denom = torch.clamp_min(m.to(err.dtype).sum(dim=(-2, -1)), 1.0)
        p_err = torch.where(m, err, 0.0).sum(dim=(-2, -1)) / denom
        p_sig = torch.where(m, sig, 0.0).sum(dim=(-2, -1)) / denom
    return 10.0 * torch.log10(torch.clamp_min(p_sig, 1e-12)
                              / torch.clamp_min(p_err, 1e-12))


# ---------------------------------------------------------------------------
# channel estimation / equalization (SISO)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def ltf_ref_grid(bw: BW, legacy: bool) -> np.ndarray:
    """LTF reference values on the shifted grid (zeros on null tones)."""
    nfft = tables.NFFT[bw]
    lim = {BW.BW20: 26 if legacy else 28, BW.BW40: 58, BW.BW80: 122}[bw]
    seq = tables.LTF_L[bw] if legacy else (
        tables.LTF_HT[bw] if bw != BW.BW80 else tables.LTF_VHT[bw])
    grid = np.zeros(nfft, dtype=np.complex128)
    grid[nfft // 2 - lim: nfft // 2 + lim + 1] = seq
    return grid


def _chan_from_ref(avg: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    null = ref == 0
    chan = avg / torch.where(null, 1.0, ref)
    return torch.where(null, torch.ones_like(chan), chan)


def legacy_chan_est(ltf_syms: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """[B, 2, nfft] L-LTF freq symbols -> [B, nfft] channel (1.0 on nulls).
    ref: `ltf_ref_grid(bw, True)` as complex64."""
    return _chan_from_ref(torch.mean(ltf_syms, dim=1), ref)


def nonlegacy_chan_est_siso(ltf_sym: torch.Tensor,
                            ref: torch.Tensor) -> torch.Tensor:
    """[B, nfft] single HT/VHT-LTF freq symbol -> [B, nfft] channel.
    ref: `ltf_ref_grid(bw, False)` as complex64."""
    return _chan_from_ref(ltf_sym, ref)


def equalize(grids: torch.Tensor, chan: torch.Tensor) -> torch.Tensor:
    """ZF equalize [B, S, nfft] by per-packet channel [B, nfft]."""
    return grids / chan[:, None, :]


# ---------------------------------------------------------------------------
# 2x2 MIMO channel estimation / equalization
# ---------------------------------------------------------------------------


def mimo_chan_est_2x2(ltf_syms: torch.Tensor, ref: torch.Tensor,
                      p_ltf: torch.Tensor) -> torch.Tensor:
    """2x2 channel from the two HT/VHT-LTF symbols on both RX chains.

    ltf_syms: [B, nRx=2, nLtf=2, nfft] frequency-domain LTF symbols; ref:
    `ltf_ref_grid(bw, False)` as complex64; p_ltf: `tables.P_LTF_4[:2, :2]`
    as float32. Returns H [B, nfft, nRx, nSTS] with the P-matrix combining
    H[b, k, r, s] = sum_l P[s, l] Y[b, r, l, k] / (2 ref[k]), and 0 on the
    bins where ref is 0.
    """
    h = torch.einsum("sl,brlk->bkrs", p_ltf.to(ltf_syms.dtype), ltf_syms)
    null = ref == 0
    h = h / 2.0 / torch.where(null, 1.0, ref)[None, :, None, None]
    return torch.where(null[None, :, None, None], torch.zeros_like(h), h)


def mimo_equalize_2x2(grids: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """ZF (pseudo-inverse) equalization of 2-stream symbols.

    grids: [B, nRx=2, S, nfft]; h: [B, nfft, nRx, nSTS]. Returns
    x_hat [B, nSTS=2, S, nfft] = (H^H H)^-1 H^H y per tone, with the Gram
    determinant floored to 1e-12 where its magnitude is not above it.
    """
    hh = torch.conj(h.transpose(-1, -2))          # [B, nfft, nSTS, nRx]
    gram = hh @ h                                         # [B, nfft, 2, 2]
    a, b_ = gram[..., 0, 0], gram[..., 0, 1]
    c, d = gram[..., 1, 0], gram[..., 1, 1]
    det = a * d - b_ * c
    det = torch.where(torch.abs(det) > 1e-12, det,
                      torch.full_like(det, 1e-12))
    inv = torch.stack([torch.stack([d, -b_], -1),
                       torch.stack([-c, a], -1)], -2) / det[..., None, None]
    w = inv @ hh                                          # [B, nfft, 2, nRx]
    return torch.einsum("bksr,brSk->bsSk", w, grids)


# ---------------------------------------------------------------------------
# 2x2 max-log ML detection
# ---------------------------------------------------------------------------

ML_CHUNK_BYTES = 1 << 28   # bound of one [B, S, nSD, Nc, nRx] intermediate


@lru_cache(maxsize=None)
def _ml_candidates(mod: M):
    """(points [Nc] complex64, bit masks [nBPSCS, Nc] bool) for one stream:
    candidate index == chip value, so bit p of the index is coded bit p of
    the subcarrier group, demap_llr's layout."""
    pts = np.asarray(tables.QAM_TAB[mod], dtype=np.complex64)
    nb = int(np.log2(len(pts)))
    idx = np.arange(len(pts))
    masks = np.stack([(idx >> p) & 1 for p in range(nb)]).astype(bool)
    return pts, masks


def _slice_to_grid(z: torch.Tensor, mod: M) -> torch.Tensor:
    """Exact nearest constellation point per complex z (QAM grids quantize
    per axis; BPSK / QBPSK collapse to one axis). torch.round rounds half to
    even, as jnp.round does."""
    if mod == M.BPSK:
        return torch.complex(torch.sign(z.real), torch.zeros_like(z.real))
    if mod == M.QBPSK:
        return torch.complex(torch.zeros_like(z.imag), torch.sign(z.imag))
    kmod = float(tables.KMOD[mod])
    lim = float((1 << _AXIS_BITS[mod]) - 1)
    v = z * kmod

    def q(a):
        return torch.clamp(2 * torch.round((a - 1) / 2) + 1, -lim, lim) / kmod
    # each axis divided on its own: XLA's complex-by-real division rounds
    # as that, PyTorch's complex division does not
    return torch.complex(q(v.real), q(v.imag))


def ml_detect_llr_2x2(gd: torch.Tensor, h: torch.Tensor, mod: M,
                      pts: torch.Tensor, masks: torch.Tensor,
                      chunk_bytes: int = ML_CHUNK_BYTES) -> torch.Tensor:
    """Exact max-log ML soft detection for 2 spatial streams.

    gd: [B, nRx=2, S, nSD] phase-corrected tone observations (data bins
    only); h: [B, nSD, nRx, nSTS=2] channel at those bins; (pts, masks):
    `_ml_candidates(mod)` as tensors on gd's device. Returns LLRs
    [B, nSTS, S, nCBPSS] in demap_llr's per-stream layout.

    For each stream j and candidate c_j the interfering stream's symbol is
    sliced exactly (the single-interferer projection onto the QAM grid is
    the exact conditional minimum), so d2(c_j) is the minimum over the whole
    product alphabet; LLR_p = min[d2 | bit_p = 0] - min[d2 | bit_p = 1].

    JAX lets XLA fuse the [B, S, nSD, Nc, nRx] candidate tensor; here it is
    materialized, so the symbols go through in chunks whose candidate tensor
    stays within `chunk_bytes`. Every value is per (packet, symbol, tone):
    chunking over symbols changes no minimum.
    """
    b, nrx, s, nsd = gd.shape
    nc = pts.shape[0]
    per_sym = b * nsd * nc * nrx * gd.element_size()
    step = max(1, min(s, chunk_bytes // max(per_sym, 1)))
    y = gd.permute(0, 2, 3, 1)                            # [B, S, nSD, nRx]
    out = []
    for j in (0, 1):
        hj = h[..., j][:, None, :, None, :]               # [B, 1, nSD, 1, nRx]
        ho = h[..., 1 - j]                                # [B, nSD, nRx]
        ho_n2 = torch.clamp_min(torch.sum(torch.abs(ho) ** 2, dim=-1),
                                1e-20)[:, None, :, None]  # [B, 1, nSD, 1]
        ho_c = torch.conj(ho)[:, None, :, None, :]
        ho = ho[:, None, :, None, :]
        cand = hj * pts[None, None, None, :, None]  # [B, 1, nSD, Nc, nRx]
        lj = []
        for s0 in range(0, s, step):
            # residual y - hj cj for every candidate: [B, Sc, nSD, Nc, nRx]
            r = y[:, s0:s0 + step, :, None, :] - cand
            # exact conditional minimum over the other stream
            z = torch.sum(ho_c * r, dim=-1) / ho_n2       # [B, Sc, nSD, Nc]
            co = _slice_to_grid(z, mod)
            d2 = torch.sum(torch.abs(r - ho * co[..., None]) ** 2, dim=-1)
            del r, z, co
            # min over the candidates whose bit p is 0, minus over those
            # whose bit p is 1 (masks[p]: bit p == 1)
            lj.append(torch.stack(
                [d2.masked_fill(m1, 1e30).amin(dim=-1)
                 - d2.masked_fill(~m1, 1e30).amin(dim=-1) for m1 in masks],
                dim=-1))                                  # [B, Sc, nSD, nb]
        # I bits then Q bits per tone: bit p of the chip == position p
        out.append(torch.cat(lj, dim=1).reshape(b, s, -1))
    return torch.stack(out, dim=1)                        # [B, 2, S, nCBPSS]


# ---------------------------------------------------------------------------
# full data-field demod (per static config)
# ---------------------------------------------------------------------------


def _demod_data_tail(eq: torch.Tensor, weight_grid: Optional[torch.Tensor],
                     mod: Mod, pilot_ref: torch.Tensor,
                     pilot_bins: torch.Tensor, data_bins: torch.Tensor,
                     perm: torch.Tensor,
                     with_snr: bool = False,
                     n_valid_sym: Optional[torch.Tensor] = None):
    """Post-equalization tail: pilot phase track + demap + per-tone CSI
    weighting + deinterleave (+ bucket-padding mask, + EVM SNR).

    eq: [B, n_sym, nfft] equalized grids; weight_grid: [B, nfft] real
    per-tone noise-inverse weight (|H|^2 for ZF SISO): ZF inflates the noise
    on faded tones by 1/|H|^2, and scaling each tone's LLRs by its weight
    restores the max-log metric (uniform, so decisions unchanged, on a flat
    channel); None leaves the LLRs unweighted (the reference's demap).
    Tables: pilot_ref `pilot_refs(...)` [n_sym, nSP], pilot_bins /
    data_bins `tables.PILOT_GRID` / `DATA_GRID`, perm `rx_perm(mod, 0)`.
    n_valid_sym: [B] int32 true symbol counts when n_sym is a bucket's
    capacity: LLRs of later symbols are zeroed (path-neutral in the Viterbi)
    and left out of the EVM.
    Returns LLRs in coded-bit order [B, n_sym * nCBPSS], and with with_snr
    also the EVM SNR [B] in dB.
    """
    ph = pilot_phase(eq, pilot_ref, pilot_bins)
    eq = eq / ph[..., None]
    data = eq[..., data_bins]                             # [B, S, nSD]
    llr = demap_llr(data, mod.mod)                        # [B, S, nCBPSS]
    if weight_grid is not None:
        w = weight_grid[..., data_bins]
        w = w / torch.clamp_min(torch.mean(w, dim=-1, keepdim=True), 1e-12)
        nb = llr.shape[-1] // data.shape[-1]
        llr = llr * torch.repeat_interleave(w, nb, dim=-1)[:, None, :]
    out = llr[..., perm]                                  # [B, S, nCBPSS]
    mask = None
    if n_valid_sym is not None:
        n_sym = out.shape[1]
        mask = (torch.arange(n_sym, device=out.device)[None, :]
                < n_valid_sym[:, None])                   # [B, S]
        out = torch.where(mask[..., None], out, 0.0)
    out = out.reshape(out.shape[0], -1)
    if with_snr:
        return out, evm_snr_db(data, mod.mod, sym_mask=mask)
    return out


def demod_data_siso(sym_grids: torch.Tensor, chan: torch.Tensor, mod: Mod,
                    pilot_ref: torch.Tensor, pilot_bins: torch.Tensor,
                    data_bins: torch.Tensor, perm: torch.Tensor,
                    with_snr: bool = False,
                    n_valid_sym: Optional[torch.Tensor] = None,
                    csi_weight: bool = True):
    """Equalize + track + demap + deinterleave the DATA field.

    sym_grids: [B, n_sym, nfft] raw FFT grids; chan: [B, nfft]. Returns
    LLRs in coded-bit order [B, n_sym * nCBPSS] (and the EVM SNR [B] with
    with_snr); n_valid_sym as in `_demod_data_tail`. csi_weight scales each
    tone's LLRs by |H|^2 (same decisions on a flat channel, multipath
    robustness on a frequency-selective one); False is the reference's
    unweighted demap.
    """
    eq = equalize(sym_grids, chan)
    wg = torch.abs(chan) ** 2 if csi_weight else None
    return _demod_data_tail(eq, wg, mod, pilot_ref, pilot_bins, data_bins,
                            perm, with_snr, n_valid_sym)


def mrc_combine(grids: torch.Tensor, chan: torch.Tensor) -> torch.Tensor:
    """Maximal-ratio combining of multi-chain symbol grids: grids
    [B, nRx, S, nfft], chan [B, nRx, nfft] -> the combined equalized grid
    [B, S, nfft], eq = sum_r conj(H_r) Y_r / (sum_r |H_r|^2 + 1e-9)."""
    den = torch.sum(torch.abs(chan) ** 2, dim=1) + 1e-9   # [B, nfft]
    num = torch.einsum("brsk,brk->bsk", grids, torch.conj(chan))
    return num / den[:, None, :]


def demod_data_mrc(sym_grids: torch.Tensor, chan: torch.Tensor, mod: Mod,
                   pilot_ref: torch.Tensor, pilot_bins: torch.Tensor,
                   data_bins: torch.Tensor, perm: torch.Tensor,
                   with_snr: bool = False,
                   n_valid_sym: Optional[torch.Tensor] = None):
    """demod_data_siso for a single-stream packet on several RX chains:
    sym_grids [B, nRx, n_sym, nfft], chan [B, nRx, nfft]. MRC-combines the
    chains, then runs the shared tail with the MRC combiner's noise-inverse
    weight sum_r |H_r|^2 as the per-tone CSI weight."""
    eq = mrc_combine(sym_grids, chan)
    return _demod_data_tail(eq, torch.sum(torch.abs(chan) ** 2, dim=1), mod,
                            pilot_ref, pilot_bins, data_bins, perm, with_snr,
                            n_valid_sym)
