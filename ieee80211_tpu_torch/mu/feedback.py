"""VHT MU-MIMO channel sounding & beamforming feedback.

The closed loop (reference cmu_v3 flow, SURVEY.md §3.3):

  AP sends NDP -> STA captures the two VHT-LTF symbols -> per-subcarrier
  channel estimate + pilot interpolation + CSD removal -> per-subcarrier
  SVD -> V -> (optionally Givens-compressed like the standard's
  compressed beamforming report) -> AP stacks both STAs' V into H,
  computes ZF Q = H (H^H H)^-1 (normalized), maps Q onto FFT bins and
  applies it as the TX spatial mapping.

Math parity: tools/phy80211header.py:1235-1379 (procVhtDataChanEst /
procVhtPilotChanIntpo / procVhtChannelFeedback),
tools/mac80211header.py:444-556 (procVhtVCompress/procVhtVRecover),
tools/cmu_v3/cmu_ap.py:165-205 (ZF Q).

Copy of ieee80211_tpu/mu/feedback.py: host-side numpy on the AP and the
STA (56 small matrices per report), kept in numpy because LAPACK's SVD
phases are the feedback's; tests/test_torch_mu.py holds it equal to the
original.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..specs import BW, tables

# ---------------------------------------------------------------------------
# NDP LTF capture -> channel estimate
# ---------------------------------------------------------------------------


def ndp_ltf_channel(ltf_iq: np.ndarray, n_sts: int = 2, bw: BW = BW.BW20
                    ) -> np.ndarray:
    """Raw CFO-corrected VHT-LTF time samples -> per-LTF tone estimates.

    ltf_iq: [nLtf * 64] complex time samples (the reference's `mu2x1chan`
    blob, lib/demod_impl.cc:396-399). Returns ltf_sym [nLtf, 52] data-tone
    values after FFT, tone descaling and pilot removal (the input format of
    vht_channel_feedback; parity: tools/cmu_v3/cmu_ap.py:165-176).
    """
    nfft = tables.NFFT[bw]
    n_ltf = len(ltf_iq) // nfft
    syms = np.fft.fftshift(
        np.fft.fft(np.asarray(ltf_iq).reshape(n_ltf, nfft), axis=-1), axes=-1)
    scale = np.sqrt(tables.SCALE_LTF_VHT[bw] * n_sts) / nfft
    syms = syms * scale
    return syms[:, tables.DATA_GRID[(bw, False)]]


# ---------------------------------------------------------------------------
# channel estimation + pilot interpolation + SVD feedback
# ---------------------------------------------------------------------------


def _data_chan_est(ltf_sym: np.ndarray, n_sts: int, n_rx: int) -> np.ndarray:
    """LTF data-tone symbols [nRx*nLtf, nSD] -> est [nSD, nRx, nSTS].

    H = rxLTF @ P^H / (ltf_ref * nLtf)  per subcarrier
    (parity: procVhtDataChanEst, tools/phy80211header.py:1235-1285).
    """
    n_ltf = tables.N_LTF[n_sts]
    ltf_occ = np.delete(tables.LTF_HT[BW.BW20], 28)   # drop DC -> 56 tones
    ref = ltf_occ[tables.data_pos_in_occ(BW.BW20, False)]
    p = tables.P_LTF_4[:n_sts, :n_ltf]
    y = np.asarray(ltf_sym).reshape(n_rx, n_ltf, -1)      # [nRx, nLtf, nSD]
    est = np.einsum("rlk,sl->krs", y, p.conj()) / ref[:, None, None] / n_ltf
    return est


def _csd_phase_tones(k_idx: np.ndarray, n_sts: int, sign: float) -> np.ndarray:
    """Per-(tone, sts) CSD phasor exp(-2j*pi*sign*csd_samp*k/64)."""
    csd = tables.CSD_NONLEGACY_NS[n_sts - 1, :n_sts] * 20 * 1e-3  # samples
    return np.exp(-2j * np.pi * sign * csd[None, :] * k_idx[:, None] / 64.0)


def _pilot_interp(est: np.ndarray, n_sts: int, n_rx: int) -> np.ndarray:
    """Interpolate pilot-tone channels from neighbors (52 -> 56 tones).

    CSD is removed before interpolation (magnitude/phase averaged) and
    re-applied (parity: procVhtPilotChanIntpo, phy80211header.py:1287-1338).
    """
    occ = tables._occupied(BW.BW20, False)
    kd = occ[tables.data_pos_in_occ(BW.BW20, False)].astype(np.float64)
    kdp = occ.astype(np.float64)
    no_csd = est * _csd_phase_tones(kd, n_sts, -1.0)[:, None, :]
    mag = np.abs(no_csd)
    ph = np.arctan2(np.imag(no_csd), np.real(no_csd))

    def interp(a):
        return np.concatenate([
            a[0:7], (a[6:7] + a[7:8]) / 2, a[7:20], (a[19:20] + a[20:21]) / 2,
            a[20:32], (a[31:32] + a[32:33]) / 2, a[32:45],
            (a[44:45] + a[45:46]) / 2, a[45:52]], axis=0)

    mag56 = interp(mag)
    ph56 = interp(ph)
    full = mag56 * (np.cos(ph56) + 1j * np.sin(ph56))
    return full * _csd_phase_tones(kdp, n_sts, 1.0)[:, None, :]


def vht_channel_feedback(ltf_sym: np.ndarray, bw: BW, n_sts: int, n_rx: int
                         ) -> np.ndarray:
    """LTF data-tone symbols -> per-tone beamforming V [56, nSTS, nRx].

    v_k = -conj(Vh_k)^T of the SVD of the CSD-free channel estimate
    (parity: procVhtChannelFeedback, phy80211header.py:1340-1379).
    """
    assert bw == BW.BW20, "feedback tables implemented for 20 MHz"
    est = _data_chan_est(ltf_sym, n_sts, n_rx)            # [52, nRx, nSTS]
    full = _pilot_interp(est, n_sts, n_rx)                # [56, nRx, nSTS]
    occ = tables._occupied(BW.BW20, False).astype(np.float64)
    no_csd = full * _csd_phase_tones(occ, n_sts, -1.0)[:, None, :]
    _, _, vh = np.linalg.svd(no_csd, full_matrices=False)
    return -np.conj(np.swapaxes(vh, -1, -2))              # [56, nSTS, nRx]


# ---------------------------------------------------------------------------
# Givens-rotation compression (IEEE 802.11-2020 19.3.12.3.6)
# ---------------------------------------------------------------------------


def _phi_quant(phi: float, nbit: int) -> int:
    step = np.pi / (1 << (nbit - 1))
    vals = np.arange(1 << nbit) * step + np.pi / (1 << nbit)
    return int(np.argmin(np.abs(vals - phi)))


def _psi_quant(psi: float, nbit: int) -> int:
    step = np.pi / (1 << (nbit + 1))
    vals = np.arange(1 << nbit) * step + np.pi / (1 << (nbit + 2))
    return int(np.argmin(np.abs(vals - psi)))


def _phi_dequant(q: int, nbit: int) -> float:
    return q * np.pi / (1 << (nbit - 1)) + np.pi / (1 << nbit)


def _psi_dequant(q: int, nbit: int) -> float:
    return q * np.pi / (1 << (nbit + 1)) + np.pi / (1 << (nbit + 2))


#: angle kind sequence per Nr (True = phi)
ANGLE_IS_PHI = {
    2: [True, False],
    3: [True, True, False, False, True, False],
    4: [True, True, True, False, False, False, True, True, False, False,
        True, False],
}
N_ANGLES = {(2, 1): 2, (2, 2): 2, (3, 1): 4, (3, 2): 6, (3, 3): 6,
            (4, 1): 6, (4, 2): 10, (4, 3): 12, (4, 4): 12}


def compress_v(v: np.ndarray, codebook: int = 0):
    """Givens-decompose V [m, n] into quantized (angles, is_phi) lists."""
    v = np.array(v, dtype=complex)
    m, n = v.shape
    nbit_phi, nbit_psi = (9, 7) if codebook else (7, 5)
    angles: List[int] = []
    kinds: List[bool] = []
    dt = np.diag(np.exp(1j * np.angle(v[m - 1, :])))
    w = v @ dt.conj().T
    w[m - 1, :] = np.real(w[m - 1, :])
    for i in range(1, min(m - 1, n) + 1):
        phis = np.angle(w[i - 1:m - 1, i - 1])
        if len(phis):
            phis = np.unwrap(phis)
            if phis[0] < 0:
                phis = phis + 2 * np.pi
            di = np.eye(m, dtype=complex)
            for j, ph in zip(range(i, m), phis):
                di[j - 1, j - 1] = np.exp(1j * ph)
            for ph in phis:
                angles.append(_phi_quant(ph, nbit_phi))
                kinds.append(True)
            w = di.conj().T @ w
        w[i - 1:m, i - 1] = np.real(w[i - 1:m, i - 1])
        for l in range(i + 1, m + 1):
            x1 = np.real(w[i - 1, i - 1])
            x2 = np.real(w[l - 1, i - 1])
            y = np.sqrt(x1 * x1 + x2 * x2)
            psi = np.arccos(x1 / y) if y > 0 else 0.0
            angles.append(_psi_quant(psi, nbit_psi))
            kinds.append(False)
            gli = np.eye(m, dtype=complex)
            gli[i - 1, i - 1] = np.cos(psi)
            gli[l - 1, i - 1] = -np.sin(psi)
            gli[i - 1, l - 1] = np.sin(psi)
            gli[l - 1, l - 1] = np.cos(psi)
            w = gli @ w
            w[l - 1, i - 1] = 0
    return angles, kinds


def recover_v(nr: int, nc: int, angles: Sequence[int], codebook: int = 0
              ) -> np.ndarray:
    """Rebuild V-tilde [nr, nc] from quantized Givens angles
    (parity: procVhtVRecover, mac80211header.py:516-556)."""
    nbit_phi, nbit_psi = (9, 7) if codebook else (7, 5)
    it = iter(angles)
    v = np.eye(nr, dtype=complex)
    for i in range(1, min(nr - 1, nc) + 1):
        di = np.eye(nr, dtype=complex)
        for j in range(i, nr):
            di[j - 1, j - 1] = np.exp(1j * _phi_dequant(next(it), nbit_phi))
        v = v @ di
        for l in range(i + 1, nr + 1):
            psi = _psi_dequant(next(it), nbit_psi)
            gli = np.eye(nr, dtype=complex)
            gli[i - 1, i - 1] = np.cos(psi)
            gli[l - 1, i - 1] = -np.sin(psi)
            gli[i - 1, l - 1] = np.sin(psi)
            gli[l - 1, l - 1] = np.cos(psi)
            v = v @ gli.T
    return v[:, :nc]


# ---------------------------------------------------------------------------
# ZF spatial mapping
# ---------------------------------------------------------------------------


def zf_q(v_users: Sequence[np.ndarray], normalize: bool = True) -> np.ndarray:
    """Per-tone ZF precoder from the users' feedback matrices.

    v_users: list of [nTones, nSTS, nRx_u]; stacked to H [nTones, nSTS,
    sum nRx]; Q = H (H^H H)^-1, Frobenius-normalized to sqrt(nSTS)
    (parity: cmu_v3/cmu_ap.py:188-199).
    """
    h = np.concatenate([np.asarray(v) for v in v_users], axis=-1)
    hh = np.conj(np.swapaxes(h, -1, -2))
    gram = hh @ h
    q = h @ np.linalg.inv(gram)
    if normalize:
        n_sts = h.shape[1]
        norms = np.linalg.norm(q, axis=(-2, -1), keepdims=True)
        q = q / norms * np.sqrt(n_sts)
    return q


def map_q_to_grid(q56: np.ndarray, bw: BW = BW.BW20) -> np.ndarray:
    """Per-occupied-tone Q [56, n, n] -> full FFT grid [64, n, n]
    (identity on null tones), aligned to the shifted-grid convention."""
    n = q56.shape[-1]
    nfft = tables.NFFT[bw]
    grid = np.tile(np.eye(n, dtype=complex), (nfft, 1, 1))
    grid[tables.OCC_GRID[(bw, False)]] = q56
    return grid
