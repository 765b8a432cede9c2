"""Golden-model transmitter (numpy, float64) — the framework's test oracle.

Standards-faithful TX for L/HT/VHT, SISO / up-to-4-stream SU-MIMO / up-to-4
user MU-MIMO, A-MPDU and NDP. Functional parity with the reference PY-TB
transmitter (reference tools/phy80211.py:80-884 `phy80211.genFromMpdu`
/`genFromAmpdu`/`genAmpduMu`); re-written as vectorized numpy over the spec
layer's index maps. Validated bit- and sample-exact against the reference in
tests/test_tx_vs_reference.py.

The performance TX path (batched, jit, bf16 where safe) lives in
tx/jax_tx.py; this module is correctness-first.

The benchmark's frozen copy of ieee80211_tpu_torch/tx/golden.py:
the traffic generator builds its packets with it and imports
nothing of the program it measures.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from ..specs import BW, CR, F, M, Mod, PpduParams, tables
from ..specs import interleaver as ilv
from ..specs.modulation import ppdu_params_aggregate, ppdu_params_nonaggregate
from ..specs.tables import crc8_bits

# ---------------------------------------------------------------------------
# bit helpers (LSB-first on air)
# ---------------------------------------------------------------------------


def bytes_to_bits(data: bytes) -> np.ndarray:
    if len(data) == 0:
        return np.zeros(0, dtype=np.int64)
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    return np.unpackbits(arr, bitorder="little").astype(np.int64)


def uint_to_bits(v: int, n: int) -> list:
    return [(v >> i) & 1 for i in range(n)]


# ---------------------------------------------------------------------------
# coding primitives
# ---------------------------------------------------------------------------


def scramble(bits: np.ndarray, seed: int) -> np.ndarray:
    """XOR with the 127-periodic PRBS of `seed` (17.3.5.5)."""
    n = len(bits)
    seq = tables.SCRAMBLE_SEQ[seed]
    reps = -(-n // 127)
    prbs = np.tile(seq, reps)[:n].astype(np.int64)
    return bits ^ prbs


def bcc_encode(bits: np.ndarray) -> np.ndarray:
    """Rate-1/2 convolutional encode (K=7, g0=133, g1=171), zero state.

    Vectorized: each output is an XOR of time-shifted input taps.
    Output layout [2N]: (out0, out1) interleaved per input bit.
    """
    bits = np.asarray(bits, dtype=np.int64)
    n = len(bits)
    padded = np.concatenate([np.zeros(6, dtype=np.int64), bits])
    # register(t) bit k = input bit t-k ; g masks G0=0o155, G1=0o117
    def taps(mask):
        out = np.zeros(n, dtype=np.int64)
        for k in range(7):
            if (mask >> k) & 1:
                out ^= padded[6 - k: 6 - k + n]
        return out
    out0 = taps(tables.G0)
    out1 = taps(tables.G1)
    out = np.empty(2 * n, dtype=np.int64)
    out[0::2] = out0
    out[1::2] = out1
    return out


def puncture(coded: np.ndarray, cr: CR) -> np.ndarray:
    pat = tables.PUNCTURE[cr]
    n = len(coded)
    keep = np.tile(pat.astype(bool), -(-n // len(pat)))[:n]
    return coded[keep]


def bcc(bits: np.ndarray, cr: CR) -> np.ndarray:
    return puncture(bcc_encode(bits), cr)


# ---------------------------------------------------------------------------
# OFDM assembly
# ---------------------------------------------------------------------------


def map_qam(bits: np.ndarray, mod: M, nbpscs: int) -> np.ndarray:
    """Interleaved bits -> constellation points (LSB-first chips)."""
    chips = bits.reshape(-1, nbpscs) @ (1 << np.arange(nbpscs))
    return tables.QAM_TAB[mod][chips]


def build_grid(data: np.ndarray, pilots: np.ndarray, bw: BW,
               legacy: bool) -> np.ndarray:
    """Place data+pilot tones onto the shifted FFT grid.

    data: [..., nSD], pilots: [..., nSP] -> [..., NFFT]
    """
    nfft = tables.NFFT[bw]
    grid = np.zeros(data.shape[:-1] + (nfft,), dtype=np.complex128)
    grid[..., tables.DATA_GRID[(bw, legacy)]] = data
    grid[..., tables.PILOT_GRID[(bw, legacy)]] = pilots
    return grid


def csd_phase(bw: BW, shift_ns: float) -> np.ndarray:
    """Per-grid-bin cyclic-shift phasor (freq-domain circular time shift)."""
    nfft = tables.NFFT[bw]
    spr = {BW.BW20: 20, BW.BW40: 40, BW.BW80: 80}[bw]
    k = np.arange(nfft) - nfft // 2
    return np.exp(-2j * np.pi * shift_ns * spr * 1e-3 * k / nfft)


def apply_csd(grid: np.ndarray, bw: BW, nss: int, iss: int,
              legacy_field: bool) -> np.ndarray:
    tab = tables.CSD_LEGACY_NS if legacy_field else tables.CSD_NONLEGACY_NS
    return grid * csd_phase(bw, tab[nss - 1, iss])


def ifft_sym(grid: np.ndarray) -> np.ndarray:
    """Shifted grid -> time symbol (ifft with ifftshift)."""
    return np.fft.ifft(np.fft.ifftshift(grid, axes=-1), axis=-1)


def add_gi(sym: np.ndarray) -> np.ndarray:
    n = sym.shape[-1]
    return np.concatenate([sym[..., 3 * n // 4:], sym], axis=-1)


def tone_scale(sig: np.ndarray, n_tone: int, nss: int) -> np.ndarray:
    return sig / np.sqrt(n_tone * nss)


def concat_blocks(blocks: Sequence[np.ndarray]) -> np.ndarray:
    """Concatenate field blocks, halving both samples at each boundary.

    Reproduces the reference's window smoothing (procConcat2Symbol,
    tools/phy80211header.py:910-917) applied at every field/symbol boundary.
    """
    out = [b.astype(np.complex128).copy() for b in blocks]
    for i in range(len(out) - 1):
        out[i][-1] *= 0.5
        out[i + 1][0] *= 0.5
    return np.concatenate(out)


# ---------------------------------------------------------------------------
# SIG field bit generation
# ---------------------------------------------------------------------------


def lsig_bits(mod: Mod, legacy_len: int) -> np.ndarray:
    """L-SIG: RATE(4) R(1) LENGTH(12) P(1) TAIL(6) (17.3.4)."""
    rate_mcs = mod.mcs if mod.fmt == F.L else 0
    bits = list(tables.LEGACY_RATE_BITS[rate_mcs]) + [0]
    bits += uint_to_bits(legacy_len, 12)
    bits.append(sum(bits) % 2)
    bits += [0] * 6
    return np.asarray(bits, dtype=np.int64)


def htsig_bits(mod: Mod, pp: PpduParams) -> np.ndarray:
    """HT-SIG1+2 (19.3.9.4.3)."""
    bits = uint_to_bits(mod.mcs, 7)
    bits.append(1 if mod.bw == BW.BW40 else 0)
    bits += uint_to_bits(pp.psdu_len, 16)
    bits += [1, 1, 1]                 # smoothing, not sounding, reserved
    bits.append(1 if pp.ampdu else 0)
    bits += [0, 0]                    # STBC
    bits.append(0)                    # BCC
    bits.append(1 if mod.sgi else 0)
    bits += [0, 0]                    # no ESS
    bits += crc8_bits(bits)
    bits += [0] * 6
    return np.asarray(bits, dtype=np.int64)


def vhtsiga_bits(mod: Mod, pp: PpduParams, group_id: int, partial_aid: int,
                 mu_nsts: Optional[Sequence[int]] = None) -> np.ndarray:
    """VHT-SIG-A1+A2 (21.3.8.3.3)."""
    bits = uint_to_bits(mod.bw.value, 2)
    bits += [1, 0]                    # reserved, no STBC
    bits += uint_to_bits(group_id, 6)
    if pp.mu:
        assert mu_nsts is not None
        for nsts in mu_nsts:
            bits += uint_to_bits(nsts, 3)
        for _ in range(4 - len(mu_nsts)):
            bits += [0, 0, 0]
    else:
        bits += uint_to_bits(mod.nSTS - 1, 3)
        bits += uint_to_bits(partial_aid, 9)
    bits += [0, 1]                    # txop ps allowed, reserved
    bits.append(1 if mod.sgi else 0)
    bits.append(1 if (mod.sgi and pp.n_sym % 10 == 9) else 0)
    bits.append(0)                    # SU/MU0 coding BCC
    bits.append(0)                    # LDPC extra
    if pp.mu:
        n_user = len(mu_nsts)
        bits += [0] * (n_user - 1)    # MU user 1..3 coding BCC
        bits += [1] * (4 - n_user)    # reserved
        bits += [1, 1]                # MU reserved, beamformed reserved
    else:
        bits += uint_to_bits(mod.mcs, 4)
        bits.append(0)                # not beamformed
    bits.append(1)                    # reserved
    bits += crc8_bits(bits)
    bits += [0] * 6
    return np.asarray(bits, dtype=np.int64)


def vhtsigb_bits(mod: Mod, pp: PpduParams):
    """VHT-SIG-B SU (21.3.8.3.6). Returns (bits, crc8-of-first-20/etc)."""
    if mod.bw == BW.BW20:
        n_len, n_res = 17, 3
    elif mod.bw == BW.BW40:
        n_len, n_res = 19, 2
    else:
        n_len, n_res = 21, 2
    if pp.ampdu_len > 0:
        bits = uint_to_bits(-(-pp.ampdu_len // 4), n_len) + [1] * n_res
        crc = crc8_bits(bits)
    else:
        bits = list(tables.NDP_SIG_B[mod.bw])
        crc = crc8_bits(bits)   # unused for NDP
    bits = bits + [0] * 6
    # bandwidth repetition (21.3.8.3.6): x2 @40 MHz, x4+pad @80 MHz. (The
    # reference writes x2+[0] for 80 MHz — phy80211.py:571 — which cannot
    # fill its own 234-tone interleaver; we follow the standard.)
    if mod.bw == BW.BW40:
        bits = bits * 2
    elif mod.bw == BW.BW80:
        bits = bits * 4 + [0]
    return np.asarray(bits, dtype=np.int64), np.asarray(crc, dtype=np.int64)


# ---------------------------------------------------------------------------
# field synthesis
# ---------------------------------------------------------------------------


def _legacy_grid_from_occ(occ_vals: np.ndarray, bw: BW) -> np.ndarray:
    """Occupied-tone vector (incl. DC span) -> shifted grid."""
    nfft = tables.NFFT[bw]
    grid = np.zeros(nfft, dtype=np.complex128)
    lim = {BW.BW20: 26, BW.BW40: 58, BW.BW80: 122}[bw]
    grid[nfft // 2 - lim: nfft // 2 + lim + 1] = occ_vals
    return grid


def legacy_training(mod: Mod) -> List[np.ndarray]:
    """[nSS] list of 320-sample L-STF+L-LTF blocks (with inner halving)."""
    bw = mod.bw
    out = []
    for iss in range(mod.nSS):
        stf_g = apply_csd(_legacy_grid_from_occ(tables.STF_L[bw], bw), bw,
                          mod.nSS, iss, True)
        ltf_g = apply_csd(_legacy_grid_from_occ(tables.LTF_L[bw], bw), bw,
                          mod.nSS, iss, True)
        stf = tone_scale(ifft_sym(stf_g), tables.SCALE_STF_L[bw], mod.nSS)
        ltf = tone_scale(ifft_sym(ltf_g), tables.SCALE_LTF_L[bw], mod.nSS)
        n = stf.shape[-1]
        stf_t = np.concatenate([stf[n // 2:], stf, stf])
        ltf_t = np.concatenate([ltf[n // 2:], ltf, ltf])
        out.append(concat_blocks([stf_t, ltf_t]))
    return out


def _bpsk_sig_symbol(int_bits: np.ndarray, qbpsk: bool, mod: Mod, iss: int,
                     scale: int) -> np.ndarray:
    """48 interleaved SIG bits -> one 80/160/320-sample legacy-tone symbol.

    40/80 MHz legacy-band fields duplicate the whole 64-bin shifted grid
    (reference tools/phy80211.py:290-295).
    """
    bw = mod.bw
    qam = tables.QAM_TAB[M.QBPSK if qbpsk else M.BPSK][int_bits]
    grid = build_grid(qam, tables.PILOT_L, BW.BW20, True)
    reps = {BW.BW20: 1, BW.BW40: 2, BW.BW80: 4}[bw]
    if reps > 1:
        grid = np.tile(grid, reps)
    grid = apply_csd(grid, bw, mod.nSS, iss, True)
    return add_gi(tone_scale(ifft_sym(grid), scale, mod.nSS))


def legacy_sig_field(mod: Mod, pp: PpduParams) -> List[np.ndarray]:
    bits = lsig_bits(mod, pp.legacy_len)
    coded = bcc(bits, CR.CR12)
    inted = coded[ilv.sig_tx_perm()]
    return [_bpsk_sig_symbol(inted, False, mod, iss, tables.SCALE_SIG_L[mod.bw])
            for iss in range(mod.nSS)]


def ht_sig_field(mod: Mod, pp: PpduParams) -> List[np.ndarray]:
    bits = htsig_bits(mod, pp)
    coded = bcc(bits, CR.CR12)
    i1 = coded[:48][ilv.sig_tx_perm()]
    i2 = coded[48:][ilv.sig_tx_perm()]
    out = []
    for iss in range(mod.nSS):
        s1 = _bpsk_sig_symbol(i1, True, mod, iss, tables.SCALE_SIG_HT[mod.bw])
        s2 = _bpsk_sig_symbol(i2, True, mod, iss, tables.SCALE_SIG_HT[mod.bw])
        out.append(concat_blocks([s1, s2]))
    return out


def vht_siga_field(mod: Mod, pp: PpduParams, group_id: int, partial_aid: int,
                   mu_nsts=None) -> List[np.ndarray]:
    bits = vhtsiga_bits(mod, pp, group_id, partial_aid, mu_nsts)
    coded = bcc(bits, CR.CR12)
    i1 = coded[:48][ilv.sig_tx_perm()]
    i2 = coded[48:][ilv.sig_tx_perm()]
    out = []
    for iss in range(mod.nSS):
        s1 = _bpsk_sig_symbol(i1, False, mod, iss, tables.SCALE_SIG_VHT_A[mod.bw])
        s2 = _bpsk_sig_symbol(i2, True, mod, iss, tables.SCALE_SIG_VHT_A[mod.bw])
        out.append(concat_blocks([s1, s2]))
    return out


def _vht_ltf_occ(bw: BW, iss: int, iltf: int) -> np.ndarray:
    """VHT-LTF occupied-tone values: P on data tones, R on pilot tones."""
    base = tables.LTF_VHT[bw]
    lim = {BW.BW20: 28, BW.BW40: 58, BW.BW80: 122}[bw]
    pil = tables.PILOT_SC[(bw, False)]
    k = np.arange(-lim, lim + 1)
    is_pilot = np.isin(k, pil)
    p = tables.P_LTF_4[iss % 4, iltf]
    r = tables.R_LTF_VHT[iltf]
    return base * np.where(is_pilot, r, p)


def _ht_ltf_occ(bw: BW, iss: int, iltf: int) -> np.ndarray:
    base = tables.LTF_HT[bw]
    return base * tables.P_LTF_4[iss % 4, iltf]


def nonlegacy_training(mod: Mod, bfq: Optional[np.ndarray] = None,
                       n_sts_total: Optional[int] = None) -> List[np.ndarray]:
    """[nSS] non-legacy STF + nLTF LTF blocks (halved at inner boundaries).

    bfq: optional [nfft, nSS, nSS] spatial mapping Q applied per tone
    (MU-MIMO beamforming), matching reference __genNonLegacyTraining.
    """
    bw = mod.bw
    nss = n_sts_total or mod.nSS
    nfft = tables.NFFT[bw]
    vht = mod.fmt == F.VHT
    # STF
    stf_gs = []
    for iss in range(nss):
        occ = tables.STF_VHT[bw] if vht else tables.STF_HT[bw]
        g = _nl_grid_from_occ(occ, bw)
        stf_gs.append(apply_csd(g, bw, nss, iss, False))
    stf_gs = np.stack(stf_gs)
    if bfq is not None:
        stf_gs = np.einsum("kij,jk->ik", bfq, stf_gs)
    blocks = [[] for _ in range(nss)]
    scale_stf = tables.SCALE_STF_VHT[bw] if vht else tables.SCALE_STF_HT[bw]
    scale_ltf = tables.SCALE_LTF_VHT[bw] if vht else tables.SCALE_LTF_HT[bw]
    for iss in range(nss):
        blocks[iss].append(add_gi(tone_scale(ifft_sym(stf_gs[iss]), scale_stf, nss)))
    # LTFs
    n_ltf = tables.N_LTF[nss]
    for iltf in range(n_ltf):
        ltf_gs = []
        for iss in range(nss):
            occ = _vht_ltf_occ(bw, iss, iltf) if vht else _ht_ltf_occ(bw, iss, iltf)
            g = _nl_grid_from_occ(occ, bw)
            ltf_gs.append(apply_csd(g, bw, nss, iss, False))
        ltf_gs = np.stack(ltf_gs)
        if bfq is not None:
            ltf_gs = np.einsum("kij,jk->ik", bfq, ltf_gs)
        for iss in range(nss):
            blocks[iss].append(add_gi(tone_scale(ifft_sym(ltf_gs[iss]),
                                                 scale_ltf, nss)))
    return [concat_blocks(b) for b in blocks]


def _nl_grid_from_occ(occ_vals: np.ndarray, bw: BW) -> np.ndarray:
    nfft = tables.NFFT[bw]
    lim = {BW.BW20: 28, BW.BW40: 58, BW.BW80: 122}[bw]
    grid = np.zeros(nfft, dtype=np.complex128)
    grid[nfft // 2 - lim: nfft // 2 + lim + 1] = occ_vals
    return grid


def vht_sigb_field(mod: Mod, sigb_int_bits_per_ss: List[np.ndarray],
                   bfq: Optional[np.ndarray] = None,
                   n_sts_total: Optional[int] = None) -> List[np.ndarray]:
    """Interleaved SIG-B bits per stream -> [nSS] 80-sample symbols."""
    bw = mod.bw
    nss = n_sts_total or mod.nSS
    grids = []
    for iss in range(nss):
        qam = tables.QAM_TAB[M.BPSK][sigb_int_bits_per_ss[iss]]
        if nss in (4, 7, 8):
            qam = qam * tables.P_SIGB_NSTS478[iss]
        grid = build_grid(qam, tables.PILOT_VHT[bw], bw, False)
        grids.append(apply_csd(grid, bw, nss, iss, False))
    grids = np.stack(grids)
    if bfq is not None:
        grids = np.einsum("kij,jk->ik", bfq, grids)
    return [add_gi(tone_scale(ifft_sym(grids[iss]),
                              tables.SCALE_SIG_VHT_B[bw], nss))
            for iss in range(nss)]


def interleave_sigb(mod: Mod, coded: np.ndarray) -> np.ndarray:
    sigb_mod = Mod(F.VHT, 0, mod.bw, 1)
    return coded[ilv.tx_perm(sigb_mod)]


# ---------------------------------------------------------------------------
# DATA field
# ---------------------------------------------------------------------------


def data_bits(mod: Mod, pp: PpduParams, psdu: bytes, sigb_crc: np.ndarray,
              ) -> np.ndarray:
    """SERVICE + PSDU (+EOF pad) + pad bits (pre-scrambling)."""
    if mod.fmt == F.VHT:
        service = np.concatenate([np.zeros(8, dtype=np.int64),
                                  sigb_crc.astype(np.int64)])
        psdu_bits = np.concatenate([
            bytes_to_bits(psdu),
            np.tile(tables.EOF_PAD_SUBFRAME.astype(np.int64), pp.n_pad_eof),
            np.zeros(8 * pp.n_pad_octet, dtype=np.int64)])
        return np.concatenate([service, psdu_bits,
                               np.zeros(pp.n_pad_bits, dtype=np.int64)])
    service = np.zeros(16, dtype=np.int64)
    return np.concatenate([service, bytes_to_bits(psdu),
                           np.zeros(6 * mod.nES + pp.n_pad_bits, dtype=np.int64)])


def coded_stream_bits(mod: Mod, pp: PpduParams, dbits: np.ndarray,
                      scrambler_seed: int) -> List[np.ndarray]:
    """Scramble -> per-encoder BCC+puncture -> stream parse -> interleave.

    Returns [nSS] arrays of interleaved bits [nSym * nCBPSS].
    """
    scrambled = scramble(dbits, scrambler_seed)
    es_coded = []
    if mod.fmt == F.VHT:
        # VHT: scramble first, then append (unscrambled) zero tails per encoder
        n_in = pp.n_sym * mod.nDBPS // mod.nES - 6
        for ies in range(mod.nES):
            div = scrambled[ies: n_in * mod.nES: mod.nES]
            div = np.concatenate([div, np.zeros(6, dtype=np.int64)])
            es_coded.append(bcc(div, mod.cr))
    else:
        # L/HT: scramble everything, then zero the tail region
        scrambled = scrambled.copy()
        t0 = 16 + pp.psdu_len * 8
        scrambled[t0: t0 + 6 * mod.nES] = 0
        n_in = pp.n_sym * mod.nDBPS // mod.nES
        for ies in range(mod.nES):
            div = scrambled[ies: n_in * mod.nES: mod.nES]
            es_coded.append(bcc(div, mod.cr))
    # stream parse (per symbol) then interleave
    es_arr = np.stack(es_coded).reshape(mod.nES, pp.n_sym, -1)
    es_idx, bit_idx = ilv.stream_parser_maps(mod)
    ss_int = []
    for iss in range(mod.nSS):
        if mod.fmt == F.L:
            stream = es_arr[0]
        else:
            stream = es_arr[es_idx[iss], :, bit_idx[iss]].T  # [nSym, nCBPSS]
        inted = stream[:, ilv.tx_perm(mod, iss)]
        ss_int.append(inted.reshape(-1))
    return ss_int


def data_symbols(mod: Mod, pp: PpduParams, ss_int_bits: List[np.ndarray]
                 ) -> np.ndarray:
    """Interleaved bits -> constellation streams [nSS, nSym, nSD]."""
    out = []
    for iss in range(mod.nSS):
        qam = map_qam(ss_int_bits[iss], mod.mod, mod.nBPSCS)
        out.append(qam.reshape(pp.n_sym, mod.nSD))
    return np.stack(out)


def pilot_sequence(mod: Mod, n_sym: int, iss: int = 0,
                   pidx0: Optional[int] = None) -> np.ndarray:
    """Per-symbol pilot tone values [nSym, nSP] incl. polarity & rotation."""
    if mod.fmt == F.L:
        base = tables.PILOT_L.copy()
        pidx = 1 if pidx0 is None else pidx0
        rotate = False
    elif mod.fmt == F.HT:
        base = tables.PILOT_HT[mod.bw][mod.nSS - 1][iss].copy()
        pidx = 3 if pidx0 is None else pidx0
        rotate = True
    else:
        base = tables.PILOT_VHT[mod.bw].copy()
        pidx = 4 if pidx0 is None else pidx0
        rotate = True
    out = np.empty((n_sym, len(base)))
    for s in range(n_sym):
        out[s] = base * tables.PILOT_POLARITY[(pidx + s) % 127]
        if rotate:
            base = np.roll(base, -1)
    return out


def data_field(mod: Mod, pp: PpduParams, ss_syms: np.ndarray,
               bfq: Optional[np.ndarray] = None,
               n_sts_total: Optional[int] = None,
               pilot_iss_map: Optional[Sequence[int]] = None
               ) -> List[np.ndarray]:
    """Constellations [nSS, nSym, nSD] -> list of per-symbol 80-sample blocks
    per stream (not yet boundary-halved across symbols)."""
    bw = mod.bw
    nss = n_sts_total or mod.nSS
    legacy = mod.fmt == F.L
    if mod.fmt == F.L:
        scale = tables.SCALE_DATA_L[bw]
    elif mod.fmt == F.HT:
        scale = tables.SCALE_DATA_HT[bw]
    else:
        scale = tables.SCALE_DATA_VHT[bw]
    grids = np.empty((nss, pp.n_sym, tables.NFFT[bw]), dtype=np.complex128)
    for iss in range(nss):
        p_iss = pilot_iss_map[iss] if pilot_iss_map is not None else iss
        pilots = pilot_sequence(mod, pp.n_sym, p_iss)
        g = build_grid(ss_syms[iss], pilots, bw, legacy)
        # the reference applies the *non-legacy* CSD table to all DATA
        # symbols (phy80211.py:869-871); identical for nSS==1 (zero shift).
        grids[iss] = apply_csd(g, bw, nss, iss, False)
    if bfq is not None:
        grids = np.einsum("kij,jsk->isk", bfq, grids)
    syms = add_gi(tone_scale(ifft_sym(grids), scale, nss))
    return [list(syms[iss]) for iss in range(nss)]


# ---------------------------------------------------------------------------
# top-level packet generation
# ---------------------------------------------------------------------------

DEFAULT_SCRAMBLER = 93


@dataclasses.dataclass
class TxResult:
    mod: Mod
    pp: PpduParams
    waveform: np.ndarray           # [nSS, nSamp] complex128
    sigb_crc: Optional[np.ndarray] = None


def gen_mpdu(mpdu: bytes, mod: Mod, scrambler: int = DEFAULT_SCRAMBLER
             ) -> TxResult:
    """L / HT single-MPDU packet (reference genFromMpdu, phy80211.py:80)."""
    assert mod.fmt in (F.L, F.HT)
    pp = ppdu_params_nonaggregate(mod, len(mpdu))
    return _gen_su(mpdu, mod, pp, scrambler)


def gen_ampdu(ampdu: bytes, mod: Mod, partial_aid: int = 0, group_id: int = 0,
              scrambler: int = DEFAULT_SCRAMBLER) -> TxResult:
    """HT/VHT aggregate packet incl. VHT NDP (reference genFromAmpdu)."""
    assert mod.fmt in (F.HT, F.VHT)
    pp = ppdu_params_aggregate(mod, len(ampdu))
    return _gen_su(ampdu, mod, pp, scrambler, partial_aid=partial_aid,
                   group_id=group_id)


def _gen_su(psdu: bytes, mod: Mod, pp: PpduParams, scrambler: int,
            partial_aid: int = 0, group_id: int = 0) -> TxResult:
    nss = mod.nSS
    streams: List[List[np.ndarray]] = [[] for _ in range(nss)]
    lt = legacy_training(mod)
    ls = legacy_sig_field(mod, pp)
    for iss in range(nss):
        streams[iss] += [lt[iss], ls[iss]]
    sigb_crc = None
    if mod.fmt == F.HT:
        hs = ht_sig_field(mod, pp)
        nt = nonlegacy_training(mod)
        for iss in range(nss):
            streams[iss] += [hs[iss], nt[iss]]
    elif mod.fmt == F.VHT:
        va = vht_siga_field(mod, pp, group_id, partial_aid)
        nt = nonlegacy_training(mod)
        sb_bits, sigb_crc = vhtsigb_bits(mod, pp)
        coded = bcc(sb_bits, CR.CR12)
        inted = interleave_sigb(mod, coded)
        vb = vht_sigb_field(mod, [inted] * nss)
        for iss in range(nss):
            streams[iss] += [va[iss], nt[iss], vb[iss]]
    if pp.n_sym > 0:
        dbits = data_bits(mod, pp, psdu,
                          sigb_crc if sigb_crc is not None else np.zeros(0))
        ss_int = coded_stream_bits(mod, pp, dbits, scrambler)
        ss_syms = data_symbols(mod, pp, ss_int)
        dsyms = data_field(mod, pp, ss_syms)
        for iss in range(nss):
            streams[iss] += dsyms[iss]
    wave = np.stack([concat_blocks(s) for s in streams])
    return TxResult(mod=mod, pp=pp, waveform=wave, sigb_crc=sigb_crc)

