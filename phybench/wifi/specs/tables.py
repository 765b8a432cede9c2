"""IEEE 802.11a/g/n/ac PHY constant tables.

Every table here is either an IEEE 802.11-2016/2020 standard constant
(training sequences, pilot polarity, rate bits) or is *generated* from the
standard's closed-form definitions (QAM constellations from per-axis Gray
maps, convolutional trellis from the K=7 g0=133/g1=171 polynomials,
subcarrier index maps from the occupied/pilot tone sets).

Capability parity with the reference's table inventory
(reference lib/cloud80211phy.cc:27-474 and
reference tools/phy80211header.py:538-772); values are validated
against the reference in tests/test_specs_vs_reference.py.

Layout conventions used throughout this framework:
  * Frequency-domain symbols are stored in *shifted* order: index i of an
    N-bin grid is subcarrier k = i - N//2 ("DC" at N//2).
  * Data-subcarrier vectors are ordered by increasing subcarrier index.
  * Bit vectors are LSB-first within a byte (matching the air interface).

The benchmark's frozen copy of ieee80211_tpu_torch/specs/tables.py:
the traffic generator builds its packets with it and imports
nothing of the program it measures.
"""
from __future__ import annotations

import numpy as np

from .enums import BW, CR, M

# ---------------------------------------------------------------------------
# FFT geometry
# ---------------------------------------------------------------------------

NFFT = {BW.BW20: 64, BW.BW40: 128, BW.BW80: 256}
NGI = {BW.BW20: 16, BW.BW40: 32, BW.BW80: 64}  # 0.8 us guard interval
NSYM_SAMP = {BW.BW20: 80, BW.BW40: 160, BW.BW80: 320}

# ---------------------------------------------------------------------------
# Occupied / pilot subcarrier sets
# ---------------------------------------------------------------------------


def _occupied(bw: BW, legacy: bool) -> np.ndarray:
    """Occupied (data+pilot) subcarrier indices, ascending, DC excluded."""
    if bw == BW.BW20:
        lim = 26 if legacy else 28
        k = [i for i in range(-lim, lim + 1) if i != 0]
    elif bw == BW.BW40:
        k = [i for i in range(-58, 59) if i not in (-1, 0, 1)]
    else:
        k = [i for i in range(-122, 123) if i not in (-1, 0, 1)]
    return np.asarray(k, dtype=np.int32)


PILOT_SC = {
    (BW.BW20, True): np.array([-21, -7, 7, 21], dtype=np.int32),
    (BW.BW20, False): np.array([-21, -7, 7, 21], dtype=np.int32),
    (BW.BW40, False): np.array([-53, -25, -11, 11, 25, 53], dtype=np.int32),
    (BW.BW80, False): np.array([-103, -75, -39, -11, 11, 39, 75, 103], dtype=np.int32),
}


def data_sc(bw: BW, legacy: bool) -> np.ndarray:
    """Data subcarrier indices (ascending), excluding pilots and DC."""
    occ = _occupied(bw, legacy)
    pil = PILOT_SC[(bw, legacy if bw == BW.BW20 else False)]
    return np.asarray([k for k in occ if k not in pil], dtype=np.int32)


def grid_index(k: np.ndarray, bw: BW) -> np.ndarray:
    """Subcarrier index -> shifted-grid index."""
    return (np.asarray(k) + NFFT[bw] // 2).astype(np.int32)


# Shifted-grid indices of data / pilot tones.
DATA_GRID = {
    (bw, legacy): grid_index(data_sc(bw, legacy), bw)
    for bw in BW
    for legacy in ((True, False) if bw == BW.BW20 else (False,))
}
PILOT_GRID = {
    (bw, legacy): grid_index(PILOT_SC[(bw, legacy if bw == BW.BW20 else False)], bw)
    for bw in BW
    for legacy in ((True, False) if bw == BW.BW20 else (False,))
}
OCC_GRID = {
    (bw, legacy): grid_index(_occupied(bw, legacy), bw)
    for bw in BW
    for legacy in ((True, False) if bw == BW.BW20 else (False,))
}

# ---------------------------------------------------------------------------
# QAM constellations (generated from the per-axis Gray map)
# ---------------------------------------------------------------------------


def _gray_axis(nbits: int) -> np.ndarray:
    """Per-axis amplitude for an axis bit-group read MSB-first.

    802.11 maps the axis bit pattern (Gray code) to odd amplitudes
    -(2^n-1) ... +(2^n-1): value = 2*graydecode(bits) - (2^n - 1).
    """
    n = 1 << nbits
    out = np.empty(n, dtype=np.float64)
    for g in range(n):
        b = g
        mask = g >> 1
        while mask:
            b ^= mask
            mask >>= 1
        out[g] = 2.0 * b - (n - 1)
    return out


def _gen_qam(nbpscs: int) -> np.ndarray:
    """Constellation table indexed by chip value with LSB-first bit order.

    chip = sum_j bit_j << j ; first nbpscs/2 bits -> I axis (MSB-first
    within the group), remaining -> Q axis. BPSK handled separately.
    """
    if nbpscs == 1:
        return np.array([-1.0 + 0j, 1.0 + 0j])
    half = nbpscs // 2
    axis = _gray_axis(half)
    norm = {2: 2.0, 4: 10.0, 6: 42.0, 8: 170.0, 10: 682.0}[nbpscs]
    tab = np.empty(1 << nbpscs, dtype=np.complex128)
    for chip in range(1 << nbpscs):
        bits = [(chip >> j) & 1 for j in range(nbpscs)]
        iu = 0
        for b in bits[:half]:
            iu = (iu << 1) | b
        qu = 0
        for b in bits[half:]:
            qu = (qu << 1) | b
        tab[chip] = (axis[iu] + 1j * axis[qu]) / np.sqrt(norm)
    return tab


QAM_TAB = {
    M.BPSK: _gen_qam(1),
    M.QBPSK: 1j * _gen_qam(1),
    M.QPSK: _gen_qam(2),
    M.QAM16: _gen_qam(4),
    M.QAM64: _gen_qam(6),
    M.QAM256: _gen_qam(8),
    M.QAM1024: _gen_qam(10),
}

#: Kmod scale of each constellation (amplitude de-normalization for LLRs).
KMOD = {
    M.BPSK: 1.0,
    M.QBPSK: 1.0,
    M.QPSK: np.sqrt(2.0),
    M.QAM16: np.sqrt(10.0),
    M.QAM64: np.sqrt(42.0),
    M.QAM256: np.sqrt(170.0),
    M.QAM1024: np.sqrt(682.0),
}

# ---------------------------------------------------------------------------
# L-SIG RATE bits (IEEE 802.11-2016 table 17-6), LSB-first on air
# ---------------------------------------------------------------------------

LEGACY_RATE_BITS = np.array(
    [
        [1, 1, 0, 1],  # 6 Mbps
        [1, 1, 1, 1],  # 9
        [0, 1, 0, 1],  # 12
        [0, 1, 1, 1],  # 18
        [1, 0, 0, 1],  # 24
        [1, 0, 1, 1],  # 36
        [0, 0, 0, 1],  # 48
        [0, 0, 1, 1],  # 54
    ],
    dtype=np.int32,
)

# ---------------------------------------------------------------------------
# Training sequences (standard constants, stored over occupied tones and on
# the shifted FFT grid)
# ---------------------------------------------------------------------------

_STF_QUARTER = np.array(
    [0, 0, 1 + 1j, 0, 0, 0, -1 - 1j, 0, 0, 0, 1 + 1j, 0, 0, 0, -1 - 1j, 0, 0, 0,
     -1 - 1j, 0, 0, 0, 1 + 1j, 0, 0, 0, 0, 0, 0, 0, -1 - 1j, 0, 0, 0, -1 - 1j,
     0, 0, 0, 1 + 1j, 0, 0, 0, 1 + 1j, 0, 0, 0, 1 + 1j, 0, 0, 0, 1 + 1j, 0, 0],
    dtype=np.complex128,
) * np.sqrt(0.5)
# _STF_QUARTER covers subcarriers -26..26 (53 tones).

_LTF_LEFT = np.array(
    [1, 1, -1, -1, 1, 1, -1, 1, -1, 1, 1, 1, 1, 1, 1, -1, -1, 1, 1, -1, 1, -1,
     1, 1, 1, 1], dtype=np.float64)
_LTF_RIGHT = np.array(
    [1, -1, -1, 1, 1, -1, 1, -1, 1, -1, -1, -1, -1, -1, 1, 1, -1, -1, 1, -1, 1,
     -1, 1, 1, 1, 1], dtype=np.float64)

# Legacy STF/LTF over occupied tones (-26..26 incl DC)
STF_L = {
    BW.BW20: _STF_QUARTER,
    BW.BW40: np.concatenate([_STF_QUARTER, np.zeros(11), _STF_QUARTER]),
}
STF_L[BW.BW80] = np.concatenate([STF_L[BW.BW40], np.zeros(11), STF_L[BW.BW40]])

LTF_L = {
    BW.BW20: np.concatenate([_LTF_LEFT, [0.0], _LTF_RIGHT]),
}
LTF_L[BW.BW40] = np.concatenate([LTF_L[BW.BW20], np.zeros(11), LTF_L[BW.BW20]])
LTF_L[BW.BW80] = np.concatenate([LTF_L[BW.BW40], np.zeros(11), LTF_L[BW.BW40]])

# HT/VHT STF over the non-legacy occupied span
STF_HT = {
    BW.BW20: np.concatenate([[0, 0], _STF_QUARTER, [0, 0]]),
    BW.BW40: np.concatenate([_STF_QUARTER, np.zeros(11), _STF_QUARTER]),
}
STF_VHT = {
    BW.BW20: STF_HT[BW.BW20],
    BW.BW40: STF_HT[BW.BW40],
    BW.BW80: np.concatenate([STF_HT[BW.BW40], np.zeros(11), STF_HT[BW.BW40]]),
}

# HT/VHT LTF (IEEE 802.11-2016 19.3.9.4.6 / 21.3.8.3.5)
LTF_HT = {
    BW.BW20: np.concatenate([[1, 1], _LTF_LEFT, [0], _LTF_RIGHT, [-1, -1]]),
    BW.BW40: np.concatenate(
        [_LTF_LEFT, [1], _LTF_RIGHT, [-1, -1, -1, 1, 0, 0, 0, -1, 1, 1, -1],
         _LTF_LEFT, [1], _LTF_RIGHT]),
}
LTF_VHT = {
    BW.BW20: LTF_HT[BW.BW20],
    BW.BW40: LTF_HT[BW.BW40],
    BW.BW80: np.concatenate(
        [_LTF_LEFT, [1], _LTF_RIGHT, [-1, -1, -1, 1, 1, -1, 1, -1, 1, 1, -1],
         _LTF_LEFT, [1], _LTF_RIGHT, [1, -1, 1, -1, 0, 0, 0, 1, -1, -1, 1],
         _LTF_LEFT, [1], _LTF_RIGHT, [-1, -1, -1, 1, 1, -1, 1, -1, 1, 1, -1],
         _LTF_LEFT, [1], _LTF_RIGHT]),
}

#: Number of non-legacy LTF symbols for a given number of space-time streams.
N_LTF = [0, 1, 2, 4, 4]

#: P matrix applied across LTF symbols / space-time streams
#: (IEEE 802.11-2016 eq. 19-27; first 4x4 block).
P_LTF_4 = np.array(
    [[1, -1, 1, 1],
     [1, 1, -1, 1],
     [1, 1, 1, -1],
     [-1, 1, 1, 1]], dtype=np.float64)
#: R row applied on VHT-LTF *pilot* tones (first row of P).
R_LTF_VHT = P_LTF_4[0]

#: VHT SIG-B per-stream constellation polarity for nSTS 4/7/8.
P_SIGB_NSTS478 = np.array([1, 1, 1, -1, 1, 1, 1, -1], dtype=np.float64)

# ---------------------------------------------------------------------------
# Pilots
# ---------------------------------------------------------------------------

PILOT_L = np.array([1, 1, 1, -1], dtype=np.float64)

# HT per-(bw, nSTS, iSTS) pilot patterns (IEEE 802.11-2016 table 19-20)
PILOT_HT = {
    BW.BW20: [
        np.array([[1, 1, 1, -1]], dtype=np.float64),
        np.array([[1, 1, -1, -1], [1, -1, -1, 1]], dtype=np.float64),
        np.array([[1, 1, -1, -1], [1, -1, 1, -1], [-1, 1, 1, -1]], dtype=np.float64),
        np.array([[1, 1, 1, -1], [1, 1, -1, 1], [1, -1, 1, 1], [-1, 1, 1, 1]],
                 dtype=np.float64),
    ],
    BW.BW40: [
        np.array([[1, 1, 1, -1, -1, 1]], dtype=np.float64),
        np.array([[1, 1, -1, -1, -1, -1], [1, 1, 1, -1, 1, 1]], dtype=np.float64),
        np.array([[1, 1, -1, -1, -1, -1], [1, 1, 1, -1, 1, 1],
                  [1, -1, 1, -1, -1, 1]], dtype=np.float64),
        np.array([[1, 1, -1, -1, -1, -1], [1, 1, 1, -1, 1, 1],
                  [1, -1, 1, -1, -1, 1], [-1, 1, 1, 1, -1, 1]], dtype=np.float64),
    ],
}

PILOT_VHT = {
    BW.BW20: np.array([1, 1, 1, -1], dtype=np.float64),
    BW.BW40: np.array([1, 1, 1, -1, -1, 1], dtype=np.float64),
    BW.BW80: np.array([1, 1, 1, -1, -1, 1, 1, 1], dtype=np.float64),
}

#: Pilot polarity sequence p_n (IEEE 802.11-2016 eq. 17-25), period 127.
PILOT_POLARITY = np.array(
    [1, 1, 1, 1, -1, -1, -1, 1, -1, -1, -1, -1, 1, 1, -1, 1, -1, -1, 1, 1, -1,
     1, 1, -1, 1, 1, 1, 1, 1, 1, -1, 1, 1, 1, -1, 1, 1, -1, -1, 1, 1, 1, -1, 1,
     -1, -1, -1, 1, -1, 1, -1, -1, 1, -1, -1, 1, 1, 1, 1, 1, -1, -1, 1, 1, -1,
     -1, 1, -1, 1, -1, 1, 1, -1, -1, -1, 1, 1, -1, -1, -1, -1, 1, -1, -1, 1,
     -1, 1, 1, 1, 1, -1, 1, -1, 1, -1, 1, -1, -1, -1, -1, -1, 1, -1, 1, 1, -1,
     1, -1, 1, 1, 1, -1, -1, 1, -1, -1, -1, 1, 1, 1, -1, -1, -1, -1, -1, -1,
     -1], dtype=np.float64)

# ---------------------------------------------------------------------------
# Cyclic shift diversity (ns per iSTS; IEEE 802.11-2016 tables 19-9 / 21-10)
# ---------------------------------------------------------------------------

CSD_LEGACY_NS = np.array(
    [[0, 0, 0, 0],
     [0, -200, 0, 0],
     [0, -100, -200, 0],
     [0, -50, -100, -150]], dtype=np.float64)

CSD_NONLEGACY_NS = np.array(
    [[0, 0, 0, 0],
     [0, -400, 0, 0],
     [0, -400, -200, 0],
     [0, -400, -200, -600]], dtype=np.float64)

# ---------------------------------------------------------------------------
# Tone rotation for 40/80 MHz (IEEE 802.11-2016 21.3.7.5)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Scale factors: N_tone of each field (802.11-2016 table 21-8 analog)
# ---------------------------------------------------------------------------

SCALE_STF_L = {BW.BW20: 12, BW.BW40: 24, BW.BW80: 48}
SCALE_LTF_L = {BW.BW20: 52, BW.BW40: 104, BW.BW80: 208}
SCALE_SIG_L = {BW.BW20: 52, BW.BW40: 104, BW.BW80: 208}
SCALE_SIG_HT = {BW.BW20: 52, BW.BW40: 104}
SCALE_STF_HT = {BW.BW20: 12, BW.BW40: 24}
SCALE_LTF_HT = {BW.BW20: 56, BW.BW40: 114}
SCALE_DATA_HT = {BW.BW20: 56, BW.BW40: 114}
SCALE_SIG_VHT_A = {BW.BW20: 52, BW.BW40: 104, BW.BW80: 208}
SCALE_STF_VHT = {BW.BW20: 12, BW.BW40: 24, BW.BW80: 48}
SCALE_LTF_VHT = {BW.BW20: 56, BW.BW40: 114, BW.BW80: 242}
SCALE_SIG_VHT_B = {BW.BW20: 56, BW.BW40: 114, BW.BW80: 242}
SCALE_DATA_VHT = {BW.BW20: 56, BW.BW40: 114, BW.BW80: 242}
SCALE_DATA_L = {BW.BW20: 52, BW.BW40: 104, BW.BW80: 208}

# ---------------------------------------------------------------------------
# NDP VHT SIG-B fixed bit patterns (IEEE 802.11-2016 21.3.8.3.6)
# ---------------------------------------------------------------------------

NDP_SIG_B = {
    BW.BW20: np.array([0, 0, 0, 0, 0, 1, 1, 1, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0],
                      dtype=np.int32),
    BW.BW40: np.array([1, 0, 1, 0, 0, 1, 0, 1, 1, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0, 1, 1],
                      dtype=np.int32),
    BW.BW80: np.array([0, 1, 0, 1, 0, 0, 1, 1, 0, 0, 1, 0, 1, 1, 1, 1, 1, 1, 1, 0, 0,
                       1, 0, 0], dtype=np.int32)[:23],
}

# ---------------------------------------------------------------------------
# Convolutional code: K=7, g0=0133, g1=0171 (IEEE 802.11-2016 17.3.5.6)
# ---------------------------------------------------------------------------

G0 = 0o155  # generator masks applied to the 7-bit shift register
G1 = 0o117  # (newest bit in LSB position after `state = state<<1 | bit`)


def _parity(x: int) -> int:
    return bin(x).count("1") & 1


def _gen_trellis():
    """Viterbi trellis tables from the generator polynomials.

    State s (6 bits) holds the last 6 input bits, newest in bit 5
    (s_next = (s >> 1) | (bit << 5)). Returns:
      next_state[s][b], out2[s][b] (two coded bits as 0..3, out0 in bit 1),
      prev_state[s'][d], prev_out[s'][d], prev_bit[s'] for the RX ACS form.
    """
    next_state = np.zeros((64, 2), dtype=np.int32)
    out2 = np.zeros((64, 2), dtype=np.int32)
    for s in range(64):
        for b in range(2):
            # reconstruct the encoder register: the encoder in the reference
            # keeps `state = (state<<1)|bit` with the 6-bit history in the
            # upper bits. Our trellis state s has the *oldest* bit in bit 0.
            # Encoder register value: bits b, s5..s0 => (s << 1 | b) read in
            # reversed order. Build the 7-bit register explicitly:
            reg = 0
            hist = [(s >> k) & 1 for k in range(6)]  # hist[0] oldest
            seq = hist + [b]  # oldest ... newest
            for bit in seq:
                reg = ((reg << 1) & 0x7E) | bit
            o0 = _parity(reg & G0)
            o1 = _parity(reg & G1)
            next_state[s, b] = (s >> 1) | (b << 5)
            out2[s, b] = (o0 << 1) | o1
    prev_state = np.zeros((64, 2), dtype=np.int32)
    prev_out = np.zeros((64, 2), dtype=np.int32)
    for sp in range(64):
        b = sp >> 5
        base = (sp & 31) << 1
        for d in range(2):
            p = base + d
            prev_state[sp, d] = p
            prev_out[sp, d] = out2[p, b]
    return next_state, out2, prev_state, prev_out


SV_STATE_NEXT, SV_STATE_OUTPUT2, SV_PREV_STATE, SV_PREV_OUTPUT2 = _gen_trellis()

#: Puncture keep-patterns over one period of 2*k coded bits.
PUNCTURE = {
    CR.CR12: np.array([1, 1], dtype=np.int32),
    CR.CR23: np.array([1, 1, 1, 0], dtype=np.int32),
    CR.CR34: np.array([1, 1, 1, 0, 0, 1], dtype=np.int32),
    CR.CR56: np.array([1, 1, 1, 0, 0, 1, 1, 0, 0, 1], dtype=np.int32),
}

# ---------------------------------------------------------------------------
# Scrambler PRBS x^7 + x^4 + 1 (17.3.5.5): 127-periodic sequence per seed
# ---------------------------------------------------------------------------


def _gen_scramble_tab() -> np.ndarray:
    tab = np.zeros((128, 127), dtype=np.int8)
    for seed in range(1, 128):
        s = seed
        for i in range(127):
            fb = ((s >> 6) & 1) ^ ((s >> 3) & 1)
            tab[seed, i] = fb
            s = ((s << 1) & 0x7E) | fb
    return tab


SCRAMBLE_SEQ = _gen_scramble_tab()

# ---------------------------------------------------------------------------
# VHT A-MPDU EOF padding delimiter (9.3.2.22 null delimiter w/ signature 0x4E)
# ---------------------------------------------------------------------------


def _crc8_bits(bits) -> list:
    """CRC-8 (x^8+x^2+x+1, init all-ones, inverted output), MSB-first out."""
    c = [1] * 8
    for b in bits:
        nxt = [0] * 8
        nxt[0] = b ^ c[7]
        nxt[1] = b ^ c[7] ^ c[0]
        nxt[2] = b ^ c[7] ^ c[1]
        nxt[3] = c[2]
        nxt[4] = c[3]
        nxt[5] = c[4]
        nxt[6] = c[5]
        nxt[7] = c[6]
        c = nxt
    return [1 - b for b in c[::-1]]


def _gen_eof_pad() -> np.ndarray:
    head = [1] + [0] * 15  # EOF=1, reserved+len zero
    sig = [(0x4E >> i) & 1 for i in range(8)]
    return np.asarray(head + _crc8_bits(head) + sig, dtype=np.int8)


EOF_PAD_SUBFRAME = _gen_eof_pad()  # 32 bits

crc8_bits = _crc8_bits  # re-export for SIG field generation
