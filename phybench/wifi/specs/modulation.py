"""Modulation/coding descriptor — the static configuration of one PPDU.

Functional parity with the reference descriptor classes
(reference tools/phy80211header.py:137-536 `modulation` and
reference lib/cloud80211phy.h:58-98 `c8p_mod`): given
(format, mcs, bw, nSTS, sgi) it derives constellation, coding rate,
interleaver geometry, symbol counts and padding. All fields are plain
Python ints/enums so a `Mod` instance can serve as a *static* jit argument
(it is hashable and equality-comparable).

The benchmark's frozen copy of ieee80211_tpu_torch/specs/modulation.py:
the traffic generator builds its packets with it and imports
nothing of the program it measures.
"""
from __future__ import annotations

import dataclasses
import math
from functools import cached_property

from .enums import BW, CR, CR_RATIO, F, M

# (constellation, coding rate) per mcs for each format family
_LEGACY_MCS = {
    0: (M.BPSK, CR.CR12),
    1: (M.BPSK, CR.CR34),
    2: (M.QPSK, CR.CR12),
    3: (M.QPSK, CR.CR34),
    4: (M.QAM16, CR.CR12),
    5: (M.QAM16, CR.CR34),
    6: (M.QAM64, CR.CR23),
    7: (M.QAM64, CR.CR34),
}
_HT_MCS = {
    0: (M.BPSK, CR.CR12),
    1: (M.QPSK, CR.CR12),
    2: (M.QPSK, CR.CR34),
    3: (M.QAM16, CR.CR12),
    4: (M.QAM16, CR.CR34),
    5: (M.QAM64, CR.CR23),
    6: (M.QAM64, CR.CR34),
    7: (M.QAM64, CR.CR56),
}
_VHT_MCS = {
    0: (M.BPSK, CR.CR12),
    1: (M.QPSK, CR.CR12),
    2: (M.QPSK, CR.CR34),
    3: (M.QAM16, CR.CR12),
    4: (M.QAM16, CR.CR34),
    5: (M.QAM64, CR.CR23),
    6: (M.QAM64, CR.CR34),
    7: (M.QAM64, CR.CR56),
    8: (M.QAM256, CR.CR34),
    9: (M.QAM256, CR.CR56),
}

_NBPSCS = {M.BPSK: 1, M.QBPSK: 1, M.QPSK: 2, M.QAM16: 4, M.QAM64: 6,
           M.QAM256: 8, M.QAM1024: 10}

# per-bw (nSD, nSP, intlv_col, intlv_row_factor, intlv_rot)
_BW_GEOM = {
    BW.BW20: (52, 4, 13, 4, 11),
    BW.BW40: (108, 6, 18, 6, 29),
    BW.BW80: (234, 8, 26, 9, 58),
}

N_SERVICE = 16
N_TAIL = 6


class ConfigError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class Mod:
    """Static modulation config. Hashable: usable as a jit static arg."""

    fmt: F = F.L
    mcs: int = 0
    bw: BW = BW.BW20
    nSTS: int = 1
    sgi: bool = False

    def __post_init__(self):
        f, mcs, bw, nsts = self.fmt, self.mcs, self.bw, self.nSTS
        if f == F.L:
            if mcs not in _LEGACY_MCS or bw != BW.BW20 or nsts != 1 or self.sgi:
                raise ConfigError(f"invalid legacy config {self}")
        elif f == F.HT:
            if not (0 <= mcs <= 31) or bw == BW.BW80:
                raise ConfigError(f"invalid HT config {self}")
            if mcs // 8 + 1 != nsts or not (1 <= nsts <= 4):
                raise ConfigError(f"HT mcs/nSTS mismatch {self}")
        elif f == F.VHT:
            if mcs not in _VHT_MCS or not (1 <= nsts <= 4):
                raise ConfigError(f"invalid VHT config {self}")
            if bw == BW.BW20 and mcs == 9 and nsts in (1, 2, 4):
                raise ConfigError("VHT 20MHz MCS9 invalid for nSS 1/2/4")
            if bw == BW.BW80 and mcs == 6 and nsts == 3:
                raise ConfigError("VHT 80MHz MCS6 invalid for nSS 3")
        else:
            raise ConfigError(f"unknown format {f}")

    # -- modulation & coding ------------------------------------------------
    @cached_property
    def mod(self) -> M:
        if self.fmt == F.L:
            return _LEGACY_MCS[self.mcs][0]
        if self.fmt == F.HT:
            return _HT_MCS[self.mcs % 8][0]
        return _VHT_MCS[self.mcs][0]

    @cached_property
    def cr(self) -> CR:
        if self.fmt == F.L:
            return _LEGACY_MCS[self.mcs][1]
        if self.fmt == F.HT:
            return _HT_MCS[self.mcs % 8][1]
        return _VHT_MCS[self.mcs][1]

    @property
    def nSS(self) -> int:
        return self.nSTS  # STBC unsupported (as in reference)

    @property
    def nBPSCS(self) -> int:
        return _NBPSCS[self.mod]

    @property
    def nSD(self) -> int:
        return 48 if self.fmt == F.L else _BW_GEOM[self.bw][0]

    @property
    def nSP(self) -> int:
        return 4 if self.fmt == F.L else _BW_GEOM[self.bw][1]

    @property
    def intlv_cols(self) -> int:
        return 16 if self.fmt == F.L else _BW_GEOM[self.bw][2]

    @property
    def intlv_rows(self) -> int:
        if self.fmt == F.L:
            return 3 * self.nBPSCS
        return _BW_GEOM[self.bw][3] * self.nBPSCS

    @property
    def intlv_rot(self) -> int:
        return 0 if self.fmt == F.L else _BW_GEOM[self.bw][4]

    @property
    def nCBPSS(self) -> int:
        return self.nSD * self.nBPSCS

    @property
    def nCBPS(self) -> int:
        return self.nCBPSS * self.nSS

    @property
    def nDBPS(self) -> int:
        num, den = CR_RATIO[self.cr]
        return self.nCBPS * num // den

    @property
    def nES(self) -> int:
        """Number of BCC encoders."""
        if self.fmt == F.L:
            return 1
        drs = self.nDBPS / 3.6  # short-GI data rate in Mbps
        if self.fmt == F.HT:
            return 1 if drs < 300.1 else 2
        if drs < 600.1:
            return 1
        return 2 if drs < 1200.1 else 3

    @property
    def nLTF(self) -> int:
        if self.nSTS <= 1:
            return 1
        return int(math.ceil(self.nSTS / 2)) * 2

    @property
    def spr(self) -> int:
        """Sampling rate in MHz."""
        return {BW.BW20: 20, BW.BW40: 40, BW.BW80: 80}[self.bw]

@dataclasses.dataclass(frozen=True)
class PpduParams:
    """Length-dependent parameters of one PPDU (Mod + payload length).

    Parity: reference `procPktLenNonAggre`/`procPktLenAggre`/
    `procPktLenAggreMu` (tools/phy80211header.py:433-536).
    """

    mod: Mod
    psdu_len: int       # bytes carried in DATA (after VHT padding)
    ampdu_len: int      # pre-padding A-MPDU length (VHT) or 0
    mpdu_len: int       # single-MPDU length (L/HT non-aggregate) or 0
    n_sym: int
    n_pad_eof: int
    n_pad_octet: int
    n_pad_bits: int
    tx_time_us: int
    legacy_len: int
    ampdu: bool
    mu: bool = False

def ppdu_params_nonaggregate(mod: Mod, mpdu_len: int) -> PpduParams:
    """L / HT single-MPDU packet sizing."""
    if mod.fmt == F.VHT:
        raise ConfigError("VHT packets are always aggregates")
    n_sym = math.ceil((mpdu_len * 8 + N_SERVICE + N_TAIL * mod.nES) / mod.nDBPS)
    n_pad_bits = n_sym * mod.nDBPS - 8 * mpdu_len - N_SERVICE - N_TAIL * mod.nES
    if mod.fmt == F.L:
        tx_time = 20 + n_sym * 4
        legacy_len = mpdu_len
    else:
        if mod.sgi:
            tx_time = int(20 + 8 + 4 + mod.nLTF * 4 + math.ceil(n_sym * 3.6 / 4) * 4)
        else:
            tx_time = int(20 + 8 + 4 + mod.nLTF * 4 + n_sym * 4)
        legacy_len = int((tx_time - 20) / 4) * 3 - 3
    return PpduParams(mod=mod, psdu_len=mpdu_len, ampdu_len=0, mpdu_len=mpdu_len,
                      n_sym=n_sym, n_pad_eof=0, n_pad_octet=0,
                      n_pad_bits=n_pad_bits, tx_time_us=tx_time,
                      legacy_len=legacy_len, ampdu=False)


def ppdu_params_aggregate(mod: Mod, ampdu_len: int) -> PpduParams:
    """HT A-MPDU / VHT A-MPDU (incl. NDP when ampdu_len == 0) sizing."""
    if mod.fmt == F.HT:
        n_sym = math.ceil((ampdu_len * 8 + N_SERVICE + N_TAIL * mod.nES) / mod.nDBPS)
        n_pad_bits = n_sym * mod.nDBPS - 8 * ampdu_len - N_SERVICE - N_TAIL * mod.nES
        if mod.sgi:
            tx_time = int(20 + 8 + 4 + mod.nLTF * 4 + math.ceil(n_sym * 3.6 / 4) * 4)
        else:
            tx_time = int(20 + 8 + 4 + mod.nLTF * 4 + n_sym * 4)
        legacy_len = int((tx_time - 20) / 4) * 3 - 3
        return PpduParams(mod=mod, psdu_len=ampdu_len, ampdu_len=ampdu_len,
                          mpdu_len=0, n_sym=n_sym, n_pad_eof=0, n_pad_octet=0,
                          n_pad_bits=n_pad_bits, tx_time_us=tx_time,
                          legacy_len=legacy_len, ampdu=True)
    if mod.fmt != F.VHT:
        raise ConfigError("aggregate sizing applies to HT/VHT")
    if ampdu_len > 0:
        n_sym = math.ceil((8 * ampdu_len + N_SERVICE + N_TAIL * mod.nES) / mod.nDBPS)
        psdu_len = (n_sym * mod.nDBPS - N_SERVICE - N_TAIL * mod.nES) // 8
        n_pad_eof = (psdu_len - ampdu_len) // 4
        n_pad_octet = psdu_len - ampdu_len - n_pad_eof * 4
        n_pad_bits = n_sym * mod.nDBPS - 8 * psdu_len - N_SERVICE - N_TAIL * mod.nES
        if mod.sgi:
            tx_time = int(20 + 8 + 4 + mod.nLTF * 4 + 4 + math.ceil(n_sym * 3.6 / 4) * 4)
        else:
            tx_time = int(20 + 8 + 4 + mod.nLTF * 4 + 4 + n_sym * 4)
        legacy_len = int((tx_time - 20) / 4) * 3 - 3
        return PpduParams(mod=mod, psdu_len=psdu_len, ampdu_len=ampdu_len,
                          mpdu_len=0, n_sym=n_sym, n_pad_eof=n_pad_eof,
                          n_pad_octet=n_pad_octet, n_pad_bits=n_pad_bits,
                          tx_time_us=tx_time, legacy_len=legacy_len, ampdu=True)
    # VHT NDP
    tx_time = int(20 + 8 + 4 + mod.nLTF * 4 + 4)
    legacy_len = int((tx_time - 20) / 4) * 3 - 3
    return PpduParams(mod=mod, psdu_len=0, ampdu_len=0, mpdu_len=0, n_sym=0,
                      n_pad_eof=0, n_pad_octet=0, n_pad_bits=0,
                      tx_time_us=tx_time, legacy_len=legacy_len, ampdu=True)

