"""The trellis work that decoding needs, from the problem's shape alone,
whatever kernel does it.

A BCC decode of n information bits is n trellis steps over 64 states. Per
state and step the add-compare-select needs 4 float32 lane operations: two
additions (each predecessor's metric plus its branch metric), one
comparison, one selection. Per step it reads the two coded LLRs (float32,
punctured slots depunctured to zero) and writes one decoded bit (1/8 of a
byte).

DATA steps per packet: its true symbols times nDBPS (padding rows and a
decoder's spare symbols are not work). SIG steps per trigger: L-SIG (24),
and HT-SIG and VHT-SIG-A (48 each) where both are tried.
"""
from __future__ import annotations

from phybench.wifi.specs import BW, F, Mod

STATES = 64
OPS_PER_STATE_STEP = 4
BYTES_PER_STEP = 2 * 4 + 1 / 8
SIG_BITS = {"lsig": 24, "htsig": 48, "vhtsiga": 48}


def n_sym(fmt: str, mcs: int, nss: int, psdu_len: int) -> int:
    """DATA symbols of a PSDU of psdu_len octets (a VHT PSDU's length as
    the receiver reads it back: whole symbols less SERVICE and tail)."""
    mod = Mod(F[fmt], mcs, BW.BW20, nss)
    return -(-(8 * psdu_len + 16 + 6 * mod.nES) // mod.nDBPS)


def data_steps(fmt: str, mcs: int, nss: int, psdu_len: int) -> int:
    mod = Mod(F[fmt], mcs, BW.BW20, nss)
    return n_sym(fmt, mcs, nss, psdu_len) * mod.nDBPS


def sig_steps(triggers: int, fields=("lsig", "htsig", "vhtsiga")) -> int:
    return triggers * sum(SIG_BITS[f] for f in fields)


def ops(steps: float) -> float:
    return steps * STATES * OPS_PER_STATE_STEP


def bytes_moved(steps: float) -> float:
    return steps * BYTES_PER_STEP
