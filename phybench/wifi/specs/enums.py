"""PHY format / modulation / coding-rate / bandwidth enums.

Capability parity with the reference descriptor enums
(reference tools/phy80211header.py:38-85); re-expressed as IntEnums so
they can be used directly as static jit arguments and table indices.

The benchmark's frozen copy of ieee80211_tpu_torch/specs/enums.py:
the traffic generator builds its packets with it and imports
nothing of the program it measures.
"""
from __future__ import annotations

import enum


class F(enum.IntEnum):
    """PHY packet format."""

    L = 0        # legacy 802.11a/g (non-HT OFDM)
    HT = 1       # 802.11n
    VHT = 2      # 802.11ac


class GRF(enum.IntEnum):
    """Packet-descriptor type codes used by the MAC<->PHY message API.

    Mirrors the wire API of the reference (tools/phy80211header.py:38-44,
    lib/cloud80211phy.h C8P_F_*): SU formats share the F values, MU/BFQ/NDP
    extend them.
    """

    L = 0
    HT = 1
    VHT = 2
    MU = 3
    BFQ = 10
    NDP = 20


class M(enum.IntEnum):
    """Constellation."""

    BPSK = 0
    QBPSK = 1
    QPSK = 2
    QAM16 = 3
    QAM64 = 4
    QAM256 = 5
    QAM1024 = 6


class CR(enum.IntEnum):
    """BCC coding rate."""

    CR12 = 0
    CR23 = 1
    CR34 = 2
    CR56 = 3


class BW(enum.IntEnum):
    """Channel bandwidth."""

    BW20 = 0
    BW40 = 1
    BW80 = 2


#: Number of coded bits per axis kept / punctured per coding rate:
#: (numerator data bits, denominator coded bits) of the rate.
CR_RATIO = {
    CR.CR12: (1, 2),
    CR.CR23: (2, 3),
    CR.CR34: (3, 4),
    CR.CR56: (5, 6),
}
