"""The MAC FCS, CRC-32 (the SIG fields' bit-level CRC-8 is
`tables.crc8_bits`).

Parity: boost::crc FCS usage (lib/decode_impl.cc:372-374).

The benchmark's frozen copy of ieee80211_tpu_torch/specs/crc.py:
the traffic generator builds its packets with it and imports
nothing of the program it measures.
"""
from __future__ import annotations

import zlib


def crc32_bytes(data: bytes) -> int:
    return zlib.crc32(bytes(data)) & 0xFFFFFFFF


def fcs_ok(frame: bytes) -> bool:
    """True if the trailing 4-byte little-endian FCS matches."""
    if len(frame) <= 4:
        return False
    expect = int.from_bytes(frame[-4:], "little")
    return crc32_bytes(frame[:-4]) == expect


def append_fcs(frame: bytes) -> bytes:
    return bytes(frame) + crc32_bytes(frame).to_bytes(4, "little")


_CRC32_TAB = None

