"""CRC helpers: SIG-field / delimiter CRC-8 and MAC FCS CRC-32.

Parity: reference genBitBitCrc8 (tools/phy80211header.py:87-100) and
boost::crc FCS usage (lib/decode_impl.cc:372-374).

Copy of ieee80211_tpu/specs/crc.py: the port imports nothing of the JAX
package, so it carries its own copy; tests/test_torch_specs.py holds it
equal to the original.
"""
from __future__ import annotations

import zlib

import numpy as np

from .tables import crc8_bits  # bit-level CRC-8 (LSB-first input bits)


def crc8_check(bits, crc_bits) -> bool:
    return list(crc8_bits(list(bits))) == list(crc_bits)


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


def crc32_table() -> np.ndarray:
    """Byte-wise CRC-32 table for vectorized/streaming implementations."""
    global _CRC32_TAB
    if _CRC32_TAB is None:
        tab = np.empty(256, dtype=np.uint32)
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ (0xEDB88320 if (c & 1) else 0)
            tab[i] = c
        _CRC32_TAB = tab
    return _CRC32_TAB
