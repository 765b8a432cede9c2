"""MAC-layer packet construction: UDP/IPv4/LLC encapsulation and 802.11
data/control/management frames with FCS.

Capability parity with the reference MAC toolbox
(reference tools/mac80211.py:65-366): same wire formats, so MPDUs are
byte-identical for identical inputs (validated in tests/test_mac.py).

The benchmark's frozen copy of ieee80211_tpu_torch/mac/frames.py:
the traffic generator builds its packets with it and imports
nothing of the program it measures.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Sequence

from ..specs.crc import append_fcs, fcs_ok
from ..specs.tables import crc8_bits

IPPROTO_UDP = 17


def _ip_to_bytes(ip: str) -> bytes:
    return bytes(int(p) for p in ip.split("."))


def _mac_to_bytes(addr: str) -> bytes:
    return bytes(int(p, 16) for p in addr.split(":"))


def _ones_complement_sum(value: int) -> int:
    while value > 0xFFFF:
        value = (value & 0xFFFF) + (value >> 16)
    return 0xFFFF - value


def build_udp(payload: bytes, src_ip: str, dst_ip: str, src_port: int,
              dst_port: int) -> bytes:
    """UDP datagram with the IPv4 pseudo-header checksum."""
    length = len(payload) + 8
    csum = 0
    sip, dip = _ip_to_bytes(src_ip), _ip_to_bytes(dst_ip)
    for b in (sip, dip):
        csum += (b[0] << 8 | b[1]) + (b[2] << 8 | b[3])
    csum += IPPROTO_UDP + length + src_port + dst_port + length
    for i in range(len(payload) // 2):
        csum += (payload[2 * i] << 8) | payload[2 * i + 1]
    if len(payload) % 2:
        csum += payload[-1] << 8
    csum = _ones_complement_sum(csum)
    return struct.pack(">HHHH", src_port, dst_port, length, csum) + payload


def build_ipv4(payload: bytes, ident: int, ttl: int, src_ip: str,
               dst_ip: str) -> bytes:
    """IPv4 header (no options, DF set) + payload."""
    ver_ihl = (4 << 12) | (5 << 8)   # version 4, IHL 5, DSCP/ECN 0
    length = 20 + len(payload)
    flags_frag = 0b010 << 13
    ttl_proto = (ttl << 8) | IPPROTO_UDP
    csum = (ver_ihl + length + ident + flags_frag + ttl_proto)
    sip, dip = _ip_to_bytes(src_ip), _ip_to_bytes(dst_ip)
    for b in (sip, dip):
        csum += (b[0] << 8 | b[1]) + (b[2] << 8 | b[3])
    csum = _ones_complement_sum(csum)
    return (struct.pack(">HHHHHH", ver_ihl, length, ident, flags_frag,
                        ttl_proto, csum) + sip + dip + payload)


def build_llc(payload: bytes, ethertype: int = 0x0800) -> bytes:
    """LLC/SNAP header (AA AA 03 00 00 00 + ethertype)."""
    return b"\xaa\xaa\x03\x00\x00\x00" + struct.pack(">H", ethertype) + payload


@dataclass
class MacConfig:
    ftype: int = 2          # data
    subtype: int = 0        # 0 = Data, 8 = QoS Data
    to_ds: int = 1
    from_ds: int = 0
    retry: int = 0
    protected: int = 0
    addr1: str = "ff:ff:ff:ff:ff:ff"
    addr2: str = "ff:ff:ff:ff:ff:ff"
    addr3: str = "ff:ff:ff:ff:ff:ff"
    seq: int = 0
    duration: int = 110
    qos: int = 0


def build_data_frame(payload: bytes, cfg: MacConfig) -> bytes:
    """802.11 (QoS-)Data MPDU with FCS.

    Note: matches the reference exactly, including its quirk of writing
    addr1 into the third address slot (tools/mac80211.py:224-226).
    """
    fc = (cfg.ftype << 2) | (cfg.subtype << 4) | (cfg.to_ds << 8) | \
         (cfg.from_ds << 9) | (cfg.retry << 11) | (cfg.protected << 14)
    sc = cfg.seq << 4
    hdr = struct.pack("<HH", fc, cfg.duration)
    hdr += _mac_to_bytes(cfg.addr1) + _mac_to_bytes(cfg.addr2)
    hdr += _mac_to_bytes(cfg.addr1)
    hdr += struct.pack("<H", sc)
    if cfg.subtype == 8:
        hdr += struct.pack("<H", cfg.qos)
    return append_fcs(hdr + payload)


def build_udp_mpdu(udp_payload: bytes, cfg: MacConfig,
                   src_ip: str = "10.10.0.6", dst_ip: str = "10.10.0.1",
                   src_port: int = 39379, dst_port: int = 8889,
                   ident: int = 43778, ttl: int = 64) -> bytes:
    """Full UDP-over-IPv4-over-LLC-over-802.11 data MPDU."""
    pkt = build_udp(udp_payload, src_ip, dst_ip, src_port, dst_port)
    pkt = build_ipv4(pkt, ident, ttl, src_ip, dst_ip)
    pkt = build_llc(pkt)
    return build_data_frame(pkt, cfg)


# ---------------------------------------------------------------------------
# A-MPDU aggregation (9.7): delimiter = eof/len/crc8/signature 0x4E
# ---------------------------------------------------------------------------


def _delimiter(len_bits: List[int], eof: int = 0, rsvd: int = 0,
               ht: bool = False) -> bytes:
    if ht:
        bits = [0, 0, 0, 0] + len_bits          # 4 reserved + 12-bit len
    else:
        bits = [eof, rsvd] + len_bits[12:14] + len_bits[0:12]
    bits = bits + crc8_bits(bits)
    bits += [(0x4E >> i) & 1 for i in range(8)]
    out = bytearray()
    for i in range(4):
        byte = 0
        for j in range(8):
            byte |= bits[i * 8 + j] << j
        out.append(byte)
    return bytes(out)


def aggregate_vht(mpdus: Sequence[bytes]) -> bytes:
    """VHT A-MPDU: 14-bit length delimiters, every subframe padded."""
    out = b""
    eof = 1 if len(mpdus) == 1 else 0
    for mpdu in mpdus:
        n = len(mpdu)
        len_bits = [(n >> k) & 1 for k in range(14)]
        sub = _delimiter(len_bits, eof=eof) + mpdu
        sub += b"\x00" * (-len(sub) % 4)
        out += sub
    return out


# ---------------------------------------------------------------------------
# RX side parsing
# ---------------------------------------------------------------------------


@dataclass
class AmpduSubframe:
    mpdu: bytes
    fcs_ok: bool


def deaggregate_vht(psdu: bytes, max_subframes: int = 64) -> List[AmpduSubframe]:
    """Walk VHT A-MPDU delimiters (parity: lib/decode_impl.cc:329-427)."""
    out: List[AmpduSubframe] = []
    i = 0
    while i + 4 <= len(psdu) and len(out) < max_subframes:
        d = psdu[i:i + 4]
        bits = [(d[k // 8] >> (k % 8)) & 1 for k in range(32)]
        if bits[24:32] != [(0x4E >> k) & 1 for k in range(8)]:
            break
        if crc8_bits(bits[0:16]) != bits[16:24]:
            break
        mlen = 0
        for k in range(12):
            mlen |= bits[4 + k] << k
        mlen |= (bits[2] << 12) | (bits[3] << 13)
        if mlen == 0:       # EOF padding delimiter
            i += 4
            continue
        mpdu = psdu[i + 4: i + 4 + mlen]
        if len(mpdu) < mlen:
            break
        out.append(AmpduSubframe(mpdu=mpdu, fcs_ok=fcs_ok(mpdu)))
        i += 4 + mlen
        i += -i % 4
    return out


def deaggregate_ht(psdu: bytes, max_subframes: int = 64) -> List[AmpduSubframe]:
    out: List[AmpduSubframe] = []
    i = 0
    while i + 4 <= len(psdu) and len(out) < max_subframes:
        d = psdu[i:i + 4]
        bits = [(d[k // 8] >> (k % 8)) & 1 for k in range(32)]
        if bits[24:32] != [(0x4E >> k) & 1 for k in range(8)]:
            break
        if crc8_bits(bits[0:16]) != bits[16:24]:
            break
        mlen = 0
        for k in range(12):
            mlen |= bits[4 + k] << k
        if mlen == 0:
            i += 4
            continue
        mpdu = psdu[i + 4: i + 4 + mlen]
        if len(mpdu) < mlen:
            break
        out.append(AmpduSubframe(mpdu=mpdu, fcs_ok=fcs_ok(mpdu)))
        i += 4 + mlen
        if i < len(psdu):
            i += -i % 4
    return out
