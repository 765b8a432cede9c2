"""MAC-layer packet construction: UDP/IPv4/LLC encapsulation and 802.11
data/control/management frames with FCS.

Capability parity with the reference MAC toolbox
(reference tools/mac80211.py:65-366): same wire formats, so MPDUs are
byte-identical for identical inputs (validated in tests/test_mac.py).

Copy of ieee80211_tpu/mac/frames.py: the port imports nothing of the JAX
package, so it carries its own copy; tests/test_torch_mac.py holds it equal
to the original.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Sequence

from ..specs.crc import append_fcs, crc32_bytes, fcs_ok
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


def build_vht_ndp_announcement(rx_addr: str, tx_addr: str, token: int,
                               sta_aids: Sequence[int],
                               sta_fb_type: Sequence[int],
                               sta_nc: Sequence[int]) -> bytes:
    """VHT NDP Announcement control frame (9.3.1.19)."""
    fc = (1 << 2) | (5 << 4)
    pkt = struct.pack("<HH", fc, 340)
    pkt += _mac_to_bytes(rx_addr) + _mac_to_bytes(tx_addr)
    pkt += struct.pack("<B", token << 2)
    for aid, fb, nc in zip(sta_aids, sta_fb_type, sta_nc):
        info = aid | (fb << 12) | (((nc - 1) if fb else 0) << 13)
        pkt += struct.pack("<H", info)
    return append_fcs(pkt)


def build_bf_report_poll(rx_addr: str, tx_addr: str,
                         fb_segments: Sequence[int]) -> bytes:
    """Beamforming Report Poll control frame (9.3.1.20)."""
    fc = (1 << 2) | (4 << 4)
    pkt = struct.pack("<HH", fc, 110)
    pkt += _mac_to_bytes(rx_addr) + _mac_to_bytes(tx_addr)
    bitmap = 0
    for s in fb_segments:
        bitmap |= 1 << s
    pkt += struct.pack("<B", bitmap)
    return append_fcs(pkt)


def build_mgmt_action_no_ack(ds_addr: str, tx_addr: str, bssid: str, seq: int,
                             category: int, details: bytes) -> bytes:
    """Management Action-No-Ack frame (9.4.1.11) carrying e.g. a VHT
    compressed beamforming report."""
    fc = (0 << 2) | (14 << 4)
    pkt = struct.pack("<HH", fc, 32)
    pkt += _mac_to_bytes(ds_addr) + _mac_to_bytes(tx_addr) + _mac_to_bytes(bssid)
    pkt += struct.pack("<H", seq)
    pkt += struct.pack("<B", category)
    pkt += details
    return append_fcs(pkt)


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


def aggregate_ht(mpdus: Sequence[bytes]) -> bytes:
    """HT A-MPDU: delimiters + 4-byte padding between subframes."""
    out = b""
    for i, mpdu in enumerate(mpdus):
        n = len(mpdu)
        if not (1 <= n <= 4095):
            raise ValueError(f"HT A-MPDU subframe length {n} out of range")
        len_bits = [(n >> k) & 1 for k in range(12)]
        sub = _delimiter(len_bits, ht=True) + mpdu
        if i < len(mpdus) - 1:
            sub += b"\x00" * (-len(sub) % 4)
        out += sub
    return out


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
class ParsedMpdu:
    fc: int
    ftype: int
    subtype: int
    duration: int
    addr1: str
    addr2: str
    addr3: str
    seq: int
    frag: int
    body: bytes
    fcs_ok: bool


def _fmt_mac(b: bytes) -> str:
    return ":".join(f"{x:02x}" for x in b)


def parse_mpdu(mpdu: bytes) -> ParsedMpdu:
    fc, duration = struct.unpack("<HH", mpdu[0:4])
    ftype = (fc >> 2) & 3
    subtype = (fc >> 4) & 0xF
    a1, a2, a3 = mpdu[4:10], mpdu[10:16], mpdu[16:22]
    sc, = struct.unpack("<H", mpdu[22:24])
    hlen = 24 + (2 if (ftype == 2 and subtype == 8) else 0)
    return ParsedMpdu(fc=fc, ftype=ftype, subtype=subtype, duration=duration,
                      addr1=_fmt_mac(a1), addr2=_fmt_mac(a2),
                      addr3=_fmt_mac(a3), seq=sc >> 4, frag=sc & 0xF,
                      body=mpdu[hlen:-4], fcs_ok=fcs_ok(mpdu))


@dataclass
class ParsedUdp:
    src_port: int
    dst_port: int
    payload: bytes


def parse_udp_mpdu(mpdu: bytes) -> ParsedUdp:
    """MAC -> LLC -> IPv4 -> UDP payload extraction."""
    p = parse_mpdu(mpdu)
    llc = p.body
    assert llc[:3] == b"\xaa\xaa\x03", "not LLC/SNAP"
    ip = llc[8:]
    ihl = (ip[0] & 0xF) * 4
    udp = ip[ihl:]
    sp, dp, ln, _ = struct.unpack(">HHHH", udp[:8])
    return ParsedUdp(src_port=sp, dst_port=dp, payload=udp[8:ln])


@dataclass
class AmpduSubframe:
    mpdu: bytes
    fcs_ok: bool


def deaggregate_vht(psdu: bytes, max_subframes: int = 64) -> List[AmpduSubframe]:
    """Walk VHT A-MPDU delimiters (parity: lib/decode_impl.cc:329-427).

    Uses the native runtime's delimiter walk + CRC-32 when available
    (tests/test_native.py pins it byte-identical to the loop below)."""
    from .. import native
    nat = native.deagg(psdu, vht=True, max_sub=max_subframes)
    if nat is not None:
        return [AmpduSubframe(mpdu=psdu[o:o + ln], fcs_ok=ok)
                for o, ln, ok in nat]
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
    from .. import native
    nat = native.deagg(psdu, vht=False, max_sub=max_subframes)
    if nat is not None:
        return [AmpduSubframe(mpdu=psdu[o:o + ln], fcs_ok=ok)
                for o, ln, ok in nat]
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
