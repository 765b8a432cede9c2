"""Generic 802.11 frame parsing: frame control, management elements, and a
type-dispatched packet parser covering management (beacon/probe), control
(ACK/BlockAck/RTS/CTS/NDP-announcement/BF-poll) and data (QoS) frames.

Capability parity with the reference's print-based inspectors
(reference tools/mac80211header.py:235-260 frameControl,
:732-830 mgmtElementParser, :833-938 pktParser) — re-designed as structured
dataclasses so results are programmatically usable; ``describe()`` renders
the same human-readable summary the reference prints.

Also provides ``build_beacon`` so the beacon waveform example
(reference tools/pktGenExample.py:233-240, which replays a captured
hex blob) can be synthesized from scratch.

Copy of ieee80211_tpu/mac/parse.py: the port imports nothing of the JAX
package, so it carries its own copy; tests/test_torch_mac.py holds it equal
to the original.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..specs.crc import append_fcs, fcs_ok

TYPE_NAMES = ("Management", "Control", "Data", "Extension")

SUBTYPE_NAMES = (
    # Management (reference C_FC_SUBTYPE_MGMT_STR)
    ("Association Request", "Association Response", "Reassociation Request",
     "Reassociation Response", "Probe Request", "Probe Response",
     "Timing Advertisement", "Reserved", "Beacon", "ATIM", "Disassociation",
     "Authentication", "Deauthentication", "Action", "Action No Ack",
     "Reserved"),
    # Control
    ("Reserved", "Reserved", "Reserved", "Reserved",
     "Beamforming Report Poll", "VHT NDP Announcement",
     "Control Frame Extension", "Control Wrapper", "Block Ack Request",
     "Block Ack", "PS-Poll", "RTS", "CTS", "Ack", "CF-End", "CF-End +CF-Ack"),
    # Data
    ("Data", "Data +CF-Ack", "Data +CF-Poll", "Data +CF-Ack +CF-Poll",
     "Null", "CF-Ack", "CF-Poll", "CF-Ack +CF-Poll", "QoS Data",
     "QoS Data +CF-Ack", "QoS Data +CF-Poll", "QoS Data +CF-Ack +CF-Poll",
     "QoS Null", "Reserved", "QoS CF-Poll", "QoS CF-Ack +CF-Poll"),
    # Extension
    ("DMG Beacon",) + ("Reserved",) * 15,
)

# Management element IDs the reference understands
# (tools/mac80211header.py:171-191 MGMT_ELE)
ELEMENT_NAMES = {
    0: "SSID", 1: "Supported Rates", 3: "DS Parameter Set", 5: "TIM",
    7: "Country", 11: "BSS Load", 45: "HT Capabilities", 48: "RSN",
    61: "HT Operation", 64: "Antenna", 70: "RM Enabled Capabilities",
    127: "Extended Capabilities", 191: "VHT Capabilities",
    192: "VHT Operation", 195: "TX Power Envelope", 221: "Vendor Specific",
}


@dataclass
class FrameControl:
    """Decoded 16-bit frame-control field (9.2.4.1)."""
    value: int
    version: int
    ftype: int
    subtype: int
    to_ds: int
    from_ds: int
    more_frag: int
    retry: int
    power_mgmt: int
    more_data: int
    protected: int
    htc_order: int

    @classmethod
    def from_value(cls, fc: int) -> "FrameControl":
        return cls(value=fc, version=fc & 3, ftype=(fc >> 2) & 3,
                   subtype=(fc >> 4) & 0xF, to_ds=(fc >> 8) & 1,
                   from_ds=(fc >> 9) & 1, more_frag=(fc >> 10) & 1,
                   retry=(fc >> 11) & 1, power_mgmt=(fc >> 12) & 1,
                   more_data=(fc >> 13) & 1, protected=(fc >> 14) & 1,
                   htc_order=(fc >> 15) & 1)

    @property
    def type_name(self) -> str:
        return TYPE_NAMES[self.ftype]

    @property
    def subtype_name(self) -> str:
        return SUBTYPE_NAMES[self.ftype][self.subtype]

    def describe(self) -> str:
        return (f"FC {self.value:#06x} proto {self.version} "
                f"{self.type_name}/{self.subtype_name} toDS {self.to_ds} "
                f"fromDS {self.from_ds} moreFrag {self.more_frag} "
                f"retry {self.retry}")


@dataclass
class MgmtElement:
    """One information element: raw bytes plus a decoded summary."""
    eid: int
    name: str
    data: bytes
    summary: str
    fields: Dict[str, object] = field(default_factory=dict)


def _fmt_mac(b: bytes) -> str:
    return ":".join(f"{x:02x}" for x in b)


def _decode_element(eid: int, data: bytes) -> Tuple[str, Dict[str, object]]:
    """Decode the elements the reference inspects
    (tools/mac80211header.py:745-818); unknown IDs keep raw bytes."""
    f: Dict[str, object] = {}
    if eid == 0:
        ssid = data.decode("utf-8", errors="replace")
        f["ssid"] = ssid
        return f"SSID: {ssid}", f
    if eid == 1:
        rates = [((b & 0x7F) * 500 / 1000, bool(b & 0x80)) for b in data]
        f["rates_mbps"] = rates
        return "Supported Rates: " + " ".join(
            f"{r}Mbps" + ("(Basic)" if basic else "")
            for r, basic in rates), f
    if eid == 3 and len(data) >= 1:
        f["channel"] = data[0]
        return f"DS Channel: {data[0]}", f
    if eid == 7 and len(data) >= 3:
        country = data[:2].decode("ascii", errors="replace").strip()
        f["country"] = country
        return f"Country: {country}", f
    if eid == 11 and len(data) >= 5:
        sta, = struct.unpack("<H", data[0:2])
        util = data[2]
        adm, = struct.unpack("<H", data[3:5])
        f.update(station_count=sta, channel_utilization=util,
                 avail_admission_capacity=adm)
        return (f"BSS Load: stations {sta}, utilization {util}, "
                f"admission capacity {adm}"), f
    if eid == 45 and len(data) >= 13:
        cap, = struct.unpack("<H", data[0:2])
        f.update(ldpc=cap & 1, chan_width=(cap >> 1) & 1,
                 greenfield=(cap >> 4) & 1, sgi20=(cap >> 5) & 1,
                 sgi40=(cap >> 6) & 1, tx_stbc=(cap >> 7) & 1)
        mcs_bits = [(data[3 + i // 8] >> (i % 8)) & 1 for i in range(77)]
        f["rx_mcs_bitmap"] = mcs_bits
        return (f"HT Cap: LDPC {cap & 1}, 40MHz {(cap >> 1) & 1}, "
                f"GF {(cap >> 4) & 1}, SGI20 {(cap >> 5) & 1}, "
                f"SGI40 {(cap >> 6) & 1}, TxSTBC {(cap >> 7) & 1}, "
                f"MCS {''.join(map(str, mcs_bits[:32]))}"), f
    if eid == 64 and len(data) >= 1:
        f["antenna"] = data[0]
        return f"Antenna: {data[0]}", f
    if eid == 191 and len(data) >= 4:
        cap, = struct.unpack("<I", data[0:4])
        f.update(max_mpdu_len=cap & 3, rx_ldpc=(cap >> 4) & 1,
                 tx_stbc=(cap >> 7) & 1, rx_stbc=(cap >> 8) & 7,
                 sounding_dim=(cap >> 16) & 7)
        return (f"VHT Cap: max MPDU {cap & 3}, RxLDPC {(cap >> 4) & 1}, "
                f"TxSTBC {(cap >> 7) & 1}, RxSTBC {(cap >> 8) & 7}, "
                f"sounding dim {(cap >> 16) & 7}"), f
    if eid == 195 and len(data) >= 2:
        f.update(pwr_count=data[0] & 3, max_pwr_20mhz=data[1])
        return (f"TX Power: count {data[0] & 3}, "
                f"local max 20MHz {data[1]}"), f
    return f"{ELEMENT_NAMES.get(eid, f'Element {eid}')}: "\
           f"{data.hex()}", f


def parse_mgmt_elements(body: bytes) -> List[MgmtElement]:
    """Walk the TLV element list of a management frame body."""
    out: List[MgmtElement] = []
    i = 0
    n = len(body)
    while i + 2 <= n:
        eid, ln = body[i], body[i + 1]
        data = body[i + 2: i + 2 + ln]
        if len(data) < ln:
            break
        summary, fields = _decode_element(eid, data)
        out.append(MgmtElement(eid=eid,
                               name=ELEMENT_NAMES.get(eid, f"Element {eid}"),
                               data=data, summary=summary, fields=fields))
        i += 2 + ln
    return out


@dataclass
class ParsedFrame:
    """Structured result of the generic parser (analogous to the stdout of
    reference pktParser, tools/mac80211header.py:833)."""
    fc: FrameControl
    duration: int
    addr1: Optional[str] = None
    addr2: Optional[str] = None
    addr3: Optional[str] = None
    seq: Optional[int] = None
    frag: Optional[int] = None
    qos_ctrl: Optional[int] = None
    body: bytes = b""
    # beacon fields
    timestamp: Optional[int] = None
    beacon_interval: Optional[int] = None
    capability: Optional[int] = None
    elements: List[MgmtElement] = field(default_factory=list)
    fcs_ok: Optional[bool] = None

    @property
    def ssid(self) -> Optional[str]:
        for e in self.elements:
            if e.eid == 0:
                return e.fields.get("ssid")
        return None

    def describe(self) -> List[str]:
        # PS-Poll reuses the duration field as the association ID
        # (IEEE 802.11-2020 9.3.1.4)
        if self.fc.ftype == 1 and self.fc.subtype == 10:
            lines = [self.fc.describe(), f"AID {self.duration & 0x3FFF}"]
        else:
            lines = [self.fc.describe(), f"Duration {self.duration} us"]
        if self.addr1 is not None:
            who = f"{self.fc.type_name} to {self.addr1}"
            if self.addr2 is not None:
                who += f" from {self.addr2}"
            if self.addr3 is not None:
                who += f" dest {self.addr3}"
            lines.append(who)
        if self.seq is not None:
            lines.append(f"Sequence {self.seq} fragment {self.frag}")
        if self.timestamp is not None:
            lines.append(f"Beacon timestamp {self.timestamp}, interval "
                         f"{self.beacon_interval}, cap {self.capability:#06x}")
        lines += [e.summary for e in self.elements]
        if self.qos_ctrl is not None:
            lines.append(f"QoS control {self.qos_ctrl:#06x}")
        if self.fcs_ok is not None:
            lines.append(f"FCS {'ok' if self.fcs_ok else 'BAD'}")
        return lines


# control subtypes that carry only RA (len 10+4) vs RA+TA (len 16+4)
_CTRL_RA_ONLY = {12, 13}            # CTS, ACK
# BF-poll, NDPA, BAR, BA, PS-Poll, RTS, CF-End, CF-End +CF-Ack
_CTRL_RA_TA = {4, 5, 8, 9, 10, 11, 14, 15}


def parse_frame(pkt: bytes, has_fcs: bool = True) -> ParsedFrame:
    """Generic type-dispatched parser for any 802.11 MPDU.

    Unlike :func:`frames.parse_mpdu` (data-frame fast path) this handles
    management and control layouts too, mirroring the coverage of the
    reference pktParser (tools/mac80211header.py:833-938).
    """
    fcs = fcs_ok(pkt) if has_fcs and len(pkt) >= 8 else None
    if has_fcs and len(pkt) >= 8:
        pkt = pkt[:-4]
    fcv, duration = struct.unpack("<HH", pkt[0:4])
    fc = FrameControl.from_value(fcv)
    out = ParsedFrame(fc=fc, duration=duration, fcs_ok=fcs)
    i = 4
    if fc.ftype == 1:   # control: no seq ctrl, variable address count
        if len(pkt) >= i + 6:
            out.addr1 = _fmt_mac(pkt[i:i + 6])
            i += 6
        if fc.subtype in _CTRL_RA_TA and len(pkt) >= i + 6:
            out.addr2 = _fmt_mac(pkt[i:i + 6])
            i += 6
        out.body = pkt[i:]
        return out
    # management / data: 3 addresses + sequence control. A frame too short
    # for the full header is malformed — return the remainder as body
    # rather than falling through and misreading address bytes as
    # QoS/fixed fields.
    if len(pkt) < i + 20:
        out.body = pkt[i:]
        return out
    out.addr1 = _fmt_mac(pkt[i:i + 6])
    out.addr2 = _fmt_mac(pkt[i + 6:i + 12])
    out.addr3 = _fmt_mac(pkt[i + 12:i + 18])
    sc, = struct.unpack("<H", pkt[i + 18:i + 20])
    out.seq, out.frag = sc >> 4, sc & 0xF
    i += 20
    if fc.ftype == 0:   # management
        if fc.subtype in (8, 5):   # beacon / probe response: fixed fields
            if len(pkt) >= i + 12:
                out.timestamp, = struct.unpack("<Q", pkt[i:i + 8])
                out.beacon_interval, = struct.unpack("<H", pkt[i + 8:i + 10])
                out.capability, = struct.unpack("<H", pkt[i + 10:i + 12])
                i += 12
            out.elements = parse_mgmt_elements(pkt[i:])
        elif fc.subtype == 4:      # probe request: elements only
            out.elements = parse_mgmt_elements(pkt[i:])
        out.body = pkt[i:]
        return out
    # data
    if fc.subtype >= 8 and len(pkt) >= i + 2:   # QoS variants
        out.qos_ctrl, = struct.unpack("<H", pkt[i:i + 2])
        i += 2
    out.body = pkt[i:]
    return out


def build_element(eid: int, data: bytes) -> bytes:
    return struct.pack("<BB", eid, len(data)) + data


def build_beacon(ssid: str, addr2: str, addr3: str, seq: int = 0,
                 timestamp: int = 0, interval_tu: int = 100,
                 capability: int = 0x1111, channel: int = 100,
                 rates_500kbps: Sequence[int] = (0x8C, 0x12, 0x98, 0x24,
                                                 0xB0, 0x48, 0x60, 0x6C),
                 extra_elements: Sequence[Tuple[int, bytes]] = ()) -> bytes:
    """Beacon MPDU with FCS: the synthesizable counterpart of the captured
    beacon the reference replays (tools/pktGenExample.py:233-240)."""
    from .frames import _mac_to_bytes
    fc = (0 << 2) | (8 << 4)
    hdr = struct.pack("<HH", fc, 0)
    hdr += b"\xff" * 6 + _mac_to_bytes(addr2) + _mac_to_bytes(addr3)
    hdr += struct.pack("<H", seq << 4)
    body = struct.pack("<QHH", timestamp, interval_tu, capability)
    body += build_element(0, ssid.encode("utf-8"))
    body += build_element(1, bytes(rates_500kbps))
    body += build_element(3, bytes([channel]))
    for eid, data in extra_elements:
        body += build_element(eid, data)
    return append_fcs(hdr + body)
