"""Binary MAC<->PHY message formats.

Wire parity with the reference UDP control plane (SURVEY.md §2.4):

  TX requests (MAC -> PHY, reference port 9528):
    SU data:  [format(1B) mcs(1B) nSTS(1B) len(2B LE)] + MPDU
              (tools/phy80211.py:1187 genPktGrData / pktgen_impl.cc:58-70)
    MU data:  [3(1B) mcs0 nSTS0 len0(2B) mcs1 nSTS1 len1(2B) gid(1B)]
              + MPDU0 + MPDU1       (genPktGrDataMu)
    BFQ:      [10(1B)] + 64 tones x 2x2 complex64 (2048 B)  (genPktGrBfQ)
    NDP:      [2, 0, 2, 0, 0]                              (genPktGrNdp)

  RX records (PHY -> MAC, reference port 9527):
    data:     [format(1B) len(2B LE)] + payload + [mcs(1B)]
              (lib/decode_impl.cc:414-419,512-516)
    channel:  [20(1B) len(2B LE)] + 256 float32 (2x64 complex LTF samples)
              (lib/decode_impl.cc:100-121, type C8P_F_VHT_CHAN)

Copy of ieee80211_tpu/api/descriptors.py: the wire format, pinned to the
original by tests/test_torch_api.py.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Tuple, Union

import numpy as np

from ..specs import F, GRF, Mod


@dataclasses.dataclass
class DataRequest:
    fmt: F
    mcs: int
    n_sts: int
    mpdu: bytes


@dataclasses.dataclass
class MuDataRequest:
    mcs0: int
    n_sts0: int
    mpdu0: bytes
    mcs1: int
    n_sts1: int
    mpdu1: bytes
    group_id: int


@dataclasses.dataclass
class BfqMessage:
    q: np.ndarray      # [64, n, n] complex64 (n=2 is the reference wire
                       # format; n=3/4 extends it for multi-stream MU users)


@dataclasses.dataclass
class NdpRequest:
    n_sts: int = 2


@dataclasses.dataclass
class RxRecord:
    fmt: int           # GRF value (0/1/2) for data, 20 for channel report
    payload: bytes
    mcs: int = 0


@dataclasses.dataclass
class ChannelReport:
    ltf_iq: np.ndarray  # [128] complex64 (2 x 64 VHT-LTF samples)


def pack_data(mpdu: bytes, mod: Mod) -> bytes:
    assert len(mpdu) < 4096
    return (struct.pack("<BBBH", mod.fmt.value, mod.mcs, mod.nSTS, len(mpdu))
            + bytes(mpdu))


def pack_mu_data(mpdu0: bytes, mod0: Mod, mpdu1: bytes, mod1: Mod,
                 group_id: int) -> bytes:
    """Real per-user nSTS on the wire (parity: genPktGrDataMu packs each
    user's nSS, tools/phy80211.py:1200-1222 / lib/pktgen_impl.cc:95-115) —
    a 2-stream MU user is expressible, matching the golden TX envelope."""
    assert 0 < group_id < 63
    return (struct.pack("<BBBH", GRF.MU.value, mod0.mcs, mod0.nSTS,
                        len(mpdu0))
            + struct.pack("<BBH", mod1.mcs, mod1.nSTS, len(mpdu1))
            + struct.pack("<B", group_id) + bytes(mpdu0) + bytes(mpdu1))


def pack_bfq(q: np.ndarray) -> bytes:
    """[64, n, n] spatial-mapping Q -> wire message. n=2 is byte-identical
    to the reference (genPktGrBfQ, 1 + 64*2*2*8 bytes); larger n uses the
    same layout with the message length carrying the dimension."""
    q = np.asarray(q)
    n = q.shape[1]
    assert q.shape == (64, n, n) and 1 <= n <= 4
    out = struct.pack("<B", GRF.BFQ.value)
    flat = np.empty(64 * n * n * 2, dtype=np.float32)
    flat[0::2] = np.real(q).reshape(-1)
    flat[1::2] = np.imag(q).reshape(-1)
    return out + flat.tobytes()


def pack_ndp() -> bytes:
    return b"\x02\x00\x02\x00\x00"   # VHT mcs0 nSTS2 len0


Request = Union[DataRequest, MuDataRequest, BfqMessage, NdpRequest]


def unpack_request(msg: bytes) -> Optional[Request]:
    if len(msg) < 1:
        return None
    t = msg[0]
    if t == GRF.BFQ.value:
        n = int(round(np.sqrt((len(msg) - 1) / 512.0)))
        flat = np.frombuffer(msg[1:1 + 64 * n * n * 8], dtype=np.float32)
        q = (flat[0::2] + 1j * flat[1::2]).astype(np.complex64)
        return BfqMessage(q=q.reshape(64, n, n))
    if t == GRF.MU.value:
        mcs0, nsts0, len0 = struct.unpack("<BBH", msg[1:5])
        mcs1, nsts1, len1 = struct.unpack("<BBH", msg[5:9])
        gid = msg[9]
        body = msg[10:]
        return MuDataRequest(mcs0=mcs0, n_sts0=nsts0, mpdu0=body[:len0],
                             mcs1=mcs1, n_sts1=nsts1,
                             mpdu1=body[len0:len0 + len1], group_id=gid)
    if t in (GRF.L.value, GRF.HT.value, GRF.VHT.value):
        fmt, mcs, nsts, ln = struct.unpack("<BBBH", msg[:5])
        if ln == 0 and fmt == F.VHT.value:
            return NdpRequest(n_sts=nsts)
        return DataRequest(fmt=F(fmt), mcs=mcs, n_sts=nsts,
                           mpdu=msg[5:5 + ln])
    return None


def pack_rx_record(fmt_code: int, payload: bytes, mcs: int = 0) -> bytes:
    out = struct.pack("<BH", fmt_code, len(payload)) + bytes(payload)
    if fmt_code != GRF.NDP.value:
        out += struct.pack("<B", mcs)
    return out


def pack_channel_report(ltf_iq: np.ndarray) -> bytes:
    flat = np.empty(256, dtype=np.float32)
    flat[0::2] = np.real(ltf_iq).astype(np.float32)
    flat[1::2] = np.imag(ltf_iq).astype(np.float32)
    return struct.pack("<BH", GRF.NDP.value, 1024) + flat.tobytes()


def unpack_rx_record(msg: bytes) -> Union[RxRecord, ChannelReport, None]:
    if len(msg) < 3:
        return None
    t, ln = struct.unpack("<BH", msg[:3])
    if t == GRF.NDP.value:
        flat = np.frombuffer(msg[3:3 + 1024], dtype=np.float32)
        return ChannelReport(ltf_iq=(flat[0::2] + 1j * flat[1::2]
                                     ).astype(np.complex64))
    payload = msg[3:3 + ln]
    mcs = msg[3 + ln] if len(msg) > 3 + ln else 0
    return RxRecord(fmt=t, payload=payload, mcs=mcs)
