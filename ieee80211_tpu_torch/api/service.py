"""The PHY service: request -> waveform (TX) and capture -> records (RX).

Port of ieee80211_tpu/api/service.py (`PhyService` :25). One object takes
the binary MAC->PHY requests, synthesizes waveforms with the golden TX (as
the JAX service does), and decodes captures back into the binary PHY->MAC
records with the port's receivers, on the card unless `device="cpu"` asks
for the CPU: in-process, or served over the reference's UDP port pair (TX
9528 / RX 9527).
"""
from __future__ import annotations

import socket
from typing import Callable, List, Optional

import numpy as np

from ..rx import MimoReceiver, SisoReceiver
from ..specs import BW, F, Mod
from ..tx import finalize, gen_ampdu, gen_ampdu_mu, gen_mpdu
from . import descriptors as d


class PhyService:
    """In-process PHY endpoint with the reference's wire API.

    mupos/mugid configure the station's MU-MIMO group position for downlink
    MU decode (the reference demod block's parameters): mugid in [1, 62]
    arms both receivers' MU lanes; mugid 0 (an AP or a non-member) leaves
    them off. The receivers run on `device` (default the card)."""

    def __init__(self, mupos: int = 0, mugid: int = 1,
                 amplitude: float = 0.25, gap_len: int = 1200, device=None):
        self.mupos = mupos
        self.mugid = mugid
        self.amplitude = amplitude
        self.gap_len = gap_len
        self.bfq: Optional[np.ndarray] = None
        gid = mugid if 1 <= mugid <= 62 else None
        self.siso_rx = SisoReceiver(mu_pos=mupos, mu_gid=gid, device=device)
        self.mimo_rx = MimoReceiver(mu_pos=mupos, mu_gid=gid, device=device)

    # -- TX side -----------------------------------------------------------
    def handle_request(self, msg: bytes) -> Optional[np.ndarray]:
        """Binary request -> waveform [nSS, N] complex64 (None for BFQ)."""
        req = d.unpack_request(msg)
        if req is None:
            return None
        if isinstance(req, d.BfqMessage):
            self.bfq = req.q            # installed for subsequent MU packets
            return None
        if isinstance(req, d.NdpRequest):
            tx = gen_ampdu(b"", Mod(F.VHT, 0, BW.BW20, req.n_sts))
            return finalize(tx.waveform, multiplier=self.amplitude,
                            gap=True, gap_len=self.gap_len)
        if isinstance(req, d.MuDataRequest):
            if self.bfq is None:
                raise ValueError("BFQ must be installed before MU TX")
            n_sts = req.n_sts0 + req.n_sts1
            if self.bfq.shape[1] != n_sts:
                raise ValueError(
                    f"installed BFQ is {self.bfq.shape[1]}-stream but the "
                    f"MU request totals {n_sts} streams")
            tx = gen_ampdu_mu(
                [req.mpdu0, req.mpdu1],
                [Mod(F.VHT, req.mcs0, BW.BW20, req.n_sts0),
                 Mod(F.VHT, req.mcs1, BW.BW20, req.n_sts1)],
                bfq=self.bfq, group_id=req.group_id)
            return finalize(tx.waveform, multiplier=self.amplitude,
                            gap=True, gap_len=self.gap_len)
        mod = Mod(req.fmt, req.mcs, BW.BW20, req.n_sts)
        if req.fmt == F.VHT:
            tx = gen_ampdu(req.mpdu, mod)
        else:
            tx = gen_mpdu(req.mpdu, mod)
        return finalize(tx.waveform, multiplier=self.amplitude,
                        gap=True, gap_len=self.gap_len)

    # -- RX side -----------------------------------------------------------
    @staticmethod
    def _records(packets, ndps) -> List[bytes]:
        """Data records of every FCS-valid MPDU, then channel reports (an
        entry of ndps is an NdpCapture, or a list of one per chain)."""
        recs = [d.pack_rx_record(r.fmt.value, mpdu, r.mcs)
                for r in packets for mpdu in r.mpdus]
        for nd in ndps:
            for ndp in (nd if isinstance(nd, list) else [nd]):
                recs.append(d.pack_channel_report(ndp.ltf_iq))
        return recs

    def rx_capture(self, capture: np.ndarray) -> List[bytes]:
        """Decode a capture into binary PHY->MAC records.

        capture: [N] (SISO) or [2, N] (dual-chain). Emits data records for
        every FCS-valid MPDU (this station's MU stream included when a
        group is configured), then NDP channel reports (one per RX chain of
        a dual-chain capture)."""
        capture = np.asarray(capture)
        rx = self.mimo_rx if capture.ndim == 2 else self.siso_rx
        return self._records(*rx.decode_capture_full(capture))

    def rx_captures(self, captures) -> List[List[bytes]]:
        """Sustained streaming decode: a list of captures through the
        pipelined `decode_captures` path, per-capture record lists with the
        NDP channel reports inline. All captures must share a shape family:
        [N] (SISO) or [2, N] (dual-chain)."""
        caps = [np.asarray(c) for c in captures]
        if not caps:
            return []
        rx = self.mimo_rx if caps[0].ndim == 2 else self.siso_rx
        results, ndps = rx.decode_captures_full(caps)
        return [self._records(res_k, ndps[k])
                for k, res_k in enumerate(results)]

    # -- UDP mode (reference port pair) ------------------------------------
    def serve_udp(self, on_waveform: Callable[[np.ndarray], None],
                  tx_addr=("127.0.0.1", 9528), stop_event=None):
        """Listen for MAC requests on the reference TX port; synthesized
        waveforms go to `on_waveform` (e.g. a channel emulator or radio)."""
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.bind(tx_addr)
        sock.settimeout(0.25)
        while stop_event is None or not stop_event.is_set():
            try:
                msg, _ = sock.recvfrom(65535)
            except socket.timeout:
                continue
            wave = self.handle_request(msg)
            if wave is not None:
                on_waveform(wave)
        sock.close()

    def send_records(self, records: List[bytes],
                     rx_addr=("127.0.0.1", 9527)):
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for rec in records:
            sock.sendto(rec, rx_addr)
        sock.close()
