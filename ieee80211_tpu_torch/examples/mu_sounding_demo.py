"""Closed-loop MU-MIMO sounding demo over the binary MAC<->PHY API.

    python -m ieee80211_tpu_torch.examples.mu_sounding_demo [--device cpu]

Port of examples/mu_sounding_demo.py, an in-memory re-creation of the
reference cmu_v3 wireless demo (tools/cmu_v3/cmu_ap.py): an AP PHY and two
STA PHYs exchange NDP / channel-report / BFQ / MU-data messages through a
2x2 channel matrix. The stations' receivers run on the card unless
--device asks for another device.
"""
import argparse

import numpy as np

from ..api import PhyService
from ..api import descriptors as d
from ..mac import MacConfig, aggregate_vht, build_udp_mpdu, parse_udp_mpdu
from ..mu import map_q_to_grid, ndp_ltf_channel, vht_channel_feedback, zf_q
from ..specs import BW, F, Mod

CFG = MacConfig(subtype=8, addr1="f4:69:d5:80:0f:a0",
                addr2="00:c0:ca:b1:5b:e1", addr3="f4:69:d5:80:0f:a0", seq=1)
PAYLOADS = [b"1234567 packet for station 000",
            b"7654321 packet for station 111"]


def main(device=None):
    """Run the loop; returns each station's decoded UDP payloads."""
    rng = np.random.default_rng(0)
    h = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
    h += 2.0 * np.eye(2)

    ap = PhyService(mugid=0, device=device)
    stas = [PhyService(mupos=u, mugid=2, device=device) for u in range(2)]

    print("1. AP sends NDP")
    ndp = ap.handle_request(d.pack_ndp())
    ltfs = []
    for u in range(2):
        recs = stas[u].rx_capture((h[u] @ ndp).astype(np.complex64))
        rep = [d.unpack_rx_record(r) for r in recs]
        rep = [r for r in rep if isinstance(r, d.ChannelReport)][0]
        print(f"   STA{u} channel report: {len(rep.ltf_iq)} LTF samples")
        ltfs.append(rep.ltf_iq)

    print("2. AP computes SVD feedback + ZF Q, installs BFQ")
    v = [vht_channel_feedback(ndp_ltf_channel(x), BW.BW20, 2, 1)
         for x in ltfs]
    q = map_q_to_grid(zf_q(v)).astype(np.complex64)
    ap.handle_request(d.pack_bfq(q))

    print("3. AP sends 2-user MU data")
    mpdus = [build_udp_mpdu(p, CFG) for p in PAYLOADS]
    wave = ap.handle_request(d.pack_mu_data(
        aggregate_vht([mpdus[0]]), Mod(F.VHT, 0),
        aggregate_vht([mpdus[1]]), Mod(F.VHT, 0), 2))

    decoded = [[], []]
    for u in range(2):
        recs = stas[u].rx_capture((h[u] @ wave).astype(np.complex64))
        for r in recs:
            rec = d.unpack_rx_record(r)
            if isinstance(rec, d.RxRecord) and rec.fmt == F.VHT.value:
                udp = parse_udp_mpdu(rec.payload)
                print(f"   STA{u} decoded: {udp.payload!r}")
                decoded[u].append(udp.payload)
    return decoded


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    main(ap.parse_args().device)
