"""Generate the canonical multi-format test captures.

    python -m ieee80211_tpu_torch.examples.gen_test_captures [OUTDIR]

Port of examples/gen_test_captures.py, the analog of the reference signal
file generator (tools/pktGenExample.py): a SISO capture with L/HT/VHT MCS7
packets (with per-packet CFO), a 2x2 MIMO capture, a legacy beacon at MCS0
and VHT captures at 40 and 80 MHz, written in the reference-compatible
interleaved-float32 bin format. The waveforms come from the golden numpy
TX, so the bins are byte-identical to the JAX example's and no device is
involved.
"""
import os
import sys

import numpy as np

from ..mac import MacConfig, aggregate_vht, build_beacon, build_udp_mpdu
from ..specs import BW, F, Mod
from ..tx import finalize, gen_ampdu, gen_mpdu
from ..utils import save_complex_bin

CFG = MacConfig(addr1="f4:69:d5:80:0f:a0", addr2="00:c0:ca:b1:5b:e1",
                addr3="f4:69:d5:80:0f:a0", seq=2704)
CFG_QOS = MacConfig(subtype=8, addr1="f4:69:d5:80:0f:a0",
                    addr2="00:c0:ca:b1:5b:e1", addr3="f4:69:d5:80:0f:a0",
                    seq=2704)
PAYLOAD = b"123456789012345678901234567890"


def main(outdir="tmp"):
    """Write the captures into outdir; returns their paths."""
    os.makedirs(outdir, exist_ok=True)
    mpdu = build_udp_mpdu(PAYLOAD, CFG)
    mpdu_q = build_udp_mpdu(PAYLOAD, CFG_QOS)
    paths = []

    def save(name, sig):
        paths.append(os.path.join(outdir, name))
        save_complex_bin(paths[-1], sig)

    parts = [
        finalize(gen_mpdu(mpdu, Mod(F.L, 7)).waveform, 12.0, 232111.0,
                 gap_len=1200),
        finalize(gen_mpdu(mpdu, Mod(F.HT, 7)).waveform, 12.0, 212233.0,
                 gap_len=1200),
        finalize(gen_ampdu(aggregate_vht([mpdu_q]), Mod(F.VHT, 7)).waveform,
                 12.0, 21223.0, gap_len=1200),
    ]
    save("sig80211GenMultipleSiso_1x1_0.bin",
         np.concatenate([p[0] for p in parts]))

    mimo = finalize(gen_mpdu(mpdu, Mod(F.HT, 8, BW.BW20, 2)).waveform,
                    12.0 * np.sqrt(2), 0.0, gap_len=1200)
    for i in range(2):
        save(f"sig80211GenMultipleMimo_2x2_{i}.bin", mimo[i])

    # the beacon is synthesized (build_beacon), not a replay of the
    # reference's captured blob: seq/timestamp and the element set differ
    # from pktGenExample.py's hex string, with a freshly computed FCS
    beacon = build_beacon("cloud_ac86u_5G", "24:4b:fe:61:25:ac",
                          "24:4b:fe:61:25:ac", seq=671, timestamp=23784950,
                          interval_tu=100, capability=0x1111, channel=100)
    bc = finalize(gen_mpdu(beacon, Mod(F.L, 0)).waveform, 18.0, 234567.0,
                  gap_len=10000)
    save("sig80211GenBeacon_1x1_0.bin", bc[0])

    # wideband captures (beyond the reference envelope): decode with
    # `inspect_bin FILE 40e6` / `80e6`
    wb40 = finalize(gen_ampdu(aggregate_vht([mpdu_q]),
                              Mod(F.VHT, 7, BW.BW40)).waveform,
                    12.0, 42000.0, gap_len=2400, fs_hz=40e6)
    save("sig80211GenWideband_40MHz.bin", wb40[0])
    wb80 = finalize(gen_ampdu(aggregate_vht([mpdu_q]),
                              Mod(F.VHT, 9, BW.BW80)).waveform,
                    12.0, 84000.0, gap_len=4800, fs_hz=80e6)
    save("sig80211GenWideband_80MHz.bin", wb80[0])
    print(f"wrote captures to {outdir}/")
    return paths


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tmp")
