"""Inspect and decode a capture bin (analog of the reference's
tools/drawGrBin.py + tools/pktRxExample.py): prints the triggers and the
decoded packets.

    python -m ieee80211_tpu_torch.examples.inspect_bin FILE [FS_HZ]
        [--device cpu]

Port of examples/inspect_bin.py. The capture decodes through
`SisoReceiver` on the card unless --device asks for another device.
"""
import argparse

import numpy as np

from ..ops.sync import find_triggers_np
from ..rx import SisoReceiver
from ..utils import load_complex_bin


def main(path, fs_hz=20e6, device=None):
    """Print and return the capture's decoded packets."""
    cap = load_complex_bin(path)
    print(f"{path}: {len(cap)} samples @ {fs_hz/1e6:.0f} MHz, "
          f"peak {np.abs(cap).max():.3f}")
    rx = SisoReceiver(sample_rate_hz=fs_hz, device=device)
    t0s = find_triggers_np(cap, q=rx.q)
    print(f"triggers at {list(t0s)}")
    res = rx.decode_capture(cap)
    for r in res:
        print(f"  {r.fmt.name} mcs{r.mcs} fcs_ok={r.fcs_ok} "
              f"cfo={r.cfo_hz:.0f}Hz evm_snr={r.evm_snr_db:.1f}dB "
              f"mpdus={[len(m) for m in r.mpdus]}")
    print("stats:", rx.stats.summary())
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path")
    ap.add_argument("fs_hz", nargs="?", type=float, default=20e6)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    main(args.path, args.fs_hz, device=args.device)
