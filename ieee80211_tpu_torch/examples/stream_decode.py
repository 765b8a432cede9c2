"""Sustained streaming decode demo, the examples/rx.grc / rx2.grc analog.

    python -m ieee80211_tpu_torch.examples.stream_decode [--dual]
        [--device cpu]

Port of examples/stream_decode.py. Synthesizes a stream of mixed-format
captures (SU HT/VHT and downlink MU; on the dual-chain variant SU packets
reach both chains through a flat channel), decodes them through the
pipelined public API (`decode_captures`) on the card unless --device asks
for another device, and prints per-packet counts and the sustained sample
rate.
"""
import argparse
import time

import numpy as np

from ..mac import MacConfig, aggregate_vht, build_udp_mpdu
from ..rx import MimoReceiver, SisoReceiver
from ..specs import BW, F, Mod
from ..tx import finalize, gen_ampdu, gen_ampdu_mu, gen_mpdu

CFG = MacConfig(subtype=8, addr1="f4:69:d5:80:0f:a0",
                addr2="00:c0:ca:b1:5b:e1", addr3="f4:69:d5:80:0f:a0",
                seq=2704)
N_SEG = 6   # packets per segment: HT MCS5, VHT MCS7, 2-user MU, twice


def build_stream(dual: bool, n_caps: int = 4, reps: int = 30):
    """n_caps captures of `reps` copies of a 6-packet segment (seed 3),
    with 64 + 32k leading zeros: [N] each, or [2, N] when dual."""
    rng = np.random.default_rng(3)
    qi = np.tile(np.eye(2, dtype=np.complex64)[None], (64, 1, 1))
    parts = []
    for i in range(N_SEG):
        pl = bytes(rng.integers(0, 256, int(rng.integers(100, 700)),
                                dtype=np.uint8))
        mp = build_udp_mpdu(pl, CFG)
        cfo = float(rng.uniform(-4e4, 4e4))
        if i % 3 == 0:
            wv = finalize(gen_mpdu(mp, Mod(F.HT, 5)).waveform,
                          multiplier=0.2, cfo_hz=cfo, gap=False)
        elif i % 3 == 1:
            wv = finalize(gen_ampdu(aggregate_vht([mp]),
                                    Mod(F.VHT, 7)).waveform,
                          multiplier=0.2, cfo_hz=cfo, gap=False)
        else:
            mu = gen_ampdu_mu(
                [aggregate_vht([mp]), aggregate_vht([mp])],
                [Mod(F.VHT, 4, BW.BW20, 1), Mod(F.VHT, 2, BW.BW20, 1)],
                bfq=qi, group_id=2)
            wv = finalize(mu.waveform, multiplier=0.2, cfo_hz=cfo,
                          gap=False)
        if dual:
            if wv.shape[0] == 2:
                w2 = np.eye(2) @ wv                   # keep MU isolated
            else:
                h1 = np.array([0.9 - 0.3j, 0.5 + 0.8j])
                w2 = np.stack([h1[0] * wv[0], h1[1] * wv[0]])
            parts.append(np.zeros((2, 800), np.complex64))
            parts.append(w2.astype(np.complex64))
        else:
            parts.append(np.zeros(800, np.complex64))
            parts.append(wv[0].astype(np.complex64))
    seg = np.concatenate(parts, axis=-1)
    big = np.concatenate([seg] * reps, axis=-1)
    if dual:
        return [np.concatenate(
            [np.zeros((2, 64 + 32 * k), np.complex64), big], axis=1)
            for k in range(n_caps)]
    return [np.concatenate([np.zeros(64 + 32 * k, np.complex64), big])
            for k in range(n_caps)]


def main(dual=False, device=None, n_caps=4, reps=30):
    """Decode the stream twice (the first pass builds the decoders), print
    the second pass's counts and rate, and return its results."""
    caps = build_stream(dual, n_caps, reps)
    total = sum(c.shape[-1] for c in caps)
    rx = (MimoReceiver(mu_pos=0, mu_gid=2, device=device) if dual
          else SisoReceiver(mu_pos=0, mu_gid=2, device=device))
    print(f"{'dual-chain' if dual else 'siso'} stream: "
          f"{len(caps)} captures, {total/1e6:.1f} M samples")
    rx.decode_captures(caps)                    # warm: builds the decoders
    t = time.perf_counter()
    results = rx.decode_captures(caps)
    dt = time.perf_counter() - t
    n_ok = sum(1 for res in results for r in res if r.fcs_ok)
    n_mu = sum(1 for res in results for r in res if r.mu and r.fcs_ok)
    kinds = {}
    for res in results:
        for r in res:
            if r.fcs_ok:
                key = (f"{r.fmt.name}{r.mcs}"
                       + ("/MU" if r.mu else "")
                       + (f" {r.psdu and len(r.psdu)}B"))
                kinds[key] = kinds.get(key, 0) + 1
    print(f"decoded {n_ok} packets ({n_mu} MU) in {dt*1e3:.0f} ms "
          f"= {total/dt/1e6:.1f} Msps sustained")
    for k, v in sorted(kinds.items()):
        print(f"  {v:4d} x {k}")
    print("stats:", rx.stats.summary())
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dual", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    main(args.dual, args.device)
