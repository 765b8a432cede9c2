"""The sharded capture loop's branch-dispatch floor, on a 1-rank mesh.

    python -m ieee80211_tpu_torch.perf.branch_floor [--packets K]

Port of perf_generic_r5.py and perf_ab_r4.py::ab_branch_cost (:146-210).

  branch loop  `sharded_capture_decode_auto` with its per-branch decode
               loop and with `generic=True` (one table-driven
               GenericSisoDecoder), at 8, 16 and 25 branches (VHT MCS 0-8,
               HT MCS 0-7, L MCS 0-7, in that order), over a capture of K
               planted packets (the 30-byte UDP MPDU) cycling through the
               branches, k_per_shard 2K
  routed loop  `sharded_capture_decode_auto2` at 8 branches (VHT and HT
               MCS 0, 2, 4, 7) at full width and with branch_cap 16 and 8,
               over a dual-chain capture of K packets through a flat
               channel

Each call is timed between CUDA events (median of ITERS after the first
call, which is gated: every planted packet must decode to its MPDU with
a good FCS; the JAX scripts print only the count of `ok` windows). The
generic decoder cuts its DATA at the VHT offset from every window, so its
loop gets a window as long as `GenericSisoDecoder.window_capacity()` where
the branches need less (ROADMAP.md §3). Runs on the card;
`device="cpu"` runs the same path on the CPU (the tests).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from ..mac import (MacConfig, aggregate_vht, build_udp_mpdu, deaggregate_ht,
                   deaggregate_vht)
from ..parallel import make_phy_mesh
from ..parallel.sharded import (branch_window_len,
                                sharded_capture_decode_auto,
                                sharded_capture_decode_auto2)
from ..rx import MrcDataDecoder
from ..rx.generic import GenericSisoDecoder
from ..specs import F, Mod
from ..specs.crc import fcs_ok
from ..specs.modulation import (ppdu_params_aggregate,
                                ppdu_params_nonaggregate)
from ..tx import finalize, gen_ampdu, gen_mpdu
from ..utils import c2r
from ..utils.device import entry_device
from .bench import MAC, card_info, check
from .timing import median_ms

PACKETS = 64
ITERS = 5
BRANCHES = (8, 16, 25)
ALL_MODS = ([Mod(F.VHT, m) for m in range(9)]
            + [Mod(F.HT, m) for m in range(8)]
            + [Mod(F.L, m) for m in range(8)])
ROUTED_MODS = ([Mod(F.VHT, m) for m in (0, 2, 4, 7)]
               + [Mod(F.HT, m) for m in (0, 2, 4, 7)])
BRANCH_CAPS = (None, 16, 8)


def loop_mpdus(out, row: int = 0, psdu_len=None):
    """The MPDUs of one row's `ok` windows whose FCS holds, in time order,
    as the receivers assemble them (`assemble_psdu`: VHT and MU PSDUs are
    A-MPDUs, HT ones when their aggregation bit is set; the loops'
    `ampdu` is that HT-SIG bit of every window, so a legacy window's is
    junk and is not read); `ok` is SIG consistency, and the FCS drops
    re-trigger junk, as tests/test_sharded_capture.py applies it.
    psdu_len: the one length of a loop without a planner. Returns
    [(window, fmt, [mpdu, ...])]."""
    ok = out["ok"][row].cpu().numpy()
    bits = out["bits"][row].cpu().numpy().astype(np.uint8)
    n = len(ok)
    fmt = out["fmt"][row].cpu().numpy() if "fmt" in out else np.zeros(n)
    vht = fmt == 2
    if "mu" in out:
        vht |= out["mu"][row].cpu().numpy()
    ht_agg = (out["ampdu"][row].cpu().numpy() & (fmt == 1) if "ampdu" in out
              else np.zeros(n, bool))
    lens = (np.full(n, psdu_len) if psdu_len is not None
            else out["psdu_len"][row].cpu().numpy())
    got = []
    for j in np.flatnonzero(ok):
        psdu = np.packbits(bits[j, 16:16 + int(lens[j]) * 8],
                           bitorder="little").tobytes()
        if vht[j] or ht_agg[j]:
            subs = (deaggregate_vht if vht[j] else deaggregate_ht)(psdu)
            mpdus = [s.mpdu for s in subs if s.fcs_ok]
        else:
            mpdus = [psdu] if fcs_ok(psdu) else []
        if mpdus:
            got.append((int(j), int(fmt[j]), mpdus))
    return got


def _mpdu():
    return build_udp_mpdu(b"123456789012345678901234567890",
                          MacConfig(seq=2704, **MAC))


def branches_of(mods, mpdu: bytes):
    """((mod, n_sym), ...): each branch's capacity is its own packet's
    symbols (VHT in an A-MPDU)."""
    ampdu = aggregate_vht([mpdu])
    return tuple((m, (ppdu_params_aggregate(m, len(ampdu))
                      if m.fmt == F.VHT else
                      ppdu_params_nonaggregate(m, len(mpdu))).n_sym)
                 for m in mods)


def loop_capture(mods, packets: int, w: int, dual: bool):
    """perf_generic_r5.py's capture (perf_ab_r4.py's on two chains through
    h1): `packets` packets cycling through mods, CFO 4 kHz x ((i % 5) - 2),
    700 zeros before each, padded to a multiple of 512 past 2w. Returns
    [1, T, 2] or [1, 2, T, 2] float32."""
    mpdu = _mpdu()
    ampdu = aggregate_vht([mpdu])
    h1 = np.array([0.9 - 0.3j, 0.5 + 0.8j])
    parts = []
    for i in range(packets):
        m = mods[i % len(mods)]
        wv = (gen_ampdu(ampdu, m).waveform if m.fmt == F.VHT
              else gen_mpdu(mpdu, m).waveform)
        wv = finalize(wv, multiplier=0.2, cfo_hz=4e3 * ((i % 5) - 2),
                      gap=False)[0]
        if dual:
            parts.append(np.zeros((2, 700), np.complex64))
            parts.append(np.stack([h1[0] * wv, h1[1] * wv]).astype(
                np.complex64))
        else:
            parts.append(np.zeros(700, np.complex64))
            parts.append(wv.astype(np.complex64))
    seg = np.concatenate(parts, axis=-1)
    t_len = -(-(seg.shape[-1] + 2 * w) // 512) * 512
    cap = np.zeros(seg.shape[:-1] + (t_len,), np.complex64)
    cap[..., :seg.shape[-1]] = seg
    return c2r(cap[None])


def _timed(run, x, want, what: str, dev, iters: int) -> dict:
    """The loop's first call, its warm-up, gated (every planted packet
    decodes to its MPDU), then its time per call: the median of
    `iters`."""
    with torch.inference_mode():
        got = [m for _, _, m in loop_mpdus(run(x))]
        check(got == want, f"{what}: {len(got)}/{len(want)} packets decode "
                           f"to their MPDU")
        ms = median_ms(lambda: run(x), dev, iters, warmup=0)
    n = x.shape[-2]
    return {"ms": ms, "samples_per_s": n / (ms * 1e-3),
            "packets": len(got)}


def branch_loop(n_branches: int, packets: int = PACKETS, *, mesh, dev,
                iters: int = ITERS) -> dict:
    """The auto loop with its branch loop and with generic=True, at
    n_branches of ALL_MODS."""
    mods = ALL_MODS[:n_branches]
    mpdu = _mpdu()
    branches = branches_of(mods, mpdu)
    w = max(branch_window_len(m, c) for m, c in branches)
    w_gen = max(w, GenericSisoDecoder(
        tuple((m.fmt, m.mcs) for m in mods), max(c for _, c in branches),
        device="cpu").window_capacity())
    x = torch.from_numpy(loop_capture(mods, packets, w_gen, False)).to(dev)
    out = {"window": w, "generic_window": w_gen, "samples": x.shape[1]}
    for label, generic, win in (("branch_loop", False, w),
                                ("generic", True, w_gen)):
        run = sharded_capture_decode_auto(mesh, branches, win,
                                          k_per_shard=2 * packets,
                                          generic=generic)
        out[label] = _timed(run, x, [[mpdu]] * packets,
                            f"{n_branches} branches {label}", dev, iters)
    return out


def routed_loop(packets: int = PACKETS, caps=BRANCH_CAPS, *, mesh, dev,
                iters: int = ITERS) -> dict:
    """The auto2 loop at 8 branches, full width and with each branch_cap."""
    mpdu = _mpdu()
    branches = branches_of(ROUTED_MODS, mpdu)
    w = max(MrcDataDecoder(m, c).window_capacity() for m, c in branches)
    x = torch.from_numpy(loop_capture(ROUTED_MODS, packets, w, True)).to(dev)
    out = {"window": w, "samples": x.shape[2]}
    for cap in caps:
        run = sharded_capture_decode_auto2(mesh, branches, w,
                                           k_per_shard=2 * packets,
                                           branch_cap=cap)
        out[f"branch_cap={cap}"] = _timed(run, x, [[mpdu]] * packets,
                                          f"auto2 branch_cap={cap}", dev,
                                          iters)
    return out


def measure(branch_counts=BRANCHES, packets: int = PACKETS,
            caps=BRANCH_CAPS, iters: int = ITERS, *, device=None) -> dict:
    """Both loops on a 1-rank mesh of `device` (made here, with its process
    group when none exists; that group is destroyed before returning)."""
    dev = entry_device(device)
    own_group = not dist.is_initialized()
    mesh = make_phy_mesh(device=dev)
    try:
        return {"packets": packets,
                "branch_loop": {n: branch_loop(n, packets, mesh=mesh,
                                               dev=dev, iters=iters)
                                for n in branch_counts},
                "routed": routed_loop(packets, caps, mesh=mesh, dev=dev,
                                      iters=iters)}
    finally:
        if own_group:
            dist.destroy_process_group()


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--packets", type=int, default=PACKETS)
    args = ap.parse_args(argv)
    dev = entry_device(device)
    card = card_info(dev)
    tag = f"({card['name']}, {card['power_limit']})"
    r = measure(packets=args.packets, device=dev)
    for n, b in r["branch_loop"].items():
        for label in ("branch_loop", "generic"):
            t = b[label]
            print(f"{n:2d} branches {label}: {t['ms']:.4f} ms per call, "
                  f"{t['samples_per_s']:.6g} samples/s, {t['packets']}/"
                  f"{r['packets']} packets {tag}")
    for label, t in r["routed"].items():
        if isinstance(t, dict):
            print(f"auto2 8 branches {label}: {t['ms']:.4f} ms per call, "
                  f"{t['samples_per_s']:.6g} samples/s per chain, "
                  f"{t['packets']}/{r['packets']} packets {tag}")
    print(json.dumps({"device": card, **r}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
