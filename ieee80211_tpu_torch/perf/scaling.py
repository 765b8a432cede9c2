"""Multi-device scaling-efficiency harness.

Port of ieee80211_tpu/perf/scaling.py (`_packet_batch` :26,
`measure_scaling` :46, `main` :80). Measures batched RX decode throughput of
`parallel.sharded_rx` over a ("dp", "sp") mesh of the first n ranks of the
world at increasing n, and reports efficiency against the one-rank rate.
As in the JAX harness the meshes are dp only (sp = 1), `batch_per_device`
packets per rank. Every rank of the world calls it (the meshes are made
collectively); ranks outside a mesh wait for its rate. On the card each
call is timed between CUDA events; on the CPU (`device="cpu"`, the tests'
gloo ranks) on the host's clock. A call's time is its slowest rank's, and
the cut of each rank's rows from the global batch is timed apart
(`scaling_runs`).

    torchrun --nproc-per-node N -m ieee80211_tpu_torch.perf.scaling
    python -m ieee80211_tpu_torch.perf.scaling        # one rank
    ... [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import init_distributed, make_phy_mesh, sharded_rx
from ..parallel.mesh import ensure_process_group
from ..specs import F, Mod
from ..specs.modulation import ppdu_params_nonaggregate
from ..utils.device import entry_device
from .bench import card_info
from .timing import median_ms


def _packet_batch(batch: int):
    """`batch` copies of one L MCS7 packet's window (the 120-byte UDP
    payload, CFO 9 kHz), triggered 8 samples early: (mod, ppdu params,
    x2 [batch, W, 2] float32, t0 [batch] int32)."""
    from ..mac import MacConfig, build_udp_mpdu
    from ..models import RxPipeline
    from ..tx import finalize, gen_mpdu
    from ..utils import c2r
    cfg = MacConfig(addr1="f4:69:d5:80:0f:a0", addr2="00:c0:ca:b1:5b:e1",
                    addr3="f4:69:d5:80:0f:a0", seq=2704)
    mpdu = build_udp_mpdu(b"123456789012345678901234567890" * 4, cfg)
    mod = Mod(F.L, 7)
    pp = ppdu_params_nonaggregate(mod, len(mpdu))
    wave = finalize(gen_mpdu(mpdu, mod).waveform, multiplier=0.2,
                    cfo_hz=9000.0, gap=True, gap_len=64)[0]
    w = RxPipeline(mod, pp.n_sym, pp.psdu_len, device="cpu").window_len()
    seg = wave[64 - 8:]
    x = np.zeros((batch, w), dtype=np.complex64)
    x[:, :min(w, len(seg))] = seg[:min(w, len(seg))]
    return mod, pp, c2r(x), np.zeros(batch, dtype=np.int32)


def scaling_runs(device_counts: Optional[Sequence[int]] = None,
                 batch_per_device: int = 256, iters: int = 5, *,
                 device=None) -> Dict[int, dict]:
    """The sharded RX step on the first n ranks of the world for each n:
    {n: {"samples_per_s", "ms", "ranks_ms", "slice_ms"}}, the same dict on
    every rank. Each rank of the mesh times the median of `iters` calls
    after one warm-up; a call costs what its slowest rank takes, so "ms"
    (and the rate from it) is the largest of "ranks_ms". Every rank holds
    the global batch on its own device, and each call cuts the rank's rows
    from it and copies them (JAX's timed call holds an array already
    sharded): "slice_ms" is that cut alone, the slowest rank's median.
    Runs on the card unless `device="cpu"`."""
    dev = entry_device(device)
    ensure_process_group(dev)
    world = dist.get_world_size()
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8) if n <= world]
    mod, pp, x2_one, t0_one = _packet_batch(batch_per_device)
    out: Dict[int, dict] = {}
    for n in device_counts:
        mesh = make_phy_mesh(n, sp=1, device=dev)
        run = sharded_rx(mesh, mod, pp.n_sym)
        mine = None
        if mesh.get_coordinate() is not None:
            x2 = torch.from_numpy(np.tile(x2_one, (n, 1, 1))).to(dev)
            t0 = torch.from_numpy(np.tile(t0_one, n)).to(dev)
            with torch.inference_mode():
                run(x2, t0)
                mine = (median_ms(lambda: run(x2, t0), dev, iters, warmup=0),
                        median_ms(lambda: run._local(x2, t0), dev, iters))
        got = [None] * world
        dist.all_gather_object(got, mine)
        ranks = [g for g in got if g is not None]
        ms = max(call for call, _ in ranks)
        out[n] = {"samples_per_s": (batch_per_device * n * x2_one.shape[1]
                                    / (ms * 1e-3)),
                  "ms": ms, "ranks_ms": [call for call, _ in ranks],
                  "slice_ms": max(cut for _, cut in ranks)}
    return out


def measure_scaling(device_counts: Optional[Sequence[int]] = None,
                    batch_per_device: int = 256, iters: int = 5, *,
                    device=None) -> Dict[int, float]:
    """Returns {n_devices: samples/sec} for the sharded RX step, from its
    slowest rank (`scaling_runs`), the same dict on every rank. Runs on
    the card unless `device="cpu"`."""
    return {n: r["samples_per_s"] for n, r in scaling_runs(
        device_counts, batch_per_device, iters, device=device).items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    joined = init_distributed(device=args.device)
    dev = entry_device(args.device)
    runs = scaling_runs(device=dev)
    base = runs[1]["samples_per_s"]
    cards = [None] * dist.get_world_size()
    dist.all_gather_object(cards, card_info(dev))
    if dist.get_rank() == 0:
        print(json.dumps({
            "samples_per_sec": {n: r["samples_per_s"] for n, r in
                                runs.items()},
            "efficiency": {n: r["samples_per_s"] / (base * n)
                           for n, r in runs.items()},
            "ms": {n: r["ms"] for n, r in runs.items()},
            "ranks_ms": {n: r["ranks_ms"] for n, r in runs.items()},
            "slice_ms": {n: r["slice_ms"] for n, r in runs.items()},
            "ranks": dist.get_world_size(), "cards": cards}))
    # the 1-rank group of a lone process is destroyed; torchrun's group,
    # after the meshes' sub-groups, is left to the process's exit, as
    # perf.multicard leaves it
    if not joined:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
