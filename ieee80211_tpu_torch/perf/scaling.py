"""Multi-device scaling-efficiency harness.

Port of ieee80211_tpu/perf/scaling.py (`_packet_batch` :26,
`measure_scaling` :46, `main` :80). Measures batched RX decode throughput of
`parallel.sharded_rx` over a ("dp", "sp") mesh of the first n ranks of the
world at increasing n, and reports efficiency against the one-rank rate.
Every rank of the world calls it (the meshes are made collectively); ranks
outside a mesh wait for its rate. On the card each call is timed between
CUDA events; on the CPU (`device="cpu"`, the tests' gloo ranks) on the
host's clock.

    torchrun --nproc-per-node N -m ieee80211_tpu_torch.perf.scaling
    python -m ieee80211_tpu_torch.perf.scaling        # one rank
"""
from __future__ import annotations

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
from .timing import call_ms


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


def measure_scaling(device_counts: Optional[Sequence[int]] = None,
                    batch_per_device: int = 256, iters: int = 5, *,
                    device=None) -> Dict[int, float]:
    """Returns {n_devices: samples/sec} for the sharded RX step (median of
    `iters` calls after one warm-up), the same dict on every rank. Runs on
    the card unless `device="cpu"`."""
    dev = entry_device(device)
    ensure_process_group(dev)
    n_avail = dist.get_world_size()
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8) if n <= n_avail]
    mod, pp, x2_one, t0_one = _packet_batch(batch_per_device)
    out: Dict[int, float] = {}
    for n in device_counts:
        mesh = make_phy_mesh(n, sp=1, device=dev)
        run = sharded_rx(mesh, mod, pp.n_sym)
        rate = [None]
        if mesh.get_coordinate() is not None:
            b = batch_per_device * n
            x2 = torch.from_numpy(np.tile(x2_one, (n, 1, 1))).to(dev)
            t0 = torch.from_numpy(np.tile(t0_one, n)).to(dev)
            with torch.inference_mode():
                run(x2, t0)
                dts = [call_ms(lambda: run(x2, t0), dev)[0] / 1e3
                       for _ in range(iters)]
            rate = [b * x2_one.shape[1] / float(np.median(dts))]
        dist.broadcast_object_list(rate, src=0)   # rank 0 is in every mesh
        out[n] = rate[0]
    return out


def main():
    init_distributed()
    rates = measure_scaling()
    base = rates.get(1)
    eff = {n: (r / (base * n) if base else None) for n, r in rates.items()}
    if dist.get_rank() == 0:
        print(json.dumps({"samples_per_sec": rates, "efficiency": eff,
                          "device": torch.cuda.get_device_name(0),
                          "ranks": dist.get_world_size()}))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
