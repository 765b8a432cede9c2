"""Floor probe of the Viterbi kernel: its skeleton with the add-compare-select
replaced by one add, timed beside the real kernel on the same input.

    python -m ieee80211_tpu_torch.perf.vit_floor

Port of perf_vit_floor.py (TPU kernel :14, `pallas_call` :37). The probe
runs csrc/viterbi.cu's skeleton (one warp per packet and per thread block,
lane l on states l and l + 32, LLRs staged through shared memory a chunk
ahead, path metrics double-buffered in shared memory with one __syncwarp
per block) with the add-compare-select taken out: no branch-metric table,
no candidates, no renorm, no survivors, no traceback. Its device time on
the Viterbi kernel's own input is therefore the floor under that kernel's,
and `device_share` (probe / Viterbi device time) the part of the Viterbi's
time that its skeleton alone takes. Needs a CUDA card: without one, main()
exits 1.
"""
from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from ..ops import coding
from ..ops.cuda import vit_floor as kf
from ..ops.cuda.viterbi import viterbi_pairs_cuda
from .timing import cuda_ms, device_ms, host_us

# The TPU probe's shape: 1024 packets x 1176 blocks of 4 trellis steps
# (4704 steps, the headline 4680-bit DATA decode rounded up) x 8 LLRs.
N_PACKETS = 1024
N_BLK = 1176


def vit_floor_plain(lp: torch.Tensor) -> torch.Tensor:
    """Plain probe: [B, n_blk, 2k] float32 -> int32 [B, 64] (every entry
    n_blk), a loop over blocks in the kernel's float32 order."""
    b, n_blk, c = lp.shape
    m = torch.zeros((b, 64), dtype=torch.float32, device=lp.device)
    for t in range(n_blk):
        s = lp[:, t, 0]
        for i in range(1, c):
            s = s + lp[:, t, i]
        m = (m + (s * 1e-30)[:, None]) + 1.0
    return m.to(torch.int32)


def vit_floor(lp: torch.Tensor) -> torch.Tensor:
    """The probe on any device: the plain version on a CPU tensor, the
    kernel (which raises on what it does not take) on any other."""
    if lp.device.type == "cpu":
        return vit_floor_plain(lp)
    return kf.vit_floor_cuda(lp)


def probe_input(device, seed: int = 0) -> torch.Tensor:
    """Standard-normal LLR blocks [N_PACKETS, N_BLK, 8] float32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N_PACKETS, N_BLK, 2 * kf.K)).astype(np.float32)
    return torch.from_numpy(x).to(device)


def measure(device) -> dict:
    """Check the kernel against its plain version at the probe's shape, then
    time the probe (the probe run: its launches are counted), the plain
    version, and the radix-4 Viterbi kernel on the same memory read as
    depunctured pairs [N_PACKETS, 4 * N_BLK, 2]: each kernel per wrapper
    call between CUDA events ("ms", "viterbi_ms") and on the device alone
    ("device_ms", "viterbi_device_ms"), and the host's time to issue one
    probe call ("host_us")."""
    lp = probe_input(device)
    got = kf.vit_floor_cuda(lp)
    ref = vit_floor_plain(lp)
    torch.cuda.synchronize()
    if not (torch.equal(got, ref) and bool((ref == N_BLK).all())):
        raise RuntimeError("floor probe kernel != plain version")
    w0, w1 = (torch.from_numpy(a).to(device)
              for a in coding._radix_tables(coding.RADIX))
    pairs = lp.view(N_PACKETS, N_BLK * kf.K, 2)
    kf.LAUNCHES = 0
    floor_ms = cuda_ms(lambda: kf.vit_floor_cuda(lp))
    floor_dev = device_ms(lambda: kf.vit_floor_cuda(lp))
    launches = kf.LAUNCHES
    floor_host = host_us(lambda: kf.vit_floor_cuda(lp))

    def vit():
        return viterbi_pairs_cuda(pairs, w0, w1, coding.RENORM)

    vit_ms, vit_dev = cuda_ms(vit), device_ms(vit)
    plain_ms = cuda_ms(lambda: vit_floor_plain(lp), iters=3, warmup=1)
    return {"shape": tuple(lp.shape), "launches": launches,
            "max_abs_err": int((got - ref).abs().max()),
            "ms": floor_ms, "host_us": floor_host, "device_ms": floor_dev,
            "plain_ms": plain_ms,
            "viterbi_ms": vit_ms, "viterbi_device_ms": vit_dev,
            "device_share": floor_dev / vit_dev}


def main() -> int:
    if not torch.cuda.is_available():
        print("vit_floor: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    r = measure(torch.device("cuda:0"))
    b, n_blk, _ = r["shape"]
    print(f"floor probe [{b} x {n_blk} blocks x 8]: kernel == plain; "
          f"probe {r['ms']:.4f} ms (device {r['device_ms']:.4f} ms), plain "
          f"{r['plain_ms']:.4f} ms, viterbi_r4 on [{b} x {n_blk * kf.K} x 2] "
          f"{r['viterbi_ms']:.4f} ms (device {r['viterbi_device_ms']:.4f} "
          f"ms), probe / viterbi device time {r['device_share']:.4f} "
          f"({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
