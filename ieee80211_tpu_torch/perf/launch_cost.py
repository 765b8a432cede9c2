"""Where the host's time goes in one kernel wrapper call: each step of a
per-row slice launch at the receive step's shape [1024 x 2320 -> 2080],
timed alone on the host clock, as the former launch path made it and as
ops/cuda/build.py::launch makes it, beside whole wrapper calls of every
kernel and one torch.gather call that cuts the same windows.

    python -m ieee80211_tpu_torch.perf.launch_cost

The former path, restated here step by step: checks through Tensor.device
objects, `start.to(torch.int32).contiguous()` (a cast launch for int64
starts), `torch.empty(..., device=)`, a `with torch.cuda.device(...)` block
and a `torch.cuda.current_stream()` object around the ctypes call. Every
number is the median of perf/timing.py::HOST_ITERS calls'
`time.perf_counter_ns`, with no synchronize inside a timed call. Needs a
CUDA card: without one, main() exits 1.
"""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from ..ops import coding
from ..ops.cuda import build
from ..ops.cuda import gather as kg
from ..ops.cuda import vit_floor as kf
from ..ops.cuda import viterbi as kv
from .timing import host_us

B, N, L = 1024, 2320, 2080   # the step's per-row slice
VIT_SHAPE = (1024, 4704)     # the headline DATA decode: packets x steps


def _former_checks(x, start, length: int, rows: int) -> None:
    """The former wrapper's checks, through Tensor.device objects."""
    if x.device.type != "cuda":
        raise ValueError("not a CUDA tensor")
    if x.dtype != torch.float32 or x.shape[-1] != 2:
        raise ValueError("not float32 [..., N, 2]")
    if not x.is_contiguous() or x.data_ptr() % 8:
        raise ValueError("not contiguous and 8-byte aligned")
    if not 0 < length <= x.shape[-2] or rows > 65535:
        raise ValueError("length or rows out of range")
    if tuple(start.shape) != (rows,) or start.device != x.device:
        raise ValueError("starts of the wrong shape or device")
    if start.dtype not in (torch.int32, torch.int64):
        raise ValueError("starts not integers")


def measure(device) -> dict:
    """{step: host microseconds}."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((B, N, 2)).astype(np.float32)
                         ).to(device)
    s32 = torch.from_numpy(rng.integers(0, N - L + 1, B).astype(np.int32)
                           ).to(device)
    s64 = s32.long()
    idx = (s64[:, None] + torch.arange(L, device=device))[..., None].expand(
        B, L, 2).contiguous()
    out = torch.empty((B, L, 2), dtype=torch.float32, device=device)
    lib = build.library()
    fn = lib.slice_iq_launch
    args = (x.data_ptr(), s32.data_ptr(), 0, out.data_ptr(), B, 1, N, L, 1)
    dev = x.get_device()
    pairs = torch.from_numpy(rng.standard_normal(VIT_SHAPE + (2,)).astype(
        np.float32)).to(device)
    blocks = pairs.view(VIT_SHAPE[0], -1, 2 * kf.K)
    w0, w1 = (torch.from_numpy(a).to(device)
              for a in coding._radix_tables(coding.RADIX))

    def device_block():
        with torch.cuda.device(x.device):
            pass

    steps = {
        "former: checks": lambda: _former_checks(x, s32, L, B),
        "former: start.to(int32).contiguous(), int32 starts":
            lambda: s32.to(torch.int32).contiguous(),
        "former: start.to(int32).contiguous(), int64 starts":
            lambda: s64.to(torch.int32).contiguous(),
        "former: torch.empty(shape, dtype=, device=)": lambda: torch.empty(
            (B, L, 2), dtype=torch.float32, device=x.device),
        "former: with torch.cuda.device(...)": device_block,
        "former: torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "ctypes call of the launch function": lambda: fn(
            *args, torch._C._cuda_getCurrentRawStream(dev)),
        "ctypes call of a 1-argument function (no launch)":
            lambda: lib.kernels_error_string(0),
        "now: x.new_empty(shape)": lambda: x.new_empty((B, L, 2)),
        "now: x.get_device()": x.get_device,
        "now: torch._C._cuda_getDevice()": torch._C._cuda_getDevice,
        "now: torch._C._cuda_getCurrentRawStream(i)":
            lambda: torch._C._cuda_getCurrentRawStream(dev),
        "now: build.launch(...)": lambda: build.launch(
            "slice_iq_launch", dev, *args),
        "per-row slice wrapper, int32 starts":
            lambda: kg.batch_slice_iq_cuda(x, s32, L),
        "per-row slice wrapper, int64 starts":
            lambda: kg.batch_slice_iq_cuda(x, s64, L),
        "torch.gather of the same windows": lambda: torch.gather(x, 1, idx),
        "viterbi wrapper [1024 x 4704 x 2]": lambda: kv.viterbi_pairs_cuda(
            pairs, w0, w1, coding.RENORM),
        "floor probe wrapper [1024 x 1176 x 8]":
            lambda: kf.vit_floor_cuda(blocks),
    }
    return {k: host_us(f) for k, f in steps.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("launch_cost: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    r = measure(torch.device("cuda:0"))
    for k, v in r.items():
        print(f"host {k}: {v:.3f} us ({card})")
    print(json.dumps({"card": card, "torch": torch.__version__,
                      "host_us": r}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
