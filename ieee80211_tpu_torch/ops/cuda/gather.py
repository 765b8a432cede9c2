"""Wrappers of the window-slice CUDA kernel (csrc/gather.cu): per-row,
shared-source and multi-chain.

Replaces the TPU kernel ieee80211_tpu/ops/pallas/gather.py
(`batch_slice_iq_pallas` :95, `_build_call` :77), and the vmapped
dynamic_slices of ieee80211_tpu/rx/receiver.py::capture_windows (:354) and
`capture_windows_mimo` (:368). Starts may be int32 or int64: the kernel
reads either, so no cast is launched.
"""
from __future__ import annotations

import torch

from .build import launch

LAUNCHES = 0          # per-row launches so far: a run can show that it
SHARED_LAUNCHES = 0   # went through each mode
MULTI_LAUNCHES = 0
INT_MAX = 2**31 - 1   # windows (the grid's x extent), windows x chains and
                      # N are C ints
MAX_CHAINS = 65535    # the grid's z extent: one layer per chain
_STARTS = (torch.int32, torch.int64)


def _launch(x: torch.Tensor, start: torch.Tensor, length: int, windows: int,
            chains: int, n: int, per_row: int,
            out_shape: tuple) -> torch.Tensor:
    """Raise on what the kernel does not take, then allocate the output and
    launch (none for no windows)."""
    if not x.is_cuda:
        raise ValueError(f"slice kernel needs a CUDA tensor, got {x.device}")
    if x.dtype is not torch.float32 or x.shape[-1] != 2:
        raise ValueError(f"expected float32 [..., N, 2], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() & 7:
        raise ValueError("I/Q rows must be contiguous and 8-byte aligned")
    if not 0 < length <= n:
        raise ValueError(f"window length {length} outside (0, {n}]")
    if n > INT_MAX or windows * chains > INT_MAX:
        raise ValueError(f"{windows} x {chains} windows of a {n}-sample "
                         f"source exceed {INT_MAX}")
    if start.dtype not in _STARTS:
        raise ValueError(f"starts must be int32 or int64, got {start.dtype}")
    device = x.get_device()
    if start.shape != (windows,) or start.get_device() != device:
        raise ValueError(f"starts must be [{windows}] on the samples' "
                         f"device, got {tuple(start.shape)} on "
                         f"{start.device}")
    out = x.new_empty(out_shape)
    if windows:
        start = start.contiguous()
        launch("slice_iq_launch", device, x.data_ptr(), start.data_ptr(),
               start.dtype is torch.int64, out.data_ptr(), windows, chains,
               n, length, per_row)
    return out


def batch_slice_iq_cuda(x2: torch.Tensor, start: torch.Tensor,
                        length: int) -> torch.Tensor:
    """out[b] = x2[b, s_b : s_b + length], s_b = clip(start[b], 0, N - length):
    [B, N, 2] float32 -> [B, length, 2] on the card."""
    global LAUNCHES
    if x2.dim() != 3:
        raise ValueError(f"expected [B, N, 2], got {tuple(x2.shape)}")
    b, n, _ = x2.shape
    out = _launch(x2, start, length, b, 1, n, 1, (b, length, 2))
    if b:
        LAUNCHES += 1
    return out


def capture_slice_iq_cuda(cap: torch.Tensor, start: torch.Tensor,
                          length: int) -> torch.Tensor:
    """out[g] = cap[s_g : s_g + length], s_g = clip(start[g], 0, N - length):
    one [N, 2] float32 capture, G starts -> [G, length, 2] on the card."""
    global SHARED_LAUNCHES
    if cap.dim() != 2 or start.dim() != 1:
        raise ValueError(f"expected [N, 2] and [G] starts, got "
                         f"{tuple(cap.shape)} and {tuple(start.shape)}")
    g = start.shape[0]
    out = _launch(cap, start, length, g, 1, cap.shape[0], 0, (g, length, 2))
    if g:
        SHARED_LAUNCHES += 1
    return out


def capture_slice_iq_mimo_cuda(cap: torch.Tensor, start: torch.Tensor,
                               length: int) -> torch.Tensor:
    """out[g, r] = cap[r, s_g : s_g + length], s_g = clip(start[g], 0,
    N - length): an [R, N, 2] float32 multi-chain capture, G starts ->
    [G, R, length, 2] on the card, in one launch."""
    global MULTI_LAUNCHES
    if cap.dim() != 3 or start.dim() != 1:
        raise ValueError(f"expected [R, N, 2] and [G] starts, got "
                         f"{tuple(cap.shape)} and {tuple(start.shape)}")
    chains, n, _ = cap.shape
    if not 0 < chains <= MAX_CHAINS:
        raise ValueError(f"{chains} chains outside (0, {MAX_CHAINS}]")
    g = start.shape[0]
    out = _launch(cap, start, length, g, chains, n, 0,
                  (g, chains, length, 2))
    if g:
        MULTI_LAUNCHES += 1
    return out
