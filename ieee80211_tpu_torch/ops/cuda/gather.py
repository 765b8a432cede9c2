"""Wrappers of the window-slice CUDA kernel (csrc/gather.cu): per-row,
shared-source and multi-chain.

Replaces the TPU kernel ieee80211_tpu/ops/pallas/gather.py
(`batch_slice_iq_pallas` :95, `_build_call` :77), and the vmapped
dynamic_slices of ieee80211_tpu/rx/receiver.py::capture_windows (:354) and
`capture_windows_mimo` (:368).
"""
from __future__ import annotations

import torch

from .build import check, library

LAUNCHES = 0          # per-row launches so far: a run can show that it
SHARED_LAUNCHES = 0   # went through each mode
MULTI_LAUNCHES = 0
_MAX_ROWS = 65535     # gridDim.y and .z limit: one grid row per window,
                      # one grid layer per chain


def _check(x2: torch.Tensor, start: torch.Tensor, length: int,
           rows: int) -> None:
    if x2.device.type != "cuda":
        raise ValueError(f"slice kernel needs a CUDA tensor, got {x2.device}")
    if x2.dtype != torch.float32 or x2.shape[-1] != 2:
        raise ValueError(f"expected float32 [..., N, 2], got {x2.dtype} "
                         f"{tuple(x2.shape)}")
    if not x2.is_contiguous() or x2.data_ptr() % 8:
        raise ValueError("I/Q rows must be contiguous and 8-byte aligned")
    n = x2.shape[-2]
    if not 0 < length <= n:
        raise ValueError(f"window length {length} outside (0, {n}]")
    if rows > _MAX_ROWS:
        raise ValueError(f"{rows} windows exceed {_MAX_ROWS}")
    if tuple(start.shape) != (rows,) or start.device != x2.device:
        raise ValueError(f"starts must be [{rows}] on the samples' device")
    if start.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"starts must be integers, got {start.dtype}")


def batch_slice_iq_cuda(x2: torch.Tensor, start: torch.Tensor,
                        length: int) -> torch.Tensor:
    """out[b] = x2[b, s_b : s_b + length], s_b = clip(start[b], 0, N - length):
    [B, N, 2] float32 -> [B, length, 2] on the card."""
    global LAUNCHES
    if x2.dim() != 3:
        raise ValueError(f"expected [B, N, 2], got {tuple(x2.shape)}")
    b, n, _ = x2.shape
    _check(x2, start, length, b)
    starts = start.to(torch.int32).contiguous()
    out = torch.empty((b, length, 2), dtype=torch.float32, device=x2.device)
    if b == 0:
        return out
    lib = library()
    with torch.cuda.device(x2.device):
        err = lib.slice_iq_launch(
            x2.data_ptr(), starts.data_ptr(), out.data_ptr(), b, n, length,
            torch.cuda.current_stream().cuda_stream)
    check(lib, err, "slice_iq_launch")
    LAUNCHES += 1
    return out


def capture_slice_iq_cuda(cap: torch.Tensor, start: torch.Tensor,
                          length: int) -> torch.Tensor:
    """out[g] = cap[s_g : s_g + length], s_g = clip(start[g], 0, N - length):
    one [N, 2] float32 capture, G starts -> [G, length, 2] on the card."""
    global SHARED_LAUNCHES
    if cap.dim() != 2:
        raise ValueError(f"expected [N, 2], got {tuple(cap.shape)}")
    g = start.shape[0] if start.dim() == 1 else -1
    _check(cap, start, length, g)
    starts = start.to(torch.int32).contiguous()
    out = torch.empty((g, length, 2), dtype=torch.float32, device=cap.device)
    if g == 0:
        return out
    lib = library()
    with torch.cuda.device(cap.device):
        err = lib.slice_iq_shared_launch(
            cap.data_ptr(), starts.data_ptr(), out.data_ptr(), g,
            cap.shape[0], length, torch.cuda.current_stream().cuda_stream)
    check(lib, err, "slice_iq_shared_launch")
    SHARED_LAUNCHES += 1
    return out


def capture_slice_iq_mimo_cuda(cap: torch.Tensor, start: torch.Tensor,
                               length: int) -> torch.Tensor:
    """out[g, r] = cap[r, s_g : s_g + length], s_g = clip(start[g], 0,
    N - length): an [R, N, 2] float32 multi-chain capture, G starts ->
    [G, R, length, 2] on the card, in one launch."""
    global MULTI_LAUNCHES
    if cap.dim() != 3:
        raise ValueError(f"expected [R, N, 2], got {tuple(cap.shape)}")
    chains = cap.shape[0]
    g = start.shape[0] if start.dim() == 1 else -1
    _check(cap, start, length, g)
    if not 0 < chains <= _MAX_ROWS:
        raise ValueError(f"{chains} chains outside (0, {_MAX_ROWS}]")
    starts = start.to(torch.int32).contiguous()
    out = torch.empty((g, chains, length, 2), dtype=torch.float32,
                      device=cap.device)
    if g == 0:
        return out
    lib = library()
    with torch.cuda.device(cap.device):
        err = lib.slice_iq_multi_launch(
            cap.data_ptr(), starts.data_ptr(), out.data_ptr(), g, chains,
            cap.shape[1], length, torch.cuda.current_stream().cuda_stream)
    check(lib, err, "slice_iq_multi_launch")
    MULTI_LAUNCHES += 1
    return out
