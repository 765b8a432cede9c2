"""Wrapper of the per-row window-slice CUDA kernel (csrc/gather.cu).

Replaces the TPU kernel ieee80211_tpu/ops/pallas/gather.py
(`batch_slice_iq_pallas` :95, `_build_call` :77).
"""
from __future__ import annotations

import torch

from .build import check, library

LAUNCHES = 0   # kernel launches so far: a run can show that it went through
_MAX_ROWS = 65535   # gridDim.y limit: one grid row per batch row


def batch_slice_iq_cuda(x2: torch.Tensor, start: torch.Tensor,
                        length: int) -> torch.Tensor:
    """out[b] = x2[b, s_b : s_b + length], s_b = clip(start[b], 0, N - length):
    [B, N, 2] float32 -> [B, length, 2] on the card."""
    global LAUNCHES
    if x2.device.type != "cuda":
        raise ValueError(f"slice kernel needs a CUDA tensor, got {x2.device}")
    if x2.dtype != torch.float32 or x2.dim() != 3 or x2.shape[2] != 2:
        raise ValueError(f"expected float32 [B, N, 2], got {x2.dtype} "
                         f"{tuple(x2.shape)}")
    if not x2.is_contiguous() or x2.data_ptr() % 8:
        raise ValueError("I/Q rows must be contiguous and 8-byte aligned")
    b, n, _ = x2.shape
    if not 0 < length <= n:
        raise ValueError(f"window length {length} outside (0, {n}]")
    if b > _MAX_ROWS:
        raise ValueError(f"batch {b} exceeds {_MAX_ROWS} rows")
    if tuple(start.shape) != (b,) or start.device != x2.device:
        raise ValueError("starts must be [B] on the samples' device")
    if start.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"starts must be integers, got {start.dtype}")
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
