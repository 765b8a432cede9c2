"""Wrapper of the Viterbi floor-probe CUDA kernel (csrc/vit_floor.cu).

Replaces the TPU probe perf_vit_floor.py::main (kernel :14, `pallas_call`
:37). The plain version and the probe's entry point are in
ieee80211_tpu_torch/perf/vit_floor.py.
"""
from __future__ import annotations

import torch

from .build import launch

LAUNCHES = 0   # kernel launches so far: a run can show that it went through
K = 4          # trellis steps per block, as the Viterbi kernel's radix


def vit_floor_cuda(lp: torch.Tensor) -> torch.Tensor:
    """Run the probe on LLR blocks [B, n_blk, 2k] float32 on the card:
    int32 [B, 64], every entry n_blk, equal to
    `perf.vit_floor.vit_floor_plain(lp)`."""
    global LAUNCHES
    if not lp.is_cuda:
        raise ValueError(f"floor probe needs a CUDA tensor, got {lp.device}")
    if lp.dtype is not torch.float32 or lp.dim() != 3 or lp.shape[2] != 2 * K:
        raise ValueError(f"expected float32 [B, n_blk, {2 * K}], got "
                         f"{lp.dtype} {tuple(lp.shape)}")
    if not lp.is_contiguous():
        raise ValueError("LLR blocks must be contiguous")
    b, n_blk, _ = lp.shape
    out = lp.new_empty((b, 64), dtype=torch.int32)
    if b == 0:
        return out
    if lp.data_ptr() & 15:   # the kernel reads a block's LLRs as float4s
        lp = lp.clone()
    launch("vit_floor_launch", lp.get_device(), lp.data_ptr(), out.data_ptr(),
           b, n_blk)
    LAUNCHES += 1
    return out
