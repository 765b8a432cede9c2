"""Wrapper of the radix-4 soft-Viterbi CUDA kernel (csrc/viterbi.cu).

Replaces the TPU kernel ieee80211_tpu/ops/pallas/viterbi.py
(`viterbi_decode_pallas` :311, `_build_call` :263). Depuncturing and the
padding to a multiple of k stay in PyTorch (ops/coding.py), as they stay in
JAX around the TPU kernel; the kernel takes the depunctured pairs.
"""
from __future__ import annotations

import torch

from .build import launch

LAUNCHES = 0   # kernel launches so far: a run can show that it went through
K = 4          # the kernel's radix


def viterbi_pairs_cuda(lp: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor,
                       renorm: int) -> torch.Tensor:
    """Decode depunctured pairs [B, T, 2] float32 (T a multiple of 4) on the
    card: bits [B, T] int32, equal bit for bit to
    `ops.coding.viterbi_pairs_plain(lp, w0, w1, renorm)`."""
    global LAUNCHES
    if not lp.is_cuda:
        raise ValueError(f"viterbi kernel needs a CUDA tensor, got "
                         f"{lp.device}")
    if lp.dtype is not torch.float32 or lp.dim() != 3 or lp.shape[2] != 2:
        raise ValueError(f"expected float32 [B, T, 2], got {lp.dtype} "
                         f"{tuple(lp.shape)}")
    if not lp.is_contiguous():
        raise ValueError("LLR pairs must be contiguous")
    if w0.shape != (64, 1 << K, K) or w1.shape != w0.shape:
        raise ValueError(f"the kernel is radix {K}: tables must be "
                         f"[64, {1 << K}, {K}], got {tuple(w0.shape)}")
    device = lp.get_device()
    if w0.get_device() != device or w1.get_device() != device:
        raise ValueError("radix tables must lie on the LLRs' device")
    if (w0.dtype is not torch.float32 or w1.dtype is not torch.float32
            or not (w0.is_contiguous() and w1.is_contiguous())):
        raise ValueError("radix tables must be contiguous float32")
    b, t_pad, _ = lp.shape
    if t_pad % K:
        raise ValueError(f"trellis length {t_pad} is not a multiple of {K}")
    if renorm < 1:
        raise ValueError(f"renorm period must be >= 1, got {renorm}")
    n_blk = t_pad // K
    bits = lp.new_empty((b, t_pad), dtype=torch.int32)
    if b == 0 or n_blk == 0:
        return bits
    # the kernel reads a block's LLRs, and a table row, as float4s
    if lp.data_ptr() & 15:
        lp = lp.clone()
    if w0.data_ptr() & 15:
        w0 = w0.clone()
    if w1.data_ptr() & 15:
        w1 = w1.clone()
    # survivor decisions in device memory: 4 bits per state per block, one
    # 32-bit word per lane (states l and l + 32) per group of 4 blocks
    dec = lp.new_empty((b, -(-n_blk // 4), 32), dtype=torch.int32)
    launch("viterbi_r4_launch", device, lp.data_ptr(), w0.data_ptr(),
           w1.data_ptr(), dec.data_ptr(), bits.data_ptr(), b, n_blk, renorm)
    LAUNCHES += 1
    return bits
