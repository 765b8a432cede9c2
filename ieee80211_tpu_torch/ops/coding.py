"""Batched channel-coding ops (PyTorch): soft Viterbi, depuncture, descramble.

Port of ieee80211_tpu/ops/coding.py, with `depuncture_slots` (:84),
`viterbi_decode_pairs` (:186) and `scramble_seed_of` (:285). The numpy
table builders are copies: their JAX module cannot be imported where there
is no jax.

The Viterbi keeps the semantics that the JAX decoder and its TPU kernel
(ieee80211_tpu/ops/pallas/viterbi.py) fix: radix-2^k add-compare-select in
float32, ties keep the lower path index, metrics renormed by their max over
states every `renorm` blocks, traceback from the first best final state
(L/HT streams carry scrambled pad bits after the zero tail, so the encoder
need not end in state 0). On a CUDA tensor the decode runs in the
hand-written kernel (ops/cuda/viterbi.py, csrc/viterbi.cu); on a CPU tensor
it runs the plain version below, which the kernel equals bit for bit.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..specs import CR, tables
from .cuda.viterbi import viterbi_pairs_cuda

NEG = -1e30
RADIX = 4     # trellis steps per ACS block on the main path: the kernel's k
RENORM = 64   # metric renorm period in blocks, as the TPU kernel's RENORM
_BM_CHUNK = 64  # blocks whose branch metrics the plain version forms at once


@lru_cache(maxsize=None)
def _radix_tables(k: int):
    """Tables for a radix-2^k trellis step (k input bits per block).

    After k steps, new state s'' keeps the old state's high 6-k bits in its
    low bits and the k fresh inputs in its high bits; the dropped low k bits
    of the old state enumerate the 2^k candidate paths:
        p = ((s'' mod 2^(6-k)) << k) | path,  inputs b_j = bit (6-k+j) of s''.
    Returns (W0, W1): float32 [64, 2^k, k] output-bit weights of each step
    along each path.
    """
    assert 1 <= k <= 6
    npaths = 1 << k
    w0 = np.zeros((64, npaths, k), dtype=np.float32)
    w1 = np.zeros((64, npaths, k), dtype=np.float32)
    nxt = tables.SV_STATE_NEXT
    out2 = tables.SV_STATE_OUTPUT2
    mask = (1 << (6 - k)) - 1
    for s2 in range(64):
        bits = [(s2 >> (6 - k + j)) & 1 for j in range(k)]
        for path in range(npaths):
            p = ((s2 & mask) << k) | path
            s = p
            for j in range(k):
                o = out2[s, bits[j]]
                w0[s2, path, j] = (o >> 1) & 1
                w1[s2, path, j] = o & 1
                s = nxt[s, bits[j]]
            assert s == s2
    return w0, w1


@lru_cache(maxsize=None)
def depuncture_slots(cr: CR, n_steps: int) -> np.ndarray:
    """Flat indices into a zeroed [n_steps*2] LLR buffer for each surviving
    (punctured-stream) position."""
    pat = tables.PUNCTURE[cr].astype(bool)
    tiled = np.tile(pat, -(-2 * n_steps // len(pat)))[: 2 * n_steps]
    return np.nonzero(tiled)[0].astype(np.int32)


def depuncture(llrs: torch.Tensor, cr: CR, n_steps: int) -> torch.Tensor:
    """[..., n_coded] punctured LLRs -> [..., n_steps, 2] with zeros inserted.

    The puncture pattern is periodic (period <= 10): a reshape to pattern
    cycles and a static per-column select, with no index table on the
    device.
    """
    pat = tables.PUNCTURE[cr].astype(bool)
    period = len(pat)
    n_keep = int(pat.sum())
    batch = tuple(llrs.shape[:-1])
    n_cyc = -(-2 * n_steps // period)
    need = n_cyc * n_keep
    have = llrs.shape[-1]
    if have < need:
        llrs = F.pad(llrs, (0, need - have))
    elif have > need:
        llrs = llrs[..., :need]
    cyc = llrs.reshape(batch + (n_cyc, n_keep))
    zero = llrs.new_zeros(batch + (n_cyc, 1))
    cols = []
    ki = 0
    for p in pat:
        if p:
            cols.append(cyc[..., ki:ki + 1])
            ki += 1
        else:
            cols.append(zero)
    flat = torch.cat(cols, dim=-1).reshape(batch + (n_cyc * period,))
    return flat[..., :2 * n_steps].reshape(batch + (n_steps, 2))


def _pairs(llrs: torch.Tensor, cr: CR, n_bits: int, k: int) -> torch.Tensor:
    """Depunctured pairs [B, T, 2], T = n_bits padded to a multiple of k
    with zero (path-neutral) steps."""
    lp = depuncture(llrs, cr, n_bits)
    t_pad = -(-n_bits // k) * k
    if t_pad != n_bits:
        lp = F.pad(lp, (0, 0, 0, t_pad - n_bits))
    return lp.contiguous()


def viterbi_pairs_plain(lp: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor,
                        renorm: int = RENORM) -> torch.Tensor:
    """Plain radix-2^k Viterbi over depunctured pairs: [B, T, 2] -> [B, T]
    int32, k = w0.shape[-1] and T a multiple of k.

    Counterpart of `_viterbi_core` (renorm=1 renorms after every block, as
    it does) and of the TPU kernel (renorm=64). The branch metric is a sum
    of the selected LLRs in one fixed order, step j = 0..k-1 and then coded
    bit c = 0, 1, formed with selects and adds: the CUDA kernel sums in the
    same order, so the two agree bit for bit.
    """
    b, t_pad, _ = lp.shape
    n_path, k = w0.shape[1], w0.shape[2]
    assert k >= 2 and t_pad % k == 0
    n_blk = t_pad // k
    n_low = 64 // n_path
    dev = lp.device
    sel = torch.stack([w0, w1], dim=-1).reshape(64, n_path, 2 * k) != 0
    lpb = lp.reshape(b, n_blk, 2 * k)
    state_ids = torch.arange(64, device=dev)
    pred = (((state_ids & (n_low - 1)) << k)[:, None]
            | torch.arange(n_path, device=dev)[None, :])    # [64, 2^k]
    m = torch.full((b, 64), NEG, dtype=torch.float32, device=dev)
    m[:, 0] = 0.0
    decs = torch.empty((b, n_blk, 64), dtype=torch.uint8, device=dev)
    zero = lp.new_zeros(())
    for c0 in range(0, n_blk, _BM_CHUNK):
        lc = lpb[:, c0:c0 + _BM_CHUNK, None, None, :]       # [B, C, 1, 1, 2k]
        bm = torch.zeros((b, lc.shape[1], 64, n_path), dtype=torch.float32,
                         device=dev)
        for i in range(2 * k):
            bm = bm + torch.where(sel[:, :, i], lc[..., i], zero)
        for tt in range(lc.shape[1]):
            t = c0 + tt
            m, dec = torch.max(m[:, pred] + bm[:, tt], dim=-1)  # first max
            decs[:, t] = dec
            if t % renorm == renorm - 1:
                m = m - m.amax(dim=-1, keepdim=True)
    state = torch.argmax(m, dim=-1)                          # first best
    shifts = torch.arange(6 - k, 6, device=dev)
    bits = torch.empty((b, n_blk, k), dtype=torch.int32, device=dev)
    for t in range(n_blk - 1, -1, -1):
        bits[:, t] = (state[:, None] >> shifts) & 1
        path = decs[:, t].gather(1, state[:, None])[:, 0].long()
        state = ((state & (n_low - 1)) << k) + path
    return bits.reshape(b, t_pad)


def viterbi_decode_plain(llrs: torch.Tensor, cr: CR, n_bits: int,
                         w0: torch.Tensor, w1: torch.Tensor,
                         renorm: int = RENORM) -> torch.Tensor:
    """`viterbi_decode` through the plain version on any device."""
    lp = _pairs(llrs, cr, n_bits, w0.shape[-1])
    return viterbi_pairs_plain(lp, w0, w1, renorm)[:, :n_bits]


def viterbi_decode(llrs: torch.Tensor, cr: CR, n_bits: int,
                   w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """Soft Viterbi decode of a zero-terminated BCC stream.

    llrs: [B, n_coded] float32 punctured soft bits (positive = bit 1).
    (w0, w1): `_radix_tables(k)` as tensors on the device of llrs; k is the
    radix. Returns decoded bits [B, n_bits] int32.

    A CPU tensor runs the plain version; a CUDA tensor launches the radix-4
    kernel, which raises on anything it does not take. The renorm period
    follows the radix as in the JAX package: every 64 blocks at radix 4 (the
    TPU kernel), every block below it (`_viterbi_core`, the JAX decoder on
    the CPU at radix 3), so radix-3 tables reproduce the JAX CPU decoder.
    """
    return _decode_pairs(_pairs(llrs, cr, n_bits, w0.shape[-1]), w0,
                         w1)[:, :n_bits]


def _decode_pairs(lp: torch.Tensor, w0: torch.Tensor,
                  w1: torch.Tensor) -> torch.Tensor:
    """Pairs [B, T, 2] (T a multiple of the radix) -> bits [B, T]: the plain
    version on a CPU tensor, the kernel on any other, at the radix's renorm
    period."""
    k = w0.shape[-1]
    if lp.device.type == "cpu":
        return viterbi_pairs_plain(lp, w0, w1, RENORM if k == RADIX else 1)
    return viterbi_pairs_cuda(lp, w0, w1, RENORM)


def viterbi_decode_pairs(lp: torch.Tensor, n_bits: int, w0: torch.Tensor,
                         w1: torch.Tensor) -> torch.Tensor:
    """viterbi_decode for PRE-DEPUNCTURED LLR pairs [B, n_bits, 2]
    (punctured slots already zero): the generic multi-config decoder
    (rx/generic.py) folds depuncturing into its per-window gather. Pads to
    a multiple of the radix with zero (path-neutral) steps and decodes as
    `viterbi_decode` does. Returns bits [B, n_bits] int32."""
    k = w0.shape[-1]
    t_pad = -(-n_bits // k) * k
    lp = lp[:, :n_bits]
    if t_pad != n_bits:
        lp = F.pad(lp, (0, 0, 0, t_pad - n_bits))
    return _decode_pairs(lp.contiguous(), w0, w1)[:, :n_bits]


# ---------------------------------------------------------------------------
# scrambler (closed-form)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _seed_from_first7() -> np.ndarray:
    """Map the first 7 PRBS bits (LSB-first packed) -> scrambler seed."""
    inv = np.zeros(128, dtype=np.int32)
    for seed in range(1, 128):
        key = 0
        for i in range(7):
            key |= int(tables.SCRAMBLE_SEQ[seed, i]) << i
        inv[key] = seed
    return inv


@lru_cache(maxsize=None)
def _prbs_tiled(n: int) -> np.ndarray:
    reps = -(-n // 127)
    return np.stack([np.tile(tables.SCRAMBLE_SEQ[s], reps)[:n]
                     for s in range(128)]).astype(np.int32)


def descramble(bits: torch.Tensor, prbs: torch.Tensor,
               seed_inv: torch.Tensor) -> torch.Tensor:
    """Recover the scrambler seed from the first 7 (known-zero) service bits
    and remove the PRBS. bits: [B, N] int32 -> [B, N] int32.

    prbs: `_prbs_tiled(N)` and seed_inv: `_seed_from_first7()`, as tensors
    on the device of bits. The seed selects a PRBS row (a row gather; the
    JAX package's one-hot matmul was a choice for the TPU's matrix unit).
    """
    return bits ^ prbs[scramble_seed_of(bits, seed_inv).long()]


def scramble_seed_of(bits: torch.Tensor,
                     seed_inv: torch.Tensor) -> torch.Tensor:
    """The scrambler seed [B] of scrambled DATA bits [B, N], read from
    their first 7 service bits (zero before scrambling); seed_inv:
    `_seed_from_first7()` as a tensor on the bits' device."""
    weights = torch.arange(7, device=bits.device)
    key = (bits[:, :7].long() << weights).sum(dim=-1)
    return seed_inv[key]
