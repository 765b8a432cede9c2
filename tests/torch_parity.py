"""Shared helpers of the tests that hold the PyTorch port
(`ieee80211_tpu_torch`) against the JAX package (tests/test_torch_*.py).
Not collected by pytest. Inputs are made with numpy and passed to both
packages as numpy arrays; JAX stays on the CPU (tests/conftest.py).
"""
import numpy as np
import torch

from ieee80211_tpu.mac import deaggregate_vht
from ieee80211_tpu.specs import F
from ieee80211_tpu.specs.crc import fcs_ok
from ieee80211_tpu.tx.golden import bcc

# tier-1 runs several pytest workers on one host: keep each one's torch
# intra-op pool small
torch.set_num_threads(2)


def encode_batch(rng, batch: int, n_bits: int, cr, sigma: float = 0.2):
    """Random zero-terminated BCC streams -> (true bits, noisy LLRs)."""
    bits = rng.integers(0, 2, size=(batch, n_bits)).astype(np.int32)
    bits[:, -6:] = 0
    punct = np.stack([bcc(row, cr) for row in bits])
    llr = (punct * 2.0 - 1.0) + rng.normal(0, sigma, punct.shape)
    return bits, llr.astype(np.float32)


def radix_tensors(k: int, device="cpu"):
    """The port's radix-2^k tables (w0, w1) as tensors."""
    from ieee80211_tpu_torch.ops.coding import _radix_tables
    w0, w1 = _radix_tables(k)
    return (torch.from_numpy(w0).to(device), torch.from_numpy(w1).to(device))


def mpdu_decoded(bits_row, psdu_len: int, mpdu: bytes, fmt) -> bool:
    """Descrambled DATA bits of one packet -> exact MPDU with a good FCS."""
    psdu = np.packbits(np.asarray(bits_row)[16:16 + psdu_len * 8]
                       .astype(np.uint8), bitorder="little").tobytes()
    if fmt == F.VHT:
        subs = deaggregate_vht(psdu)
        return bool(subs) and subs[0].fcs_ok and subs[0].mpdu == mpdu
    return fcs_ok(psdu) and psdu == mpdu
