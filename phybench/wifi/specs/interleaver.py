"""Interleaver permutations, generated from the standard formulas.

IEEE 802.11-2016 17.3.5.7 (legacy), 19.3.11.8 / 21.3.10.8 (HT/VHT incl.
per-stream frequency rotation). Capability parity with the reference's
precomputed permutation tables (reference lib/cloud80211phy.cc:1407-1831)
— but expressed as gather index vectors so that (de)interleaving a whole
packet is a single `take` along the per-symbol axis.

Conventions:
  interleave:   inter = coded[TX_PERM]     (TX_PERM[j] = source index k)
  deinterleave: coded = inter[RX_PERM]     (RX_PERM[k] = source index j)
RX_PERM is exactly the j(k) map of the standard; TX_PERM its inverse.

The benchmark's frozen copy of ieee80211_tpu_torch/specs/interleaver.py:
the traffic generator builds its packets with it and imports
nothing of the program it measures.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from .enums import F
from .modulation import Mod


def _legacy_jofk(n_cbps: int, n_bpscs: int) -> np.ndarray:
    s = max(1, n_bpscs // 2)
    j_of_k = np.empty(n_cbps, dtype=np.int64)
    for k in range(n_cbps):
        i = (n_cbps // 16) * (k % 16) + k // 16
        j = s * (i // s) + (i + n_cbps - (16 * i // n_cbps)) % s
        j_of_k[k] = j
    return j_of_k


def _nonlegacy_jofk(n_cbpss: int, n_bpscs: int, n_col: int, n_row: int,
                    n_rot: int, iss: int, n_ss: int) -> np.ndarray:
    s = max(1, n_bpscs // 2)
    j_of_k = np.empty(n_cbpss, dtype=np.int64)
    for k in range(n_cbpss):
        i = n_row * (k % n_col) + k // n_col
        j = s * (i // s) + (i + n_cbpss - (n_col * i // n_cbpss)) % s
        r = j
        if n_ss >= 2:
            rot = ((iss * 2) % 3 + 3 * (iss // 3)) * n_rot * n_bpscs
            r = (j - rot) % n_cbpss
        j_of_k[k] = r
    return j_of_k


@lru_cache(maxsize=None)
def rx_perm(mod: Mod, iss: int = 0) -> np.ndarray:
    """Deinterleave gather indices for one OFDM symbol of stream `iss`."""
    if mod.fmt == F.L:
        return _legacy_jofk(mod.nCBPS, mod.nBPSCS)
    return _nonlegacy_jofk(mod.nCBPSS, mod.nBPSCS, mod.intlv_cols,
                           mod.intlv_rows, mod.intlv_rot, iss, mod.nSS)


@lru_cache(maxsize=None)
def tx_perm(mod: Mod, iss: int = 0) -> np.ndarray:
    """Interleave gather indices (inverse of rx_perm)."""
    return np.argsort(rx_perm(mod, iss)).astype(np.int64)


@lru_cache(maxsize=None)
def sig_rx_perm() -> np.ndarray:
    """48-bit BPSK SIG-field deinterleave indices (legacy geometry, s=1)."""
    return _legacy_jofk(48, 1)


@lru_cache(maxsize=None)
def sig_tx_perm() -> np.ndarray:
    return np.argsort(sig_rx_perm()).astype(np.int64)


@lru_cache(maxsize=None)
def stream_parser_maps(mod: Mod):
    """Stream-parser index maps for one OFDM symbol.

    802.11-2016 21.3.10.6: round-robin s-bit blocks from nES encoder outputs
    onto nSS streams. Returns (es_idx, bit_idx) arrays of shape
    [nSS, nCBPSS]: stream iss takes bit `bit_idx[iss, k]` of encoder
    `es_idx[iss, k]` for its k-th coded bit of the symbol.
    """
    s = max(1, mod.nBPSCS // 2)
    cs = mod.nSS * s
    es_idx = np.empty((mod.nSS, mod.nCBPSS), dtype=np.int64)
    bit_idx = np.empty((mod.nSS, mod.nCBPSS), dtype=np.int64)
    for iss in range(mod.nSS):
        for k in range(mod.nCBPSS):
            es_idx[iss, k] = (k // s) % mod.nES
            bit_idx[iss, k] = iss * s + cs * (k // (mod.nES * s)) + (k % s)
    return es_idx, bit_idx


@lru_cache(maxsize=None)
def stream_deparser_maps(mod: Mod):
    """Inverse of the stream parser: per-encoder (ss_idx, pos_idx) gathers.

    Returns arrays of shape [nES, nCBPS // nES]: encoder ies's bit i came
    from stream `ss_idx[ies, i]` position `pos_idx[ies, i]`.
    """
    es_idx, bit_idx = stream_parser_maps(mod)
    n_per_es = mod.nCBPS // mod.nES
    ss_idx = np.full((mod.nES, n_per_es), -1, dtype=np.int64)
    pos_idx = np.full((mod.nES, n_per_es), -1, dtype=np.int64)
    for iss in range(mod.nSS):
        for k in range(mod.nCBPSS):
            ss_idx[es_idx[iss, k], bit_idx[iss, k]] = iss
            pos_idx[es_idx[iss, k], bit_idx[iss, k]] = k
    assert (ss_idx >= 0).all(), "stream parser map not a bijection"
    return ss_idx, pos_idx
