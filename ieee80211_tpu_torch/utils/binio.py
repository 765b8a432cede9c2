"""Capture file IO: interleaved float32 complex bins.

A copy of ieee80211_tpu/utils/binio.py, which cannot be imported where there
is no jax (ieee80211_tpu/utils/__init__.py imports riq.py, which imports
jax); tests/test_torch_examples.py holds the two to the same bytes.

Format-compatible with the reference (tools/phy80211.py:1097-1123
genSigBinFile / phy80211header.py:1397 procLoadComplexBin and GNU Radio
file_source/file_sink).
"""
from __future__ import annotations

import numpy as np


def load_complex_bin(path: str) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.float32)
    return raw[0::2].astype(np.complex64) + 1j * raw[1::2].astype(np.complex64)


def save_complex_bin(path: str, sig: np.ndarray) -> None:
    sig = np.asarray(sig)
    out = np.empty(2 * sig.shape[-1], dtype=np.float32)
    out[0::2] = np.real(sig).astype(np.float32)
    out[1::2] = np.imag(sig).astype(np.float32)
    out.tofile(path)


def save_openwifi_text(path: str, sig: np.ndarray) -> None:
    """Integer 'I Q' text lines for the OpenWiFi TX intf
    (parity: tools/phy80211.py:1160 genSigOwTextFile)."""
    sig = np.asarray(sig)
    with open(path, "w") as f:
        for v in sig:
            f.write(f"{int(np.real(v))} {int(np.imag(v))}\n")


def load_openwifi_text(path: str) -> np.ndarray:
    data = np.loadtxt(path, dtype=np.float64)
    if data.ndim == 1:
        data = data[None, :]
    return (data[:, 0] + 1j * data[:, 1]).astype(np.complex64)
