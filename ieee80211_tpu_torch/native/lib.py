"""ctypes bindings for the native host runtime (phyrt.cc).

Lazily compiles libphyrt.so with g++ on first use, into the port's
git-ignored ieee80211_tpu_torch/_build/; callers fall back to the
numpy/pure-python implementations when the toolchain is unavailable.

Copy of ieee80211_tpu/native/lib.py: the port imports nothing of the JAX
package, so it carries its own copy; tests/test_torch_native.py holds it
equal to the original.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "phyrt.cc")
_SO = os.path.join(os.path.dirname(_DIR), "_build", "libphyrt.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            # build beside it and rename: processes may build at once
            os.makedirs(os.path.dirname(_SO), exist_ok=True)
            tmp = f"{_SO}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC,
                 "-o", tmp], check=True, capture_output=True)
            os.replace(tmp, _SO)
        lib = ctypes.CDLL(_SO)
        lib.phyrt_find_triggers_lag.restype = ctypes.c_int64
        lib.phyrt_find_triggers_lag.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        lib.phyrt_crc32.restype = ctypes.c_uint32
        lib.phyrt_crc32.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                    ctypes.c_int64]
        lib.phyrt_pack_bits.restype = None
        lib.phyrt_pack_bits.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                        ctypes.c_int64,
                                        ctypes.POINTER(ctypes.c_uint8)]
        lib.phyrt_deagg.restype = ctypes.c_int64
        lib.phyrt_deagg.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.phyrt_quantize_int8.restype = ctypes.c_float
        lib.phyrt_quantize_int8.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int8)]
        lib.phyrt_scan_quantize.restype = ctypes.c_int64
        lib.phyrt_scan_quantize.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_float)]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def find_triggers(x: np.ndarray, thresh: float = 0.5, plateau: int = 20,
                  min_gap: int = 400, max_out: int = 65536, lag: int = 16
                  ) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    if x.dtype == np.complex64:
        # complex64 memory IS interleaved (re, im) float32: zero-copy view
        # instead of a stack() that would copy the whole capture
        iq = np.ascontiguousarray(x).view(np.float32)
    else:
        iq = np.ascontiguousarray(
            np.stack([np.real(x), np.imag(x)], axis=-1), dtype=np.float32)
    out = np.zeros(max_out, dtype=np.int64)
    n = lib.phyrt_find_triggers_lag(
        iq.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x),
        thresh, plateau, min_gap, lag,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_out)
    return out[:n].copy()


def quantize_int8(x: np.ndarray, out: np.ndarray) -> Optional[float]:
    """Peak-normalized int8 quantization of a complex64 capture.

    Writes interleaved (re, im) int8 into `out` (shape [n, 2] or flat 2n)
    and returns the dequantization scale, or None without the native lib.
    """
    lib = _load()
    if lib is None:
        return None
    iq = np.ascontiguousarray(x).view(np.float32)
    return float(lib.phyrt_quantize_int8(
        iq.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))))


def scan_quantize(x: np.ndarray, out: np.ndarray, thresh: float = 0.5,
                  plateau: int = 20, min_gap: int = 400, lag: int = 16,
                  max_out: int = 65536
                  ) -> Optional[Tuple[np.ndarray, float]]:
    """Fused trigger scan + int8 quantization of a complex64 capture.

    Writes interleaved int8 into `out` and returns (trigger_starts,
    dequant_scale), or None without the native lib."""
    lib = _load()
    if lib is None:
        return None
    iq = np.ascontiguousarray(x).view(np.float32)
    trig = np.zeros(max_out, dtype=np.int64)
    scale = ctypes.c_float(0.0)
    n = lib.phyrt_scan_quantize(
        iq.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x),
        thresh, plateau, min_gap, lag,
        trig.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_out,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        ctypes.byref(scale))
    return trig[:n].copy(), float(scale.value)


def crc32(data: bytes) -> Optional[int]:
    lib = _load()
    if lib is None:
        return None
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    if len(buf) == 0:
        return 0
    return int(lib.phyrt_crc32(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf)))


def pack_bits(bits: np.ndarray) -> Optional[bytes]:
    lib = _load()
    if lib is None:
        return None
    b = np.ascontiguousarray(bits, dtype=np.uint8)
    out = np.zeros(len(b) // 8, dtype=np.uint8)
    lib.phyrt_pack_bits(
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(b),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.tobytes()


class _DeaggScratch:
    """Preallocated output buffers + cached ctypes pointers: the per-call
    marshaling (fresh np.zeros + 4x data_as) cost ~20 us/packet on the
    decode_capture assembly path; reusing them cuts it to a few us.
    Thread-LOCAL (deagg feeds the public mac.deaggregate_* functions, so
    external callers may run it from several threads concurrently)."""

    __slots__ = ("cap", "offs", "lens", "oks", "p_offs", "p_lens", "p_oks")

    def __init__(self, cap: int = 256):
        self.cap = cap
        self.offs = np.zeros(cap, dtype=np.int64)
        self.lens = np.zeros(cap, dtype=np.int64)
        self.oks = np.zeros(cap, dtype=np.uint8)
        self.p_offs = self.offs.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64))
        self.p_lens = self.lens.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64))
        self.p_oks = self.oks.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


_deagg_tls = threading.local()


def deagg(psdu: bytes, vht: bool = True, max_sub: int = 64
          ) -> Optional[List[Tuple[int, int, bool]]]:
    """Returns [(offset, length, fcs_ok)] of A-MPDU subframes."""
    lib = _load()
    if lib is None:
        return None
    s = getattr(_deagg_tls, "scratch", None)
    if s is None:
        s = _deagg_tls.scratch = _DeaggScratch()
    if max_sub > s.cap:
        s = _deagg_tls.scratch = _DeaggScratch(max_sub)
    buf = np.frombuffer(psdu if isinstance(psdu, (bytes, bytearray))
                        else bytes(psdu), dtype=np.uint8)
    n = lib.phyrt_deagg(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
        1 if vht else 0, s.p_offs, s.p_lens, s.p_oks,
        min(max_sub, s.cap))
    offs, lens, oks = s.offs, s.lens, s.oks
    return [(int(offs[i]), int(lens[i]), bool(oks[i])) for i in range(n)]
