"""Build the port's CUDA kernels at first use and load them with ctypes.

Every `*.cu` file under ieee80211_tpu_torch/csrc/ is compiled by nvcc for
`sm_90a` into ONE shared library with a plain C interface (no PyTorch
headers, so the build takes seconds). The library lands in
ieee80211_tpu_torch/_build/ (git-ignored) under a name keyed by the
sources and flags, so an edited source builds anew. Nothing here runs when
the module is imported: the CPU tests import it without nvcc or a GPU.

nvcc is found through $CUDA_HOME, else torch.utils.cpp_extension.CUDA_HOME.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
# -fmad=false: no multiply-add contraction anywhere, so the Viterbi's
# float32 sums round exactly as the plain PyTorch version's
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # name: argtypes (pointers and the stream as c_void_p: a bare Python int
    # would pass as a 32-bit int and cut the pointer)
    "viterbi_r4_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "slice_iq_launch": [_P, _P, _P, _I, _I, _I, _P],
    "slice_iq_shared_launch": [_P, _P, _P, _I, _I, _I, _P],
    "slice_iq_multi_launch": [_P, _P, _P, _I, _I, _I, _I, _P],
    "vit_floor_launch": [_P, _P, _I, _I, _P],
}

_lib = None
build_log = ""   # nvcc's output (ptxas register/shared-memory report)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME
        home = CUDA_HOME
    if not home:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME")
    return os.path.join(home, "bin", "nvcc")


def _build() -> Path:
    global build_log
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"libieee80211_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on the first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.kernels_error_string.argtypes = [ctypes.c_int]
        lib.kernels_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        msg = lib.kernels_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
