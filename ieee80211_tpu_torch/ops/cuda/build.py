"""Build the port's CUDA kernels at first use, and launch them.

Every `*.cu` file under ieee80211_tpu_torch/csrc/ is compiled by nvcc for
`sm_90a` into ONE shared library with a plain C interface (no PyTorch
headers, so the build takes seconds). The library lands in
ieee80211_tpu_torch/_build/ (git-ignored) under a name keyed by the
sources and flags, so an edited source builds anew. Nothing here runs when
the module is imported: the CPU tests import it without nvcc or a GPU.

nvcc is found through $CUDA_HOME, else torch.utils.cpp_extension.CUDA_HOME.

The launch path, shared by every wrapper in ops/cuda/ (`launch`): each
launch function is resolved once, with its argument types; PyTorch's
current stream of the tensor's card is read as a raw handle (not as a
torch.cuda.Stream object); the card is switched only when it is not the
current one. Each launch function returns cudaGetLastError(), and `launch`
raises when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
# -fmad=false: no multiply-add contraction anywhere, so the Viterbi's
# float32 sums round exactly as the plain PyTorch version's
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# every extern "C" launch function of csrc/*.cu: its argument types, the
# stream last (pointers and the stream as c_void_p: a bare Python int would
# pass as a 32-bit int and cut the pointer)
SIGNATURES = {
    "viterbi_r4_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "slice_iq_launch": [_P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
    "vit_floor_launch": [_P, _P, _I, _I, _P],
}

_lib = None
_fns = {}        # launch function name -> its ctypes function
_current_device = _raw_stream = None   # PyTorch's, bound at the first launch
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
    """The kernels' shared library, built on the first call, with the
    argument types of every launch function set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.kernels_error_string.argtypes = [ctypes.c_int]
        lib.kernels_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _resolve(name: str):
    """Launch function `name`, and PyTorch's device and stream getters (a
    build without CUDA has none), bound once."""
    global _current_device, _raw_stream
    _current_device = torch._C._cuda_getDevice
    _raw_stream = torch._C._cuda_getCurrentRawStream
    fn = _fns[name] = getattr(library(), name)
    return fn


def launch(name: str, device: int, *args) -> None:
    """Call launch function `name` with `args` and the current stream of
    card `device` (an index), on that card; raise if it returned a CUDA
    error. The caller has checked every argument."""
    fn = _fns.get(name) or _resolve(name)
    if device == _current_device():
        err = fn(*args, _raw_stream(device))
    else:
        with torch.cuda.device(device):
            err = fn(*args, _raw_stream(device))
    if err:
        msg = library().kernels_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
