"""Where the Viterbi kernel's time goes: csrc/viterbi.cu timed beside copies
of itself with one part of the work taken out.

    python -m ieee80211_tpu_torch.perf.viterbi_ablate

torch.profiler gives a kernel's time on the card but not what holds it
back, and the card's machine runs no Nsight Compute. So this probe builds
variants of the kernel's source, each with one edit, and times them on the
same input ([1024 x 4680] depunctured pairs, the headline DATA decode):

  full            the kernel as it is;
  no_compare      each state's 16 candidates summed instead of compared:
                  no compare-select, no survivor index;
  no_table_loads  the candidates add register values in place of the 16 x 2
                  branch-metric loads from shared memory;
  no_table_build  no branch-metric table is built after the first block:
                  no LLR staging, no table sums, no table stores;
  no_survivors    no survivor word is stored but the last of each row;
  no_traceback    no traceback and no bits written.

Only "full" decodes; the others compute garbage and are timing probes.
Each variant is built by nvcc with the port's flags into
ieee80211_tpu_torch/_build/ablate/ (all at once, in parallel) and timed on
the card alone (perf/timing.py::device_ms). Needs a CUDA card: without
one, main() exits 1.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import coding
from ..ops.cuda import build
from .timing import device_ms

SOURCE = build.CSRC / "viterbi.cu"
OUT = build.BUILD_DIR / "ablate"
SHAPE = (1024, 4680)   # packets x trellis steps

# variant: [(text of csrc/viterbi.cu, its replacement)]
EDITS = {
    "full": [],
    "no_compare": [(
        "  best_of<kNan>(pv, tv0, best0, arg0);\n"
        "  best_of<kNan>(pv, tv1, best1, arg1);\n",
        "  best0 = best1 = 0.0f;\n"
        "  arg0 = arg1 = 0;\n"
        "#pragma unroll\n"
        "  for (int p = 0; p < kPaths; ++p) {\n"
        "    best0 = best0 + (pv[p] + tv0[p]);\n"
        "    best1 = best1 + (pv[p] + tv1[p]);\n"
        "  }\n")],
    "no_table_loads": [(
        "    tv0[p] = sh.table[kCur][idx0[p]];\n"
        "    tv1[p] = sh.table[kCur][idx1[p]];\n",
        "    tv0[p] = pv[p ^ 1];\n"
        "    tv1[p] = pv[p ^ 2];\n")],
    "no_table_build": [(
        "  if (more) {\n    const int c = u / kChunk;",
        "  if (false) {\n    const int c = u / kChunk;"), (
        "  if (more) {\n    float4* next",
        "  if (false) {\n    float4* next")],
    "no_survivors": [(
        "  if ((t & 3) == 3 || t == n_blk - 1) {\n"
        "    dec_b[(size_t)(t >> 2) * 32 + lane] = cr.word;",
        "  if (t == n_blk - 1) {\n"
        "    dec_b[(size_t)(t >> 2) * 32 + lane] = cr.word;")],
    "no_traceback": [(
        "  for (int c = last; c >= 0; --c) {",
        "  for (int c = last; c >= 0 && n_blk < 0; --c) {")],
}


def variant_source(name: str) -> str:
    src = SOURCE.read_text()
    for old, new in EDITS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: csrc/viterbi.cu no longer holds "
                               f"the text this variant edits: {old!r}")
        src = src.replace(old, new)
    return src


def _build(name: str) -> ctypes.CDLL:
    cu, so = OUT / f"viterbi_{name}.cu", OUT / f"viterbi_{name}.so"
    cu.write_text(variant_source(name))
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    proc = subprocess.run([build._nvcc(), *flags, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.viterbi_r4_launch.argtypes = build.SIGNATURES["viterbi_r4_launch"]
    lib.viterbi_r4_launch.restype = ctypes.c_int
    return lib


def measure(device) -> dict:
    """Device time in ms of every variant on the same input; "full" is also
    checked against the plain version."""
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(EDITS)) as pool:
        libs = dict(zip(EDITS, pool.map(_build, EDITS)))
    b, t = SHAPE
    rng = np.random.default_rng(0)
    lp = torch.from_numpy(rng.standard_normal((b, t, 2)).astype(
        np.float32)).to(device)
    w0, w1 = (torch.from_numpy(a).to(device)
              for a in coding._radix_tables(coding.RADIX))
    bits = torch.empty((b, t), dtype=torch.int32, device=device)
    dec = torch.empty((b, -(-t // 16), 32), dtype=torch.int32,
                      device=device)

    def run(lib):
        err = lib.viterbi_r4_launch(
            lp.data_ptr(), w0.data_ptr(), w1.data_ptr(), dec.data_ptr(),
            bits.data_ptr(), b, t // 4, coding.RENORM,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    run(libs["full"])
    ref = coding.viterbi_pairs_plain(lp, w0, w1, coding.RENORM)
    if not torch.equal(bits, ref):
        raise RuntimeError("the unedited kernel != the plain version")
    return {name: device_ms(lambda lib=lib: run(lib))
            for name, lib in libs.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("viterbi_ablate: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    times = measure(torch.device("cuda:0"))
    full = times["full"]
    for name, ms in times.items():
        print(f"viterbi {name} [{SHAPE[0]} x {SHAPE[1]}]: {ms:.4f} ms "
              f"device, {ms / full:.4f} of full ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
