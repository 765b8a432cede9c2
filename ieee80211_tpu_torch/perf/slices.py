"""The window-slice kernel (csrc/gather.cu) at the shapes the port cuts,
timed beside the one torch.gather call that cuts the same windows.

    python -m ieee80211_tpu_torch.perf.slices [--out FILE]

For each mode and shape: the kernel's output checked against its plain
version and against torch.gather, element for element; then for the
kernel and for torch.gather, one call between two CUDA events ("ms",
median of ITERS, the two timed in turns, the host's issue inside), the
host's time to issue one
call ("host_us", perf/timing.py::host_us) and the card's own time
("device_ms", launches queued behind a spin); and the least time of the
work ("bound_ms": each covered input sample read once, each output sample
written once, at 3.35 TB/s). Starts are random over the source, so about
half of them are odd. Prints one line per shape and a JSON object of all
of them (also written to --out). Needs a CUDA card: without one, main()
exits 1.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from ..ops import sync
from ..ops.cuda import gather as kg
from ..rx import receiver
from .timing import cuda_ms_turns, device_ms, host_us

HBM_BYTES_PER_S = 3.35e12   # the H100 SXM's published device-memory rate
ITERS = 50
N_CAP = 1 << 22             # the capture-slice modes' source: 4M samples

# (name, windows, source samples, length, int64 starts)
PER_ROW = [
    ("step_z", 1024, 2320, 2080, False),      # RxPipeline.step's DATA window
    ("step_sync", 1024, 2320, 448, False),    # its sync window
    ("step_z_int64", 1024, 2320, 2080, True),
    ("odd_length", 1024, 2321, 2079, False),  # odd L: rows start unaligned
    ("sweep_batch", 100, 2320, 2080, False),  # the PDR sweep's batch
    ("large_batch", 6144, 2800, 2080, False),
]
# (name, windows, length, sorted starts): the receivers' SIG window, their
# DATA windows (SISO VHT MCS7 x 48 symbols, 2x2 VHT MCS4 x 16) and the MU
# stream's SIG-B and DATA windows, at random starts; the MU DATA windows
# also at ascending starts, the order in which the receivers' triggers
# hand them over
CAPTURE = [("sig", 1024, 1072, False), ("data", 1024, 4480, False),
           ("data_2x2", 1024, 2000, False), ("mu_sigb", 1024, 1040, False),
           ("mu_data", 1024, 4560, False),
           ("mu_data_sorted", 1024, 4560, True)]


def _covered(starts: torch.Tensor, n: int, length: int) -> int:
    """How many samples of one source row the windows cover, each once."""
    s = np.sort(np.clip(starts.cpu().numpy().astype(np.int64), 0,
                        n - length))
    prev_end = np.concatenate([[0], s[:-1] + length])
    return int(np.sum(s + length - np.maximum(s, prev_end)))


def _gather_index(starts, n: int, length: int, shape):
    """torch.gather's index that cuts the same windows as the kernel."""
    s = starts.long().clamp(0, n - length)
    pos = s[:, None] + torch.arange(length, device=starts.device)
    view = (len(s),) + (1,) * (len(shape) - 3) + (length, 1)
    return pos.view(view).expand(shape).contiguous()


def _time(kernel, library, nbytes: int) -> dict:
    ms, gather_ms = cuda_ms_turns([kernel, library], iters=ITERS)
    t = {"ms": ms, "host_us": host_us(kernel),
         "device_ms": device_ms(kernel), "gather_ms": gather_ms,
         "gather_host_us": host_us(library),
         "gather_device_ms": device_ms(library),
         "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    t["bound_share"] = t["bound_ms"] / t["device_ms"]
    return t


def _check(got, plain, gathered, what: str) -> None:
    torch.cuda.synchronize()
    if not (torch.equal(got, plain) and torch.equal(got, gathered)):
        raise RuntimeError(f"slice kernel != plain version or torch.gather "
                           f"({what})")


def measure(device) -> dict:
    """{shape name: times} for every shape of PER_ROW and CAPTURE."""
    rng = np.random.default_rng(0)
    out = {}
    for name, b, n, length, wide in PER_ROW:
        x = torch.from_numpy(rng.standard_normal((b, n, 2)).astype(
            np.float32)).to(device)
        st = torch.from_numpy(rng.integers(0, n - length + 1, b)).to(
            device, torch.int64 if wide else torch.int32)
        idx = _gather_index(st, n, length, (b, length, 2))
        _check(kg.batch_slice_iq_cuda(x, st, length),
               sync.batch_slice_iq_plain(x, st, length),
               torch.gather(x, 1, idx), name)
        out[f"per_row_{name}"] = dict(
            shape=f"[{b} x {n} -> {length}]",
            **_time(lambda: kg.batch_slice_iq_cuda(x, st, length),
                    lambda: torch.gather(x, 1, idx), 2 * b * length * 8
                    + b * st.element_size()))
        del x, idx
    for chains in (1, 2):
        cap = torch.from_numpy(rng.standard_normal((chains, N_CAP, 2)).astype(
            np.float32)).to(device)
        for name, g, length, ascending in CAPTURE:
            st = rng.integers(0, N_CAP - length + 1, g)
            st = torch.from_numpy((np.sort(st) if ascending else st)
                                  .astype(np.int32)).to(device)
            nbytes = chains * (_covered(st, N_CAP, length) + g * length) * 8
            if chains == 1:
                src = cap[0]
                wide = src.expand(g, N_CAP, 2)
                idx = _gather_index(st, N_CAP, length, (g, length, 2))
                _check(kg.capture_slice_iq_cuda(src, st, length),
                       receiver.capture_windows_plain(src, st, length),
                       torch.gather(wide, 1, idx), name)
                key, shape = f"shared_{name}", f"[{N_CAP} -> {g} x {length}]"
                kernel = (lambda: kg.capture_slice_iq_cuda(src, st, length))
                library = (lambda: torch.gather(wide, 1, idx))
            else:
                wide = cap.expand(g, chains, N_CAP, 2)
                idx = _gather_index(st, N_CAP, length,
                                    (g, chains, length, 2))
                _check(kg.capture_slice_iq_mimo_cuda(cap, st, length),
                       receiver.capture_windows_mimo_plain(cap, st, length),
                       torch.gather(wide, 2, idx), name)
                key = f"multi_{name}"
                shape = f"[{chains} x {N_CAP} -> {g} x {chains} x {length}]"
                kernel = (lambda: kg.capture_slice_iq_mimo_cuda(cap, st,
                                                                length))
                library = (lambda: torch.gather(wide, 2, idx))
            out[key] = dict(shape=shape, **_time(kernel, library,
                                                 nbytes + g * 4))
            del idx
        del cap
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write the JSON here too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("slices: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    r = measure(torch.device("cuda:0"))
    for key, t in r.items():
        print(f"slice {key} {t['shape']}: kernel == plain == torch.gather; "
              f"call {t['ms']:.4f} ms, issue {t['host_us']:.2f} us, device "
              f"{t['device_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_share']:.3f}); torch.gather call "
              f"{t['gather_ms']:.4f} ms, issue {t['gather_host_us']:.2f} us, "
              f"device {t['gather_device_ms']:.4f} ms ({card})")
    line = json.dumps({"card": card, "torch": torch.__version__,
                       "slices": r})
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
