"""The receive step stage by stage, and the TPU-era layouts against one
PyTorch call each.

    python -m ieee80211_tpu_torch.perf.stages [--batch B ...]

Port of perf_profile_stages.py and perf_fine_profile.py. `RxStep.forward`
(models/pipeline.py) is the composition of nine stage methods; here each
runs alone on the step's own intermediate tensors (bench.py's headline
input, cloned once before timing, so no stage sees what another wrote):

  1 sync_front   sync.sync_front_iq (its window slice included)
  2 window       the per-row slice kernel: the packet-aligned window z
  3 cfo_ramp     the CFO ramp over z
  4 fft          the symbol windows and their DFTs (demod.fft_syms)
  5 lsig         L-LTF estimate, L-SIG with its 24-bit Viterbi
  6 ht_ltf       the HT/VHT-LTF channel estimate
  7 demod        demod.demod_data_siso: ZF, pilots, LLR demap, deinterleave
  8 viterbi      the DATA Viterbi kernel
  9 descramble   coding.descramble

For each stage: one call between CUDA events (median of ITERS), then,
separately so that the profiler stays out of those times, its kernels' time
and count per call (torch.profiler); the whole step op by op
(`RxStep._eager`, as a CPU call and a key's first CUDA call run it; later
CUDA calls replay its graph) beside the sum of its stages. Then the ROADMAP ground rules' layout choices, each stage's form
beside one PyTorch call computing the same function on the same tensors,
timed in turns (call and device-only time) and checked to agree:

  fft         the DFT matmul (the step's) vs torch.fft.fft + fftshift
  movsum      the banded matmul of the LTF sync's four moving sums (the
              step's) vs cumsum differences
  descramble  the PRBS row gather (the step's since the port began) vs the
              JAX package's one-hot matmul

These are measurements only: the step keeps its forms. Runs on the card;
`measure(device="cpu")` runs the same path on the CPU with host-clock
times and no profiler (the tests).
"""
from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.nn.functional as F

from ..models import RxPipeline
from ..ops import coding, sync
from ..ops.cuda import gather as kg
from ..ops.cuda import viterbi as kv
from ..utils.device import entry_device
from .bench import HEADLINE, card_info, rx_batch
from .timing import ITERS, cuda_ms_turns, device_ms, kernels, median_ms

BATCHES = (1024, 2048)   # bench.py's batch and the JAX scripts' 2048
# a PyTorch call against the step's form: float32 rounding of another sum
# order, relative to the largest magnitude of the step's output
ALT_TOL = 1e-4
STAGES = ("sync_front", "window", "cfo_ramp", "fft", "lsig", "ht_ltf",
          "demod", "viterbi", "descramble")


def _clone(t):
    return None if t is None else t.clone()


def run_stages(step, x2: torch.Tensor, t0: torch.Tensor):
    """The step once, stage by stage. Returns ([(stage, its inputs)] in
    order, the outputs: bits, ltf_start, cfo, snr, lsig_ok and the DATA
    LLRs)."""
    ls, cfo, snr = step.sync_front(x2, t0)
    z2 = step.window(x2, ls)
    z = step.derotate(z2, cfo)
    ltf_g, sig_g, nl_g, data_g = step.grids(z)
    lchan, lsig_ok = step.lsig(ltf_g, sig_g)
    chan = step.chan_est(lchan, nl_g)
    llrs = step.data_llrs(data_g, chan)
    bits = step.viterbi(llrs)
    scr = step.descramble(bits)
    inputs = [(x2, t0), (x2, ls), (z2, cfo), (z,), (ltf_g, sig_g),
              (lchan, nl_g), (data_g, chan), (llrs,), (bits,)]
    return (list(zip(STAGES, inputs)),
            dict(bits=scr, ltf_start=ls, cfo=cfo, snr=snr, lsig_ok=lsig_ok,
                 llrs=llrs))


def stage_calls(step, x2: torch.Tensor, t0: torch.Tensor):
    """[(stage, fn)]: each fn runs its stage alone on clones of the inputs
    that the step handed it, made once here."""
    fns = (step.sync_front, step.window, step.derotate, step.grids,
           step.lsig, step.chan_est, step.data_llrs, step.viterbi,
           step.descramble)
    staged, _ = run_stages(step, x2, t0)
    out = []
    for fn, (name, args) in zip(fns, staged):
        args = tuple(_clone(a) for a in args)
        out.append((name, lambda fn=fn, args=args: fn(*args)))
    return out


def fft_alt(x: torch.Tensor) -> torch.Tensor:
    """`demod.fft_syms`' shifted-order grid by torch.fft (cuFFT on the
    card)."""
    return torch.fft.fftshift(torch.fft.fft(x, dim=-1), dim=-1)


def movsum_alt(stacked: torch.Tensor, w: int) -> torch.Tensor:
    """The moving sums of window w along the last axis, [R, n] ->
    [R, n - w + 1], as float32 cumsum differences (the banded matmul's
    function)."""
    c = torch.cumsum(F.pad(stacked, (1, 0)), dim=-1)
    return c[:, w:] - c[:, :-w]


def descramble_onehot(bits: torch.Tensor, prbs: torch.Tensor,
                      seed_inv: torch.Tensor) -> torch.Tensor:
    """The JAX package's descramble (ieee80211_tpu/ops/coding.py:264): the
    PRBS row selected by a one-hot matmul, XOR in arithmetic form."""
    seed = coding.scramble_seed_of(bits, seed_inv)
    p = F.one_hot(seed.long(), prbs.shape[0]).float() @ prbs.float()
    b = bits.float()
    return (b + p - 2.0 * b * p).to(torch.int32)


def layout_pairs(step, x2: torch.Tensor, t0: torch.Tensor):
    """[(name, shape, the step's form, the PyTorch call, tolerance)] on the
    step's own tensors: tolerance None means exactly equal."""
    staged, _ = run_stages(step, x2, t0)
    z = staged[3][1][0]
    data_w = step.symbol_windows(z)[3].contiguous()
    y, cfo_c = sync.stf_coarse(x2, t0, step.q)
    stacked = sync.ltf_sync_products(y, cfo_c, step.q)
    w = sync.LTF_PERIOD * step.q
    bits = staged[8][1][0].clone()
    return [
        ("fft", tuple(data_w.shape), lambda: step._fft(data_w),
         lambda: fft_alt(data_w), ALT_TOL),
        ("movsum", tuple(stacked.shape), lambda: stacked @ step.band,
         lambda: movsum_alt(stacked, w), ALT_TOL),
        ("descramble", tuple(bits.shape), lambda: step.descramble(bits),
         lambda: descramble_onehot(bits, step.prbs, step.seed_inv), None),
    ]


def agreement(ref: torch.Tensor, alt: torch.Tensor):
    """(max |alt - ref|, the largest |ref|)."""
    return (float((alt - ref).abs().max()), float(ref.abs().max()))


def _hand_launches(fn) -> dict:
    """The hand-written kernels' launches in one call of fn()."""
    before = (kv.LAUNCHES, kg.LAUNCHES)
    fn()
    return {"viterbi": kv.LAUNCHES - before[0],
            "slice": kg.LAUNCHES - before[1]}


def measure(batch: int = HEADLINE["batch"], iters: int = ITERS, *,
            device=None) -> dict:
    """Every stage and the whole step on bench.py's headline input at
    `batch`, then the three layout pairs."""
    dev = entry_device(device)
    b = rx_batch(**dict(HEADLINE, batch=batch))
    step = RxPipeline(b.mod, b.n_sym, b.psdu_len, device=dev).step
    x2, t0 = (torch.from_numpy(a).to(dev) for a in (b.x2, b.t0))
    with torch.inference_mode():
        calls = stage_calls(step, x2, t0)
        whole = ("step", lambda: step._eager(x2, t0))
        res = {name: {"ms": median_ms(fn, dev, iters)}
               for name, fn in calls + [whole]}
        for name, fn in calls + [whole]:
            res[name]["hand_launches"] = _hand_launches(fn)
            if dev.type == "cuda":
                res[name]["device_ms"], res[name]["launches"] = kernels(
                    fn, iters)
        layouts = {}
        for name, shape, form, alt, tol in layout_pairs(step, x2, t0):
            ref, got = form(), alt()
            err, scale = agreement(ref, got)
            ok = (torch.equal(ref, got) if tol is None
                  else err <= tol * scale)
            if not ok:
                raise RuntimeError(f"layout {name}: the PyTorch call "
                                   f"disagrees with the step's form "
                                   f"(max |d| {err:.3g} of {scale:.3g})")
            t = {"shape": list(shape), "max_abs_err": err, "scale": scale,
                 "tol": tol}
            if dev.type == "cuda":
                t["ms"], t["alt_ms"] = cuda_ms_turns([form, alt], iters)
                t["device_ms"], t["alt_device_ms"] = (device_ms(form),
                                                      device_ms(alt))
            else:
                t["ms"], t["alt_ms"] = (median_ms(form, dev, iters),
                                        median_ms(alt, dev, iters))
            layouts[name] = t
    stage_sum = {"ms": sum(res[s]["ms"] for s in STAGES), "device_ms": None}
    if all(res[s].get("device_ms") is not None for s in STAGES):
        stage_sum["device_ms"] = sum(res[s]["device_ms"] for s in STAGES)
    return {"batch": batch, "window": x2.shape[1], "stages": res,
            "stage_sum": stage_sum, "layouts": layouts}


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=list(BATCHES))
    ap.add_argument("--iters", type=int, default=ITERS)
    args = ap.parse_args(argv)
    dev = entry_device(device)
    card = card_info(dev)
    tag = f"({card['name']}, {card['power_limit']})"
    out = {"device": card, "runs": []}
    for batch in args.batch:
        r = measure(batch, args.iters, device=dev)
        out["runs"].append(r)
        for name in STAGES + ("step",):
            t = r["stages"][name]
            dev_t = ("not measured" if t.get("device_ms") is None
                     else f"{t['device_ms']:.4f} ms in {t['launches']} "
                          f"kernels")
            print(f"batch {batch} {name}: call {t['ms']:.4f} ms, device "
                  f"{dev_t}, hand kernels {t['hand_launches']} {tag}")
        print(f"batch {batch}: step {r['stages']['step']['ms']:.4f} ms, sum "
              f"of stages {r['stage_sum']['ms']:.4f} ms (device "
              f"{r['stage_sum']['device_ms']}) {tag}")
        for name, t in r["layouts"].items():
            print(f"batch {batch} layout {name} {t['shape']}: step's form "
                  f"{t['ms']:.4f} ms, PyTorch call {t['alt_ms']:.4f} ms, "
                  f"device {t.get('device_ms')} / {t.get('alt_device_ms')} "
                  f"ms; max |d| {t['max_abs_err']:.3g} of "
                  f"{t['scale']:.3g} {tag}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
