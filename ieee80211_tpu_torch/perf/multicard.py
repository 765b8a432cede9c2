"""The sharded loops across cards: every loop of parallel/sharded.py on
every ("dp", "sp") mesh that the world allows, held to its run on one rank,
and timed.

    torchrun --nproc-per-node N -m ieee80211_tpu_torch.perf.multicard
    python -m ieee80211_tpu_torch.perf.multicard        # the 1-rank pass
    ... [--cards N] [--device cpu]

The loops, on the inputs chip_smoke.py's phases 27-29 build (perf/bench.py's
memoized builders), `rows` rows each, rows = the largest mesh:

  frontend        `sharded_frontend` on bench.py's SISO stream captures with
                  30 dB of noise
  rx              `sharded_rx` on bench.py's headline batch (VHT MCS7 20 MHz)
  capture_decode  `sharded_capture_decode` on rows of L MCS7 packets, one
                  starting 200 samples before each shard edge of a 4-way sp
  auto            `sharded_capture_decode_auto` (its branch loop) on the
  auto_generic    SISO stream captures, and with `generic=True`
  auto2           `sharded_capture_decode_auto2` on bench.py's dual-chain
  auto2_capped    stream captures, without and with `branch_cap`

Every capture is padded with zeros to a multiple of 512 x rows samples, so
that it splits over every sp. First each loop runs on a 1-rank mesh (rank
0): its packets must be the ones planted (the frontend: `stf_autocorr` of
each row). Then, for n in (2, 4) up to the world and each sp in (1, 2, 4)
that divides n, each loop runs on the (n / sp, sp) mesh of the first n
ranks and is held to the 1-rank run: the frontend's autocorrelation within
AC_TOL of its largest value, the rx step's bits, `ltf_start` and `lsig_ok`
exactly, its CFO and SNR within CFO_TOL and SNR_TOL; a capture loop's
triggered slots (`ok`, or an NDP's) row by row, each with its bits and
plan exactly, its trigger exactly (`same_trigger`: or, where the mesh's
trigger is a shard's first sample, up to TRIG_TOL samples after the 1-rank
run's) and its CFO and NDP LTF within CFO_TOL and NDP_TOL, and its overflow
flags. A capture loop's trigger capacity per shard and
per-branch cap scale with 1 / sp and the rows per rank (`k_shard`,
`branch_cap`; the cap with the rows alone): a shard's slots past its
packets are junk, and which junk a shape emits differs. Every rank of a mesh must return the same outputs
(a digest of each).

Each (loop, mesh) is timed as the median of `iters` calls after the first,
checked one (CUDA events on the card; the host's clock on the CPU, never a device
metric), on every rank of the mesh; the time of the call is the slowest
rank's. One JSON line per (loop, mesh) goes to stdout from rank 0: ms per
call, samples/s, the speed-up and efficiency against the 1-rank run, every
rank's time and each kernel's launches on every rank in the first call
(the `LAUNCHES` counters of ops/cuda/), the world size and every rank's
card (nvidia-smi's name and power limit); the last line is a summary. A
failed check raises on every rank, so the program exits non-zero; a world
smaller than `--cards` raises; a (loop, mesh) still running after
CASE_TIMEOUT_S seconds dumps every thread's stack and exits. Runs on the
card unless `device="cpu"`.
"""
from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import hashlib
import json
import sys
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..entry import example_mpdu, round_up
from ..mac import aggregate_vht
from ..models import RxPipeline
from ..ops import sync
from ..parallel import init_distributed, make_phy_mesh, sharded
from ..rx import MimoDataDecoder, MrcDataDecoder
from ..rx.generic import GenericSisoDecoder
from ..specs import F, Mod
from ..specs.modulation import (ppdu_params_aggregate,
                                ppdu_params_nonaggregate)
from ..tx import finalize, gen_mpdu
from ..utils import c2r, r2c
from ..utils.device import entry_device
from . import bench
from .branch_floor import loop_mpdus
from .timing import median_ms

LOOPS = ("frontend", "rx", "capture_decode", "auto", "auto_generic", "auto2",
         "auto2_capped")
ITERS = 5
MESH_SIZES = (2, 4)
SP_SIZES = (1, 2, 4)
# a mesh's outputs against the 1-rank run's: float32 sums taken over other
# shards and batches (the frontend's moving sums start at each shard)
AC_TOL = 1e-4      # of the autocorrelation's largest value
CFO_TOL = 1e-5     # rad/sample
SNR_TOL = 1e-2     # dB
NDP_TOL = 1e-4     # an NDP's LTF I/Q
# a trigger, in samples, at a shard edge only: a shard sees a plateau only
# inside its own samples, so one that starts in the last 19 of a shard (the
# 20-sample plateau less one) fires at the next shard's first sample (both
# packages' loops)
TRIG_TOL = 19
TOL = {"cfo": CFO_TOL, "snr": SNR_TOL, "ndp_ltf": NDP_TOL}
FIXED_SPACING = 2048   # samples between the fixed-config loop's packets
# a (loop, mesh) that has not finished after this long dumps every thread's
# stack and exits the rank non-zero: a rank stuck in a collective would
# otherwise hold every card until the NCCL watchdog's timeout, or longer
CASE_TIMEOUT_S = 120


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The inputs' sizes: bench.py's stream captures, its headline batch,
    and the fixed-config capture's packets per row (4 m - 1, m per shard of
    a 4-way sp). The CPU tests take small ones."""
    stream: bench.Sizes = bench.FULL
    rx_batch: int = bench.HEADLINE["batch"]
    fixed_m: int = 64


FULL = Sizes()


class Case(NamedTuple):
    """One loop: the function of parallel/sharded.py that makes it, its
    global inputs (numpy), the samples one call reads (per chain), its
    keyword arguments on a mesh (after the mesh; from sp and the rows per
    rank), what its 1-rank run must show, and how a mesh's outputs are
    held to the 1-rank run's."""
    loop: str
    fn: str
    x: tuple
    samples: int
    kwargs: Callable       # (sp, rows per rank) -> {argument: value}
    planted: Callable      # (outputs) -> [problem]
    compare: Callable      # (1-rank outputs, outputs, sp) -> [problem]

    def build(self, mesh, sp: int, rows_per_rank: int):
        """The loop on `mesh`: run(*x) -> {output: tensor}."""
        fn = getattr(sharded, self.fn)
        if self.fn == "sharded_frontend":
            return lambda x2: {"ac": fn(mesh, x2)}
        return fn(mesh, **self.kwargs(sp, rows_per_rank))


def mesh_shapes(n_cards: int) -> list:
    """(dp, sp) of every mesh of n in MESH_SIZES <= n_cards ranks and sp in
    SP_SIZES dividing n, in that order."""
    return [(n // sp, sp) for n in MESH_SIZES if n <= n_cards
            for sp in SP_SIZES if n % sp == 0]


def k_shard(k_total: int, sp: int) -> int:
    """Trigger slots per shard for a row that needs k_total: its 1 / sp
    share and a quarter more, plus 2 (packets do not split evenly)."""
    return -(-5 * k_total // (4 * sp)) + 2


def branch_cap(per_row: int, rows_per_rank: int) -> int:
    """auto2's windows per branch on a rank of `rows_per_rank` rows, each
    with `per_row` packets of the branch, with `k_shard`'s margin. Not 1 /
    sp of them: a rank decodes the time-sorted slots j = s (mod sp) of its
    rows, and where packets alternate between branches (bench.py's
    dual-chain stream: VHT MCS7 SISO, then VHT MCS4 2x2) every other rank
    gets every window of one branch."""
    return k_shard(per_row * rows_per_rank, 1)


def add_noise(cap: np.ndarray, snr_db: float, seed: int) -> np.ndarray:
    """White complex noise snr_db below the capture's signal RMS."""
    rng = np.random.default_rng(seed)
    rms = np.sqrt(np.mean(np.abs(cap[cap != 0]) ** 2))
    sigma = rms / 10 ** (snr_db / 20) / np.sqrt(2)
    return (cap + rng.normal(0, sigma, cap.shape)
            + 1j * rng.normal(0, sigma, cap.shape)).astype(np.complex64)


def stack_rows(caps, rows: int, min_len: int = 0) -> np.ndarray:
    """The first `rows` captures [..., N_i] as rows of one array, each
    zero-padded at its end to a length that splits over every sp up to
    `rows` (512 x rows divides it) and is at least min_len."""
    caps = caps[:rows]
    assert len(caps) == rows, f"{len(caps)} captures for {rows} rows"
    t = round_up(max([c.shape[-1] for c in caps] + [min_len]), rows)
    out = np.zeros((rows,) + caps[0].shape[:-1] + (t,), np.complex64)
    for r, c in enumerate(caps):
        out[r, ..., :c.shape[-1]] = c
    return out


def fixed_capture(rows: int, m: int):
    """Rows of L MCS7 packets (the entry points' 30-byte UDP MPDU, CFO 9
    kHz): row r's i-th packet at i x FIXED_SPACING - 200 + 16 r for i = 1 ..
    4m - 1, so that one starts 200 samples before each edge of a 4-way
    (and 2-way) sp split. Returns (capture [rows, 4m x FIXED_SPACING],
    offsets per row, mod, n_sym, psdu_len, window, mpdu)."""
    mpdu = example_mpdu()
    mod = Mod(F.L, 7)
    pp = ppdu_params_nonaggregate(mod, len(mpdu))
    wave = finalize(gen_mpdu(mpdu, mod).waveform, multiplier=0.2,
                    cfo_hz=9000.0, gap=False)[0]
    w = RxPipeline(mod, pp.n_sym, pp.psdu_len, device="cpu").window_len()
    cap = np.zeros((rows, 4 * m * FIXED_SPACING), np.complex64)
    offs = []
    for r in range(rows):
        row = [i * FIXED_SPACING - 200 + 16 * r for i in range(1, 4 * m)]
        for o in row:
            cap[r, o:o + len(wave)] += wave
        offs.append(row)
    return cap, offs, mod, pp.n_sym, pp.psdu_len, w, mpdu


# -- holding a mesh's outputs to the 1-rank run's ---------------------------
def _diff(what: str, ref: torch.Tensor, got: torch.Tensor, tol=None):
    """[problem] where got differs from ref: in shape or dtype, or beyond
    tol (exactly when None)."""
    if ref.shape != got.shape or ref.dtype != got.dtype:
        return [f"{what}: {tuple(got.shape)} {got.dtype} != "
                f"{tuple(ref.shape)} {ref.dtype}"]
    if tol is None:
        n = int((ref != got).sum())
        return [f"{what}: {n} elements differ"] if n else []
    d = float((ref.double() - got.double()).abs().max()) if ref.numel() \
        else 0.0
    return [f"{what}: max |d| {d:.3g} > {tol:.3g}"] if not d <= tol else []


def same_rows(ref: dict, got: dict, what: str) -> list:
    """Every output of every row: TOL's keys within their tolerance, the
    others exactly."""
    if set(ref) != set(got):
        return [f"{what}: keys {sorted(got)} != {sorted(ref)}"]
    return [p for k in ref for p in _diff(f"{what} {k}", ref[k], got[k],
                                          TOL.get(k))]


def same_frontend(ref: dict, got: dict, what: str) -> list:
    """The autocorrelation within AC_TOL of the 1-rank run's largest
    value."""
    return _diff(f"{what} ac", ref["ac"], got["ac"],
                 AC_TOL * float(ref["ac"].abs().max()))


def triggered(out: dict) -> torch.Tensor:
    """[B, n_win] the slots that decoded: `ok`, or an NDP's."""
    sel = out["ok"]
    return sel | out["ndp"] if "ndp" in out else sel


def same_trigger(ref: torch.Tensor, got: torch.Tensor, shard_len: int,
                 what: str) -> list:
    """[problem] where a row's triggers differ: each equal, or the mesh's
    at a shard's first sample and at most TRIG_TOL samples after the
    1-rank run's (a plateau that starts in a shard's last samples)."""
    if ref.shape != got.shape or ref.dtype != got.dtype:
        return _diff(what, ref, got)
    late = got.long() - ref.long()
    edge = (got % shard_len == 0) & (late > 0) & (late <= TRIG_TOL)
    n = int(((late != 0) & ~edge).sum())
    return [f"{what}: {n} triggers differ"] if n else []


def same_slots(ref: dict, got: dict, what: str, shard_len: int) -> list:
    """A capture loop's outputs, row by row on the triggered slots: the
    same count, flags, bits and plan exactly, the trigger by
    `same_trigger` on shards of `shard_len` samples, TOL's keys within
    their tolerance; each output without a slot axis (the overflow flags)
    whole."""
    if set(ref) != set(got):
        return [f"{what}: keys {sorted(got)} != {sorted(ref)}"]
    n_ref, n_got = ref["ok"].shape[1], got["ok"].shape[1]
    sel_r, sel_g = triggered(ref), triggered(got)
    problems = []
    for k in ref:
        r, g = ref[k], got[k]
        if r.dim() < 2 or r.shape[1] != n_ref or g.shape[1] != n_got:
            problems += _diff(f"{what} {k}", r, g)
            continue
        for row in range(r.shape[0]):
            rr, gg = r[row][sel_r[row]], g[row][sel_g[row]]
            problems += (same_trigger(rr, gg, shard_len, f"{what} {k} row "
                                      f"{row}") if k == "trig_t" else
                         _diff(f"{what} {k} row {row}", rr, gg, TOL.get(k)))
    return problems


def digest(out: dict) -> str:
    """sha256 of every output's bytes, key by key."""
    h = hashlib.sha256()
    for k in sorted(out):
        v = out[k].detach().cpu().contiguous()
        h.update(k.encode())
        h.update(str((tuple(v.shape), v.dtype)).encode())
        h.update(v.view(torch.uint8).numpy().tobytes() if v.numel() else b"")
    return h.hexdigest()


# -- the loops ----------------------------------------------------------------
def _planted(out: dict, want: list, what: str) -> list:
    """Every row's decoded MPDUs (FCS-checked, in time order) are `want`."""
    problems = []
    for r in range(out["ok"].shape[0]):
        got = [m for _, _, m in loop_mpdus(out, r)]
        if got != want:
            problems.append(f"{what} row {r}: {len(got)} packets decode, "
                            f"{len(want)} planted")
    return problems


def frontend_case(rows: int, sizes: Sizes) -> Case:
    caps = bench.stream_captures(sizes.stream)
    x = c2r(add_noise(stack_rows(caps, rows), 30.0, seed=27))

    def planted(out):
        xt = torch.from_numpy(x).to(out["ac"].device)
        ref = sync.stf_autocorr(r2c(torch.cat(
            [xt, xt.new_zeros(rows, sharded.HALO, 2)], dim=1)))
        ref = ref[:, :x.shape[1]].clone()
        ref[:, -sharded.HALO:] = 0.0
        return _diff("frontend == stf_autocorr of each row", ref, out["ac"],
                     AC_TOL * float(ref.abs().max()))

    return Case("frontend", "sharded_frontend", (x,), rows * x.shape[1],
                lambda sp, b: {}, planted,
                lambda r, g, sp: same_frontend(r, g, "frontend"))


def rx_case(sizes: Sizes) -> Case:
    b = bench.rx_batch(**dict(bench.HEADLINE, batch=sizes.rx_batch))

    def planted(out):
        try:
            bench.gate_rows(out["bits"], b.psdu_len, b.mpdu, "rx")
        except RuntimeError as e:       # bench's gate raises; report it
            return [str(e)]
        return [] if bool(out["lsig_ok"].all()) else ["rx: lsig_ok"]

    return Case("rx", "sharded_rx", (b.x2, b.t0),
                b.x2.shape[0] * b.x2.shape[1],
                lambda sp, rows: {"mod": b.mod, "n_sym": b.n_sym}, planted,
                lambda r, g, sp: same_rows(r, g, "rx"))


def capture_decode_case(rows: int, sizes: Sizes) -> Case:
    cap, offs, mod, n_sym, psdu_len, w, mpdu = fixed_capture(rows,
                                                             sizes.fixed_m)
    k_total = 4 * sizes.fixed_m

    def planted(out):
        problems = []
        for r, row in enumerate(offs):
            pk = loop_mpdus(out, r, psdu_len)
            trig = out["trig_t"][r][out["ok"][r]].cpu().numpy()
            if not ([m for _, _, m in pk] == [[mpdu]] * len(row)
                    and len(trig) == len(row)
                    and np.all(np.abs(trig - np.asarray(row)) < 40)):
                problems.append(f"capture_decode row {r}: {len(pk)} of "
                                f"{len(row)} packets, triggers {trig[:8]}")
        return problems

    return Case("capture_decode", "sharded_capture_decode", (c2r(cap),),
                rows * cap.shape[1],
                lambda sp, b: {"mod": mod, "n_sym": n_sym, "window_len": w,
                               "k_per_shard": k_shard(k_total, sp)},
                planted, lambda r, g, sp: same_slots(
                    r, g, "capture_decode", cap.shape[1] // sp))


def auto_cases(rows: int, sizes: Sizes) -> list:
    """The auto loop, its branch loop and generic=True, on the SISO stream
    captures: chip_smoke phase 28's branches and window; 2 rises per
    packet (L-STF, then the HT/VHT-STF)."""
    _, mpdus = bench.api_capture(sizes.stream)
    ht = max(ppdu_params_nonaggregate(Mod(F.HT, 5), len(m)).n_sym
             for m in mpdus[0::2])
    vht = max(ppdu_params_aggregate(Mod(F.VHT, 7),
                                    len(aggregate_vht([m]))).n_sym
              for m in mpdus[1::2])
    branches = ((Mod(F.HT, 5), ht), (Mod(F.VHT, 7), vht))
    w = max([sharded.branch_window_len(m, c) for m, c in branches]
            + [GenericSisoDecoder(((F.HT, 5), (F.VHT, 7)), max(ht, vht),
                                  device="cpu").window_capacity()])
    x = c2r(stack_rows(bench.stream_captures(sizes.stream), rows,
                       min_len=rows * w))
    want = [[m] for m in mpdus] * sizes.stream.n_copy
    k_total = 2 * len(want)
    out = []
    for loop, generic in (("auto", False), ("auto_generic", True)):
        out.append(Case(
            loop, "sharded_capture_decode_auto", (x,), rows * x.shape[1],
            lambda sp, b, g=generic: {
                "branches": branches, "window_len": w,
                "k_per_shard": k_shard(k_total, sp), "generic": g},
            lambda o, what=loop: _planted(o, want, what),
            lambda r, g, sp, what=loop: same_slots(r, g, what,
                                                   x.shape[-2] // sp)))
    return out


def auto2_cases(rows: int, sizes: Sizes) -> list:
    """The auto2 loop on the dual-chain stream captures (chip_smoke phase
    29's branches and window), at full width and with a branch cap."""
    caps, n_pk, seg = bench.mimo_stream_captures(sizes.stream)
    n_sym = {}
    for mod, mp in seg:
        n = ppdu_params_aggregate(mod, len(aggregate_vht([mp]))).n_sym
        n_sym[mod] = max(n_sym.get(mod, 0), n)
    branches = tuple(n_sym.items())
    w = max(272 + (MimoDataDecoder(m, c) if m.nSS == 2 else MrcDataDecoder(
        m, c)).data_offset() + c * 80 + 80 for m, c in branches)
    x = c2r(stack_rows(caps, rows, min_len=rows * w))
    want = [[mp] for _, mp in seg] * sizes.stream.n_mimo_rep
    per_branch = max(sum(m == mod for m, _ in seg) for mod in n_sym) \
        * sizes.stream.n_mimo_rep
    k_total = 2 * n_pk
    out = []
    for loop, capped in (("auto2", False), ("auto2_capped", True)):
        out.append(Case(
            loop, "sharded_capture_decode_auto2", (x,), rows * x.shape[2],
            lambda sp, b, c=capped: {
                "branches": branches, "window_len": w,
                "k_per_shard": k_shard(k_total, sp),
                "branch_cap": branch_cap(per_branch, b) if c else None},
            lambda o, what=loop: _planted(o, want, what),
            lambda r, g, sp, what=loop: same_slots(r, g, what,
                                                   x.shape[-2] // sp)))
    return out


def cases(rows: int, sizes: Sizes = FULL) -> list:
    """Every loop of LOOPS on `rows` rows."""
    return ([frontend_case(rows, sizes), rx_case(sizes),
             capture_decode_case(rows, sizes)]
            + auto_cases(rows, sizes) + auto2_cases(rows, sizes))


# -- the run --------------------------------------------------------------------
def _gathered(mine):
    """Every rank's `mine`, in rank order."""
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, mine)
    return got


def _raise_any(problems_by_rank, what: str) -> None:
    problems = [f"rank {r}: {p}" for r, ps in enumerate(problems_by_rank)
                for p in ps or ()]
    if problems:
        raise RuntimeError(f"{what}:\n" + "\n".join(problems[:40]))


def _call(case: Case, mesh, sp: int, rows_per_rank: int, xs, iters: int,
          dev: torch.device):
    """One (loop, mesh) on this rank: the first call's outputs and kernel
    launches, then the median time of `iters` more calls."""
    run = case.build(mesh, sp, rows_per_rank)
    with torch.inference_mode():
        before = bench.launch_counts()
        out = run(*xs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        after = bench.launch_counts()
        ms = median_ms(lambda: run(*xs), dev, iters, warmup=0)
    return out, {k: after[k] - before[k] for k in after}, ms


def run(cards: int | None = None, sizes: Sizes = FULL, iters: int = ITERS,
        *, device=None, keep=(), emit=print) -> dict:
    """The 1-rank pass, then every mesh of `mesh_shapes(cards)` (cards: the
    world's size by default; a smaller world raises). Every rank of the
    world calls it; under torchrun it joins the group of the environment
    (left to the process's exit), and without a group it makes a 1-rank
    one, destroyed when the run returns (and left when a check raises).
    Rank 0 emits the JSON lines. Returns {"lines": [line dicts], "outputs":
    {(loop, (dp, sp)): {key: numpy}} for the meshes in `keep`, on every
    rank of them}."""
    own_group = not dist.is_initialized()
    joined = init_distributed(device=device)   # torchrun's group, this card
    dev = entry_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    cards = cards or world
    if world < cards:
        raise RuntimeError(
            f"perf.multicard on {cards} cards needs {cards} ranks and the "
            f"world has {world}: start one process per card, `torchrun "
            f"--nproc-per-node {cards} -m ieee80211_tpu_torch.perf.multicard`")
    try:
        out = _run(cards, sizes, iters, dev, keep, emit)
    finally:
        faulthandler.cancel_dump_traceback_later()
    # a 1-rank group made here is destroyed, on success only (a failed
    # check must print its traceback). A group of several processes
    # (torchrun's) is left to the process's exit, which aborts it:
    # destroying it after the meshes' sub-groups blocked on four H100s
    if own_group and not joined:
        dist.destroy_process_group()
    return out


def _run(cards: int, sizes: Sizes, iters: int, dev: torch.device, keep,
         emit) -> dict:
    mesh0 = make_phy_mesh(1, device=dev)    # the group, where none was
    world = dist.get_world_size()
    rows = max(n for n in (1,) + MESH_SIZES if n <= cards)
    shapes = [(1, 1)] + mesh_shapes(cards)
    rank = dist.get_rank()
    card = _gathered(bench.card_info(dev))
    all_cases = cases(rows, sizes)
    inputs = {c.loop: tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                            for a in c.x) for c in all_cases}
    refs, lines, kept, ref_ms = {}, [], {}, {}
    for dp, sp in shapes:
        n = dp * sp
        mesh = mesh0 if n == 1 else make_phy_mesh(n, sp, device=dev)
        inside = mesh.get_coordinate() is not None
        for case in all_cases:
            faulthandler.dump_traceback_later(CASE_TIMEOUT_S, exit=True)
            mine = None
            if inside:
                out, launches, ms = _call(case, mesh, sp, rows // dp,
                                          inputs[case.loop], iters, dev)
                if n == 1:
                    problems = case.planted(out)
                    refs[case.loop] = out
                elif rank == 0:
                    problems = case.compare(refs[case.loop], out, sp)
                else:
                    problems = []
                if (dp, sp) in keep:
                    kept[(case.loop, (dp, sp))] = {
                        k: v.cpu().numpy() for k, v in out.items()}
                mine = {"ms": ms, "launches": launches,
                        "digest": digest(out), "problems": problems}
                del out
            got = _gathered(mine)
            ranks = [g for g in got if g is not None]
            what = f"{case.loop} on the ({dp}, {sp}) mesh"
            _raise_any([g["problems"] for g in ranks],
                       f"{what} differs from the 1-rank run")
            if len({g["digest"] for g in ranks}) != 1:
                raise RuntimeError(f"{what}: the ranks' outputs differ")
            ms = max(g["ms"] for g in ranks)
            if n == 1:
                ref_ms[case.loop] = ms
            line = {"loop": case.loop, "mesh": [dp, sp], "world": world,
                    "ms": ms, "samples_per_s": case.samples / (ms * 1e-3),
                    "speedup": ref_ms[case.loop] / ms,
                    "efficiency": ref_ms[case.loop] / ms / n,
                    "ranks_ms": [g["ms"] for g in ranks],
                    "launches": [g["launches"] for g in ranks],
                    "cards": card[:n]}
            lines.append(line)
            if rank == 0:
                emit(json.dumps(line))
    if rank == 0:
        emit(json.dumps({"multicard": {
            "world": world, "rows": rows, "shapes": shapes,
            "loops": list(LOOPS), "iters": iters,
            "ms": {f"{ln['loop']} {ln['mesh']}": ln["ms"] for ln in lines}},
            "cards": card}))
    return {"lines": lines, "outputs": kept}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=None,
                    help="the largest mesh, in ranks (default: the world)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    run(args.cards, device=args.device,
        emit=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
