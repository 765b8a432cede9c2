"""Sharded PHY computation over a ("dp", "sp") DeviceMesh.

Port of ieee80211_tpu/parallel/sharded.py: `HALO` :26, `sharded_frontend`
:29, `sharded_rx` :61, `_local_triggers` :74, `sharded_capture_decode`
:107, the planner tables and `_ndbps_q` :210-217, `_auto_plan` :241,
`_auto_plan2` :314, `_FMT_CODE` :410, `_mu_ingraph` :413,
`branch_window_len` :522, `sharded_capture_decode_auto` :528,
`sharded_capture_decode_auto2` :711 and `multichip_step` :972.

  * front-end correlators run over *time-sharded* captures with an
    overlap-save halo that each shard receives from its right neighbour
    (from an all-gather over the sp group);
  * packet decode is *batch-sharded* (dp);
  * windows and decoded bits are regrouped with all-gathers over sp.

Each JAX `shard_map` body is a function that every rank of the mesh runs
on its own shard: `ppermute(x, "sp", i -> i-1)` becomes the right
neighbour's row of an all-gather over the sp group (the identity on a
1-member sp axis), `all_gather(x, "sp")` an all-gather over the sp group, and
`axis_index("sp")` the rank's sp coordinate. Every collective goes through
the process group, a 1-rank one too.

Calling convention: a run takes the GLOBAL input on every rank (numpy or a
tensor, the counterpart of a jit input with in_shardings): each rank cuts
its own (dp, sp) block and moves it to its device. It returns the GLOBAL
outputs on every rank, all-gathered over dp (the counterpart of fetching a
dp-sharded array); outputs are replicated over sp as in the JAX package.
The runs are `nn.Module`s whose decoders and tables are submodules and
buffers. The window cut of the capture loops is the slice kernel on the
card (`capture_slice_iq_cuda` / `_mimo_cuda`, one launch per dp row), and
every decode reaches the Viterbi and per-row slice kernels.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F_nn
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from ..models.pipeline import RxPipeline, RxStep, as_tables
from ..mu.sounding import MU_SIGB_INFO, MU_SIGB_LEN
from ..ops import coding, demod, sync
from ..rx.mimo import MimoDataDecoder, MrcDataDecoder
from ..rx.receiver import (OFF_NLLTF, SigTables, _bits_to_uint,
                           _crc8_matrix, _gf2_affine, capture_windows,
                           capture_windows_mimo, sig_parse, sig_parse_mimo)
from ..specs import BW, CR, F, Mod
from ..specs import interleaver as ilv
from ..specs import tables as T
from ..utils.riq import r2c, r_of
from .mesh import mesh_device

HALO = 31  # lag (16) + window (16) - 1 of the STF auto-correlator
_BW_OF_Q = {1: BW.BW20, 2: BW.BW40, 4: BW.BW80}
_VHT_BW_CODE = {1: 0, 2: 1, 4: 2}


class _Axes:
    """This rank's place in a ("dp", "sp") mesh and the collectives of its
    shard_map bodies."""

    def __init__(self, mesh: DeviceMesh):
        grid = mesh.mesh
        self.n_dp, self.n_sp = (int(v) for v in grid.shape)
        # a sub-group numbers its ranks in global order: the mesh must too,
        # so that group rank == mesh coordinate
        flat = grid.flatten()
        assert torch.equal(flat, flat.sort().values), grid
        self.device = mesh_device(mesh)
        coord = mesh.get_coordinate()
        self.inside = coord is not None
        if self.inside:
            self.d, self.s = (int(c) for c in coord)
            self.dp = mesh.get_group("dp")
            self.sp = mesh.get_group("sp")

    def check(self) -> None:
        if not self.inside:
            raise RuntimeError(f"rank {dist.get_rank()} is not in the mesh")

    def block(self, x, t_axis: int) -> torch.Tensor:
        """This rank's (dp, sp) block of a global input: rows over dp, the
        time axis `t_axis` over sp; on the rank's device, contiguous."""
        x = torch.as_tensor(x)
        b, t = x.shape[0], x.shape[t_axis]
        if b % self.n_dp or t % self.n_sp:
            raise ValueError(f"{b} rows x {t} samples do not split over a "
                             f"({self.n_dp}, {self.n_sp}) mesh")
        bl, tl = b // self.n_dp, t // self.n_sp
        return self.local(x[self.d * bl:(self.d + 1) * bl].narrow(
            t_axis, self.s * tl, tl))

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """x on this rank's device, contiguous. An input on another card
        raises: each rank holds the global input on the host or its own
        card, so that no call reads its block across the cards' link."""
        if x.is_cuda and x.device != self.device:
            raise ValueError(f"an input on {x.device}, but this rank runs "
                             f"on {self.device}")
        return x.to(self.device).contiguous()

    def gather(self, x: torch.Tensor, group, n: int) -> torch.Tensor:
        """all_gather over `group` (n members): [n, *x.shape] in coordinate
        order. Bools travel as uint8 (gloo has no bool all-gather)."""
        is_bool = x.dtype == torch.bool
        x = (x.to(torch.uint8) if is_bool else x).contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        out = out.view((n,) + tuple(x.shape))
        return out.bool() if is_bool else out

    def gather_dp(self, x: torch.Tensor) -> torch.Tensor:
        """The global [B, ...] of this dp block [b, ...] on every rank."""
        g = self.gather(x, self.dp, self.n_dp)
        return g.reshape((-1,) + tuple(x.shape[1:]))

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The global rows of a block split over both axes, (dp, sp)
        flattened dp-major: gathered over sp, then over dp."""
        g = self.gather(x, self.sp, self.n_sp)
        return self.gather_dp(g.reshape((-1,) + tuple(x.shape[1:])))

    def from_right(self, x: torch.Tensor) -> torch.Tensor:
        """ppermute(x, "sp", i -> i - 1): the right neighbour's x (cyclic),
        picked from an all-gather of every shard's x over sp (a halo is
        small; an all-gather is the one kind of collective the loops use).
        A 1-member sp axis gives the shard its own x."""
        if self.n_sp == 1:
            return x
        return self.gather(x, self.sp, self.n_sp)[(self.s + 1) % self.n_sp]

    def regroup(self, a: torch.Tensor, b: int, k: int) -> torch.Tensor:
        """Per-window results [b*k, ...] of each shard's strided share ->
        [b, n_sp*k, ...] in sorted-slot order (slot j = kk*n_sp + shard)."""
        rest = tuple(a.shape[1:])
        g = self.gather(a, self.sp, self.n_sp).reshape(
            (self.n_sp, b, k) + rest)
        g = g.permute((1, 2, 0) + tuple(range(3, g.dim())))
        return g.reshape((b, self.n_sp * k) + rest)


def sharded_frontend(mesh: DeviceMesh, x2) -> torch.Tensor:
    """STF auto-correlation of a time-sharded capture with halo exchange.

    x2: global [B, T, 2] float32 I/Q; B splits over 'dp' and T over 'sp'.
    Each time shard receives HALO samples from its right neighbour so the
    sliding correlator is seamless across shard boundaries (overlap-save).
    Returns ac: global [B, T] (the last HALO samples of the capture are
    zero) on every rank of the mesh.
    """
    ax = _Axes(mesh)
    ax.check()
    xb2 = ax.block(x2, 1)
    tl = xb2.shape[1]
    halo = ax.from_right(xb2[:, :HALO])
    ac = sync.stf_autocorr(r2c(torch.cat([xb2, halo], dim=1)))[:, :tl]
    if ax.s == ax.n_sp - 1:     # the wrapped-around tail of the last shard
        ac = torch.cat([ac[:, :tl - HALO], ac.new_zeros(ac.shape[0], HALO)],
                       dim=1)
    g = ax.gather(ac, ax.sp, ax.n_sp)                     # [n_sp, b, tl]
    return ax.gather_dp(g.permute(1, 0, 2).reshape(ac.shape[0], -1))


class _MeshRun(nn.Module):
    """A program over a mesh: its tables and decoders are submodules on
    this rank's device."""

    def __init__(self, mesh: DeviceMesh):
        super().__init__()
        self.mesh = mesh
        self.ax = _Axes(mesh)

    def _ready(self) -> None:
        self.to(self.ax.device)


class _ShardedRx(_MeshRun):
    def __init__(self, mesh, mod: Mod, n_sym: int):
        super().__init__(mesh)
        self.step = RxStep(mod, n_sym)
        self._ready()

    def _local(self, x2, t0):
        """This rank's rows of the batch, split over (dp, sp) flattened."""
        ax = self.ax
        x2, t0 = torch.as_tensor(x2), torch.as_tensor(t0)
        n = ax.n_dp * ax.n_sp
        if x2.shape[0] % n:
            raise ValueError(f"{x2.shape[0]} rows do not split over {n} "
                             f"ranks")
        bl = x2.shape[0] // n
        f = ax.d * ax.n_sp + ax.s
        rows = slice(f * bl, (f + 1) * bl)
        return ax.local(x2[rows]), ax.local(t0[rows])

    def forward(self, x2, t0) -> dict:
        self.ax.check()
        out = self.step(*self._local(x2, t0))
        return {k: self.ax.gather_rows(v) for k, v in out.items()}


def sharded_rx(mesh: DeviceMesh, mod: Mod, n_sym: int) -> _ShardedRx:
    """Batch-sharded fixed-config RX step: packets split over the mesh's
    ranks ((dp, sp) flattened). run(x2 [B, W, 2], t0 [B]) -> the step's
    dict (bits, ltf_start, cfo, snr, lsig_ok), global on every rank."""
    return _ShardedRx(mesh, mod, n_sym)


def _local_triggers(ac: torch.Tensor, k: int, thresh: float = 0.5,
                    plateau: int = 20, min_gap: int = 400) -> torch.Tensor:
    """Fixed-capacity trigger: rising edges of >=plateau runs of
    ac > thresh, min_gap-deduped. ac: [B, Ta] -> t [B, k] int32, invalid
    slots = Ta (one-past-end sentinel).

    As the JAX function: slot i holds the i-th rise of the row (the first
    k rises, before dedup), or Ta where the sequential keep rule (keep t
    when t - last_kept >= min_gap) drops it. With no host sync and no
    k-step loop: the first k rises come from a binary search of the running
    rise count, and the kept chain is reachability from the first rise in
    the graph i -> next(i) = the first rise at least min_gap later, marked
    by pointer doubling in ceil(log2(k + 1)) steps.
    """
    b, ta = ac.shape
    dev = ac.device
    above = ac > thresh
    c = F_nn.pad(torch.cumsum(above.to(torch.int32), dim=1,
                              dtype=torch.int32), (1, 0))
    runp = (c[:, plateau:] - c[:, :-plateau]) == plateau  # [B, Ta-p+1]
    prev = torch.cat([above.new_zeros(b, 1), above[:, :-1]],
                     dim=1)[:, :runp.shape[1]]
    rise = runp & ~prev
    count = torch.cumsum(rise.to(torch.int32), dim=1, dtype=torch.int32)
    want = torch.arange(1, k + 1, dtype=torch.int32,
                        device=dev).expand(b, k).contiguous()
    pos = torch.searchsorted(count, want)
    t = torch.where(want <= count[:, -1:], pos, ta)      # ascending, int64
    # next(i): the first slot at least min_gap later (k: none)
    nxt = torch.searchsorted(t, t + min_gap)
    f = F_nn.pad(nxt, (0, 1), value=k)                    # f[k] = k
    on = torch.zeros(b, k + 1, dtype=torch.int32, device=dev)
    on[:, 0] = 1
    for _ in range(k.bit_length()):          # 2^steps > k hops
        on = on.scatter_reduce(1, f, on, reduce="amax")
        f = f.gather(1, f)
    kept = (on[:, :k] > 0) & (t < ta)
    return torch.where(kept, t, ta).to(torch.int32)


class _CaptureRun(_MeshRun):
    """What the capture loops share: the halo'd shard, its triggers, the
    window cut and the regroup of the windows."""

    def _front(self, xb2: torch.Tensor, w: int, n_trig: int, q: int = 1,
               plateau: int = 20, min_gap: int = 400):
        """xb2: this shard [b, tl, 2] or [b, nRx, tl, 2]. Returns (ext, the
        shard with its right halo of w samples; t [b, n_trig] local
        triggers). Multi-chain shards trigger on the max of the per-chain
        autocorrelations. The wrapped halo of the last shard is zeroed in
        the JAX function only past tl, where no trigger looks."""
        tl = xb2.shape[-2]
        if tl < w:
            raise ValueError(f"shard of {tl} samples < window {w}")
        halo = self.ax.from_right(xb2[..., :w, :])
        ext = torch.cat([xb2, halo], dim=-2)
        x = r2c(ext)
        if ext.dim() == 4:
            b, nrx = ext.shape[:2]
            ac = sync.stf_autocorr(x.reshape(b * nrx, -1), lag=16 * q,
                                   win=16 * q).reshape(b, nrx, -1).amax(1)
        else:
            ac = sync.stf_autocorr(x, lag=16 * q, win=16 * q)
        return ext, _local_triggers(ac[:, :tl], n_trig, plateau=plateau,
                                    min_gap=min_gap)

    def _windows(self, ext: torch.Tensor, t_loc: torch.Tensor, w: int):
        """Cut the windows of every trigger slot (one slice-kernel launch
        per dp row on the card; starts clip to [0, tl] as dynamic_slice
        clamps them), then regroup over sp. Returns (mine [b*k, ...] this
        shard's strided share of the time-sorted windows, val_all and
        tg_all [b, n_sp*k] the sorted validity and global trigger times)."""
        ax = self.ax
        b, k = t_loc.shape
        tl = ext.shape[-2] - w
        valid = t_loc < tl
        t_safe = torch.clamp_max(t_loc, tl)
        cut = capture_windows if ext.dim() == 3 else capture_windows_mimo
        wins = [cut(ext[r], t_safe[r], w) for r in range(b)]
        wins = wins[0][None] if b == 1 else torch.stack(wins)
        t_glob = torch.where(valid, t_loc + ax.s * tl,
                             ax.n_sp * tl).to(torch.int32)

        n = ax.n_sp
        wins_all = ax.gather(wins, ax.sp, n)           # [n_sp, b, k, ...]
        val_all = ax.gather(valid, ax.sp, n).transpose(0, 1).reshape(b, -1)
        tg_all = ax.gather(t_glob, ax.sp, n).transpose(0, 1).reshape(b, -1)
        # sort by global time so output slots are capture-ordered (stable:
        # the invalid slots share one sentinel)
        order = torch.argsort(tg_all, dim=1, stable=True)
        val_all = val_all.gather(1, order)
        tg_all = tg_all.gather(1, order)
        # this shard decodes sorted slots j = i mod n_sp
        share = order.view(b, k, n)[:, :, ax.s]
        rows = torch.arange(b, device=order.device)[:, None]
        mine = wins_all[share // k, rows, share % k]
        return mine.reshape((b * k,) + tuple(mine.shape[2:])), val_all, tg_all


class _CaptureDecode(_CaptureRun):
    def __init__(self, mesh, mod: Mod, n_sym: int, window_len: int,
                 k_per_shard: int):
        super().__init__(mesh)
        self.step = RxStep(mod, n_sym)
        self.w = window_len
        self.k = k_per_shard
        self._ready()

    def forward(self, capture) -> dict:
        ax = self.ax
        ax.check()
        xb2 = ax.block(capture, 1)
        b, k = xb2.shape[0], self.k
        ext, t_loc = self._front(xb2, self.w, k)
        xw, val_all, tg_all = self._windows(ext, t_loc, self.w)
        out = self.step(xw, torch.zeros(b * k, dtype=torch.int32,
                                        device=xw.device))
        bits = ax.regroup(out["bits"], b, k)
        ok = ax.regroup(out["lsig_ok"], b, k) & val_all
        cfo = ax.regroup(out["cfo"], b, k)
        return {name: ax.gather_dp(v) for name, v in
                dict(bits=bits, trig_t=tg_all, ok=ok, cfo=cfo).items()}


def sharded_capture_decode(mesh: DeviceMesh, mod: Mod, n_sym: int,
                           window_len: int,
                           k_per_shard: int = 4) -> _CaptureDecode:
    """The CLOSED sharded capture->decode loop:

      sp-sharded front-end (STF autocorr with the right halo)
        -> trigger (fixed capacity k per time shard; a packet belongs to
           the shard containing its trigger)
        -> window extraction with a right halo of a full window length, so
           packets straddling shard edges decode seamlessly
        -> all-gather regroup of the windows over sp
        -> load-balanced decode: shard i decodes sorted windows j = i mod
           n_sp
        -> all-gather of decoded bits (replicated out).

    Returns run(capture [B, T, 2] f32 I/Q; B over dp, T over sp) -> dict:
      bits [B, n_win, n_bits], trig_t [B, n_win] (global sample index,
      T = invalid slot), ok [B, n_win] (valid trigger & L-SIG-consistent
      decode), cfo [B, n_win].
    """
    return _CaptureDecode(mesh, mod, n_sym, window_len, k_per_shard)


# ---------------------------------------------------------------------------
# auto-detecting sharded loop: per-packet format/MCS/length detection on the
# device (the whole mixed-format capture decodes in one program per rank)
# ---------------------------------------------------------------------------

# nDBPS lookup tables for the planner (20 MHz defaults; the wideband
# variants are generated from the Mod descriptor)
_NDBPS_L = np.array([24, 36, 48, 72, 96, 144, 192, 216], np.int32)
_NDBPS_HT = np.array([26, 52, 78, 104, 156, 208, 234, 260], np.int32)
_NDBPS_VHT = np.array([26, 52, 78, 104, 156, 208, 234, 260, 312, 1],
                      np.int32)  # mcs9 invalid @ 20 MHz 1SS


@lru_cache(maxsize=None)
def _ndbps_q(q: int):
    """(ht [8], vht [10]) single-stream nDBPS at the capture bandwidth
    (invalid combos -> 1, which the length gates then reject)."""
    bw = _BW_OF_Q[q]
    ht = np.ones(8, np.int32)
    vht = np.ones(10, np.int32)
    for m in range(8):
        if bw != BW.BW80:            # HT exists at 20/40 MHz only
            ht[m] = Mod(F.HT, m, bw, 1).nDBPS
    for m in range(10):
        try:
            vht[m] = Mod(F.VHT, m, bw, 1).nDBPS
        except ValueError:
            pass
    return ht, vht


class PlanTables(nn.Module):
    """The planner's lookup tables at oversample factor q, as buffers."""

    def __init__(self, q: int):
        super().__init__()
        self.q = q
        ht, vht = _ndbps_q(q)
        for name, arr in (("ndbps_l", _NDBPS_L), ("ndbps_ht", ht),
                          ("ndbps_vht", vht), ("mu_nltf", [1, 1, 2, 4, 4])):
            self.register_buffer(name, torch.tensor(np.asarray(arr),
                                                    dtype=torch.int64))


# LSB-first integer from bit columns [.., lo:lo+n] (int32), the JAX name
_bits_val = _bits_to_uint


def _pick(conds, vals, default):
    """jnp.where chain: the value of the first true condition, else
    default."""
    out = default
    for c, v in zip(reversed(conds), reversed(vals)):
        out = torch.where(c, v, out)
    return out


def _lsig_fields(meta: dict, tabs: PlanTables):
    """What both planners read from L-SIG and the format pick."""
    q = tabs.q
    lsig_ok = meta["lsig_ok"]
    l_mcs = meta["l_mcs"].to(torch.int32)
    l_len = meta["l_len"].to(torch.int32)
    ht_ok, vht_ok = meta["ht_ok"], meta["vht_ok"]
    imag_dom = meta["nl1_imag_dom"]
    # format pick (mirror of _pick_nl_format): only an L-SIG rate of MCS0
    # can hide a non-legacy preamble
    nl = lsig_ok & (l_mcs == 0)
    pick_vht = nl & vht_ok & (~imag_dom | ~ht_ok)
    pick_ht = nl & ht_ok & ~pick_vht
    pick_l = lsig_ok & ~pick_vht & ~pick_ht
    ndl = tabs.ndbps_l[l_mcs.clamp(0, 7).long()]
    l_n_sym = (8 * l_len + 22 + ndl - 1) // ndl
    l_valid = pick_l & (l_len >= 14) & (l_len <= 4095) & (q == 1)
    return l_mcs, l_len, pick_ht, pick_vht, l_n_sym, l_valid


def _auto_plan(meta: dict, tabs: PlanTables) -> dict:
    """Vectorized packet planner (the counterpart of
    SisoReceiver._plan_one, SISO envelope at the capture bandwidth).

    tabs.q: capture oversample factor (1/2/4 = 20/40/80 MHz): wideband
    captures plan HT40 / VHT40 / VHT80 packets (legacy payloads exist only
    at 20 MHz). meta: the sig_parse output dict. Returns fmt (0=L/1=HT/
    2=VHT, -1 invalid), mcs, n_sym, psdu_len [N] int32, ampdu [N] bool.
    """
    q = tabs.q
    snr_ok = meta["snr"] > 0.0          # LTF-corr gate
    l_mcs, l_len, pick_ht, pick_vht, l_n_sym, l_valid = _lsig_fields(meta,
                                                                     tabs)
    hb = meta["ht_bits"]
    ht_mcs = _bits_val(hb, 0, 7)
    ht_bw40 = hb[:, 7].bool()
    ht_len = _bits_val(hb, 8, 16)
    ht_aggre = hb[:, 27].bool()
    ht_sgi = hb[:, 31].bool()
    ndh = tabs.ndbps_ht[ht_mcs.clamp(0, 7).long()]
    ht_n_sym = (8 * ht_len + 22 + ndh - 1) // ndh
    ht_valid = (pick_ht & (ht_mcs <= 7) & (ht_bw40 == (q == 2)) & (q <= 2)
                & ~ht_sgi & (ht_len >= 1) & (ht_len <= 4095))

    # VHT-SIG-A fields; nSym from the spoofed L-SIG duration
    vb = meta["vht_bits"]
    vht_bw = _bits_val(vb, 0, 2)
    vht_nsts = _bits_val(vb, 10, 3) + 1
    vht_sgi = vb[:, 24].bool()
    vht_mcs = _bits_val(vb, 28, 4)
    n_sym_l = (l_len * 8 + 22 + 23) // 24
    vht_n_sym = n_sym_l - 4 - 1          # nLTF = 1 (SISO)
    vndbps = tabs.ndbps_vht[vht_mcs.clamp(0, 9).long()]
    vht_psdu = (vht_n_sym * vndbps - 16 - 6) // 8
    vht_valid = (pick_vht & (vht_bw == _VHT_BW_CODE[q]) & (vht_nsts == 1)
                 & ~vht_sgi & (vndbps > 1) & (vht_n_sym >= 1)
                 & (vht_psdu >= 1) & (vht_psdu <= 4095))

    conds = (vht_valid, ht_valid)
    valid = (l_valid | ht_valid | vht_valid) & snr_ok
    fmt = _pick(conds + (l_valid,), (2, 1, 0), -1)
    fmt = torch.where(valid, fmt, -1)
    i32 = torch.int32
    return dict(fmt=fmt.to(i32),
                mcs=_pick(conds, (vht_mcs, ht_mcs), l_mcs).to(i32),
                n_sym=_pick(conds, (vht_n_sym, ht_n_sym), l_n_sym).to(i32),
                psdu_len=_pick(conds, (vht_psdu, ht_len), l_len).to(i32),
                ampdu=ht_aggre)


def _auto_plan2(meta: dict, tabs: PlanTables, mu_pos: int = 0,
                mu_gid: int | None = None) -> dict:
    """_auto_plan extended to the DUAL-CHAIN envelope: adds nSS (1 or 2)
    and an NDP flag (VHT whose spoofed-length symbol budget is <= 0). HT
    MCS 0-15 (20/40 MHz), VHT nSTS 1-2 at the capture bandwidth.

    mu_gid: also flag downlink MU PPDUs of that group whose layout gives
    position mu_pos a single stream — `mu` windows carry mu_n_sym /
    mu_nsts / mu_sidx and decode through the loop's MU branches."""
    q = tabs.q
    snr_ok = meta["snr"] > 0.0
    lsig_ok = meta["lsig_ok"]
    l_mcs, l_len, pick_ht, pick_vht, l_n_sym, l_valid = _lsig_fields(meta,
                                                                     tabs)
    hb = meta["ht_bits"]
    ht_mcs = _bits_val(hb, 0, 7)
    ht_bw40 = hb[:, 7].bool()
    ht_len = _bits_val(hb, 8, 16)
    ht_aggre = hb[:, 27].bool()
    ht_sgi = hb[:, 31].bool()
    ht_nss = ht_mcs // 8 + 1
    ndh = tabs.ndbps_ht[(ht_mcs % 8).clamp(0, 7).long()] * ht_nss
    ht_n_sym = (8 * ht_len + 22 + ndh - 1) // ndh
    ht_valid = (pick_ht & (ht_mcs <= 15) & (ht_bw40 == (q == 2)) & (q <= 2)
                & ~ht_sgi & (ht_len >= 1) & (ht_len <= 4095))

    vb = meta["vht_bits"]
    vht_bw = _bits_val(vb, 0, 2)
    vht_nsts = _bits_val(vb, 10, 3) + 1
    vht_sgi = vb[:, 24].bool()
    vht_mcs = _bits_val(vb, 28, 4)
    n_sym_l = (l_len * 8 + 22 + 23) // 24
    # nSTS > 2 only relevant for NDPs (data envelope is <= 2 streams)
    v_nltf = torch.where(vht_nsts > 2, 4, torch.where(vht_nsts > 1, 2, 1))
    vht_n_sym = n_sym_l - 2 - 1 - v_nltf - 1
    vndbps1 = tabs.ndbps_vht[vht_mcs.clamp(0, 9).long()]
    vndbps = vndbps1 * torch.clamp_max(vht_nsts, 2)
    vht_psdu = (vht_n_sym * vndbps - 16 - 6) // 8
    vht_fields_ok = pick_vht & (vht_bw == _VHT_BW_CODE[q]) & ~vht_sgi
    ndp = vht_fields_ok & (vht_nsts >= 1) & (vht_n_sym <= 0)
    vht_valid = (vht_fields_ok & (vht_nsts <= 2) & (vndbps1 > 1)
                 & (vht_n_sym >= 1) & (vht_psdu >= 1) & (vht_psdu <= 4095))

    conds = (vht_valid, ht_valid)
    valid = (l_valid | ht_valid | vht_valid) & snr_ok
    fmt = torch.where(valid, _pick(conds + (l_valid,), (2, 1, 0), -1), -1)
    i32 = torch.int32
    out = dict(fmt=fmt.to(i32),
               mcs=_pick(conds, (vht_mcs, ht_mcs), l_mcs).to(i32),
               nss=_pick(conds, (torch.clamp_max(vht_nsts, 2), ht_nss),
                         torch.ones_like(ht_nss)).to(i32),
               n_sym=_pick(conds, (vht_n_sym, ht_n_sym), l_n_sym).to(i32),
               psdu_len=_pick(conds, (vht_psdu, ht_len), l_len).to(i32),
               ampdu=ht_aggre, ndp=ndp & snr_ok)
    if mu_gid is not None:
        gid = _bits_val(vb, 4, 6)
        nsts_u = torch.stack([_bits_val(vb, 10 + 3 * u, 3)
                              for u in range(4)], dim=1)     # [N, 4]
        n_tot = nsts_u.sum(dim=1)
        mu_nltf = tabs.mu_nltf[n_tot.clamp(0, 4).long()]
        mu_n_sym = n_sym_l - 2 - 1 - mu_nltf - 1
        mu = (lsig_ok & (l_mcs == 0) & meta["vht_ok"] & snr_ok
              & (gid == mu_gid) & (vht_bw == _VHT_BW_CODE[q]) & ~vht_sgi
              & (nsts_u[:, mu_pos] == 1) & (n_tot >= 1) & (n_tot <= 4)
              & (mu_n_sym >= 1))
        sidx = F_nn.pad(torch.cumsum(nsts_u, dim=1)[:, :-1],
                        (1, 0))[:, mu_pos]
        out.update(mu=mu, mu_n_sym=mu_n_sym.to(i32),
                   mu_nsts=n_tot.to(i32), mu_sidx=sidx.to(i32))
        out["fmt"] = torch.where(mu, -1, out["fmt"])  # MU exits the SU path
    return out


_FMT_CODE = {F.L: 0, F.HT: 1, F.VHT: 2}


def mu_ingraph_tables_from_numpy(mod: Mod, n_sym: int, mu_pos: int, q: int):
    """Every constant table of one MU branch's SIG-B pass and own-stream
    decode, as numpy."""
    bw = _BW_OF_Q[q]
    w0, w1 = coding._radix_tables(coding.RADIX)
    dft_re, dft_im = demod._dft_mats(64 * q)
    mat, const = _crc8_matrix(MU_SIGB_LEN[bw] + 4)
    return as_tables({
        "dft_re": dft_re,
        "dft_im": dft_im,
        "ltf_ref": demod.ltf_ref_grid(bw, False),
        "p_row": T.P_LTF_4[mu_pos],
        "pilot_idx": T.PILOT_GRID[(bw, False)],
        "data_idx": T.DATA_GRID[(bw, False)],
        "sigb_pilot_ref": T.PILOT_VHT[bw] * T.PILOT_POLARITY[3],
        "sigb_perm": ilv.rx_perm(Mod(F.VHT, 0, bw, 1)),
        "crc8_mat": mat.astype(np.float32),
        "crc8_const": const.astype(np.float32),
        "pilot_ref": demod.pilot_refs(mod, n_sym, 4),
        "rx_perm": ilv.rx_perm(mod, 0),
        "vit_w0": w0,
        "vit_w1": w1,
        "prbs": coding._prbs_tiled(n_sym * mod.nDBPS),
        "seed_inv": coding._seed_from_first7(),
    })


class MuInGraph(nn.Module):
    """Downlink MU own-stream decode inside the mesh loop (`_mu_ingraph`).

    The one-program loop handles the group layout DYNAMICALLY: 4 NL-LTF
    symbols are always extracted and the P-row combining masks
    l >= nLTF; SIG-B and data offsets are per-window starts. Envelope:
    every group member carries one stream (stream index == group
    position), groups of 1..4 streams.

    sigb(yf2, ltf_start, nltf, nsts) -> (mcs [G], crc8 [G]);
    data(yf2, ltf_start, nltf, nsts, n_valid, crc8) -> (bits [G, n_bits],
    sigb_ok [G]); yf2: [G, nRx, w] complex, CFO-corrected.
    """

    def __init__(self, mod: Mod, n_sym: int, mu_pos: int, q: int):
        super().__init__()
        self.mod, self.n_sym, self.mu_pos, self.q = mod, n_sym, mu_pos, q
        self.bw = _BW_OF_Q[q]
        self.n_bits = n_sym * mod.nDBPS
        for name, arr in mu_ingraph_tables_from_numpy(mod, n_sym, mu_pos,
                                                      q).items():
            self.register_buffer(name, torch.from_numpy(arr))

    def _syms(self, yf: torch.Tensor, start: torch.Tensor, n: int):
        q = self.q
        return demod.fft_syms(demod.extract_symbol_windows(
            yf, start, n, nfft=64 * q, gi=16 * q, shift=4 * q),
            self.dft_re, self.dft_im)

    def _chans(self, yf2, ltf_start, nltf):
        g, nrx, _ = yf2.shape
        q, nfft = self.q, 64 * self.q
        yf = yf2.reshape(g * nrx, -1)
        ls2 = ltf_start.repeat_interleave(nrx)
        ltf_f = self._syms(yf, ls2 + 448 * q, 4).reshape(g, nrx, 4, nfft)
        null = self.ltf_ref == 0
        safe_ref = torch.where(null, 1.0, self.ltf_ref)
        lmask = (torch.arange(4, device=yf.device)[None, :] < nltf[:, None])
        prow = (self.p_row[None, :] * lmask).to(ltf_f.dtype)   # [G, 4]
        h_u = (torch.einsum("gl,grlk->grk", prow, ltf_f)
               / nltf.to(torch.float32)[:, None, None] / safe_ref)
        h_u = torch.where(null[None, None], torch.ones_like(h_u), h_u)
        pil = self.pilot_idx
        sum_h_pil = ltf_f[:, :, 0, :][..., pil] / safe_ref[pil]
        return yf, ls2, h_u, sum_h_pil

    def sigb(self, yf2, ltf_start, nltf, nsts):
        g, nrx, _ = yf2.shape
        q = self.q
        yf, ls2, h_u, sum_h_pil = self._chans(yf2, ltf_start, nltf)
        nltf2 = nltf.repeat_interleave(nrx)
        sb = self._syms(yf, ls2 + (448 + 80 * nltf2) * q, 1).reshape(
            g, nrx, -1)
        acc = torch.sum(sb[..., self.pilot_idx] * torch.conj(
            sum_h_pil * self.sigb_pilot_ref[None, None]), dim=(1, 2))
        ph = acc / torch.clamp_min(torch.abs(acc), 1e-12)
        sb = sb / ph[:, None, None]
        eq = demod.mrc_combine(sb[:, :, None, :], h_u)[:, 0]
        llr = eq[..., self.data_idx].real
        sign = torch.where(nsts == 4, float(T.P_SIGB_NSTS478[self.mu_pos]),
                           1.0)
        llr = (llr * sign[:, None])[..., self.sigb_perm].contiguous()
        n_len = MU_SIGB_LEN[self.bw]
        bits = coding.viterbi_decode(llr, CR.CR12, MU_SIGB_INFO[self.bw],
                                     self.vit_w0, self.vit_w1)
        mcs = _bits_val(bits, n_len, 4)
        crc_bits = _gf2_affine(bits[:, :n_len + 4], self.crc8_mat,
                               self.crc8_const).to(torch.int32)
        crc = _bits_val(crc_bits, 0, 8)
        return mcs, crc

    def data(self, yf2, ltf_start, nltf, nsts, n_valid, crc8):
        g, nrx, _ = yf2.shape
        q, n_sym = self.q, self.n_sym
        yf, ls2, h_u, sum_h_pil = self._chans(yf2, ltf_start, nltf)
        nltf2 = nltf.repeat_interleave(nrx)
        gd = self._syms(yf, ls2 + (448 + 80 * nltf2 + 80) * q,
                        n_sym).reshape(g, nrx, n_sym, -1)
        exp = sum_h_pil[:, :, None, :] * self.pilot_ref[None, None]
        acc = torch.sum(gd[..., self.pilot_idx] * torch.conj(exp),
                        dim=(1, 3))
        ph = acc / torch.clamp_min(torch.abs(acc), 1e-12)
        gd = gd / ph[:, None, :, None]
        eq = demod.mrc_combine(gd, h_u)
        data_t = eq[..., self.data_idx]
        llr = demod.demap_llr(data_t, self.mod.mod)
        wg = torch.sum(torch.abs(h_u) ** 2, dim=1)[..., self.data_idx]
        wg = wg / torch.clamp_min(torch.mean(wg, dim=-1, keepdim=True),
                                  1e-12)
        nb = llr.shape[-1] // data_t.shape[-1]
        llr = llr * torch.repeat_interleave(wg, nb, dim=-1)[:, None, :]
        llr = llr[..., self.rx_perm].reshape(g, -1)
        sym_m = (torch.arange(n_sym, device=yf.device)[None, :]
                 < n_valid[:, None])
        ncbpss = llr.shape[1] // n_sym
        llr = torch.where(torch.repeat_interleave(sym_m, ncbpss, dim=1), llr,
                          0.0)
        bits = coding.viterbi_decode(llr, self.mod.cr, self.n_bits,
                                     self.vit_w0, self.vit_w1)
        scr = coding.descramble(bits, self.prbs, self.seed_inv)
        return scr, _bits_val(scr, 8, 8) == crc8


def branch_window_len(mod: Mod, n_sym_cap: int) -> int:
    """Window length needed to decode up to n_sym_cap symbols of mod."""
    return RxPipeline(mod, n_sym_cap, 0, device="cpu").window_len()


def _pad_cols(bits: torch.Tensor, n: int) -> torch.Tensor:
    """int32 bits [G, m] zero-padded to [G, n]."""
    bits = bits.to(torch.int32)
    return F_nn.pad(bits, (0, n - bits.shape[1])) if bits.shape[1] < n \
        else bits


def _dedup_across_shards(val_all, tg_all, min_gap: int):
    """An STF straddling a shard edge fires in BOTH shards (per-shard
    min_gap suppression cannot see across the boundary): after the global
    time-sort, drop any window within min_gap of its predecessor."""
    prev_t = F_nn.pad(tg_all[:, :-1], (1, 0), value=-(1 << 30))
    return val_all & (tg_all - prev_t >= min_gap)


class _AutoDecode(_CaptureRun):
    def __init__(self, mesh, branches, window_len, k_per_shard, generic, q):
        super().__init__(mesh)
        branches = tuple(branches)
        bw_q = _BW_OF_Q[q]
        for m, cap in branches:
            assert m.bw == bw_q, f"branch {m} vs capture bandwidth {bw_q}"
            need = branch_window_len(m, cap)
            assert window_len >= need, (
                f"window_len {window_len} < {need} required by branch "
                f"({m.fmt.name} mcs{m.mcs}, {cap} sym)")
        if generic:
            assert q == 1, "the generic decoder covers the 20 MHz envelope"
        self.branches, self.w, self.k, self.q = (branches, window_len,
                                                 k_per_shard, q)
        self.generic = generic
        self.sig = SigTables(q)
        self.plan = PlanTables(q)
        if generic:
            from ..rx.generic import GenericSisoDecoder
            self.cap_max = max(cap for _, cap in branches)
            self.gen = GenericSisoDecoder(
                tuple((m.fmt, m.mcs) for m, _ in branches), self.cap_max,
                device="cpu")
            # (fmt, mcs) -> config row; -1 = no branch
            lut = np.full((3, 16), -1, np.int64)
            caps_tab = np.zeros(len(branches), np.int64)
            for j, (m, capj) in enumerate(branches):
                if lut[_FMT_CODE[m.fmt], m.mcs] < 0:
                    lut[_FMT_CODE[m.fmt], m.mcs] = j
                caps_tab[j] = capj
            self.register_buffer("lut", torch.from_numpy(lut))
            self.register_buffer("caps_tab", torch.from_numpy(caps_tab))
            self.n_bits_max = self.gen.n_bits_max
        else:
            self.steps = nn.ModuleList(RxStep(m, cap) for m, cap in branches)
            self.n_bits_max = max(cap * m.nDBPS for m, cap in branches)
        self._ready()

    def forward(self, capture) -> dict:
        ax, q, k = self.ax, self.q, self.k
        ax.check()
        xb2 = ax.block(capture, 1)
        b = xb2.shape[0]
        ext, t_ext = self._front(xb2, self.w, k + 1, q=q, plateau=20 * q,
                                 min_gap=600 * q)
        tl = xb2.shape[1]
        overflow = t_ext[:, k] < tl                     # [b] capacity hit
        xw, val_all, tg_all = self._windows(ext, t_ext[:, :k], self.w)
        ov_all = ax.gather(overflow, ax.sp, ax.n_sp).any(dim=0)
        val_all = _dedup_across_shards(val_all, tg_all, 600 * q)

        n_loc = b * k
        t0 = torch.zeros(n_loc, dtype=torch.int32, device=xw.device)
        meta = sig_parse(xw, t0, self.sig)
        plan = _auto_plan(meta, self.plan)

        # branch routing: first branch whose (fmt, mcs) matches and whose
        # symbol capacity fits
        if self.generic:
            fmt_c = plan["fmt"].clamp(0, 2).long()
            mcs_c = plan["mcs"].clamp(0, 15).long()
            bid = self.lut[fmt_c, mcs_c]
            bid = torch.where(
                (plan["fmt"] >= 0)
                & (plan["n_sym"] <= self.caps_tab[bid.clamp(min=0)]),
                bid, -1)
            nv = plan["n_sym"].clamp(1, self.cap_max)
            bits = self.gen.decode(xw, meta["ltf_start"].to(torch.int32),
                                   meta["cfo"], bid.clamp(min=0),
                                   nv).to(torch.int32)
        else:
            bid = torch.full((n_loc,), -1, dtype=torch.int64,
                             device=xw.device)
            for j, (m, capj) in enumerate(self.branches):
                match = ((plan["fmt"] == _FMT_CODE[m.fmt])
                         & (plan["mcs"] == m.mcs) & (plan["n_sym"] <= capj))
                bid = torch.where((bid < 0) & match, j, bid)
            bits = torch.zeros((n_loc, self.n_bits_max), dtype=torch.int32,
                               device=xw.device)
            for j, step in enumerate(self.steps):
                bj = _pad_cols(step(xw, t0)["bits"], self.n_bits_max)
                bits = torch.where((bid == j)[:, None], bj, bits)
        ok = bid >= 0

        out = dict(bits=ax.regroup(bits, b, k), trig_t=tg_all,
                   ok=ax.regroup(ok, b, k) & val_all)
        for name in ("fmt", "mcs", "n_sym", "psdu_len", "ampdu"):
            out[name] = ax.regroup(plan[name], b, k)
        out["overflow"] = ov_all
        return {name: ax.gather_dp(v) for name, v in out.items()}


def sharded_capture_decode_auto(mesh: DeviceMesh, branches, window_len: int,
                                k_per_shard: int = 4, generic: bool = False,
                                q: int = 1) -> _AutoDecode:
    """Mixed-format sharded capture decode with on-device auto-detection.

    branches: static tuple of (Mod, n_sym_cap) decode branches. Every
    detected packet is planned on the device from its own SIG fields
    (sig_parse + _auto_plan) and routed to the first branch whose
    (format, mcs) matches and whose symbol capacity fits. Each branch's
    fixed-config RX step runs over all windows; outputs are one-hot
    selected (len(branches)x the single-config decode, no host round
    trip).

    generic=True replaces the per-branch decode loop with the table-driven
    rx/generic.GenericSisoDecoder: ONE shared-trellis decode whose
    per-window (rate, constellation, interleaver, depuncture) come from
    gathered config tables.

    Pipeline: sp-sharded STF autocorr with the halo -> trigger (capacity
    k_per_shard, with an overflow flag when a (k+1)-th rise survives the
    dedup) -> halo window extraction -> all-gather regroup -> per-window
    SIG parse + plan -> masked multi-branch decode -> all-gather of bits
    and plan meta.

    Returns run(capture [B, T, 2]; B over dp, T over sp) -> dict:
      bits [B, n_win, max_bits], trig_t, ok, fmt, mcs, n_sym, psdu_len,
      ampdu [B, n_win], overflow [B] (True => a shard saturated its
      trigger capacity and may have dropped packets).
    """
    return _AutoDecode(mesh, branches, window_len, k_per_shard, generic, q)


class _AutoDecode2(_CaptureRun):
    def __init__(self, mesh, branches, window_len, k_per_shard, branch_cap,
                 q, mu_branches, mu_pos, mu_gid):
        super().__init__(mesh)
        branches = tuple(branches)
        bw_q = _BW_OF_Q[q]
        self.decs = nn.ModuleList(
            (MimoDataDecoder(m, cap) if m.nSS == 2 else MrcDataDecoder(m, cap))
            for m, cap in branches)
        for (m, cap), dec in zip(branches, self.decs):
            assert m.bw == bw_q, f"branch {m} vs capture bandwidth {bw_q}"
            need = 272 * q + dec.data_offset() + (cap * 80 + 80) * q
            assert window_len >= need, (
                f"window_len {window_len} < {need} required by branch "
                f"({m.fmt.name} mcs{m.mcs} nSS{m.nSS}, {cap} sym)")
        mu_branches = tuple(mu_branches)
        assert not mu_branches or mu_gid is not None
        for m, cap in mu_branches:
            assert m.fmt == F.VHT and m.nSS == 1 and m.bw == bw_q
            need = (272 + 448 + 4 * 80 + 160 + cap * 80 + 80) * q
            assert window_len >= need, (
                f"window_len {window_len} < {need} required by MU branch "
                f"(VHT mcs{m.mcs}, {cap} sym)")
        self.mu_fns = nn.ModuleList(MuInGraph(m, cap, mu_pos, q)
                                    for m, cap in mu_branches)
        self.branches, self.mu_branches = branches, mu_branches
        self.w, self.k, self.q = window_len, k_per_shard, q
        self.branch_cap, self.mu_pos, self.mu_gid = branch_cap, mu_pos, mu_gid
        self.n_bits_max = max([cap * m.nDBPS for m, cap in branches]
                              + [cap * m.nDBPS for m, cap in mu_branches])
        self.sig = SigTables(q)
        self.plan = PlanTables(q)
        self._ready()

    def _routed(self, j: int, bid, n_loc: int):
        """(kj, sel): branch j's capacity and the windows it decodes, the
        ones routed to it first, in time order (a stable gather)."""
        widx = torch.arange(n_loc, device=bid.device)
        kj = min(self.branch_cap, n_loc)
        key = torch.where(bid == j, widx, n_loc + widx)
        return kj, torch.argsort(key)[:kj]

    def forward(self, capture) -> dict:
        ax, q, k = self.ax, self.q, self.k
        ax.check()
        xb2 = ax.block(capture, 2)
        b, nrx, tl, _ = xb2.shape
        # trigger on the max of per-chain autocorrelations: detection
        # survives one chain's fade
        ext, t_ext = self._front(xb2, self.w, k + 1, q=q, plateau=20 * q,
                                 min_gap=600 * q)
        overflow = t_ext[:, k] < tl
        xw, val_all, tg_all = self._windows(ext, t_ext[:, :k], self.w)
        ov_all = ax.gather(overflow, ax.sp, ax.n_sp).any(dim=0)
        val_all = _dedup_across_shards(val_all, tg_all, 600 * q)

        n_loc = b * k
        dev = xw.device
        t0 = torch.zeros(n_loc, dtype=torch.int32, device=dev)
        meta = sig_parse_mimo(xw, t0, self.sig)
        plan = _auto_plan2(meta, self.plan, self.mu_pos, self.mu_gid)
        ltf_start = meta["ltf_start"].to(torch.int32)
        cfo = meta["cfo"]

        # CFO-corrected complex windows (shared by the MU pass + NDP slice)
        w = self.w
        ys = r2c(xw) * sync.cfo_ramp(cfo, w)[:, None, :]

        n_br = len(self.branches)
        bid = torch.full((n_loc,), -1, dtype=torch.int64, device=dev)
        for j, (m, capj) in enumerate(self.branches):
            match = ((plan["fmt"] == _FMT_CODE[m.fmt]) & (plan["mcs"] == m.mcs)
                     & (plan["nss"] == m.nSS) & (plan["n_sym"] <= capj)
                     & ~plan["ndp"])
            bid = torch.where((bid < 0) & match, j, bid)
        if self.mu_branches:
            mu_nltf = self.plan.mu_nltf[plan["mu_nsts"].clamp(0, 4).long()]
            mu_mcs, mu_crc = self.mu_fns[0].sigb(ys, ltf_start, mu_nltf,
                                                 plan["mu_nsts"])
            for j, (m, capj) in enumerate(self.mu_branches):
                match = (plan["mu"] & (mu_mcs == m.mcs)
                         & (plan["mu_n_sym"] <= capj))
                bid = torch.where((bid < 0) & match, n_br + j, bid)

        nv_all = plan["n_sym"].clamp(min=1)
        bits = torch.zeros((n_loc, self.n_bits_max), dtype=torch.int32,
                           device=dev)
        br_ov = []
        for j, dec in enumerate(self.decs):
            capj = self.branches[j][1]
            if self.branch_cap is None:
                oj, _, _ = dec._decode(xw, ltf_start, cfo,
                                       nv_all.clamp(max=capj))
                bits = torch.where((bid == j)[:, None],
                                   _pad_cols(oj, self.n_bits_max), bits)
                br_ov.append(torch.zeros((), dtype=torch.bool, device=dev))
            else:
                kj, sel = self._routed(j, bid, n_loc)
                oj, _, _ = dec._decode(xw[sel], ltf_start[sel], cfo[sel],
                                       nv_all[sel].clamp(max=capj))
                mask = (bid[sel] == j)[:, None]
                # rows belong to <= 1 branch and start at zero -> add
                bits.index_add_(0, sel, torch.where(
                    mask, _pad_cols(oj, self.n_bits_max), 0))
                br_ov.append((bid == j).sum() > kj)
        sigb_ok_all = torch.ones(n_loc, dtype=torch.bool, device=dev)
        for j, mu_fn in enumerate(self.mu_fns):
            bj_id = n_br + j
            nvm = plan["mu_n_sym"].clamp(1, self.mu_branches[j][1])
            if self.branch_cap is None:
                oj, sb_ok = mu_fn.data(ys, ltf_start, mu_nltf,
                                       plan["mu_nsts"], nvm, mu_crc)
                sel_m = bid == bj_id
                bits = torch.where(sel_m[:, None],
                                   _pad_cols(oj, self.n_bits_max), bits)
                sigb_ok_all = torch.where(sel_m, sb_ok, sigb_ok_all)
                br_ov.append(torch.zeros((), dtype=torch.bool, device=dev))
            else:
                kj, sel = self._routed(bj_id, bid, n_loc)
                oj, sb_ok = mu_fn.data(ys[sel], ltf_start[sel], mu_nltf[sel],
                                       plan["mu_nsts"][sel], nvm[sel],
                                       mu_crc[sel])
                mine = bid[sel] == bj_id
                bits.index_add_(0, sel, torch.where(
                    mine[:, None], _pad_cols(oj, self.n_bits_max), 0))
                sigb_ok_all.index_put_(
                    (sel,), torch.where(mine, sb_ok, sigb_ok_all[sel]))
                br_ov.append((bid == bj_id).sum() > kj)
        branch_overflow = torch.stack(br_ov)[None, :].expand(b, -1)
        mu_win = bid >= n_br
        ok = (bid >= 0) & sigb_ok_all

        # NDP LTF windows (a fixed-size slice, masked by the flag): 2
        # VHT-LTF symbols per chain, CFO-corrected; starts clip to
        # [0, w - 160q] as dynamic_slice clamps them
        ndp_ltf = sync.batch_slice_iq(
            r_of(ys).reshape(n_loc * nrx, w, 2),
            (ltf_start + OFF_NLLTF * q).repeat_interleave(nrx),
            160 * q).reshape(n_loc, nrx, 160 * q, 2)

        # MU windows surface their own symbol count / data capacity
        n_sym_out = plan["n_sym"]
        psdu_out = plan["psdu_len"]
        if self.mu_branches:
            mu_ndbps = torch.zeros(n_loc, dtype=torch.int32, device=dev)
            for j, (m, _) in enumerate(self.mu_branches):
                mu_ndbps = torch.where(bid == n_br + j, m.nDBPS, mu_ndbps)
            mu_psdu = (plan["mu_n_sym"] * mu_ndbps - 16 - 6) // 8
            n_sym_out = torch.where(mu_win, plan["mu_n_sym"], n_sym_out)
            psdu_out = torch.where(mu_win, mu_psdu.clamp(min=0), psdu_out)

        rg = ax.regroup
        out = dict(bits=rg(bits, b, k), trig_t=tg_all,
                   ok=rg(ok, b, k) & val_all, fmt=rg(plan["fmt"], b, k),
                   mcs=rg(plan["mcs"], b, k), nss=rg(plan["nss"], b, k),
                   n_sym=rg(n_sym_out.to(torch.int32), b, k),
                   psdu_len=rg(psdu_out.to(torch.int32), b, k),
                   ampdu=rg(plan["ampdu"], b, k), mu=rg(mu_win, b, k),
                   ndp=rg(plan["ndp"], b, k) & val_all,
                   ndp_ltf=rg(ndp_ltf, b, k), overflow=ov_all,
                   branch_overflow=branch_overflow)
        return {name: ax.gather_dp(v) for name, v in out.items()}


def sharded_capture_decode_auto2(mesh: DeviceMesh, branches,
                                 window_len: int, k_per_shard: int = 4,
                                 branch_cap: int | None = None, q: int = 1,
                                 mu_branches=(), mu_pos: int = 0,
                                 mu_gid: int | None = None) -> _AutoDecode2:
    """DUAL-CHAIN mixed-format sharded capture decode with on-device
    auto-detection — the one-program mesh analog of the reference's rx2
    flowgraph: SISO packets decode with MRC combining across both chains,
    2x2 packets with the MIMO detector (its default, "ml"), and VHT NDPs
    emit their CFO-corrected LTF windows.

    branches: static tuple of (Mod, n_sym_cap) with mod.nSS in {1, 2}.

    branch_cap: optional per-branch window capacity K. Without it every
    branch decodes ALL windows and outputs are one-hot selected. With it,
    each branch gathers at most K windows whose planned (fmt, mcs, nSS)
    matches (in time order), so the decode cost is sum_j K_j x cost_j;
    `branch_overflow[j]` flags truncation.

    mu_branches/mu_pos/mu_gid: optional downlink-MU decode branches for a
    station at group position mu_pos in group mu_gid — each a
    (Mod(F.VHT, mcs, bw, 1), n_sym_cap). MU windows are detected from
    SIG-A, their (mcs, len) decoded from a MU SIG-B pass, and routed like
    every other branch; `mu[b, j]` flags them and `ok` additionally
    requires the SIG-B CRC-8 vs SERVICE check.

    Returns run(capture [B, nRx, T, 2]; B over dp, T over sp) -> dict:
      bits [B, n_win, max_bits], trig_t, ok, fmt, mcs, nss, n_sym,
      psdu_len, ampdu, mu [B, n_win]; ndp [B, n_win] flag + ndp_ltf
      [B, n_win, nRx, 160q, 2] CFO-corrected VHT-LTF windows;
      overflow [B]; branch_overflow [B, n_branches (+ mu branches)].
    """
    return _AutoDecode2(mesh, branches, window_len, k_per_shard, branch_cap,
                        q, mu_branches, mu_pos, mu_gid)


class _MultichipStep(_ShardedRx):
    def forward(self, capture, windows, t0) -> dict:
        ax = self.ax
        ax.check()
        ac = sharded_frontend(self.mesh, capture)
        out = self.step(*self._local(windows, t0))
        # global packet counter: the cross-shard reduction of per-shard
        # counts
        n_ok = out["lsig_ok"].sum(dtype=torch.int32)
        dist.all_reduce(n_ok, group=ax.sp)
        dist.all_reduce(n_ok, group=ax.dp)
        return dict(ac_peak=ac.max(), n_ok=n_ok,
                    bits=ax.gather_rows(out["bits"]),
                    cfo=ax.gather_rows(out["cfo"]))


def multichip_step(mesh: DeviceMesh, mod: Mod, n_sym: int) -> _MultichipStep:
    """The full multi-chip step: halo-sharded front-end + batch-sharded
    decode + collective reduction of per-packet outcomes.
    run(capture [B, T, 2], windows [Bw, W, 2], t0 [Bw]) -> dict(ac_peak,
    n_ok, bits, cfo), global on every rank."""
    return _MultichipStep(mesh, mod, n_sym)
