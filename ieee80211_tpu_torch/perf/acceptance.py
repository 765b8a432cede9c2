"""Reference-scale PDR acceptance sweep (SISO, 2x2 MIMO, MRC, fading, MU).

    python -m ieee80211_tpu_torch.perf.acceptance [--no-siso] [--no-mimo]
        [--no-wideband] [--no-mu] [--npkt N] [--payload B] [--snr ...]
        [--seed S] [--out artifacts/pdr_acceptance_torch.json]

Port of ieee80211_tpu/perf/acceptance.py (`_fir_taps` :65, `_mix_2x2` :82,
`_sweep_curves` :92, `_MrcPipe` :152, `_build_mrc_packet` :178,
`_MuStaPipe` :187, `_mu_curves` :211, `_snr_at` :291, `run_acceptance`
:300; `_packed_step` :37 and `_count_ok` :51 are in pdr.py, whose `_Row`
path `pdr_point` shares). 100 packets x SNR 0..30 dB x every MCS: SISO
{L0-7, HT0-7, VHT0-8} and 2x2 {HT8-15, VHT0-8} at the reference operating
point (500 B payload, signal amplitude 0.1875), decoded through the full
receive chain with FCS-exact acceptance; then MRC rows, per-packet fading
rows at 40/80 MHz swept to 36 dB, the unweighted-demap contrast row, and the
2- and 4-user MU closed loops. Writes a JSON artifact with the curves, the
waterfall positions (SNR at sustained 90% PDR) that
tests/test_torch_acceptance.py holds to tests/test_pdr_acceptance.py's
limits, the card's name and power limit, the torch and CUDA versions, the
seed, and the sweep's wall seconds and packets/s.

Each point adds its noise (pdr.awgn), decodes and packs the bits to bytes
on the pipeline's device, then fetches the bytes once through pinned memory
behind an event. Runs on the card unless `device="cpu"` is passed.
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..mac import aggregate_vht, build_udp_mpdu
from ..models import RxPipeline
from ..mu import map_q_to_grid, ndp_ltf_channel, vht_channel_feedback, zf_q
from ..mu.sounding import MuStaDecoder, sta_capture_ndp
from ..rx.mimo import MrcDataDecoder
from ..specs import BW, F, Mod, tables
from ..specs.modulation import ppdu_params_aggregate
from ..tx import finalize, gen_ampdu, gen_ampdu_mu
from ..utils.device import entry_device
from .pdr import (MAC_CFG_QOS, SIG_AMP, MimoRxPipeline, SyncedPipe, _Row,
                  _build_mimo_packet, _build_mimo_packet_bw, _build_packet,
                  _build_packet_bw, _payload, _prepare_row, _scaled,
                  batch_on, noise_amp_at, noise_generator, rx_window)

MU_GID = 2


def _fir_taps(rng, q: int) -> np.ndarray:
    """Random 3-tap multipath channel (delay spread < GI/2), unit energy:
    a direct path plus two delayed complex-Gaussian reflections inside
    8 samples (20 MHz units), well within the 16-sample GI."""
    taps = np.zeros(8 * q + 1, np.complex64)
    taps[0] = 1.0
    for lo, hi, amp in ((1, 4 * q + 1, 0.5), (4 * q + 1, 8 * q + 1, 0.25)):
        d = int(rng.integers(lo, hi))
        taps[d] += amp * (rng.standard_normal()
                          + 1j * rng.standard_normal()) / np.sqrt(2)
    return taps / np.linalg.norm(taps)


def _mix_2x2(rng) -> np.ndarray:
    """Random per-packet 2x2 mixing channel, Frobenius-normalized to
    sqrt(2) (unit average per-chain gain); the +1.8 I Ricean-style bias
    bounds the condition number as a line-of-sight component does."""
    h = ((rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2)))
         / np.sqrt(2) + 1.8 * np.eye(2))
    return h * np.sqrt(2) / np.linalg.norm(h)


def _chan_fir(q: int):
    """Per-packet multipath: wave convolved with a fresh _fir_taps draw."""
    def chan(rng, wave):
        return np.convolve(wave, _fir_taps(rng, q))[:len(wave)].astype(
            np.complex64)
    return chan


def _chan_mix(rng, wave2):
    return (_mix_2x2(rng) @ wave2).astype(np.complex64)


def _sweep_curves(build, pipe_cls, configs, snr_db, n_pkt, payload_len,
                  seed, log, chan=None, device=None) -> Dict[str, List[float]]:
    """chan: optional per-packet channel draw, chan(rng, wave) -> wave'.
    With chan=None every row is the clean waveform (AWGN on identity, the
    reference perf_siso methodology); with a channel the sweep measures
    ensemble PDR over random channels at calibrated AWGN. Decodes on
    `device` (default the card)."""
    dev = entry_device(device)
    curves: Dict[str, List[float]] = {}
    gen = noise_generator(seed, dev)
    for fmt, mcs in configs:
        t_start = time.time()
        row = _prepare_row(build, pipe_cls, fmt, mcs, n_pkt, payload_len,
                           seed, chan, dev)
        curve = [row.n_ok(gen, noise_amp_at(s)) / n_pkt for s in snr_db]
        name = f"{fmt.name}{mcs}"
        curves[name] = curve
        log(f"{name}: waterfall(90%)={_snr_at(snr_db, curve, 0.9)} "
            f"pdr@{snr_db[-1]}={curve[-1]:.2f} "
            f"[{time.time() - t_start:.1f}s]")
    return curves


class _MrcPipe(SyncedPipe):
    """Batched dual-chain decode of a fixed-config SISO packet by MRC
    combining (rx/mimo.MrcDataDecoder), timed and CFO-corrected from chain
    0. The acceptance row it feeds quantifies what the reference's
    chain-0-only legacy/SISO path leaves on the table: with a second
    equal-power chain, MRC buys ~3 dB of waterfall."""

    def __init__(self, mod, n_sym: int, psdu_len: int, device=None):
        dec = MrcDataDecoder(mod, n_sym)
        super().__init__(dec.q)
        self.mod, self.n_sym, self.psdu_len = mod, n_sym, psdu_len
        self._dec = dec
        self.to(entry_device(device))

    def window_len(self) -> int:
        return (192 + self._dec.data_offset()
                + (self.n_sym * 80 + 80) * self._dec.q)

    def forward(self, x2: torch.Tensor, t0: torch.Tensor):
        ltf_start, cfo, _snr = self.sync_front(x2[:, 0], t0)
        bits, _, _ = self._dec._decode(x2, ltf_start, cfo)
        return dict(bits=bits)


def _build_mrc_packet(fmt, mcs, payload_len, seed):
    """SISO VHT packet presented on TWO RX chains (unit-gain chain 0,
    identical to the siso AWGN rows, plus a unit-magnitude chain 1)."""
    mod, pp, mpdu, wave = _build_packet(fmt, mcs, payload_len, seed)
    h1 = np.exp(1j * 1.1)
    return mod, pp, mpdu, np.stack([wave, h1 * wave]).astype(np.complex64)


class _MuStaPipe(SyncedPipe):
    """Batched per-STA decode of a fixed-config MU PPDU: sync on the
    station's single antenna, then MuStaDecoder (P-row combining,
    joint-pilot tracking, own-stream ZF)."""

    def __init__(self, mod, n_sym: int, psdu_len: int, mupos: int,
                 n_sts_total: int = 2, device=None):
        super().__init__(1)
        self.mod, self.n_sym, self.psdu_len = mod, n_sym, psdu_len
        self._dec = MuStaDecoder(mod, n_sym, psdu_len, mupos, n_sts_total)
        self._n_ltf = int(tables.N_LTF[n_sts_total])
        self.to(entry_device(device))

    def window_len(self) -> int:
        return 192 + 448 + 80 * self._n_ltf + 80 + 80 * self.n_sym + 160

    def forward(self, x2: torch.Tensor, t0: torch.Tensor):
        ltf_start, cfo, _snr = self.sync_front(x2, t0)
        return dict(bits=self._dec(x2, ltf_start, cfo))


def _mu_sounding(seed: int, n_user: int, device) -> tuple:
    """The MU rows' channel and precoder: a fixed well-conditioned
    n_user x n_user channel h, sounded once through `sta_capture_ndp` on
    `device` and the numpy feedback. Returns (h, the ZF Q on the 64-tone
    grid)."""
    nu = n_user
    rng = np.random.default_rng(seed + 99)
    h = ((rng.standard_normal((nu, nu)) + 1j * rng.standard_normal((nu, nu)))
         / np.sqrt(2) + (2.0 + 0.5 * (nu - 2)) * np.eye(nu))
    h = h * np.sqrt(nu) / np.linalg.norm(h)
    ndp = gen_ampdu(b"", Mod(F.VHT, 0, BW.BW20, nu))
    ncap = finalize(ndp.waveform, multiplier=0.3, cfo_hz=4000.0, gap=True,
                    gap_len=1200)
    v_users = []
    for u in range(nu):
        nc = sta_capture_ndp((h[u] @ ncap).astype(np.complex64), n_sts=nu,
                             device=device)
        if nc is None:
            raise RuntimeError(f"sounding NDP capture failed at station {u}")
        v_users.append(vht_channel_feedback(
            ndp_ltf_channel(nc.ltf_iq, n_sts=nu), BW.BW20, n_sts=nu,
            n_rx=1))
    return h, map_q_to_grid(zf_q(v_users))


def _mu_packet(mcs: int, n_user: int, q64: np.ndarray, payload_len: int,
               seed: int):
    """The n_user MU PPDU at VHT mcs for every user, precoded by q64.
    Returns (mods, PPDU params, MPDUs, the group's symbol count, finalized
    waveform [n_user, N])."""
    mods = [Mod(F.VHT, mcs, BW.BW20, 1)] * n_user
    mpdus = [build_udp_mpdu(_payload(payload_len, seed + 31 * u),
                            MAC_CFG_QOS) for u in range(n_user)]
    amps = [aggregate_vht([mp]) for mp in mpdus]
    tx = gen_ampdu_mu(amps, mods, bfq=q64, group_id=MU_GID)
    pps = [ppdu_params_aggregate(m, len(a)) for m, a in zip(mods, amps)]
    return mods, pps, mpdus, max(p.n_sym for p in pps), _scaled(tx.waveform)


def _mu_rows(mcs: int, n_user: int, h: np.ndarray, q64: np.ndarray,
             n_pkt: int, payload_len: int, seed: int, dev) -> List[_Row]:
    """Every station's row of the MU PPDU at VHT mcs: its `_MuStaPipe` on
    dev and n_pkt copies of what its antenna hears, h[u] @ wave."""
    mods, pps, mpdus, n_sym_mu, wave = _mu_packet(mcs, n_user, q64,
                                                  payload_len, seed)
    rows = []
    for u in range(n_user):
        pipe = _MuStaPipe(mods[u], n_sym_mu, pps[u].psdu_len, u,
                          n_sts_total=n_user, device=dev)
        y = (h[u] @ wave).astype(np.complex64)
        rows.append(_Row(pipe, batch_on(rx_window(y, pipe.window_len()),
                                        n_pkt, dev), mpdus[u], True))
    return rows


def _mu_curves(snr_db, n_pkt, payload_len, seed, log, n_user: int = 2,
               mcs_list: Sequence[int] = (0, 2, 4), device=None
               ) -> Dict[str, List[float]]:
    """n_user MU-MIMO PDR: the full sounding -> feedback -> ZF -> MU-TX ->
    decode loop swept over AWGN, on `device` (default the card). The
    channel is a fixed well-conditioned n_user x n_user (sounded once,
    exact closed loop); PDR averages every STA's own-MPDU delivery."""
    dev = entry_device(device)
    h, q64 = _mu_sounding(seed, n_user, dev)
    curves: Dict[str, List[float]] = {}
    gen = noise_generator(seed, dev)
    for mcs in mcs_list:
        t_start = time.time()
        oks = np.zeros(len(snr_db))
        for row in _mu_rows(mcs, n_user, h, q64, n_pkt, payload_len, seed,
                            dev):
            for si, s in enumerate(snr_db):
                oks[si] += row.n_ok(gen, noise_amp_at(s))
        name = f"MU_VHT{mcs}x{n_user}"
        curves[name] = [float(v) for v in oks / (n_user * n_pkt)]
        log(f"{name}: waterfall(90%)="
            f"{_snr_at(snr_db, curves[name], 0.9)} "
            f"pdr@{snr_db[-1]}={curves[name][-1]:.2f} "
            f"[{time.time() - t_start:.1f}s]")
    return curves


def _snr_at(snr_db: Sequence[float], curve: Sequence[float],
            thresh: float) -> Optional[float]:
    """Lowest swept SNR from which PDR stays >= thresh (None if never)."""
    for i in range(len(curve)):
        if all(p >= thresh for p in curve[i:]):
            return snr_db[i]
    return None


def device_info(dev: torch.device) -> dict:
    """What ran the sweep: the card's name and power limit (nvidia-smi's
    line) and the torch and CUDA versions."""
    info = {"device": str(dev), "torch": torch.__version__,
            "cuda": torch.version.cuda}
    if dev.type == "cuda":
        info["name"] = torch.cuda.get_device_name(dev)
        info["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index}"],
            capture_output=True, text=True, check=True).stdout.strip()
    return info


def run_acceptance(n_pkt: int = 100, payload_len: int = 500,
                   snr_db: Optional[Sequence[float]] = None, seed: int = 0,
                   siso: bool = True, mimo: bool = True,
                   wideband: bool = True, mu: bool = True,
                   out_path: Optional[str] = None, quiet: bool = False,
                   device=None):
    """The sweep's groups on `device` (default the card); returns the
    artifact's dict and writes it to out_path when given."""
    dev = entry_device(device)
    log = (lambda m: None) if quiet else \
        (lambda m: print(m, file=sys.stderr, flush=True))
    if snr_db is None:
        snr_db = list(range(0, 31))
    result = {"n_pkt": n_pkt, "payload_len": payload_len,
              "snr_db": list(snr_db), "sig_amp": SIG_AMP, "seed": seed,
              "device": device_info(dev), "curves": {}, "seconds": {}}
    n_decoded = 0
    t_sweep = time.perf_counter()

    def group(name, n_pkts, sweep, *args, **kw):
        nonlocal n_decoded
        t = time.perf_counter()
        result["curves"][name] = sweep(*args, log=log, device=dev, **kw)
        result["seconds"][name] = time.perf_counter() - t
        n_decoded += n_pkts

    def rows(name, build, pipe_cls, configs, snr, chan=None):
        group(name, len(configs) * len(snr) * n_pkt, _sweep_curves, build,
              pipe_cls, configs, snr, n_pkt, payload_len, seed, chan=chan)

    if siso:
        rows("siso", _build_packet, RxPipeline,
             [(F.L, m) for m in range(8)] + [(F.HT, m) for m in range(8)]
             + [(F.VHT, m) for m in range(9)], snr_db)
    if mimo:
        rows("mimo_2x2", _build_mimo_packet, MimoRxPipeline,
             [(F.HT, m) for m in range(8, 16)]
             + [(F.VHT, m) for m in range(9)], snr_db)
        # SISO packets on the dual-chain receiver: MRC across chains,
        # directly comparable with the `siso` group (same packets, same
        # noise calibration, chain 0 identical)
        rows("siso_mrc_2rx", _build_mrc_packet, _MrcPipe,
             [(F.VHT, m) for m in (0, 4, 7)], snr_db)
    if wideband:
        # beyond-reference rows over per-packet random channels (multipath
        # for SISO, Ricean mixing for 2x2), swept to 36 dB: 256-QAM r=5/6
        # under the multipath ensemble waterfalls above 30 dB
        snr_wb = list(snr_db) + [s for s in (31, 32, 33, 34, 35, 36)
                                 if s > snr_db[-1]]
        result["snr_db_wideband"] = snr_wb
        for bw, tag in ((BW.BW40, "40"), (BW.BW80, "80")):
            q = tables.NFFT[bw] // 64
            rows(f"siso_fading_{tag}", _build_packet_bw(bw), RxPipeline,
                 [(F.VHT, m) for m in range(10)], snr_wb, chan=_chan_fir(q))
            # HT exists only at 20/40 MHz (802.11n); 80 MHz rows are VHT
            mimo_cfg = (([(F.HT, m) for m in range(8, 16)]
                         if bw == BW.BW40 else [])
                        + [(F.VHT, m) for m in range(10)])
            rows(f"mimo_2x2_fading_{tag}", _build_mimo_packet_bw(bw),
                 MimoRxPipeline, mimo_cfg, snr_wb, chan=_chan_mix)
        # contrast row: the same VHT7 @80 multipath sweep without per-tone
        # CSI LLR weighting (the reference's unweighted demap)
        rows("siso_fading_80_unweighted_llr", _build_packet_bw(BW.BW80),
             functools.partial(RxPipeline, csi_weight=False), [(F.VHT, 7)],
             snr_wb, chan=_chan_fir(4))
    if mu:
        for nu in (2, 4):
            group(f"mu_{nu}user", 3 * len(snr_db) * n_pkt * nu, _mu_curves,
                  snr_db, n_pkt, payload_len, seed, n_user=nu)
    result["wall_s"] = time.perf_counter() - t_sweep
    result["packets"] = n_decoded
    result["packets_per_s"] = n_decoded / result["wall_s"]

    # derived waterfall table (SNR at sustained 90% PDR); fading groups
    # use the extended wideband grid
    def _grid(grp):
        return result.get("snr_db_wideband", snr_db) \
            if "fading" in grp else snr_db
    result["waterfall_90pct"] = {
        grp: {k: _snr_at(_grid(grp), v, 0.9) for k, v in cs.items()}
        for grp, cs in result["curves"].items()}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f)
    return result


def main():
    import argparse
    ap = argparse.ArgumentParser(description="reference-scale PDR sweep")
    ap.add_argument("--npkt", type=int, default=100)
    ap.add_argument("--payload", type=int, default=500)
    ap.add_argument("--out", default="artifacts/pdr_acceptance_torch.json")
    ap.add_argument("--no-siso", action="store_true")
    ap.add_argument("--no-mimo", action="store_true")
    ap.add_argument("--no-wideband", action="store_true")
    ap.add_argument("--no-mu", action="store_true")
    ap.add_argument("--snr", type=float, nargs="*", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    res = run_acceptance(n_pkt=args.npkt, payload_len=args.payload,
                         snr_db=args.snr, seed=args.seed,
                         siso=not args.no_siso, mimo=not args.no_mimo,
                         wideband=not args.no_wideband, mu=not args.no_mu,
                         out_path=args.out)
    print(json.dumps({k: res[k] for k in ("wall_s", "packets",
                                          "packets_per_s")}))
    print(json.dumps(res["waterfall_90pct"]))


if __name__ == "__main__":
    main()
