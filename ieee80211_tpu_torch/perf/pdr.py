"""PDR-vs-SNR sweep harness.

    python -m ieee80211_tpu_torch.perf.pdr --fmt L --mcs 0 7 --snr 0 10 30

Port of ieee80211_tpu/perf/pdr.py (`_build_packet` :40, `pdr_point` :61,
`pdr_sweep` :83, `MimoRxPipeline` :111, `_build_mimo_packet` :141,
`_build_packet_bw` :162, `_build_mimo_packet_bw` :186, `mimo_pdr_point`
:214, `mimo_pdr_sweep` :236). N packets per (MCS, SNR) point are impaired
with calibrated AWGN and pushed through the full receive chain (sync, CFO,
SIG, demod, Viterbi, FCS); the packet delivery ratio curve is the
acceptance metric. The packets are built by the golden numpy TX, uploaded
once per MCS, and every point adds its noise, decodes the batch and packs
the bits to bytes on the pipeline's device (the card unless `device="cpu"`
asks for the CPU), then fetches the bytes once (acceptance.py's
`_packed_step` and `_count_ok`, kept here in one `_Row` path for both
harnesses). The
noise is drawn by `torch.randn` from a generator on that device seeded with
`seed`, where the JAX package draws it with `jax.random.normal`: the two
packages' curves differ by the noise draw alone.

Reference operating point: 500 B random payload, signal amplitude 0.1875,
SNR 0..30 dB (noise amplitude = amp / 10^(SNR/20)).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..mac import MacConfig, aggregate_vht, build_udp_mpdu, deaggregate_vht
from ..models import RxPipeline
from ..models.pipeline import as_tables
from ..ops import sync
from ..rx.mimo import MimoDataDecoder
from ..rx.receiver import _Fetch, pack_bits_le
from ..specs import BW, F, Mod, tables
from ..specs.crc import fcs_ok
from ..specs.modulation import ppdu_params_aggregate, ppdu_params_nonaggregate
from ..tx import finalize, gen_ampdu, gen_mpdu
from ..utils import c2r
from ..utils.device import entry_device

MAC_CFG = MacConfig(addr1="f4:69:d5:80:0f:a0", addr2="00:c0:ca:b1:5b:e1",
                    addr3="f4:69:d5:80:0f:a0", seq=2704)
MAC_CFG_QOS = MacConfig(subtype=8, addr1="f4:69:d5:80:0f:a0",
                        addr2="00:c0:ca:b1:5b:e1",
                        addr3="f4:69:d5:80:0f:a0", seq=2704)

SIG_AMP = 0.1875   # reference LTF rms amplitude (perf_siso.py:92)


def noise_generator(seed: int, device: torch.device) -> torch.Generator:
    """The sweep's noise source: a generator on `device` seeded with seed."""
    return torch.Generator(device=device).manual_seed(seed)


def awgn(x2: torch.Tensor, noise_amp: float,
         gen: torch.Generator) -> torch.Tensor:
    """x2 [..., 2] float32 I/Q plus complex white noise of amplitude
    noise_amp (noise_amp / sqrt(2) per axis), drawn on x2's device."""
    noise = torch.randn(x2.shape, generator=gen, dtype=torch.float32,
                        device=x2.device)
    return x2 + noise * (noise_amp / np.sqrt(2))


def noise_amp_at(snr_db: float) -> float:
    """The noise amplitude at snr_db below the reference amplitude."""
    return SIG_AMP / (10 ** (snr_db / 20))


def noisy_batch(x1: np.ndarray, n_pkt: int, snr_db: float,
                seed: int) -> np.ndarray:
    """n_pkt copies of one window x1 [..., W, 2] plus white noise drawn by
    numpy (default_rng(seed)) at snr_db below the reference amplitude, as
    float32: one noise batch that two decoders (two devices, or two
    packages) can decode alike."""
    rng = np.random.default_rng(seed)
    x2 = np.broadcast_to(x1, (n_pkt,) + x1.shape)
    return (x2 + rng.standard_normal(x2.shape)
            * (noise_amp_at(snr_db) / np.sqrt(2))).astype(np.float32)


def rx_window(wave: np.ndarray, w: int, q: int = 1) -> np.ndarray:
    """The trigger-relative window of a finalized waveform ([N], or
    [nRx, N]) whose packet follows a 64q-sample gap: from 8q samples before
    the packet, zero-padded or cut to w samples, as float32 [..., w, 2]."""
    seg = wave[..., (64 - 8) * q:]
    x = np.zeros(wave.shape[:-1] + (w,), dtype=np.complex64)
    n = min(w, seg.shape[-1])
    x[..., :n] = seg[..., :n]
    return c2r(x)


def batch_on(x: np.ndarray, n_pkt: int, dev: torch.device) -> torch.Tensor:
    """One window uploaded once, seen as a batch of n_pkt copies."""
    x = torch.from_numpy(x).to(dev)
    return x.expand((n_pkt,) + tuple(x.shape))


def _payload(payload_len: int, seed: int) -> bytes:
    return bytes(np.random.default_rng(seed).integers(
        0, 256, payload_len, dtype=np.uint8))


def _scaled(waveform: np.ndarray, q: int = 1) -> np.ndarray:
    """finalize() with the multiplier that sets the time-domain rms over
    the LTF to the reference amplitude, and a 64q-sample leading gap."""
    ltf = waveform[0, 160 * q:320 * q]
    scale = SIG_AMP / np.sqrt(np.mean(np.abs(ltf) ** 2))
    return finalize(waveform, multiplier=scale, gap=True, gap_len=64 * q)


def _build_packet(fmt: F, mcs: int, payload_len: int, seed: int = 0):
    payload = _payload(payload_len, seed)
    if fmt == F.VHT:
        mpdu = build_udp_mpdu(payload, MAC_CFG_QOS)
        ampdu = aggregate_vht([mpdu])
        mod = Mod(fmt, mcs)
        tx = gen_ampdu(ampdu, mod)
        pp = ppdu_params_aggregate(mod, len(ampdu))
    else:
        mpdu = build_udp_mpdu(payload, MAC_CFG)
        mod = Mod(fmt, mcs)
        tx = gen_mpdu(mpdu, mod)
        pp = ppdu_params_nonaggregate(mod, len(mpdu))
    return mod, pp, mpdu, _scaled(tx.waveform)[0]


def _packed_step(step_fn):
    """Wrap a pipeline step: add AWGN on the step's device, decode, and
    pack the whole bytes of the bits there (little bit order, as
    np.packbits(bitorder='little')). run(x2, t0, gen, namp) -> uint8
    [B, n_bits // 8] on the device, not waited for."""
    def run(x2, t0, gen, namp):
        with torch.inference_mode():
            bits = step_fn(awgn(x2, namp, gen), t0)["bits"]
            return pack_bits_le(bits[:, :bits.shape[1] // 8 * 8])
    return run


def _fetch(t: torch.Tensor) -> np.ndarray:
    """A point's one device->host copy (pinned, behind an event)."""
    return _Fetch(t).result()


def _count_ok(pkts: np.ndarray, psdu_len: int, mpdu: bytes,
              ampdu: bool) -> int:
    """The byte rows whose PSDU carries exactly `mpdu` with a good FCS (as
    the only frame or as an A-MPDU subframe)."""
    n_ok = 0
    for row in pkts:
        psdu = row[2:2 + psdu_len].tobytes()   # skip 16 SERVICE bits
        if ampdu:
            n_ok += any(s.fcs_ok and s.mpdu == mpdu
                        for s in deaggregate_vht(psdu))
        else:
            n_ok += fcs_ok(psdu) and psdu == mpdu
    return n_ok


@dataclasses.dataclass
class _Row:
    """One configuration of a sweep, ready on the device: its pipeline, the
    uploaded batch xd [B, ...] and the MPDU that each packet must carry."""
    pipe: nn.Module
    xd: torch.Tensor
    mpdu: bytes
    ampdu: bool

    def packed(self, gen: torch.Generator, namp: float) -> torch.Tensor:
        """The batch plus noise of amplitude namp, decoded and packed on
        the device: uint8 [B, n_bits // 8], not waited for."""
        td = torch.zeros(self.xd.shape[0], dtype=torch.int32,
                         device=self.xd.device)
        return _packed_step(self.pipe.step)(self.xd, td, gen, namp)

    def n_ok(self, gen: torch.Generator, namp: float) -> int:
        """One noise level: the packets that carry the MPDU, counted on
        the host after the point's one fetch."""
        return _count_ok(_fetch(self.packed(gen, namp)), self.pipe.psdu_len,
                         self.mpdu, self.ampdu)


def _prepare_row(build, pipe_cls, fmt: F, mcs: int, n_pkt: int,
                 payload_len: int, seed: int, chan, dev) -> _Row:
    """Build the packet of (fmt, mcs) and its pipeline on dev, and upload
    the row's batch: one clean window seen n_pkt times (chan=None), or
    n_pkt windows through the channel draws chan(rng, wave) of
    default_rng(seed * 7919 + mcs)."""
    mod, pp, mpdu, wave = build(fmt, mcs, payload_len, seed)
    pipe = pipe_cls(mod, pp.n_sym, pp.psdu_len, device=dev)
    w = pipe.window_len()
    q = tables.NFFT[mod.bw] // 64
    if chan is None:
        xd = batch_on(rx_window(wave, w, q), n_pkt, dev)
    else:
        crng = np.random.default_rng(seed * 7919 + mcs)
        xd = torch.from_numpy(np.stack([
            rx_window(chan(crng, wave), w, q) for _ in range(n_pkt)])).to(dev)
    return _Row(pipe, xd, mpdu, fmt == F.VHT)


def pdr_point(pipe, x2: torch.Tensor, mpdu: bytes, noise_amp: float,
              gen: torch.Generator, ampdu: bool) -> float:
    """Decode one batch (x2 [B, W, 2], or [B, nRx, W, 2] with independent
    AWGN per RX chain) at one noise level; return the delivery ratio."""
    return _Row(pipe, x2, mpdu, ampdu).n_ok(gen, noise_amp) / x2.shape[0]


mimo_pdr_point = pdr_point


def _sweep(build, pipe_cls, fmt: F, mcs_list, snr_db, n_pkt: int,
           payload_len: int, seed: int, device) -> Dict[int, List[float]]:
    dev = entry_device(device)
    gen = noise_generator(seed, dev)
    curves: Dict[int, List[float]] = {}
    for mcs in mcs_list:
        row = _prepare_row(build, pipe_cls, fmt, mcs, n_pkt, payload_len,
                           seed, None, dev)
        curves[mcs] = [row.n_ok(gen, noise_amp_at(s)) / n_pkt
                       for s in snr_db]
    return curves


def pdr_sweep(fmt: F = F.VHT, mcs_list: Optional[Sequence[int]] = None,
              snr_db: Optional[Sequence[float]] = None, n_pkt: int = 100,
              payload_len: int = 500, seed: int = 0,
              device=None) -> Dict[int, List[float]]:
    """PDR curves per MCS over an SNR sweep (reference perf_siso
    semantics), decoded by `RxPipeline` on `device` (default the card)."""
    if mcs_list is None:
        mcs_list = list(range(9)) if fmt == F.VHT else list(range(8))
    if snr_db is None:
        snr_db = list(range(0, 31))
    return _sweep(_build_packet, RxPipeline, fmt, mcs_list, snr_db, n_pkt,
                  payload_len, seed, device)


class SyncedPipe(nn.Module):
    """A fixed-config batched receiver that times and CFO-corrects every
    packet from one chain (chain 0 where there are two: the chains share
    one LO) with its own LTF band buffer at oversample factor q, then
    decodes it. `step(x2, t0)` runs it."""

    def __init__(self, q: int):
        super().__init__()
        self.q = q
        self.register_buffer("band", torch.from_numpy(
            as_tables({"band": sync.ltf_band_mat(q)})["band"]))

    def sync_front(self, x1: torch.Tensor, t0: torch.Tensor):
        """(ltf_start, cfo, snr) of one chain's windows x1 [B, W, 2]."""
        return sync.sync_front_iq(x1.contiguous(), t0, self.band, q=self.q)

    def step(self, x2: torch.Tensor, t0: torch.Tensor):
        return self(x2, t0)


class MimoRxPipeline(SyncedPipe):
    """Fixed-config batched 2x2 RX: chain-0 sync + 2-stream data decode
    (the default "ml" detector), on `device` (default the card).

    The 2-stream analog of models.RxPipeline, used by the MIMO PDR sweep
    (reference perf_sumimo.py semantics: known config, AWGN on both RX
    chains, full chain incl. sync/CFO/channel-est/detection/Viterbi/FCS).
    """

    def __init__(self, mod: Mod, n_sym: int, psdu_len: int, device=None):
        super().__init__(tables.NFFT[mod.bw] // 64)
        self.mod, self.n_sym, self.psdu_len = mod, n_sym, psdu_len
        self._dec = MimoDataDecoder(mod, n_sym)
        self.to(entry_device(device))

    def window_len(self) -> int:
        extra = 80 if self.mod.fmt == F.VHT else 0
        return (192 + 448 + 80 * self.mod.nLTF + extra
                + 80 * self.n_sym + 80) * self.q

    def forward(self, x2: torch.Tensor, t0: torch.Tensor):
        """x2 [B, 2, W, 2] float32, t0 [B] int32 -> dict of bits,
        ltf_start, cfo and snr, as the JAX step."""
        ltf_start, cfo, snr = self.sync_front(x2[:, 0], t0)
        bits, _, _ = self._dec._decode(x2, ltf_start, cfo)
        return dict(bits=bits, ltf_start=ltf_start, cfo=cfo, snr=snr)


def _build_mimo_packet(fmt: F, mcs: int, payload_len: int, seed: int = 0):
    """2-stream (nSS=2) packet; HT mcs is the 2-stream index 8..15."""
    return _build_mimo_packet_bw(BW.BW20)(fmt, mcs, payload_len, seed)


def _build_packet_bw(bw: BW):
    """Builder factory: SISO VHT packets at 40/80 MHz (beyond the
    reference envelope). Same (fmt, mcs, payload, seed) signature as
    _build_packet for the acceptance sweep."""
    q = tables.NFFT[bw] // 64

    def build(fmt: F, mcs: int, payload_len: int, seed: int = 0):
        mpdu = build_udp_mpdu(_payload(payload_len, seed), MAC_CFG_QOS)
        ampdu = aggregate_vht([mpdu])
        mod = Mod(F.VHT, mcs, bw, 1)
        tx = gen_ampdu(ampdu, mod)
        pp = ppdu_params_aggregate(mod, len(ampdu))
        return mod, pp, mpdu, _scaled(tx.waveform, q)[0]
    return build


def _build_mimo_packet_bw(bw: BW):
    """Builder factory: 2-stream packets at 20/40/80 MHz (HT mcs 8..15 or
    VHT nSTS=2); the waveform is [2, N]."""
    q = tables.NFFT[bw] // 64

    def build(fmt: F, mcs: int, payload_len: int, seed: int = 0):
        payload = _payload(payload_len, seed)
        if fmt == F.VHT:
            mpdu = build_udp_mpdu(payload, MAC_CFG_QOS)
            ampdu = aggregate_vht([mpdu])
            mod = Mod(fmt, mcs, bw, 2)
            tx = gen_ampdu(ampdu, mod)
            pp = ppdu_params_aggregate(mod, len(ampdu))
        else:
            mpdu = build_udp_mpdu(payload, MAC_CFG)
            mod = Mod(F.HT, mcs, bw, 2)
            tx = gen_mpdu(mpdu, mod)
            pp = ppdu_params_nonaggregate(mod, len(mpdu))
        return mod, pp, mpdu, _scaled(tx.waveform, q)
    return build


def mimo_pdr_sweep(fmt: F = F.VHT, mcs_list: Optional[Sequence[int]] = None,
                   snr_db: Optional[Sequence[float]] = None, n_pkt: int = 100,
                   payload_len: int = 500, seed: int = 0, device=None
                   ) -> Dict[int, List[float]]:
    """2x2 SU-MIMO PDR curves (reference perf_sumimo.py analog), on
    `device` (default the card).

    AWGN on both chains through the full 2-stream RX: sync, CFO, dual-LTF
    MIMO channel estimation, max-log ML detection, joint pilot tracking,
    stream deparser, Viterbi, FCS.
    """
    if mcs_list is None:
        mcs_list = list(range(9)) if fmt == F.VHT else list(range(8, 16))
    if snr_db is None:
        snr_db = list(range(0, 31))
    return _sweep(_build_mimo_packet, MimoRxPipeline, fmt, mcs_list, snr_db,
                  n_pkt, payload_len, seed, device)


def main():
    import argparse
    ap = argparse.ArgumentParser(description="PDR vs SNR sweep")
    ap.add_argument("--fmt", default="VHT", choices=["L", "HT", "VHT"])
    ap.add_argument("--mcs", type=int, nargs="*", default=None)
    ap.add_argument("--snr", type=float, nargs="*", default=None)
    ap.add_argument("--npkt", type=int, default=100)
    ap.add_argument("--payload", type=int, default=500)
    args = ap.parse_args()
    curves = pdr_sweep(F[args.fmt], args.mcs, args.snr, args.npkt,
                       args.payload)
    print(json.dumps({str(k): v for k, v in curves.items()}))


if __name__ == "__main__":
    main()
