"""The one traffic generator: captures and row batches from a traffic file's
parameters and a seed.

A traffic file (`phybench/traffic/<name>.json`) is data only. Its `kind`
says which shape of input it describes:

  stream  bursts of `captures_per_call` captures of `capture_samples` each
          ([chains, N] for a multi-chain configuration), packets placed one
          after another with zero gaps, until the next one would not fit;
  batch   `rows` pre-cut windows of one rate set, each holding one packet
          that starts `early` samples after the window's first sample.

Every packet is built by the frozen golden transmitter (`phybench/wifi`),
scaled by `amplitude`, shifted by its own CFO, passed through its channel
and given AWGN at `snr_db` below its mean received power.

A capture's work is the same for every seed: which packets it holds (rate
set, MPDU lengths) and the gap before each are drawn once from the
traffic's `shape_seed` (the rate sets in shuffled rounds, each set once per
round), and the run's seed only permutes that list and draws the payload
bytes, CFOs, channels and noise.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .wifi.mac import MacConfig, aggregate_vht, build_udp_mpdu
from .wifi.specs import (BW, F, Mod, ppdu_params_aggregate,
                         ppdu_params_nonaggregate)
from .wifi.tx import gen_ampdu, gen_mpdu

MAC = dict(addr1="f4:69:d5:80:0f:a0", addr2="00:c0:ca:b1:5b:e1",
           addr3="f4:69:d5:80:0f:a0")
FMT = {"L": F.L, "HT": F.HT, "VHT": F.VHT}


@dataclasses.dataclass(frozen=True)
class Packet:
    """What the generator put on the air: the rate set, the PSDU's MPDUs,
    and where the packet's first sample lies (sample index in its capture
    or row)."""
    fmt: str
    mcs: int
    nss: int
    mpdus: Tuple[bytes, ...]
    start: int
    cfo_hz: float


@dataclasses.dataclass
class Stream:
    """Bursts: bursts[b][c] is capture c of burst b, complex64 [N] (one
    chain) or [chains, N]; packets[b][c] lists its packets in time order."""
    bursts: List[List[np.ndarray]]
    packets: List[List[List[Packet]]]

    def samples_per_burst(self, b: int) -> int:
        return sum(c.shape[-1] for c in self.bursts[b])


@dataclasses.dataclass
class Batch:
    """Row batches: x[b] is complex64 [rows, window], packets[b][r] the
    packet of row r; `fmt`, `mcs` and the PSDU length are common."""
    x: List[np.ndarray]
    packets: List[List[Packet]]
    fmt: str
    mcs: int
    psdu_len: int
    n_sym: int


def _rng(seed: int, *tags) -> np.random.Generator:
    """An independent stream per (seed, tags): any whole seed, also above
    32 bits, and the same numbers on every machine."""
    key = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    key += [zlib.crc32(str(t).encode()) for t in tags]
    return np.random.default_rng(np.random.SeedSequence(key))


def _rate_sets(rates) -> List[Tuple[str, int, int]]:
    """A list of [fmt, mcs list, nss] entries as (fmt, mcs, nss) sets."""
    out = []
    for fmt, mcss, nss in rates:
        out += [(fmt, int(m), int(nss)) for m in mcss]
    return out


def _mixes(traffic: dict) -> List[List[Tuple[str, int, int]]]:
    """`rates` is one list of rate sets; `mix` is several, and packets then
    take turns between them (half and half for two)."""
    if "mix" in traffic:
        return [_rate_sets(r) for r in traffic["mix"]]
    return [_rate_sets(traffic["rates"])]


def _payload_lengths(traffic: dict, rng: np.random.Generator,
                     cfg: MacConfig) -> Tuple[int, ...]:
    """One packet's UDP payload lengths: one, or, with `psdu_max`, as many
    as the VHT A-MPDU holds within psdu_max octets."""
    lo, hi = traffic["payload"]
    cap = traffic.get("psdu_max")
    lens = [int(rng.integers(lo, hi + 1))]
    while cap:
        nxt = int(rng.integers(lo, hi + 1))
        if len(aggregate_vht([build_udp_mpdu(bytes(n), cfg)
                              for n in lens + [nxt]])) > cap:
            break
        lens.append(nxt)
    return tuple(lens)


def _mpdus(lengths, rng: np.random.Generator, cfg: MacConfig
           ) -> Tuple[bytes, ...]:
    """UDP MPDUs with seeded random payloads of the given lengths."""
    return tuple(build_udp_mpdu(bytes(rng.integers(0, 256, n,
                                                   dtype=np.uint8)), cfg)
                 for n in lengths)


def _airtime(fmt: str, mcs: int, nss: int, lengths, cfg: MacConfig) -> int:
    """Samples of a packet's waveform, from its rate set and lengths."""
    mpdus = [build_udp_mpdu(bytes(n), cfg) for n in lengths]
    mod = Mod(FMT[fmt], mcs, BW.BW20, nss)
    if fmt == "VHT":
        pp = ppdu_params_aggregate(mod, len(aggregate_vht(mpdus)))
        pre = 400 + 160 + 80 + 80 * mod.nLTF + 80
    else:
        pp = ppdu_params_nonaggregate(mod, len(mpdus[0]))
        pre = 400 + (160 + 80 + 80 * mod.nLTF if fmt == "HT" else 0)
    return pre + 80 * pp.n_sym


def _shape(traffic: dict, cfg: MacConfig) -> list:
    """The packets of one capture, (rate set, payload lengths, gap), drawn
    from `shape_seed` until the next one would not fit."""
    rng = _rng(int(traffic["shape_seed"]), "shape")
    order = _order(_mixes(traffic), rng)
    room = int(traffic["capture_samples"]) - int(traffic["tail"])
    lo, hi = traffic["gap"]
    out = []
    while True:
        fmt, mcs, nss = next(order)
        lens = _payload_lengths(traffic, rng, cfg)
        gap = int(traffic["lead"]) + int(rng.integers(lo, hi))
        n = gap + _airtime(fmt, mcs, nss, lens, cfg)
        if n > room:
            return out
        room -= n
        out.append((fmt, mcs, nss, lens, gap))


def _waveform(fmt: str, mcs: int, nss: int, mpdus: Sequence[bytes]
              ) -> np.ndarray:
    """The golden waveform [nss, n] complex128 of one packet: L and HT carry
    one MPDU, VHT an A-MPDU."""
    mod = Mod(FMT[fmt], mcs, BW.BW20, nss)
    if fmt == "VHT":
        return gen_ampdu(aggregate_vht(list(mpdus)), mod).waveform
    assert len(mpdus) == 1
    return gen_mpdu(mpdus[0], mod).waveform


def _channel(traffic: dict, nss: int, rng: np.random.Generator
             ) -> Optional[np.ndarray]:
    """The packet's flat channel [chains, nss], or None for one chain and
    no channel. `channel.cond_max` redraws a CN(0, 1) 2x2 matrix until its
    condition number is at most that; a one-stream packet takes its first
    column."""
    ch = traffic.get("channel")
    if not ch:
        return None
    chains = int(ch["chains"])
    while True:
        h = (rng.normal(size=(chains, chains))
             + 1j * rng.normal(size=(chains, chains))) / np.sqrt(2)
        if np.linalg.cond(h) <= float(ch["cond_max"]):
            return h[:, :nss]


def _on_air(traffic: dict, wave: np.ndarray, cfo_hz: float,
            h: Optional[np.ndarray], rng: np.random.Generator) -> np.ndarray:
    """Amplitude, CFO, channel and AWGN: [chains, n] complex128."""
    n = wave.shape[-1]
    x = wave * float(traffic["amplitude"])
    x = x * np.exp(2j * np.pi * cfo_hz / 20e6 * np.arange(n))
    if h is not None:
        x = h @ x
    p = float(np.mean(np.abs(x) ** 2))
    sigma = np.sqrt(p / 10 ** (float(traffic["snr_db"]) / 10) / 2)
    return x + sigma * (rng.normal(size=x.shape) + 1j * rng.normal(
        size=x.shape))


def _rounds(rates, rng: np.random.Generator):
    """The rate sets in rounds, each round a fresh shuffle of all of them."""
    while True:
        for i in rng.permutation(len(rates)):
            yield rates[i]


def _order(mixes, rng: np.random.Generator):
    """Packets taking turns between the mixes, each mix in its rounds."""
    its = [_rounds(m, rng) for m in mixes]
    while True:
        for it in its:
            yield next(it)


def make_stream(traffic: dict, seed: int) -> Stream:
    """`distinct_bursts` bursts of the stream traffic `traffic`: every
    capture holds the packets of `_shape` in an order of its own."""
    cfg = MacConfig(subtype=8, seq=2704, **MAC)
    n = int(traffic["capture_samples"])
    chains = int(traffic.get("channel", {}).get("chains", 1))
    shape = _shape(traffic, cfg)
    bursts, packets = [], []
    for b in range(int(traffic["distinct_bursts"])):
        caps, pks = [], []
        for c in range(int(traffic["captures_per_call"])):
            rng = _rng(seed, "stream", b, c)
            cap = np.zeros((chains, n), np.complex64)
            pos, placed = 0, []
            for k in rng.permutation(len(shape)):
                fmt, mcs, nss, lens, gap = shape[k]
                mp = _mpdus(lens, rng, cfg)
                wave = _waveform(fmt, mcs, nss, mp)
                if wave.shape[-1] != _airtime(fmt, mcs, nss, lens, cfg):
                    raise AssertionError("airtime formula")
                start = pos + gap
                cfo = float(rng.uniform(*traffic["cfo_hz"]))
                x = _on_air(traffic, wave, cfo, _channel(traffic, nss, rng),
                            rng)
                cap[:, start:start + x.shape[-1]] = x
                placed.append(Packet(fmt, mcs, nss, mp, start, cfo))
                pos = start + x.shape[-1]
            caps.append(cap[0] if chains == 1 else cap)
            pks.append(placed)
        bursts.append(caps)
        packets.append(pks)
    return Stream(bursts, packets)


def make_batch(traffic: dict, seed: int) -> Batch:
    """`distinct_batches` batches of the batch traffic `traffic`: every row
    a distinct packet of the one rate set, its payload, CFO and noise its
    own."""
    cfg = MacConfig(subtype=8, seq=2704, **MAC)
    (fmt, mcs, nss), = _rate_sets(traffic["rates"])
    rows, win, early = (int(traffic[k]) for k in ("rows", "window", "early"))
    xs, pks = [], []
    psdu_len = n_sym = None
    for b in range(int(traffic["distinct_batches"])):
        rng = _rng(seed, "batch", b)
        x = np.zeros((rows, win), np.complex64)
        placed = []
        for r in range(rows):
            mp = _mpdus(_payload_lengths(traffic, rng, cfg), rng, cfg)
            wave = _waveform(fmt, mcs, int(nss), mp)[0]
            cfo = float(rng.uniform(*traffic["cfo_hz"]))
            seg = np.zeros(win, np.complex128)
            k = min(win - early, len(wave))
            seg[early:early + k] = wave[:k]
            ramp = np.exp(2j * np.pi * cfo / 20e6 * (np.arange(win) - early))
            sig = seg * float(traffic["amplitude"]) * ramp
            p = float(np.mean(np.abs(sig[early:early + k]) ** 2))
            sigma = np.sqrt(p / 10 ** (float(traffic["snr_db"]) / 10) / 2)
            x[r] = sig + sigma * (rng.normal(size=win)
                                  + 1j * rng.normal(size=win))
            placed.append(Packet(fmt, mcs, int(nss), mp, early, cfo))
            if fmt == "VHT":
                pp = ppdu_params_aggregate(Mod(F.VHT, mcs, BW.BW20, int(nss)),
                                           len(aggregate_vht(list(mp))))
                if psdu_len is None:
                    psdu_len, n_sym = pp.psdu_len, pp.n_sym
                if (pp.psdu_len, pp.n_sym) != (psdu_len, n_sym):
                    raise ValueError("a batch's rows must share one PSDU "
                                     "length: fix `payload` to one size")
        xs.append(x)
        pks.append(placed)
    if psdu_len is None:
        raise ValueError("batch traffic takes VHT rows")
    return Batch(xs, pks, fmt, mcs, psdu_len, n_sym)
