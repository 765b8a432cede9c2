"""The comparison that decides `correct`: what the timed path produced,
against what the generator put on the air, and against the plain
reference (`phybench/ref.py`) run on the same inputs.

Each number is compared with the limit its configuration file states
(`limits`); PERF.md gives the readings each limit was set from.

Streams (every kept call, each capture of its burst):
  triggers_off  |triggers the program counted - the reference's|, summed
  wrong         MPDUs the program delivered (good FCS) that the capture
                did not carry, or carried in a packet of another format
                or MCS
  missed        MPDUs on the air that the program did not deliver, of
                those the reference delivers in every reading of their
                packet with a decision margin of at least MARGIN_TIE. The
                rest are not due: an MPDU whose packet the reference's
                float64 decode of the same samples loses is the channel's
                loss (AWGN at the traffic's SNR); one whose DATA the
                reference decodes with a narrower margin may decode
                either way in float32
  packets_off   the program's good-FCS packets whose format, MCS, PSDU or
                MPDUs differ from every reading of the reference's decode
                of the same packet (found by a shared MPDU); where that
                decode's margin is narrow, format, MCS and PSDU length
  cfo_gap_hz, snr_gap_db, evm_gap_db
                the widest gap of the front end's estimates over those
                packets, to the closest reading of the same format and MCS
A result whose FCS fails is not compared: the program drops its MPDUs, and
a trigger inside another packet's DATA field (BPSK symbols can hold the
STF's lag-16 correlation for 20 samples) gives one.
Row batches (every kept call):
  rows_off      rows whose descrambled bits differ anywhere
  missed        rows whose PSDU does not carry the generated MPDUs with a
                good FCS
  cfo_gap_hz, snr_gap_db
Where the reference holds tied readings (a plateau edge lag that lies
within float32's precision of the 0.88-of-peak threshold, or two chains
whose LTF SNRs tie: the program may read either way), a CFO, SNR or EVM
gap is taken to the closest reading.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import ref
from .wifi.specs import F


# A decode whose Viterbi margin (ref.viterbi_pairs) is below this share of
# its mean |LLR| may go either way in float32: rounding moves each LLR and
# path metric by about 1e-6 of that scale, and a margin sums some tens of
# them. The A-MPDU mix at 30 dB reads margins of 0.089 and more
MARGIN_TIE = 0.05


def _fmt(r) -> str:
    return r.fmt if isinstance(r.fmt, str) else r.fmt.name


def _key(r) -> tuple:
    return (_fmt(r), int(r.mcs), bytes(r.psdu), bool(r.fcs_ok),
            tuple(bytes(m) for m in r.mpdus))


def _readings(w) -> tuple:
    return (w,) + tuple(w.alts)


def stream_numbers(kept: Sequence[Tuple[int, list, int]],
                   reference: Sequence[Sequence[Tuple[int, list]]],
                   on_air: Sequence[Sequence[Sequence]]
                   ) -> Dict[str, float]:
    """kept: (burst, the program's per-capture results, triggers it
    counted); reference[burst][capture] = (triggers, results);
    on_air[burst][capture]: the generator's packets (`gen.Packet`)."""
    out = dict(triggers_off=0, wrong=0, missed=0, packets_off=0,
               cfo_gap_hz=0.0, snr_gap_db=0.0, evm_gap_db=0.0)
    for b, results, n_trig in kept:
        out["triggers_off"] += abs(n_trig - sum(t for t, _ in reference[b]))
        for got, (_, want), air in zip(results, reference[b], on_air[b]):
            sent = {m: p for p in air for m in p.mpdus}
            packet_of, due = {}, set()
            for w in want:
                opts = _readings(w)
                for m in {m for o in opts for m in o.mpdus}:
                    packet_of[m] = opts
                if min(o.margin for o in opts) >= MARGIN_TIE:
                    due |= set(w.mpdus).intersection(
                        *(o.mpdus for o in opts[1:]))
            delivered = set()
            for g in (r for r in got if r.fcs_ok):
                for m in g.mpdus:
                    p = sent.get(bytes(m))
                    if p is None or (p.fmt, p.mcs) != (_fmt(g), int(g.mcs)):
                        out["wrong"] += 1
                    delivered.add(bytes(m))
                opts = next((packet_of[bytes(m)] for m in g.mpdus
                             if bytes(m) in packet_of), None)
                if opts is None:
                    continue
                same = [o for o in opts if _key(o) == _key(g)]
                if not same and min(o.margin for o in opts) < MARGIN_TIE:
                    same = [o for o in opts if (_fmt(o), o.mcs, len(o.psdu))
                            == (_fmt(g), g.mcs, len(g.psdu))]
                if not same:
                    out["packets_off"] += 1
                    continue
                w = min(same, key=lambda o: abs(g.cfo_hz - o.cfo_hz))
                out["cfo_gap_hz"] = max(out["cfo_gap_hz"],
                                        abs(g.cfo_hz - w.cfo_hz))
                out["snr_gap_db"] = max(out["snr_gap_db"],
                                        abs(g.snr_db - w.snr_db))
                out["evm_gap_db"] = max(out["evm_gap_db"],
                                        abs(g.evm_snr_db - w.evm_snr_db))
            out["missed"] += len((due & sent.keys()) - delivered)
    return out


def _psdu_ok(bits: np.ndarray, psdu_len: int, mpdus) -> bool:
    psdu = np.packbits(bits[16:16 + 8 * psdu_len].astype(np.uint8),
                       bitorder="little").tobytes()
    ok, mp = ref.assemble(F.VHT, psdu, True)
    return ok and mp == tuple(mpdus)


def batch_numbers(kept: Sequence[Tuple[int, np.ndarray, np.ndarray,
                                       np.ndarray]],
                  reference: Sequence[Dict[str, np.ndarray]],
                  on_air: Sequence[Sequence], psdu_len: int
                  ) -> Dict[str, float]:
    """kept: (batch, bits [B, n], cfo [B] rad per sample, snr [B] dB) of
    the program; reference[batch]: `ref.decode_rows`'s dict."""
    out = dict(rows_off=0, missed=0, cfo_gap_hz=0.0, snr_gap_db=0.0)
    hz = 20e6 / (2 * np.pi)
    for b, bits, cfo, snr in kept:
        want = reference[b]
        same = np.all(bits.astype(np.int64) == want["bits"], axis=1)
        out["rows_off"] += int(np.sum(~same))
        out["missed"] += sum(not _psdu_ok(bits[r], psdu_len, p.mpdus)
                             for r, p in enumerate(on_air[b]))
        if same.any():
            gap = [min(abs(c - w) for w in [want["cfo"][r]]
                       + want["cfo_alts"][r])
                   for r, c in enumerate(cfo) if same[r]]
            out["cfo_gap_hz"] = max(out["cfo_gap_hz"], max(gap) * hz)
            out["snr_gap_db"] = max(out["snr_gap_db"], float(np.max(np.abs(
                snr[same] - want["snr"][same]))))
    return out


def judged(numbers: Dict[str, float], limits: Dict[str, float]
           ) -> Dict[str, Tuple[float, float]]:
    """Every number beside its limit, in a fixed order."""
    return {k: (float(numbers[k]), float(limits[k])) for k in numbers}


def missing_limits(numbers: Dict[str, float], limits: Dict[str, float]
                   ) -> List[str]:
    return [k for k in numbers if k not in limits]
