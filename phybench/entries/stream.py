"""Stream traffic: `decode_captures` of the configuration's receiver over
bursts of captures, one call per burst, in a closed loop from one client.

A call ends with every packet's result on the host. Its work is the burst's
samples along the time axis (once per capture, whatever its chains).
"""
from __future__ import annotations

from typing import Dict, List

from phybench import compare, gen, ref, ref_mimo
from phybench.metrics import work


class Cell:
    """The cell's inputs, and with a device the program's receiver."""

    def __init__(self, config: dict, traffic: dict, seed: int, device=None):
        self.config, self.traffic = config, traffic
        self.data = gen.make_stream(traffic, seed)
        if device is not None:
            from ieee80211_tpu_torch import rx
            from ieee80211_tpu_torch.utils.metrics import DecodeStats
            self.stats = DecodeStats()
            spec = config["stream"]
            self.rx = getattr(rx, spec["receiver"])(
                float(config["sample_rate_hz"]), stats=self.stats,
                device=device, **spec["options"])
        self.n_bursts = len(self.data.bursts)
        self.samples = [self.data.samples_per_burst(b)
                        for b in range(self.n_bursts)]
        self.kept: List[tuple] = []
        self.traced: List[tuple] = []   # (results, triggers, fcs_ok)
        self.tracing = False

    def warm(self) -> None:
        """Every distinct burst once: builds the kernels and every decoder
        that the window's groups use."""
        for burst in self.data.bursts:
            self.rx.decode_captures(burst)

    def call(self, i: int, keep: bool) -> int:
        b = i % self.n_bursts
        t0, f0 = self.stats.n_trigger, self.stats.n_fcs_ok
        out = self.rx.decode_captures(self.data.bursts[b])
        if keep:
            self.kept.append((b, out, self.stats.n_trigger - t0))
        if self.tracing:
            self.traced.append((out, self.stats.n_trigger - t0,
                                self.stats.n_fcs_ok - f0))
        return self.samples[b]

    def slice_counts(self) -> Dict[str, float]:
        """What the traced calls did, for the per-layer readers."""
        pk = [r for out, _, _ in self.traced for cap in out for r in cap]
        trig = sum(t for _, t, _ in self.traced)
        return dict(calls=len(self.traced), packets=len(pk),
                    triggers=trig,
                    fcs_ok=sum(f for _, _, f in self.traced),
                    viterbi_steps=work.sig_steps(trig) + sum(
                        work.data_steps(_fmt(r), r.mcs, _nss(r),
                                        len(r.psdu)) for r in pk))

    def free(self) -> None:
        del self.rx

    def reference(self, prec: str = "f64") -> list:
        """The plain reference of the configuration's chains over every
        distinct burst."""
        p = ref.Prec(prec)
        decode = {1: ref.decode_captures,
                  2: ref_mimo.decode_captures}[int(self.config["chains"])]
        return [decode(burst, self.int8(), p) for burst in self.data.bursts]

    def int8(self) -> bool:
        """The program's ingest of these captures, as the configuration
        states it: with ingest="auto", int8 once the padded capture passes
        `int8_above` samples."""
        mode = self.config["stream"]["options"].get("ingest", "auto")
        npad = ref.next_pow2(int(self.traffic["capture_samples"]) + 4096,
                             lo=1 << 15)
        return mode == "int8" or (mode == "auto" and npad > int(
            self.config["int8_above"]))

    def numbers(self, reference: list, kept=None) -> Dict[str, float]:
        """The comparison's numbers of the kept calls (or of `kept`)."""
        return compare.stream_numbers(self.kept if kept is None else kept,
                                      reference, self.data.packets)

    @staticmethod
    def as_kept(outputs: list) -> list:
        """Reference outputs of every burst in the place of kept calls."""
        return [(b, [res for _, res in caps], sum(t for t, _ in caps))
                for b, caps in enumerate(outputs)]


def end_to_end(win) -> Dict[str, float]:
    """stream_msps: the window's samples over its seconds, in Msps;
    burst_p95_ms: the 95th percentile of every call's latency."""
    return {"stream_msps": win.rate() / 1e6, "burst_p95_ms": win.p95() * 1e3}


def _fmt(r) -> str:
    return r.fmt if isinstance(r.fmt, str) else r.fmt.name


def _nss(r) -> int:
    """Streams of a result: HT MCS 8-15 are two; a VHT result reports one
    EVM per stream."""
    if _fmt(r) == "HT":
        return r.mcs // 8 + 1
    return len(r.sssnr) if _fmt(r) == "VHT" else 1


def build(config: dict, traffic: dict, seed: int, device) -> Cell:
    return Cell(config, traffic, seed, device)

