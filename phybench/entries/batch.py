"""Row-batch traffic: `RxPipeline.step` over pre-cut windows of one rate
set, one call per batch, in a closed loop from one client.

Inputs live on the card from set-up on, as a PDR sweep's rows do. A call
ends with the step's bits, CFO and SNR on the host, copied into page-locked
buffers made at set-up (a pageable copy goes through the driver's staging
buffer, at the host's memcpy speed). Its work is the rows' samples.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from phybench import compare, gen, ref
from phybench.metrics import work
from phybench.wifi.specs import BW, F, Mod


class Cell:
    """The cell's inputs, and with a device the program's step."""

    def __init__(self, config: dict, traffic: dict, seed: int, device=None):
        self.config, self.traffic = config, traffic
        self.data = gen.make_batch(traffic, seed)
        self.kept: List[tuple] = []
        self.traced = 0
        self.tracing = False
        if device is not None:
            self._program(device)

    def _program(self, device) -> None:
        from ieee80211_tpu_torch import models, specs
        d = self.data
        mod = specs.Mod(specs.F[d.fmt], d.mcs, specs.BW.BW20, 1)
        self.pipe = models.RxPipeline(mod, d.n_sym, d.psdu_len, device=device)
        if self.pipe.window_len() != d.x[0].shape[1]:
            raise ValueError(f"traffic window {d.x[0].shape[1]} is not the "
                             f"step's {self.pipe.window_len()}")
        self.x2 = [torch.from_numpy(np.ascontiguousarray(x).view(np.float32)
                                    .reshape(x.shape + (2,))).to(device)
                   for x in d.x]
        self.t0 = torch.zeros(d.x[0].shape[0], dtype=torch.int32,
                              device=device)
        self.samples = int(d.x[0].size)
        self.host = None
        self.device = device

    def _step(self, b: int):
        out = self.pipe.step(self.x2[b], self.t0)
        keys = ("bits", "cfo", "snr")
        if self.host is None:
            pin = self.device.type == "cuda"
            self.host = [torch.empty(out[k].shape, dtype=out[k].dtype,
                                     pin_memory=pin) for k in keys]
        for h, k in zip(self.host, keys):
            h.copy_(out[k], non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return self.host

    def warm(self) -> None:
        for b in range(len(self.x2)):
            self._step(b)

    def call(self, i: int, keep: bool) -> int:
        b = i % len(self.x2)
        bits, cfo, snr = self._step(b)
        if keep:
            self.kept.append((b, bits.numpy().copy(),
                              cfo.numpy().astype(np.float64),
                              snr.numpy().astype(np.float64)))
        if self.tracing:
            self.traced += 1
        return self.samples

    def slice_counts(self) -> Dict[str, float]:
        d = self.data
        rows = d.x[0].shape[0]
        return dict(calls=self.traced, steps=self.traced,
                    packets=self.traced * rows,
                    viterbi_steps=self.traced * (
                        rows * work.data_steps(d.fmt, d.mcs, 1, d.psdu_len)
                        + work.sig_steps(rows, fields=("lsig",))))

    def free(self) -> None:
        del self.pipe, self.x2, self.host

    def reference(self, prec: str = "f64") -> list:
        d = self.data
        mod = Mod(F[d.fmt], d.mcs, BW.BW20, 1)
        p = ref.Prec(prec)
        return [ref.decode_rows(x, np.zeros(len(x), np.int64), mod, d.n_sym,
                                p) for x in d.x]

    def numbers(self, reference: list, kept=None) -> Dict[str, float]:
        """The comparison's numbers of the kept calls (or of `kept`)."""
        return compare.batch_numbers(self.kept if kept is None else kept,
                                     reference, self.data.packets,
                                     self.data.psdu_len)

    @staticmethod
    def as_kept(outputs: list) -> list:
        """Reference outputs of every batch in the place of kept calls."""
        return [(b, o["bits"], o["cfo"], o["snr"])
                for b, o in enumerate(outputs)]


def end_to_end(win) -> Dict[str, float]:
    """batch_msps: the window's row samples over its seconds, in Msps."""
    return {"batch_msps": win.rate() / 1e6}


def build(config: dict, traffic: dict, seed: int, device) -> Cell:
    return Cell(config, traffic, seed, device)
