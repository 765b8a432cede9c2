"""Decode observability: per-MCS counters and JSONL metric records.

A copy of ieee80211_tpu/utils/metrics.py, which cannot be imported where
there is no jax (ieee80211_tpu/utils/__init__.py imports riq.py, which
imports jax); tests/test_torch_receiver.py holds the two to the same
counters. Counters are keyed by (format, mcs), plus a JSONL emitter so that
harnesses consume records instead of parsing prints.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import sys
import time
from typing import Dict, Optional, TextIO, Tuple


@dataclasses.dataclass
class DecodeStats:
    n_trigger: int = 0
    n_sig_ok: int = 0
    n_decoded: int = 0
    n_fcs_ok: int = 0
    n_mu: int = 0        # downlink MU own-stream decodes (fcs-ok)
    n_ndp: int = 0       # NDP channel captures surfaced
    per_mcs_ok: Dict[Tuple[str, int], int] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(int))
    per_mcs_fail: Dict[Tuple[str, int], int] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(int))

    def record(self, fmt_name: str, mcs: int, ok: bool, mu: bool = False):
        self.n_decoded += 1
        if ok:
            self.n_fcs_ok += 1
            self.per_mcs_ok[(fmt_name, mcs)] += 1
            if mu:
                self.n_mu += 1
        else:
            self.per_mcs_fail[(fmt_name, mcs)] += 1

    def summary(self) -> dict:
        return {
            "triggers": self.n_trigger,
            "sig_ok": self.n_sig_ok,
            "decoded": self.n_decoded,
            "fcs_ok": self.n_fcs_ok,
            "mu_ok": self.n_mu,
            "ndp": self.n_ndp,
            "per_mcs_ok": {f"{f}{m}": v
                           for (f, m), v in sorted(self.per_mcs_ok.items())},
            "per_mcs_fail": {f"{f}{m}": v
                             for (f, m), v in
                             sorted(self.per_mcs_fail.items())},
        }


class JsonlEmitter:
    """Append structured metric records to a JSONL stream/file."""

    def __init__(self, stream: Optional[TextIO] = None,
                 path: Optional[str] = None):
        self._own = path is not None
        self.stream = open(path, "a") if path else (stream or sys.stdout)

    def emit(self, kind: str, **fields):
        rec = {"ts": time.time(), "kind": kind, **fields}
        self.stream.write(json.dumps(rec) + "\n")
        self.stream.flush()

    def close(self):
        if self._own:
            self.stream.close()
