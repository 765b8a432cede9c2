"""The comparison fails what it must: the lower-precision control (the
reference with its signal path in bfloat16, in the program's place) and a
run whose timed path is broken underneath (on the CPU, small sizes)."""
import time

import numpy as np
import pytest
import torch

from phybench import compare, harness, run

SMALL = {
    "siso20.stream_ampdu_4095": dict(capture_samples=1 << 16,
                                     captures_per_call=2, distinct_bursts=1,
                                     keep_share=1.0),
    "siso20.batch_vht7": dict(rows=8, distinct_batches=1, keep_share=1.0),
}


def _cell(name, seed):
    bench = harness.benchmark()
    w = harness.workload(bench, name)
    cfg = harness.config(w["config"])
    trf = dict(harness.traffic(w["traffic"]), **SMALL[name])
    return cfg, harness.entry(trf["kind"]).build(cfg, trf, seed, None)


@pytest.mark.parametrize("seed", [2 ** 33 + 1, 2 ** 34 + 7])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_is_not_correct(name, seed):
    cfg, cell = _cell(name, seed)
    f64 = cell.reference()
    assert harness.correct(compare.judged(
        cell.numbers(f64, kept=cell.as_kept(f64)), cfg["limits"]))
    checks = compare.judged(
        cell.numbers(f64, kept=cell.as_kept(cell.reference("bf16"))),
        cfg["limits"])
    assert not harness.correct(checks), checks


def _run(name):
    line, checks, _ = run.run_cell(name, 2 ** 33 + 5, 0.1, False,
                                   torch.device("cpu"), time.time(),
                                   overrides=SMALL[name])
    return line


def _stream_half(monkeypatch, cls):
    orig = cls.decode_captures

    def half(self, captures):
        out = orig(self, captures)
        return out[:len(out) // 2] + [[] for _ in out[len(out) // 2:]]
    monkeypatch.setattr(cls, "decode_captures", half)


def _stream_altered(monkeypatch, cls):
    """The first packet's PSDU and MPDU altered in the result the receiver
    returns, its FCS flag left as it was."""
    orig = cls.decode_captures

    def altered(self, captures):
        out = orig(self, captures)
        r = out[0][0]
        r.psdu = bytes([r.psdu[0] ^ 1]) + r.psdu[1:]
        r.mpdus = [bytes([m[0] ^ 1]) + m[1:] for m in r.mpdus]
        return out
    monkeypatch.setattr(cls, "decode_captures", altered)


def _batch(monkeypatch, fault):
    from ieee80211_tpu_torch.models import pipeline
    orig = pipeline.RxStep.forward

    def broken(self, x2, t0):
        out = orig(self, x2, t0)
        bits = out["bits"].clone()
        if fault == "half":
            bits[bits.shape[0] // 2:] = 0
        else:
            bits[0, 100] ^= 1
        return dict(out, bits=bits)
    monkeypatch.setattr(pipeline.RxStep, "forward", broken)


@pytest.mark.parametrize("fault", ["half", "altered"])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    assert _run(name)["correct"]
    if "batch" in name:
        _batch(monkeypatch, fault)
    else:
        from ieee80211_tpu_torch.rx import MimoReceiver, SisoReceiver
        cls = MimoReceiver if "mimo" in name else SisoReceiver
        (_stream_half if fault == "half" else _stream_altered)(
            monkeypatch, cls)
    line = _run(name)
    assert line["correct"] is False, line["checks"]


@pytest.mark.card
def test_a_cell_on_the_card():
    """One short run of the batch cell through run.py's main on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import contextlib
    import io
    import json
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(["--workload", "siso20.batch_vht7", "--seed", "3",
                       "--seconds", "2", "--trace", "0"])
    assert rc == 0
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert np.isfinite(line["metrics"]["batch_msps"]["value"])
