"""The port's benchmark (ieee80211_tpu_torch/perf/bench.py) against bench.py
on the CPU: every input function gives bench.py's input bit for bit (the
headline one against `bench.build_batch` itself, the others against
bench.py's recipes restated below with the JAX package's golden TX, at
reduced counts); `main` prints one JSON line with every key of bench.py's line,
read from bench.py's source; a row whose gate fails raises and prints
nothing.
"""
import ast
import json
import os
from pathlib import Path

import numpy as np
import pytest

import bench
from ieee80211_tpu.mac import MacConfig, aggregate_vht, build_udp_mpdu
from ieee80211_tpu.models import RxPipeline as JaxRxPipeline
from ieee80211_tpu.specs import BW, F, Mod
from ieee80211_tpu.specs.modulation import (ppdu_params_aggregate,
                                            ppdu_params_nonaggregate)
from ieee80211_tpu.tx import finalize, gen_ampdu, gen_ampdu_mu, gen_mpdu
from ieee80211_tpu.utils import c2r
from ieee80211_tpu_torch.perf import bench as pbench
from torch_parity import port_mod

REPO = Path(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the capture rows at the CPU's size; bench.py's recipes cut the same way
SMALL = pbench.Sizes(n_api=4, n_copy=3, n_stream=2, n_mimo_seg=4,
                     n_mimo_rep=2, n_mu_seg=4, n_mu_rep=2, n_mu_cap=2,
                     mu_tx_floor=2)
TINY = pbench.Sizes(n_api=2, n_copy=1, n_stream=1, n_mimo_seg=2,
                    n_mimo_rep=1, n_mu_seg=2, n_mu_rep=1, n_mu_cap=1,
                    mu_tx_floor=2)
CFG = MacConfig(subtype=8, addr1="f4:69:d5:80:0f:a0",
                addr2="00:c0:ca:b1:5b:e1", addr3="f4:69:d5:80:0f:a0",
                seq=2704)
PLAIN = MacConfig(addr1="f4:69:d5:80:0f:a0", addr2="00:c0:ca:b1:5b:e1",
                  addr3="f4:69:d5:80:0f:a0")


def _bench_line_keys():
    """The top-level keys of bench.py's JSON line and the keys of its
    `extra`, read from bench.py's source."""
    tree = ast.parse((REPO / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            if "extra" in keys:
                extra = node.values[keys.index("extra")]
                return keys, [k.value for k in extra.keys]
    raise AssertionError("bench.py has no line with an `extra`")


def test_headline_input_is_build_batch():
    jpipe, x, t0, mpdu = bench.build_batch(8)
    b = pbench.rx_batch(**dict(pbench.HEADLINE, batch=8))
    assert b.mod == port_mod(jpipe.mod)
    assert (b.n_sym, b.psdu_len) == (jpipe.n_sym, jpipe.psdu_len)
    assert b.x2.shape[1] == jpipe.window_len()
    np.testing.assert_array_equal(b.x2, x)
    np.testing.assert_array_equal(b.t0, t0)
    assert b.x2.dtype == x.dtype and b.t0.dtype == t0.dtype
    assert b.mpdu == mpdu


def test_wideband_input_is_bench_recipe():
    """bench.py:189-206 at batch 2."""
    pl = bytes(np.random.default_rng(1).integers(0, 256, 1800,
                                                 dtype=np.uint8))
    mpdu = build_udp_mpdu(pl, CFG)
    am = aggregate_vht([mpdu])
    mod = Mod(F.VHT, 9, BW.BW80, 1)
    pp = ppdu_params_aggregate(mod, len(am))
    wv = finalize(gen_ampdu(am, mod).waveform, multiplier=0.2,
                  cfo_hz=60000.0, gap=True, gap_len=256)[0]
    w = JaxRxPipeline(mod, pp.n_sym, pp.psdu_len).window_len()
    seg = wv[(64 - 8) * 4:]
    x = np.zeros((2, w), dtype=np.complex64)
    x[:, :min(w, len(seg))] = seg[:min(w, len(seg))]
    b = pbench.rx_batch(**dict(pbench.WIDEBAND, batch=2))
    assert b.mod == port_mod(mod) and b.mpdu == mpdu
    assert (b.n_sym, b.psdu_len) == (pp.n_sym, pp.psdu_len)
    np.testing.assert_array_equal(b.x2, c2r(x))
    np.testing.assert_array_equal(b.t0, np.zeros(2, np.int32))


def test_tx_inputs_are_bench_recipes():
    """bench.py:136-141 (TX) and :233-243 (MU TX), with the golden
    waveforms the port's TX rows are held to."""
    mpdu = build_udp_mpdu(b"123456789012345678901234567890",
                          MacConfig(addr1="f4:69:d5:80:0f:a0",
                                    addr2="00:c0:ca:b1:5b:e1",
                                    addr3="f4:69:d5:80:0f:a0", seq=2704))
    mod = Mod(F.L, 0)
    pmod, pp, pmpdu, wave = pbench.tx_input()
    assert pmod == port_mod(mod) and pmpdu == mpdu
    assert pp.n_sym == ppdu_params_nonaggregate(mod, len(mpdu)).n_sym
    np.testing.assert_array_equal(wave, gen_mpdu(mpdu, mod).waveform)
    rng = np.random.default_rng(2)
    a0 = aggregate_vht([build_udp_mpdu(bytes(rng.integers(
        0, 256, 500, dtype=np.uint8)), CFG)])
    a1 = aggregate_vht([build_udp_mpdu(bytes(rng.integers(
        0, 256, 300, dtype=np.uint8)), CFG)])
    mods = [Mod(F.VHT, 4, BW.BW20, 1), Mod(F.VHT, 2, BW.BW20, 1)]
    qm, _ = np.linalg.qr(rng.normal(size=(64, 2, 2))
                         + 1j * rng.normal(size=(64, 2, 2)))
    pmods, ampdus, pq, mu_wave = pbench.mu_tx_input()
    assert list(pmods) == [port_mod(m) for m in mods]
    assert ampdus == (a0, a1)
    np.testing.assert_array_equal(pq, qm)
    np.testing.assert_array_equal(mu_wave,
                                  gen_ampdu_mu([a0, a1], mods, qm).waveform)


def test_mu_sta_input_is_bench_recipe():
    """bench.py:300-318."""
    rng4 = np.random.default_rng(4)
    mpdus = [build_udp_mpdu(bytes(rng4.integers(0, 256, 500,
                                                dtype=np.uint8)), CFG)
             for _ in range(2)]
    amps = [aggregate_vht([m]) for m in mpdus]
    mods4 = [Mod(F.VHT, 4, BW.BW20, 1)] * 2
    qi = np.tile(np.eye(2, dtype=np.complex64)[None], (64, 1, 1))
    wave4 = finalize(gen_ampdu_mu(amps, mods4, bfq=qi, group_id=2).waveform,
                     multiplier=0.2, cfo_hz=-9000.0, gap=True, gap_len=64)
    pps4 = [ppdu_params_aggregate(m, len(a)) for m, a in zip(mods4, amps)]
    n_sym4 = max(p.n_sym for p in pps4)
    w4 = 192 + 448 + 160 + 80 + 80 * n_sym4 + 80
    x4 = np.zeros(w4, np.complex64)
    seg4 = wave4[0, 64 - 8:]
    x4[:min(w4, len(seg4))] = seg4[:min(w4, len(seg4))]
    mod, n_sym, psdu_len, x, mpdu = pbench.mu_sta_input()
    assert mod == port_mod(mods4[0])
    assert (n_sym, psdu_len) == (n_sym4, pps4[0].psdu_len)
    np.testing.assert_array_equal(x, x4)
    assert mpdu == mpdus[0]


def _api_recipe(n_api):
    """bench.py:362-381 with n_api packets."""
    rng = np.random.default_rng(3)
    parts, mpdus = [], []
    for i in range(n_api):
        pl = bytes(rng.integers(0, 256, int(rng.integers(100, 900)),
                                dtype=np.uint8))
        if i % 2:
            mpdus.append(build_udp_mpdu(pl, CFG))
            wv = gen_ampdu(aggregate_vht([mpdus[-1]]),
                           Mod(F.VHT, 7)).waveform
        else:
            mpdus.append(build_udp_mpdu(pl, PLAIN))
            wv = gen_mpdu(mpdus[-1], Mod(F.HT, 5)).waveform
        parts.append(finalize(wv, multiplier=0.2, cfo_hz=float(
            rng.uniform(-5e4, 5e4)), gap=True, gap_len=800)[0])
    return np.concatenate(parts), mpdus


def test_capture_inputs_are_bench_recipes():
    """bench.py's decode_capture capture (:362-381) and stream (:406-416)
    at SMALL's counts."""
    cap, mpdus = _api_recipe(SMALL.n_api)
    pcap, pmpdus = pbench.api_capture(SMALL)
    np.testing.assert_array_equal(pcap, cap)
    assert list(pmpdus) == mpdus
    rng2 = np.random.default_rng(7)
    big_parts = []
    for _ in range(SMALL.n_copy):
        big_parts.append(np.zeros(int(rng2.integers(16, 512)),
                                  np.complex64))
        big_parts.append(cap)
    big = np.concatenate(big_parts)
    caps = [np.concatenate([np.zeros(64 + 32 * k, np.complex64), big])
            for k in range(SMALL.n_stream)]
    got = pbench.stream_captures(SMALL)
    assert len(got) == len(caps)
    for a, b in zip(got, caps):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_mimo_stream_input_is_bench_recipe():
    """bench.py:460-490 at SMALL's counts."""
    h1 = np.array([0.9 - 0.3j, 0.5 + 0.8j])
    h22 = np.array([[1.1 + 0.2j, 0.3 - 0.5j], [-0.4 + 0.6j, 0.9 + 0.1j]])
    rng5 = np.random.default_rng(15)
    parts2, seg = [], []
    for i in range(SMALL.n_mimo_seg):
        pl = bytes(rng5.integers(0, 256, int(rng5.integers(100, 700)),
                                 dtype=np.uint8))
        mp = build_udp_mpdu(pl, CFG)
        if i % 2:
            mod = Mod(F.VHT, 4, BW.BW20, 2)
            wv = finalize(gen_ampdu(aggregate_vht([mp]), mod).waveform,
                          multiplier=0.2, cfo_hz=float(
                              rng5.uniform(-4e4, 4e4)), gap=False)
            w2 = h22 @ wv
        else:
            mod = Mod(F.VHT, 7)
            wv = finalize(gen_ampdu(aggregate_vht([mp]), mod).waveform,
                          multiplier=0.2, cfo_hz=float(
                              rng5.uniform(-4e4, 4e4)), gap=False)[0]
            w2 = np.stack([h1[0] * wv, h1[1] * wv])
        parts2.append(np.zeros((2, 800), np.complex64))
        parts2.append(w2.astype(np.complex64))
        seg.append((port_mod(mod), mp))
    big2 = np.concatenate([np.concatenate(parts2, axis=1)]
                          * SMALL.n_mimo_rep, axis=1)
    caps2 = [np.concatenate([np.zeros((2, 64 + 32 * k), np.complex64),
                             big2], axis=1) for k in range(SMALL.n_stream)]
    got, n, pseg = pbench.mimo_stream_captures(SMALL)
    assert n == SMALL.n_mimo_seg * SMALL.n_mimo_rep
    assert list(pseg) == seg
    assert len(got) == len(caps2)
    for a, b in zip(got, caps2):
        np.testing.assert_array_equal(a, b)


def test_mu_stream_input_is_bench_recipe():
    """bench.py:516-543 at SMALL's counts."""
    rng6 = np.random.default_rng(21)
    qi = np.tile(np.eye(2, dtype=np.complex64)[None], (64, 1, 1))
    parts6, mu, su = [], [], []
    for i in range(SMALL.n_mu_seg):
        pl0 = bytes(rng6.integers(0, 256, 400, dtype=np.uint8))
        pl1 = bytes(rng6.integers(0, 256, 300, dtype=np.uint8))
        m0 = build_udp_mpdu(pl0, CFG)
        if i % 2:
            mu6 = gen_ampdu_mu([aggregate_vht([m0]),
                                aggregate_vht([build_udp_mpdu(pl1, CFG)])],
                               [Mod(F.VHT, 4, BW.BW20, 1),
                                Mod(F.VHT, 2, BW.BW20, 1)],
                               bfq=qi, group_id=2)
            wv6 = finalize(mu6.waveform, multiplier=0.2,
                           cfo_hz=float(rng6.uniform(-3e4, 3e4)),
                           gap=False)[0]
            mu.append(m0)
        else:
            wv6 = finalize(gen_ampdu(aggregate_vht([m0]),
                                     Mod(F.VHT, 7)).waveform,
                           multiplier=0.2, cfo_hz=float(
                               rng6.uniform(-3e4, 3e4)), gap=False)[0]
            su.append(m0)
        parts6.append(np.zeros(800, np.complex64))
        parts6.append(wv6.astype(np.complex64))
    big6 = np.concatenate([np.concatenate(parts6)] * SMALL.n_mu_rep)
    caps6 = [np.concatenate([np.zeros(64 + 32 * k, np.complex64), big6])
             for k in range(SMALL.n_mu_cap)]
    got, pmu, psu = pbench.mu_stream_captures(SMALL)
    assert list(pmu) == mu * SMALL.n_mu_rep
    assert list(psu) == su * SMALL.n_mu_rep
    assert len(got) == len(caps6)
    for a, b in zip(got, caps6):
        np.testing.assert_array_equal(a, b)


def test_extra_keys_are_bench_py_keys():
    top, extra = _bench_line_keys()
    assert top == ["metric", "value", "unit", "vs_baseline", "extra"]
    assert list(pbench.EXTRA_KEYS) == extra


def _numbers(d):
    for v in d.values():
        if isinstance(v, dict):
            yield from _numbers(v)
        elif not isinstance(v, str):
            yield v


def test_main_prints_bench_line(capsys):
    assert pbench.main(["4", "1", "--rounds", "1"], device="cpu",
                       sizes=TINY) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    top, extra = _bench_line_keys()
    assert set(top) | {"backend", "rounds", "spread", "launches",
                       "device"} == set(line)
    # the plain versions run on the CPU: no kernel launches
    assert [name for name, _ in pbench.ROWS] == list(line["launches"])
    assert all(n == 0 for row in line["launches"].values()
               for n in row.values())
    assert list(line["extra"]) == extra
    assert line["metric"] == pbench.METRIC == ("rx_decode_samples_per_sec_"
                                              "per_chip_vht_mcs7_20mhz")
    assert line["unit"] == "samples/s"
    assert line["backend"] == line["extra"]["backend"] == "cpu"
    assert line["rounds"] == 1
    assert line["device"] == {"name": "cpu", "power_limit": None}
    assert line["vs_baseline"] == line["value"] / 20e6
    assert (line["extra"]["batch"], line["extra"]["iters"]) == (4, 1)
    assert set(line["extra"]["api_stream_mimo_sps_by_detector"]) == {
        "auto", "zf", "ml"}
    nums = [line["value"]] + list(_numbers(line["extra"]))
    assert nums and all(v > 0 for v in nums)
    # one round: each spread is the value itself
    assert line["spread"]["value"] == [line["value"]] * 2
    assert line["spread"]["api_stream_mimo_sps_by_detector"]["zf"] == [
        line["extra"]["api_stream_mimo_sps_by_detector"]["zf"]] * 2


def _flip(mpdu: bytes) -> bytes:
    return mpdu[:-1] + bytes([mpdu[-1] ^ 1])


def _wrong_headline(rx_batch):
    def build(**kw):
        b = rx_batch(**kw)
        return b._replace(mpdu=_flip(b.mpdu))
    return build


def _wrong_capture(api_capture):
    def build(sizes):
        cap, mpdus = api_capture(sizes)
        return cap, (_flip(mpdus[0]),) + mpdus[1:]
    return build


@pytest.mark.parametrize("maker,wrong", [
    ("rx_batch", _wrong_headline), ("api_capture", _wrong_capture)],
    ids=["headline_step", "decode_capture"])
def test_failed_gate_raises_and_prints_nothing(monkeypatch, capsys, maker,
                                               wrong):
    """The headline step's gate fails in its first round, decode_capture's
    in its warm pass: either raises, and no line is printed."""
    monkeypatch.setattr(pbench, maker, wrong(getattr(pbench, maker)))
    with pytest.raises(RuntimeError, match="gate failed"):
        pbench.main(["2", "1", "--rounds", "1"], device="cpu", sizes=TINY)
    assert capsys.readouterr().out == ""


def test_without_a_card_main_raises(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pbench.main(["2", "1"])
