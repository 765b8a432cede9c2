"""The port's acceptance sweep (ieee80211_tpu_torch/perf/acceptance.py)
against the JAX package's (ieee80211_tpu/perf/acceptance.py) on the CPU,
and the committed H100 artifact against the JAX package's limits.

Everything but the AWGN draw is numpy in both packages and must match
exactly: the fading channels (`_fir_taps`, `_mix_2x2`), the MU sounding's
captures (its Q within 1e-5), the MU payloads, `_snr_at` and `_count_ok`.
The window lengths of the sweep's pipes equal JAX's for every configuration the sweep
runs. The packed-byte steps of `RxPipeline` (weighted and unweighted),
`_MrcPipe` and `_MuStaPipe` decode one numpy noise batch to the same bytes
as JAX's at 30 dB and to ok-counts within 1 of 20 at a waterfall SNR (the
port's Viterbi takes radix-3 tables, as the JAX CPU decoder runs).
`artifacts/pdr_acceptance_torch.json` must pass
tests/test_pdr_acceptance.py's threshold checks unchanged, and every
waterfall in it must sit within 2 dB of the TPU artifact's.
"""
import functools
import json
import os

import numpy as np
import pytest

from ieee80211_tpu.models import RxPipeline as JaxRxPipeline
from ieee80211_tpu.perf import acceptance as jacc
from ieee80211_tpu.perf import pdr as jpdr
from ieee80211_tpu.specs import BW, F
from ieee80211_tpu_torch.models import RxPipeline
from ieee80211_tpu_torch.perf import acceptance as acc
from ieee80211_tpu_torch.perf import pdr
from ieee80211_tpu_torch.specs import (Mod, ppdu_params_aggregate,
                                      ppdu_params_nonaggregate)
from torch_parity import assert_packed_parity, packed_both, radix3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART_TPU = os.path.join(REPO, "artifacts", "pdr_acceptance.json")
ART_TORCH = os.path.join(REPO, "artifacts", "pdr_acceptance_torch.json")
WATERFALL_TOL_DB = 2
Q_TOL = 1e-5    # the ZF Q of two float32 CFO estimates (|Q| <= 1)
PAYLOAD = 100
N_PKT = 20


def QUIET(msg: str) -> None:
    """The sweeps' log, silenced."""


@pytest.mark.parametrize("q", [1, 2, 4])
def test_fading_draws_equal_jax(q):
    """A sweep row's 100 channel draws, in the sweep's order."""
    for seed in (0, 7919 * 3 + 7):
        rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(100):
            np.testing.assert_array_equal(acc._fir_taps(rng, q),
                                          jacc._fir_taps(jrng, q))
            np.testing.assert_array_equal(acc._mix_2x2(rng),
                                          jacc._mix_2x2(jrng))


def test_snr_at_equal_jax():
    rng = np.random.default_rng(1)
    cases = [([0, 1, 2, 3], [0.0, 0.95, 0.8, 1.0]), ([0, 1, 2],
                                                       [0.0, 0.95, 1.0]),
             ([0, 1], [0.0, 0.5])]
    cases += [(list(range(31)), list(np.sort(rng.uniform(0, 1, 31))))
              for _ in range(20)]
    for snr, curve in cases:
        for th in (0.5, 0.9):
            assert acc._snr_at(snr, curve, th) == jacc._snr_at(snr, curve,
                                                               th)
    assert acc._snr_at([0, 1, 2, 3], [0.0, 0.95, 0.8, 1.0], 0.9) == 3


@pytest.mark.parametrize("fmt", [F.L, F.VHT])
def test_count_ok_equal_jax(fmt):
    """Byte rows of the right PSDU, with one bit flipped in some rows (in
    the MPDU, in the A-MPDU delimiter, in the padding)."""
    mod, pp, mpdu, _ = pdr._build_packet(fmt, 3, PAYLOAD, 0)
    ampdu = fmt == F.VHT
    psdu = jpdr.aggregate_vht([mpdu]) if ampdu else mpdu
    row = np.zeros(pp.n_sym * mod.nDBPS // 8, np.uint8)
    row[2:2 + len(psdu)] = np.frombuffer(psdu, np.uint8)
    rows = np.tile(row, (12, 1))
    rng = np.random.default_rng(2)
    for i, pos in enumerate(rng.integers(0, 2 + pp.psdu_len, 8)):
        rows[i, pos] ^= 1 << int(rng.integers(0, 8))
    got = pdr._count_ok(rows, pp.psdu_len, mpdu, ampdu)
    assert got == jacc._count_ok(rows, pp.psdu_len, mpdu, ampdu)
    assert 4 <= got < 12


def _pp(mod):
    """The PPDU parameters of the sweep's 500 B packet (seed 0) at mod."""
    payload = pdr._payload(500, 0)
    if mod.fmt == F.VHT:
        return ppdu_params_aggregate(mod, len(acc.aggregate_vht(
            [acc.build_udp_mpdu(payload, pdr.MAC_CFG_QOS)])))
    return ppdu_params_nonaggregate(mod, len(acc.build_udp_mpdu(
        payload, pdr.MAC_CFG)))


def test_siso_window_len_equal_jax():
    """RxPipeline for every SISO, fading and MRC row of the sweep."""
    rows = ([(F.L, m, BW.BW20) for m in range(8)]
            + [(F.HT, m, BW.BW20) for m in range(8)]
            + [(F.VHT, m, bw) for bw in (BW.BW20, BW.BW40, BW.BW80)
               for m in range(10) if (bw, m) != (BW.BW20, 9)])
    for fmt, mcs, bw in rows:
        mod = Mod(fmt, mcs, bw, 1)
        pp = _pp(mod)
        jmod = jpdr.Mod(fmt, mcs, bw, 1)
        assert (RxPipeline(mod, pp.n_sym, pp.psdu_len, device="cpu")
                .window_len()
                == JaxRxPipeline(jmod, pp.n_sym, pp.psdu_len).window_len())
        if bw == BW.BW20 and fmt == F.VHT:
            assert (acc._MrcPipe(mod, pp.n_sym, pp.psdu_len, device="cpu")
                    .window_len()
                    == jacc._MrcPipe(jmod, pp.n_sym, pp.psdu_len)
                    .window_len())


@pytest.mark.parametrize("n_user", [2, 4])
def test_mu_window_len_equal_jax(n_user):
    q64 = np.tile(np.eye(n_user, dtype=np.complex64)[None], (64, 1, 1))
    for mcs in (0, 2, 4):
        mods, pps, _, n_sym, _ = acc._mu_packet(mcs, n_user, q64, 500, 0)
        for u in range(n_user):
            assert (acc._MuStaPipe(mods[u], n_sym, pps[u].psdu_len, u,
                                   n_user, device="cpu").window_len()
                    == jacc._MuStaPipe(jpdr.Mod(F.VHT, mcs), n_sym,
                                       pps[u].psdu_len, u,
                                       n_user).window_len())


class _Stop(Exception):
    pass


def test_mu_sounding_and_packet_equal_jax(monkeypatch):
    """The JAX `_mu_curves` up to its first MU PPDU, recorded: the
    stations' NDP captures (h applied) and the MU TX's A-MPDUs equal the
    port's `_mu_sounding` / `_mu_packet`, and so does the Q they feed
    back, within Q_TOL: each package's sync estimates the NDP's CFO in
    float32 before the numpy feedback."""
    import ieee80211_tpu.mu.sounding as jsounding
    import ieee80211_tpu.tx as jtx
    seen = {"ndp": []}
    real_ndp = jsounding.sta_capture_ndp

    def ndp(cap, **kw):
        seen["ndp"].append(np.array(cap))
        return real_ndp(cap, **kw)

    def mu_tx(amps, mods, bfq, group_id):
        seen.update(amps=amps, bfq=np.array(bfq), gid=group_id)
        raise _Stop

    monkeypatch.setattr(jsounding, "sta_capture_ndp", ndp)
    monkeypatch.setattr(jtx, "gen_ampdu_mu", mu_tx)
    with pytest.raises(_Stop):
        jacc._mu_curves([30.0], 2, 500, 0, QUIET)
    h, q64 = acc._mu_sounding(0, 2, "cpu")
    ncap = acc.finalize(acc.gen_ampdu(b"", Mod(F.VHT, 0, BW.BW20, 2))
                        .waveform, multiplier=0.3, cfo_hz=4000.0, gap=True,
                        gap_len=1200)
    for u in range(2):
        np.testing.assert_array_equal((h[u] @ ncap).astype(np.complex64),
                                      seen["ndp"][u])
    np.testing.assert_allclose(q64, seen["bfq"], rtol=0, atol=Q_TOL)
    mods, _, mpdus, _, _ = acc._mu_packet(0, 2, q64, 500, 0)
    assert [jpdr.aggregate_vht([m]) for m in mpdus] == seen["amps"]
    assert seen["gid"] == acc.MU_GID


def _siso_pipes(csi_weight: bool, bw):
    build = pdr._build_packet_bw(bw)
    mod, pp, mpdu, wave = build(F.VHT, 7, PAYLOAD, 0)
    jmod = jpdr._build_packet_bw(bw)(F.VHT, 7, PAYLOAD, 0)[0]
    pipe = radix3(RxPipeline(mod, pp.n_sym, pp.psdu_len,
                             csi_weight=csi_weight, device="cpu"))
    jpipe = JaxRxPipeline(jmod, pp.n_sym, pp.psdu_len, csi_weight=csi_weight)
    return pipe, jpipe.step, pp, mpdu, wave


@pytest.mark.parametrize("csi_weight,bw,snr_db,waterfall", [
    (True, BW.BW20, 30.0, False), (True, BW.BW20, 20.0, True),
    (False, BW.BW80, 30.0, False)],
    ids=["weighted_30dB", "weighted_waterfall", "unweighted_80_fading"])
def test_rx_packed_step_matches_jax(csi_weight, bw, snr_db, waterfall):
    """VHT MCS7, 100 B; the unweighted row through the sweep's multipath
    draws at 80 MHz."""
    pipe, jstep, pp, mpdu, wave = _siso_pipes(csi_weight, bw)
    q = {BW.BW20: 1, BW.BW80: 4}[bw]
    if csi_weight:
        x1 = pdr.rx_window(wave, pipe.window_len(), q)
        x2 = pdr.noisy_batch(x1, N_PKT, snr_db, seed=11)
    else:
        crng = np.random.default_rng(7919 + 7)
        x2 = np.stack([pdr.noisy_batch(pdr.rx_window(
            acc._chan_fir(q)(crng, wave), pipe.window_len(), q), 1, snr_db,
            seed=i)[0] for i in range(N_PKT)])
    ref, got = packed_both(jstep, pipe, x2)
    assert_packed_parity(ref, got, lambda b: pdr._count_ok(
        b, pp.psdu_len, mpdu, True), waterfall,
        f"RxPipeline(csi_weight={csi_weight}) {snr_db} dB")


@pytest.mark.parametrize("snr_db,waterfall", [(30.0, False), (11.0, True)],
                         ids=["30dB", "waterfall"])
def test_mrc_packed_step_matches_jax(snr_db, waterfall):
    mod, pp, mpdu, wave = acc._build_mrc_packet(F.VHT, 4, PAYLOAD, 0)
    jmod = jacc._build_mrc_packet(F.VHT, 4, PAYLOAD, 0)[0]
    pipe = radix3(acc._MrcPipe(mod, pp.n_sym, pp.psdu_len, device="cpu"))
    jpipe = jacc._MrcPipe(jmod, pp.n_sym, pp.psdu_len)
    x2 = pdr.noisy_batch(pdr.rx_window(wave, pipe.window_len()), N_PKT,
                         snr_db, seed=12)
    ref, got = packed_both(jpipe._step, pipe, x2)
    assert_packed_parity(ref, got, lambda b: pdr._count_ok(
        b, pp.psdu_len, mpdu, True), waterfall, f"_MrcPipe {snr_db} dB")


@pytest.mark.parametrize("snr_db,waterfall", [(30.0, False), (13.0, True)],
                         ids=["30dB", "waterfall"])
def test_mu_sta_packed_step_matches_jax(snr_db, waterfall):
    """Station 0 of the 2-user VHT MCS4 row, the sounding on the CPU."""
    h, q64 = acc._mu_sounding(0, 2, "cpu")
    mods, pps, mpdus, n_sym, wave = acc._mu_packet(4, 2, q64, PAYLOAD, 0)
    pipe = radix3(acc._MuStaPipe(mods[0], n_sym, pps[0].psdu_len, 0, 2,
                                 device="cpu"))
    jpipe = jacc._MuStaPipe(jpdr.Mod(F.VHT, 4), n_sym, pps[0].psdu_len, 0, 2)
    y = (h[0] @ wave).astype(np.complex64)
    x2 = pdr.noisy_batch(pdr.rx_window(y, pipe.window_len()), N_PKT,
                         snr_db, seed=13)
    ref, got = packed_both(jpipe._step, pipe, x2)
    assert_packed_parity(ref, got, lambda b: pdr._count_ok(
        b, pps[0].psdu_len, mpdus[0], True), waterfall,
        f"_MuStaPipe {snr_db} dB")


def test_harness_smoke_tiny():
    """tests/test_pdr_acceptance.py's smoke sweep, on device="cpu"."""
    siso = acc._sweep_curves(pdr._build_packet, RxPipeline, [(F.VHT, 7)],
                             [10.0, 30.0], 4, 100, 0, QUIET, device="cpu")
    assert siso["VHT7"][1] == 1.0
    assert siso["VHT7"][0] <= siso["VHT7"][1]
    mimo = acc._sweep_curves(pdr._build_mimo_packet, pdr.MimoRxPipeline,
                             [(F.HT, 8)], [30.0], 4, 100, 0, QUIET,
                             device="cpu")
    assert mimo["HT8"][0] == 1.0


def test_fading_rows_tiny():
    """A fading row and the unweighted one at 36 dB, 4 packets."""
    for pipe_cls in (RxPipeline,
                     functools.partial(RxPipeline, csi_weight=False)):
        c = acc._sweep_curves(pdr._build_packet_bw(BW.BW40), pipe_cls,
                              [(F.VHT, 2)], [36.0], 4, 100, 0, QUIET,
                              chan=acc._chan_fir(2), device="cpu")
        assert c == {"VHT2": [1.0]}
    c = acc._sweep_curves(pdr._build_mimo_packet_bw(BW.BW40),
                          pdr.MimoRxPipeline, [(F.HT, 9)], [36.0], 4, 100, 0,
                          QUIET, chan=acc._chan_mix, device="cpu")
    assert c == {"HT9": [1.0]}


def test_mu_curves_tiny():
    """`_mu_curves` at 2 packets and 30 dB: every curve 1.0."""
    curves = acc._mu_curves([30.0], 2, PAYLOAD, 0, QUIET, device="cpu")
    assert curves == {f"MU_VHT{m}x2": [1.0] for m in (0, 2, 4)}


def test_run_acceptance_artifact_keys(tmp_path):
    out = tmp_path / "art.json"
    res = acc.run_acceptance(n_pkt=2, payload_len=PAYLOAD, snr_db=[30.0],
                             siso=False, wideband=False, mu=False,
                             out_path=str(out), quiet=True, device="cpu")
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert res["device"]["device"] == "cpu" and res["seed"] == 0
    assert set(res["curves"]) == {"mimo_2x2", "siso_mrc_2rx"}
    assert res["packets"] == (17 + 3) * 2
    assert res["packets_per_s"] > 0 and res["wall_s"] > 0
    assert all(v == 30.0 for g in res["waterfall_90pct"].values()
               for v in g.values())


def _load(path):
    with open(path) as f:
        return json.load(f)


@pytest.mark.skipif(not os.path.exists(ART_TORCH),
                    reason="the H100 artifact is not generated yet")
@pytest.mark.parametrize("check", ["test_committed_artifact_thresholds",
                                   "test_committed_artifact_fading_mu_"
                                   "thresholds"])
def test_torch_artifact_thresholds(monkeypatch, check):
    """tests/test_pdr_acceptance.py's checks, as they are, on the port's
    artifact."""
    import test_pdr_acceptance
    monkeypatch.setattr(test_pdr_acceptance, "ART", ART_TORCH)
    getattr(test_pdr_acceptance, check)()


@pytest.mark.skipif(not os.path.exists(ART_TORCH),
                    reason="the H100 artifact is not generated yet")
def test_torch_artifact_near_tpu_artifact():
    """Every row of the TPU artifact is in the port's, its waterfall within
    WATERFALL_TOL_DB; the card that made it is recorded."""
    art, tpu = _load(ART_TORCH), _load(ART_TPU)
    assert "H100" in art["device"]["name"] and "W" in art["device"]["card"]
    assert (art["n_pkt"], art["payload_len"], art["snr_db"]) == (
        tpu["n_pkt"], tpu["payload_len"], tpu["snr_db"])
    far = []
    for grp, rows in tpu["waterfall_90pct"].items():
        for name, want in rows.items():
            got = art["waterfall_90pct"][grp][name]
            if got is None or abs(got - want) > WATERFALL_TOL_DB:
                far.append(f"{grp}/{name}: {got} vs {want} dB")
    assert not far, far
