"""The port's profiling probes on the CPU: the step's stages
(ieee80211_tpu_torch/perf/stages.py), composed in order, reproduce
`RxPipeline.step`; each TPU-era layout's PyTorch call equals the step's
form (and the JAX package's function) within the stated tolerance, the
descramble exactly; the streams' floor bracket (perf/floor.py) and the
branch-dispatch floor (perf/branch_floor.py, 8 branches, 8 packets)
decode every packet they time, equal to the receivers'; the branch
floor's captures are perf_generic_r5.py's and perf_ab_r4.py's recipes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ieee80211_tpu.mac import MacConfig, aggregate_vht, build_udp_mpdu
from ieee80211_tpu.ops import coding as jcoding
from ieee80211_tpu.ops import demod as jdemod
from ieee80211_tpu.specs import F, Mod
from ieee80211_tpu.tx import finalize, gen_ampdu, gen_mpdu
from ieee80211_tpu.utils import c2r
from ieee80211_tpu_torch.models import RxPipeline
from ieee80211_tpu_torch.perf import bench as pbench
from ieee80211_tpu_torch.perf import branch_floor, floor, stages
from ieee80211_tpu_torch.perf.scaling import _packet_batch
from ieee80211_tpu_torch.rx import MimoReceiver, SisoReceiver

LLR_TOL = 1e-5
TINY = pbench.Sizes(n_api=2, n_copy=1, n_stream=1, n_mimo_seg=2,
                    n_mimo_rep=1, n_mu_seg=2, n_mu_rep=1, n_mu_cap=1,
                    mu_tx_floor=2)


def _headline():
    b = pbench.rx_batch(**dict(pbench.HEADLINE, batch=4))
    return b.mod, b.n_sym, b.psdu_len, b.x2, b.t0


def _wideband():
    b = pbench.rx_batch(**dict(pbench.WIDEBAND, batch=2))
    return b.mod, b.n_sym, b.psdu_len, b.x2, b.t0


def _legacy():
    """perf/scaling.py's L MCS7 batch: no HT/VHT-LTF stage."""
    mod, pp, x2, t0 = _packet_batch(3)
    return mod, pp.n_sym, pp.psdu_len, x2, t0


CASES = [_headline, _wideband, _legacy]
IDS = ["vht7_20", "vht9_80", "l7_20"]


def _pipe(make):
    mod, n_sym, psdu_len, x2, t0 = make()
    pipe = RxPipeline(mod, n_sym, psdu_len, device="cpu")
    return pipe, torch.from_numpy(x2), torch.from_numpy(t0)


@pytest.mark.parametrize("make", [_headline, _legacy],
                         ids=["vht7_20", "l7_20"])
def test_stages_compose_to_the_step(make):
    pipe, x2, t0 = _pipe(make)
    step = pipe.step
    seen = []
    viterbi = step.viterbi
    step.viterbi = lambda llrs: (seen.append(llrs), viterbi(llrs))[1]
    with torch.inference_mode():
        ref = pipe.step(x2, t0)
        del step.viterbi
        staged, out = stages.run_stages(step, x2, t0)
    assert [name for name, _ in staged] == list(stages.STAGES)
    for key in ("bits", "ltf_start", "lsig_ok", "cfo", "snr"):
        assert torch.equal(out[key], ref[key]), key
    assert len(seen) == 1 and out["llrs"].shape == seen[0].shape
    assert float((out["llrs"] - seen[0]).abs().max()) <= LLR_TOL
    # each stage alone, on clones of its inputs, gives what it gave in turn
    calls = dict(stages.stage_calls(step, x2, t0))
    with torch.inference_mode():
        assert torch.equal(calls["descramble"](), ref["bits"])
        assert torch.equal(step.descramble(calls["viterbi"]()), ref["bits"])
        assert torch.equal(calls["sync_front"]()[0], ref["ltf_start"])


@pytest.mark.parametrize("make", CASES, ids=IDS)
def test_layout_calls_agree_with_the_step(make):
    pipe, x2, t0 = _pipe(make)
    with torch.inference_mode():
        pairs = stages.layout_pairs(pipe.step, x2, t0)
        assert [p[0] for p in pairs] == ["fft", "movsum", "descramble"]
        for name, _, form, alt, tol in pairs:
            ref, got = form(), alt()
            assert ref.shape == got.shape and ref.dtype == got.dtype, name
            if tol is None:
                assert torch.equal(ref, got), name
            else:
                err, scale = stages.agreement(ref, got)
                assert err <= tol * scale, (name, err, scale)


def test_layout_calls_match_jax():
    """torch.fft's grid against the JAX package's DFT matmul, the one-hot
    descramble against JAX's coding.descramble, the cumsum moving sums
    against numpy's float64 ones, on numpy inputs."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 7, 64))
         + 1j * rng.standard_normal((3, 7, 64))).astype(np.complex64)
    ref = np.asarray(jdemod.fft_syms(jnp.asarray(x)))
    got = stages.fft_alt(torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() <= stages.ALT_TOL * np.abs(ref).max()
    bits = rng.integers(0, 2, (5, 500)).astype(np.int32)
    pipe = RxPipeline(pbench.rx_batch(**dict(pbench.HEADLINE, batch=4)).mod,
                      18, 582, device="cpu").step
    prbs = torch.from_numpy(jcoding._prbs_tiled(500))
    got = stages.descramble_onehot(torch.from_numpy(bits), prbs,
                                   pipe.seed_inv)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcoding.descramble(jnp.asarray(bits))))
    n, w = 40, 16
    stacked = torch.from_numpy(rng.standard_normal((6, n)).astype(np.float32))
    want = np.stack([np.convolve(r, np.ones(w), "valid")
                     for r in stacked.numpy().astype(np.float64)])
    got = stages.movsum_alt(stacked, w).numpy()
    assert np.abs(got - want).max() <= stages.ALT_TOL * np.abs(want).max()


def test_measure_runs_on_the_cpu():
    r = stages.measure(2, iters=1, device="cpu")
    assert set(r["stages"]) == set(stages.STAGES) | {"step"}
    assert all(t["ms"] > 0 for t in r["stages"].values())
    assert r["stage_sum"]["device_ms"] is None
    assert set(r["layouts"]) == {"fft", "movsum", "descramble"}
    assert r["layouts"]["descramble"]["max_abs_err"] == 0.0


def test_floor_bracket_decodes_every_packet():
    out = floor.bracket(1, device="cpu", sizes=TINY)
    assert set(out) == {"siso host trigger", "siso device trigger",
                        "mimo auto"}
    for name, r in out.items():
        assert all(len(r[p]) == 1 and r[p][0] > 0 for p in floor.PASSES)
    caps = pbench.stream_captures(TINY)
    assert out["siso host trigger"]["samples"] == sum(len(c) for c in caps)
    summ = floor.summary(out)
    assert all(summ[n][p]["samples_per_s"] > 0 for n in summ
               for p in floor.PASSES)


def test_floor_sig_pass_meta_matches_the_receiver():
    """The bracket's SIG pass parses the windows decode_capture parses."""
    caps = pbench.stream_captures(TINY)
    rx = SisoReceiver(device="cpu")
    metas = floor._sig_pass(rx, rx._ingest, caps, False)
    t0s, cap_dev, npad = rx._ingest(caps[0])
    ref = rx._parse_sigs(cap_dev, npad, t0s)
    assert set(metas[0]) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(metas[0][k]),
                                       np.asarray(ref[k]))


def _jax_loop_capture(mods, k_windows, w, dual):
    """perf_generic_r5.py:51-64 (one chain) and perf_ab_r4.py:177-190 (two
    chains through h1)."""
    cfg = MacConfig(addr1="f4:69:d5:80:0f:a0", addr2="00:c0:ca:b1:5b:e1",
                    addr3="f4:69:d5:80:0f:a0", seq=2704)
    mpdu = build_udp_mpdu(b"123456789012345678901234567890", cfg)
    ampdu = aggregate_vht([mpdu])
    h1 = np.array([0.9 - 0.3j, 0.5 + 0.8j])
    parts = []
    for i in range(k_windows):
        m = mods[i % len(mods)]
        wv = (gen_ampdu(ampdu, m).waveform if m.fmt == F.VHT
              else gen_mpdu(mpdu, m).waveform)
        wv = finalize(wv, multiplier=0.2, cfo_hz=4e3 * ((i % 5) - 2),
                      gap=False)[0]
        if dual:
            parts.append(np.zeros((2, 700), np.complex64))
            parts.append(np.stack([h1[0] * wv, h1[1] * wv]).astype(
                np.complex64))
        else:
            parts.append(np.zeros(700, np.complex64))
            parts.append(wv.astype(np.complex64))
    seg = np.concatenate(parts, axis=-1)
    t_len = -(-(seg.shape[-1] + 2 * w) // 512) * 512
    if dual:
        cap = np.zeros((1, 2, t_len), np.complex64)
        cap[0, :, :seg.shape[1]] = seg
    else:
        cap = np.zeros((1, t_len), np.complex64)
        cap[0, :len(seg)] = seg
    return c2r(cap), mpdu


@pytest.mark.parametrize("dual", [False, True], ids=["siso", "dual"])
def test_loop_capture_is_the_jax_recipe(dual):
    jmods = ([Mod(F.VHT, m) for m in (0, 2, 4, 7)]
             + [Mod(F.HT, m) for m in (0, 2, 4, 7)] if dual else
             [Mod(F.VHT, m) for m in range(8)])
    pmods = branch_floor.ROUTED_MODS if dual else branch_floor.ALL_MODS[:8]
    assert [(m.fmt, m.mcs) for m in pmods] == [(m.fmt, m.mcs) for m in jmods]
    want, mpdu = _jax_loop_capture(jmods, 10, 3000, dual)
    got = branch_floor.loop_capture(pmods, 10, 3000, dual)
    np.testing.assert_array_equal(got, want)
    assert branch_floor._mpdu() == mpdu


@pytest.mark.parametrize("fmt,ampdu,want", [(0, True, True), (0, False, True),
                                            (1, False, True), (1, True, False),
                                            (2, False, False)])
def test_loop_mpdus_reads_the_ampdu_bit_of_ht_windows_only(fmt, ampdu, want):
    """A loop's `ampdu` is the HT-SIG aggregation bit of every window, a
    legacy one's too: loop_mpdus deaggregates HT windows by it and VHT
    windows always, as the receivers assemble them. One window carrying a
    bare MPDU."""
    mpdu = branch_floor._mpdu()
    bits = np.concatenate([np.zeros(16, np.uint8), np.unpackbits(
        np.frombuffer(mpdu, np.uint8), bitorder="little")])
    out = {"ok": torch.tensor([[True]]), "bits": torch.from_numpy(
        bits[None, None].astype(np.int32)), "fmt": torch.tensor([[fmt]]),
        "ampdu": torch.tensor([[ampdu]]),
        "psdu_len": torch.tensor([[len(mpdu)]])}
    got = branch_floor.loop_mpdus(out)
    assert got == ([(0, fmt, [mpdu])] if want else [])


def test_branch_floor_decodes_every_packet():
    """8 branches, 8 planted packets: every loop decodes each packet to its
    MPDU, as the receivers decode the same captures."""
    r = branch_floor.measure((8,), packets=8, caps=(8,), iters=1,
                             device="cpu")
    loops = r["branch_loop"][8]
    assert [loops[k]["packets"] for k in ("branch_loop", "generic")] == [8, 8]
    assert loops["generic_window"] >= loops["window"]
    assert r["routed"]["branch_cap=8"]["packets"] == 8
    mpdu = branch_floor._mpdu()
    cap = branch_floor.loop_capture(branch_floor.ALL_MODS[:8], 8,
                                    loops["generic_window"], False)[0]
    got = SisoReceiver(device="cpu").decode_capture(cap[..., 0]
                                                    + 1j * cap[..., 1])
    assert [p.mpdus for p in got if p.fcs_ok] == [[mpdu]] * 8
    cap2 = branch_floor.loop_capture(branch_floor.ROUTED_MODS, 8,
                                     r["routed"]["window"], True)[0]
    got2 = MimoReceiver(device="cpu").decode_capture(cap2[..., 0]
                                                     + 1j * cap2[..., 1])
    assert [p.mpdus for p in got2 if p.fcs_ok] == [[mpdu]] * 8
