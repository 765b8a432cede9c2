"""The port's sharded capture loop (`ieee80211_tpu_torch.parallel`) against
the JAX package's at world size 1: a 1-rank gloo group in the test process
(the port) and a (1, 1) mesh of one virtual CPU device (JAX), on the same
numpy captures.

Exact: bits, trig_t, ok, fmt, mcs, nss, n_sym, psdu_len, ampdu, mu, ndp,
overflow, branch_overflow, the step's ltf_start / lsig_ok and the
trigger's slots; within 1e-5 rad/sample the CFO; within 1e-4 the frontend's
autocorrelation and the NDP LTF windows
(`torch_parity.LOOP_TOL`: float32 sums taken in another order; the port's
long moving sums in float64). The port's
Viterbi runs at radix 3, as the JAX CPU decoder does
(`torch_parity.radix3`).
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp
from ieee80211_tpu.mac import MacConfig, aggregate_vht, build_udp_mpdu
from ieee80211_tpu.parallel import make_phy_mesh as jax_mesh
from ieee80211_tpu.parallel import sharded as jsh
from ieee80211_tpu.specs import BW, F, Mod
from ieee80211_tpu.specs.modulation import (ppdu_params_aggregate,
                                            ppdu_params_nonaggregate)
from ieee80211_tpu.tx import finalize, gen_ampdu, gen_ampdu_mu
from ieee80211_tpu.utils import c2r
from ieee80211_tpu_torch.parallel import sharded as psh
from test_sharded_capture import _build, _mixed_capture
from test_sharded_dual import _capture, _setup
from torch_parity import LOOP_TOL, assert_same, port_mod, radix3

CFG = MacConfig(addr1="f4:69:d5:80:0f:a0", addr2="00:c0:ca:b1:5b:e1",
                addr3="f4:69:d5:80:0f:a0", seq=2704)


@pytest.fixture(scope="module")
def mesh():
    """A 1-rank gloo group of the test process, and its (1, 1) mesh."""
    from ieee80211_tpu_torch.parallel import make_phy_mesh
    torch.set_num_threads(1)
    m = make_phy_mesh(device="cpu")
    yield m
    dist.destroy_process_group()


def _branches(branches):
    return tuple((port_mod(m), c) for m, c in branches)


# --------------------------------------------------------------------------
# the trigger and the planners
# --------------------------------------------------------------------------


def _plateaus(seed: int, b: int, ta: int, gaps, min_gap: int):
    """ac rows of noise below the threshold with runs above it: lengths
    around the plateau (too short ones included) at the given gaps, so
    that rises fall just under and just over min_gap apart."""
    rng = np.random.default_rng(seed)
    ac = rng.uniform(0.0, 0.45, (b, ta)).astype(np.float32)
    for r in range(b):
        t = int(rng.integers(0, 50))
        while t < ta - 40:
            ac[r, t:t + int(rng.integers(12, 40))] = rng.uniform(0.55, 1.0)
            t += int(rng.choice(gaps)) + int(rng.integers(-2, 3))
    return ac


@pytest.mark.parametrize("k,gaps", [(64, (398, 400, 402, 30, 800)),
                                    (8, (399, 401, 120)),
                                    (3, (410, 399, 120))])
def test_local_triggers_equal_jax(k, gaps):
    """Random plateaus with gaps just under and over min_gap; k = 8 and 3
    saturate the capacity (rises past it are dropped before the dedup)."""
    ac = _plateaus(k, 4, 6000, gaps, 400)
    ref = np.asarray(jsh._local_triggers(jnp.asarray(ac), k))
    got = psh._local_triggers(torch.from_numpy(ac), k).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert np.any(ref < 6000) and np.any(ref == 6000)


def test_local_triggers_wideband_gaps():
    ac = _plateaus(5, 2, 9000, (2399, 2400, 2401, 700), 2400)
    ref = np.asarray(jsh._local_triggers(jnp.asarray(ac), 17, plateau=80,
                                         min_gap=2400))
    got = psh._local_triggers(torch.from_numpy(ac), 17, plateau=80,
                              min_gap=2400).numpy()
    np.testing.assert_array_equal(got, ref)


def _random_meta(seed: int, n: int = 512) -> dict:
    """SIG metadata with random fields, biased so that every planner path
    (L, HT, VHT, NDP, MU, invalid) occurs."""
    rng = np.random.default_rng(seed)
    meta = {k: rng.random(n) < 0.7 for k in ("lsig_ok", "ht_ok", "vht_ok",
                                             "nl1_imag_dom")}
    meta["l_mcs"] = np.where(rng.random(n) < 0.6, 0,
                             rng.integers(0, 8, n)).astype(np.int32)
    meta["l_len"] = rng.integers(0, 4096, n).astype(np.int32)
    meta["snr"] = rng.normal(5, 5, n).astype(np.float32)
    for key in ("ht_bits", "vht_bits"):
        bits = rng.integers(0, 2, (n, 48)).astype(np.int32)
        bits[:, 24] &= rng.random(n) < 0.2          # VHT SGI mostly off
        bits[:, 31] &= rng.random(n) < 0.2          # HT SGI mostly off
        bits[:, 8:24] &= (np.arange(16) < 10)       # HT lengths < 1024
        bits[:, 28:32] &= (np.arange(4) < 3)[None]  # VHT MCS mostly < 8
        meta[key] = bits
    meta["vht_bits"][:, 4:10] = (np.arange(6) == 1)  # group id 2 ...
    meta["vht_bits"][rng.random(n) < 0.5, 5] = 0    # ... or 0
    meta["vht_bits"][:, 0:2] = 0                    # 20 MHz
    return meta


def _port_meta(meta: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in meta.items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_auto_plans_equal_jax_on_random_meta(seed):
    meta = _random_meta(seed)
    jmeta = {k: jnp.asarray(v) for k, v in meta.items()}
    for q in (1, 2, 4):
        tabs = psh.PlanTables(q)
        ref = jsh._auto_plan(jmeta, q)
        assert_same(ref, psh._auto_plan(_port_meta(meta), tabs))
        ref = jsh._auto_plan2(jmeta, q, 0, 2 if q == 1 else None)
        assert_same(ref, psh._auto_plan2(_port_meta(meta), tabs, 0,
                                         2 if q == 1 else None))
    assert {-1, 0, 1, 2} <= set(np.asarray(jsh._auto_plan(jmeta, 1)["fmt"]))


def test_auto_plans_equal_jax_on_real_captures():
    """The SIG metadata of the dual-chain capture's windows (L MRC, VHT
    A-MPDU, HT 2x2, VHT NDP) through both planners."""
    from ieee80211_tpu.ops.sync import find_triggers_np
    from ieee80211_tpu.rx.receiver import sig_parse_mimo
    _, waves, _, w = _setup()
    cap = _capture(waves, w, 1, 2)[0]
    t = find_triggers_np(cap[0], min_gap=600)
    win = np.stack([cap[:, s:s + 1200] for s in t - 8])
    meta = {k: np.asarray(v) for k, v in sig_parse_mimo(
        jnp.asarray(c2r(win)), jnp.zeros(len(t), jnp.int32)).items()}
    jmeta = {k: jnp.asarray(v) for k, v in meta.items()}
    tabs = psh.PlanTables(1)
    ref = jsh._auto_plan2(jmeta, 1)
    assert_same(ref, psh._auto_plan2(_port_meta(meta), tabs))
    assert sorted(np.asarray(ref["fmt"]).tolist()) == [-1, 0, 1, 2]
    assert np.asarray(ref["ndp"]).sum() == 1
    assert_same(jsh._auto_plan(jmeta, 1), psh._auto_plan(_port_meta(meta),
                                                         tabs))


# --------------------------------------------------------------------------
# the loops on a (1, 1) mesh
# --------------------------------------------------------------------------


def test_frontend_equal_jax(mesh):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 4096)) + 1j * rng.standard_normal((2, 4096))
         ).astype(np.complex64)
    ref = np.asarray(jsh.sharded_frontend(jax_mesh(1), jnp.asarray(c2r(x))))
    got = psh.sharded_frontend(mesh, c2r(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=LOOP_TOL["ac"])
    assert np.all(got[:, -psh.HALO:] == 0)


def test_sharded_rx_and_multichip_step_equal_jax(mesh):
    from ieee80211_tpu.perf.scaling import _packet_batch
    mod, pp, x2, t0 = _packet_batch(8)
    ref = jsh.sharded_rx(jax_mesh(1), mod, pp.n_sym)(x2, t0)
    run = radix3(psh.sharded_rx(mesh, port_mod(mod), pp.n_sym))
    assert_same(ref, run(x2, t0))
    rng = np.random.default_rng(1)
    cap = (rng.standard_normal((2, 2048, 2)) * 0.1).astype(np.float32)
    ref = jsh.multichip_step(jax_mesh(1), mod, pp.n_sym)(cap, x2, t0)
    got = radix3(psh.multichip_step(mesh, port_mod(mod), pp.n_sym))(cap, x2,
                                                                    t0)
    assert int(got["n_ok"]) == 8
    assert_same(ref, got)


@pytest.mark.parametrize("offs", [[[600, 5000], [1200, 3400]], "edge"])
def test_capture_decode_equal_jax(mesh, offs):
    if offs == "edge":      # triggers 200 samples before sp=4 shard edges
        tl = _build(4, 2, [[100], [100]])[4].shape[1] // 4
        offs = [[tl - 200], [3 * tl - 200]]
    _, mod, pp, pipe, cap = _build(4, 2, offs)
    w = pipe.window_len()
    ref = jsh.sharded_capture_decode(jax_mesh(1), mod, pp.n_sym, w)(
        jnp.asarray(c2r(cap)))
    got = radix3(psh.sharded_capture_decode(mesh, port_mod(mod), pp.n_sym,
                                            w))(c2r(cap))
    assert_same(ref, got)
    assert got["ok"].sum() == sum(len(o) for o in offs)


def test_shard_shorter_than_the_window_raises(mesh):
    _, mod, pp, pipe, cap = _build(1, 1, [[100]])
    run = psh.sharded_capture_decode(mesh, port_mod(mod), pp.n_sym,
                                     pipe.window_len())
    with pytest.raises(ValueError, match="< window"):
        run(c2r(cap[:, :pipe.window_len() - 1]))


@pytest.mark.parametrize("generic", [False, True])
def test_auto_equal_jax(mesh, generic):
    _, _, branches, w, cap = _mixed_capture(2, 2)
    ref = jsh.sharded_capture_decode_auto(jax_mesh(1), branches, w,
                                          generic=generic)(
        jnp.asarray(c2r(cap)))
    got = radix3(psh.sharded_capture_decode_auto(
        mesh, _branches(branches), w, generic=generic))(c2r(cap))
    assert_same(ref, got)
    assert set(got["fmt"][got["ok"]].tolist()) == {0, 1, 2}


def test_auto_overflow_equal_jax(mesh):
    from ieee80211_tpu.tx import gen_mpdu
    mpdu = build_udp_mpdu(b"123456789012345678901234567890", CFG)
    mod = Mod(F.L, 7)
    pp = ppdu_params_nonaggregate(mod, len(mpdu))
    wave = finalize(gen_mpdu(mpdu, mod).waveform, 0.2, 0.0, gap=False)[0]
    w = jsh.branch_window_len(mod, pp.n_sym)
    assert psh.branch_window_len(port_mod(mod), pp.n_sym) == w
    t_len = -(-(4 * (len(wave) + 600) + w) // 1024) * 1024
    cap = np.zeros((2, t_len), dtype=np.complex64)
    for i in range(3):
        o = 64 + i * (len(wave) + 600)
        cap[0, o:o + len(wave)] += wave
    cap[1, 64:64 + len(wave)] += wave
    branches = ((mod, pp.n_sym),)
    ref = jsh.sharded_capture_decode_auto(jax_mesh(1), branches, w,
                                          k_per_shard=2)(
        jnp.asarray(c2r(cap)))
    got = radix3(psh.sharded_capture_decode_auto(
        mesh, _branches(branches), w, k_per_shard=2))(c2r(cap))
    assert_same(ref, got)
    assert got["overflow"].tolist() == [True, False]


def test_auto_wideband_80mhz_equal_jax(mesh):
    from ieee80211_tpu.mac import aggregate_vht
    mpdu = build_udp_mpdu(b"wideband mesh loop payload 80MHz", CFG)
    ampdu = aggregate_vht([mpdu])
    mod = Mod(F.VHT, 9, BW.BW80, 1)
    pp = ppdu_params_aggregate(mod, len(ampdu))
    wave = finalize(gen_ampdu(ampdu, mod).waveform, 0.2, 35000.0,
                    gap=False)[0]
    w = jsh.branch_window_len(mod, pp.n_sym)
    t_len = -(-(len(wave) + 3000 + 2 * w) // 1024) * 1024
    cap = np.zeros((1, t_len), dtype=np.complex64)
    cap[0, 256:256 + len(wave)] += wave
    branches = ((mod, pp.n_sym),)
    ref = jsh.sharded_capture_decode_auto(jax_mesh(1), branches, w,
                                          k_per_shard=4, q=4)(
        jnp.asarray(c2r(cap)))
    got = radix3(psh.sharded_capture_decode_auto(
        mesh, _branches(branches), w, k_per_shard=4, q=4))(c2r(cap))
    assert_same(ref, got)
    assert got["ok"].sum() == 1


@pytest.mark.parametrize("branch_cap", [None, 8, 1])
def test_auto2_equal_jax(mesh, branch_cap):
    """MRC SISO + 2x2 branches and an NDP per row; a capacity of 1
    overflows."""
    _, waves, branches, w = _setup()
    cap = _capture(waves, w, 2, 2)
    ref = jsh.sharded_capture_decode_auto2(jax_mesh(1), branches, w,
                                           k_per_shard=8,
                                           branch_cap=branch_cap)(c2r(cap))
    got = radix3(psh.sharded_capture_decode_auto2(
        mesh, _branches(branches), w, k_per_shard=8,
        branch_cap=branch_cap))(c2r(cap))
    assert_same(ref, got)
    assert got["ndp"].sum() == 2
    assert bool(got["branch_overflow"].any()) == (branch_cap == 1)


def _mu_capture(dp: int, sp: int):
    """tests/test_sharded_dual.py::test_sharded_auto2_mu_branch's capture:
    a 2-user MU PPDU as station 0 hears it on two chains, then an SU VHT7
    A-MPDU. Returns (capture, branches, mu_branches, w)."""
    mpdu0 = build_udp_mpdu(b"sharded mu user zero exact pay", CFG)
    mpdu1 = build_udp_mpdu(b"sharded mu user one exact payl", CFG)
    mpdu_su = build_udp_mpdu(b"sharded su packet exact paylo", CFG)
    qi = np.tile(np.eye(2, dtype=np.complex64)[None], (64, 1, 1))
    mu_tx = gen_ampdu_mu([aggregate_vht([mpdu0]), aggregate_vht([mpdu1])],
                         [Mod(F.VHT, 4, BW.BW20, 1),
                          Mod(F.VHT, 2, BW.BW20, 1)], bfq=qi, group_id=2)
    mu_wave = finalize(mu_tx.waveform, 0.2, -6000.0, gap=False)
    g = np.array([0.9 - 0.2j, 0.55 + 0.7j])
    rx_mu = np.stack([g[0] * mu_wave[0], g[1] * mu_wave[0]])
    mod_su = Mod(F.VHT, 7)
    pp_su = ppdu_params_aggregate(mod_su, len(aggregate_vht([mpdu_su])))
    su_wave = finalize(gen_ampdu(aggregate_vht([mpdu_su]), mod_su).waveform,
                       0.2, 9000.0, gap=False)[0]
    rx_su = np.stack([0.8 * su_wave, (0.3 + 0.6j) * su_wave])
    n_sym_mu = max(ppdu_params_aggregate(Mod(F.VHT, m, BW.BW20, 1), len(
        aggregate_vht([p]))).n_sym for m, p in ((4, mpdu0), (2, mpdu1)))
    branches = ((mod_su, pp_su.n_sym),)
    mu_branches = ((Mod(F.VHT, 4, BW.BW20, 1), n_sym_mu + 2),)
    from ieee80211_tpu.rx.mimo import MrcDataDecoder
    w = max(MrcDataDecoder(mod_su, pp_su.n_sym).window_capacity(),
            272 + 448 + 4 * 80 + 160 + (n_sym_mu + 2) * 80 + 80)
    seg = np.concatenate([np.zeros((2, 700), np.complex64), rx_mu,
                          np.zeros((2, 700), np.complex64), rx_su],
                         axis=1).astype(np.complex64)
    t_len = -(-(seg.shape[1] + 2 * w) // (512 * sp)) * (512 * sp)
    cap = np.zeros((dp, 2, t_len), np.complex64)
    for r in range(dp):
        cap[r, :, 64 + 32 * r:64 + 32 * r + seg.shape[1]] += seg
    return cap, branches, mu_branches, w


@pytest.mark.parametrize("branch_cap", [None, 4])
def test_auto2_mu_branch_equal_jax(mesh, branch_cap):
    cap, branches, mu_branches, w = _mu_capture(1, 2)
    ref = jsh.sharded_capture_decode_auto2(
        jax_mesh(1), branches, w, k_per_shard=4, branch_cap=branch_cap,
        mu_branches=mu_branches, mu_pos=0, mu_gid=2)(c2r(cap))
    got = radix3(psh.sharded_capture_decode_auto2(
        mesh, _branches(branches), w, k_per_shard=4, branch_cap=branch_cap,
        mu_branches=_branches(mu_branches), mu_pos=0, mu_gid=2))(c2r(cap))
    assert_same(ref, got)
    assert int((got["ok"] & got["mu"]).sum()) == 1
    assert int((got["ok"] & ~got["mu"]).sum()) == 1
