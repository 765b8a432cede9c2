"""The port's top-level entry points (`ieee80211_tpu_torch.entry`) against
__graft_entry__.py on the CPU.

`example_batch` equals `_example_batch` element for element, and `entry()`'s
step gives the bits, `ltf_start` and `lsig_ok` of JAX's jitted step exactly,
CFO and SNR within test_torch_pipeline's CFO_TOL / SNR_TOL. The envelope's
captures, branches and windows equal a literal copy of the JAX dryrun's
recipe built with the JAX package's MAC, specs, TX and MrcDataDecoder.
`dryrun_multichip` runs on a 1-rank gloo group in the test process and
on 2, 4 and 8 gloo ranks in subprocesses ((dp, sp) = (1, 2), (2, 2) and
(4, 2)); every
rank returns the same outputs, the counts are 3 dp / dp / dp / dp, and each
stage's outputs equal the JAX package's `sharded_capture_decode_auto2` on
that JAX-built recipe, on a JAX mesh of the same shape
(`torch_parity.assert_same`), the port's Viterbi at radix 3 as the JAX CPU
decoder runs.
"""
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import __graft_entry__
import jax
from ieee80211_tpu.mac import MacConfig, aggregate_vht, build_udp_mpdu
from ieee80211_tpu.parallel import make_phy_mesh as jax_mesh
from ieee80211_tpu.parallel import sharded as jsh
from ieee80211_tpu.rx.mimo import MrcDataDecoder
from ieee80211_tpu.specs import BW, F, Mod
from ieee80211_tpu.specs.modulation import (ppdu_params_aggregate,
                                            ppdu_params_nonaggregate)
from ieee80211_tpu.tx import finalize, gen_ampdu, gen_ampdu_mu, gen_mpdu
from ieee80211_tpu.utils import c2r
from ieee80211_tpu_torch import entry
from ieee80211_tpu_torch.parallel import sharded as psh
from test_torch_pipeline import CFO_TOL, SNR_TOL
from torch_parity import (assert_same, finish_ranks, port_mod, radix3,
                          spawn_ranks)

TIMEOUT = 300   # s for a group of worker processes


def test_example_batch_equals_jax():
    jpipe, jmod, jpp, jx, jt0 = __graft_entry__._example_batch()
    pipe, mod, pp, x2, t0 = entry.example_batch(device="cpu")
    assert mod == port_mod(jmod)
    assert (pp.n_sym, pp.psdu_len) == (jpp.n_sym, jpp.psdu_len)
    assert pipe.window_len() == jpipe.window_len()
    assert x2.dtype == jx.dtype == np.float32 and t0.dtype == jt0.dtype
    np.testing.assert_array_equal(x2, jx)
    np.testing.assert_array_equal(t0, jt0)


def test_entry_step_equals_jax():
    jfn, jargs = __graft_entry__.entry()
    ref = {k: np.asarray(v) for k, v in jax.jit(jfn)(*jargs).items()}
    fn, args = entry.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    with torch.inference_mode():
        out = {k: v.numpy() for k, v in fn(*args).items()}
    assert set(out) == set(ref)
    for k in out:
        assert out[k].dtype == ref[k].dtype and out[k].shape == ref[k].shape
    for k in ("bits", "ltf_start", "lsig_ok"):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    np.testing.assert_allclose(out["cfo"], ref["cfo"], rtol=0, atol=CFO_TOL)
    np.testing.assert_allclose(out["snr"], ref["snr"], rtol=0, atol=SNR_TOL)
    assert out["lsig_ok"].all()


def test_main_checks_the_step(capsys):
    entry.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "entry OK: {'bits': (4, 864)" in out
    assert "lsig_ok 4/4, 4/4 exact MPDUs" in out


def _former_recipe(n_devices: int):
    """__graft_entry__.py:61-120, :166-187 and :210-226, copied line for
    line, with the JAX package's MAC, specs, TX and MrcDataDecoder: the
    dryrun's three captures, branches (JAX Mods), windows and loop
    options."""
    sp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    dp = n_devices // sp
    rng = np.random.default_rng(5)

    cfg = MacConfig(addr1="f4:69:d5:80:0f:a0", addr2="00:c0:ca:b1:5b:e1",
                    addr3="f4:69:d5:80:0f:a0", seq=2704)
    mpdu = build_udp_mpdu(b"123456789012345678901234567890", cfg)
    ampdu = aggregate_vht([mpdu])

    mod_l, mod_vht = Mod(F.L, 7), Mod(F.VHT, 7)
    mod_22 = Mod(F.HT, 12, BW.BW20, 2)
    pp_l = ppdu_params_nonaggregate(mod_l, len(mpdu))
    pp_vht = ppdu_params_aggregate(mod_vht, len(ampdu))
    pp_22 = ppdu_params_nonaggregate(mod_22, len(mpdu))

    h1 = np.array([0.9 - 0.3j, 0.5 + 0.8j])          # SISO -> 2 chains
    h22 = np.array([[1.1 + 0.2j, 0.3 - 0.5j],
                    [-0.4 + 0.6j, 0.9 + 0.1j]])

    def two_chain(wave1):
        return np.stack([h1[0] * wave1, h1[1] * wave1])

    w_l = two_chain(finalize(gen_mpdu(mpdu, mod_l).waveform,
                             multiplier=0.2, cfo_hz=12000.0, gap=False)[0])
    w_vht = two_chain(finalize(gen_ampdu(ampdu, mod_vht).waveform,
                               multiplier=0.2, cfo_hz=5000.0, gap=False)[0])
    w_22 = h22 @ finalize(gen_mpdu(mpdu, mod_22).waveform,
                          multiplier=0.2, cfo_hz=-8000.0, gap=False)
    w_ndp = h22 @ finalize(gen_ampdu(b"", Mod(F.VHT, 0, BW.BW20, 2)).waveform,
                           multiplier=0.2, cfo_hz=3000.0, gap=False)
    waves = [("L", w_l), ("VHT", w_vht), ("HT22", w_22), ("NDP", w_ndp)]

    branches = ((mod_l, pp_l.n_sym), (mod_vht, pp_vht.n_sym),
                (mod_22, pp_22.n_sym))
    w = max(MrcDataDecoder(mod_l, pp_l.n_sym).window_capacity(),
            MrcDataDecoder(Mod(F.VHT, 7), pp_vht.n_sym).window_capacity(),
            272 + 448 + 160 + 80 * pp_22.n_sym + 160)

    max_wave = max(wv.shape[1] for _, wv in waves)
    t_len = -(-(4 * (max_wave + 900) + 2 * w) // (512 * sp)) * (512 * sp)
    tl = t_len // sp
    capture = np.zeros((dp, 2, t_len), dtype=np.complex64)
    for r in range(dp):
        order = [waves[(r + i) % 4] for i in range(4)]
        offs = [64 + 16 * r, 64 + max_wave + 900,
                (tl - 100) if sp > 1 else (64 + 2 * (max_wave + 900)),
                t_len - max_wave - w]
        for o, (_, wv) in zip(offs, order):
            capture[r, :, o:o + wv.shape[1]] += wv
    capture += (rng.standard_normal(capture.shape)
                + 1j * rng.standard_normal(capture.shape)) * 1e-4

    qi = np.tile(np.eye(2, dtype=np.complex64)[None], (64, 1, 1))
    mu_tx = gen_ampdu_mu([ampdu, ampdu],
                         [Mod(F.VHT, 4, BW.BW20, 1),
                          Mod(F.VHT, 2, BW.BW20, 1)],
                         bfq=qi, group_id=2)
    mu_wave2 = finalize(mu_tx.waveform, multiplier=0.2, cfo_hz=-6000.0,
                        gap=False)
    rx_mu = np.stack([0.9 * mu_wave2[0], (0.5 + 0.6j) * mu_wave2[0]])
    mod_mu = Mod(F.VHT, 4, BW.BW20, 1)
    n_sym_mu = max(ppdu_params_aggregate(Mod(F.VHT, m, BW.BW20, 1),
                                         len(ampdu)).n_sym for m in (2, 4))
    w_mu = max(w, 272 + 448 + 4 * 80 + 160 + (n_sym_mu + 2) * 80 + 80)
    t_mu = -(-(rx_mu.shape[1] + 2000 + 2 * w_mu)
             // (512 * sp)) * (512 * sp)
    cap_mu = np.zeros((dp, 2, t_mu), dtype=np.complex64)
    for r in range(dp):
        o = 128 + 48 * r
        cap_mu[r, :, o:o + rx_mu.shape[1]] += rx_mu

    mod80 = Mod(F.VHT, 9, BW.BW80, 1)
    pp80 = ppdu_params_aggregate(mod80, len(ampdu))
    w80_wave = two_chain(finalize(gen_ampdu(ampdu, mod80).waveform,
                                  multiplier=0.2, cfo_hz=40000.0,
                                  gap=False)[0])
    w80 = MrcDataDecoder(mod80, pp80.n_sym).window_capacity()
    t80 = -(-(w80_wave.shape[1] + 3000 + 2 * w80)
            // (512 * sp)) * (512 * sp)
    cap80 = np.zeros((dp, 2, t80), dtype=np.complex64)
    for r in range(dp):
        o = 256 + 64 * r
        cap80[r, :, o:o + w80_wave.shape[1]] += w80_wave
    return [(capture, branches, w, dict(k_per_shard=8, branch_cap=8)),
            (cap_mu, branches[:1], w_mu, dict(
                k_per_shard=4, mu_branches=((mod_mu, n_sym_mu + 2),),
                mu_pos=0, mu_gid=2)),
            (cap80, ((mod80, pp80.n_sym),), w80, dict(k_per_shard=4, q=4))]


def _port_branches(branches) -> tuple:
    return tuple((port_mod(m), int(c)) for m, c in branches)


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_envelope_captures_equal_the_recipe(n_devices):
    stages = entry.envelope_captures(n_devices)
    want = _former_recipe(n_devices)
    assert [s.name for s in stages] == ["mixed", "mu", "wideband"]
    dp, sp = entry.mesh_shape(n_devices)
    for st, (cap, branches, w, options) in zip(stages, want):
        assert st.capture.dtype == cap.dtype == np.complex64
        np.testing.assert_array_equal(st.capture, cap, err_msg=st.name)
        assert _port_branches(st.branches) == _port_branches(branches)
        assert type(st.window) is int and st.window == int(w)
        port_opts = dict(options)
        if "mu_branches" in options:
            port_opts["mu_branches"] = _port_branches(options["mu_branches"])
        assert st.options == port_opts
        assert st.capture.shape[0] == dp
        assert st.capture.shape[2] % (512 * sp) == 0


def _jax_loops(n_devices: int) -> dict:
    """The JAX package's loop of each stage on a JAX mesh of the dryrun's
    shape, on the JAX-built recipe's captures, branches and windows:
    {stage: outputs}."""
    _, sp = entry.mesh_shape(n_devices)
    jm = jax_mesh(n_devices, sp=sp)
    ref = {}
    for name, (cap, branches, w, opts) in zip(
            ("mixed", "mu", "wideband"), _former_recipe(n_devices)):
        out = jsh.sharded_capture_decode_auto2(jm, branches, w, **opts)(
            c2r(cap))
        ref[name] = {k: np.asarray(v) for k, v in out.items()}
    return ref


# the outputs a loop decodes from each slot's window
_DECODED = ("bits", "fmt", "mcs", "nss", "n_sym", "psdu_len", "ampdu",
            "ndp_ltf")


def _assert_stage_same(stage, ref: dict, got: dict, n_devices: int) -> None:
    """assert_same on one stage's outputs of the n_devices envelope. The
    MU stage's capture holds no noise, and its slots without a trigger
    (trig_t at the sentinel, the capture's length) cut the wrapped halo,
    where the sync lands in the STF and the SIG tones divide by channel
    estimates of rounding size: what the loop decodes there is rounding
    noise, and the JAX loop's own values move when the capture is scaled
    by 1 +- 1e-7 (test_untriggered_mu_slots_are_rounding_noise). So do the
    80 MHz stage's on 8 devices, (dp, sp) = (4, 2)
    (test_untriggered_wideband_slots_are_rounding_noise); on fewer it is
    held whole. There the decoded outputs are held on the triggered slots
    only; trig_t, ok, mu, ndp and the overflow flags on every slot."""
    if stage.name == "mu" or (stage.name == "wideband" and n_devices == 8):
        np.testing.assert_array_equal(got["trig_t"], ref["trig_t"])
        idle = ref["trig_t"] >= stage.capture.shape[2]
        assert idle.any() and not idle.all()
        ref, got = dict(ref), dict(got)
        for k in _DECODED:
            for d in (ref, got):
                d[k] = np.where(idle.reshape(idle.shape + (1,) * (
                    d[k].ndim - 2)), np.zeros((), d[k].dtype), d[k])
    assert_same(ref, got)


def test_untriggered_mu_slots_are_rounding_noise():
    """The JAX loop alone, on the MU stage's capture and on that capture
    scaled by 1 + 1e-7 (about one float32 ulp): the triggered slot decodes
    the same, the slots without a trigger do not."""
    cap, branches, w, opts = _former_recipe(1)[1]
    run = jsh.sharded_capture_decode_auto2(jax_mesh(1), branches, w, **opts)
    a, b = ({k: np.asarray(v) for k, v in run(c2r(x)).items()}
            for x in (cap, cap * np.float32(1 + 1e-7)))
    idle = a["trig_t"][0] >= cap.shape[2]
    assert idle.tolist() == [False, True, True, True]
    for k in ("bits", "ok", "mu", "n_sym", "psdu_len"):
        np.testing.assert_array_equal(a[k][0, ~idle], b[k][0, ~idle])
    assert a["ok"][0, 0] and a["mu"][0, 0]
    assert np.all(a["n_sym"][0, idle] != b["n_sym"][0, idle])


def test_untriggered_wideband_slots_are_rounding_noise():
    """The JAX loop alone on the 80 MHz capture of the 8-device envelope
    ((dp, sp) = (4, 2)) and on it scaled by 1 + 1e-7: the triggered slots
    decode the same, some slots without a trigger do not."""
    cap, branches, w, opts = _former_recipe(8)[2]
    run = jsh.sharded_capture_decode_auto2(jax_mesh(8, sp=2), branches, w,
                                           **opts)
    a, b = ({k: np.asarray(v) for k, v in run(c2r(x)).items()}
            for x in (cap, cap * np.float32(1 + 1e-7)))
    idle = a["trig_t"] >= cap.shape[2]
    assert idle.any() and not idle.all()
    for k in ("bits", "ok", "fmt", "n_sym", "psdu_len"):
        np.testing.assert_array_equal(a[k][~idle], b[k][~idle], err_msg=k)
    assert a["ok"].sum() == 4
    assert np.any(a["n_sym"][idle] != b["n_sym"][idle])


def _want(n_devices: int) -> dict:
    dp, _ = entry.mesh_shape(n_devices)
    return {"mixed": 3 * dp, "ndp": dp, "mu": dp, "wideband": dp}


def test_dryrun_one_rank_equals_jax(monkeypatch):
    """dryrun_multichip(1) on a 1-rank gloo group of the test process;
    then, in that 1-rank world, dryrun_multichip(2) raises."""
    loop = psh.sharded_capture_decode_auto2
    monkeypatch.setattr(psh, "sharded_capture_decode_auto2",
                        lambda *a, **kw: radix3(loop(*a, **kw)))
    torch.set_num_threads(1)
    assert not dist.is_initialized()
    try:
        res = entry.dryrun_multichip(1, device="cpu")
        assert dist.get_backend() == "gloo"
        with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2 "
                           "-m ieee80211_tpu_torch.entry --dryrun 2"):
            entry.dryrun_multichip(2, device="cpu")
    finally:
        dist.destroy_process_group()
    assert res["counts"] == _want(1)
    ref = _jax_loops(1)
    assert set(res["outputs"]) == set(ref)
    for st in entry.envelope_captures(1):
        _assert_stage_same(st, ref[st.name], {
            k: v.numpy() for k, v in res["outputs"][st.name].items()}, 1)


def test_dryrun_needs_enough_ranks():
    """Without a process group the world is this one process: a 2-rank
    dryrun raises before it makes a group, and falls back to nothing."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs 2 ranks and the world has "
                       "1.*--nproc-per-node 2"):
        entry.dryrun_multichip(2, device="cpu")
    assert not dist.is_initialized()


# one rank: dryrun_multichip(n) for each n of the spec, the port's Viterbi
# at radix 3; outputs and counts to an npz, or a marker outside the mesh
_WORKER = r"""
import json, sys
import numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
from ieee80211_tpu_torch import entry
from ieee80211_tpu_torch.ops.coding import _radix_tables
from ieee80211_tpu_torch.parallel import sharded as psh

spec = json.loads(sys.argv[1])
w0, w1 = (torch.from_numpy(a) for a in _radix_tables(3))
loop = psh.sharded_capture_decode_auto2


def radix3(*args, **kw):
    run = loop(*args, **kw)
    for m in run.modules():
        if hasattr(m, "vit_w0"):
            m.vit_w0, m.vit_w1 = w0, w1
    return run


psh.sharded_capture_decode_auto2 = radix3
for n in spec["n"]:
    res = entry.dryrun_multichip(n, device="cpu")
    path = f"{spec['out']}/n{n}_rank{dist.get_rank()}.npz"
    if res is None:
        np.savez(path, outside=np.ones(1))
        continue
    arrs = {f"{s}/{k}": v.numpy() for s, o in res["outputs"].items()
            for k, v in o.items()}
    arrs.update({f"counts/{k}": np.asarray(v)
                 for k, v in res["counts"].items()})
    np.savez(path, **arrs)
dist.destroy_process_group()
"""


@pytest.mark.parametrize("n_ranks", [2, 4, 8])
def test_dryrun_across_ranks_equal_jax(tmp_path, n_ranks):
    """dryrun_multichip(n) on n gloo ranks: (1, 2), (2, 2) and (4, 2)
    meshes (8 is tests/test_parallel.py's test_dryrun_multichip_8), the
    mixed stage's third packet straddling the shard edge, the MU branch and
    the 80 MHz loop at sp = 2. Then dryrun_multichip(n / 2) in the same
    world: the ranks outside its mesh return None."""
    spec = {"n": [n_ranks, n_ranks // 2], "out": str(tmp_path)}
    procs = spawn_ranks(n_ranks, ["-c", _WORKER, json.dumps(spec)])
    try:
        ref = _jax_loops(n_ranks)        # while the ranks run
    finally:
        outs = finish_ranks(procs, TIMEOUT)
    for n in spec["n"]:
        assert sum(f"dryrun_multichip({n}): " in o for o in outs) == n
    got = [dict(np.load(tmp_path / f"n{n_ranks}_rank{r}.npz"))
           for r in range(n_ranks)]
    for r, g in enumerate(got):
        assert set(g) == set(got[0])
        for k, v in g.items():            # every rank returns the same
            np.testing.assert_array_equal(v, got[0][k], err_msg=(r, k))
    g = got[0]
    assert {k.split("/")[1]: int(v) for k, v in g.items()
            if k.startswith("counts/")} == _want(n_ranks)
    for st in entry.envelope_captures(n_ranks):
        _assert_stage_same(st, ref[st.name], {
            k.split("/")[1]: v for k, v in g.items()
            if k.startswith(st.name + "/")}, n_ranks)
    half = n_ranks // 2
    for r in range(n_ranks):
        h = dict(np.load(tmp_path / f"n{half}_rank{r}.npz"))
        if r < half:
            assert {k.split("/")[1]: int(v) for k, v in h.items()
                    if k.startswith("counts/")} == _want(half)
        else:
            assert set(h) == {"outside"}
