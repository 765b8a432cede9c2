"""`ieee80211_tpu_torch.perf.multicard` across processes, and the meshes'
rank-card guard (`parallel/mesh.py::check_cards`).

`multicard.run` on 2 and 4 gloo ranks (subprocesses, one CPU rank each) at
a small size: every loop on the 1-rank mesh, then on every (dp, sp) mesh of
2 and 4 ranks ((2, 1), (1, 2); (4, 1), (2, 2), (1, 4)), each held by the
module itself to the 1-rank run. Its outputs on the (1, n) mesh (sp = n,
the time split four ways on 4 ranks, the port's counterpart of
tests/test_parallel.py's sp = 4 frontend) are the same on every rank and
equal the JAX package's function of the same name and arguments on a JAX
mesh of the same shape (`torch_parity.assert_same`), the port's Viterbi at
radix 3 as the JAX CPU decoder runs; the frontend there equals its float64
definition, and on tests/test_parallel.py's noise the JAX mesh's frontend
and the unsharded autocorrelation. Also: the comparison helpers on
outputs made to differ, a world smaller than asked, and two ranks of one
host on one card (`torch.cuda.current_device` replaced in each rank).
"""
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp
from ieee80211_tpu.parallel import make_phy_mesh as jax_mesh
from ieee80211_tpu.ops import sync as jsync
from ieee80211_tpu.parallel import sharded as jsh
from ieee80211_tpu.utils import c2r
from ieee80211_tpu_torch.parallel.sharded import HALO
from ieee80211_tpu_torch.perf import bench, multicard
from torch_parity import assert_same, finish_ranks, jax_mod, spawn_ranks

TIMEOUT = 600   # s for a group of worker processes
# two packets in each stream capture, one dual-chain segment of two, eight
# packets in the step's batch, three fixed-config packets per row
STREAM = dict(n_api=2, n_copy=1, n_stream=4, n_mimo_seg=2, n_mimo_rep=1,
              n_mu_seg=2, n_mu_rep=1, n_mu_cap=1, mu_tx_floor=1)
SMALL = dict(rx_batch=8, fixed_m=1)
SIZES = multicard.Sizes(stream=bench.Sizes(**STREAM), **SMALL)

# one rank: the frontend on tests/test_parallel.py's noise at (1, n), then
# multicard.run at SIZES in the same group, the port's Viterbi at radix 3;
# the frontend's output, the run's lines and the outputs of the meshes of
# spec["keep"] to files
_WORKER = r"""
import json, sys
import numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
from ieee80211_tpu_torch.ops.coding import _radix_tables
from ieee80211_tpu_torch.parallel import init_distributed, make_phy_mesh
from ieee80211_tpu_torch.parallel import sharded as psh
from ieee80211_tpu_torch.perf import bench, multicard

spec = json.loads(sys.argv[1])
w0, w1 = (torch.from_numpy(a) for a in _radix_tables(3))


def radix3(make):
    def build(*args, **kw):
        run = make(*args, **kw)
        for m in run.modules():
            if hasattr(m, "vit_w0"):
                m.vit_w0, m.vit_w1 = w0, w1
        return run
    return build


for name in ("sharded_rx", "sharded_capture_decode",
             "sharded_capture_decode_auto", "sharded_capture_decode_auto2"):
    setattr(psh, name, radix3(getattr(psh, name)))
assert init_distributed(device="cpu")
n = dist.get_world_size()
halo = psh.sharded_frontend(make_phy_mesh(sp=n, device="cpu"),
                            np.load(spec["noise"]))
sizes = multicard.Sizes(stream=bench.Sizes(**spec["stream"]),
                        **spec["small"])
emitted = []
res = multicard.run(sizes=sizes, iters=1, device="cpu",
                    keep=[tuple(s) for s in spec["keep"]],
                    emit=emitted.append)
rank = dist.get_rank()
np.savez(f"{spec['out']}/rank{rank}.npz", halo=halo.numpy(), **{
    f"{loop}|{shape[0]}x{shape[1]}|{k}": v
    for (loop, shape), out in res["outputs"].items() for k, v in out.items()})
with open(f"{spec['out']}/rank{rank}.json", "w") as f:
    json.dump({"lines": res["lines"], "emitted": emitted}, f)
dist.destroy_process_group()
"""


def _jax_args(kwargs: dict) -> dict:
    """A loop's keyword arguments with the JAX package's Mods."""
    out = dict(kwargs)
    if "mod" in out:
        out["mod"] = jax_mod(out["mod"])
    if "branches" in out:
        out["branches"] = tuple((jax_mod(m), c) for m, c in out["branches"])
    return out


def _autocorr64(x2: np.ndarray) -> np.ndarray:
    """The frontend's output in float64 numpy from its definition: each
    row's lag-16 autocorrelation magnitude over 16-sample windows,
    normalized, with HALO zeros past the capture's end, and its last HALO
    samples zero."""
    x = x2[..., 0].astype(np.float64) + 1j * x2[..., 1]
    t = x.shape[1]
    x = np.pad(x, ((0, 0), (0, HALO)))

    def movsum(v):
        c = np.pad(np.cumsum(v, axis=1), ((0, 0), (1, 0)))
        return c[:, 16:] - c[:, :-16]

    pwr = np.abs(x) ** 2
    ac = np.abs(movsum(x[:, :-16] * np.conj(x[:, 16:]))) / (
        np.sqrt(movsum(pwr[:, :-16]) * movsum(pwr[:, 16:])) + 1e-12)
    ac = ac[:, :t]
    ac[:, t - HALO:] = 0.0
    return ac


def _jax_outputs(case, n: int) -> dict:
    """The JAX package's function of the case on a (1, n) JAX mesh of the
    virtual CPU devices, on the case's numpy inputs: its arguments as the
    port's on the (1, n) mesh of n rows."""
    jm = jax_mesh(n, sp=n)
    fn = getattr(jsh, case.fn)
    xs = [jnp.asarray(a) for a in case.x]
    if case.fn == "sharded_frontend":
        return {"ac": np.asarray(fn(jm, *xs))}
    out = fn(jm, **_jax_args(case.kwargs(n, n)))(*xs)
    return {k: np.asarray(v) for k, v in out.items()}


# what a capture loop decodes from a slot's window
_DECODED = ("bits", "cfo", "fmt", "mcs", "nss", "n_sym", "psdu_len", "ampdu",
            "ndp_ltf")


def _triggered_only(ref: dict, got: dict, t: int):
    """Both output dicts with what is decoded on the slots without a
    trigger (trig_t at the sentinel t) zeroed. On sp > 1 such a slot cuts
    the right neighbour's halo, often mid-packet, whose LLRs come out half
    NaN; the two packages' decoders order NaN apart (the port's as
    torch.max does), so their bits there differ. trig_t, ok, ndp and the
    overflow flags are held on every slot."""
    idle = ref["trig_t"] >= t
    out = []
    for d in (ref, got):
        d = dict(d)
        for k in _DECODED:
            if k in d:
                d[k] = np.where(idle.reshape(idle.shape + (1,) * (
                    d[k].ndim - 2)), np.zeros((), d[k].dtype), d[k])
        out.append(d)
    return out


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_multicard_across_ranks_equal_jax(tmp_path, n_ranks):
    rng = np.random.default_rng(0)        # tests/test_parallel.py:31-33
    noise = c2r((rng.standard_normal((4, 2048))
                 + 1j * rng.standard_normal((4, 2048))).astype(np.complex64))
    np.save(tmp_path / "noise.npy", noise)
    spec = {"stream": STREAM, "small": SMALL, "keep": [[1, n_ranks]],
            "noise": str(tmp_path / "noise.npy"), "out": str(tmp_path)}
    procs = spawn_ranks(n_ranks, ["-c", _WORKER, json.dumps(spec)])
    try:                                   # the JAX loops while ranks run
        cases = multicard.cases(n_ranks, SIZES)
        ref = {c.loop: _jax_outputs(c, n_ranks) for c in cases
               if c.fn != "sharded_frontend"}
        halo_ref = np.asarray(jsh.sharded_frontend(
            jax_mesh(n_ranks, sp=n_ranks), jnp.asarray(noise)))
        unsharded = np.asarray(jsync.stf_autocorr(jnp.asarray(
            noise[..., 0] + 1j * noise[..., 1])))
    finally:
        finish_ranks(procs, TIMEOUT)
    runs = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(n_ranks)]
    lines = runs[0]["lines"]
    shapes = [(1, 1)] + multicard.mesh_shapes(n_ranks)
    assert [(ln["loop"], tuple(ln["mesh"])) for ln in lines] == [
        (loop, s) for s in shapes for loop in multicard.LOOPS]
    for ln in lines:
        n = ln["mesh"][0] * ln["mesh"][1]
        assert ln["world"] == n_ranks
        assert len(ln["ranks_ms"]) == len(ln["launches"]) == n
        assert ln["ms"] == max(ln["ranks_ms"]) > 0
        assert ln["cards"] == [{"name": "cpu", "power_limit": None}] * n
        # the CPU runs the kernels' plain versions: no kernel launches
        assert all(set(d.values()) == {0} for d in ln["launches"])
    assert all(r["lines"] == lines for r in runs)
    emitted = [json.loads(e) for e in runs[0]["emitted"]]
    assert emitted[:-1] == lines and all(not r["emitted"] for r in runs[1:])
    summary = emitted[-1]["multicard"]
    assert summary["world"] == n_ranks and summary["rows"] == n_ranks
    assert [tuple(s) for s in summary["shapes"]] == shapes

    got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(n_ranks)]
    for r, g in enumerate(got):              # every rank the same outputs
        assert set(g) == set(got[0])
        for k, v in g.items():
            np.testing.assert_array_equal(v, got[0][k], err_msg=(r, k))
    # tests/test_parallel.py::test_halo_frontend_matches_unsharded at
    # sp = n: the JAX mesh's output and the unsharded autocorrelation
    halo = got[0].pop("halo")
    assert_same({"ac": halo_ref}, {"ac": halo})
    n = unsharded.shape[1]
    np.testing.assert_allclose(halo[:, :n], unsharded, atol=1e-4)
    assert np.all(halo[:, n:] == 0)
    for c in cases:
        tag = f"{c.loop}|1x{n_ranks}|"
        out = {k[len(tag):]: v for k, v in got[0].items()
               if k.startswith(tag)}
        if c.fn == "sharded_frontend":
            # JAX's float32 moving sums over a shard of this length are off
            # by up to ~1e-2 where the capture is quiet (ROADMAP.md §3):
            # the port's is held to the float64 definition instead
            want = _autocorr64(c.x[0])
            np.testing.assert_allclose(out["ac"], want, rtol=0,
                                       atol=multicard.AC_TOL * want.max())
        elif c.fn == "sharded_rx":
            assert_same(ref[c.loop], out)
        else:
            assert_same(*_triggered_only(ref[c.loop], out, c.x[0].shape[-2]))


def test_multicard_needs_enough_ranks():
    """A 1-process world asked for 2 cards raises, names the torchrun
    command, and leaves no group behind."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs 2 ranks and the world has "
                       "1.*torchrun --nproc-per-node 2 -m "
                       "ieee80211_tpu_torch.perf.multicard"):
        multicard.run(2, SIZES, device="cpu")
    assert not dist.is_initialized()


def test_mesh_shapes():
    assert multicard.mesh_shapes(1) == []
    assert multicard.mesh_shapes(2) == [(2, 1), (1, 2)]
    assert multicard.mesh_shapes(3) == [(2, 1), (1, 2)]
    assert multicard.mesh_shapes(4) == [(2, 1), (1, 2), (4, 1), (2, 2),
                                        (1, 4)]


@pytest.mark.parametrize("dp,sp", [(1, 1)] + multicard.mesh_shapes(4))
def test_branch_cap_holds_every_window_of_a_branch(dp, sp):
    """auto2's cap on each rank of a (dp, sp) mesh of 4 rows holds all of
    a branch's packets in the rank's rows: with packets alternating
    between two branches, every other sp rank decodes every window of
    one branch."""
    for per_row in (1, 720):
        assert multicard.branch_cap(per_row, 4 // dp) >= per_row * 4 // dp
        assert multicard.k_shard(2 * per_row, sp) >= 2 * per_row / sp


@pytest.mark.parametrize("rows", [1, 2, 4])
def test_inputs_split_over_every_sp(rows):
    """Every capture splits into whole 512-sample blocks over each sp up to
    `rows`, each shard at least the loop's window; the fixed-config capture
    has a packet 200 samples before each edge of a 2- and 4-way split."""
    for c in multicard.cases(rows, SIZES):
        x = c.x[0]
        assert x.dtype == np.float32 and x.shape[0] in (rows,
                                                         SIZES.rx_batch)
        if c.fn == "sharded_rx":
            continue
        t = x.shape[-2]
        assert t % (512 * rows) == 0
        if "window_len" in c.kwargs(rows, 1):
            assert t // rows >= c.kwargs(rows, 1)["window_len"]
    cap, offs, *_ = multicard.fixed_capture(rows, 2)
    t = cap.shape[1]
    for r, row in enumerate(offs):
        for edge in (t // 4, t // 2, 3 * t // 4):
            assert edge - 200 + 16 * r in row


def _loop_out(trig, ok, bits):
    """A capture loop's outputs of one row."""
    return {"trig_t": torch.tensor([trig], dtype=torch.int32),
            "ok": torch.tensor([ok]),
            "bits": torch.tensor([bits], dtype=torch.int32)[..., None],
            "cfo": torch.zeros(1, len(ok)),
            "overflow": torch.tensor([False])}


@pytest.mark.parametrize("got,problems", [
    # the same triggered slots among other junk, in more slots: the same
    (_loop_out([5, 9, 301, 64], [True, False, True, False], [1, 0, 2, 7]), 0),
    (_loop_out([5, 301, 64], [True, True, False], [1, 2, 3]), 0),
    # a trigger TRIG_TOL late at a shard's first sample (a plateau that
    # starts in a shard's last samples fires at the next shard's first):
    # the same
    (_loop_out([5, 320, 64], [True, True, False], [1, 2, 0]), 0),
    # a trigger 5 samples late away from a shard edge, one early, a decoded
    # bit, a triggered slot too many or too few
    (_loop_out([5, 306, 64], [True, True, False], [1, 2, 0]), 1),
    (_loop_out([5, 300, 64], [True, True, False], [1, 2, 0]), 1),
    (_loop_out([5, 301, 64], [True, True, False], [1, 3, 0]), 1),
    (_loop_out([5, 301, 64], [True, True, True], [1, 2, 0]), 4),
    (_loop_out([5, 301, 64], [True, False, False], [1, 2, 0]), 4),
])
def test_same_slots(got, problems):
    ref = _loop_out([5, 301, 64], [True, True, False], [1, 2, 0])
    assert len(multicard.same_slots(ref, got, "loop", 320)) == problems
    got = dict(got, overflow=torch.tensor([True]))
    assert len(multicard.same_slots(ref, got, "loop", 320)) == problems + 1


@pytest.mark.parametrize("ref,got,ok", [
    ([301], [301], True),
    ([301], [320], True),          # TRIG_TOL late, at a shard's first
    ([621, 7], [640, 7], True),    # the second shard edge
    ([300], [320], False),         # TRIG_TOL + 1 late at the edge
    ([315], [320 + 315 - 301], False),   # 19 late away from an edge
    ([325], [320], False),         # early, to the edge
    ([0, 9], [0, 14], False),      # 5 late, away from an edge
])
def test_same_trigger(ref, got, ok):
    """A mesh's trigger equals the 1-rank run's, but at a shard's first
    sample, where it may be up to TRIG_TOL samples late."""
    t = lambda v: torch.tensor(v, dtype=torch.int32)
    assert (multicard.same_trigger(t(ref), t(got), 320, "t") == []) == ok


def test_same_rows_and_frontend_tolerances():
    ref = {"bits": torch.tensor([[1, 0]]), "cfo": torch.tensor([0.5]),
           "snr": torch.tensor([20.0])}
    assert multicard.same_rows(ref, dict(ref), "rx") == []
    near = dict(ref, cfo=ref["cfo"] + 0.5 * multicard.CFO_TOL,
                snr=ref["snr"] + 0.5 * multicard.SNR_TOL)
    assert multicard.same_rows(ref, near, "rx") == []
    far = dict(ref, cfo=ref["cfo"] + 2 * multicard.CFO_TOL)
    assert len(multicard.same_rows(ref, far, "rx")) == 1
    flip = dict(ref, bits=torch.tensor([[1, 1]]))
    assert len(multicard.same_rows(ref, flip, "rx")) == 1
    ac = {"ac": torch.tensor([[0.0, 0.9, 2.0]])}
    assert multicard.same_frontend(
        ac, {"ac": ac["ac"] + 1.5 * multicard.AC_TOL}, "f") == []
    assert len(multicard.same_frontend(
        ac, {"ac": ac["ac"] + 2.5 * multicard.AC_TOL}, "f")) == 1


def test_digest_sees_every_output():
    out = _loop_out([5, 300], [True, False], [1, 2])
    d = multicard.digest(out)
    assert multicard.digest(dict(out)) == d
    for k, v in out.items():
        flat = v.clone().view(-1)
        flat[0] = ~flat[0] if v.dtype == torch.bool else flat[0] + 1
        assert multicard.digest(dict(out, **{k: flat.view(v.shape)})) != d, k


# two ranks: the guard passes on distinct cards and raises on one card
_GUARD = r"""
import torch
import torch.distributed as dist
from ieee80211_tpu_torch.parallel import init_distributed
from ieee80211_tpu_torch.parallel.mesh import check_cards

assert init_distributed(device="cpu")
rank = dist.get_rank()
torch.cuda.current_device = lambda: rank
check_cards()
print("distinct cards pass", flush=True)
torch.cuda.current_device = lambda: 0
try:
    check_cards()
except RuntimeError as e:
    print(f"shared card raises: {e}", flush=True)
dist.destroy_process_group()
"""


def test_ranks_of_one_host_on_one_card_raise():
    for out in finish_ranks(spawn_ranks(2, ["-c", _GUARD]), TIMEOUT):
        assert "distinct cards pass" in out, out
        assert "shared card raises: ranks [0, 1] of host " in out, out
        assert ("all run on cuda:0: give each rank its card with "
                "torch.cuda.set_device(LOCAL_RANK)") in out, out
