"""The port's sharded loops across processes: gloo ranks in subprocesses,
one CPU rank each, against the JAX package's loops on a mesh of the same
shape (virtual CPU devices of tests/conftest.py).

2 ranks form a (dp=1, sp=2) mesh and 4 ranks a (dp=2, sp=2) mesh. Each
rank runs the frontend, `sharded_capture_decode` (a packet straddling a
shard edge), `sharded_capture_decode_auto` (and with `generic=True` on 2
ranks) and `_auto2` on the same numpy captures and saves its outputs: every
rank's are equal to each other's and to the JAX mesh's, exactly or within
`torch_parity.LOOP_TOL`. The port's Viterbi runs at radix 3, as the JAX CPU
decoder does. Also: `_smoke_worker` on 2 processes, the scaling harness
on 2 ranks (each mesh's rate from its slowest rank), and the
single-process fallback of `init_distributed`.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch.distributed as dist

import jax.numpy as jnp
from ieee80211_tpu.parallel import make_phy_mesh as jax_mesh
from ieee80211_tpu.parallel import sharded as jsh
from ieee80211_tpu.utils import c2r
from test_sharded_capture import _build, _mixed_capture
from test_sharded_dual import _capture, _setup
from ieee80211_tpu_torch.perf.scaling import _packet_batch
from torch_parity import assert_same, finish_ranks, spawn_ranks

TIMEOUT = 300   # s for a group of worker processes

# one rank: the port's loops on the spec's captures, outputs to an npz
_WORKER = r"""
import json, sys
import numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
from ieee80211_tpu_torch.ops.coding import _radix_tables
from ieee80211_tpu_torch.parallel import init_distributed, make_phy_mesh
from ieee80211_tpu_torch.parallel import sharded as psh
from ieee80211_tpu_torch.specs import BW, F, Mod

spec = json.loads(sys.argv[1])
assert init_distributed(device="cpu")
mesh = make_phy_mesh(sp=2, device="cpu")
data = np.load(spec["inputs"])
w0, w1 = (torch.from_numpy(a) for a in _radix_tables(3))


def radix3(run):
    for m in run.modules():
        if hasattr(m, "vit_w0"):
            m.vit_w0, m.vit_w1 = w0, w1
    return run


def mod(d):
    return Mod(F(d["fmt"]), d["mcs"], BW(d["bw"]), d["nSTS"], d["sgi"])


def branches(bs):
    return tuple((mod(m), cap) for m, cap in bs)


out = {"frontend/ac": psh.sharded_frontend(mesh, data["noise"])}
c = spec["capture_decode"]
res = radix3(psh.sharded_capture_decode(mesh, mod(c["mod"]), c["n_sym"],
                                        c["w"]))(data["straddle"])
out.update({f"capture_decode/{k}": v for k, v in res.items()})
a = spec["auto"]
for generic in spec["generic"]:
    res = radix3(psh.sharded_capture_decode_auto(
        mesh, branches(a["branches"]), a["w"], generic=generic))(
            data["mixed"])
    out.update({f"auto_{generic}/{k}": v for k, v in res.items()})
a2 = spec["auto2"]
res = radix3(psh.sharded_capture_decode_auto2(
    mesh, branches(a2["branches"]), a2["w"], k_per_shard=8,
    branch_cap=a2["branch_cap"]))(data["dual"])
out.update({f"auto2/{k}": v for k, v in res.items()})
if spec["scaling"]:
    from ieee80211_tpu_torch.perf.scaling import (measure_scaling,
                                                  scaling_runs)
    runs = scaling_runs(device_counts=[1, 2], batch_per_device=8, iters=1,
                        device="cpu")
    rates = measure_scaling(device_counts=[2], batch_per_device=8, iters=1,
                            device="cpu")
    out["scaling/rates"] = torch.tensor(list(rates.items()),
                                        dtype=torch.float64)
    for key in ("samples_per_s", "ms", "slice_ms"):
        out[f"scaling/{key}"] = torch.tensor([runs[1][key], runs[2][key]],
                                             dtype=torch.float64)
    out["scaling/ranks_ms_1"] = torch.tensor(runs[1]["ranks_ms"],
                                             dtype=torch.float64)
    out["scaling/ranks_ms_2"] = torch.tensor(runs[2]["ranks_ms"],
                                             dtype=torch.float64)
np.savez(f"{spec['out']}/rank{dist.get_rank()}.npz",
         **{k: v.numpy() for k, v in out.items()})
dist.destroy_process_group()
"""


def _mod_spec(mod) -> dict:
    return {f.name: int(getattr(mod, f.name))
            for f in dataclasses.fields(mod)}


def _branches_spec(branches):
    return [[_mod_spec(m), int(cap)] for m, cap in branches]


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_loops_across_ranks_equal_jax(tmp_path, n_ranks):
    rows = 2
    rng = np.random.default_rng(0)
    noise = (rng.standard_normal((rows, 4096, 2)) * 0.1).astype(np.float32)
    # sharded_capture_decode: row 0's packet straddles the shard-0/1 edge
    tl = _build(2, rows, [[100], [100]])[4].shape[1] // 2
    _, mod, pp, pipe, straddle = _build(2, rows, [[tl - 200], [900]])
    w = pipe.window_len()
    _, _, branches, w_auto, mixed = _mixed_capture(2, rows)
    _, waves, branches2, w2 = _setup()
    dual = _capture(waves, w2, rows, 2)
    branch_cap = 8 if n_ranks == 2 else None
    generic = [False, True] if n_ranks == 2 else [False]
    inputs = str(tmp_path / "inputs.npz")
    np.savez(inputs, noise=noise, straddle=c2r(straddle), mixed=c2r(mixed),
             dual=c2r(dual))
    spec = {"inputs": inputs, "out": str(tmp_path), "generic": generic,
            "capture_decode": {"mod": _mod_spec(mod), "n_sym": pp.n_sym,
                               "w": w},
            "auto": {"branches": _branches_spec(branches), "w": w_auto},
            "auto2": {"branches": _branches_spec(branches2), "w": w2,
                      "branch_cap": branch_cap},
            "scaling": n_ranks == 2}
    procs = spawn_ranks(n_ranks, ["-c", _WORKER, json.dumps(spec)])

    # the JAX mesh of the same shape, while the ranks run
    jm = jax_mesh(n_ranks, sp=2)
    ref = {"frontend/ac": jsh.sharded_frontend(jm, jnp.asarray(noise))}
    res = jsh.sharded_capture_decode(jm, mod, pp.n_sym, w)(
        jnp.asarray(c2r(straddle)))
    ref.update({f"capture_decode/{k}": v for k, v in res.items()})
    for g in generic:
        res = jsh.sharded_capture_decode_auto(jm, branches, w_auto,
                                              generic=g)(
            jnp.asarray(c2r(mixed)))
        ref.update({f"auto_{g}/{k}": v for k, v in res.items()})
    res = jsh.sharded_capture_decode_auto2(jm, branches2, w2, k_per_shard=8,
                                           branch_cap=branch_cap)(c2r(dual))
    ref.update({f"auto2/{k}": v for k, v in res.items()})

    finish_ranks(procs, TIMEOUT)
    got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(n_ranks)]
    for r, g in enumerate(got):
        for k, v in g.items():       # every rank returns the same outputs
            np.testing.assert_array_equal(v, got[0][k], err_msg=(r, k))
    g = got[0]
    if n_ranks == 2:
        # the rate of each mesh from its slowest rank's time; the cut of
        # each rank's rows timed apart
        sc = {k.split("/")[1]: g.pop(k) for k in list(g)
              if k.startswith("scaling/")}
        assert sc["ranks_ms_1"].shape == (1,) and sc["ranks_ms_2"].shape == (2,)
        np.testing.assert_array_equal(
            sc["ms"], [sc["ranks_ms_1"].max(), sc["ranks_ms_2"].max()])
        width = _packet_batch(8)[2].shape[1]
        np.testing.assert_allclose(
            sc["samples_per_s"], np.array([8, 16]) * width
            / (sc["ms"] * 1e-3), rtol=1e-12)
        assert np.all(sc["samples_per_s"] > 0) and np.all(sc["slice_ms"] > 0)
        assert sc["rates"].shape == (1, 2) and sc["rates"][0, 0] == 2
        assert sc["rates"][0, 1] > 0
    for case in {k.split("/")[0] for k in ref}:
        assert_same({k.split("/")[1]: v for k, v in ref.items()
                     if k.startswith(case + "/")},
                    {k.split("/")[1]: v for k, v in g.items()
                     if k.startswith(case + "/")})
    assert g["capture_decode/ok"].sum() == 2
    assert g["auto2/ndp"].sum() == rows


def test_two_process_smoke_worker():
    outs = finish_ranks(spawn_ranks(
        2, ["-m", "ieee80211_tpu_torch.parallel._smoke_worker"]), TIMEOUT)
    for rank, out in enumerate(outs):
        assert f"SMOKE OK process {rank}/2 mesh dp=1 sp=2" in out, out


def test_single_process_fallback(monkeypatch):
    from ieee80211_tpu_torch.parallel import distributed as pdist
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert pdist.init_distributed() is False      # nothing to join
    assert not dist.is_initialized()
    try:
        mesh = pdist.make_global_phy_mesh(sp=1, device="cpu")
        assert tuple(mesh.mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("dp", "sp")
        info = pdist.process_summary()
        assert info["process_count"] == 1 and info["global_devices"] == 1
        assert info["backend"] == "gloo"
        with pytest.raises(AssertionError, match="ranks per node"):
            pdist.make_global_phy_mesh(sp=2, device="cpu")
    finally:
        dist.destroy_process_group()
