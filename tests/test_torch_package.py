"""The port's package as a whole: its constant tables equal the JAX
package's numpy helpers element for element, importing it (the TX, MU and
API modules included) never loads jax or the JAX package and never builds a
kernel, its entry points run on the card unless asked for the CPU, and the
receive module's buffers are those tables.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ieee80211_tpu.models import RxPipeline as JaxRxPipeline
from ieee80211_tpu.ops import coding as jcoding
from ieee80211_tpu.ops import demod as jdemod
from ieee80211_tpu.ops import sync as jsync
from ieee80211_tpu.specs import BW, F, Mod, tables
from ieee80211_tpu_torch.models import RxPipeline, tables_from_numpy
from ieee80211_tpu_torch.perf.bench import Sizes
from ieee80211_tpu_torch.perf.multicard import LOOPS as MULTICARD_LOOPS
from torch_parity import port_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [(Mod(F.VHT, 7), 18), (Mod(F.L, 7), 6),
           (Mod(F.HT, 5, BW.BW40, 1), 9), (Mod(F.VHT, 9, BW.BW80, 1), 10)]


@pytest.mark.parametrize("mod,n_sym", CONFIGS)
def test_tables_equal_jax_helpers(mod, n_sym):
    q = tables.NFFT[mod.bw] // 64
    t = tables_from_numpy(port_mod(mod), n_sym)
    w0, w1 = jcoding._radix_tables(4)
    np.testing.assert_array_equal(t["vit_w0"], w0)
    np.testing.assert_array_equal(t["vit_w1"], w1)
    wr, wi = jdemod._dft_mats(64 * q)
    np.testing.assert_array_equal(t["dft_re"], wr)
    np.testing.assert_array_equal(t["dft_im"], wi)
    np.testing.assert_array_equal(t["band"], jsync._band_mat(304 * q, 64 * q))
    np.testing.assert_array_equal(t["prbs"],
                                  jcoding._prbs_tiled(n_sym * mod.nDBPS))
    np.testing.assert_array_equal(t["seed_inv"], jcoding._seed_from_first7())
    np.testing.assert_array_equal(
        t["ltf_ref_l"], jdemod.ltf_ref_grid(mod.bw, True).astype(np.complex64))
    if mod.fmt != F.L:
        np.testing.assert_array_equal(
            t["ltf_ref_nl"],
            jdemod.ltf_ref_grid(mod.bw, False).astype(np.complex64))
    pidx0 = {F.L: 1, F.HT: 3, F.VHT: 4}[mod.fmt]
    np.testing.assert_array_equal(
        t["pilot_ref"],
        jdemod.pilot_refs(mod, n_sym, pidx0).astype(np.float32))
    key = (mod.bw, mod.fmt == F.L)
    np.testing.assert_array_equal(t["data_idx"], tables.DATA_GRID[key])
    np.testing.assert_array_equal(t["pilot_idx"], tables.PILOT_GRID[key])


def test_pipeline_buffers_are_the_tables():
    mod, n_sym = port_mod(CONFIGS[0][0]), CONFIGS[0][1]
    pipe = RxPipeline(mod, n_sym, 582, device="cpu")
    bufs = dict(pipe.named_buffers())
    want = tables_from_numpy(mod, n_sym)
    assert set(bufs) == {f"step.{k}" for k in want}
    for k, arr in want.items():
        b = bufs[f"step.{k}"]
        assert b.device.type == "cpu"
        np.testing.assert_array_equal(b.numpy(), arr)
    assert not any(True for _ in pipe.parameters())


@pytest.mark.parametrize("mod,n_sym", CONFIGS)
def test_window_len_matches_jax(mod, n_sym):
    assert (RxPipeline(port_mod(mod), n_sym, 100, device="cpu").window_len()
            == JaxRxPipeline(mod, n_sym, 100).window_len())


_PROBE = r"""
import importlib, importlib.abc, json, pkgutil, sys


class NoJaxPackage(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "ieee80211_tpu" or name.startswith("ieee80211_tpu."):
            raise ImportError(f"the port imported {name}")
        return None


sys.meta_path.insert(0, NoJaxPackage())
import ieee80211_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ieee80211_tpu_torch.__path__,
                                               "ieee80211_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
from ieee80211_tpu_torch.ops.cuda import build
print(json.dumps({"modules": names,
                  "jax": sorted(m for m in sys.modules
                                if m == "jax" or m.startswith("jax.")),
                  "jax_package": sorted(
                      m for m in sys.modules if m == "ieee80211_tpu"
                      or m.startswith("ieee80211_tpu.")),
                  "lib_built": build._lib is not None}))
"""


@pytest.fixture(scope="module")
def import_probe(tmp_path_factory):
    """Import every module of the port, and chip_smoke, in a fresh
    interpreter whose CUDA toolkit path leads nowhere and in which any
    import of the JAX package raises."""
    env = dict(os.environ, CUDA_HOME=str(tmp_path_factory.mktemp("nocuda")))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_import_never_loads_jax(import_probe):
    assert {"ieee80211_tpu_torch.models.pipeline",
            "ieee80211_tpu_torch.ops.cuda.viterbi",
            "ieee80211_tpu_torch.ops.cuda.gather",
            "ieee80211_tpu_torch.ops.cuda.vit_floor",
            "ieee80211_tpu_torch.perf.vit_floor",
            "ieee80211_tpu_torch.rx.receiver",
            "ieee80211_tpu_torch.rx.mimo",
            "ieee80211_tpu_torch.mu.sounding",
            "ieee80211_tpu_torch.utils.metrics",
            "ieee80211_tpu_torch.specs.tables",
            "ieee80211_tpu_torch.mac.frames",
            "ieee80211_tpu_torch.native.lib",
            "ieee80211_tpu_torch.tx.golden",
            "ieee80211_tpu_torch.tx.torch_tx",
            "ieee80211_tpu_torch.mu.feedback",
            "ieee80211_tpu_torch.mac.bf_report",
            "ieee80211_tpu_torch.api.descriptors",
            "ieee80211_tpu_torch.api.service",
            "ieee80211_tpu_torch.perf.pdr",
            "ieee80211_tpu_torch.perf.acceptance",
            "ieee80211_tpu_torch.utils.binio",
            "ieee80211_tpu_torch.examples.gen_test_captures",
            "ieee80211_tpu_torch.examples.inspect_bin",
            "ieee80211_tpu_torch.examples.stream_decode",
            "ieee80211_tpu_torch.examples.mu_sounding_demo",
            "ieee80211_tpu_torch.parallel.mesh",
            "ieee80211_tpu_torch.parallel.distributed",
            "ieee80211_tpu_torch.parallel.sharded",
            "ieee80211_tpu_torch.parallel._smoke_worker",
            "ieee80211_tpu_torch.perf.scaling",
            "ieee80211_tpu_torch.rx.generic",
            "ieee80211_tpu_torch.perf.bench",
            "ieee80211_tpu_torch.perf.stages",
            "ieee80211_tpu_torch.perf.floor",
            "ieee80211_tpu_torch.perf.branch_floor",
            "ieee80211_tpu_torch.perf.multicard",
            "ieee80211_tpu_torch.entry"} <= set(
                import_probe["modules"])
    assert import_probe["jax"] == []


def test_import_never_loads_the_jax_package(import_probe):
    assert import_probe["jax_package"] == []


def _imported_roots(path: Path):
    """The top-level package of every import statement in a source file."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    (Path(REPO) / "ieee80211_tpu_torch").rglob("*.py")) + [
        Path(REPO) / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_neither_jax_nor_the_jax_package(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "ieee80211_tpu"}, roots


def test_import_builds_no_kernel(import_probe):
    assert not import_probe["lib_built"]


def test_tf32_off_after_import():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("q", [1, 2, 4])
def test_sig_tables_equal_jax_helpers(q):
    from ieee80211_tpu.rx import receiver as jrx
    from ieee80211_tpu_torch.rx.receiver import SigTables
    bw = {1: BW.BW20, 2: BW.BW40, 4: BW.BW80}[q]
    t = {k: v.numpy() for k, v in SigTables(q).named_buffers()}
    np.testing.assert_array_equal(t["band"], jsync._band_mat(304 * q, 64 * q))
    wr, wi = jdemod._dft_mats(64 * q)
    np.testing.assert_array_equal(t["dft_re"], wr)
    np.testing.assert_array_equal(t["dft_im"], wi)
    np.testing.assert_array_equal(
        t["ltf_ref_l"], jdemod.ltf_ref_grid(bw, True).astype(np.complex64))
    w0, w1 = jcoding._radix_tables(4)
    np.testing.assert_array_equal(t["vit_w0"], w0)
    np.testing.assert_array_equal(t["vit_w1"], w1)
    mat, const = jrx._crc8_matrix()
    np.testing.assert_array_equal(t["crc8_mat"], mat)
    np.testing.assert_array_equal(t["crc8_const"], const)
    np.testing.assert_array_equal(t["rate_tab"], tables.LEGACY_RATE_BITS)
    pil = np.tile(tables.PILOT_L, q)
    np.testing.assert_array_equal(
        t["nlsig_pilot_ref"],
        (pil[None] * tables.PILOT_POLARITY[1:3, None]).astype(np.float32))
    assert t["sig_data_idx"].shape == (48 * q,)


@pytest.mark.parametrize("mod,n_sym", CONFIGS)
def test_decoder_buffers_are_the_tables(mod, n_sym):
    from ieee80211_tpu.rx import receiver as jrx
    from ieee80211_tpu.specs import interleaver as ilv
    from ieee80211_tpu_torch.rx.receiver import (SisoDataDecoder,
                                                 get_data_decoder)
    pmod = port_mod(mod)
    dec = SisoDataDecoder(pmod, n_sym)
    bufs = {k: v.numpy() for k, v in dec.named_buffers()}
    want = tables_from_numpy(pmod, n_sym)
    assert {"dft_re", "pilot_ref", "data_idx", "rx_perm", "vit_w0",
            "prbs", "seed_inv"} <= set(bufs)
    for k, arr in want.items():
        if k in bufs:
            np.testing.assert_array_equal(bufs[k], arr, err_msg=k)
    assert not any(True for _ in dec.parameters())
    assert dec.zlen() == jrx.SisoDataDecoder(mod, n_sym).zlen()
    assert (dec.window_capacity()
            == jrx.SisoDataDecoder(mod, n_sym).window_capacity())
    if mod.fmt == F.VHT:
        n_pre = jrx.SIGB_DIMS[mod.bw][0]
        np.testing.assert_array_equal(bufs["sigb_crc8_mat"],
                                      jrx._crc8_matrix(n_pre)[0])
        np.testing.assert_array_equal(
            bufs["sigb_perm"], ilv.rx_perm(Mod(F.VHT, 0, mod.bw, 1)))
    assert get_data_decoder(pmod, n_sym, "cpu") is get_data_decoder(
        pmod, n_sym, torch.device("cpu"))


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


# perf.bench's capture rows at their smallest
TINY = Sizes(n_api=2, n_copy=1, n_stream=1, n_mimo_seg=2, n_mimo_rep=1,
             n_mu_seg=2, n_mu_rep=1, n_mu_cap=1, mu_tx_floor=1)


def _slice_entry_points(tmp_path=None):
    """The entry points of the TX, MU and API slice and of the PDR harness
    and examples, each built without a device argument (so on the card),
    and with `device`. The harness's run at a tiny size (the acceptance
    sweep with every group off); inspect_bin decodes a file of silence in
    tmp_path."""
    from ieee80211_tpu_torch.api import PhyService
    from ieee80211_tpu_torch.examples import (inspect_bin, mu_sounding_demo,
                                              stream_decode)
    from ieee80211_tpu_torch.mu import sounding
    from ieee80211_tpu_torch.perf import (acceptance, bench, branch_floor,
                                          floor, mimo_pdr_sweep, multicard,
                                          pdr, pdr_sweep, stages)
    from ieee80211_tpu_torch.rx import MimoReceiver, SisoReceiver
    from ieee80211_tpu_torch.specs.modulation import ppdu_params_aggregate
    from ieee80211_tpu_torch.tx import (MuTxPipeline, TxPipeline,
                                        get_tx_pipeline)
    from ieee80211_tpu_torch.utils import save_complex_bin
    mod = port_mod(Mod(F.VHT, 4))
    pp = ppdu_params_aggregate(mod, 100)
    silence = np.zeros(4000, np.complex64)
    bin_path = None
    if tmp_path is not None:
        bin_path = str(tmp_path / "silence.bin")
        save_complex_bin(bin_path, silence)
    mod2 = port_mod(Mod(F.HT, 9, BW.BW20, 2))
    return {
        "TxPipeline": lambda **kw: TxPipeline(mod, pp, **kw),
        "MuTxPipeline": lambda **kw: MuTxPipeline([mod, mod], [100, 60],
                                                  **kw),
        "get_tx_pipeline": lambda **kw: get_tx_pipeline(mod, 100, True,
                                                        **kw),
        "sta_capture_ndp": lambda **kw: sounding.sta_capture_ndp(silence,
                                                                 **kw),
        "sta_decode_mu": lambda **kw: sounding.sta_decode_mu(silence, 0,
                                                             **kw),
        "get_mu_sta_decoder": lambda **kw: sounding.get_mu_sta_decoder(
            mod, 10, 100, 0, **kw),
        "get_mu_sta_data_decoder": lambda **kw:
            sounding.get_mu_sta_data_decoder(mod, 16, 1, 2, **kw),
        "get_mu_sigb_tables": lambda **kw: sounding.get_mu_sigb_tables(
            1, 0, 2, **kw),
        "SisoReceiver(mu_gid)": lambda **kw: SisoReceiver(mu_gid=2, **kw),
        "MimoReceiver(mu_gid)": lambda **kw: MimoReceiver(mu_gid=2, **kw),
        "PhyService": lambda **kw: PhyService(**kw),
        "pdr_sweep": lambda **kw: pdr_sweep(F.L, [0], [30.0], 2, 30, **kw),
        "mimo_pdr_sweep": lambda **kw: mimo_pdr_sweep(F.HT, [8], [30.0], 2,
                                                      30, **kw),
        "MimoRxPipeline": lambda **kw: pdr.MimoRxPipeline(mod2, 10, 100,
                                                          **kw),
        "run_acceptance": lambda **kw: acceptance.run_acceptance(
            siso=False, mimo=False, wideband=False, mu=False, quiet=True,
            **kw),
        "inspect_bin.main": lambda **kw: inspect_bin.main(bin_path, **kw),
        "stream_decode.main": lambda **kw: stream_decode.main(
            True, n_caps=1, reps=1, **kw),
        "mu_sounding_demo.main": lambda **kw: mu_sounding_demo.main(**kw),
        # the measuring programs at their smallest: one round of bench's
        # rows on TINY's captures, the stages at batch 1, the floor
        # bracket's warm passes, the branch floor's mesh and capture
        "perf.bench.run": lambda **kw: bench.run(1, 1, 1, sizes=TINY, **kw),
        "perf.stages.measure": lambda **kw: stages.measure(1, 1, **kw),
        "perf.floor.bracket": lambda **kw: floor.bracket(0, sizes=TINY,
                                                         **kw),
        "perf.branch_floor.measure": lambda **kw: branch_floor.measure(
            (), packets=1, caps=(), **kw),
        # the sharded loops' 1-rank pass on TINY's captures
        "perf.multicard.run": lambda **kw: multicard.run(
            sizes=multicard.Sizes(stream=TINY, rx_batch=4, fixed_m=1),
            iters=1, emit=lambda line: None, **kw),
    }


# what the harness's and examples' entry points return on the CPU
_CPU_RESULTS = {
    "pdr_sweep": lambda out: out == {0: [1.0]},
    "mimo_pdr_sweep": lambda out: out == {8: [1.0]},
    "run_acceptance": lambda out: (out["device"]["device"] == "cpu"
                                   and out["curves"] == {}),
    "stream_decode.main": lambda out: (
        [len(r) for r in out] == [6] and all(p.fcs_ok for p in out[0])),
    "mu_sounding_demo.main": lambda out: len(out) == 2 and all(
        len(d) == 1 for d in out),
    "perf.bench.run": lambda out: (out["backend"] == "cpu"
                                   and out["device"]["name"] == "cpu"
                                   and out["value"] > 0),
    "perf.stages.measure": lambda out: (
        out["batch"] == 1 and out["stage_sum"]["device_ms"] is None
        and set(out["layouts"]) == {"fft", "movsum", "descramble"}),
    "perf.floor.bracket": lambda out: len(out) == 3 and all(
        r["full"] == [] and r["samples"] > 0 for r in out.values()),
    "perf.branch_floor.measure": lambda out: (
        out["branch_loop"] == {} and out["routed"]["window"] > 0),
    "perf.multicard.run": lambda out: (
        [(ln["loop"], ln["mesh"]) for ln in out["lines"]]
        == [(loop, [1, 1]) for loop in MULTICARD_LOOPS]
        and all(ln["cards"] == [{"name": "cpu", "power_limit": None}]
                for ln in out["lines"])),
}


@pytest.mark.parametrize("name", list(_slice_entry_points()))
def test_slice_entry_points_need_a_card(monkeypatch, tmp_path, name):
    build = _slice_entry_points(tmp_path)[name]
    _no_card(monkeypatch)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build(**kw)


@pytest.mark.parametrize("name", list(_slice_entry_points()))
def test_slice_entry_points_run_on_the_cpu_when_asked(monkeypatch, tmp_path,
                                                      name):
    _no_card(monkeypatch)
    out = _slice_entry_points(tmp_path)[name](device="cpu")
    cpu = torch.device("cpu")
    if name in _CPU_RESULTS:
        assert _CPU_RESULTS[name](out)
    elif isinstance(out, torch.nn.Module):
        assert {b.device for b in out.buffers()} == {cpu}
    elif hasattr(out, "siso_rx"):
        assert out.siso_rx.device == out.mimo_rx.device == cpu
    elif hasattr(out, "device"):
        assert out.device == cpu
    else:
        assert out in (None, [])     # silence: no NDP, no packet


def test_entry_points_without_a_device_need_a_card(monkeypatch):
    """With no device given, every entry point asks for the card, and
    raises where there is none: nothing falls back to the CPU."""
    from ieee80211_tpu_torch import entry
    from ieee80211_tpu_torch.parallel import (make_global_phy_mesh,
                                              make_phy_mesh)
    from ieee80211_tpu_torch.rx import (MimoReceiver, SisoReceiver,
                                        get_data_decoder, get_mimo_decoder,
                                        get_mrc_decoder)
    from ieee80211_tpu_torch.rx.generic import GenericSisoDecoder
    _no_card(monkeypatch)
    mod = port_mod(Mod(F.VHT, 7))
    mod2 = port_mod(Mod(F.VHT, 4, BW.BW20, 2))
    for build in (lambda: RxPipeline(mod, 18, 582), SisoReceiver,
                  MimoReceiver, lambda: get_data_decoder(mod, 16),
                  lambda: get_mimo_decoder(mod2, 16),
                  lambda: get_mrc_decoder(mod, 16),
                  lambda: RxPipeline(mod, 18, 582, device="cuda"),
                  make_phy_mesh, make_global_phy_mesh,
                  lambda: make_phy_mesh(device="cuda"),
                  lambda: GenericSisoDecoder(((F.L, 3), (F.VHT, 7)), 8),
                  entry.entry, lambda: entry.dryrun_multichip(1),
                  lambda: entry.entry("cuda"),
                  lambda: entry.dryrun_multichip(1, device="cuda")):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build()


def test_entry_points_run_on_the_cpu_when_asked(monkeypatch):
    from ieee80211_tpu_torch.rx import (MimoReceiver, SisoReceiver,
                                        get_data_decoder)
    _no_card(monkeypatch)
    cpu = torch.device("cpu")
    mod = port_mod(Mod(F.VHT, 7))
    pipe = RxPipeline(mod, 18, 582, device="cpu")
    assert {b.device for b in pipe.buffers()} == {cpu}
    assert SisoReceiver(device="cpu").device == cpu
    assert MimoReceiver(device="cpu").device == cpu
    assert MimoReceiver(device=cpu).sig.band.device == cpu
    assert get_data_decoder(mod, 16, "cpu").vit_w0.device == cpu
    from ieee80211_tpu_torch.rx.generic import GenericSisoDecoder
    dec = GenericSisoDecoder(((F.L, 3), (F.VHT, 7)), 8, device="cpu")
    assert {b.device for b in dec.buffers()} == {cpu}
    from ieee80211_tpu_torch import entry
    step, args = entry.entry(device="cpu")
    assert {b.device for b in step.buffers()} == {cpu}
    assert {a.device for a in args} == {cpu}


def test_meshes_run_on_the_cpu_when_asked(monkeypatch):
    """Without a card and a process group, the mesh builders make a 1-rank
    gloo group on the CPU when asked for it."""
    import torch.distributed as dist
    from ieee80211_tpu_torch.parallel import (make_global_phy_mesh,
                                              make_phy_mesh)
    _no_card(monkeypatch)
    assert not dist.is_initialized()
    try:
        for build in (make_phy_mesh, make_global_phy_mesh):
            mesh = build(device="cpu")
            assert mesh.device_type == "cpu"
            assert tuple(mesh.mesh.shape) == (1, 1)
            assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
