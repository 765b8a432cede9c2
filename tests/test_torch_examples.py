"""The port's capture file IO (ieee80211_tpu_torch/utils/binio.py) and its
examples (ieee80211_tpu_torch/examples/) on the CPU.

binio is a copy: a save of one signal writes the same bytes as the JAX
package's, and each package loads the other's file to the same array. The
capture generator writes bins byte-identical to examples/gen_test_captures.py
(both use the golden numpy TX). The decoding examples run with
device="cpu" at a small size: every packet of the generated captures,
of a one-capture stream (SISO and dual-chain, MU packets included) and of
the MU sounding demo decodes.
"""
import importlib.util
import os

import numpy as np
import pytest

from ieee80211_tpu.utils import binio as jbinio
from ieee80211_tpu_torch.examples import (gen_test_captures, inspect_bin,
                                          mu_sounding_demo, stream_decode)
from ieee80211_tpu_torch.specs import F
from ieee80211_tpu_torch.utils import binio, load_complex_bin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_binio_round_trip_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    sig = (rng.standard_normal(1001) + 1j * rng.standard_normal(1001)
           ).astype(np.complex64)
    binio.save_complex_bin(str(tmp_path / "port.bin"), sig)
    jbinio.save_complex_bin(str(tmp_path / "jax.bin"), sig)
    assert ((tmp_path / "port.bin").read_bytes()
            == (tmp_path / "jax.bin").read_bytes())
    got = binio.load_complex_bin(str(tmp_path / "jax.bin"))
    ref = jbinio.load_complex_bin(str(tmp_path / "port.bin"))
    assert got.dtype == ref.dtype == np.complex64
    np.testing.assert_array_equal(got, sig)
    np.testing.assert_array_equal(ref, sig)


def test_openwifi_text_equal_jax(tmp_path):
    sig = (np.arange(-20, 20) * (3 - 2j)).astype(np.complex64)
    binio.save_openwifi_text(str(tmp_path / "port.txt"), sig)
    jbinio.save_openwifi_text(str(tmp_path / "jax.txt"), sig)
    assert ((tmp_path / "port.txt").read_text()
            == (tmp_path / "jax.txt").read_text())
    np.testing.assert_array_equal(
        binio.load_openwifi_text(str(tmp_path / "jax.txt")),
        jbinio.load_openwifi_text(str(tmp_path / "port.txt")))


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """The port's captures and the JAX example's, in two directories."""
    port_dir = tmp_path_factory.mktemp("port_caps")
    jax_dir = tmp_path_factory.mktemp("jax_caps")
    paths = gen_test_captures.main(str(port_dir))
    _jax_example("gen_test_captures").main(str(jax_dir))
    return paths, jax_dir


def test_gen_test_captures_byte_identical(captures):
    paths, jax_dir = captures
    assert sorted(os.listdir(jax_dir)) == sorted(
        os.path.basename(p) for p in paths)
    for p in paths:
        with open(p, "rb") as a, open(jax_dir / os.path.basename(p),
                                      "rb") as b:
            assert a.read() == b.read(), p


# what inspect_bin decodes from each generated bin: (fs, [(fmt, mcs)]); a
# chain of the 2x2 capture alone holds no packet the SISO receiver decodes
EXPECTED = {
    "sig80211GenMultipleSiso_1x1_0.bin": (20e6, [(F.L, 7), (F.HT, 7),
                                                 (F.VHT, 7)]),
    "sig80211GenMultipleMimo_2x2_0.bin": (20e6, []),
    "sig80211GenMultipleMimo_2x2_1.bin": (20e6, []),
    "sig80211GenBeacon_1x1_0.bin": (20e6, [(F.L, 0)]),
    "sig80211GenWideband_40MHz.bin": (40e6, [(F.VHT, 7)]),
    "sig80211GenWideband_80MHz.bin": (80e6, [(F.VHT, 9)]),
}


@pytest.mark.parametrize("name", list(EXPECTED))
def test_inspect_bin_decodes_captures(captures, name):
    paths, _ = captures
    fs, want = EXPECTED[name]
    path = next(p for p in paths if p.endswith(name))
    res = inspect_bin.main(path, fs, device="cpu")
    assert [(r.fmt, r.mcs) for r in res] == want
    assert all(r.fcs_ok for r in res)


def test_mimo_capture_decodes_on_both_chains(captures):
    """The two chain bins of the 2x2 capture, read back and stacked,
    decode through the dual-chain receiver."""
    from ieee80211_tpu_torch.rx import MimoReceiver
    paths, _ = captures
    cap = np.stack([load_complex_bin(p) for p in paths if "Mimo" in p])
    res = MimoReceiver(device="cpu").decode_capture(cap)
    assert [(r.fmt, r.mcs, r.fcs_ok) for r in res] == [(F.HT, 8, True)]
    assert res[0].mpdus[0].endswith(gen_test_captures.PAYLOAD, 0, -4)


@pytest.mark.parametrize("dual", [False, True], ids=["siso", "dual"])
def test_stream_decode_small(dual):
    """One capture of one 6-packet segment: 2 HT MCS5, 2 VHT MCS7 and 2 MU
    packets (station 0's stream), every one with a good FCS."""
    results = stream_decode.main(dual, device="cpu", n_caps=1, reps=1)
    assert len(results) == 1 and len(results[0]) == stream_decode.N_SEG
    assert all(r.fcs_ok for r in results[0])
    kinds = sorted((r.fmt.name, r.mcs, r.mu) for r in results[0])
    assert kinds == [("HT", 5, False)] * 2 + [("VHT", 4, True)] * 2 + [
        ("VHT", 7, False)] * 2


def test_stream_decode_build_equal_jax():
    """The stream the port's example synthesizes is the JAX example's."""
    jax_ex = _jax_example("stream_decode")
    for dual in (False, True):
        got = stream_decode.build_stream(dual, 2, 1)
        ref = jax_ex.build_stream(dual, 2, 1)
        assert len(got) == len(ref) == 2
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


def test_mu_sounding_demo():
    assert mu_sounding_demo.main(device="cpu") == [
        [p] for p in mu_sounding_demo.PAYLOADS]
