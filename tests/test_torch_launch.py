"""What surrounds the port's hand-written kernels, on the CPU: the wrappers
of ieee80211_tpu_torch/ops/cuda/ and their launch path (ops/cuda/build.py).

The kernels themselves run only on a card (chip_smoke.py holds them to their
plain versions there). Here:
  * each wrapper raises on what its kernel does not take before it reaches
    the launch path, and on a tensor that only claims to be on a card
    (`_OnCard`: a CPU tensor whose device index reads 0) hands the launch
    function the arguments its C signature expects, counting one launch;
  * the plain window slices give the JAX package's windows for int32 and
    int64 starts, at tests/test_pallas_gather.py's shapes;
  * every extern "C" launch function of csrc/*.cu has its argument types in
    the launch path's table, and every table entry is in the sources.
"""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ieee80211_tpu.ops import sync as jsync
from ieee80211_tpu.rx import receiver as jreceiver
from ieee80211_tpu_torch.ops import coding, sync
from ieee80211_tpu_torch.ops.cuda import build
from ieee80211_tpu_torch.ops.cuda import gather as kg
from ieee80211_tpu_torch.ops.cuda import vit_floor as kf
from ieee80211_tpu_torch.ops.cuda import viterbi as kv
from ieee80211_tpu_torch.rx import receiver
import torch_parity  # noqa: F401  (caps torch's threads)

# tests/test_pallas_gather.py's shapes (b, n, L)
GATHER_SHAPES = [(8, 500, 120), (32, 2320, 2080), (5, 300, 300),
                 (16, 1096, 1096), (3, 129, 64)]


class _OnCard:
    """A CPU tensor that reads as lying on card 0: the wrappers check only
    metadata, so it carries them to their launch call."""

    is_cuda = True

    def __init__(self, t: torch.Tensor):
        self._t = t

    def get_device(self) -> int:
        return 0

    @property
    def device(self):
        return torch.device("cuda", 0)

    def contiguous(self):
        return self if self._t.is_contiguous() else _OnCard(
            self._t.contiguous())

    def clone(self):
        return _OnCard(self._t.clone())

    def new_empty(self, *args, **kwargs):
        return self._t.new_empty(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._t, name)


@pytest.fixture
def launches(monkeypatch):
    """Every launch the wrappers make, as (name, device, args), in place of
    the launch path; library() must not be reached."""
    calls = []

    def fake_launch(name, device, *args):
        calls.append((name, device, args))

    def no_library():
        raise AssertionError("library() reached")

    for mod in (kg, kv, kf):
        monkeypatch.setattr(mod, "launch", fake_launch)
    monkeypatch.setattr(build, "library", no_library)
    return calls


def _iq(*shape, dtype=torch.float32):
    return torch.zeros(shape + (2,), dtype=dtype)


def _starts(n, dtype=torch.int32):
    return torch.zeros(n, dtype=dtype)


# each slice wrapper with a valid call: (wrapper, source, starts, length,
# counter name)
def _slice_cases():
    return {
        "per_row": (kg.batch_slice_iq_cuda, _iq(4, 20), _starts(4), 6,
                    "LAUNCHES"),
        "shared": (kg.capture_slice_iq_cuda, _iq(50), _starts(3), 6,
                   "SHARED_LAUNCHES"),
        "multi": (kg.capture_slice_iq_mimo_cuda, _iq(2, 50), _starts(3), 6,
                  "MULTI_LAUNCHES"),
    }


def _misaligned(x: torch.Tensor) -> torch.Tensor:
    """x's values in a contiguous tensor whose data starts 4 bytes off 8."""
    base = torch.zeros(x.numel() + 1, dtype=x.dtype)
    return base[1:].view(x.shape)


# what the slice kernel does not take: name -> (source, starts, length)
def _bad_slice(mode, x, st, length):
    wrong_rank = x[0] if mode != "shared" else x[None]
    return {
        "cpu": (x, st, length, False),
        "float64": (x.double(), st, length, True),
        "wrong_rank": (wrong_rank, st, length, True),
        "not_iq": (x[..., :1].contiguous(), st, length, True),
        "non_contiguous": (x[..., ::2, :], st, length, True),
        "misaligned": (_misaligned(x), st, length, True),
        "length_0": (x, st, 0, True),
        "length_past_n": (x, st, x.shape[-2] + 1, True),
        "starts_float": (x, st.float(), length, True),
        "starts_2d": (x, st[:, None], length, True),
        "starts_cpu": (x, st, length, "starts_cpu"),
    }


@pytest.mark.parametrize("mode", ["per_row", "shared", "multi"])
@pytest.mark.parametrize("bad", ["cpu", "float64", "wrong_rank", "not_iq",
                                 "non_contiguous", "misaligned", "length_0",
                                 "length_past_n", "starts_float", "starts_2d",
                                 "starts_cpu"])
def test_slice_wrapper_rejects(mode, bad, launches):
    wrapper, x, st, length, counter = _slice_cases()[mode]
    src, starts, length, on_card = _bad_slice(mode, x, st, length)[bad]
    if bad == "starts_2d" and mode == "per_row":
        starts = _starts(4)[:, None]
    if on_card == "starts_cpu":   # samples on the card, starts on the host
        src, on_card = _OnCard(src), False
    elif on_card:
        src, starts = _OnCard(src), _OnCard(starts)
    before = getattr(kg, counter)
    with pytest.raises(ValueError):
        wrapper(src, starts, length)
    assert launches == [] and getattr(kg, counter) == before


@pytest.mark.parametrize("mode", ["per_row", "shared", "multi"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_slice_wrapper_launch_arguments(mode, dtype, launches):
    """A valid call hands slice_iq_launch its C arguments (x, start,
    start64, out, windows, chains, n, len, per_row), without casting the
    starts, and counts one launch; no windows, no launch."""
    wrapper, x, st, length, counter = _slice_cases()[mode]
    st = st.to(dtype)
    before = getattr(kg, counter)
    out = wrapper(_OnCard(x), _OnCard(st), length)
    assert getattr(kg, counter) == before + 1
    (name, device, args), = launches
    windows = st.shape[0]
    chains = x.shape[0] if mode == "multi" else 1
    want_shape = ((windows, chains, length, 2) if mode == "multi"
                  else (windows, length, 2))
    assert name == "slice_iq_launch" and device == 0
    assert tuple(out.shape) == want_shape and out.dtype == torch.float32
    assert args == (x.data_ptr(), st.data_ptr(), dtype == torch.int64,
                    out.data_ptr(), windows, chains, x.shape[-2], length,
                    int(mode == "per_row"))
    assert len(args) + 1 == len(build.SIGNATURES[name])   # + the stream
    empty = x[:0] if mode == "per_row" else x
    out = wrapper(_OnCard(empty), _OnCard(st[:0]), length)
    assert out.shape[0] == 0 and len(launches) == 1
    assert getattr(kg, counter) == before + 1


def test_viterbi_wrapper_checks_and_arguments(launches):
    w0, w1 = coding._radix_tables(kv.K)
    w0, w1 = _OnCard(torch.from_numpy(w0)), _OnCard(torch.from_numpy(w1))
    lp = torch.zeros(3, 8, 2)
    bad = [(lp, w0, w1, 64),                               # on the host
           (_OnCard(lp.double()), w0, w1, 64),
           (_OnCard(lp[:, :, :1].contiguous()), w0, w1, 64),
           (_OnCard(lp.transpose(0, 1)), w0, w1, 64),
           (_OnCard(torch.zeros(3, 6, 2)), w0, w1, 64),    # T % 4
           (_OnCard(lp), w0, w1, 0),                       # renorm
           (_OnCard(lp), w0._t, w1, 64),                   # table on host
           (_OnCard(lp), _OnCard(w0._t[:, :8]), w1, 64)]   # radix 3
    before = kv.LAUNCHES
    for args in bad:
        with pytest.raises(ValueError):
            kv.viterbi_pairs_cuda(*args)
    assert launches == [] and kv.LAUNCHES == before
    bits = kv.viterbi_pairs_cuda(_OnCard(lp), w0, w1, 64)
    (name, device, args), = launches
    assert name == "viterbi_r4_launch" and device == 0
    assert tuple(bits.shape) == (3, 8) and bits.dtype == torch.int32
    assert args[4:] == (bits.data_ptr(), 3, 2, 64)
    assert len(args) + 1 == len(build.SIGNATURES[name])
    assert kv.LAUNCHES == before + 1


def test_floor_probe_wrapper_checks_and_arguments(launches):
    lp = torch.zeros(3, 5, 2 * kf.K)
    bad = [lp, _OnCard(lp.double()), _OnCard(lp[:, :, :4].contiguous()),
           _OnCard(lp.transpose(0, 1)), _OnCard(lp[0])]
    before = kf.LAUNCHES
    for x in bad:
        with pytest.raises(ValueError):
            kf.vit_floor_cuda(x)
    assert launches == [] and kf.LAUNCHES == before
    out = kf.vit_floor_cuda(_OnCard(lp))
    (name, device, args), = launches
    assert name == "vit_floor_launch" and device == 0
    assert tuple(out.shape) == (3, 64) and out.dtype == torch.int32
    assert args[1:] == (out.data_ptr(), 3, 5)
    assert len(args) + 1 == len(build.SIGNATURES[name])
    assert kf.LAUNCHES == before + 1


@pytest.mark.parametrize("b,n,L", GATHER_SHAPES)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_plain_slices_equal_jax_for_both_start_types(b, n, L, dtype):
    """The per-row, shared-source and multi-chain plain slices against the
    JAX package's batch_slice_iq, capture_windows and capture_windows_mimo,
    starts past N - L included."""
    rng = np.random.default_rng(b * 7 + L)
    x2 = rng.standard_normal((b, n, 2)).astype(np.float32)
    st = rng.integers(0, n - L + 3, b).astype(np.int32)
    st[0] = n - L
    s = torch.from_numpy(st).to(dtype)
    ref = np.asarray(jsync.batch_slice_iq(jnp.asarray(x2), jnp.asarray(st),
                                          L))
    got = sync.batch_slice_iq_plain(torch.from_numpy(x2), s, L)
    np.testing.assert_array_equal(got.numpy(), ref)
    cap = x2.reshape(-1, 2)
    cs = rng.integers(0, b * n - L + 3, b).astype(np.int32)
    ref = np.asarray(jreceiver.capture_windows(jnp.asarray(cap),
                                               jnp.asarray(cs), L))
    got = receiver.capture_windows_plain(torch.from_numpy(cap),
                                         torch.from_numpy(cs).to(dtype), L)
    np.testing.assert_array_equal(got.numpy(), ref)
    chains = x2[:2] if b > 1 else x2
    ms = rng.integers(0, n - L + 3, b).astype(np.int32)
    ref = np.asarray(jreceiver.capture_windows_mimo(
        jnp.asarray(chains), jnp.asarray(ms), L))
    got = receiver.capture_windows_mimo_plain(
        torch.from_numpy(chains), torch.from_numpy(ms).to(dtype), L)
    np.testing.assert_array_equal(got.numpy(), ref)


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int}


def _extern_launches() -> dict:
    """{name: [ctypes type per parameter]} of every extern "C" int function
    in csrc/*.cu."""
    found = {}
    for src in sorted(build.CSRC.glob("*.cu")):
        text = src.read_text()
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       text):
            types = [re.sub(r"\s*\w+$", "", p.strip()).replace(" *", "*")
                     for p in params.split(",")]
            found[name] = [_C_TYPES[t] for t in types]
    return found


def test_every_launch_function_has_its_signature():
    found = _extern_launches()
    assert set(found) == set(build.SIGNATURES)
    for name, argtypes in build.SIGNATURES.items():
        assert found[name] == argtypes, name
        assert argtypes[-1] is ctypes.c_void_p   # the stream, last


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_each_table_entry_is_a_launch_function_in_the_sources(name):
    text = "".join(p.read_text() for p in build.CSRC.glob("*.cu"))
    assert f'extern "C" int {name}(' in text


@pytest.mark.parametrize("chains", [0, kg.MAX_CHAINS + 1])
def test_multi_chain_wrapper_rejects_chain_counts(chains, launches):
    """One grid layer per chain: 0 chains, or more than the grid's z extent,
    raise before the launch."""
    before = kg.MULTI_LAUNCHES
    with pytest.raises(ValueError):
        kg.capture_slice_iq_mimo_cuda(_OnCard(_iq(chains, 4)),
                                      _OnCard(_starts(3)), 2)
    assert launches == [] and kg.MULTI_LAUNCHES == before
