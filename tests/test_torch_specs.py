"""The port's copy of the spec layer (ieee80211_tpu_torch/specs/) equals the
JAX package's ieee80211_tpu/specs/ exactly: every public table and dict of
`tables`, the enums, the Mod / PpduParams properties over a grid of L, HT
and VHT configurations at 20/40/80 MHz with 1-2 streams, the interleaver
permutations and the CRCs.
"""
import dataclasses

import numpy as np
import pytest

from ieee80211_tpu.specs import crc as jcrc
from ieee80211_tpu.specs import enums as jenums
from ieee80211_tpu.specs import interleaver as jilv
from ieee80211_tpu.specs import modulation as jmodulation
from ieee80211_tpu.specs import tables as jtables
from ieee80211_tpu_torch.specs import (crc, enums, interleaver, modulation,
                                       tables)
import torch_parity  # noqa: F401  (caps torch's threads)

BWS = list(jenums.BW)


def _public(module, kind):
    return sorted(n for n in dir(module) if not n.startswith("_")
                  and isinstance(getattr(module, n), kind)
                  and not isinstance(getattr(module, n), type))


def _assert_same(got, want):
    """Equal in type family and value: arrays element for element with their
    dtype, dicts key for key, sequences item for item."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("name", _public(jtables, (np.ndarray, dict, list,
                                                   int)))
def test_table_equals_jax(name):
    _assert_same(getattr(tables, name), getattr(jtables, name))


def test_every_public_table_is_copied():
    kinds = (np.ndarray, dict, list, int)
    assert _public(tables, kinds) == _public(jtables, kinds)


@pytest.mark.parametrize("fn", ["data_pos_in_occ", "data_sc", "occupied_sc",
                                "pilot_pos_in_occ"])
@pytest.mark.parametrize("bw,legacy", [(jenums.BW.BW20, True)]
                         + [(bw, False) for bw in BWS])
def test_tone_maps_equal_jax(fn, bw, legacy):
    _assert_same(getattr(tables, fn)(bw, legacy),
                 getattr(jtables, fn)(bw, legacy))


@pytest.mark.parametrize("bw", BWS)
def test_tone_rotation_and_grid_index_equal_jax(bw):
    _assert_same(tables.tone_rotation(bw), jtables.tone_rotation(bw))
    k = jtables.occupied_sc(bw, False)
    _assert_same(tables.grid_index(k, bw), jtables.grid_index(k, bw))


@pytest.mark.parametrize("enum_name", ["F", "BW", "CR", "M", "GRF"])
def test_enum_equals_jax(enum_name):
    got, want = getattr(enums, enum_name), getattr(jenums, enum_name)
    assert [(e.name, e.value) for e in got] == [(e.name, e.value)
                                               for e in want]
    # IntEnums: a member of one package equals and hashes as the other's
    for g, w in zip(got, want):
        assert g == w and hash(g) == hash(w)


def test_code_rate_ratios_equal_jax():
    assert {int(k): v for k, v in enums.CR_RATIO.items()} == {
        int(k): v for k, v in jenums.CR_RATIO.items()}
    assert (modulation.N_SERVICE, modulation.N_TAIL) == (
        jmodulation.N_SERVICE, jmodulation.N_TAIL)


def _grid():
    """(fmt, mcs, bw, nSTS): L MCS 0-7 at 20 MHz, HT MCS 0-15 at 20/40 MHz,
    VHT MCS 0-9 at 20/40/80 MHz with 1 and 2 streams; some are invalid
    (both packages must refuse them alike)."""
    F, BW = jenums.F, jenums.BW
    out = [(F.L, m, BW.BW20, 1) for m in range(8)]
    out += [(F.HT, m, bw, m // 8 + 1) for m in range(16)
            for bw in (BW.BW20, BW.BW40)]
    out += [(F.VHT, m, bw, n) for m in range(10) for bw in BWS
            for n in (1, 2)]
    return out


PROPS = ["mod", "cr", "nSS", "nBPSCS", "legacy_tones", "nSD", "nSP",
         "intlv_cols", "intlv_rows", "intlv_rot", "nCBPSS", "nCBPS", "nDBPS",
         "nES", "nLTF", "spr", "dr_mbps"]


def _outcome(fn, *args):
    """fn(*args) as ("ok", its fields) or ("error", exception name and
    message): the two packages raise their own ConfigError classes."""
    try:
        out = fn(*args)
    except (modulation.ConfigError, jmodulation.ConfigError) as e:
        return "error", type(e).__name__, str(e)
    return "ok", dataclasses.asdict(out)


def _mods(fmt, mcs, bw, nsts):
    try:
        want = jmodulation.Mod(fmt, mcs, bw, nsts)
    except jmodulation.ConfigError:
        with pytest.raises(modulation.ConfigError):
            modulation.Mod(fmt, mcs, bw, nsts)
        return None, None
    return modulation.Mod(fmt, mcs, bw, nsts), want


@pytest.mark.parametrize("fmt,mcs,bw,nsts", _grid())
def test_mod_and_ppdu_params_equal_jax(fmt, mcs, bw, nsts):
    got, want = _mods(fmt, mcs, bw, nsts)
    if want is None:
        return
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert hash(got) == hash(want)
    for p in PROPS:
        assert getattr(got, p) == getattr(want, p), p
    for length in (1, 100, 1500, 4000):
        for fn in ("ppdu_params_aggregate", "ppdu_params_nonaggregate"):
            g = _outcome(getattr(modulation, fn), got, length)
            assert g == _outcome(getattr(jmodulation, fn), want, length), fn
        if g[0] == "ok":
            assert (modulation.ppdu_params_nonaggregate(got, length)
                    .n_data_bits == jmodulation.ppdu_params_nonaggregate(
                        want, length).n_data_bits)
    assert _outcome(modulation.ppdu_params_aggregate_mu, got, 300, 40) == (
        _outcome(jmodulation.ppdu_params_aggregate_mu, want, 300, 40))


@pytest.mark.parametrize("fmt,mcs,bw,nsts", _grid())
def test_interleaver_permutations_equal_jax(fmt, mcs, bw, nsts):
    got, want = _mods(fmt, mcs, bw, nsts)
    if want is None:
        return
    for iss in range(want.nSS):
        _assert_same(interleaver.rx_perm(got, iss), jilv.rx_perm(want, iss))
        _assert_same(interleaver.tx_perm(got, iss), jilv.tx_perm(want, iss))
    _assert_same(interleaver.stream_parser_maps(got),
                 jilv.stream_parser_maps(want))
    _assert_same(interleaver.stream_deparser_maps(got),
                 jilv.stream_deparser_maps(want))


def test_sig_permutations_equal_jax():
    _assert_same(interleaver.sig_rx_perm(), jilv.sig_rx_perm())
    _assert_same(interleaver.sig_tx_perm(), jilv.sig_tx_perm())


@pytest.mark.parametrize("seed", range(4))
def test_crcs_equal_jax(seed):
    rng = np.random.default_rng(seed)
    _assert_same(crc.crc32_table(), jcrc.crc32_table())
    for n in (0, 1, 7, 34, 1500):
        data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        assert crc.crc32_bytes(data) == jcrc.crc32_bytes(data)
        framed = crc.append_fcs(data)
        assert framed == jcrc.append_fcs(data)
        assert crc.fcs_ok(framed) == jcrc.fcs_ok(framed)
        if n:
            assert crc.fcs_ok(framed) is True
            bad = bytes([framed[0] ^ 1]) + framed[1:]
            assert crc.fcs_ok(bad) == jcrc.fcs_ok(bad) is False
    for n in (8, 24, 34, 100):
        bits = rng.integers(0, 2, n).astype(np.uint8)
        got = crc.crc8_bits(bits)
        assert got == jcrc.crc8_bits(bits) == tables.crc8_bits(bits)
        assert crc.crc8_check(bits, got) == jcrc.crc8_check(bits, got)
        flipped = [1 - b for b in got]
        assert crc.crc8_check(bits, flipped) == jcrc.crc8_check(bits,
                                                                flipped)
