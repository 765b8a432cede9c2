"""The port's copy of the golden transmitter (ieee80211_tpu_torch/tx/golden.py)
gives the JAX package's samples bit for bit: `gen_mpdu`, `gen_ampdu` and
`finalize` for L, HT and VHT at 20/40/80 MHz and for 2x2, an MU PPDU, and
the `bcc`, `scramble` and `pilot_sequence` building blocks.
"""
import dataclasses

import numpy as np
import pytest

from ieee80211_tpu.mac import MacConfig, aggregate_vht, build_udp_mpdu
from ieee80211_tpu.specs import BW, CR, F, Mod
from ieee80211_tpu.tx import golden as jgolden
from ieee80211_tpu_torch.tx import golden
from torch_parity import MAC, port_mod

CONFIGS = [(F.L, 0, BW.BW20, 1), (F.L, 7, BW.BW20, 1), (F.HT, 5, BW.BW20, 1),
           (F.HT, 7, BW.BW40, 1), (F.HT, 12, BW.BW20, 2),
           (F.HT, 15, BW.BW40, 2), (F.VHT, 7, BW.BW20, 1),
           (F.VHT, 9, BW.BW40, 1), (F.VHT, 9, BW.BW80, 1),
           (F.VHT, 4, BW.BW20, 2), (F.VHT, 7, BW.BW80, 2)]


def _assert_tx_equal(got, want):
    """Two TxResults: Mod and PPDU parameters field for field, waveform and
    SIG-B CRC bit for bit."""
    assert dataclasses.asdict(got.mod) == dataclasses.asdict(want.mod)
    assert dataclasses.asdict(got.pp) == dataclasses.asdict(want.pp)
    assert got.waveform.dtype == want.waveform.dtype
    np.testing.assert_array_equal(got.waveform, want.waveform)
    np.testing.assert_array_equal(np.asarray(got.sigb_crc),
                                  np.asarray(want.sigb_crc))


def _mpdu(seed: int, n: int = 200) -> bytes:
    body = bytes(np.random.default_rng(seed).integers(0, 256, n,
                                                      dtype=np.uint8))
    return build_udp_mpdu(body, MacConfig(subtype=8, seq=seed, **MAC))


@pytest.mark.parametrize("fmt,mcs,bw,nsts", CONFIGS)
def test_gen_mpdu_and_ampdu_equal_jax(fmt, mcs, bw, nsts):
    mod = Mod(fmt, mcs, bw, nsts)
    mpdu = _mpdu(mcs + 10 * int(bw))
    if fmt != F.VHT:
        _assert_tx_equal(golden.gen_mpdu(mpdu, port_mod(mod), scrambler=71),
                         jgolden.gen_mpdu(mpdu, mod, scrambler=71))
    if fmt != F.L:
        ampdu = aggregate_vht([mpdu, _mpdu(3, 60)])
        _assert_tx_equal(
            golden.gen_ampdu(ampdu, port_mod(mod), partial_aid=5),
            jgolden.gen_ampdu(ampdu, mod, partial_aid=5))


@pytest.mark.parametrize("nsts", [1, 2])
def test_ndp_equals_jax(nsts):
    mod = Mod(F.VHT, 0, BW.BW20, nsts)
    _assert_tx_equal(golden.gen_ampdu(b"", port_mod(mod)),
                     jgolden.gen_ampdu(b"", mod))


def test_gen_ampdu_mu_equals_jax():
    mods = [Mod(F.VHT, 4, BW.BW20, 1), Mod(F.VHT, 7, BW.BW20, 1)]
    ampdus = [aggregate_vht([_mpdu(1, 120)]), aggregate_vht([_mpdu(2, 90)])]
    rng = np.random.default_rng(5)
    n_sc = 64
    bfq = (rng.standard_normal((n_sc, 2, 2))
           + 1j * rng.standard_normal((n_sc, 2, 2))).astype(np.complex128)
    _assert_tx_equal(
        golden.gen_ampdu_mu(ampdus, [port_mod(m) for m in mods], bfq),
        jgolden.gen_ampdu_mu(ampdus, mods, bfq))


@pytest.mark.parametrize("fmt,mcs,bw,nsts", CONFIGS[::2])
def test_finalize_equals_jax(fmt, mcs, bw, nsts):
    mod = Mod(fmt, mcs, bw, nsts)
    wave = jgolden.gen_ampdu(aggregate_vht([_mpdu(4)]), mod).waveform \
        if fmt != F.L else jgolden.gen_mpdu(_mpdu(4), mod).waveform
    fs = 20e6 * (1 << int(bw))
    for kw in (dict(), dict(multiplier=0.2, cfo_hz=15000.0, gap=True,
                            gap_len=800, fs_hz=fs),
               dict(multiplier=0.5, cfo_hz=-3e4, num=3, gap=False,
                    fs_hz=fs)):
        got, want = golden.finalize(wave, **kw), jgolden.finalize(wave, **kw)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cr", list(CR))
def test_bcc_and_scramble_equal_jax(cr):
    rng = np.random.default_rng(int(cr))
    for n in (6, 24, 481, 4680):
        bits = rng.integers(0, 2, n).astype(np.uint8)
        np.testing.assert_array_equal(golden.bcc(bits, cr),
                                      jgolden.bcc(bits, cr))
        for seed in (1, 71, 93, 127):
            np.testing.assert_array_equal(golden.scramble(bits, seed),
                                          jgolden.scramble(bits, seed))


@pytest.mark.parametrize("fmt,mcs,bw,nsts", CONFIGS)
def test_pilot_sequence_equals_jax(fmt, mcs, bw, nsts):
    mod = Mod(fmt, mcs, bw, nsts)
    for iss in range(nsts):
        for pidx0 in (None, 1, 3, 4):
            np.testing.assert_array_equal(
                golden.pilot_sequence(port_mod(mod), 9, iss, pidx0),
                jgolden.pilot_sequence(mod, 9, iss, pidx0))
