"""The port's generic SISO decoder (`ieee80211_tpu_torch/rx/generic.py`) and
the coding helpers it brought (`viterbi_decode_pairs`, `depuncture_slots`,
`scramble_seed_of`) against the JAX package's.

Tables are equal element for element; decoded bits are equal bit for bit
with the port's Viterbi at radix 3, as the JAX CPU decoder runs
(`torch_parity.radix3`), on the same numpy windows.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ieee80211_tpu.ops import coding as jcoding
from ieee80211_tpu.ops import sync as jsync
from ieee80211_tpu.rx import generic as jgen
from ieee80211_tpu.specs import CR, F
from ieee80211_tpu.utils import c2r
from ieee80211_tpu_torch.ops import coding
from ieee80211_tpu_torch.rx import generic as pgen
from test_generic_decoder import _build
from torch_parity import encode_batch, radix3, radix_tensors

CONFIG_SETS = {
    "L": ((F.L, 2), (F.L, 3), (F.L, 5), (F.L, 7)),
    "HT": ((F.HT, 1), (F.HT, 4), (F.HT, 6), (F.HT, 7)),
    "VHT": ((F.VHT, 2), (F.VHT, 5), (F.VHT, 7), (F.VHT, 8)),
    "mixed": ((F.L, 3), (F.HT, 5), (F.VHT, 7), (F.VHT, 2)),
}


@pytest.mark.parametrize("name", list(CONFIG_SETS))
def test_cfg_tables_equal_jax(name):
    configs = CONFIG_SETS[name]
    for got, ref in zip(pgen._cfg_tables(configs, 12),
                        jgen._cfg_tables(configs, 12)):
        np.testing.assert_array_equal(got, ref)
    dec = pgen.GenericSisoDecoder(configs, 12, device="cpu")
    np.testing.assert_array_equal(dec.src_idx.numpy(),
                                  jgen._cfg_tables(configs, 12)[0])
    assert dec.n_bits_max == jgen.GenericSisoDecoder(configs,
                                                     12).n_bits_max
    assert dec.zlen() == jgen.GenericSisoDecoder(configs, 12).zlen()


@pytest.mark.parametrize("n_sym", [1, 7, 24])
def test_pilot_ref_table_equal_jax(n_sym):
    np.testing.assert_array_equal(pgen._pilot_ref_table(n_sym),
                                  jgen._pilot_ref_table(n_sym))


@pytest.mark.parametrize("cr", list(CR))
def test_depuncture_helpers_equal_jax(cr):
    for n in (1, 24, 4680):
        np.testing.assert_array_equal(coding.depuncture_slots(cr, n),
                                      jcoding.depuncture_slots(cr, n))
        np.testing.assert_array_equal(pgen._depuncture_map(cr, n),
                                      jgen._depuncture_map(cr, n))


def test_scramble_seed_of_equal_jax():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (300, 16)).astype(np.int32)
    seed_inv = torch.from_numpy(coding._seed_from_first7())
    got = coding.scramble_seed_of(torch.from_numpy(bits), seed_inv)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcoding.scramble_seed_of(jnp.asarray(bits))))


@pytest.mark.parametrize("cr,n_bits", [(CR.CR12, 48), (CR.CR34, 360),
                                       (CR.CR56, 1001)])
def test_viterbi_decode_pairs_bit_exact(cr, n_bits):
    """Noisy depunctured pairs through both packages at radix 3 (n_bits not
    a multiple of 3 included), and to the encoder's bits."""
    rng = np.random.default_rng(n_bits)
    bits, llr = encode_batch(rng, 6, n_bits, cr, sigma=0.3)
    lp = np.asarray(jcoding.depuncture(jnp.asarray(llr), cr, n_bits))
    ref = np.asarray(jcoding.viterbi_decode_pairs(jnp.asarray(lp), n_bits))
    got = coding.viterbi_decode_pairs(torch.from_numpy(lp), n_bits,
                                      *radix_tensors(3)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, bits)
    # at the card's radix 4 (the plain version on the CPU) the bits hold
    np.testing.assert_array_equal(
        coding.viterbi_decode_pairs(torch.from_numpy(lp), n_bits,
                                    *radix_tensors(4)).numpy(), bits)


def _windows(configs, n_sym: int, seed: int, snr_db=None):
    """One window per config (40-byte payloads, CFO 8 kHz), triggered 8
    samples early, with white noise at snr_db when given."""
    rng = np.random.default_rng(seed)
    w = 200 + jgen.GenericSisoDecoder(configs, n_sym).window_capacity()
    rows, pps = [], []
    for fmt, mcs in configs:
        mod, pp, _, wave = _build(fmt, mcs, bytes(rng.integers(
            0, 256, 40, dtype=np.uint8)))
        assert pp.n_sym <= n_sym
        x = np.zeros(w, np.complex64)
        seg = wave[64 - 8:]
        x[:min(w, len(seg))] = seg[:min(w, len(seg))]
        if snr_db is not None:
            rms = float(np.sqrt(np.mean(np.abs(wave[:320]) ** 2)))
            x += ((rng.standard_normal(w) + 1j * rng.standard_normal(w))
                  * rms * 10 ** (-snr_db / 20) / np.sqrt(2))
        rows.append(c2r(x.astype(np.complex64)))
        pps.append(pp)
    return np.stack(rows), np.asarray([p.n_sym for p in pps], np.int32)


@pytest.mark.parametrize("name,snr_db", [("L", None), ("HT", None),
                                         ("VHT", None), ("mixed", 30.0)])
def test_generic_decode_bit_exact(name, snr_db):
    """GenericSisoDecoder.decode of both packages on the same windows, the
    sync's (ltf_start, cfo) from the JAX package handed to both."""
    configs = CONFIG_SETS[name]
    n_sym = 24
    x2, nv = _windows(configs, n_sym, 5, snr_db)
    ls, cfo, _ = jsync.sync_front_iq(jnp.asarray(x2),
                                     jnp.zeros(len(x2), jnp.int32))
    cfg_idx = np.arange(len(x2), dtype=np.int32)
    ref = np.asarray(jgen.GenericSisoDecoder(configs, n_sym).decode(
        jnp.asarray(x2), ls, cfo, jnp.asarray(cfg_idx), jnp.asarray(nv)))
    dec = radix3(pgen.GenericSisoDecoder(configs, n_sym, device="cpu"))
    got = dec.decode(torch.from_numpy(x2),
                     torch.from_numpy(np.asarray(ls)),
                     torch.from_numpy(np.asarray(cfo)),
                     torch.from_numpy(cfg_idx), torch.from_numpy(nv))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
