"""The port's channel coding (ieee80211_tpu_torch/ops/coding.py) against
the JAX package: depuncture and descramble exactly; the plain Viterbi bit
for bit against the JAX decoder at the same radix and renorm period, and
against the encoder's input bits.

Radix 3 with a renorm after every block is `coding.viterbi_decode` on the
CPU; radix 4 with renorm 64 is the TPU kernel's default, run here through
the Pallas interpreter. The CUDA kernel is held to this plain version on
the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ieee80211_tpu.ops import coding as jcoding
from ieee80211_tpu.ops.pallas.viterbi import viterbi_decode_pallas
from ieee80211_tpu.specs import CR
from ieee80211_tpu.tx.golden import scramble
from ieee80211_tpu_torch.ops import coding
from torch_parity import encode_batch, radix_tensors

CRS = [CR.CR12, CR.CR23, CR.CR34, CR.CR56]
# (n_bits, batch): the cases of tests/test_pallas_interpret.py
SIZES = [(24, 33), (360, 4), (528, 4), (1040, 3)]


@pytest.mark.parametrize("cr", CRS)
@pytest.mark.parametrize("n_bits,batch", SIZES)
def test_viterbi_radix3_matches_jax_decoder(cr, n_bits, batch):
    rng = np.random.default_rng(n_bits * 10 + cr.value)
    bits, llr = encode_batch(rng, batch, n_bits, cr)
    ref = np.asarray(jcoding.viterbi_decode(jnp.asarray(llr), cr, n_bits))
    w0, w1 = radix_tensors(3)
    got = coding.viterbi_decode_plain(torch.from_numpy(llr), cr, n_bits,
                                      w0, w1, renorm=1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), bits)


@pytest.mark.parametrize("cr,n_bits,batch", [
    (CR.CR12, 24, 33), (CR.CR23, 360, 4), (CR.CR34, 528, 4),
    (CR.CR56, 360, 4), (CR.CR12, 1040, 3)])
def test_viterbi_radix4_matches_tpu_kernel(cr, n_bits, batch):
    """The main path's decoder (radix 4, renorm 64, through the dispatcher)
    equals the TPU kernel's interpreted run and the encoder's input."""
    rng = np.random.default_rng(n_bits * 7 + cr.value)
    bits, llr = encode_batch(rng, batch, n_bits, cr)
    ref = np.asarray(viterbi_decode_pallas(jnp.asarray(llr), cr, n_bits,
                                           radix=4, renorm=64, tb=128,
                                           interpret=True))
    w0, w1 = radix_tensors(4)
    got = coding.viterbi_decode(torch.from_numpy(llr), cr, n_bits, w0, w1)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), bits)


def test_viterbi_renorm_period_keeps_decisions():
    """A long noisy trellis decodes the same with renorm every block and
    every 64 blocks (the f32 metrics stay bounded either way)."""
    rng = np.random.default_rng(5)
    bits, llr = encode_batch(rng, 2, 4680, CR.CR56, sigma=0.4)
    w0, w1 = radix_tensors(4)
    x = torch.from_numpy(llr)
    a = coding.viterbi_decode_plain(x, CR.CR56, 4680, w0, w1, renorm=1)
    b = coding.viterbi_decode_plain(x, CR.CR56, 4680, w0, w1, renorm=64)
    np.testing.assert_array_equal(a.numpy(), bits)
    np.testing.assert_array_equal(b.numpy(), bits)


@pytest.mark.parametrize("cr", CRS)
@pytest.mark.parametrize("extra", [-3, 0, 5])
def test_depuncture_exact(cr, extra):
    """Short, exact and long punctured inputs depuncture as in JAX."""
    rng = np.random.default_rng(cr.value + 10 * extra + 30)
    n_steps = 97
    n_coded = jcoding.n_punctured(cr, n_steps) + extra
    llr = rng.standard_normal((3, n_coded)).astype(np.float32)
    ref = np.asarray(jcoding.depuncture(jnp.asarray(llr), cr, n_steps))
    got = coding.depuncture(torch.from_numpy(llr), cr, n_steps)
    assert tuple(got.shape) == (3, n_steps, 2)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n", [24, 780, 4680])
def test_descramble_exact(n):
    rng = np.random.default_rng(n)
    seeds = rng.integers(1, 128, 6)
    data = rng.integers(0, 2, (6, n)).astype(np.int64)
    data[:, :7] = 0                       # SERVICE bits are zero
    scr = np.stack([scramble(d, int(s)) for d, s in zip(data, seeds)]
                   ).astype(np.int32)
    ref = np.asarray(jcoding.descramble(jnp.asarray(scr)))
    got = coding.descramble(torch.from_numpy(scr),
                            torch.from_numpy(coding._prbs_tiled(n)),
                            torch.from_numpy(coding._seed_from_first7()))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), data)


def test_viterbi_cpu_dispatch_launches_no_kernel():
    from ieee80211_tpu_torch.ops.cuda import viterbi as kv
    before = kv.LAUNCHES
    rng = np.random.default_rng(1)
    bits, llr = encode_batch(rng, 2, 48, CR.CR12)
    w0, w1 = radix_tensors(4)
    got = coding.viterbi_decode(torch.from_numpy(llr), CR.CR12, 48, w0, w1)
    np.testing.assert_array_equal(got.numpy(), bits)
    assert kv.LAUNCHES == before
    with pytest.raises(ValueError):
        kv.viterbi_pairs_cuda(torch.zeros(2, 48, 2), w0, w1, 64)
    assert kv.LAUNCHES == before
