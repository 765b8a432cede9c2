"""The port's sync ops (ieee80211_tpu_torch/ops/sync.py) against the JAX
package: the window slice element-exact (against the JAX slice and the TPU
kernel's interpreted run), and the sync front end at 20/40/80 MHz with
`ltf_start` exact, CFO within 1e-6 rad/sample and SNR within 1e-3 dB.

Only valid starts (0 <= s <= N - L) are used: the JAX CPU and Pallas paths
clamp negative starts differently, and no caller passes one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ieee80211_tpu.mac import MacConfig, aggregate_vht, build_udp_mpdu
from ieee80211_tpu.ops import sync as jsync
from ieee80211_tpu.ops.pallas.gather import batch_slice_iq_pallas
from ieee80211_tpu.specs import BW, F, Mod
from ieee80211_tpu.tx import finalize, gen_ampdu
from ieee80211_tpu_torch.ops import sync
from ieee80211_tpu_torch.utils import c2r
import torch_parity  # noqa: F401  (caps torch's threads)

CFO_TOL = 1e-6     # rad/sample: float32 rounding of the angle sums
SNR_TOL = 1e-3     # dB, at the 20 dB test SNR


@pytest.mark.parametrize("b,n,L", [
    (8, 500, 120), (32, 2320, 2080), (5, 300, 300), (16, 1096, 1096),
    (3, 129, 64)])   # the shapes of tests/test_pallas_gather.py
def test_batch_slice_iq_exact(b, n, L):
    rng = np.random.default_rng(b * 1000 + L)
    x2 = rng.standard_normal((b, n, 2)).astype(np.float32)
    st = rng.integers(0, n - L + 1, b).astype(np.int32)
    st[0] = n - L
    ref = np.asarray(jsync.batch_slice_iq(jnp.asarray(x2), jnp.asarray(st),
                                          L))
    tpu = np.asarray(batch_slice_iq_pallas(jnp.asarray(x2), jnp.asarray(st),
                                           L, interpret=True))
    got = sync.batch_slice_iq(torch.from_numpy(x2), torch.from_numpy(st), L)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), tpu)


def test_batch_slice_iq_clips_past_end():
    """Starts past N - L clip to N - L, as in both JAX paths."""
    rng = np.random.default_rng(0)
    x2 = rng.standard_normal((4, 700, 2)).astype(np.float32)
    st = np.array([0, 444, 445, 699], np.int32)
    ref = np.asarray(jsync.batch_slice_iq(jnp.asarray(x2), jnp.asarray(st),
                                          256))
    got = sync.batch_slice_iq_plain(torch.from_numpy(x2),
                                    torch.from_numpy(st), 256)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy()[3], x2[3, 444:])


def test_slice_kernel_wrapper_rejects_cpu():
    from ieee80211_tpu_torch.ops.cuda import gather as kg
    before = kg.LAUNCHES
    with pytest.raises(ValueError):
        kg.batch_slice_iq_cuda(torch.zeros(2, 10, 2),
                               torch.zeros(2, dtype=torch.int32), 4)
    assert kg.LAUNCHES == before


def test_cfo_ramp_close():
    cfo = np.array([0.0, 1e-3, -2.5e-2], np.float32)
    ref = np.asarray(jsync.cfo_ramp(jnp.asarray(cfo), 2080))
    got = sync.cfo_ramp(torch.from_numpy(cfo), 2080).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def _noisy_windows(bw: BW, batch: int, seed: int):
    """VHT MCS0 packets at 20 dB SNR with a per-row trigger offset."""
    q = {BW.BW20: 1, BW.BW40: 2, BW.BW80: 4}[bw]
    cfg = MacConfig(subtype=8, addr1="f4:69:d5:80:0f:a0",
                    addr2="00:c0:ca:b1:5b:e1", addr3="f4:69:d5:80:0f:a0")
    mpdu = build_udp_mpdu(b"sync parity " * 4, cfg)
    wave = finalize(gen_ampdu(aggregate_vht([mpdu]), Mod(F.VHT, 0, bw, 1))
                    .waveform, multiplier=0.2, cfo_hz=9000.0 * q,
                    gap=True, gap_len=64 * q)[0]
    rng = np.random.default_rng(seed)
    w = 1200 * q
    x = np.zeros((batch, w), np.complex64)
    for r in range(batch):
        seg = wave[(64 - 8 - 3 * r) * q:]
        x[r, :min(w, len(seg))] = seg[:min(w, len(seg))]
    rms = np.sqrt(np.mean(np.abs(wave[wave != 0]) ** 2))
    sigma = rms / 10 ** (20 / 20) / np.sqrt(2)
    x += (rng.normal(0, sigma, x.shape)
          + 1j * rng.normal(0, sigma, x.shape)).astype(np.complex64)
    return c2r(x), rng.integers(0, 3, batch).astype(np.int32), q


@pytest.mark.parametrize("bw", [BW.BW20, BW.BW40, BW.BW80],
                         ids=["20MHz", "40MHz", "80MHz"])
def test_sync_front_iq_matches_jax(bw):
    x2, t0, q = _noisy_windows(bw, 4, seed=40 + bw.value)
    ls_j, cfo_j, snr_j = (np.asarray(v) for v in jsync.sync_front_iq(
        jnp.asarray(x2), jnp.asarray(t0), q=q))
    band = torch.from_numpy(sync.ltf_band_mat(q))
    ls, cfo, snr = sync.sync_front_iq(torch.from_numpy(x2),
                                      torch.from_numpy(t0), band, q=q)
    assert ls.dtype == torch.int32 and cfo.dtype == torch.float32
    np.testing.assert_array_equal(ls.numpy(), ls_j)
    np.testing.assert_allclose(cfo.numpy(), cfo_j, rtol=0, atol=CFO_TOL)
    np.testing.assert_allclose(snr.numpy(), snr_j, rtol=0, atol=SNR_TOL)
