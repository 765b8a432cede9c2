"""The port's sync ops (ieee80211_tpu_torch/ops/sync.py) against the JAX
package: the window slice element-exact (against the JAX slice and the TPU
kernel's interpreted run), the sync front end at 20/40/80 MHz with
`ltf_start` exact, CFO within 1e-6 rad/sample and SNR within 1e-3 dB, and
the capture-level trigger scans.

Only valid starts (0 <= s <= N - L) are used: the JAX CPU and Pallas paths
clamp negative starts differently, and no caller passes one.

The device trigger scan's moving sums over a whole capture are cumsum
differences, accumulated in float32 by JAX and in float64 by the port, so
a sample at the edge of a plateau could cross the 0.5 threshold in one
package and not the other; the sync front end searches +-176 samples
around a trigger. On these captures the trigger positions are equal, and
they are within 4 samples of the host scan's.
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


def _capture(q: int, snr_db=None):
    """Three VHT MCS4 packets (20 MHz) or two VHT MCS9 80 MHz packets with
    CFO and gaps; white noise at snr_db when given."""
    cfg = MacConfig(subtype=8, addr1="f4:69:d5:80:0f:a0",
                    addr2="00:c0:ca:b1:5b:e1", addr3="f4:69:d5:80:0f:a0")
    bw = {1: BW.BW20, 4: BW.BW80}[q]
    parts = []
    for k in range(3 if q == 1 else 2):
        mpdu = build_udp_mpdu(bytes(range(100 + 50 * k)), cfg)
        wave = gen_ampdu(aggregate_vht([mpdu]), Mod(F.VHT, 4 if q == 1
                                                    else 9, bw, 1)).waveform
        parts.append(finalize(wave, 0.2, cfo_hz=3e3 * (k - 1) * q, gap=True,
                              gap_len=(700 + 31 * k) * q)[0])
    cap = np.ascontiguousarray(np.concatenate(parts), np.complex64)
    if snr_db is not None:
        rng = np.random.default_rng(q)
        rms = np.sqrt(np.mean(np.abs(cap[cap != 0]) ** 2))
        sigma = rms / 10 ** (snr_db / 20) / np.sqrt(2)
        cap = (cap + rng.normal(0, sigma, cap.shape)
               + 1j * rng.normal(0, sigma, cap.shape)).astype(np.complex64)
    npad = 1 << (len(cap) + 4096 - 1).bit_length()
    x = np.zeros((npad, 2), np.float32)
    x[:len(cap)] = c2r(cap)
    return cap, x


@pytest.mark.parametrize("q,snr_db", [(1, None), (1, 25.0), (4, 25.0)],
                         ids=["20MHz", "20MHz-noisy", "80MHz-noisy"])
def test_trigger_scan_capture_matches_jax(q, snr_db):
    from ieee80211_tpu.rx.receiver import MIN_TRIGGER_GAP
    cap, x = _capture(q, snr_db)
    kw = dict(k_max=16, q=q, min_gap=MIN_TRIGGER_GAP)
    j_t0, j_n = (np.asarray(v) for v in jsync.trigger_scan_capture(
        jnp.asarray(x), jnp.float32(1.0), **kw))
    t0, n = sync.trigger_scan_capture(torch.from_numpy(x), **kw)
    assert t0.dtype == torch.int32 and tuple(t0.shape) == (16,)
    assert int(n) == int(j_n) >= 2
    np.testing.assert_array_equal(t0.numpy()[int(n):], len(x))
    np.testing.assert_array_equal(t0.numpy(), j_t0)
    # and against the host scan of the same capture
    host = sync.find_triggers_np(cap, q=q, min_gap=MIN_TRIGGER_GAP)
    np.testing.assert_array_equal(host, jsync.find_triggers_np(
        cap, q=q, min_gap=MIN_TRIGGER_GAP))
    assert len(host) == int(n)
    assert np.all(np.abs(t0.numpy()[:int(n)] - host) <= 4)


def test_trigger_scan_capture_int8_and_capacity():
    """The JAX scan of the int8 upload and its scale equals the port's scan
    of the same upload dequantized; past k_max the count still grows."""
    from ieee80211_tpu.rx.receiver import MIN_TRIGGER_GAP
    _, x = _capture(1, 25.0)
    scale = np.float32(np.abs(x).max() / 126.0)
    x8 = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    kw = dict(k_max=2, min_gap=MIN_TRIGGER_GAP)
    j_t0, j_n = (np.asarray(v) for v in jsync.trigger_scan_capture(
        jnp.asarray(x8), jnp.asarray(scale), **kw))
    t0, n = sync.trigger_scan_capture(
        torch.from_numpy(x8.astype(np.float32) * scale), **kw)
    assert int(n) == int(j_n) == 3
    np.testing.assert_array_equal(t0.numpy(), j_t0)


def test_movsum_i32_exact():
    bits = np.random.default_rng(3).random(5000) < 0.4
    for w in (20, 600, 2400):
        np.testing.assert_array_equal(
            sync._movsum_i32(torch.from_numpy(bits), w).numpy(),
            np.asarray(jsync._movsum_i32(jnp.asarray(bits), w)))


@pytest.mark.parametrize("lag", [16, 64])
def test_stf_autocorr_close(lag):
    """The banded-matmul form (N <= 2048) within float32 rounding."""
    rng = np.random.default_rng(lag)
    x = (rng.standard_normal((2, 1500)) + 1j * rng.standard_normal(
        (2, 1500))).astype(np.complex64)
    x[:, 200:520] = np.tile(x[:, 200:200 + lag], (1, 320 // lag))
    ref = np.asarray(jsync.stf_autocorr(jnp.asarray(x), lag=lag, win=lag))
    got = sync.stf_autocorr(torch.from_numpy(x), lag=lag, win=lag).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert got.max() > 0.99


def test_apply_cfo_correction_close():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 4288)) + 1j * rng.standard_normal(
        (3, 4288))).astype(np.complex64)
    cfo = np.array([0.0, 2e-3, -3e-2], np.float32)
    ref = np.asarray(jsync.apply_cfo_correction(jnp.asarray(x),
                                                jnp.asarray(cfo)))
    got = sync.apply_cfo_correction(torch.from_numpy(x),
                                    torch.from_numpy(cfo)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
