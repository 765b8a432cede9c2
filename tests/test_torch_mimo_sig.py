"""The dual-chain receiver's windowing and MRC SIG parse
(ieee80211_tpu_torch/rx/receiver.py: `capture_windows_mimo_plain`,
`sig_parse_mimo`, `sig_parse_mimo_capture`) against the JAX package's.

Windows are cut exactly. The SIG parse's ltf_start, flags and SIG bits must
be equal; its CFO and SNR are float32 results of sums taken in another
order, held to 1e-6 rad/sample and to `torch_parity.snr_tol_db` (5e-3 dB
at the SNRs of tests/test_torch_receiver_sig.py, more above them). As
there, the JAX SIG Viterbi decodes run at radix 3 on the CPU: with radix-3
tables every window must match, junk windows included; with the receiver's
radix-4 tables the windows that pass the SIG gates must match. Each capture carries white noise at 30 dB
below its signal: on a noiseless packet (the universal capture's NDP) the
decode of the other SIG format's tones, whose CRC fails in both packages,
sees LLRs of the size of float32 rounding, and its junk bits differ.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ieee80211_tpu.mac import aggregate_vht, build_udp_mpdu
from ieee80211_tpu.ops import sync as jsync
from ieee80211_tpu.rx import receiver as jrx
from ieee80211_tpu.rx.mimo import merge_triggers
from ieee80211_tpu.specs import BW, F, Mod
from ieee80211_tpu.tx import finalize, gen_ampdu, gen_mpdu
from ieee80211_tpu_torch.ops.cuda import gather as kg
from ieee80211_tpu_torch.rx import receiver as rx
from ieee80211_tpu_torch.utils import c2r
from test_dual_chain_universal import _mixed_capture
from test_wideband_mimo import CFG, CFG_QOS, _mix
from torch_parity import add_noise, radix_tensors, snr_tol_db

CFO_TOL = 1e-6     # rad/sample
FIELDS = ("ltf_start", "lsig_ok", "l_mcs", "l_len", "lsig_bits", "ht_ok",
          "vht_ok", "ht_bits", "vht_bits", "nl1_imag_dom")


def _two_chain(wave, h, rng, noise=1e-4):
    out = np.stack([h[0] * wave, h[1] * wave])
    out += (rng.standard_normal(out.shape)
            + 1j * rng.standard_normal(out.shape)) * noise
    return out


def _capture(q: int):
    """q = 1: the universal mixed capture (legacy, SISO HT/VHT, 2x2, NDP);
    q = 2: HT MCS12 2x2 and VHT MCS4 SISO at 40 MHz; q = 4: VHT MCS7 2x2
    and VHT MCS9 SISO at 80 MHz. [2, N] complex64, white noise at 30 dB."""
    if q == 1:
        return add_noise(_mixed_capture()[0], 30.0, seed=31)
    bw = {2: BW.BW40, 4: BW.BW80}[q]
    rng = np.random.default_rng(40 + q)
    mpdu = build_udp_mpdu(b"two chains " * 6, CFG_QOS)
    if q == 2:
        w22 = gen_mpdu(build_udp_mpdu(b"ht 2x2 " * 8, CFG),
                       Mod(F.HT, 12, bw, 2)).waveform
    else:
        w22 = gen_ampdu(aggregate_vht([mpdu]), Mod(F.VHT, 7, bw, 2)).waveform
    w1 = gen_ampdu(aggregate_vht([mpdu]), Mod(F.VHT, 4 if q == 2 else 9, bw,
                                              1)).waveform
    parts = [_mix(finalize(w22, multiplier=0.2, cfo_hz=-7000.0 * q, num=1,
                           gap=True, gap_len=400 * q), seed=q),
             _two_chain(finalize(w1, multiplier=0.2, cfo_hz=5000.0 * q,
                                 gap=True, gap_len=400 * q)[0],
                        np.array([0.9 - 0.3j, 0.5 + 0.8j]), rng)]
    return add_noise(np.concatenate(parts, axis=1), 30.0, seed=30 + q)


def _windows(cap, q: int, seed: int):
    """(capture [2, npad, 2] f32, t_clamp, delta, wlen) as the dual-chain
    receiver builds them, for the merged per-chain host triggers plus
    random junk starts."""
    t0s = merge_triggers([jsync.find_triggers_np(c, q=q,
                                                 min_gap=jrx.MIN_TRIGGER_GAP)
                          for c in cap], dedup_gap=200 * q)
    n = cap.shape[1]
    rng = np.random.default_rng(seed)
    wlen = (jrx.SIGPARSE_WIN + 320) * q
    t0s = np.concatenate([t0s, rng.integers(0, n - wlen, 5)])
    npad = jrx.next_pow2(n + 4096, lo=1 << 15)
    bpad = -(-len(t0s) // 32) * 32
    t_clamp = np.zeros(bpad, np.int32)
    delta = np.zeros(bpad, np.int32)
    tc = np.minimum(t0s, npad - wlen)
    t_clamp[:len(t0s)] = tc
    delta[:len(t0s)] = t0s - tc
    x = np.zeros((2, npad, 2), np.float32)
    x[:, :n] = c2r(cap)
    return x, t_clamp, delta, wlen


@pytest.fixture(scope="module", params=[1, 2, 4],
                ids=["20MHz", "40MHz", "80MHz"])
def parsed(request):
    """sig_parse_mimo of every window, in JAX and in the port at radix 3
    and 4."""
    q = request.param
    x, t_clamp, delta, wlen = _windows(_capture(q), q, seed=q)
    x2 = rx.capture_windows_mimo_plain(torch.from_numpy(x),
                                       torch.from_numpy(t_clamp), wlen)
    ref = jrx.sig_parse_mimo(jnp.asarray(x2.numpy()), jnp.asarray(delta),
                             q=q)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    tabs = rx.SigTables(q)
    r4 = rx.sig_parse_mimo(x2, torch.from_numpy(delta), tabs)
    tabs.vit_w0, tabs.vit_w1 = radix_tensors(3)
    r3 = rx.sig_parse_mimo(x2, torch.from_numpy(delta), tabs)
    return ref, ({k: v.numpy() for k, v in r3.items()},
                 {k: v.numpy() for k, v in r4.items()})


def _assert_meta(got, ref, rows):
    assert set(got) == set(ref)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k][rows], ref[k][rows], err_msg=k)
    np.testing.assert_allclose(got["cfo"][rows], ref["cfo"][rows], rtol=0,
                               atol=CFO_TOL)
    assert (np.abs(got["snr"][rows] - ref["snr"][rows])
            <= snr_tol_db(ref["snr"][rows])).all()


def test_sig_parse_mimo_radix3_equals_jax_on_every_window(parsed):
    ref, (r3, _) = parsed
    _assert_meta(r3, ref, slice(None))
    assert 0 < int(ref["lsig_ok"].sum()) < len(ref["lsig_ok"])


def test_sig_parse_mimo_radix4_equals_jax_past_the_sig_gates(parsed):
    ref, (_, r4) = parsed
    gate = ref["lsig_ok"].astype(bool) & (ref["snr"] > 0)
    assert gate.sum() >= 2
    _assert_meta(r4, ref, gate)


def test_sig_parse_mimo_finds_the_formats(parsed):
    """The windows that pass the gates carry the capture's formats: HT-SIG
    or VHT-SIG-A with a good CRC on each data packet."""
    ref, (_, r4) = parsed
    gate = ref["lsig_ok"].astype(bool) & (ref["snr"] > 0)
    assert (r4["ht_ok"][gate] | r4["vht_ok"][gate]).sum() >= 2


@pytest.fixture(scope="module")
def universal_windows():
    return _windows(_capture(1), 1, seed=9)


@pytest.mark.parametrize("ingest", ["f32", "int8"])
def test_sig_parse_mimo_capture_equals_jax(universal_windows, ingest):
    """The packed meta of an f32 upload, and of an int8 upload with one
    scale per chain (JAX dequantizes each window; the port dequantizes the
    upload once, with the same float32 product): words 0-6 equal, the CFO
    and SNR words within tolerance."""
    x, t_clamp, delta, wlen = universal_windows
    scale = np.ones((2, 1, 1), np.float32)
    cap = x
    if ingest == "int8":
        peak = np.abs(x).max(axis=(1, 2), keepdims=True)
        scale = (peak / 126.0).astype(np.float32)
        cap = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    ref = np.asarray(jrx.sig_parse_mimo_capture(
        jnp.asarray(cap), jnp.asarray(scale), jnp.asarray(t_clamp),
        jnp.asarray(delta), wlen=wlen, q=1))
    deq = torch.from_numpy(cap).to(torch.float32) * torch.from_numpy(scale)
    tabs = rx.SigTables(1)
    tabs.vit_w0, tabs.vit_w1 = radix_tensors(3)
    got = rx.sig_parse_mimo_capture(deq, torch.from_numpy(t_clamp),
                                    torch.from_numpy(delta), wlen,
                                    tabs).numpy()
    assert got.dtype == np.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got[:, :7], ref[:, :7])
    g = got[:, 7:].copy().view(np.float32)
    r = ref[:, 7:].copy().view(np.float32)
    np.testing.assert_allclose(g[:, 0], r[:, 0], rtol=0, atol=CFO_TOL)
    assert (np.abs(g[:, 1] - r[:, 1]) <= snr_tol_db(r[:, 1])).all()


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_capture_windows_mimo_plain_exact(dtype):
    rng = np.random.default_rng(17)
    n, length = 6000, 1072
    cap = (rng.standard_normal((2, n, 2)) * 40).astype(dtype)
    st = np.array([0, 23, n - length, n - length + 9, n - 1, 3100, 5],
                  np.int32)
    ref = np.asarray(jrx.capture_windows_mimo(jnp.asarray(cap),
                                              jnp.asarray(st), length))
    got = rx.capture_windows_mimo(torch.from_numpy(cap),
                                  torch.from_numpy(st), length)
    assert got.dtype == torch.from_numpy(cap).dtype
    assert tuple(got.shape) == (7, 2, length, 2)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_multi_chain_kernel_wrapper_rejects_cpu():
    before = kg.MULTI_LAUNCHES
    with pytest.raises(ValueError):
        kg.capture_slice_iq_mimo_cuda(torch.zeros(2, 100, 2),
                                      torch.zeros(3, dtype=torch.int32), 10)
    with pytest.raises(ValueError):
        kg.capture_slice_iq_mimo_cuda(torch.zeros(100, 2),
                                      torch.zeros(3, dtype=torch.int32), 10)
    assert kg.MULTI_LAUNCHES == before
