"""The streaming receiver's SIG parse (ieee80211_tpu_torch/rx/receiver.py)
against the JAX package's, word for word.

`sig_parse_capture` packs every field of a window into nine int32 words
(ltf_start, flags/l_mcs/l_len, L-SIG, HT-SIG and VHT-SIG-A bits, and the CFO
and SNR as float32 bits). Words 0-6 must be equal; the CFO and SNR words
are float32 results of sums taken in another order, held to 1e-6
rad/sample and 5e-3 dB.

The JAX SIG Viterbi decodes run at radix 3 on the CPU, the port's at radix
4. With radix-3 tables (which the port's decoder runs with the JAX CPU
decoder's renorm after every block) every window must match, junk windows
included: the re-trigger windows mid-packet, random starts and the batch's
padding rows. With the receiver's radix-4 tables the windows that pass the
SIG gates (L-SIG parity and SNR > 0 dB) must match; a junk window's
noise-like LLRs may decode differently at another radix.

Every window here holds signal or noise. A window of zeros only (past the
end of the zero-padded capture) gives 0/0 = NaN LLRs, and the two decoders
treat NaN differently: JAX's branch metrics are products with 0/1 weights,
so NaN reaches every path, while the port's are selects. Such a window's
SIG bits differ; its SNR is -60 dB, and the planner's SNR gate drops it in
both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ieee80211_tpu.mac import MacConfig, aggregate_vht, build_udp_mpdu
from ieee80211_tpu.ops import sync as jsync
from ieee80211_tpu.rx import receiver as jrx
from ieee80211_tpu.specs import BW, F, Mod
from ieee80211_tpu.specs.tables import crc8_bits
from ieee80211_tpu.tx import finalize, gen_ampdu, gen_mpdu
from ieee80211_tpu_torch.rx import receiver as rx
from ieee80211_tpu_torch.utils import c2r
from torch_parity import MAC, add_noise, mixed_capture, radix_tensors

CFO_TOL = 1e-6     # rad/sample
# dB: the SNR metric 10 log10(c / (1 - c)) of the LTF correlation peak c
# amplifies the rounding of c near 1: at the 27 dB of these captures one
# float32 ulp of c moves it by 1.3e-4 dB, and the 80 MHz sums are 4x longer
SNR_TOL = 5e-3


def _capture(q: int):
    """q = 1: the mixed HT/VHT capture plus an L MCS3 packet; q = 4: two
    VHT MCS9 80 MHz packets. White noise at 30 dB."""
    if q == 1:
        cap, _ = mixed_capture(seed=21, n=4)
        wv = gen_mpdu(build_udp_mpdu(b"legacy" * 20, MacConfig(**MAC)),
                      Mod(F.L, 3)).waveform
        tail = finalize(wv, multiplier=0.2, cfo_hz=-3e4, gap=True,
                        gap_len=800)[0]
        return add_noise(np.concatenate([cap, tail]), 30.0, 22)
    parts = [finalize(gen_ampdu(aggregate_vht([build_udp_mpdu(
        bytes([k]) * 300, MacConfig(subtype=8, **MAC))]),
        Mod(F.VHT, 9, BW.BW80, 1)).waveform, multiplier=0.18,
        cfo_hz=28000.0, gap=True, gap_len=1024)[0] for k in range(2)]
    return add_noise(np.concatenate(parts), 30.0, 23)


def _windows(cap, q: int, seed: int):
    """(capture [npad, 2] f32, t_clamp, delta, wlen) as
    SisoReceiver._dispatch_sigs builds them, for the host triggers plus
    random junk starts."""
    t0s = jsync.find_triggers_np(cap, q=q, min_gap=jrx.MIN_TRIGGER_GAP)
    rng = np.random.default_rng(seed)
    wlen = (jrx.SIGPARSE_WIN + 320) * q
    t0s = np.concatenate([t0s, rng.integers(0, len(cap) - wlen, 6)])
    npad = jrx.next_pow2(len(cap) + 4096, lo=1 << 15)
    bpad = -(-len(t0s) // 32) * 32
    t_clamp = np.zeros(bpad, np.int32)
    delta = np.zeros(bpad, np.int32)
    tc = np.minimum(t0s, npad - wlen)
    t_clamp[:len(t0s)] = tc
    delta[:len(t0s)] = t0s - tc
    x = np.zeros((npad, 2), np.float32)
    x[:len(cap)] = c2r(cap)
    return x, t_clamp, delta, wlen


@pytest.fixture(scope="module", params=[1, 4], ids=["20MHz", "80MHz"])
def parsed(request):
    q = request.param
    x, t_clamp, delta, wlen = _windows(_capture(q), q, seed=q)
    ref = np.asarray(jrx.sig_parse_capture(
        jnp.asarray(x), jnp.float32(1.0), jnp.asarray(t_clamp),
        jnp.asarray(delta), wlen=wlen, q=q))
    args = (torch.from_numpy(x), torch.from_numpy(t_clamp),
            torch.from_numpy(delta), wlen)
    tabs = rx.SigTables(q)
    r4 = rx.sig_parse_capture(*args, tabs).numpy()
    tabs.vit_w0, tabs.vit_w1 = radix_tensors(3)
    r3 = rx.sig_parse_capture(*args, tabs).numpy()
    return ref, r3, r4


def _assert_words(got, ref):
    assert got.dtype == np.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got[:, :7], ref[:, :7])
    g = got[:, 7:].copy().view(np.float32)
    r = ref[:, 7:].copy().view(np.float32)
    np.testing.assert_allclose(g[:, 0], r[:, 0], rtol=0, atol=CFO_TOL)
    np.testing.assert_allclose(g[:, 1], r[:, 1], rtol=0, atol=SNR_TOL)


def test_radix3_equals_jax_on_every_window(parsed):
    ref, r3, _ = parsed
    _assert_words(r3, ref)
    # the batch holds packets and junk windows alike
    meta = jrx._unpack_meta(ref)
    assert 0 < int(meta["lsig_ok"].sum()) < len(ref)


def test_radix4_equals_jax_past_the_sig_gates(parsed):
    ref, _, r4 = parsed
    meta = jrx._unpack_meta(ref)
    gate = (meta["lsig_ok"] == 1) & (meta["snr"] > 0)
    assert gate.sum() >= 2
    _assert_words(r4[gate], ref[gate])


def test_meta_unpacks_as_jax(parsed):
    ref, r3, _ = parsed
    got, want = rx._unpack_meta(r3), jrx._unpack_meta(ref)
    assert set(got) == set(want)
    for k in ("ltf_start", "lsig_ok", "l_mcs", "l_len", "lsig_bits",
              "ht_ok", "vht_ok", "ht_bits", "vht_bits", "nl1_imag_dom"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_capture_windows_exact(dtype):
    rng = np.random.default_rng(7)
    n, length = 5000, 1072
    cap = (rng.standard_normal((n, 2)) * 40).astype(dtype)
    st = np.array([0, 17, n - length, n - length + 5, n - 1, 2500],
                  np.int32)
    ref = np.asarray(jrx.capture_windows(jnp.asarray(cap), jnp.asarray(st),
                                         length))
    got = rx.capture_windows(torch.from_numpy(cap), torch.from_numpy(st),
                             length)
    assert got.dtype == torch.from_numpy(cap).dtype
    np.testing.assert_array_equal(got.numpy(), ref)


def test_capture_kernel_wrapper_rejects_cpu():
    from ieee80211_tpu_torch.ops.cuda import gather as kg
    before = kg.SHARED_LAUNCHES
    with pytest.raises(ValueError):
        kg.capture_slice_iq_cuda(torch.zeros(100, 2),
                                 torch.zeros(3, dtype=torch.int32), 10)
    assert kg.SHARED_LAUNCHES == before


@pytest.mark.parametrize("n", [1, 8, 13, 4680])
def test_pack_bits_le_is_packbits(n):
    bits = np.random.default_rng(n).integers(0, 2, (3, n)).astype(np.int32)
    got = rx.pack_bits_le(torch.from_numpy(bits))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(
        got.numpy(), np.packbits(bits.astype(np.uint8), axis=1,
                                 bitorder="little"))


def _random_meta(rng, b):
    return {
        "ltf_start": rng.integers(0, 3000, b).astype(np.int32),
        "lsig_ok": rng.integers(0, 2, b).astype(bool),
        "ht_ok": rng.integers(0, 2, b).astype(bool),
        "vht_ok": rng.integers(0, 2, b).astype(bool),
        "nl1_imag_dom": rng.integers(0, 2, b).astype(bool),
        "l_mcs": rng.integers(0, 8, b).astype(np.int32),
        "l_len": rng.integers(0, 4096, b).astype(np.int32),
        "lsig_bits": rng.integers(0, 2, (b, 24)).astype(np.int32),
        "ht_bits": rng.integers(0, 2, (b, 48)).astype(np.int32),
        "vht_bits": rng.integers(0, 2, (b, 48)).astype(np.int32),
        "cfo": rng.normal(0, 0.02, b).astype(np.float32),
        "snr": rng.normal(10, 20, b).astype(np.float32),
    }


def test_pack_meta_equals_jax_and_round_trips():
    meta = _random_meta(np.random.default_rng(5), 37)
    got = rx._pack_meta({k: torch.from_numpy(v) for k, v in meta.items()})
    ref = np.asarray(jrx._pack_meta({k: jnp.asarray(v)
                                     for k, v in meta.items()}))
    assert got.dtype == torch.int32 and tuple(got.shape) == (37, 9)
    np.testing.assert_array_equal(got.numpy(), ref)
    back = rx._unpack_meta(got.numpy())
    for k, v in meta.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def _with_crc(rng, b, n_pre):
    bits = rng.integers(0, 2, (b, 48)).astype(np.int32)
    for row in bits[: b // 2]:               # half of the rows carry a CRC
        row[n_pre:n_pre + 8] = crc8_bits(list(row[:n_pre]))
    return bits


def test_crc8_ok_exact():
    bits = _with_crc(np.random.default_rng(8), 40, 34)
    mat, const = (torch.from_numpy(a.astype(np.float32))
                  for a in rx._crc8_matrix())
    got = rx._crc8_ok(torch.from_numpy(bits), mat, const).numpy()
    np.testing.assert_array_equal(got, np.asarray(jrx._crc8_ok(
        jnp.asarray(bits))))
    assert got[:20].all()


@pytest.mark.parametrize("bw", [BW.BW20, BW.BW40, BW.BW80])
def test_sigb_service_crc_ok_exact(bw):
    n_pre = rx.SIGB_DIMS[bw][0]
    rng = np.random.default_rng(9 + bw.value)
    sigb = rng.integers(0, 2, (24, n_pre + 4)).astype(np.int32)
    scr = rng.integers(0, 2, (24, 64)).astype(np.int32)
    for a, s in zip(sigb[:12], scr[:12]):
        s[8:16] = crc8_bits(list(a[:n_pre]))
    mat, const = (torch.from_numpy(a.astype(np.float32))
                  for a in rx._crc8_matrix(n_pre))
    got = rx.sigb_service_crc_ok(torch.from_numpy(sigb),
                                 torch.from_numpy(scr), bw, mat,
                                 const).numpy()
    np.testing.assert_array_equal(got, np.asarray(jrx.sigb_service_crc_ok(
        jnp.asarray(sigb), jnp.asarray(scr), bw)))
    assert got[:12].all()
