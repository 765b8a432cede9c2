"""Shared helpers of the tests that hold the PyTorch port
(`ieee80211_tpu_torch`) against the JAX package (tests/test_torch_*.py).
Not collected by pytest. Inputs are made with numpy and passed to both
packages as numpy arrays; JAX stays on the CPU (tests/conftest.py).
"""
import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from ieee80211_tpu.mac import deaggregate_vht
from ieee80211_tpu.specs import F
from ieee80211_tpu.specs.crc import fcs_ok
from ieee80211_tpu.tx.golden import bcc

# tier-1 runs several pytest workers on one host: keep each one's torch
# intra-op pool small
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def encode_batch(rng, batch: int, n_bits: int, cr, sigma: float = 0.2):
    """Random zero-terminated BCC streams -> (true bits, noisy LLRs)."""
    bits = rng.integers(0, 2, size=(batch, n_bits)).astype(np.int32)
    bits[:, -6:] = 0
    punct = np.stack([bcc(row, cr) for row in bits])
    llr = (punct * 2.0 - 1.0) + rng.normal(0, sigma, punct.shape)
    return bits, llr.astype(np.float32)


def port_mod(mod):
    """The port's Mod built from the JAX package's, field for field. The two
    packages' Mods are separate frozen dataclasses (a JAX Mod never equals a
    port Mod), so the port's code gets its own."""
    from ieee80211_tpu_torch import specs
    return specs.Mod(**{f.name: getattr(mod, f.name)
                        for f in dataclasses.fields(mod)})


def jax_mod(mod):
    """The JAX package's Mod built from the port's, field for field (the
    inverse of port_mod)."""
    from ieee80211_tpu import specs
    return specs.Mod(**{f.name: getattr(mod, f.name)
                        for f in dataclasses.fields(mod)})


def radix_tensors(k: int, device="cpu"):
    """The port's radix-2^k tables (w0, w1) as tensors."""
    from ieee80211_tpu_torch.ops.coding import _radix_tables
    w0, w1 = _radix_tables(k)
    return (torch.from_numpy(w0).to(device), torch.from_numpy(w1).to(device))


def mpdu_decoded(bits_row, psdu_len: int, mpdu: bytes, fmt) -> bool:
    """Descrambled DATA bits of one packet -> exact MPDU with a good FCS."""
    psdu = np.packbits(np.asarray(bits_row)[16:16 + psdu_len * 8]
                       .astype(np.uint8), bitorder="little").tobytes()
    if fmt == F.VHT:
        subs = deaggregate_vht(psdu)
        return bool(subs) and subs[0].fcs_ok and subs[0].mpdu == mpdu
    return fcs_ok(psdu) and psdu == mpdu


MAC = dict(addr1="f4:69:d5:80:0f:a0", addr2="00:c0:ca:b1:5b:e1",
           addr3="f4:69:d5:80:0f:a0")


def add_noise(cap, snr_db: float, seed: int):
    """White complex noise at snr_db below the capture's signal RMS."""
    rng = np.random.default_rng(seed)
    rms = np.sqrt(np.mean(np.abs(cap[cap != 0]) ** 2))
    sigma = rms / 10 ** (snr_db / 20) / np.sqrt(2)
    return (cap + rng.normal(0, sigma, cap.shape)
            + 1j * rng.normal(0, sigma, cap.shape)).astype(np.complex64)


def mixed_capture(seed: int, n: int = 6, snr_db: float = 30.0):
    """A short bench.py-style capture: HT MCS5 (non-aggregated)
    alternating with VHT MCS7 A-MPDUs, UDP payloads of 100-300 B, CFO
    uniform in +-50 kHz, gap 800, white noise at snr_db.
    Returns (capture complex64, mpdus)."""
    from ieee80211_tpu.mac import MacConfig, aggregate_vht, build_udp_mpdu
    from ieee80211_tpu.specs import Mod
    from ieee80211_tpu.tx import finalize, gen_ampdu, gen_mpdu
    rng = np.random.default_rng(seed)
    parts, mpdus = [], []
    for i in range(n):
        pl = bytes(rng.integers(0, 256, int(rng.integers(100, 300)),
                                dtype=np.uint8))
        if i % 2:
            mpdus.append(build_udp_mpdu(pl, MacConfig(subtype=8, seq=i,
                                                      **MAC)))
            wv = gen_ampdu(aggregate_vht([mpdus[-1]]), Mod(F.VHT, 7)).waveform
        else:
            mpdus.append(build_udp_mpdu(pl, MacConfig(seq=i, **MAC)))
            wv = gen_mpdu(mpdus[-1], Mod(F.HT, 5)).waveform
        parts.append(finalize(wv, multiplier=0.2, cfo_hz=float(
            rng.uniform(-5e4, 5e4)), gap=True, gap_len=800)[0])
    return add_noise(np.concatenate(parts), snr_db, seed + 1), mpdus


def snr_tol_db(snr_db):
    """Tolerance of the sync's SNR metric 10 log10(c / (1 - c)) between two
    float32 computations of the LTF correlation peak c: 64 float32 ulps of
    c, which moves the metric by 10 log10(e) * 64 * 2^-24 * (s + 2) dB with
    s = 10^(SNR / 10) (0.008 dB at 27 dB, 0.05 dB at 35 dB: near c = 1 the
    metric amplifies the rounding of c), and at least 5e-3 dB."""
    s = 10.0 ** (np.asarray(snr_db, np.float64) / 10.0)
    return np.maximum(5e-3, 10.0 * np.log10(np.e) * 64 * 2.0 ** -24
                      * (s + 2.0))


CFO_HZ_TOL = 1.0   # Hz: 1e-6 rad/sample x fs / 2pi is 13 Hz at 80 MHz
EVM_TOL = 1e-3     # dB


def assert_same_packets_all(got, ref):
    """Two receivers' PacketResult lists, packet for packet: format, MCS,
    PSDU, MPDUs, FCS, SIG-B flag, MU flag and the number of per-stream EVM
    SNRs exactly; CFO within CFO_HZ_TOL, SNR within snr_tol_db, the EVM SNR
    and each per-stream one within EVM_TOL."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert (g.fmt, g.mcs, g.psdu, g.mpdus, g.fcs_ok, g.sigb_ok, g.mu,
                len(g.sssnr)) == (r.fmt, r.mcs, r.psdu, r.mpdus, r.fcs_ok,
                                  r.sigb_ok, r.mu, len(r.sssnr))
        assert abs(g.cfo_hz - r.cfo_hz) <= CFO_HZ_TOL
        assert abs(g.snr_db - r.snr_db) <= snr_tol_db(r.snr_db)
        assert abs(g.evm_snr_db - r.evm_snr_db) <= EVM_TOL
        np.testing.assert_allclose(g.sssnr, r.sssnr, rtol=0, atol=EVM_TOL)


def radix3(module):
    """Hand every Viterbi decode inside `module` the radix-3 tables, with
    which the port's plain decoder reproduces the JAX CPU decoder."""
    w0, w1 = radix_tensors(3)
    for m in module.modules():
        if hasattr(m, "vit_w0"):
            m.vit_w0, m.vit_w1 = w0, w1
    return module


def packed_both(jstep, pipe, x2):
    """The PDR harness's packed-byte step (perf/acceptance.py
    `_packed_step`) of both packages on the same batch x2, each with its
    own noise scaled to 0: (JAX bytes, port bytes), uint8 [B, n_bits // 8].
    jstep is the JAX pipeline's step function, pipe the port's pipeline on
    the CPU."""
    import jax
    import jax.numpy as jnp
    from ieee80211_tpu.perf.acceptance import _packed_step as jax_packed
    from ieee80211_tpu_torch.perf.pdr import _packed_step, noise_generator
    b = x2.shape[0]
    ref = np.asarray(jax_packed(jstep)(jnp.asarray(x2),
                                       jnp.zeros(b, jnp.int32),
                                       jax.random.PRNGKey(0),
                                       jnp.float32(0.0)))
    got = _packed_step(pipe.step)(torch.from_numpy(x2),
                                  torch.zeros(b, dtype=torch.int32),
                                  noise_generator(0, torch.device("cpu")),
                                  0.0)
    return ref, got.numpy()


def assert_packed_parity(ref, got, ok_of, waterfall: bool, what: str):
    """Bytes equal (a high-SNR batch), or at a waterfall SNR ok-counts
    within 1 packet: LLRs differ by float32 rounding between the packages
    there, and a near-tie path can flip. ok_of(bytes) counts the rows that
    carry the MPDU."""
    assert ref.shape == got.shape and ref.dtype == got.dtype == np.uint8
    n_diff = int(np.sum(np.any(ref != got, axis=1)))
    ok_ref, ok_got = ok_of(ref), ok_of(got)
    print(f"{what}: {n_diff}/{len(ref)} rows differ; ok {ok_got} (port) "
          f"vs {ok_ref} (JAX)")
    if waterfall:
        assert 0 < ok_ref < len(ref), "SNR is not on the waterfall"
        assert abs(ok_got - ok_ref) <= 1
    else:
        np.testing.assert_array_equal(got, ref)
        assert ok_got > 0


# the sharded loops (tests/test_torch_sharded.py, test_torch_distributed.py):
# these outputs are held exact, these within a tolerance (float32 sums taken
# in another order; the port's long moving sums in float64)
LOOP_EXACT = {"bits", "trig_t", "ok", "fmt", "mcs", "nss", "n_sym",
              "psdu_len", "ampdu", "mu", "ndp", "overflow", "branch_overflow",
              "ltf_start", "lsig_ok", "n_ok", "mu_n_sym", "mu_nsts",
              "mu_sidx"}
LOOP_TOL = {"cfo": 1e-5,      # rad/sample
            "ndp_ltf": 1e-4,  # NDP LTF I/Q
            "ac": 1e-4,       # the frontend's autocorrelation
            "ac_peak": 1e-4}


def assert_same(ref: dict, got: dict) -> None:
    """A loop's output dict of the port (tensors or numpy) against the JAX
    package's, key for key: shape and dtype, LOOP_EXACT keys equal, the SNR
    within snr_tol_db, the others within LOOP_TOL."""
    assert set(got) == set(ref)
    for k, r in ref.items():
        r, g = np.asarray(r), np.asarray(got[k])
        assert g.shape == r.shape and g.dtype == r.dtype, (k, g.shape,
                                                           r.shape, g.dtype)
        if k in LOOP_EXACT:
            np.testing.assert_array_equal(g, r, err_msg=k)
        elif k == "snr":
            assert np.all(np.abs(g - r) <= snr_tol_db(r)), k
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=LOOP_TOL[k],
                                       err_msg=k)


# rank processes over gloo on localhost (tests/test_torch_distributed.py,
# test_torch_entry.py): one CPU rank each, started as torchrun starts them


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(n: int, argv):
    """n rank processes of `python argv` over gloo on localhost."""
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(n), RANK=str(rank), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(n))
        procs.append(subprocess.Popen(
            [sys.executable] + argv, cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def finish_ranks(procs, timeout: float):
    """Wait for every rank of a group, `timeout` s each; kill what is left
    on the way out. Every rank must exit 0. Returns their outputs."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
    return outs
