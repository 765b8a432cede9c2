#!/usr/bin/env python3
"""Drive the PyTorch port's receive paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the exit code is non-zero:
  1. device check (exits 1 without CUDA) and the card's name / power limit;
  2. build of every CUDA kernel from ieee80211_tpu_torch/csrc/ with nvcc;
  3. the Viterbi kernel against its plain PyTorch version on the card, bit
     for bit, and against the encoder's input bits, at the shapes of the
     receive step and of the streaming receiver;
  4. the window-slice kernel against its plain version, element for element;
  5. + 6. `RxPipeline.step` at VHT MCS7 20 MHz (500 B, batch 1024) and VHT
     MCS9 80 MHz (1800 B, batch 256), the inputs of bench.py's two RX rows:
     every packet must decode to the exact MPDU with a good FCS, the first
     rows must equal the port's CPU run, and launch counters must show that
     each step went through both kernels;
  7. times at the main path's shapes: each kernel per wrapper call (CUDA
     events, median of 10 after warm-up) and on the device alone (10
     launches queued back to back behind a spin of the card), its plain
     version, the one torch.gather call that cuts the same windows (the
     Viterbi has no such PyTorch call), the least time of its work
     (bound_ms, from its bytes and operations), and the whole step with
     its kernels' device time (torch.profiler);
  8. the Viterbi floor probe (its own entry point, perf/vit_floor.py):
     kernel == plain at 1024 x 1176 blocks, timed beside the Viterbi kernel
     on the same input;
  9. the shared-source slice kernel against its plain version and
     torch.gather on a 4M-sample capture with 1024 starts, at the SIG and a
     DATA window length, timed;
 10. `SisoReceiver.decode_capture` on bench.py's 20-packet mixed HT/VHT
     capture: 20/20 exact MPDUs, equal to the port's CPU run;
 11. 80 MHz VHT and 40 MHz HT captures: every packet decodes;
 12. `SisoReceiver.decode_captures` on bench.py's stream (six ~4M-sample
     captures of 1000 packets, int8 ingest) with the host and the device
     trigger: 1000/1000 per capture, the device trigger's positions against
     the host's, launches of every kernel in every capture, samples/s and
     packets/s (best of 3) and the host's waits on the device per capture;
 13. the multi-chain slice kernel against its plain version and
     torch.gather on a [2, 4M] capture with 1024 starts, at the SIG window
     and a 2x2 DATA window, timed;
 14. `MimoReceiver.decode_capture_full` on the dual-chain universal capture
     (legacy, SISO HT/VHT by MRC, 2x2 VHT, a VHT NDP), with both chains live
     and with chain 0 dead: every packet decodes, one NDP with two chain
     captures, equal to the port's CPU run, launches of every kernel of the
     path;
 15. 2x2 at 40 MHz (HT MCS 8/12/15) and 80 MHz (VHT MCS 0/7/9, two encoder
     lanes at 7 and 9) through random mixing channels: every packet decodes;
 16. the cond-11 hard channel: ML decodes bit for bit where ZF fails, and
     detector="auto" recovers the packet that "zf" loses;
 17. `MimoReceiver.decode_captures` on bench.py's dual-chain stream (six
     ~4.03M-sample captures per chain of 1440 packets, VHT MCS7 SISO and VHT
     MCS4 2x2, int8 ingest) with the "auto", "zf" and "ml" detectors:
     1440/1440 per capture, launches of every kernel in every capture,
     samples/s and packets/s (best of 3), host waits and implicit syncs.
The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or of the JAX package
(the GPU machine has no JAX): only the port, torch and numpy.
"""
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from ieee80211_tpu_torch import native
from ieee80211_tpu_torch.mac import (MacConfig, aggregate_vht, build_udp_mpdu,
                                     deaggregate_vht)
from ieee80211_tpu_torch.models import RxPipeline
from ieee80211_tpu_torch.ops import coding, sync
from ieee80211_tpu_torch.ops.cuda import build
from ieee80211_tpu_torch.ops.cuda import gather as kg
from ieee80211_tpu_torch.ops.cuda import vit_floor as kf
from ieee80211_tpu_torch.ops.cuda import viterbi as kv
from ieee80211_tpu_torch.perf import vit_floor
from ieee80211_tpu_torch.perf.timing import cuda_ms, device_ms, kernels_ms
from ieee80211_tpu_torch.rx import (MimoDataDecoder, MimoReceiver,
                                    SisoReceiver, get_mimo_decoder, receiver)
from ieee80211_tpu_torch.specs import BW, CR, F, Mod
from ieee80211_tpu_torch.specs.modulation import (ppdu_params_aggregate,
                                                  ppdu_params_nonaggregate)
from ieee80211_tpu_torch.tx import finalize, gen_ampdu, gen_mpdu
from ieee80211_tpu_torch.tx.golden import bcc
from ieee80211_tpu_torch.utils import c2r

DEVICE = "cuda:0"
# the least time of a kernel's work (bound_ms), from the H100 SXM's published
# peaks: device memory 3.35 TB/s; float32 outside
# the tensor cores 67 TFLOP/s, an FMA counted as two, so 3.35e13 single
# lane operations (an add, a compare-select) per second
HBM_BYTES_PER_S = 3.35e12
LANE_OPS_PER_S = 67e12 / 2
VIT_OPS_PER_CANDIDATE = 2   # an add and a compare-select
# the card against the port's CPU run on the same rows: matmuls and
# reductions sum in another order there
CFO_TOL = 1e-5    # rad/sample
SNR_TOL = 1e-2    # dB
HEADLINE = dict(fmt="VHT", mcs=7, bw=20, payload=500, seed=0,
                cfo_hz=15000.0, batch=1024)
WIDEBAND = dict(fmt="VHT", mcs=9, bw=80, payload=1800, seed=1,
                cfo_hz=60000.0, batch=256)
# the streaming receiver on the card against its CPU run of the same capture
CFO_HZ_TOL = 1.0   # Hz: the sync's float32 CFO (1e-6 rad/sample) x fs / 2pi
EVM_TOL = 1e-2     # dB, on a copy with 30 dB SNR. A noiseless packet's EVM
EVM_FLOOR = 100.0  # SNR measures float32 rounding (~130 dB) and differs by
                   # dB between devices: there both must only exceed 100 dB
MAC = dict(addr1="f4:69:d5:80:0f:a0", addr2="00:c0:ca:b1:5b:e1",
           addr3="f4:69:d5:80:0f:a0")
N_API = 20                     # bench.py's decode_capture capture
N_COPY, N_STREAM = 50, 6       # bench.py's stream: 6 x 50 copies of it
N_MIMO_SEG, N_MIMO_REP = 12, 120   # bench.py's dual-chain stream: 6 x 120
                                   # copies of a 12-packet segment


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def bound(nbytes: float, ops: float):
    """The least time of a kernel's work on the card, in ms, and what sets
    it: its bytes (each input read once, each output written once) at the
    device memory's rate, or its operations at the float32 lane rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / LANE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gather_index(starts, n: int, length: int, shape):
    """The index of `torch.gather` that cuts the slice kernels' windows:
    start clipped to [0, n - length] as the kernels clip it, plus 0..length-1
    along the sample axis (the second to last of `shape`), as int64."""
    s = starts.long().clamp(0, n - length)
    pos = s[:, None] + torch.arange(length, device=starts.device)
    view = (len(s),) + (1,) * (len(shape) - 3) + (length, 1)
    return pos.view(view).expand(shape).contiguous()


def window_samples(starts, n: int, length: int) -> int:
    """How many samples of one chain the windows cover, each counted once."""
    s = np.sort(np.clip(starts.cpu().numpy().astype(np.int64), 0,
                        n - length))
    prev_end = np.concatenate([[0], s[:-1] + length])
    return int(np.sum(s + length - np.maximum(s, prev_end)))


def make_batch(fmt: str, mcs: int, bw: int, payload: int, seed: int,
               cfo_hz: float, batch: int, device=None):
    """bench.py's RX input without JAX: one UDP MPDU in a VHT A-MPDU from the
    golden TX, triggered 8 samples early, repeated over the batch.
    Returns (RxPipeline on `device`, x2 [B, W, 2] float32, t0 [B] int32,
    mpdu)."""
    q = bw // 20
    cfg = MacConfig(subtype=8, addr1="f4:69:d5:80:0f:a0",
                    addr2="00:c0:ca:b1:5b:e1", addr3="f4:69:d5:80:0f:a0",
                    seq=2704)
    body = bytes(np.random.default_rng(seed).integers(0, 256, payload,
                                                      dtype=np.uint8))
    mpdu = build_udp_mpdu(body, cfg)
    ampdu = aggregate_vht([mpdu])
    mod = Mod(F[fmt], mcs, {20: BW.BW20, 40: BW.BW40, 80: BW.BW80}[bw], 1)
    pp = ppdu_params_aggregate(mod, len(ampdu))
    wave = finalize(gen_ampdu(ampdu, mod).waveform, multiplier=0.2,
                    cfo_hz=cfo_hz, gap=True, gap_len=64 * q)[0]
    pipe = RxPipeline(mod, pp.n_sym, pp.psdu_len, device=device)
    w = pipe.window_len()
    seg = wave[(64 - 8) * q:]
    x = np.zeros((batch, w), dtype=np.complex64)
    x[:, :min(w, len(seg))] = seg[:min(w, len(seg))]
    return pipe, c2r(x), np.zeros(batch, dtype=np.int32), mpdu


def api_capture():
    """bench.py's 20-packet capture (bench.py:362-381): seed 3, HT MCS5
    non-aggregated alternating with VHT MCS7 A-MPDU, UDP payloads of
    100-900 B, CFO uniform in +-50 kHz, gap 800. Returns (capture, mpdus)."""
    cfg = MacConfig(subtype=8, seq=2704, **MAC)
    rng = np.random.default_rng(3)
    parts, mpdus = [], []
    for i in range(N_API):
        pl = bytes(rng.integers(0, 256, int(rng.integers(100, 900)),
                                dtype=np.uint8))
        if i % 2:
            mpdus.append(build_udp_mpdu(pl, cfg))
            wv = gen_ampdu(aggregate_vht([mpdus[-1]]), Mod(F.VHT, 7)).waveform
        else:
            mpdus.append(build_udp_mpdu(pl, MacConfig(**MAC)))
            wv = gen_mpdu(mpdus[-1], Mod(F.HT, 5)).waveform
        parts.append(finalize(wv, multiplier=0.2, cfo_hz=float(
            rng.uniform(-5e4, 5e4)), gap=True, gap_len=800)[0])
    return np.concatenate(parts), mpdus


def stream_captures(cap):
    """bench.py's stream (bench.py:406-416): six captures, each 50 copies
    of `cap` with zero gaps U[16, 512) (seed 7) and 64 + 32k leading
    zeros."""
    rng = np.random.default_rng(7)
    parts = []
    for _ in range(N_COPY):
        parts.append(np.zeros(int(rng.integers(16, 512)), np.complex64))
        parts.append(cap)
    big = np.concatenate(parts)
    return [np.concatenate([np.zeros(64 + 32 * k, np.complex64), big])
            for k in range(N_STREAM)]


def wideband_capture(bw: int):
    """Four packets at 40 MHz (HT MCS 1, 3, 5, 7) or 80 MHz (VHT MCS9
    A-MPDUs) with CFO 7 kHz x q, as tests/test_wideband_rx.py builds them.
    Returns (capture, mpdus)."""
    q = bw // 20
    parts, mpdus = [], []
    for k in range(4):
        mpdus.append(build_udp_mpdu(bytes([k]) * (200 + 150 * k),
                                    MacConfig(seq=k, **MAC)))
        if bw == 80:
            wv = gen_ampdu(aggregate_vht([mpdus[-1]]),
                           Mod(F.VHT, 9, BW.BW80, 1)).waveform
        else:
            wv = gen_mpdu(mpdus[-1], Mod(F.HT, 2 * k + 1, BW.BW40,
                                         1)).waveform
        parts.append(finalize(wv, multiplier=0.18, cfo_hz=7000.0 * q,
                              gap=True, gap_len=256 * q)[0])
    return np.concatenate(parts), mpdus


def add_noise(cap, snr_db: float, seed: int):
    rng = np.random.default_rng(seed)
    rms = np.sqrt(np.mean(np.abs(cap[cap != 0]) ** 2))
    sigma = rms / 10 ** (snr_db / 20) / np.sqrt(2)
    return (cap + rng.normal(0, sigma, cap.shape)
            + 1j * rng.normal(0, sigma, cap.shape)).astype(np.complex64)


def check_same_packets(got, ref, what: str, evm_tol=None) -> str:
    """The card's PacketResults against the CPU run's: format, MCS, PSDU,
    MPDUs, FCS and SIG-B flags exactly; CFO, SNR and EVM SNR within the
    stated tolerances. Returns a summary of the largest differences."""
    check(len(got) == len(ref), f"{what}: {len(got)} packets vs {len(ref)} "
                                f"on the CPU")
    d_cfo = d_snr = d_evm = 0.0
    for a, b in zip(got, ref):
        check((a.fmt, a.mcs, a.psdu, a.mpdus, a.fcs_ok, a.sigb_ok)
              == (b.fmt, b.mcs, b.psdu, b.mpdus, b.fcs_ok, b.sigb_ok),
              f"{what}: packet fields == CPU run")
        d_cfo = max(d_cfo, abs(a.cfo_hz - b.cfo_hz))
        d_snr = max(d_snr, abs(a.snr_db - b.snr_db))
        d_evm = max(d_evm, abs(a.evm_snr_db - b.evm_snr_db))
        if evm_tol is None:
            check(min(a.evm_snr_db, b.evm_snr_db) > EVM_FLOOR,
                  f"{what}: noiseless EVM SNR above {EVM_FLOOR} dB")
        check(len(a.sssnr) == len(b.sssnr), f"{what}: per-stream EVM count")
        if evm_tol is not None:
            d_evm = max([d_evm] + [abs(x - y)
                                   for x, y in zip(a.sssnr, b.sssnr)])
    check(d_cfo <= CFO_HZ_TOL and d_snr <= SNR_TOL
          and (evm_tol is None or d_evm <= evm_tol),
          f"{what}: cfo/snr/evm vs CPU run")
    return (f"|dcfo| {d_cfo:.4g} Hz, |dsnr| {d_snr:.4g} dB, |devm| "
            f"{d_evm:.4g} dB")


MIMO_MAC = dict(ftype=2, to_ds=1, from_ds=0, retry=0, protected=0, seq=2704,
                **MAC)


def universal_capture(dead_chain0: bool):
    """tests/test_dual_chain_universal.py's `_mixed_capture` (seed 11):
    L MCS3, HT MCS5 and VHT MCS7 on flat per-chain channels, a 2x2 VHT MCS4
    A-MPDU and a 2-stream VHT NDP through one 2x2 channel, gaps of 900;
    noise 2e-4, or 1e-4 with chain 0 faded to 1e-3. Returns (capture
    [2, N], {(fmt, mcs): mpdu})."""
    noise = 1e-4 if dead_chain0 else 2e-4
    rng = np.random.default_rng(11)
    cfg, cfg_qos = MacConfig(subtype=0, **MIMO_MAC), MacConfig(subtype=8,
                                                               **MIMO_MAC)
    mpdu_l = build_udp_mpdu(b"legacy-payload-0123456789", cfg)
    mpdu_ht = build_udp_mpdu(b"ht-siso-payload-xyz", cfg)
    mpdu_vht = build_udp_mpdu(b"vht-siso-payload-abcdef", cfg_qos)
    mpdu_2x2 = build_udp_mpdu(b"two-stream-payload-2x2!!", cfg_qos)
    w_l = finalize(gen_mpdu(mpdu_l, Mod(F.L, 3)).waveform, multiplier=0.2,
                   cfo_hz=11000.0, gap=False)[0]
    w_ht = finalize(gen_mpdu(mpdu_ht, Mod(F.HT, 5)).waveform,
                    multiplier=0.2, cfo_hz=-8000.0, gap=False)[0]
    w_vht = finalize(gen_ampdu(aggregate_vht([mpdu_vht]),
                               Mod(F.VHT, 7)).waveform,
                     multiplier=0.2, cfo_hz=5000.0, gap=False)[0]
    w_22 = finalize(gen_ampdu(aggregate_vht([mpdu_2x2]),
                              Mod(F.VHT, 4, BW.BW20, 2)).waveform,
                    multiplier=0.2, cfo_hz=-3000.0, gap=False)
    w_ndp = finalize(gen_ampdu(b"", Mod(F.VHT, 0, BW.BW20, 2)).waveform,
                     multiplier=0.2, cfo_hz=2000.0, gap=False)
    h0 = 1e-3 if dead_chain0 else (0.9 - 0.3j)
    gap = np.zeros((2, 900), np.complex64)
    parts = []
    for w in (w_l, w_ht, w_vht):
        two = np.stack([h0 * w, (0.5 + 0.8j) * w])
        two += (rng.standard_normal(two.shape)
                + 1j * rng.standard_normal(two.shape)) * noise
        parts += [gap, two.astype(np.complex64)]
    h22 = np.array([[1.1 + 0.2j, 0.3 - 0.5j], [-0.4 + 0.6j, 0.9 + 0.1j]])
    mixed = (h22 @ w_22).astype(np.complex64)
    mixed += (rng.standard_normal(mixed.shape)
              + 1j * rng.standard_normal(mixed.shape)).astype(
                  np.complex64) * 2e-4
    parts += [gap, mixed, gap, (h22 @ w_ndp).astype(np.complex64), gap]
    want = {(F.L, 3): mpdu_l, (F.HT, 5): mpdu_ht, (F.VHT, 7): mpdu_vht,
            (F.VHT, 4): mpdu_2x2}
    return np.concatenate(parts, axis=1), want


def mix_2x2(wave, seed: int, namp: float):
    """tests/test_wideband_mimo.py's `_mix`: a random 2x2 channel (+2.5 I)
    and white noise of amplitude namp."""
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
         + 2.5 * np.eye(2))
    out = h @ wave
    out += (rng.standard_normal(out.shape)
            + 1j * rng.standard_normal(out.shape)) * namp
    return out.astype(np.complex64)


def wideband_mimo_captures():
    """tests/test_wideband_mimo.py's 2x2 cases at 40 MHz (HT MCS 8/12/15)
    and 80 MHz (VHT MCS 0/7/9), one capture each: [(bw, fmt, mcs, capture,
    mpdu)]."""
    payload = b"wideband 2x2 MIMO beyond the reference envelope!"
    out = []
    for mcs in (8, 12, 15):
        mpdu = build_udp_mpdu(payload, MacConfig(seq=2704, **MAC))
        cap = finalize(gen_mpdu(mpdu, Mod(F.HT, mcs, BW.BW40, 2)).waveform,
                       multiplier=0.2, cfo_hz=18000.0, num=1, gap=True,
                       gap_len=800)
        out.append((40, F.HT, mcs, mix_2x2(cap, mcs, 1e-5), mpdu))
    for mcs in (0, 7, 9):
        mpdu = build_udp_mpdu(payload, MacConfig(subtype=8, seq=2704, **MAC))
        cap = finalize(gen_ampdu(aggregate_vht([mpdu]),
                                 Mod(F.VHT, mcs, BW.BW80, 2)).waveform,
                       multiplier=0.2, cfo_hz=-28000.0, num=1, gap=True,
                       gap_len=1600)
        out.append((80, F.VHT, mcs, mix_2x2(cap, 10 * mcs + 4, 1e-5), mpdu))
    return out


def hard_channel():
    """tests/test_wideband_mimo.py's hard channel: HT MCS15 40 MHz through
    seed 15's cond-11 2x2 channel, noise 4e-5 (seed 7777). Returns
    (capture [2, N], windows [1, 2, W, 2] float32 from the first trigger,
    mod, n_sym, expected bits, mpdu)."""
    mpdu = build_udp_mpdu(b"wideband 2x2 MIMO beyond the reference envelope!"
                          * 4, MacConfig(seq=2704, **MAC))
    exp = np.concatenate([np.zeros(16, np.uint8), np.unpackbits(
        np.frombuffer(mpdu, np.uint8), bitorder="little")])
    mod = Mod(F.HT, 15, BW.BW40, 2)
    pp = ppdu_params_nonaggregate(mod, len(mpdu))
    mrng = np.random.default_rng(15)
    hm = (mrng.standard_normal((2, 2))
          + 1j * mrng.standard_normal((2, 2))) + 2.5 * np.eye(2)
    cap = hm @ finalize(gen_mpdu(mpdu, mod).waveform, multiplier=0.2,
                        cfo_hz=18000.0, num=1, gap=True, gap_len=800)
    nrng = np.random.default_rng(7777)
    cap = (cap + (nrng.standard_normal(cap.shape)
                  + 1j * nrng.standard_normal(cap.shape)) * 4e-5).astype(
                      np.complex64)
    t = int(sync.find_triggers_np(cap[0], q=2)[0])
    need = 500 + (448 + 160 + 160 + pp.n_sym * 80) * 2 + 100
    w = np.zeros((1, 2, need, 2), np.float32)
    seg = cap[:, t:t + need]
    w[0, :, :seg.shape[1], 0] = seg.real
    w[0, :, :seg.shape[1], 1] = seg.imag
    return cap, w, mod, pp.n_sym, exp, mpdu


def mimo_stream_captures(reps: int = N_MIMO_REP):
    """bench.py's dual-chain stream (bench.py:460-490): a segment of 12
    packets with UDP payloads of 100-700 B (seed 15), VHT MCS7 SISO on the
    flat channel h1 alternating with VHT MCS4 2x2 A-MPDUs through h22, CFO
    uniform in +-40 kHz, 800 zeros before each; six captures of `reps`
    copies with 64 + 32k leading zeros. Returns (captures, packets per
    capture)."""
    cfg = MacConfig(subtype=8, seq=2704, **MAC)
    h1 = np.array([0.9 - 0.3j, 0.5 + 0.8j])
    h22 = np.array([[1.1 + 0.2j, 0.3 - 0.5j], [-0.4 + 0.6j, 0.9 + 0.1j]])
    rng = np.random.default_rng(15)
    parts = []
    for i in range(N_MIMO_SEG):
        pl = bytes(rng.integers(0, 256, int(rng.integers(100, 700)),
                                dtype=np.uint8))
        mp = build_udp_mpdu(pl, cfg)
        if i % 2:
            wv = finalize(gen_ampdu(aggregate_vht([mp]),
                                    Mod(F.VHT, 4, BW.BW20, 2)).waveform,
                          multiplier=0.2, cfo_hz=float(
                              rng.uniform(-4e4, 4e4)), gap=False)
            w2 = h22 @ wv
        else:
            wv = finalize(gen_ampdu(aggregate_vht([mp]),
                                    Mod(F.VHT, 7)).waveform, multiplier=0.2,
                          cfo_hz=float(rng.uniform(-4e4, 4e4)),
                          gap=False)[0]
            w2 = np.stack([h1[0] * wv, h1[1] * wv])
        parts.append(np.zeros((2, 800), np.complex64))
        parts.append(w2.astype(np.complex64))
    big = np.concatenate([np.concatenate(parts, axis=1)] * reps, axis=1)
    return ([np.concatenate([np.zeros((2, 64 + 32 * k), np.complex64), big],
                            axis=1) for k in range(N_STREAM)],
            N_MIMO_SEG * reps)


def stream_pass(srx, caps, want: int, what: str):
    """One pass of `srx.decode_captures(caps)` under the sync debug mode:
    every capture must return `want` packets with a good FCS. Returns (host
    waits per capture, implicit syncs)."""
    waits = srx.n_waits
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            stream = srx.decode_captures(caps)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode's own notice on enabling is a warning too: count only the
    # ops it flags
    implicit = sum("synchroniz" in str(w.message)
                   and "prototype" not in str(w.message) for w in caught)
    for res in stream:
        n_ok = sum(r.fcs_ok for r in res)
        check(n_ok == want == len(res), f"{what}: {n_ok}/{want} packets")
    return (srx.n_waits - waits) / len(caps), implicit


def best_of_3(srx, caps):
    """Host clock around three passes, each ending in a synchronize.
    Returns (best s, all runs, packets of the last pass)."""
    dts = []
    for _ in range(3):
        t = time.perf_counter()
        stream = srx.decode_captures(caps)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t)
    return min(dts), dts, sum(len(r) for r in stream)


def main() -> int:
    # -- 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    dev = torch.device(DEVICE)

    # -- 2. build ------------------------------------------------------------
    t = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t:.2f} s (nvcc, every kernel)")
    print(build.build_log.strip())

    w0, w1 = (torch.from_numpy(a).to(dev)
              for a in coding._radix_tables(coding.RADIX))

    # -- 3. Viterbi kernel vs plain ------------------------------------------
    vit_err = 0
    vit_inputs = {}
    for name, batch, n_bits, cr, seed in [
            ("smoke", 256, 360, CR.CR34, 3),       # tests/test_tpu_smoke.py
            ("lsig", 1024, 24, CR.CR12, 4),        # L-SIG decode
            ("data", 1024, 4680, CR.CR56, 5),      # headline DATA decode
            ("data80", 256, 15600, CR.CR56, 6),    # 80 MHz MCS9 DATA decode
            # the streaming receiver's calls: HT-SIG / VHT-SIG-A of a SIG
            # batch, SIG-B at 20 and 80 MHz in small groups (batches that
            # are not multiples of the kernel's 4 packets per block), and
            # DATA buckets (VHT MCS7 x 48 symbols, HT MCS5 x 32)
            ("sig48", 1056, 48, CR.CR12, 7),
            ("sigb26", 1, 26, CR.CR12, 8),
            ("sigb117", 2, 117, CR.CR12, 10),
            ("bucket_vht7", 256, 12480, CR.CR56, 11),
            ("bucket_ht5", 2, 6656, CR.CR23, 12),
            # the dual-chain receiver's: the 2x2 VHT MCS4 group of bench.py's
            # stream (720 packets padded to 768, bucket 16), the two encoder
            # lanes of 4 VHT MCS9 80 MHz 2x2 packets as 8 rows, HT MCS15
            # 40 MHz
            ("mimo_vht4", 768, 4992, CR.CR34, 13),
            ("lanes_vht9_80", 8, 24960, CR.CR56, 14),
            ("mimo_ht15_40", 4, 17280, CR.CR56, 15)]:
        rng = np.random.default_rng(seed)
        bits = rng.integers(0, 2, size=(batch, n_bits)).astype(np.int32)
        bits[:, -6:] = 0
        punct = np.stack([bcc(row, cr) for row in bits])
        llr = ((punct * 2.0 - 1.0)
               + rng.normal(0, 0.2, punct.shape)).astype(np.float32)
        x = torch.from_numpy(llr).to(dev)
        got = coding.viterbi_decode(x, cr, n_bits, w0, w1)
        ref = coding.viterbi_decode_plain(x, cr, n_bits, w0, w1)
        torch.cuda.synchronize()
        err = int((got - ref).abs().max())
        vit_err = max(vit_err, err)
        check(torch.equal(got, ref), f"viterbi kernel == plain ({name})")
        check(np.array_equal(got.cpu().numpy(), bits),
              f"viterbi kernel == encoder bits ({name})")
        print(f"viterbi {name} [{batch} x {n_bits} {cr.name}]: kernel == "
              f"plain == encoder bits")
        vit_inputs[name] = (x, cr, n_bits)

    # -- 4. slice kernel vs plain --------------------------------------------
    slice_err = 0.0
    rng = np.random.default_rng(9)
    for b, n, length in [(66, 2321, 2080), (1024, 2320, 448),
                         (1024, 2320, 2080)]:
        x2 = torch.from_numpy(rng.standard_normal((b, n, 2))
                              .astype(np.float32)).to(dev)
        st = np.concatenate([[0, n - length],
                             rng.integers(0, n - length + 1, b - 2)])
        st = torch.from_numpy(st.astype(np.int32)).to(dev)
        got = sync.batch_slice_iq(x2, st, length)
        ref = sync.batch_slice_iq_plain(x2, st, length)
        torch.cuda.synchronize()
        slice_err = max(slice_err, float((got - ref).abs().max()))
        check(torch.equal(got, ref), f"slice kernel == plain ({b}, {n}, "
                                     f"{length})")
        print(f"slice [{b} x {n} -> {length}]: kernel == plain")

    # -- 5./6. the main path -------------------------------------------------
    rows = {}
    for cell in (HEADLINE, WIDEBAND):
        pipe, x2, t0, mpdu = make_batch(**cell, device=dev)
        rows[cell["bw"]] = (cell, pipe, x2, t0, mpdu)
    kv.LAUNCHES = 0
    kg.LAUNCHES = 0
    outs = {}
    per_step = {}
    with torch.inference_mode():
        for bw, (cell, pipe, x2, t0, _) in rows.items():
            before = (kv.LAUNCHES, kg.LAUNCHES)
            outs[bw] = pipe.step(torch.from_numpy(x2).to(dev),
                                 torch.from_numpy(t0).to(dev))
            torch.cuda.synchronize()
            per_step[bw] = (kv.LAUNCHES - before[0], kg.LAUNCHES - before[1])
    launches = {"viterbi": kv.LAUNCHES, "slice": kg.LAUNCHES,
                "slice_shared": 0, "slice_multi": 0, "vit_floor": 0}
    for bw, (vit, sli) in per_step.items():
        print(f"launches in the {bw} MHz step: viterbi {vit}, slice {sli}")
        check((vit, sli) == (2, 2), f"{bw} MHz step launched 2 + 2 kernels")

    for bw, (cell, pipe, x2, t0, mpdu) in rows.items():
        out = {k: v.cpu() for k, v in outs[bw].items()}
        b = cell["batch"]
        n_bits = pipe.n_sym * pipe.mod.nDBPS
        check(tuple(out["bits"].shape) == (b, n_bits)
              and out["bits"].dtype == torch.int32, f"{bw} MHz bits shape")
        check(bool(torch.isfinite(out["cfo"]).all()
                   and torch.isfinite(out["snr"]).all()),
              f"{bw} MHz cfo/snr finite")
        check(bool(out["lsig_ok"].all()), f"{bw} MHz lsig_ok on every row")
        bits = out["bits"].numpy().astype(np.uint8)
        n_ok = 0
        for row in bits:
            psdu = np.packbits(row[16:16 + pipe.psdu_len * 8],
                               bitorder="little").tobytes()
            subs = deaggregate_vht(psdu)
            n_ok += bool(subs and subs[0].fcs_ok and subs[0].mpdu == mpdu)
        print(f"{bw} MHz VHT MCS{cell['mcs']} {cell['payload']} B: {n_ok}/{b}"
              f" packets decode to the exact MPDU with a good FCS")
        check(n_ok == b, f"{bw} MHz every packet decodes")
        # the same first rows through the port's plain CPU path
        cpu_pipe = RxPipeline(pipe.mod, pipe.n_sym, pipe.psdu_len,
                              device="cpu")
        ref = cpu_pipe.step(torch.from_numpy(x2[:4]), torch.from_numpy(t0[:4]))
        for key in ("bits", "ltf_start", "lsig_ok"):
            check(torch.equal(out[key][:4], ref[key]), f"{bw} MHz {key} "
                                                       f"== CPU run")
        cfo_d = float((out["cfo"][:4] - ref["cfo"]).abs().max())
        snr_d = float((out["snr"][:4] - ref["snr"]).abs().max())
        print(f"{bw} MHz vs CPU run: bits/ltf_start/lsig_ok equal, "
              f"|dcfo| {cfo_d:.3g} rad/sample, |dsnr| {snr_d:.3g} dB")
        check(cfo_d <= CFO_TOL and snr_d <= SNR_TOL,
              f"{bw} MHz cfo/snr vs CPU")

    # -- 7. times ------------------------------------------------------------
    # "ms" and "plain_ms" are one wrapper call each between two CUDA events,
    # the host's launch cost inside; "device_ms" is the kernel's own time,
    # back-to-back launches queued behind a spin of the card; "library_ms"
    # is one call of the PyTorch function that computes the same result,
    # between two CUDA events (its own device time beside it); "bound_ms"
    # is the least time of the work.
    tag = f"({card})"
    times = {}

    def time_pair(key, shape, kernel, plain, nbytes, ops=0.0, library=None):
        t = {"ms": cuda_ms(kernel), "device_ms": device_ms(kernel),
             "plain_ms": cuda_ms(plain), "library_ms": None}
        t["bound_ms"], t["bound_by"] = bound(nbytes, ops)
        lib = ""
        if library is not None:
            t["library_ms"] = cuda_ms(library)
            t["library_device_ms"] = device_ms(library)
            lib = (f", library {t['library_ms']:.4f} ms (device "
                   f"{t['library_device_ms']:.4f} ms)")
        times[key] = t
        print(f"time {key} {shape}: kernel {t['ms']:.4f} ms (device "
              f"{t['device_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms{lib}, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}) {tag}")

    for name in ("data", "lsig", "data80", "mimo_vht4", "bucket_vht7"):
        x, cr, n_bits = vit_inputs[name]
        lp = coding._pairs(x, cr, n_bits, coding.RADIX)
        b, t_pad, _ = lp.shape
        time_pair(f"viterbi_{name}", f"[{b} x {n_bits} {cr.name}]",
                  lambda: kv.viterbi_pairs_cuda(lp, w0, w1, coding.RENORM),
                  lambda: coding.viterbi_pairs_plain(lp, w0, w1,
                                                     coding.RENORM),
                  nbytes=lp.nbytes + b * t_pad * 4 + w0.nbytes + w1.nbytes,
                  ops=VIT_OPS_PER_CANDIDATE * b * (t_pad // kv.K) * 64 * 16)
    for bw, (cell, pipe, x2, t0, _) in rows.items():
        xd = torch.from_numpy(x2).to(dev)
        td = torch.from_numpy(t0).to(dev)
        b, n = xd.shape[:2]
        q = pipe.step.q
        sync_len = (80 + sync.N_LAG + 3 * sync.LTF_PERIOD) * q
        for what, length, starts in (
                ("sync", sync_len, td),
                ("z", pipe.step.z_len(), outs[bw]["ltf_start"] - 16 * q)):
            idx = gather_index(starts, n, length, (b, length, 2))
            check(torch.equal(torch.gather(xd, 1, idx),
                              kg.batch_slice_iq_cuda(xd, starts, length)),
                  f"torch.gather == slice kernel ({what}, {bw} MHz)")
            time_pair(f"slice_{what}_{bw}", f"[{b} x {n} -> {length}]",
                      lambda: kg.batch_slice_iq_cuda(xd, starts, length),
                      lambda: sync.batch_slice_iq_plain(xd, starts, length),
                      nbytes=2 * b * length * 8 + b * 4,
                      library=lambda: torch.gather(xd, 1, idx))
        with torch.inference_mode():
            step_ms = cuda_ms(lambda: pipe.step(xd, td))
            busy_ms = kernels_ms(lambda: pipe.step(xd, td))
        busy = "not measured" if busy_ms is None else f"{busy_ms:.4f} ms"
        print(f"time step {bw} MHz VHT MCS{cell['mcs']} [{b} x {n}]: "
              f"{step_ms:.4f} ms, {b * n / (step_ms * 1e-3):.6g} samples/s; "
              f"kernels {busy} of device time per step {tag}")

    # -- 8. the Viterbi floor probe -----------------------------------------
    probe = vit_floor.measure(dev)
    launches["vit_floor"] += probe["launches"]
    b, n_blk, _ = probe["shape"]
    # the probe's function: per packet and block one sum of 2k LLRs and one
    # product, then two adds per state
    probe["bound_ms"], probe["bound_by"] = bound(
        b * n_blk * 2 * kf.K * 4 + b * 64 * 4,
        b * n_blk * (2 * kf.K + 2 * 64))
    print(f"floor probe [{b} x {n_blk} blocks x 8]: kernel == plain; probe "
          f"{probe['ms']:.4f} ms (device {probe['device_ms']:.4f} ms), plain "
          f"{probe['plain_ms']:.4f} ms, bound {probe['bound_ms']:.4f} ms "
          f"({probe['bound_by']}); viterbi_r4 on [{b} x {n_blk * kf.K} x 2] "
          f"{probe['viterbi_ms']:.4f} ms (device "
          f"{probe['viterbi_device_ms']:.4f} ms); probe / viterbi device "
          f"time {probe['device_share']:.4f} {tag}")
    check(probe["launches"] > 0, "the probe run launched the probe kernel")

    # -- 9. shared-source slice kernel vs plain ------------------------------
    rng = np.random.default_rng(12)
    n_cap = 1 << 22
    cap_dev = torch.from_numpy(rng.standard_normal((n_cap, 2))
                               .astype(np.float32)).to(dev)
    sig_len = (receiver.SIGPARSE_WIN + 320)
    data_len = receiver.SisoDataDecoder(Mod(F.VHT, 7), 48).zlen()
    shared_err = 0.0
    for what, length in (("sig", sig_len), ("data", data_len)):
        st = np.concatenate([[0, n_cap - length],
                             rng.integers(0, n_cap - length + 1, 1022)])
        st = torch.from_numpy(st.astype(np.int32)).to(dev)
        got = kg.capture_slice_iq_cuda(cap_dev, st, length)
        ref = receiver.capture_windows_plain(cap_dev, st, length)
        torch.cuda.synchronize()
        shared_err = max(shared_err, float((got - ref).abs().max()))
        check(torch.equal(got, ref), f"shared slice kernel == plain "
                                     f"({what})")
        idx = gather_index(st, n_cap, length, (len(st), length, 2))
        wide = cap_dev.expand(len(st), n_cap, 2)
        check(torch.equal(torch.gather(wide, 1, idx), got),
              f"torch.gather == shared slice kernel ({what})")
        time_pair(f"slice_shared_{what}", f"[{n_cap} -> 1024 x {length}]",
                  lambda: kg.capture_slice_iq_cuda(cap_dev, st, length),
                  lambda: receiver.capture_windows_plain(cap_dev, st,
                                                         length),
                  nbytes=(window_samples(st, n_cap, length) * 8
                          + len(st) * (length * 8 + 4)),
                  library=lambda: torch.gather(wide, 1, idx))
    del cap_dev

    def reset():
        kv.LAUNCHES = kg.LAUNCHES = kg.SHARED_LAUNCHES = 0
        kg.MULTI_LAUNCHES = 0

    def read(into=None):
        got = {"viterbi": kv.LAUNCHES, "slice": kg.LAUNCHES,
               "slice_shared": kg.SHARED_LAUNCHES,
               "slice_multi": kg.MULTI_LAUNCHES}
        if into is not None:
            for k, v in got.items():
                into[k] += v
        return got

    # the SISO receiver's windows come from a one-chain capture, the
    # dual-chain receiver's from the [2, N] capture
    siso_kernels = ("viterbi", "slice", "slice_shared")
    mimo_kernels = ("viterbi", "slice", "slice_multi")

    # -- 10. decode_capture on bench.py's 20-packet capture ------------------
    api_cap, api_mpdus = api_capture()
    rx = SisoReceiver(device=dev)
    reset()
    res = rx.decode_capture(api_cap)
    torch.cuda.synchronize()
    got = read(launches)
    print(f"decode_capture [{len(api_cap)} samples]: launches {got}")
    check(all(got[k] > 0 for k in siso_kernels), "decode_capture launched "
                                                "every receiver kernel")
    n_ok = sum(r.fcs_ok and r.mpdus[0] == m for r, m in zip(res, api_mpdus))
    print(f"decode_capture: {n_ok}/{N_API} packets decode to the exact MPDU "
          f"with a good FCS")
    check(len(res) == N_API and n_ok == N_API, "20/20 packets decode")
    ref = SisoReceiver(device="cpu").decode_capture(api_cap)
    print("decode_capture vs CPU run: fields equal, "
          + check_same_packets(res, ref, "decode_capture"))
    noisy = add_noise(api_cap, 30.0, seed=11)
    print("decode_capture at 30 dB SNR vs CPU run: fields equal, "
          + check_same_packets(rx.decode_capture(noisy),
                               SisoReceiver(device="cpu").decode_capture(
                                   noisy),
                               "noisy decode_capture", evm_tol=EVM_TOL))

    # -- 11. wideband --------------------------------------------------------
    for bw in (80, 40):
        wcap, wmpdus = wideband_capture(bw)
        wrx = SisoReceiver(sample_rate_hz=bw * 1e6, device=dev)
        reset()
        res = wrx.decode_capture(wcap)
        torch.cuda.synchronize()
        read(launches)
        n_ok = sum(r.fcs_ok and r.mpdus[0] == m for r, m in zip(res, wmpdus))
        print(f"{bw} MHz capture: {n_ok}/{len(wmpdus)} packets "
              f"({', '.join(f'{r.fmt.name}{r.mcs}' for r in res)}) decode "
              f"to the exact MPDU with a good FCS")
        check(len(res) == len(wmpdus) and n_ok == len(wmpdus),
              f"every {bw} MHz packet decodes")

    # -- 12. the stream at full width -------------------------------------
    caps = stream_captures(api_cap)
    total = sum(len(c) for c in caps)
    print(f"stream: {len(caps)} captures of {len(caps[0])}-"
          f"{len(caps[-1])} samples, {N_API * N_COPY} packets each; "
          f"native runtime available: {native.available()}")
    rx_h = SisoReceiver(device=dev)
    rx_d = SisoReceiver(trigger="device", device=dev)
    for c in caps:
        t_host, _, npad = rx_h._ingest(c)
        t_dev = rx_d._trigger_starts(rx_d._ingest_device(c)[0])
        check(len(t_dev) == len(t_host) and np.all(np.abs(t_dev - t_host)
                                                   <= 4),
              f"device trigger == host trigger (count {len(t_dev)} vs "
              f"{len(t_host)}; positions within 4)")
    print(f"triggers per capture: {len(t_host)} from the host scan, equal "
          f"in count (positions within 4 samples) to the device scan; "
          f"ingest {rx_h._mode(npad)}")
    stream_rate = {}
    for name, srx in (("host", rx_h), ("device", rx_d)):
        route = ("int8, native scan_quantize + upload"
                 if name == "host" and native.available() else
                 "int8, quantize + upload, trigger scan on the card")
        reset()
        waits, implicit = stream_pass(srx, caps, N_API * N_COPY,
                                      f"{name} trigger")
        got = read(launches)
        print(f"stream, {name} trigger ({route}): {N_API * N_COPY}/"
              f"{N_API * N_COPY} good FCS in each of {len(caps)} captures; "
              f"launches {got}; host waits on the device per capture "
              f"{waits:.4g}, implicit syncs {implicit}")
        for k, c in enumerate(caps):
            reset()
            srx.decode_captures([c])
            torch.cuda.synchronize()
            per = read()
            check(all(per[n] > 0 for n in siso_kernels),
                  f"{name} trigger capture {k} launched every kernel {per}")
        best, dts, n_pk = best_of_3(srx, caps)
        stream_rate[name] = (total / best, n_pk / best)
        print(f"time stream, {name} trigger: best of 3 {best:.4f} s "
              f"(runs {', '.join(f'{d:.4f}' for d in dts)}): "
              f"{stream_rate[name][0]:.6g} samples/s, "
              f"{stream_rate[name][1]:.6g} packets/s {tag}")
    del caps, rx_h, rx_d

    # -- 13. multi-chain slice kernel vs plain -------------------------------
    rng = np.random.default_rng(13)
    cap_dev = torch.from_numpy(rng.standard_normal((2, n_cap, 2))
                               .astype(np.float32)).to(dev)
    mimo_len = get_mimo_decoder(Mod(F.VHT, 4, BW.BW20, 2), 16).zlen()
    multi_err = 0.0
    for what, length in (("sig", sig_len), ("data", mimo_len)):
        st = np.concatenate([[0, n_cap - length],
                             rng.integers(0, n_cap - length + 1, 1022)])
        st = torch.from_numpy(st.astype(np.int32)).to(dev)
        got = kg.capture_slice_iq_mimo_cuda(cap_dev, st, length)
        ref = receiver.capture_windows_mimo_plain(cap_dev, st, length)
        torch.cuda.synchronize()
        multi_err = max(multi_err, float((got - ref).abs().max()))
        check(torch.equal(got, ref), f"multi-chain slice kernel == plain "
                                     f"({what})")
        idx = gather_index(st, n_cap, length, (len(st), 2, length, 2))
        wide = cap_dev.expand(len(st), 2, n_cap, 2)
        check(torch.equal(torch.gather(wide, 2, idx), got),
              f"torch.gather == multi-chain slice kernel ({what})")
        time_pair(f"slice_multi_{what}", f"[2 x {n_cap} -> 1024 x 2 x "
                                         f"{length}]",
                  lambda: kg.capture_slice_iq_mimo_cuda(cap_dev, st, length),
                  lambda: receiver.capture_windows_mimo_plain(cap_dev, st,
                                                              length),
                  nbytes=2 * (window_samples(st, n_cap, length) * 8
                              + len(st) * length * 8) + len(st) * 4,
                  library=lambda: torch.gather(wide, 2, idx))
    del cap_dev

    # -- 14. MimoReceiver on the dual-chain universal capture ----------------
    for dead in (False, True):
        ucap, uwant = universal_capture(dead)
        what = "dead chain 0" if dead else "both chains live"
        mrx = MimoReceiver(device=dev)
        reset()
        pkts, ndps = mrx.decode_capture_full(ucap)
        torch.cuda.synchronize()
        got = read(launches)
        print(f"dual-chain decode_capture_full ({what}) [2 x "
              f"{ucap.shape[1]}]: launches {got}")
        check(all(got[k] > 0 for k in mimo_kernels),
              f"dual-chain decode ({what}) launched every kernel of its path")
        good = {(r.fmt, r.mcs): r for r in pkts if r.fcs_ok}
        check(set(good) == set(uwant) and len(pkts) == len(uwant)
              and all(good[k].mpdus[0] == m for k, m in uwant.items()),
              f"dual-chain ({what}): every packet decodes")
        check(len(good[(F.VHT, 4)].sssnr) == 2
              and good[(F.VHT, 4)].sigb_ok is True,
              f"dual-chain ({what}): 2x2 per-stream EVM and SIG-B")
        check(len(ndps) == 1 and len(ndps[0]) == 2
              and all(n.ltf_iq.shape == (128,)
                      and np.isfinite(n.ltf_iq).all() for n in ndps[0]),
              f"dual-chain ({what}): one NDP with two chain captures")
        ref_pkts, ref_ndps = MimoReceiver(
            device="cpu").decode_capture_full(ucap)
        d_ndp = max(float(np.abs(a.ltf_iq - b.ltf_iq).max())
                    for a, b in zip(ndps[0], ref_ndps[0]))
        check(len(ref_ndps) == 1 and d_ndp <= 1e-4,
              f"dual-chain ({what}): NDP captures == CPU run")
        print(f"dual-chain ({what}): {len(good)}/{len(uwant)} packets "
              f"({', '.join(f'{k[0].name}{k[1]}' for k in good)}) decode to "
              f"the exact MPDU, 1 NDP x 2 chains; vs CPU run: fields equal, "
              + check_same_packets(pkts, ref_pkts, f"dual-chain ({what})",
                                   evm_tol=EVM_TOL)
              + f", |dndp| {d_ndp:.3g}")

    # -- 15. 2x2 at 40 and 80 MHz --------------------------------------------
    for bw, fmt, mcs, wcap, mpdu in wideband_mimo_captures():
        reset()
        res = MimoReceiver(sample_rate_hz=bw * 1e6,
                           device=dev).decode_capture(wcap)
        torch.cuda.synchronize()
        read(launches)
        n_es = Mod(fmt, mcs, {40: BW.BW40, 80: BW.BW80}[bw], 2).nES
        check(len(res) == 1 and (res[0].fmt, res[0].mcs) == (fmt, mcs)
              and res[0].fcs_ok and res[0].mpdus[0] == mpdu,
              f"2x2 {fmt.name} MCS{mcs} {bw} MHz decodes")
        print(f"2x2 {fmt.name} MCS{mcs} {bw} MHz (nES {n_es}): decodes to "
              f"the exact MPDU with a good FCS, sssnr "
              f"{tuple(round(x, 2) for x in res[0].sssnr)}")

    # -- 16. the hard channel ------------------------------------------------
    hcap, hw, hmod, hn_sym, hexp, hmpdu = hard_channel()
    x = torch.from_numpy(hw).to(dev)
    sig40 = receiver.SigTables(2).to(dev)
    ls, cfo_h, _ = sync.sync_front_iq(
        x[:, 0], torch.zeros(1, dtype=torch.int32, device=dev), sig40.band,
        q=2)
    errs = {}
    for det in ("ml", "zf"):
        bits, _ = MimoDataDecoder(hmod, hn_sym, det).to(dev).decode(x, ls,
                                                                   cfo_h)
        errs[det] = int(np.sum(bits[0, :len(hexp)] != hexp))
    res = {det: MimoReceiver(sample_rate_hz=40e6, detector=det,
                             device=dev).decode_capture(hcap)
           for det in ("zf", "auto")}
    check(errs["ml"] == 0 and errs["zf"] > 0,
          f"hard channel: ML exact, ZF wrong ({errs})")
    check([r.fcs_ok for r in res["zf"]] == [False]
          and [r.fcs_ok for r in res["auto"]] == [True]
          and res["auto"][0].mpdus == [hmpdu],
          "hard channel: auto recovers what zf loses")
    print(f"hard channel (HT MCS15 40 MHz, cond 11): bit errors ML "
          f"{errs['ml']}, ZF {errs['zf']}; the receiver's zf fails the FCS, "
          f"auto decodes it")

    # -- 17. the dual-chain stream at full width -----------------------------
    mcaps, mwant = mimo_stream_captures()
    mtotal = sum(c.shape[1] for c in mcaps)
    print(f"dual-chain stream: {len(mcaps)} captures of 2 x "
          f"{mcaps[0].shape[1]}-{mcaps[-1].shape[1]} samples, {mwant} "
          f"packets each")
    mrxs = {d: MimoReceiver(detector=d, device=dev)
            for d in ("auto", "zf", "ml")}
    _, _, mnpad = mrxs["auto"]._ingest(mcaps[0])
    print(f"ingest {mrxs['auto']._mode(mnpad)} (native scan_quantize per "
          f"chain: {native.available()})")
    mimo_rate = {}
    for det, mrx in mrxs.items():
        # a warm pass builds the decoders of the stream's groups (moving
        # their tables to the card synchronizes); then the counted one
        stream_pass(mrx, mcaps, mwant, f"dual-chain stream ({det}), warm")
        reset()
        waits, implicit = stream_pass(mrx, mcaps, mwant,
                                      f"dual-chain stream ({det})")
        got = read(launches)
        check(all(got[k] > 0 for k in mimo_kernels),
              f"dual-chain stream ({det}) launched every kernel {got}")
        print(f"dual-chain stream, detector {det}: {mwant}/{mwant} good FCS "
              f"in each of {len(mcaps)} captures; launches {got}; host waits "
              f"on the device per capture {waits:.4g}, implicit syncs "
              f"{implicit}")
    for k, c in enumerate(mcaps):
        reset()
        mrxs["auto"].decode_captures([c])
        torch.cuda.synchronize()
        per = read()
        check(all(per[n] > 0 for n in mimo_kernels),
              f"dual-chain capture {k} launched every kernel {per}")
    runs = {d: [] for d in mrxs}
    for _ in range(3):                     # alternating, as bench.py
        for det, mrx in mrxs.items():
            t = time.perf_counter()
            mrx.decode_captures(mcaps)
            torch.cuda.synchronize()
            runs[det].append(time.perf_counter() - t)
    for det, dts in runs.items():
        best = min(dts)
        mimo_rate[det] = (mtotal / best, mwant * len(mcaps) / best)
        print(f"time dual-chain stream, detector {det}: best of "
              f"{len(dts)} {best:.4f} s (runs "
              f"{', '.join(f'{d:.4f}' for d in dts)}): "
              f"{mimo_rate[det][0]:.6g} samples/s per chain, "
              f"{mimo_rate[det][1]:.6g} packets/s {tag}")

    # -- 18. the kernels line ------------------------------------------------
    def entry(name, source, replaces, key, err, t):
        return {"name": name, "route": "cuda",
                "source": f"ieee80211_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[key],
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "device_ms": t["device_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]}

    gather_tpu = "ieee80211_tpu/ops/pallas/gather.py:78"
    probe["library_ms"] = None   # no PyTorch call computes the probe
    kernels = [
        entry("viterbi_r4", "viterbi.cu",
              "ieee80211_tpu/ops/pallas/viterbi.py:272", "viterbi", vit_err,
              times["viterbi_data"]),
        entry("slice_iq", "gather.cu", gather_tpu, "slice", slice_err,
              times["slice_z_20"]),
        entry("slice_iq_shared", "gather.cu", gather_tpu, "slice_shared",
              shared_err, times["slice_shared_sig"]),
        entry("slice_iq_mimo", "gather.cu", gather_tpu, "slice_multi",
              multi_err, times["slice_multi_sig"]),
        entry("vit_floor", "vit_floor.cu", "perf_vit_floor.py:37",
              "vit_floor", probe["max_abs_err"], probe),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
