#!/usr/bin/env python3
"""Drive the PyTorch port's receive and transmit paths once on one NVIDIA
GPU.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the exit code is non-zero:
  1. device check (exits 1 without CUDA) and the card's name / power limit;
  2. build of every CUDA kernel from ieee80211_tpu_torch/csrc/ with nvcc;
  3. the Viterbi kernel against its plain PyTorch version on the card, bit
     for bit, and against the encoder's input bits, at the shapes of the
     receive step and of the streaming receiver, and on 64 rows of NaN,
     +-inf and huge LLRs (a junk window's); then, bit for bit, on the
     inputs that the PDR acceptance sweep (phase 25) handed it, recorded as
     they launched, at 0 dB and at the top SNR of rows with its longest
     DATA fields, every bandwidth, MRC, 2x2 and a 4-user MU station
     (100 packets of 500 B);
  4. the window-slice kernel against its plain version, element for element,
     on random windows (odd and even lengths and starts, full-length
     windows, starts clipped at both ends, int32 and int64 starts) and on
     the windows those sweep points cut;
  5. + 6. `RxPipeline.step` at VHT MCS7 20 MHz (500 B, batch 1024) and VHT
     MCS9 80 MHz (1800 B, batch 256), the inputs of bench.py's two RX rows:
     every packet must decode to the exact MPDU with a good FCS, the first
     rows must equal the port's CPU run, and launch counters must show that
     each step's first (eager) call went through both kernels; then each
     step's CUDA graph, captured on its second call and replayed on its
     third: both outputs equal to the eager call's (`torch.equal`), one
     capture, GRAPH_REPLAYS up by one per replay, and no wrapper call in a
     replay;
  7. times at the main path's shapes: each kernel per wrapper call (CUDA
     events, median of 10 after warm-up, in turns with the torch.gather
     call where there is one), the host's time to issue one call
     (median of 1000 on the host clock) and on the device alone (10
     launches queued back to back behind a spin of the card), its plain
     version, the one torch.gather call that cuts the same windows (the
     Viterbi has no such PyTorch call), the least time of its work
     (bound_ms, from its bytes and operations), and the whole step with
     its kernels' device time (torch.profiler);
  8. the Viterbi floor probe (its own entry point, perf/vit_floor.py):
     kernel == plain at 1024 x 1176 blocks, timed beside the Viterbi kernel
     on the same input, whose skeleton it runs: its device time must be
     below the Viterbi's;
  9. the shared-source slice kernel against its plain version and
     torch.gather on a 4M-sample capture with 1024 starts, at the SIG and a
     DATA window length, timed (with the host's issue time beside
     torch.gather's), and on odd lengths and int64 starts;
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
     and a 2x2 DATA window, timed as in phase 9, and on odd lengths and
     int64 starts;
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
     samples/s and packets/s (best of 3), host waits and implicit syncs;
 18. `TxPipeline` (bench.py:128-170): L MCS0 with the 30-byte UDP MPDU and
     VHT MCS7 with 2 streams, batch 1024 each, held to the golden TX within
     TX_TOL and timed (samples/s);
 19. `MuTxPipeline` (bench.py:220-272): VHT MCS4 + MCS2 users with 500 B /
     300 B payloads and a random unitary Q (seed 2), batch 256, held to
     `gen_ampdu_mu` and timed;
 20. the MU-MIMO closed loop on the card: NDP -> `sta_capture_ndp` ->
     feedback -> ZF Q -> `MuTxPipeline` -> `sta_decode_mu` for 2 users
     (tests/test_jax_tx.py:77-119) and 4 users (tests/test_mu_mimo.py:83-120):
     every station recovers its exact MPDU;
 21. `MuStaDecoder` at batch 256 (bench.py:281-342) behind its FCS gate,
     timed;
 22. the MU stream (bench.py:508-556): four captures of 60 x (5 MU + 5 SU)
     packets through `SisoReceiver(mu_pos=0, mu_gid=2).decode_captures`:
     300/300 MU and 300/300 SU per capture, 0 implicit syncs, launches per
     capture, samples/s (best of 3);
 23. `MimoReceiver(mu_pos=0, mu_gid=2)` on the dual-chain MU captures of
     tests/test_mu_stream.py (20 MHz with 2x2 SU traffic, 40 MHz), against
     the port's CPU run;
 24. `PhyService`: the sounding loop of tests/test_api.py:67-103 on the card,
     its records against the port's CPU run;
 25. a cut of the PDR acceptance sweep (perf/acceptance.py) at full width
     (500 B, 100 packets per point): one row of each group (SISO VHT7, 2x2
     HT8, MRC VHT4, 80 MHz fading VHT4 and VHT7, 40 MHz 2x2 fading HT12, the
     unweighted VHT7 @80 row, 2-user MU MCS4) at a dead SNR and at 30 dB
     (36 dB fading): PDR 1.0 at the top but for the unweighted row, which
     stays at or below the weighted one; Viterbi and per-row slice launches
     in every row, 0 implicit syncs per point, each point's wall and step
     time, the cut's packets/s; one numpy noise batch at 30 dB decodes to
     the same bytes on the card as on the CPU (SISO and 2x2); the ML
     detector's peak memory at 2x2 VHT9 80 MHz;
 26. the examples on the card: gen_test_captures' bins through inspect_bin
     (every packet with a good FCS, the 2x2 pair through MimoReceiver),
     stream_decode SISO and --dual (every packet, MU included; shared-source
     and multi-chain slice launches), mu_sounding_demo (each station its
     own payload);
 27. the mesh on one card (parallel/, a 1-rank NCCL group): `make_phy_mesh`
     and `process_summary`; `sharded_frontend` against `stf_autocorr` on the
     first stream capture of phase 12 with 30 dB of noise; `sharded_rx` and `multichip_step` on phase
     5's 20 MHz batch give `RxPipeline.step`'s bits; `sharded_capture_decode`
     on tests/test_sharded_capture.py's L MCS7 rows against SisoReceiver;
 28. `sharded_capture_decode_auto` on the first stream capture of phase 12
     (1000 HT5 / VHT7 packets), with the branch loop and `generic=True`:
     every packet's MPDUs equal `SisoReceiver.decode_capture`'s, no
     overflow; per call samples/s (CUDA events, median of 5), launches,
     implicit syncs, peak memory and the card's busy share, beside the
     receiver's samples/s; every Viterbi and slice launch of the first call
     recorded as it launched and held bit-equal to its plain version;
 29. `sharded_capture_decode_auto2` on the first dual-chain stream capture
     of phase 17 (1440 packets) with `branch_cap=None` and 768: the same
     checks and numbers against `MimoReceiver("auto")`;
 30. the loop's envelope: the first capture of `entry.envelope_captures(1)`
     (`__graft_entry__.dryrun_multichip`'s: L, VHT A-MPDU, HT MCS12 2x2,
     an NDP whose LTFs give `ndp_ltf_channel`),
     tests/test_sharded_dual.py's MU branch (with and without a branch
     cap), tests/test_sharded_capture.py's 80 MHz case;
 31. `perf.scaling.measure_scaling()` on one rank: {1: samples/s} (N >= 2
     cannot be measured on one card);
 32. the port's bench (perf/bench.py) for one round on the inputs that
     phases 5-22 built (its input functions are memoized): every row's
     every call gated, bench.py's keys each > 0; its JSON line;
 33. the step's stages (perf/stages.py) at batch 1024, each alone on the
     step's own tensors, beside the whole step, and the TPU-era layouts
     (DFT matmul, banded-matmul moving sums, one-hot descramble) beside one
     PyTorch call each, checked to agree;
 34. one rep of the streams' host-floor bracket (perf/floor.py): ingest,
     + SIG dispatch and fetch, full decode, for both triggers and the
     dual-chain receiver;
 35. the branch-dispatch floor (perf/branch_floor.py) at 8 branches: the
     auto loop (branch loop, generic=True) and the auto2 loop (branch_cap
     None, 16, 8) on 64 planted packets, each decoding every packet;
 36. the top-level entry points (ieee80211_tpu_torch/entry.py): `entry()` on
     the card (4/4 lsig_ok, the exact MPDU in every row, equal to the port's
     CPU run, Viterbi and per-row slice launches, the step's time), then
     `dryrun_multichip(1)` on phase 27's 1-rank NCCL group (counts 3 / 1 /
     1 / 1: mixed packets, NDPs, MU, 80 MHz) and each of its three loops
     alone: Viterbi and multi-chain slice launches, the call's time (CUDA
     events, median of 5 after a warm-up);
 37. `perf.multicard`'s 1-rank pass on phase 27's NCCL group: every loop
     of parallel/sharded.py (the frontend, `sharded_rx`,
     `sharded_capture_decode`, the auto loop with its branch loop and
     `generic=True`, auto2 with and without `branch_cap`) on a 1-rank mesh,
     each held to the packets planted, its launches and its time per call
     (CUDA events, median of 5 after a warm-up);
 38. the kernels line.
The MU shapes (a SIG-B group of 26 bits, the MU stream's DATA bucket, and
the MU window lengths of both capture-slice modes) join phases 3, 9 and 13.
The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or of the JAX package
(the GPU machine has no JAX): only the port, torch and numpy.
"""
import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

from ieee80211_tpu_torch import entry as port_entry
from ieee80211_tpu_torch import native
from ieee80211_tpu_torch.api import PhyService
from ieee80211_tpu_torch.api import descriptors as wire
from ieee80211_tpu_torch.examples import (gen_test_captures, inspect_bin,
                                          mu_sounding_demo, stream_decode)
from ieee80211_tpu_torch.mac import (MacConfig, aggregate_vht, build_udp_mpdu,
                                     deaggregate_vht)
from ieee80211_tpu_torch.mu import (map_q_to_grid, ndp_ltf_channel,
                                    vht_channel_feedback, zf_q)
from ieee80211_tpu_torch.mu import sounding
from ieee80211_tpu_torch.models import RxPipeline, pipeline
from ieee80211_tpu_torch.ops import coding, sync
from ieee80211_tpu_torch.ops.cuda import build
from ieee80211_tpu_torch.ops.cuda import gather as kg
from ieee80211_tpu_torch.ops.cuda import vit_floor as kf
from ieee80211_tpu_torch.ops.cuda import viterbi as kv
from ieee80211_tpu_torch.parallel import (make_phy_mesh, multichip_step,
                                          process_summary,
                                          sharded_capture_decode,
                                          sharded_frontend, sharded_rx)
from ieee80211_tpu_torch.parallel.sharded import (
    HALO, branch_window_len, sharded_capture_decode_auto,
    sharded_capture_decode_auto2)
from ieee80211_tpu_torch.perf import acceptance as acc
from ieee80211_tpu_torch.perf import (bench, branch_floor, floor, multicard,
                                      pdr, stages, vit_floor)
from ieee80211_tpu_torch.perf.branch_floor import loop_mpdus
from ieee80211_tpu_torch.perf.scaling import measure_scaling
from ieee80211_tpu_torch.perf.timing import (cuda_ms, cuda_ms_turns,
                                             device_ms, host_us, kernels_ms)
from ieee80211_tpu_torch.rx import (MimoDataDecoder, MimoReceiver,
                                    MrcDataDecoder, SisoReceiver,
                                    get_mimo_decoder, receiver)
from ieee80211_tpu_torch.rx.generic import GenericSisoDecoder
from ieee80211_tpu_torch.specs import BW, CR, F, Mod
from ieee80211_tpu_torch.specs.modulation import (ppdu_params_aggregate,
                                                  ppdu_params_nonaggregate)
from ieee80211_tpu_torch.tx import (MuTxPipeline, TxPipeline, finalize,
                                    gen_ampdu, gen_ampdu_mu, gen_mpdu)
from ieee80211_tpu_torch.tx.golden import bcc
from ieee80211_tpu_torch.utils import c2r, load_complex_bin, r2c

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
HEADLINE, WIDEBAND = bench.HEADLINE, bench.WIDEBAND   # bench.py's RX rows
# the streaming receiver on the card against its CPU run of the same capture
CFO_HZ_TOL = 1.0   # Hz: the sync's float32 CFO (1e-6 rad/sample) x fs / 2pi
EVM_TOL = 1e-2     # dB, on a copy with 30 dB SNR. A noiseless packet's EVM
EVM_FLOOR = 100.0  # SNR measures float32 rounding (~130 dB) and differs by
                   # dB between devices: there both must only exceed 100 dB
MAC = bench.MAC
# bench.py's capture rows (perf/bench.py builds them): its 20-packet capture,
# 50 copies of it per stream capture, the MU stream's 4 captures of 60
# copies of a 10-packet segment
N_API, N_COPY = bench.FULL.n_api, bench.FULL.n_copy
N_MU_SEG, N_MU_REP = bench.FULL.n_mu_seg, bench.FULL.n_mu_rep
N_MU_CAP = bench.FULL.n_mu_cap
MU_GID = bench.MU_GID
# a TX waveform on the card against the golden complex128 TX: cuFFT's
# float32 rounding (the CPU run is held to 2e-6 in tests/test_torch_tx.py)
TX_TOL = bench.TX_TOL
NDP_TOL = 1e-4     # a channel report's samples, card against CPU run
# the sharded capture loop on one rank: the frontend's autocorrelation
# against stf_autocorr of the whole capture (tests/test_parallel.py:37)
AC_TOL = 1e-4
# trigger slots of the loops: their capacity counts rises before the
# min_gap dedup, and the stream captures rise twice per packet (L-STF, then
# HT/VHT-STF 560 samples later): 2000 rises on the SISO capture, 2880 on
# the dual-chain one (max over chains)
LOOP_K, LOOP2_K = 2048, 3072
LOOP2_CAP = 768    # per-branch windows with branch_cap (720 packets each)
LOOP_ITERS = 5


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
    """bench.py's RX input without JAX (perf/bench.py::rx_batch, memoized:
    the port's bench reuses it). Returns (RxPipeline on `device`, x2
    [B, W, 2] float32, t0 [B] int32, mpdu)."""
    b = bench.rx_batch(fmt=fmt, mcs=mcs, bw=bw, payload=payload, seed=seed,
                       cfo_hz=cfo_hz, batch=batch)
    return (RxPipeline(b.mod, b.n_sym, b.psdu_len, device=device), b.x2,
            b.t0, b.mpdu)


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


def counted(fn):
    """fn() under the sync debug mode. Returns (its result, implicit
    syncs)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode's own notice on enabling is a warning too: count only the
    # ops it flags
    return out, sum("synchroniz" in str(w.message)
                    and "prototype" not in str(w.message) for w in caught)


def counted_pass(srx, caps):
    """One pass of `srx.decode_captures(caps)` under the sync debug mode.
    Returns (results, host waits per capture, implicit syncs)."""
    waits = srx.n_waits
    stream, implicit = counted(lambda: srx.decode_captures(caps))
    return stream, (srx.n_waits - waits) / len(caps), implicit


def stream_pass(srx, caps, want: int, what: str):
    """counted_pass, and every capture must return `want` packets with a
    good FCS. Returns (host waits per capture, implicit syncs)."""
    stream, waits, implicit = counted_pass(srx, caps)
    for res in stream:
        n_ok = sum(r.fcs_ok for r in res)
        check(n_ok == want == len(res), f"{what}: {n_ok}/{want} packets")
    return waits, implicit


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


CFG_QOS = bench.CFG_QOS


def tx_cases():
    """bench.py's TX row (L MCS0, the 30-byte UDP MPDU) and VHT MCS7 with
    2 streams on the same MPDU in an A-MPDU: [(name, mod, pp, input bytes,
    golden waveform)]."""
    l0, pp, mpdu, wave = bench.tx_input()
    ampdu = aggregate_vht([build_udp_mpdu(b"123456789012345678901234567890",
                                          CFG_QOS)])
    v7 = Mod(F.VHT, 7, BW.BW20, 2)
    return [("L MCS0", l0, pp, mpdu, wave),
            ("VHT MCS7 2x2", v7, ppdu_params_aggregate(v7, len(ampdu)),
             ampdu, gen_ampdu(ampdu, v7).waveform)]


def mu_stream_shapes():
    """The MU stream's kernel shapes: its MU DATA decode group (mod,
    bucket, padded rows) and the window lengths of its MU SIG-B and DATA
    decodes."""
    a0 = aggregate_vht([build_udp_mpdu(bytes(400), CFG_QOS)])
    a1 = aggregate_vht([build_udp_mpdu(bytes(300), CFG_QOS)])
    mod = Mod(F.VHT, 4, BW.BW20, 1)
    n_sym = max(ppdu_params_aggregate(mod, len(a0)).n_sym,
                ppdu_params_aggregate(Mod(F.VHT, 2, BW.BW20, 1),
                                      len(a1)).n_sym)
    bucket = receiver._bucket(n_sym)
    rows = receiver.group_pad(N_MU_REP * N_MU_SEG // 2)
    sigb_len = 272 + 448 + 80 * 2 + 160
    data_len = sounding.MuStaDataDecoder(mod, bucket, 0, 2).zlen()
    return mod, bucket, rows, sigb_len, data_len


def mu_dual_chain_captures():
    """tests/test_mu_stream.py's dual-chain MU captures, at 30 dB: a 2-user
    MU PPDU whose stream 0 reaches both RX antennas (the interferer's
    nulled), then at 20 MHz a 2x2 VHT MCS3 SU A-MPDU. Returns [(fs,
    capture [2, N], MU MPDU, SU MPDUs)]."""
    out = []
    for q in (1, 2):
        bw = (BW.BW20, BW.BW40)[q - 1]
        m0, m1 = (build_udp_mpdu(p, CFG_QOS) for p in (
            (b"dual chain mu user0 payload xyz",
             b"dual chain mu user1 payload abc") if q == 1 else
            (b"wideband dual mu user0 payload",
             b"wideband dual mu user1 payload")))
        qi = np.tile(np.eye(2, dtype=np.complex64)[None], (64 * q, 1, 1))
        tx = gen_ampdu_mu([aggregate_vht([m0]), aggregate_vht([m1])],
                          [Mod(F.VHT, 4 if q == 1 else 5, bw, 1),
                           Mod(F.VHT, 2, bw, 1)], bfq=qi, group_id=MU_GID)
        wave = finalize(tx.waveform, multiplier=0.2,
                        cfo_hz=-7000.0 if q == 1 else 15000.0, gap=False)
        g = np.array([0.9 - 0.2j, 0.6 + 0.7j])
        z = np.zeros((2, 900 * q), np.complex64)
        parts, su = [z, g[:, None] * wave[0], z], []
        if q == 1:
            m_su = build_udp_mpdu(b"dual chain su 2x2 payload qrstu", CFG_QOS)
            w_su = finalize(gen_ampdu(aggregate_vht([m_su]),
                                      Mod(F.VHT, 3, BW.BW20, 2)).waveform,
                            multiplier=0.2, cfo_hz=9000.0, gap=False)
            h22 = np.array([[1.0 + 0.1j, 0.3 - 0.4j], [-0.2 + 0.5j, 0.8]])
            parts += [h22 @ w_su, z]
            su = [m_su]
        out.append((20e6 * q, add_noise(np.concatenate(parts, axis=1), 30.0,
                                         seed=100 + q), m0, su))
    return out


def sta_noise(y, seed: int):
    """tests/test_mu_mimo.py's `_apply` noise: 1e-4 per axis."""
    rng = np.random.default_rng(seed)
    return (y + (rng.standard_normal(y.shape)
                 + 1j * rng.standard_normal(y.shape)) * 1e-4).astype(
                     np.complex64)


def closed_loop(n_user: int, mcss, dev):
    """NDP sounding through a well-conditioned n_user x n_user channel
    (seed 42 for 2 users, 77 for 4) -> sta_capture_ndp -> feedback -> ZF
    Q -> MuTxPipeline -> sta_decode_mu at every station, on `dev`. Returns
    the stations' results and their MPDUs."""
    rng = np.random.default_rng(42 if n_user == 2 else 77)
    h = (rng.standard_normal((n_user, n_user))
         + 1j * rng.standard_normal((n_user, n_user)))
    h += (2.0 if n_user == 2 else 2.5) * np.eye(n_user)
    ndp = gen_ampdu(b"", Mod(F.VHT, 0, BW.BW20, n_user))
    ncap = finalize(ndp.waveform, multiplier=0.3, cfo_hz=4000.0, gap=True,
                    gap_len=1200)
    v_users = []
    for u in range(n_user):
        nc = sounding.sta_capture_ndp(sta_noise(h[u] @ ncap, u),
                                      n_sts=n_user, device=dev)
        check(nc is not None, f"{n_user}-user loop: station {u} NDP")
        v_users.append(vht_channel_feedback(
            ndp_ltf_channel(nc.ltf_iq, n_sts=n_user), BW.BW20,
            n_sts=n_user, n_rx=1))
    q = map_q_to_grid(zf_q(v_users))
    mpdus = [build_udp_mpdu(f"packet for STA {u} {'x' * (10 + 7 * u)}"
                            .encode(), CFG_QOS) for u in range(n_user)]
    ampdus = [aggregate_vht([m]) for m in mpdus]
    tx = MuTxPipeline([Mod(F.VHT, m, BW.BW20, 1) for m in mcss],
                      [len(a) for a in ampdus], group_id=5, device=dev)
    out = tx.step([bench.rows_on(a, 1, dev) for a in ampdus],
                  torch.from_numpy(c2r(q.astype(np.complex64))).to(dev))
    wave = out[0].cpu().numpy()
    cap = finalize(wave[..., 0] + 1j * wave[..., 1], multiplier=0.3,
                   cfo_hz=-3000.0, gap=True, gap_len=1200)
    res = [sounding.sta_decode_mu(sta_noise(h[u] @ cap, 20 + u), mupos=u,
                                  device=dev) for u in range(n_user)]
    return res, mpdus


def sounding_loop(device):
    """tests/test_api.py's sounding loop over the wire API, the stations'
    receivers on `device`: an NDP, each station's channel report, the AP's
    ZF Q as a BFQ, a 2-user MU request. Returns (the stations' records of
    the NDP, of the MU PPDU, and the MPDUs)."""
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
    h += 2.0 * np.eye(2)
    ap = PhyService(mugid=0, device=device)
    stas = [PhyService(mupos=u, mugid=MU_GID, device=device)
            for u in range(2)]
    ndp_wave = ap.handle_request(wire.pack_ndp())
    ndp_recs = [sta.rx_capture((h[u] @ ndp_wave).astype(np.complex64))
                for u, sta in enumerate(stas)]
    ltfs = [wire.unpack_rx_record(r[0]).ltf_iq for r in ndp_recs]
    q = map_q_to_grid(zf_q([vht_channel_feedback(ndp_ltf_channel(x),
                                                 BW.BW20, 2, 1)
                            for x in ltfs]))
    ap.handle_request(wire.pack_bfq(q.astype(np.complex64)))
    m = [build_udp_mpdu(b"1234567 packet for station 000", CFG_QOS),
         build_udp_mpdu(b"7654321 packet for station 111", CFG_QOS)]
    mu_wave = ap.handle_request(wire.pack_mu_data(
        aggregate_vht([m[0]]), Mod(F.VHT, 0), aggregate_vht([m[1]]),
        Mod(F.VHT, 0), MU_GID))
    mu_recs = [sta.rx_capture((h[u] @ mu_wave).astype(np.complex64))
               for u, sta in enumerate(stas)]
    return ndp_recs, mu_recs, m


# the acceptance sweep's operating point (perf/acceptance.py): 500 B
# payloads, 100 packets per SNR point
ACC_PAYLOAD, ACC_NPKT = 500, 100


def acceptance_rows():
    """The cut of the acceptance sweep: one row of each group, as
    run_acceptance builds it, at its dead SNR point (0 dB) and its top one
    (30 dB, 36 dB for the fading rows): [(group, build, pipeline, (fmt,
    mcs), channel draw, top SNR)]. The weighted VHT7 @80 fading row is the
    unweighted row's yardstick."""
    bw80 = pdr._build_packet_bw(BW.BW80)
    return [
        ("siso", pdr._build_packet, RxPipeline, (F.VHT, 7), None, 30.0),
        ("mimo_2x2", pdr._build_mimo_packet, pdr.MimoRxPipeline, (F.HT, 8),
         None, 30.0),
        ("siso_mrc_2rx", acc._build_mrc_packet, acc._MrcPipe, (F.VHT, 4),
         None, 30.0),
        ("siso_fading_80", bw80, RxPipeline, (F.VHT, 4), acc._chan_fir(4),
         36.0),
        ("siso_fading_80", bw80, RxPipeline, (F.VHT, 7), acc._chan_fir(4),
         36.0),
        ("mimo_2x2_fading_40", pdr._build_mimo_packet_bw(BW.BW40),
         pdr.MimoRxPipeline, (F.HT, 12), acc._chan_mix, 36.0),
        ("siso_fading_80_unweighted_llr", bw80,
         functools.partial(RxPipeline, csi_weight=False), (F.VHT, 7),
         acc._chan_fir(4), 36.0)]


# rows of the acceptance sweep whose kernel inputs phases 3 and 4 hold
# against the plain versions: the longest DATA fields (VHT0 at 500 B on one
# and on two chains, VHT0 and 2x2 VHT9 at 80 MHz), every bandwidth, the
# per-chain windows of MRC and 2x2, and a 4-user MU station below
# (name, build, pipeline, (fmt, mcs), channel draw, top SNR)
SWEEP_KERNEL_ROWS = [
    ("siso/VHT0", pdr._build_packet, RxPipeline, (F.VHT, 0), None, 30.0),
    ("siso_mrc_2rx/VHT0", acc._build_mrc_packet, acc._MrcPipe, (F.VHT, 0),
     None, 30.0),
    ("mimo_2x2/HT15", pdr._build_mimo_packet, pdr.MimoRxPipeline,
     (F.HT, 15), None, 30.0),
    ("siso_fading_40/VHT9", pdr._build_packet_bw(BW.BW40), RxPipeline,
     (F.VHT, 9), acc._chan_fir(2), 36.0),
    ("siso_fading_80/VHT0", pdr._build_packet_bw(BW.BW80), RxPipeline,
     (F.VHT, 0), acc._chan_fir(4), 36.0),
    ("mimo_2x2_fading_40/HT15", pdr._build_mimo_packet_bw(BW.BW40),
     pdr.MimoRxPipeline, (F.HT, 15), acc._chan_mix, 36.0),
    ("mimo_2x2_fading_80/VHT9", pdr._build_mimo_packet_bw(BW.BW80),
     pdr.MimoRxPipeline, (F.VHT, 9), acc._chan_mix, 36.0)]


@contextlib.contextmanager
def kernel_inputs():
    """Record, cloned, the inputs of every Viterbi and slice launch made
    inside the block: yields a list that gets ("viterbi", (pairs, w0, w1,
    renorm)), ("slice", (x2, start, length)) and, for the capture windows,
    ("slice_shared" or "slice_multi", (capture, start, length)) in launch
    order."""
    calls = []
    vit, sli = coding.viterbi_pairs_cuda, sync.batch_slice_iq_cuda

    def vit_rec(lp, w0, w1, renorm):
        calls.append(("viterbi", (lp.clone(), w0, w1, renorm)))
        return vit(lp, w0, w1, renorm)

    def sli_rec(x2, start, length):
        calls.append(("slice", (x2.clone(), start.clone(), length)))
        return sli(x2, start, length)

    def cut_rec(kind, kernel):
        def rec(cap, start, length):
            calls.append((kind, (cap.clone(), start.clone(), length)))
            return kernel(cap, start, length)
        return rec

    shared = receiver.capture_slice_iq_cuda
    multi = receiver.capture_slice_iq_mimo_cuda
    coding.viterbi_pairs_cuda, sync.batch_slice_iq_cuda = vit_rec, sli_rec
    receiver.capture_slice_iq_cuda = cut_rec("slice_shared", shared)
    receiver.capture_slice_iq_mimo_cuda = cut_rec("slice_multi", multi)
    try:
        yield calls
    finally:
        coding.viterbi_pairs_cuda, sync.batch_slice_iq_cuda = vit, sli
        receiver.capture_slice_iq_cuda = shared
        receiver.capture_slice_iq_mimo_cuda = multi


# each recorded kind: its kernel's wrapper and its plain version
RECORDED = {
    "viterbi": (kv.viterbi_pairs_cuda, coding.viterbi_pairs_plain),
    "slice": (kg.batch_slice_iq_cuda, sync.batch_slice_iq_plain),
    "slice_shared": (kg.capture_slice_iq_cuda,
                     receiver.capture_windows_plain),
    "slice_multi": (kg.capture_slice_iq_mimo_cuda,
                    receiver.capture_windows_mimo_plain),
}


def check_recorded(calls, what: str) -> dict:
    """Every launch recorded by kernel_inputs() against its plain version on
    the same inputs, bit for bit. Returns {kind: (launches, max |err|,
    shapes)}."""
    seen = {}
    with torch.inference_mode():
        for kind, args in calls:
            kernel, plain = RECORDED[kind]
            got, ref = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max()) if got.numel() else 0.0
            if not torch.equal(got, ref):
                bad = (got != ref).reshape(len(got), -1).any(dim=1)
                rows = args[0].reshape(len(args[0]), -1)[bad]
                fin = torch.isfinite(rows)
                big = float(rows[fin].abs().max()) if fin.any() else 0.0
                check(False, f"{what}: {kind} kernel == plain, "
                             f"{int(bad.sum())} of {len(got)} rows of "
                             f"{tuple(args[0].shape)} differ, "
                             f"{int((~fin).any(dim=1).sum())} of them with "
                             f"non-finite inputs, max |finite input| {big:g}")
            n, e, shapes = seen.get(kind, (0, 0.0, set()))
            shapes.add("x".join(map(str, args[0].shape)))
            seen[kind] = (n + 1, max(e, err), shapes)
    return seen


def reset() -> None:
    """Every kernel's launch count to 0."""
    kv.LAUNCHES = kg.LAUNCHES = kg.SHARED_LAUNCHES = 0
    kg.MULTI_LAUNCHES = 0


def read(into=None) -> dict:
    """The launch counts since reset(), added into `into` when given."""
    got = {"viterbi": kv.LAUNCHES, "slice": kg.LAUNCHES,
           "slice_shared": kg.SHARED_LAUNCHES,
           "slice_multi": kg.MULTI_LAUNCHES}
    if into is not None:
        for k, v in got.items():
            into[k] += v
    return got


def sweep_kernel_inputs(dev):
    """What the acceptance sweep hands the Viterbi and per-row slice
    kernels: one point of each of SWEEP_KERNEL_ROWS and of station 0 of the
    4-user MU MCS4 row, at the dead SNR (0 dB: noisy LLRs, near-tie paths
    everywhere) and at the row's top one, 100 packets of 500 B each.
    Returns [(row, SNR, [(kind, args), ...])]."""
    rows = [(name, top, pdr._prepare_row(build_fn, pipe_cls, fmt, mcs,
                                         ACC_NPKT, ACC_PAYLOAD, 0, chan, dev))
            for name, build_fn, pipe_cls, (fmt, mcs), chan, top
            in SWEEP_KERNEL_ROWS]
    h, q64 = acc._mu_sounding(0, 4, dev)
    rows.append(("mu_4user/MU_VHT4x4", 30.0, acc._mu_rows(
        4, 4, h, q64, ACC_NPKT, ACC_PAYLOAD, 0, dev)[0]))
    gen = pdr.noise_generator(0, dev)
    out = []
    for name, top, row in rows:
        for snr in (0.0, top):
            with kernel_inputs() as calls:
                row.n_ok(gen, pdr.noise_amp_at(snr))
            out.append((name, snr, calls))
    return out


# what inspect_bin decodes from each bin of gen_test_captures: (sample rate,
# [(fmt, mcs)]); one chain of the 2x2 capture holds no SISO packet
EXAMPLE_BINS = {
    "sig80211GenMultipleSiso_1x1_0.bin": (20e6, [(F.L, 7), (F.HT, 7),
                                                 (F.VHT, 7)]),
    "sig80211GenMultipleMimo_2x2_0.bin": (20e6, []),
    "sig80211GenMultipleMimo_2x2_1.bin": (20e6, []),
    "sig80211GenBeacon_1x1_0.bin": (20e6, [(F.L, 0)]),
    "sig80211GenWideband_40MHz.bin": (40e6, [(F.VHT, 7)]),
    "sig80211GenWideband_80MHz.bin": (80e6, [(F.VHT, 9)]),
}


def mesh_capture():
    """tests/test_sharded_capture.py's `_build` on one rank: two rows of L
    MCS7 packets (the 30-byte UDP MPDU, CFO 9 kHz) at offsets 600 / 5000 and
    1200 / 3400. Returns (capture [2, T], offsets, mod, ppdu params, window
    length, mpdu)."""
    mpdu = build_udp_mpdu(b"123456789012345678901234567890",
                          MacConfig(seq=2704, **MAC))
    mod = Mod(F.L, 7)
    pp = ppdu_params_nonaggregate(mod, len(mpdu))
    wave = finalize(gen_mpdu(mpdu, mod).waveform, multiplier=0.2,
                    cfo_hz=9000.0, gap=False)[0]
    w = RxPipeline(mod, pp.n_sym, pp.psdu_len, device="cpu").window_len()
    offs = [[600, 5000], [1200, 3400]]
    t_len = -(-(max(max(o) for o in offs) + len(wave) + w) // 512) * 512
    cap = np.zeros((2, t_len), np.complex64)
    for r, row in enumerate(offs):
        for o in row:
            cap[r, o:o + len(wave)] += wave
    return cap, offs, mod, pp, w, mpdu


def mu_loop_capture():
    """tests/test_sharded_dual.py::test_sharded_auto2_mu_branch's capture in
    two rows: a 2-user MU PPDU (VHT MCS4 + MCS2, identity Q, group 2) whose
    stream 0 reaches both chains, then an SU VHT MCS7 A-MPDU. Returns
    (capture [2, 2, T], branches, MU branches, window length, station 0's
    MPDU, the SU MPDU)."""
    cfg = MacConfig(seq=2704, **MAC)
    mpdu0 = build_udp_mpdu(b"sharded mu user zero exact pay", cfg)
    mpdu1 = build_udp_mpdu(b"sharded mu user one exact payl", cfg)
    mpdu_su = build_udp_mpdu(b"sharded su packet exact paylo", cfg)
    qi = np.tile(np.eye(2, dtype=np.complex64)[None], (64, 1, 1))
    mods = [Mod(F.VHT, 4, BW.BW20, 1), Mod(F.VHT, 2, BW.BW20, 1)]
    amps = [aggregate_vht([mpdu0]), aggregate_vht([mpdu1])]
    mu_wave = finalize(gen_ampdu_mu(amps, mods, bfq=qi,
                                    group_id=MU_GID).waveform, 0.2, -6000.0,
                       gap=False)
    g = np.array([0.9 - 0.2j, 0.55 + 0.7j])[:, None]
    mod_su = Mod(F.VHT, 7)
    amp_su = aggregate_vht([mpdu_su])
    su_wave = finalize(gen_ampdu(amp_su, mod_su).waveform, 0.2, 9000.0,
                       gap=False)[0]
    n_mu = max(ppdu_params_aggregate(m, len(a)).n_sym
               for m, a in zip(mods, amps))
    n_su = ppdu_params_aggregate(mod_su, len(amp_su)).n_sym
    w = max(MrcDataDecoder(mod_su, n_su).window_capacity(),
            272 + 448 + 4 * 80 + 160 + (n_mu + 2) * 80 + 80)
    z = np.zeros((2, 700), np.complex64)
    seg = np.concatenate([z, g * mu_wave[0], z,
                          np.array([[0.8], [0.3 + 0.6j]]) * su_wave], axis=1)
    t_len = -(-(seg.shape[1] + 2 * w) // 512) * 512
    cap = np.zeros((2, 2, t_len), np.complex64)
    for r in range(2):
        cap[r, :, 64 + 32 * r:64 + 32 * r + seg.shape[1]] += seg
    return (cap, ((mod_su, n_su),), ((mods[0], n_mu + 2),), w, mpdu0,
            mpdu_su)


def wideband_loop_capture():
    """tests/test_sharded_capture.py::test_sharded_auto_wideband_80mhz's
    capture: a VHT MCS9 80 MHz A-MPDU (CFO 35 kHz) in each of two rows, at
    256 and 384. Returns (capture [2, T], mod, n_sym, window length,
    mpdu)."""
    mpdu = build_udp_mpdu(b"wideband mesh loop payload 80MHz",
                          MacConfig(seq=2704, **MAC))
    ampdu = aggregate_vht([mpdu])
    mod = Mod(F.VHT, 9, BW.BW80, 1)
    n_sym = ppdu_params_aggregate(mod, len(ampdu)).n_sym
    wave = finalize(gen_ampdu(ampdu, mod).waveform, 0.2, 35000.0,
                    gap=False)[0]
    w = branch_window_len(mod, n_sym)
    t_len = -(-(len(wave) + 3000 + 2 * w) // 512) * 512
    cap = np.zeros((2, t_len), np.complex64)
    for r in range(2):
        cap[r, 256 + 128 * r:256 + 128 * r + len(wave)] += wave
    return cap, mod, n_sym, w, mpdu


def host_ms(fn, iters: int = 3) -> float:
    """Median wall time of fn() in ms, each run ending in a synchronize,
    after one warm-up."""
    fn()
    torch.cuda.synchronize()
    dts = []
    for _ in range(iters):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        dts.append((time.perf_counter() - t) * 1e3)
    return float(np.median(dts))


def loop_call(run, x, what: str, kinds, launches: dict, dev):
    """One capture loop on the card, called as a user calls it. The first
    call records every Viterbi and slice launch, each then held to its
    plain version; the second is the path's counted run (launch counts from
    0, implicit syncs); then its peak memory, its time (CUDA events, median
    of LOOP_ITERS after a warm-up) and the card's busy time in one more
    call. Returns (the counted call's outputs, a line of what was measured,
    ms per call)."""
    with torch.inference_mode():
        with kernel_inputs() as calls:
            run(x)
        torch.cuda.synchronize()
        reset()
        out, implicit = counted(lambda: run(x))
        got = read(launches)
        check(all(got[k] > 0 for k in kinds), f"{what}: launches {got}")
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        run(x)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
        ms = cuda_ms(lambda: run(x), iters=LOOP_ITERS, warmup=1)
        busy_ms = kernels_ms(lambda: run(x), iters=1, warmup=0)
    seen = check_recorded(calls, what)
    del calls
    kern = "; ".join(f"{k} {n} launches [{', '.join(sorted(s))}] max |err| "
                     f"{e:g}" for k, (n, e, s) in seen.items())
    busy = ("not measured" if busy_ms is None else
            f"{busy_ms:.4f} ms, {busy_ms / ms:.4f} of the call")
    return out, (f"launches {got}; implicit syncs {implicit}; peak memory "
                 f"{peak:.3f} GiB above the inputs; {ms:.4f} ms per call "
                 f"(median of {LOOP_ITERS}); device busy {busy}; recorded "
                 f"launches, each == plain: {kern}"), ms


def loop_phases(dev, tag: str, launches: dict, headline, loop_cap,
                api_mpdus, loop_mcap, mseg, mwant: int) -> None:
    """Phases 27-31: the sharded capture loop on one rank (a 1-rank NCCL
    group). headline: (cell, pipeline, x2, t0, its step's outputs) of phase
    5's 20 MHz batch; loop_cap and api_mpdus: the first SISO stream capture
    and its 20-packet segment's MPDUs; loop_mcap, mseg and mwant: the first
    dual-chain stream capture, its segment's (mod, mpdu) and its packet
    count. Launch counts add into `launches`."""
    siso_kernels = ("viterbi", "slice", "slice_shared")
    mimo_kernels = ("viterbi", "slice", "slice_multi")
    # -- 27. the mesh on one card --------------------------------------------
    mesh = make_phy_mesh(device=dev)
    print(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} over "
          f"ranks {mesh.mesh.flatten().tolist()}, {dist.get_backend()}; "
          f"process_summary {process_summary()}")
    # the stream capture with 30 dB of noise: in a run of zeros the long
    # moving sums are rounding residues, whose ratio the card's scan (its
    # association order varies from call to call) leaves undefined
    xs = torch.from_numpy(c2r(add_noise(loop_cap, 30.0, seed=27))[None]).to(
        dev)
    with torch.inference_mode():
        ac = sharded_frontend(mesh, xs)
        ref = sync.stf_autocorr(r2c(torch.cat(
            [xs, xs.new_zeros(1, HALO, 2)], dim=1)))[:, :xs.shape[1]]
        ref[:, -HALO:] = 0.0
        d_ac = float((ac - ref).abs().max())
    check(ac.shape == ref.shape and d_ac <= AC_TOL,
          f"sharded_frontend == stf_autocorr within {AC_TOL} ({d_ac:.3g})")
    print(f"sharded_frontend [1 x {xs.shape[1]}] (the stream capture at 30 "
          f"dB): == stf_autocorr of the whole capture, max |d| {d_ac:.3g}")
    cell, pipe, x2, t0, step_out = headline
    xd, td = torch.from_numpy(x2).to(dev), torch.from_numpy(t0).to(dev)
    run_rx = sharded_rx(mesh, pipe.mod, pipe.n_sym)
    run_mc = multichip_step(mesh, pipe.mod, pipe.n_sym)
    with torch.inference_mode():
        reset()
        out = run_rx(xd, td)
        torch.cuda.synchronize()
        got = read(launches)
        check(got["viterbi"] > 0 and got["slice"] > 0,
              f"sharded_rx launches {got}")
        check(all(torch.equal(out[k], step_out[k])
                  for k in ("bits", "ltf_start", "lsig_ok")),
              "sharded_rx == RxPipeline.step (bits, ltf_start, lsig_ok)")
        reset()
        mc = run_mc(xs, xd, td)
        torch.cuda.synchronize()
        got_mc = read(launches)
        check(got_mc["viterbi"] > 0 and got_mc["slice"] > 0,
              f"multichip_step launches {got_mc}")
        check(torch.equal(mc["bits"], step_out["bits"])
              and int(mc["n_ok"]) == cell["batch"]
              and abs(float(mc["ac_peak"]) - float(ac.max())) <= AC_TOL,
              "multichip_step: the step's bits, n_ok, ac_peak")
        ms_rx = cuda_ms(lambda: run_rx(xd, td))
        ms_step = cuda_ms(lambda: pipe.step(xd, td))
    n_win = xd.shape[0] * xd.shape[1]
    print(f"sharded_rx and multichip_step on the headline batch "
          f"[{xd.shape[0]} x {xd.shape[1]}]: bits == RxPipeline.step's, "
          f"n_ok {int(mc['n_ok'])}; launches {got} / {got_mc}; sharded_rx "
          f"{ms_rx:.4f} ms ({n_win / (ms_rx * 1e-3):.6g} samples/s), the "
          f"step {ms_step:.4f} ms {tag}")
    mcap_l, offs, mod_l, pp_l, w_l, mpdu_l = mesh_capture()
    reset()
    with torch.inference_mode():
        out = sharded_capture_decode(mesh, mod_l, pp_l.n_sym, w_l)(
            torch.from_numpy(c2r(mcap_l)).to(dev))
        torch.cuda.synchronize()
    got = read(launches)
    check(got["viterbi"] > 0 and got["slice"] > 0
          and got["slice_shared"] > 0,
          f"sharded_capture_decode launches {got}")
    srx = SisoReceiver(device=dev)
    for r, row in enumerate(offs):
        pk = loop_mpdus(out, r, pp_l.psdu_len)
        trig = out["trig_t"][r][out["ok"][r]].cpu().numpy()
        check([m for _, _, m in pk] == [[mpdu_l]] * len(row)
              and len(trig) == len(row)
              and np.all(np.abs(trig - np.asarray(row)) < 40),
              f"sharded_capture_decode row {r}: packets at {row}")
        check([m for _, _, m in pk] == [p.mpdus for p in srx.decode_capture(
            mcap_l[r]) if p.fcs_ok],
              f"sharded_capture_decode row {r} == SisoReceiver")
    print(f"sharded_capture_decode (L MCS7, 2 rows x {mcap_l.shape[1]}): "
          f"every packet decodes to the exact MPDU, triggers within 40 of "
          f"their offsets, == SisoReceiver.decode_capture; launches {got}")

    # -- 28. sharded_capture_decode_auto on a stream capture -----------------
    ht = max(ppdu_params_nonaggregate(Mod(F.HT, 5), len(m)).n_sym
             for m in api_mpdus[0::2])
    vht = max(ppdu_params_aggregate(Mod(F.VHT, 7), len(aggregate_vht(
        [m]))).n_sym for m in api_mpdus[1::2])
    branches = ((Mod(F.HT, 5), ht), (Mod(F.VHT, 7), vht))
    # the generic decoder cuts its DATA at the VHT offset from every
    # window: a window shorter than its capacity clips that cut's start
    # and decodes garbage (the JAX loop checks only the branches' lengths)
    w = max([branch_window_len(m, c) for m, c in branches]
            + [GenericSisoDecoder(((F.HT, 5), (F.VHT, 7)), max(ht, vht),
                                  device="cpu").window_capacity()])
    srx = SisoReceiver(device=dev)
    want = [r.mpdus for r in srx.decode_capture(loop_cap) if r.fcs_ok]
    check(len(want) == N_API * N_COPY, f"SisoReceiver: {len(want)} packets")
    rx_ms = host_ms(lambda: srx.decode_capture(loop_cap))
    n_samp = len(loop_cap)
    print(f"auto loop capture: {n_samp} samples, {len(want)} packets, "
          f"branches HT5 x {ht} and VHT7 x {vht} symbols, window {w}, "
          f"k_per_shard {LOOP_K}; SisoReceiver.decode_capture on it "
          f"{rx_ms:.4f} ms (median of 3), {n_samp / (rx_ms * 1e-3):.6g} "
          f"samples/s {tag}")
    x = torch.from_numpy(c2r(loop_cap)[None]).to(dev)
    for generic in (False, True):
        what = ("sharded_capture_decode_auto"
                + (" generic=True" if generic else " (branch loop)"))
        run = sharded_capture_decode_auto(mesh, branches, w,
                                          k_per_shard=LOOP_K,
                                          generic=generic)
        out, line, ms = loop_call(run, x, what, siso_kernels, launches, dev)
        pk = loop_mpdus(out)
        check(not bool(out["overflow"].any()), f"{what}: no overflow")
        check([m for _, _, m in pk] == want,
              f"{what}: {len(pk)}/{len(want)} packets == SisoReceiver's")
        print(f"{what}: {len(pk)}/{len(want)} packets with a good FCS, == "
              f"SisoReceiver.decode_capture, no overflow; "
              f"{n_samp / (ms * 1e-3):.6g} samples/s; {line} {tag}")
        del run, out
    del x

    # -- 29. sharded_capture_decode_auto2 on a dual-chain stream capture -----
    caps2 = {}
    for mod, mp in mseg:
        n = ppdu_params_aggregate(mod, len(aggregate_vht([mp]))).n_sym
        caps2[mod] = max(caps2.get(mod, 0), n)
    branches2 = tuple(caps2.items())
    w2 = max(272 + (MimoDataDecoder(m, c) if m.nSS == 2 else MrcDataDecoder(
        m, c)).data_offset() + c * 80 + 80 for m, c in branches2)
    mrx = MimoReceiver(device=dev)
    want2 = [r.mpdus for r in mrx.decode_capture(loop_mcap) if r.fcs_ok]
    check(len(want2) == mwant, f"MimoReceiver: {len(want2)} packets")
    mrx_ms = host_ms(lambda: mrx.decode_capture(loop_mcap))
    n_samp2 = loop_mcap.shape[1]
    print(f"auto2 loop capture: 2 x {n_samp2} samples, {len(want2)} "
          f"packets, branches "
          f"{', '.join(f'{m.fmt.name}{m.mcs} nSS {m.nSS} x {c}' for m, c in branches2)}"
          f" symbols, window {w2}, k_per_shard {LOOP2_K}; "
          f"MimoReceiver('auto').decode_capture on it {mrx_ms:.4f} ms "
          f"(median of 3), {n_samp2 / (mrx_ms * 1e-3):.6g} samples/s per "
          f"chain {tag}")
    x = torch.from_numpy(c2r(loop_mcap)[None]).to(dev)
    for cap_b in (None, LOOP2_CAP):
        what = f"sharded_capture_decode_auto2 branch_cap={cap_b}"
        run = sharded_capture_decode_auto2(mesh, branches2, w2,
                                           k_per_shard=LOOP2_K,
                                           branch_cap=cap_b)
        out, line, ms = loop_call(run, x, what, mimo_kernels, launches, dev)
        pk = loop_mpdus(out)
        check(not bool(out["overflow"].any())
              and not bool(out["branch_overflow"].any()),
              f"{what}: no overflow")
        check([m for _, _, m in pk] == want2,
              f"{what}: {len(pk)}/{len(want2)} packets == MimoReceiver's")
        print(f"{what}: {len(pk)}/{len(want2)} packets with a good FCS, == "
              f"MimoReceiver('auto'), no overflow; "
              f"{n_samp2 / (ms * 1e-3):.6g} samples/s per chain; {line} "
              f"{tag}")
        del run, out
    del x

    # -- 30. the loop's envelope ---------------------------------------------
    est = port_entry.envelope_captures(1)[0]
    ecap, empdu = est.capture, port_entry.example_mpdu()
    reset()
    with torch.inference_mode():
        out = est.run(mesh)(torch.from_numpy(c2r(ecap)).to(dev))
        torch.cuda.synchronize()
    got = read(launches)
    check(all(got[k] > 0 for k in mimo_kernels), f"envelope launches {got}")
    pk = loop_mpdus(out)
    check(not bool(out["overflow"].any())
          and not bool(out["branch_overflow"].any())
          and sorted(f for _, f, _ in pk) == [0, 1, 2]
          and all(m == [empdu] for _, _, m in pk)
          and sorted(int(out["nss"][0, j]) for j, _, _ in pk) == [1, 1, 2],
          "envelope: L, VHT, HT 2x2")
    n_ndp = 0
    for j in np.flatnonzero(out["ndp"][0].cpu().numpy()):
        iq = out["ndp_ltf"][0, j, 0].cpu().numpy()
        iq = iq[:, 0] + 1j * iq[:, 1]
        est = ndp_ltf_channel(np.concatenate([iq[8:72], iq[88:152]]),
                              n_sts=2)
        n_ndp += bool(np.all(np.isfinite(est)) and np.abs(est).max() > 1e-3)
    check(n_ndp == 1, f"envelope: {n_ndp} NDPs give a channel")
    print(f"envelope (dryrun_multichip's first capture, 2 x "
          f"{ecap.shape[2]}): L "
          f"MCS7, VHT MCS7 A-MPDU, HT MCS12 2x2 decode to the exact MPDU, "
          f"the NDP's LTFs give ndp_ltf_channel; launches {got}")
    mcap_mu, br_su, br_mu, w_mu, mpdu0, mpdu_su = mu_loop_capture()
    for cap_b in (None, 4):
        reset()
        with torch.inference_mode():
            out = sharded_capture_decode_auto2(
                mesh, br_su, w_mu, k_per_shard=4, branch_cap=cap_b,
                mu_branches=br_mu, mu_pos=0, mu_gid=MU_GID)(
                    torch.from_numpy(c2r(mcap_mu)).to(dev))
            torch.cuda.synchronize()
        got = read(launches)
        check(all(got[k] > 0 for k in mimo_kernels), f"MU loop {got}")
        for r in range(2):
            pk = loop_mpdus(out, r)
            check([(bool(out["mu"][r, j]), m) for j, _, m in pk]
                  == [(True, [mpdu0]), (False, [mpdu_su])],
                  f"MU loop (branch_cap={cap_b}) row {r}")
        print(f"MU branch (branch_cap={cap_b}, 2 rows x 2 x "
              f"{mcap_mu.shape[2]}): station 0's MPDU from the MU PPDU and "
              f"the SU A-MPDU in each row; launches {got}")
    wcap, wmod, wn, ww, wmpdu = wideband_loop_capture()
    reset()
    with torch.inference_mode():
        out = sharded_capture_decode_auto(mesh, ((wmod, wn),), ww,
                                          k_per_shard=4, q=4)(
            torch.from_numpy(c2r(wcap)).to(dev))
        torch.cuda.synchronize()
    got = read(launches)
    check(all(got[k] > 0 for k in siso_kernels), f"80 MHz loop {got}")
    check(all([m for _, _, m in loop_mpdus(out, r)] == [[wmpdu]]
              for r in range(2)), "80 MHz loop: one VHT9 packet per row")
    print(f"80 MHz (2 rows x {wcap.shape[1]}, q = 4): the VHT MCS9 A-MPDU "
          f"decodes in each row; launches {got}")

    # -- 31. perf.scaling on one rank ----------------------------------------
    reset()
    rates = measure_scaling(device=dev)
    got = read(launches)
    check(list(rates) == [1] and rates[1] > 0
          and got["viterbi"] > 0 and got["slice"] > 0,
          f"measure_scaling: {rates}, launches {got}")
    print(f"measure_scaling on one rank (sharded_rx, L MCS7, batch 256, "
          f"median of 5 on CUDA events): {{1: {rates[1]:.6g}}} samples/s; "
          f"N >= 2 is not measurable on one card; launches {got} {tag}")


def entry_phase(dev, tag: str, launches: dict) -> None:
    """Phase 36: `entry()` as a caller of the package calls it, on the card (against the
    port's CPU run of the same batch), and `dryrun_multichip(1)` on the
    1-rank NCCL group of phase 27; then each dryrun stage on its own, its
    launches and its call time. Launch counts add into `launches`."""
    mpdu = port_entry.example_mpdu()
    fn, args = port_entry.entry()
    check(all(a.device == dev for a in args), f"entry() inputs on {dev}")
    reset()
    with torch.inference_mode():
        out = fn(*args)
        torch.cuda.synchronize()
    got = read(launches)
    check(got["viterbi"] > 0 and got["slice"] > 0, f"entry() launches {got}")
    n = len(args[1])
    rows = loop_mpdus({"ok": torch.ones(1, n, dtype=torch.bool),
                       "bits": out["bits"][None]}, psdu_len=len(mpdu))
    check(bool(out["lsig_ok"].all())
          and [m for _, _, m in rows] == [[mpdu]] * n,
          f"entry(): {n}/{n} lsig_ok and the exact MPDU in every row")
    cfn, cargs = port_entry.entry(device="cpu")
    with torch.inference_mode():
        ref = cfn(*cargs)
        ms = cuda_ms(lambda: fn(*args), iters=LOOP_ITERS, warmup=1)
    check(all(torch.equal(out[k].cpu(), ref[k])
              for k in ("bits", "ltf_start", "lsig_ok")),
          "entry(): bits, ltf_start, lsig_ok == the port's CPU run")
    print(f"entry() (L MCS7, {n} packets [{n} x {args[0].shape[1]}]): "
          f"{n}/{n} lsig_ok, the exact MPDU in every row, == the port's CPU "
          f"run; launches {got}; step {ms:.4f} ms per call (CUDA events, "
          f"median of {LOOP_ITERS}) {tag}")

    reset()
    t = time.perf_counter()
    res = port_entry.dryrun_multichip(1, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    got = read(launches)
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          "dryrun_multichip(1) on the 1-rank NCCL group of phase 27")
    check(res["counts"] == {"mixed": 3, "ndp": 1, "mu": 1, "wideband": 1},
          f"dryrun_multichip(1): counts {res['counts']}")
    check(all(got[k] > 0 for k in ("viterbi", "slice", "slice_multi")),
          f"dryrun_multichip(1) launches {got}")
    print(f"dryrun_multichip(1): counts {res['counts']}; launches {got}; "
          f"{wall:.2f} s of wall time, captures and first calls included")
    mesh = make_phy_mesh(1, device=dev)
    for st in port_entry.envelope_captures(1):
        run = st.run(mesh)
        x = c2r(st.capture)            # a numpy capture, as the dryrun
        reset()
        with torch.inference_mode():
            out = run(x)
            torch.cuda.synchronize()
        got = read(launches)
        check(got["viterbi"] > 0 and got["slice_multi"] > 0,
              f"dryrun stage {st.name} launches {got}")
        counts = port_entry.stage_counts(st, out)
        check(all(counts[k] == res["counts"][k] for k in counts),
              f"dryrun stage {st.name}: {counts}")
        with torch.inference_mode():
            ms = cuda_ms(lambda: run(x), iters=LOOP_ITERS, warmup=1)
        print(f"dryrun stage {st.name} [1 x 2 x {st.capture.shape[2]}], "
              f"window {st.window}: {counts}; launches {got}; "
              f"{ms:.4f} ms per call (CUDA events, median of {LOOP_ITERS}, "
              f"the numpy capture's upload inside) {tag}")


def multicard_phase(tag: str, launches: dict) -> None:
    """Phase 37: `perf.multicard.run` as its 1-rank pass runs, on the 1-rank
    NCCL group of phase 27: every loop once on a 1-rank mesh, held to the
    packets planted, and timed. Launch counts add into `launches`."""
    reset()
    res = multicard.run(emit=lambda line: None)
    got = read(launches)
    lines = res["lines"]
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          "perf.multicard on the 1-rank NCCL group of phase 27")
    check([ln["loop"] for ln in lines] == list(multicard.LOOPS)
          and all(ln["mesh"] == [1, 1] for ln in lines),
          f"perf.multicard: every loop on a 1-rank mesh {lines}")
    check(all(ln["launches"][0]["viterbi"] > 0 for ln in lines[1:])
          and all(got[k] > 0 for k in ("viterbi", "slice", "slice_shared",
                                       "slice_multi")),
          f"perf.multicard launches {got}")
    for ln in lines:
        print(f"multicard {ln['loop']} on one rank: {ln['ms']:.4f} ms per "
              f"call, {ln['samples_per_s']:.6g} samples/s; launches "
              f"{ln['launches'][0]} {tag}")


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
    mu_mod, mu_bucket, mu_rows, mu_sigb_len, mu_data_len = mu_stream_shapes()
    t = time.perf_counter()
    sweep_calls = sweep_kernel_inputs(dev)
    torch.cuda.synchronize()
    print(f"acceptance sweep's kernel inputs: {len(sweep_calls)} points "
          f"recorded in {time.perf_counter() - t:.2f} s")

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
            ("mimo_ht15_40", 4, 17280, CR.CR56, 15),
            # the MU lanes': a SIG-B group of the MU stream (its 300 MU
            # windows padded) and its DATA bucket (VHT MCS4)
            ("mu_sigb26", mu_rows, 26, CR.CR12, 16),
            ("mu_data", mu_rows, mu_bucket * mu_mod.nDBPS, mu_mod.cr, 17)]:
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
    # LLRs that are not finite or not below 1e30 (a junk window's, e.g. one
    # whose channel estimate divided by zero): the kernel orders NaN as the
    # plain version's torch.max does
    x, cr, n_bits = vit_inputs["data"]
    odd = x.clone()
    rng = np.random.default_rng(18)
    for r, val in enumerate([np.nan] * 16 + [np.inf] * 16 + [-np.inf] * 16
                            + [3e38] * 8 + [1e30] * 8):
        odd[r, rng.integers(0, odd.shape[1], 1 + r % 3)] = val
    got = coding.viterbi_decode(odd, cr, n_bits, w0, w1)
    ref = coding.viterbi_decode_plain(odd, cr, n_bits, w0, w1)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), "viterbi kernel == plain on non-finite LLRs")
    n_moved = int((got != coding.viterbi_decode(x, cr, n_bits, w0, w1))
                  .any(dim=1).sum())
    print(f"viterbi data with 64 rows of NaN / +-inf / 3e38 / 1e30 LLRs: "
          f"kernel == plain ({n_moved} of those rows decode otherwise)")
    # what the acceptance sweep handed the kernel, as it was: L-SIG, SIG and
    # DATA pairs [100 x T, 2] of every recorded row and point
    for name, snr, calls in sweep_calls:
        seen = check_recorded([c for c in calls if c[0] == "viterbi"],
                              f"{name} at {snr:.0f} dB")
        check("viterbi" in seen, f"{name}: the sweep launched the Viterbi")
        vit_err = max(vit_err, int(seen["viterbi"][1]))
        print(f"viterbi sweep {name} at {snr:.0f} dB, pairs "
              f"[{'], ['.join(sorted(seen['viterbi'][2]))}]: kernel == plain")

    # -- 4. slice kernel vs plain --------------------------------------------
    slice_err = 0.0
    rng = np.random.default_rng(9)
    # (windows, samples, length, start dtype): odd and even lengths and
    # row strides, full-length windows, starts past both ends
    for b, n, length, dt in [(66, 2321, 2080, torch.int32),
                             (1024, 2320, 448, torch.int32),
                             (1024, 2320, 2080, torch.int32),
                             (1024, 2320, 2080, torch.int64),
                             (67, 2321, 2079, torch.int32),
                             (5, 300, 300, torch.int64),
                             (33, 701, 1, torch.int32),
                             (70000, 37, 35, torch.int64)]:
        x2 = torch.from_numpy(rng.standard_normal((b, n, 2))
                              .astype(np.float32)).to(dev)
        st = np.concatenate([[0, n - length, -7, n],
                             rng.integers(-3, n - length + 4, b - 4)])
        st = torch.from_numpy(st).to(dev, dt)
        got = sync.batch_slice_iq(x2, st, length)
        ref = sync.batch_slice_iq_plain(x2, st, length)
        torch.cuda.synchronize()
        slice_err = max(slice_err, float((got - ref).abs().max()))
        check(torch.equal(got, ref), f"slice kernel == plain ({b}, {n}, "
                                     f"{length}, {dt})")
        print(f"slice [{b} x {n} -> {length}], {dt} starts: kernel == "
              f"plain")
    # the windows the acceptance sweep cut, as it cut them: per chain at
    # 20, 40 and 80 MHz
    for name, snr, calls in sweep_calls:
        seen = check_recorded([c for c in calls if c[0] == "slice"],
                              f"{name} at {snr:.0f} dB")
        check("slice" in seen, f"{name}: the sweep launched the slice")
        slice_err = max(slice_err, seen["slice"][1])
        print(f"slice sweep {name} at {snr:.0f} dB "
              f"[{'], ['.join(sorted(seen['slice'][2]))}]: kernel == plain")
    del sweep_calls

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
    # the step's CUDA graph: captured on the second call, replayed on the
    # second and third, each replay equal to the eager first call
    with torch.inference_mode():
        for bw, (cell, pipe, x2, t0, _) in rows.items():
            xd, td = torch.from_numpy(x2).to(dev), torch.from_numpy(t0).to(dev)
            caps, reps = pipeline.GRAPH_CAPTURES, pipeline.GRAPH_REPLAYS
            second = pipe.step(xd, td)
            torch.cuda.synchronize()
            check((pipeline.GRAPH_CAPTURES - caps,
                   pipeline.GRAPH_REPLAYS - reps) == (1, 1),
                  f"{bw} MHz step: the second call captured and replayed")
            before = (kv.LAUNCHES, kg.LAUNCHES, pipeline.GRAPH_REPLAYS)
            third = pipe.step(xd, td)
            torch.cuda.synchronize()
            check((kv.LAUNCHES, kg.LAUNCHES, pipeline.GRAPH_REPLAYS)
                  == (before[0], before[1], before[2] + 1),
                  f"{bw} MHz step: one replay, no wrapper call")
            for out in (second, third):
                check(list(out) == list(outs[bw])
                      and all(torch.equal(out[k], outs[bw][k]) for k in out),
                      f"{bw} MHz step: replay == eager call")
            print(f"{bw} MHz step graph: captured once, 2 replays equal to "
                  f"the eager call (bits, ltf_start, cfo, snr, lsig_ok)")

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
        t = {"ms": cuda_ms(kernel), "host_us": host_us(kernel),
             "device_ms": device_ms(kernel), "plain_ms": cuda_ms(plain),
             "library_ms": None}
        t["bound_ms"], t["bound_by"] = bound(nbytes, ops)
        lib = ""
        if library is not None:
            # the kernel's call and the library's in turns, one of each per
            # round: their comparison sees the same host and card
            t["ms"], t["library_ms"] = cuda_ms_turns([kernel, library])
            t["library_host_us"] = host_us(library)
            t["library_device_ms"] = device_ms(library)
            lib = (f", library {t['library_ms']:.4f} ms (issue "
                   f"{t['library_host_us']:.2f} us, device "
                   f"{t['library_device_ms']:.4f} ms)")
        times[key] = t
        print(f"time {key} {shape}: kernel {t['ms']:.4f} ms (issue "
              f"{t['host_us']:.2f} us, device {t['device_ms']:.4f} ms, "
              f"{t['bound_ms'] / t['device_ms']:.3f} of the bound), plain "
              f"{t['plain_ms']:.4f} ms{lib}, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}) {tag}")

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
    check(probe["device_ms"] < probe["viterbi_device_ms"],
          "the probe, the Viterbi's skeleton, is faster than the Viterbi")

    # -- 9. shared-source slice kernel vs plain ------------------------------
    rng = np.random.default_rng(12)
    n_cap = 1 << 22
    cap_dev = torch.from_numpy(rng.standard_normal((n_cap, 2))
                               .astype(np.float32)).to(dev)
    sig_len = (receiver.SIGPARSE_WIN + 320)
    data_len = receiver.SisoDataDecoder(Mod(F.VHT, 7), 48).zlen()
    shared_err = 0.0
    for what, length in (("sig", sig_len), ("data", data_len),
                         ("mu_sigb", mu_sigb_len), ("mu_data", mu_data_len)):
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
    # odd lengths (rows that start 8 bytes off 16), int64 starts, starts
    # past both ends
    for length, dt in ((1071, torch.int64), (4559, torch.int32),
                       (1, torch.int64)):
        st = torch.from_numpy(rng.integers(-5, n_cap - length + 6, 1000)).to(
            dev, dt)
        got = kg.capture_slice_iq_cuda(cap_dev, st, length)
        ref = receiver.capture_windows_plain(cap_dev, st, length)
        torch.cuda.synchronize()
        shared_err = max(shared_err, float((got - ref).abs().max()))
        check(torch.equal(got, ref), f"shared slice kernel == plain "
                                     f"({length}, {dt})")
        print(f"slice_shared [{n_cap} -> 1000 x {length}], {dt} starts: "
              f"kernel == plain")
    del cap_dev

    # the SISO receiver's windows come from a one-chain capture, the
    # dual-chain receiver's from the [2, N] capture
    siso_kernels = ("viterbi", "slice", "slice_shared")
    mimo_kernels = ("viterbi", "slice", "slice_multi")

    # -- 10. decode_capture on bench.py's 20-packet capture ------------------
    api_cap, api_mpdus = bench.api_capture(bench.FULL)
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
    caps = bench.stream_captures(bench.FULL)
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
    loop_cap = caps[0]    # the sharded loop's capture (phases 27-28)
    del caps, rx_h, rx_d

    # -- 13. multi-chain slice kernel vs plain -------------------------------
    rng = np.random.default_rng(13)
    cap_dev = torch.from_numpy(rng.standard_normal((2, n_cap, 2))
                               .astype(np.float32)).to(dev)
    mimo_len = get_mimo_decoder(Mod(F.VHT, 4, BW.BW20, 2), 16).zlen()
    multi_err = 0.0
    for what, length in (("sig", sig_len), ("data", mimo_len),
                         ("mu_sigb", mu_sigb_len), ("mu_data", mu_data_len)):
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
    for length, dt in ((1071, torch.int64), (1999, torch.int32),
                       (1, torch.int64)):
        st = torch.from_numpy(rng.integers(-5, n_cap - length + 6, 1000)).to(
            dev, dt)
        got = kg.capture_slice_iq_mimo_cuda(cap_dev, st, length)
        ref = receiver.capture_windows_mimo_plain(cap_dev, st, length)
        torch.cuda.synchronize()
        multi_err = max(multi_err, float((got - ref).abs().max()))
        check(torch.equal(got, ref), f"multi-chain slice kernel == plain "
                                     f"({length}, {dt})")
        print(f"slice_multi [2 x {n_cap} -> 1000 x 2 x {length}], {dt} "
              f"starts: kernel == plain")
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
    mcaps, mwant, mseg = bench.mimo_stream_captures(bench.FULL)
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
    loop_mcap = mcaps[0]  # the dual-chain loop's (phase 29)
    del mcaps, mrxs

    # -- 18. TxPipeline -------------------------------------------------------
    for name, mod, pp, data, want in tx_cases():
        txp = TxPipeline(mod, pp, device=dev)
        psdu = bench.rows_on(data, 1024, dev)
        with torch.inference_mode():
            out = txp.step(psdu)
            err = bench.tx_err(out, want)
            check(tuple(out.shape) == (1024, mod.nSS, txp.n_samp, 2)
                  and txp.n_samp == want.shape[-1] and err <= TX_TOL,
                  f"TX {name}: [1024] rows == golden within {TX_TOL}")
            ms = cuda_ms(lambda: txp.step(psdu))
        print(f"TX {name} [1024 x {len(data)} B -> {mod.nSS} x "
              f"{txp.n_samp}]: every row == golden TX, max |err| {err:.3g}; "
              f"{ms:.4f} ms, {1024 * txp.n_samp / (ms * 1e-3):.6g} samples/s "
              f"per stream {tag}")

    # -- 19. MuTxPipeline -----------------------------------------------------
    mods, ampdus, qm, mu_wave = bench.mu_tx_input()
    mtx = MuTxPipeline(list(mods), [len(a) for a in ampdus], device=dev)
    psdus = [bench.rows_on(a, 256, dev) for a in ampdus]
    q2 = torch.from_numpy(c2r(qm.astype(np.complex64))).to(dev)
    with torch.inference_mode():
        out = mtx.step(psdus, q2)
        err = bench.tx_err(out, mu_wave)
        check(tuple(out.shape) == (256, 2, mtx.n_samp, 2) and err <= TX_TOL,
              f"MU TX: [256] rows == gen_ampdu_mu within {TX_TOL}")
        ms = cuda_ms(lambda: mtx.step(psdus, q2))
    print(f"MU TX VHT MCS4 + MCS2 (500 B / 300 B, random unitary Q) [256 -> "
          f"2 x {mtx.n_samp}]: every row == gen_ampdu_mu, max |err| "
          f"{err:.3g}; {ms:.4f} ms, {256 * 2 * mtx.n_samp / (ms * 1e-3):.6g} "
          f"samples/s over both chains {tag}")

    # -- 20. the MU-MIMO closed loop on the card -----------------------------
    for n_user, mcss in ((2, (2, 2)), (4, (0, 1, 2, 0))):
        reset()
        res, mpdus = closed_loop(n_user, mcss, dev)
        torch.cuda.synchronize()
        got = read(launches)
        for u, r in enumerate(res):
            check(len(r) == 1 and r[0].fcs_ok and r[0].mu is False
                  and r[0].mcs == mcss[u] and r[0].mpdus == [mpdus[u]],
                  f"{n_user}-user closed loop: station {u} decodes its MPDU")
        check(all(got[k] > 0 for k in siso_kernels),
              f"{n_user}-user closed loop launched every kernel {got}")
        print(f"closed loop, {n_user} users (NDP -> sta_capture_ndp -> "
              f"feedback -> ZF Q -> MuTxPipeline -> sta_decode_mu): "
              f"{n_user}/{n_user} stations recover their exact MPDU; "
              f"launches {got}")

    # -- 21. MuStaDecoder at batch 256 ---------------------------------------
    smod, s_nsym, s_len, x4, s_mpdu = bench.mu_sta_input()
    dec4 = sounding.MuStaDecoder(smod, s_nsym, s_len, 0).to(dev)
    band = receiver.SigTables(1).to(dev).band
    x4d = torch.from_numpy(np.tile(c2r(x4)[None], (256, 1, 1))).to(dev)
    t4d = torch.zeros(256, dtype=torch.int32, device=dev)

    def sta_step():
        ls4, cf4, _ = sync.sync_front_iq(x4d, t4d, band)
        return dec4(x4d, ls4, cf4)

    with torch.inference_mode():
        reset()
        bits = sta_step().cpu().numpy().astype(np.uint8)
        got = read(launches)
        n_ok = 0
        for row in bits:
            subs = deaggregate_vht(np.packbits(
                row[16:16 + s_len * 8], bitorder="little").tobytes())
            n_ok += bool(subs and subs[0].fcs_ok and subs[0].mpdu == s_mpdu)
        check(n_ok == 256 and got["viterbi"] > 0,
              f"MuStaDecoder: {n_ok}/256 rows decode station 0's MPDU")
        ms = cuda_ms(sta_step)
    print(f"MuStaDecoder VHT MCS4 [256 x {len(x4)}]: 256/256 rows decode "
          f"the exact MPDU with a good FCS; launches {got}; {ms:.4f} ms, "
          f"{256 * len(x4) / (ms * 1e-3):.6g} samples/s {tag}")

    # -- 22. the MU stream ---------------------------------------------------
    mu_caps, want_mu, want_su = bench.mu_stream_captures(bench.FULL)
    mu_total = sum(len(c) for c in mu_caps)
    murx = SisoReceiver(mu_pos=0, mu_gid=MU_GID, device=dev)

    def mu_gate(stream, what):
        for k, res in enumerate(stream):
            mu = [r.mpdus for r in res if r.mu and r.fcs_ok]
            su = [r.mpdus for r in res if not r.mu and r.fcs_ok]
            check(mu == [[m] for m in want_mu] and su == [[m] for m in want_su]
                  and len(res) == len(want_mu) + len(want_su),
                  f"{what}: capture {k}: {len(mu)}/{len(want_mu)} MU, "
                  f"{len(su)}/{len(want_su)} SU packets")

    # a warm pass builds the MU decoders (moving their tables to the card
    # synchronizes); then the counted one
    mu_gate(counted_pass(murx, mu_caps)[0], "MU stream, warm")
    reset()
    stream, waits, implicit = counted_pass(murx, mu_caps)
    got = read(launches)
    mu_gate(stream, "MU stream")
    check(implicit == 0, f"MU stream: {implicit} implicit syncs")
    per_cap = []
    for k, c in enumerate(mu_caps):
        reset()
        murx.decode_captures([c])
        torch.cuda.synchronize()
        per_cap.append(read())
        check(all(per_cap[-1][n] > 0 for n in siso_kernels),
              f"MU stream capture {k} launched every kernel {per_cap[-1]}")
    best, dts, n_pk = best_of_3(murx, mu_caps)
    # the card's busy time in one more pass (torch.profiler's device
    # events), over the best pass's wall time: the device's share
    busy_ms = kernels_ms(lambda: murx.decode_captures(mu_caps), iters=1,
                         warmup=0)
    busy = ("not measured" if busy_ms is None else
            f"{busy_ms:.4f} ms per pass, {busy_ms / (best * 1e3):.4f} of "
            f"the best pass")
    print(f"MU stream: {N_MU_CAP} captures of {len(mu_caps[0])}-"
          f"{len(mu_caps[-1])} samples, {len(want_mu)}/{len(want_mu)} MU and "
          f"{len(want_su)}/{len(want_su)} SU packets with a good FCS in "
          f"each; launches {got}; per capture {per_cap[0]}; host waits on "
          f"the device per capture {waits:.4g}, implicit syncs {implicit}")
    print(f"time MU stream: best of 3 {best:.4f} s (runs "
          f"{', '.join(f'{d:.4f}' for d in dts)}): "
          f"{mu_total / best:.6g} samples/s, {n_pk / best:.6g} packets/s; "
          f"device busy {busy} {tag}")
    del mu_caps, murx

    # -- 23. MimoReceiver with an MU group -----------------------------------
    for fs, dcap, m0, su in mu_dual_chain_captures():
        what = f"dual-chain MU {fs / 1e6:.0f} MHz"
        reset()
        pkts, _ = MimoReceiver(sample_rate_hz=fs, mu_pos=0, mu_gid=MU_GID,
                               device=dev).decode_capture_full(dcap)
        torch.cuda.synchronize()
        got = read(launches)
        check(all(got[k] > 0 for k in mimo_kernels),
              f"{what} launched every kernel of its path {got}")
        check([r.mpdus for r in pkts if r.mu and r.fcs_ok] == [[m0]]
              and [r.mpdus for r in pkts if not r.mu and r.fcs_ok]
              == [[m] for m in su], f"{what}: every packet decodes")
        ref, _ = MimoReceiver(sample_rate_hz=fs, mu_pos=0, mu_gid=MU_GID,
                              device="cpu").decode_capture_full(dcap)
        print(f"{what}: the MU packet (MRC over 2 chains) and {len(su)} 2x2 "
              f"SU packet(s) decode; launches {got}; vs CPU run: fields "
              f"equal, " + check_same_packets(pkts, ref, what,
                                               evm_tol=EVM_TOL))

    # -- 24. PhyService's sounding loop --------------------------------------
    reset()
    ndp_recs, mu_recs, svc_mpdus = sounding_loop(dev)
    torch.cuda.synchronize()
    got = read(launches)
    c_ndp, c_mu, _ = sounding_loop("cpu")
    check(mu_recs == c_mu and [[wire.unpack_rx_record(r).payload
                                for r in recs] for recs in mu_recs]
          == [[m] for m in svc_mpdus],
          "PhyService: MU data records == CPU run, one MPDU per station")
    d_rep = 0.0
    for a, b in zip(ndp_recs, c_ndp):
        check(len(a) == len(b) == 1 and a[0][:3] == b[0][:3],
              "PhyService: one channel report per station, header == CPU")
        d_rep = max(d_rep, float(np.abs(wire.unpack_rx_record(a[0]).ltf_iq
                                        - wire.unpack_rx_record(b[0]).ltf_iq)
                                 .max()))
    check(d_rep <= NDP_TOL and all(got[k] > 0 for k in siso_kernels),
          f"PhyService: channel reports within {NDP_TOL} of CPU, launches")
    print(f"PhyService sounding loop: 2 channel reports (|d| {d_rep:.3g} vs "
          f"CPU run), BFQ, MU request; each station's data records "
          f"byte-identical to the CPU run; launches {got}")

    # -- 25. the acceptance sweep, cut ---------------------------------------
    def quiet(msg):
        del msg

    acc_pkts, acc_wall, curves = 0, 0.0, {}
    for group, build_fn, pipe_cls, (fmt, mcs), chan, top in acceptance_rows():
        name = f"{group}/{fmt.name}{mcs}"
        reset()
        t = time.perf_counter()
        curve = acc._sweep_curves(build_fn, pipe_cls, [(fmt, mcs)],
                                  [0.0, top], ACC_NPKT, ACC_PAYLOAD, 0,
                                  quiet, chan=chan, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        got = read(launches)
        curves[name] = curve = curve[f"{fmt.name}{mcs}"]
        acc_pkts += 2 * ACC_NPKT
        acc_wall += dt
        check(got["viterbi"] > 0 and got["slice"] > 0,
              f"acceptance {name}: Viterbi and slice launches {got}")
        # one more point of the row alone: its implicit syncs, its wall
        # time and its packed step's time
        row = pdr._prepare_row(build_fn, pipe_cls, fmt, mcs, ACC_NPKT,
                               ACC_PAYLOAD, 0, chan, dev)
        gen = pdr.noise_generator(1, dev)
        _, implicit = counted(lambda: row.n_ok(gen, pdr.noise_amp_at(top)))
        walls = []
        for _ in range(3):
            t = time.perf_counter()
            row.n_ok(gen, pdr.noise_amp_at(top))
            walls.append((time.perf_counter() - t) * 1e3)
        step_ms = cuda_ms(lambda: row.packed(gen, pdr.noise_amp_at(top)))
        print(f"acceptance {name} [{ACC_NPKT} x "
              f"{'x'.join(map(str, row.xd.shape[1:]))}]: PDR {curve[0]} at "
              f"0 dB, {curve[1]} at {top:.0f} dB; launches {got}; {dt:.4f} s "
              f"for 2 points; one point {np.median(walls):.4f} ms of wall "
              f"time (median of 3), its packed step {step_ms:.4f} ms (CUDA "
              f"events); implicit syncs per point {implicit} {tag}")
        check(implicit == 0, f"acceptance {name}: {implicit} implicit syncs")
        if group != "siso_fading_80_unweighted_llr":
            check(curve[1] == 1.0, f"acceptance {name}: PDR 1.0 at {top} dB")
    unw = curves["siso_fading_80_unweighted_llr/VHT7"]
    check(all(u <= w for u, w in zip(unw, curves["siso_fading_80/VHT7"])),
          "acceptance: unweighted VHT7 @80 no higher than weighted")
    reset()
    t = time.perf_counter()
    mu_curve = acc._mu_curves([0.0, 30.0], ACC_NPKT, ACC_PAYLOAD, 0, quiet,
                              mcs_list=(4,), device=dev)["MU_VHT4x2"]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    got = read(launches)
    acc_pkts += 2 * 2 * ACC_NPKT
    acc_wall += dt
    h_mu, q_mu = acc._mu_sounding(0, 2, dev)
    mu_rows = acc._mu_rows(4, 2, h_mu, q_mu, ACC_NPKT, ACC_PAYLOAD, 0, dev)
    gen = pdr.noise_generator(1, dev)
    _, implicit = counted(lambda: mu_rows[0].n_ok(
        gen, pdr.noise_amp_at(30.0)))
    print(f"acceptance mu_2user/MU_VHT4x2 [2 stations x {ACC_NPKT}]: PDR "
          f"{mu_curve[0]} at 0 dB, {mu_curve[1]} at 30 dB; launches {got}; "
          f"{dt:.4f} s for 2 points (sounding included); implicit syncs per "
          f"point {implicit} {tag}")
    check(mu_curve[1] == 1.0 and got["viterbi"] > 0 and got["slice"] > 0
          and implicit == 0, "acceptance mu_2user: PDR 1.0 at 30 dB, "
                             "launches, no implicit sync")
    print(f"time acceptance cut: {acc_pkts} packets in {acc_wall:.4f} s of "
          f"sweep, {acc_pkts / acc_wall:.6g} packets/s {tag}")
    # one numpy noise batch at 30 dB: the card's bytes == the CPU run's
    for build_fn, pipe_cls, (fmt, mcs) in (
            (pdr._build_packet, RxPipeline, (F.VHT, 7)),
            (pdr._build_mimo_packet, pdr.MimoRxPipeline, (F.HT, 8))):
        mod, pp, mpdu, wave = build_fn(fmt, mcs, ACC_PAYLOAD, 0)
        card, cpu = [], torch.device("cpu")
        for d in (dev, cpu):
            pipe = pipe_cls(mod, pp.n_sym, pp.psdu_len, device=d)
            x2 = pdr.noisy_batch(pdr.rx_window(wave, pipe.window_len()),
                                 ACC_NPKT, 30.0, 21)
            row = pdr._Row(pipe, torch.from_numpy(x2).to(d), mpdu,
                           fmt == F.VHT)
            card.append(pdr._fetch(row.packed(pdr.noise_generator(0, d),
                                              0.0)))
        n_ok = pdr._count_ok(card[0], pp.psdu_len, mpdu, fmt == F.VHT)
        check(np.array_equal(card[0], card[1]) and n_ok == ACC_NPKT,
              f"acceptance {fmt.name}{mcs} at 30 dB: card bytes == CPU run")
        print(f"acceptance {fmt.name}{mcs} ({pipe_cls.__name__}), one numpy "
              f"noise batch at 30 dB: {n_ok}/{ACC_NPKT} packets, bytes "
              f"[{ACC_NPKT} x {card[0].shape[1]}] on the card == the CPU "
              f"run's")
    # the ML detector's peak memory at its largest sweep shape
    row = pdr._prepare_row(pdr._build_mimo_packet_bw(BW.BW80),
                           pdr.MimoRxPipeline, F.VHT, 9, ACC_NPKT,
                           ACC_PAYLOAD, 0, None, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    n_ok = row.n_ok(pdr.noise_generator(0, dev), pdr.noise_amp_at(36.0))
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
    check(n_ok == ACC_NPKT, f"2x2 VHT9 80 MHz at 36 dB: {n_ok}/{ACC_NPKT}")
    print(f"acceptance 2x2 VHT9 80 MHz ML [{ACC_NPKT} x "
          f"{'x'.join(map(str, row.xd.shape[1:]))}]: {n_ok}/{ACC_NPKT} at "
          f"36 dB, peak device memory {peak:.1f} MiB above the batch {tag}")
    del row, mu_rows

    # -- 26. the examples on the card ----------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        paths = gen_test_captures.main(tmp)
        for path in paths:
            fs, want = EXAMPLE_BINS[os.path.basename(path)]
            reset()
            res = inspect_bin.main(path, fs, device=dev)
            torch.cuda.synchronize()
            got = read(launches)
            check([(r.fmt, r.mcs) for r in res] == want
                  and all(r.fcs_ok for r in res),
                  f"inspect_bin {os.path.basename(path)}: {want}, good FCS")
        res = MimoReceiver(device=dev).decode_capture(np.stack(
            [load_complex_bin(p) for p in paths if "Mimo" in p]))
        check([(r.fmt, r.mcs, r.fcs_ok) for r in res] == [(F.HT, 8, True)],
              "the generated 2x2 capture decodes on both chains")
    print(f"examples: gen_test_captures wrote {len(paths)} bins; inspect_bin "
          f"decoded every packet of them with a good FCS on the card (the "
          f"2x2 pair through MimoReceiver)")
    for dual in (False, True):
        reset()
        results = stream_decode.main(dual, device=dev)
        torch.cuda.synchronize()
        got = read(launches)
        mode = "slice_multi" if dual else "slice_shared"
        per = stream_decode.N_SEG * 30
        check(all(len(r) == per and all(p.fcs_ok for p in r)
                  and sum(p.mu for p in r) == per // 3 for r in results)
              and got[mode] > 0 and got["viterbi"] > 0,
              f"stream_decode (dual={dual}): every packet, MU included; "
              f"launches {got}")
        print(f"stream_decode{' --dual' if dual else ''}: {len(results)} x "
              f"{per}/{per} packets ({per // 3} MU each) with a good FCS; "
              f"launches {got}")
    reset()
    decoded = mu_sounding_demo.main(device=dev)
    got = read(launches)
    check(decoded == [[p] for p in mu_sounding_demo.PAYLOADS]
          and got["viterbi"] > 0,
          "mu_sounding_demo: each station prints its own payload")
    print(f"mu_sounding_demo: both stations decode their own payload; "
          f"launches {got}")

    # -- 27.-31. the sharded capture loop ------------------------------------
    cell, pipe, x2, t0, _ = rows[20]
    loop_phases(dev, tag, launches, (cell, pipe, x2, t0, outs[20]), loop_cap,
                api_mpdus, loop_mcap, mseg, mwant)

    # -- 32. the port's bench, one round -------------------------------------
    reset()
    t = time.perf_counter()
    line = bench.run(rounds=1, device=dev)
    got = read(launches)
    extra = line["extra"]
    by_det = extra["api_stream_mimo_sps_by_detector"]
    rates = [line["value"]] + list(by_det.values()) + [
        v for k, v in extra.items() if not isinstance(v, (str, dict))]
    check(tuple(extra) == bench.EXTRA_KEYS and extra["backend"] == "cuda"
          and set(by_det) == {"auto", "zf", "ml"} and min(rates) > 0,
          f"perf.bench: bench.py's keys, each > 0 ({line})")
    check(all(got[k] > 0 for k in ("viterbi", "slice", "slice_shared",
                                   "slice_multi")),
          f"perf.bench launched every receive kernel {got}")
    print(f"perf.bench, 1 round ({time.perf_counter() - t:.1f} s, every "
          f"row's every call gated): launches {got}")
    print(json.dumps(line))

    # -- 33. the step's stages and the TPU-era layouts ----------------------
    reset()
    prof = stages.measure(HEADLINE["batch"], device=dev)
    got = read(launches)
    st = prof["stages"]
    for name in stages.STAGES + ("step",):
        ms = st[name]
        busy = ("not measured" if ms["device_ms"] is None else
                f"{ms['device_ms']:.4f} ms in {ms['launches']} kernels")
        print(f"stage {name} [{prof['batch']} x {prof['window']}]: call "
              f"{ms['ms']:.4f} ms, device {busy}, hand-written kernels "
              f"{ms['hand_launches']} {tag}")
    check(st["step"]["hand_launches"] == {"viterbi": 2, "slice": 2}
          and st["viterbi"]["hand_launches"]["viterbi"] == 1
          and st["window"]["hand_launches"]["slice"] == 1,
          f"the stages launch the step's kernels {st['step']}")
    print(f"step {st['step']['ms']:.4f} ms against the sum of its stages "
          f"{prof['stage_sum']['ms']:.4f} ms (device "
          f"{prof['stage_sum']['device_ms']}) {tag}")
    for name, lay in prof["layouts"].items():
        print(f"layout {name} {lay['shape']}: the step's form {lay['ms']:.4f} "
              f"ms (device {lay['device_ms']:.4f}), one PyTorch call "
              f"{lay['alt_ms']:.4f} ms (device {lay['alt_device_ms']:.4f}); "
              f"max |d| {lay['max_abs_err']:.3g} of {lay['scale']:.3g} "
              f"(tolerance {lay['tol']}) {tag}")

    # -- 34. the streams' host floor, one rep -------------------------------
    reset()
    br = floor.bracket(1, device=dev)
    got = read(launches)
    check(got["slice_shared"] > 0 and got["slice_multi"] > 0,
          f"floor bracket launches {got}")
    for name, row in floor.summary(br).items():
        print(f"floor {name}: " + " | ".join(
            f"{p} {row[p]['ms']:.4f} ms ({row[p]['samples_per_s']:.6g} "
            f"samples/s)" for p in floor.PASSES) + f" {tag}")

    # -- 35. the loops' branch-dispatch floor at 8 branches -----------------
    reset()
    bf = branch_floor.measure((8,), device=dev)
    got = read(launches)
    check(got["viterbi"] > 0 and got["slice_shared"] > 0
          and got["slice_multi"] > 0, f"branch floor launches {got}")
    for label, t in list(bf["branch_loop"][8].items()) + list(
            bf["routed"].items()):
        if isinstance(t, dict):
            print(f"branch floor 8 branches {label}: {t['packets']}/"
                  f"{bf['packets']} packets, {t['ms']:.4f} ms per call, "
                  f"{t['samples_per_s']:.6g} samples/s {tag}")

    # -- 36. the top-level entry points ---------------------------------------
    entry_phase(dev, tag, launches)

    # -- 37. perf.multicard's 1-rank pass ------------------------------------
    multicard_phase(tag, launches)
    dist.destroy_process_group()       # the 1-rank group of phase 27

    # -- 38. the kernels line ------------------------------------------------
    def entry(name, source, replaces, key, err, t):
        return {"name": name, "route": "cuda",
                "source": f"ieee80211_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[key],
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "device_ms": t["device_ms"], "host_us": t["host_us"],
                "bound_ms": t["bound_ms"],
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
