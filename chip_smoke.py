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
  7. times from CUDA events (median of 10 runs after warm-up): each kernel
     and its plain version at the main path's shapes, and the whole step;
  8. the Viterbi floor probe (its own entry point, perf/vit_floor.py):
     kernel == plain at 1024 x 1176 blocks, timed beside the Viterbi kernel
     on the same input;
  9. the shared-source slice kernel against its plain version on a 4M-sample
     capture with 1024 starts, at the SIG and a DATA window length, timed;
 10. `SisoReceiver.decode_capture` on bench.py's 20-packet mixed HT/VHT
     capture: 20/20 exact MPDUs, equal to the port's CPU run;
 11. 80 MHz VHT and 40 MHz HT captures: every packet decodes;
 12. `SisoReceiver.decode_captures` on bench.py's stream (six ~4M-sample
     captures of 1000 packets, int8 ingest) with the host and the device
     trigger: 1000/1000 per capture, the device trigger's positions against
     the host's, launches of every kernel in every capture, samples/s and
     packets/s (best of 3) and the host's waits on the device per capture.
The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}. Imports no JAX: the GPU machine has none.
"""
import json
import subprocess
import sys
import time

import numpy as np

DEVICE = "cuda:0"
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


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def make_batch(fmt: str, mcs: int, bw: int, payload: int, seed: int,
               cfo_hz: float, batch: int, device=None):
    """bench.py's RX input without JAX: one UDP MPDU in a VHT A-MPDU from the
    golden TX, triggered 8 samples early, repeated over the batch.
    Returns (RxPipeline on `device`, x2 [B, W, 2] float32, t0 [B] int32,
    mpdu)."""
    from ieee80211_tpu.mac import MacConfig, aggregate_vht, build_udp_mpdu
    from ieee80211_tpu.specs import BW, F, Mod
    from ieee80211_tpu.specs.modulation import ppdu_params_aggregate
    from ieee80211_tpu.tx import finalize, gen_ampdu
    from ieee80211_tpu_torch.models import RxPipeline
    from ieee80211_tpu_torch.utils import c2r

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
    from ieee80211_tpu.mac import MacConfig, aggregate_vht, build_udp_mpdu
    from ieee80211_tpu.specs import F, Mod
    from ieee80211_tpu.tx import finalize, gen_ampdu, gen_mpdu
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
    from ieee80211_tpu.mac import MacConfig, aggregate_vht, build_udp_mpdu
    from ieee80211_tpu.specs import BW, F, Mod
    from ieee80211_tpu.tx import finalize, gen_ampdu, gen_mpdu
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
    check(d_cfo <= CFO_HZ_TOL and d_snr <= SNR_TOL
          and (evm_tol is None or d_evm <= evm_tol),
          f"{what}: cfo/snr/evm vs CPU run")
    return (f"|dcfo| {d_cfo:.4g} Hz, |dsnr| {d_snr:.4g} dB, |devm| "
            f"{d_evm:.4g} dB")


def main() -> int:
    import torch
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

    from ieee80211_tpu.mac import deaggregate_vht
    from ieee80211_tpu.specs import CR
    from ieee80211_tpu.tx.golden import bcc
    from ieee80211_tpu_torch.ops import coding, sync
    from ieee80211_tpu_torch.ops.cuda import build
    from ieee80211_tpu_torch.ops.cuda import gather as kg
    from ieee80211_tpu_torch.ops.cuda import viterbi as kv
    from ieee80211_tpu_torch.perf.timing import cuda_ms

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
            ("bucket_ht5", 2, 6656, CR.CR23, 12)]:
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
                "slice_shared": 0, "vit_floor": 0}
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
        cpu_pipe = type(pipe)(pipe.mod, pipe.n_sym, pipe.psdu_len)
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
    # Kernel and plain times are one wrapper call each between two events,
    # so the host's launch cost is inside them.
    tag = f"({card})"
    times = {}

    def time_pair(key, shape, kernel, plain):
        times[key] = (cuda_ms(kernel), cuda_ms(plain))
        print(f"time {key} {shape}: kernel {times[key][0]:.4f} ms, plain "
              f"{times[key][1]:.4f} ms {tag}")

    for name in ("data", "lsig", "data80"):
        x, cr, n_bits = vit_inputs[name]
        lp = coding._pairs(x, cr, n_bits, coding.RADIX)
        time_pair(f"viterbi_{name}", f"[{x.shape[0]} x {n_bits} {cr.name}]",
                  lambda: kv.viterbi_pairs_cuda(lp, w0, w1, coding.RENORM),
                  lambda: coding.viterbi_pairs_plain(lp, w0, w1,
                                                     coding.RENORM))
    for bw, (cell, pipe, x2, t0, _) in rows.items():
        xd = torch.from_numpy(x2).to(dev)
        td = torch.from_numpy(t0).to(dev)
        b, n = xd.shape[:2]
        q = pipe.step.q
        sync_len = (80 + sync.N_LAG + 3 * sync.LTF_PERIOD) * q
        for what, length, starts in (
                ("sync", sync_len, td),
                ("z", pipe.step.z_len(), outs[bw]["ltf_start"] - 16 * q)):
            time_pair(f"slice_{what}_{bw}", f"[{b} x {n} -> {length}]",
                      lambda: kg.batch_slice_iq_cuda(xd, starts, length),
                      lambda: sync.batch_slice_iq_plain(xd, starts, length))
        with torch.inference_mode():
            step_ms = cuda_ms(lambda: pipe.step(xd, td))
        print(f"time step {bw} MHz VHT MCS{cell['mcs']} [{b} x {n}]: "
              f"{step_ms:.4f} ms, {b * n / (step_ms * 1e-3):.6g} samples/s "
              f"{tag}")

    # -- 8. the Viterbi floor probe -----------------------------------------
    from ieee80211_tpu_torch.ops.cuda import vit_floor as kf
    from ieee80211_tpu_torch.perf import vit_floor
    probe = vit_floor.measure(dev)
    launches["vit_floor"] += probe["launches"]
    b, n_blk, _ = probe["shape"]
    print(f"floor probe [{b} x {n_blk} blocks x 8]: kernel == plain; probe "
          f"{probe['ms']:.4f} ms, plain {probe['plain_ms']:.4f} ms, "
          f"viterbi_r4 on [{b} x {n_blk * kf.K} x 2] "
          f"{probe['viterbi_ms']:.4f} ms, ACS share "
          f"{probe['acs_share']:.4f} {tag}")
    check(probe["launches"] > 0, "the probe run launched the probe kernel")

    # -- 9. shared-source slice kernel vs plain ------------------------------
    from ieee80211_tpu.specs import F, Mod
    from ieee80211_tpu_torch.rx import SisoReceiver, receiver
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
        time_pair(f"slice_shared_{what}", f"[{n_cap} -> 1024 x {length}]",
                  lambda: kg.capture_slice_iq_cuda(cap_dev, st, length),
                  lambda: receiver.capture_windows_plain(cap_dev, st,
                                                         length))
    del cap_dev

    def reset():
        kv.LAUNCHES = kg.LAUNCHES = kg.SHARED_LAUNCHES = 0

    def read(into=None):
        got = {"viterbi": kv.LAUNCHES, "slice": kg.LAUNCHES,
               "slice_shared": kg.SHARED_LAUNCHES}
        if into is not None:
            for k, v in got.items():
                into[k] += v
        return got

    # -- 10. decode_capture on bench.py's 20-packet capture ------------------
    from ieee80211_tpu import native
    api_cap, api_mpdus = api_capture()
    rx = SisoReceiver(device=dev)
    reset()
    res = rx.decode_capture(api_cap)
    torch.cuda.synchronize()
    got = read(launches)
    print(f"decode_capture [{len(api_cap)} samples]: launches {got}")
    check(all(v > 0 for v in got.values()), "decode_capture launched "
                                           "every receiver kernel")
    n_ok = sum(r.fcs_ok and r.mpdus[0] == m for r, m in zip(res, api_mpdus))
    print(f"decode_capture: {n_ok}/{N_API} packets decode to the exact MPDU "
          f"with a good FCS")
    check(len(res) == N_API and n_ok == N_API, "20/20 packets decode")
    ref = SisoReceiver().decode_capture(api_cap)
    print("decode_capture vs CPU run: fields equal, "
          + check_same_packets(res, ref, "decode_capture"))
    noisy = add_noise(api_cap, 30.0, seed=11)
    print("decode_capture at 30 dB SNR vs CPU run: fields equal, "
          + check_same_packets(rx.decode_capture(noisy),
                               SisoReceiver().decode_capture(noisy),
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
    import warnings
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
        waits = srx.n_waits
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                stream = srx.decode_captures(caps)
                torch.cuda.synchronize()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # the mode's own notice on enabling is a warning too: count only
        # the ops it flags
        implicit = sum("synchroniz" in str(w.message)
                       and "prototype" not in str(w.message) for w in caught)
        got = read(launches)
        waits = (srx.n_waits - waits) / len(caps)
        for res in stream:
            n_ok = sum(r.fcs_ok for r in res)
            check(n_ok == N_API * N_COPY == len(res),
                  f"{name} trigger: {n_ok}/{N_API * N_COPY} packets")
        print(f"stream, {name} trigger ({route}): {N_API * N_COPY}/"
              f"{N_API * N_COPY} good FCS in each of {len(caps)} captures; "
              f"launches {got}; host waits on the device per capture "
              f"{waits:.4g}, implicit syncs {implicit}")
        for k, c in enumerate(caps):
            reset()
            srx.decode_captures([c])
            torch.cuda.synchronize()
            per = read()
            check(all(v > 0 for v in per.values()),
                  f"{name} trigger capture {k} launched every kernel {per}")
        dts = []
        for _ in range(3):
            t = time.perf_counter()
            stream = srx.decode_captures(caps)
            torch.cuda.synchronize()
            dts.append(time.perf_counter() - t)
        n_pk = sum(len(r) for r in stream)
        stream_rate[name] = (total / min(dts), n_pk / min(dts))
        print(f"time stream, {name} trigger: best of 3 {min(dts):.4f} s "
              f"(runs {', '.join(f'{d:.4f}' for d in dts)}): "
              f"{stream_rate[name][0]:.6g} samples/s, "
              f"{stream_rate[name][1]:.6g} packets/s {tag}")

    # -- 13. the kernels line ------------------------------------------------
    kernels = [
        {"name": "viterbi_r4", "route": "cuda",
         "source": "ieee80211_tpu_torch/csrc/viterbi.cu",
         "replaces": "ieee80211_tpu/ops/pallas/viterbi.py:272",
         "launches": launches["viterbi"], "max_abs_err": vit_err,
         "ms": times["viterbi_data"][0], "plain_ms": times["viterbi_data"][1]},
        {"name": "slice_iq", "route": "cuda",
         "source": "ieee80211_tpu_torch/csrc/gather.cu",
         "replaces": "ieee80211_tpu/ops/pallas/gather.py:78",
         "launches": launches["slice"], "max_abs_err": slice_err,
         "ms": times["slice_z_20"][0], "plain_ms": times["slice_z_20"][1]},
        {"name": "slice_iq_shared", "route": "cuda",
         "source": "ieee80211_tpu_torch/csrc/gather.cu",
         "replaces": "ieee80211_tpu/ops/pallas/gather.py:78",
         "launches": launches["slice_shared"], "max_abs_err": shared_err,
         "ms": times["slice_shared_sig"][0],
         "plain_ms": times["slice_shared_sig"][1]},
        {"name": "vit_floor", "route": "cuda",
         "source": "ieee80211_tpu_torch/csrc/vit_floor.cu",
         "replaces": "perf_vit_floor.py:37",
         "launches": launches["vit_floor"],
         "max_abs_err": probe["max_abs_err"],
         "ms": probe["ms"], "plain_ms": probe["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
