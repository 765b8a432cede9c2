#!/usr/bin/env python3
"""Drive the PyTorch port's flagship receive path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the exit code is non-zero:
  1. device check (exits 1 without CUDA) and the card's name / power limit;
  2. build of every CUDA kernel from ieee80211_tpu_torch/csrc/ with nvcc;
  3. the Viterbi kernel against its plain PyTorch version on the card, bit
     for bit, and against the encoder's input bits;
  4. the window-slice kernel against its plain version, element for element;
  5. + 6. `RxPipeline.step` at VHT MCS7 20 MHz (500 B, batch 1024) and VHT
     MCS9 80 MHz (1800 B, batch 256), the inputs of bench.py's two RX rows:
     every packet must decode to the exact MPDU with a good FCS, the first
     rows must equal the port's CPU run, and launch counters must show that
     each step went through both kernels;
  7. times from CUDA events (median of 10 runs after warm-up): each kernel
     and its plain version at the main path's shapes, and the whole step.
The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}. Imports no JAX: the GPU machine has none.
"""
import json
import subprocess
import sys
import time

import numpy as np

DEVICE = "cuda:0"
ITERS = 10
WARMUP = 2
# the card against the port's CPU run on the same rows: matmuls and
# reductions sum in another order there
CFO_TOL = 1e-5    # rad/sample
SNR_TOL = 1e-2    # dB
HEADLINE = dict(fmt="VHT", mcs=7, bw=20, payload=500, seed=0,
                cfo_hz=15000.0, batch=1024)
WIDEBAND = dict(fmt="VHT", mcs=9, bw=80, payload=1800, seed=1,
                cfo_hz=60000.0, batch=256)


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


def cuda_ms(fn) -> float:
    """Median device time of fn() in ms, from CUDA events."""
    import torch
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(ITERS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


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

    # -- 2. build ------------------------------------------------------------
    t = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t:.2f} s (nvcc, both kernels)")
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
            ("data80", 256, 15600, CR.CR56, 6)]:   # 80 MHz MCS9 DATA decode
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
    launches = {"viterbi": kv.LAUNCHES, "slice": kg.LAUNCHES}
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
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
