"""Top-level entry points: the flagship receive step and the sharded envelope.

Port of __graft_entry__.py (`_example_batch` :7, `entry` :32,
`dryrun_multichip` :38, the command line :255). `entry()` hands out the
fixed-config receive step with a small batch of real packets;
`dryrun_multichip(n)` runs the dual-chain capture loop with in-loop format
detection over the whole envelope of the mesh loop on n ranks of
`torch.distributed`: mixed L / VHT A-MPDU / HT 2x2 traffic and a sounding
NDP, a downlink MU PPDU, and an 80 MHz VHT MCS9 A-MPDU.

    python -m ieee80211_tpu_torch.entry                   # entry() once
    torchrun --nproc-per-node N -m ieee80211_tpu_torch.entry --dryrun N
    python -m ieee80211_tpu_torch.entry --dryrun 1 --device cpu

Both run on the card unless `device="cpu"` asks for the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from .mac import MacConfig, aggregate_vht, build_udp_mpdu, deaggregate_vht
from .models import RxPipeline
from .mu import ndp_ltf_channel
from .parallel import init_distributed, make_phy_mesh, sharded
from .rx.mimo import MrcDataDecoder
from .specs import BW, F, Mod
from .specs.crc import fcs_ok
from .specs.modulation import ppdu_params_aggregate, ppdu_params_nonaggregate
from .tx import finalize, gen_ampdu, gen_ampdu_mu, gen_mpdu
from .utils import c2r
from .utils.device import entry_device


def example_mpdu() -> bytes:
    """The 30-byte UDP MPDU that every packet of the entry points carries."""
    cfg = MacConfig(addr1="f4:69:d5:80:0f:a0", addr2="00:c0:ca:b1:5b:e1",
                    addr3="f4:69:d5:80:0f:a0", seq=2704)
    return build_udp_mpdu(b"123456789012345678901234567890", cfg)


def example_batch(mcs: int = 7, n_pkt: int = 4, *, device=None):
    """n_pkt copies of one Legacy packet (golden TX, CFO 12 kHz) triggered
    8 samples early, and the receiver of its fixed config on `device`.
    Returns (RxPipeline, mod, ppdu params, x2 [n_pkt, W, 2] float32 numpy,
    t0 [n_pkt] int32 numpy)."""
    mpdu = example_mpdu()
    mod = Mod(F.L, mcs)
    pp = ppdu_params_nonaggregate(mod, len(mpdu))
    wave = finalize(gen_mpdu(mpdu, mod).waveform, multiplier=0.2,
                    cfo_hz=12000.0, gap=True, gap_len=64)[0]
    pipe = RxPipeline(mod, pp.n_sym, pp.psdu_len, device=device)
    w = pipe.window_len()
    x = np.zeros((n_pkt, w), dtype=np.complex64)
    seg = wave[64 - 8:]            # the trigger fires ~8 samples early
    x[:, :min(w, len(seg))] = seg[:min(w, len(seg))]
    return pipe, mod, pp, c2r(x), np.zeros(n_pkt, dtype=np.int32)


def entry(device=None):
    """(fn, example_args): the flagship receive step and its inputs, both
    on the card unless `device="cpu"`. fn(*example_args) returns the step's
    dict (bits, ltf_start, lsig_ok, cfo, snr)."""
    pipe, _, _, x2, t0 = example_batch(device=device)
    dev = next(pipe.buffers()).device
    return pipe.step, (torch.from_numpy(x2).to(dev),
                       torch.from_numpy(t0).to(dev))


# --------------------------------------------------------------------------
# the sharded envelope
# --------------------------------------------------------------------------


def mesh_shape(n_devices: int) -> tuple:
    """(dp, sp) of the dryrun's mesh: sp = 2 on an even count above 1."""
    sp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    return n_devices // sp, sp


@dataclasses.dataclass(frozen=True)
class Stage:
    """One loop of the envelope: its capture, complex64 [dp, 2, T], and the
    arguments of `sharded_capture_decode_auto2` that decode it."""
    name: str
    capture: np.ndarray
    branches: tuple
    window: int
    options: dict

    def run(self, mesh):
        """The stage's loop on `mesh`: run(c2r(capture)) -> its outputs."""
        return sharded.sharded_capture_decode_auto2(
            mesh, self.branches, self.window, **self.options)


def round_up(n: int, sp: int) -> int:
    """n rounded up to a multiple of 512 sp: a capture length that splits
    over sp shards of whole 512-sample blocks."""
    return -(-n // (512 * sp)) * (512 * sp)


def envelope_captures(n_devices: int) -> list:
    """The three captures of the dryrun on an n_devices mesh (seed 5),
    each row rotated or offset by its dp index, each length a multiple of
    512 sp:

      mixed:    per row L MCS7 and a VHT MCS7 A-MPDU through a flat
                channel to both chains, HT MCS12 2x2 and a 2-stream VHT NDP
                through a 2x2 channel, noise 1e-4; with sp > 1 one packet
                straddles a shard edge (at tl - 100);
      mu:       a 2-user MU PPDU (VHT MCS4 + MCS2, identity Q, group 2)
                whose stream 0 reaches both chains, at 128 + 48 r;
      wideband: a VHT MCS9 80 MHz A-MPDU (CFO 40 kHz) at 256 + 64 r.

    Returns [Stage] in that order."""
    dp, sp = mesh_shape(n_devices)
    rng = np.random.default_rng(5)
    mpdu = example_mpdu()
    ampdu = aggregate_vht([mpdu])

    mod_l, mod_vht = Mod(F.L, 7), Mod(F.VHT, 7)
    mod_22 = Mod(F.HT, 12, BW.BW20, 2)
    pp_l = ppdu_params_nonaggregate(mod_l, len(mpdu))
    pp_vht = ppdu_params_aggregate(mod_vht, len(ampdu))
    pp_22 = ppdu_params_nonaggregate(mod_22, len(mpdu))

    h1 = np.array([0.9 - 0.3j, 0.5 + 0.8j])          # SISO -> 2 chains
    h22 = np.array([[1.1 + 0.2j, 0.3 - 0.5j],
                    [-0.4 + 0.6j, 0.9 + 0.1j]])

    def two_chain(wave1):
        return np.stack([h1[0] * wave1, h1[1] * wave1])

    w_l = two_chain(finalize(gen_mpdu(mpdu, mod_l).waveform,
                             multiplier=0.2, cfo_hz=12000.0, gap=False)[0])
    w_vht = two_chain(finalize(gen_ampdu(ampdu, mod_vht).waveform,
                               multiplier=0.2, cfo_hz=5000.0, gap=False)[0])
    w_22 = h22 @ finalize(gen_mpdu(mpdu, mod_22).waveform,
                          multiplier=0.2, cfo_hz=-8000.0, gap=False)
    w_ndp = h22 @ finalize(gen_ampdu(b"", Mod(F.VHT, 0, BW.BW20, 2)).waveform,
                           multiplier=0.2, cfo_hz=3000.0, gap=False)
    waves = [w_l, w_vht, w_22, w_ndp]

    branches = ((mod_l, pp_l.n_sym), (mod_vht, pp_vht.n_sym),
                (mod_22, pp_22.n_sym))
    w = max(MrcDataDecoder(mod_l, pp_l.n_sym).window_capacity(),
            MrcDataDecoder(mod_vht, pp_vht.n_sym).window_capacity(),
            272 + 448 + 160 + 80 * pp_22.n_sym + 160)

    max_wave = max(wv.shape[1] for wv in waves)
    t_len = round_up(4 * (max_wave + 900) + 2 * w, sp)
    tl = t_len // sp
    capture = np.zeros((dp, 2, t_len), dtype=np.complex64)
    for r in range(dp):
        order = [waves[(r + i) % 4] for i in range(4)]
        offs = [64 + 16 * r, 64 + max_wave + 900,
                (tl - 100) if sp > 1 else (64 + 2 * (max_wave + 900)),
                t_len - max_wave - w]
        for o, wv in zip(offs, order):
            capture[r, :, o:o + wv.shape[1]] += wv
    capture += (rng.standard_normal(capture.shape)
                + 1j * rng.standard_normal(capture.shape)) * 1e-4
    stages = [Stage("mixed", capture, branches, w,
                    dict(k_per_shard=8, branch_cap=8))]

    qi = np.tile(np.eye(2, dtype=np.complex64)[None], (64, 1, 1))
    mu_tx = gen_ampdu_mu([ampdu, ampdu],
                         [Mod(F.VHT, 4, BW.BW20, 1),
                          Mod(F.VHT, 2, BW.BW20, 1)],
                         bfq=qi, group_id=2)
    mu_wave2 = finalize(mu_tx.waveform, multiplier=0.2, cfo_hz=-6000.0,
                        gap=False)
    rx_mu = np.stack([0.9 * mu_wave2[0], (0.5 + 0.6j) * mu_wave2[0]])
    mod_mu = Mod(F.VHT, 4, BW.BW20, 1)
    n_sym_mu = max(ppdu_params_aggregate(Mod(F.VHT, m, BW.BW20, 1),
                                         len(ampdu)).n_sym for m in (2, 4))
    w_mu = max(w, 272 + 448 + 4 * 80 + 160 + (n_sym_mu + 2) * 80 + 80)
    t_mu = round_up(rx_mu.shape[1] + 2000 + 2 * w_mu, sp)
    cap_mu = np.zeros((dp, 2, t_mu), dtype=np.complex64)
    for r in range(dp):
        o = 128 + 48 * r
        cap_mu[r, :, o:o + rx_mu.shape[1]] += rx_mu
    stages.append(Stage("mu", cap_mu, branches[:1], w_mu, dict(
        k_per_shard=4, mu_branches=((mod_mu, n_sym_mu + 2),), mu_pos=0,
        mu_gid=2)))

    mod80 = Mod(F.VHT, 9, BW.BW80, 1)
    pp80 = ppdu_params_aggregate(mod80, len(ampdu))
    w80_wave = two_chain(finalize(gen_ampdu(ampdu, mod80).waveform,
                                  multiplier=0.2, cfo_hz=40000.0,
                                  gap=False)[0])
    w80 = MrcDataDecoder(mod80, pp80.n_sym).window_capacity()
    t80 = round_up(w80_wave.shape[1] + 3000 + 2 * w80, sp)
    cap80 = np.zeros((dp, 2, t80), dtype=np.complex64)
    for r in range(dp):
        o = 256 + 64 * r
        cap80[r, :, o:o + w80_wave.shape[1]] += w80_wave
    stages.append(Stage("wideband", cap80, ((mod80, pp80.n_sym),), w80,
                        dict(k_per_shard=4, q=4)))
    return stages


def _carries(bits_row, psdu_len: int, mpdu: bytes, ampdu: bool) -> bool:
    """Descrambled DATA bits -> the exact MPDU with a good FCS: the first
    subframe of a VHT A-MPDU, or the whole PSDU."""
    psdu = np.packbits(bits_row[16:16 + psdu_len * 8].astype(np.uint8),
                       bitorder="little").tobytes()
    if ampdu:
        subs = deaggregate_vht(psdu)
        return bool(subs) and subs[0].fcs_ok and subs[0].mpdu == mpdu
    return fcs_ok(psdu) and psdu == mpdu


def _ndp_has_channel(ltf) -> bool:
    """An NDP's chain-0 LTF window [160, 2] -> a finite, non-zero channel
    estimate. Its two LTF data windows sit at 8 and 88 in the 160-sample
    slice (GI 16 less the 8-sample early shift)."""
    iq = ltf[:, 0] + 1j * ltf[:, 1]
    est = ndp_ltf_channel(np.concatenate([iq[8:72], iq[88:152]]), n_sts=2)
    return bool(np.all(np.isfinite(est)) and np.abs(est).max() > 1e-3)


def stage_counts(stage: Stage, out: dict) -> dict:
    """What one stage's outputs decode to, as the JAX dryrun counts it:
    mixed -> {"mixed": exact MPDUs, "ndp": NDPs whose LTFs give a channel},
    mu -> {"mu": own-stream MU MPDUs}, wideband -> {"wideband": MPDUs}."""
    o = {k: v.cpu().numpy() for k, v in out.items()}
    mpdu = example_mpdu()
    n_ok = n_ndp = 0
    for r in range(o["ok"].shape[0]):
        for j in range(o["ok"].shape[1]):
            if stage.name == "mixed" and o["ndp"][r, j]:
                n_ndp += _ndp_has_channel(o["ndp_ltf"][r, j, 0])
                continue
            if not o["ok"][r, j] or (stage.name == "mu"
                                     and not o["mu"][r, j]):
                continue
            ampdu = stage.name != "mixed" or o["fmt"][r, j] == 2
            n_ok += _carries(o["bits"][r, j], int(o["psdu_len"][r, j]), mpdu,
                             ampdu)
    if stage.name == "mixed":
        return {"mixed": n_ok, "ndp": n_ndp}
    return {stage.name: n_ok}


def dryrun_multichip(n_devices: int, *, device=None):
    """The closed dual-chain capture -> decode loop with in-loop format
    detection on an n_devices ("dp", "sp") mesh (sp = 2 on an even count),
    over the envelope of `envelope_captures`: a halo'd front end on both
    chains, the trigger (max over chains, with an overflow flag),
    all-gather regroup, per-window MRC SIG parse and plan,
    capacity-routed branch decode, NDP LTF extraction, the MU branch
    (SIG-A group, SIG-B (mcs, len), own-stream decode) and the 80 MHz
    loop. Windows, formats, lengths and stream counts are found by the
    loop, not cut on the host.

    Every rank of a world of at least n_devices ranks calls it (the mesh's
    groups are made collectively; under torchrun it joins the group of
    the environment). Ranks outside the mesh return None; the others
    assert what the JAX dryrun asserts (no overflow, 3 dp exact MPDUs,
    dp NDPs that give a channel, dp MU and dp 80 MHz MPDUs) and return
    {"counts": {"mixed", "ndp", "mu", "wideband"}, "outputs": {stage name:
    the loop's output dict}}. Runs on the card unless `device="cpu"`."""
    init_distributed(device=device)    # torchrun's group, this rank's card
    dev = entry_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) needs {n_devices} ranks and the "
            f"world has {world}: start one process per device, "
            f"`torchrun --nproc-per-node {n_devices} -m "
            f"ieee80211_tpu_torch.entry --dryrun {n_devices}`")
    dp, sp = mesh_shape(n_devices)
    mesh = make_phy_mesh(n_devices, sp, device=dev)
    if mesh.get_coordinate() is None:
        return None
    counts, outputs = {}, {}
    for stage in envelope_captures(n_devices):
        out = stage.run(mesh)(c2r(stage.capture))
        if stage.name == "mixed":
            assert not out["overflow"].any(), "trigger capacity hit"
            assert not out["branch_overflow"].any(), "branch capacity hit"
        outputs[stage.name] = out
        counts.update(stage_counts(stage, out))
    want = {"mixed": 3 * dp, "ndp": dp, "mu": dp, "wideband": dp}
    assert counts == want, f"decoded {counts}, want {want}"
    print(f"dryrun_multichip({n_devices}): mesh (dp={dp}, sp={sp}) "
          f"DUAL-CHAIN trigger+halo+all_gather+AUTO-DETECT with "
          f"capacity-routed branches decoded {counts['mixed']}/{3 * dp} "
          f"mixed L(MRC)/VHT-AMPDU(MRC)/HT-2x2 packets + {counts['ndp']}/"
          f"{dp} NDP channel captures OK (incl. shard-edge straddlers); "
          f"MU branch {counts['mu']}/{dp} OK; 80 MHz VHT MCS9 wideband "
          f"loop {counts['wideband']}/{dp} OK", flush=True)
    return {"counts": counts, "outputs": outputs}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m ieee80211_tpu_torch.entry",
        description="Run the receive step once, or the sharded envelope "
                    "on N ranks (one process per rank, as torchrun starts "
                    "them).")
    ap.add_argument("--dryrun", type=int, metavar="N",
                    help="run dryrun_multichip(N) on this rank")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    if args.dryrun is not None:
        dryrun_multichip(args.dryrun, device=args.device)
        if dist.is_initialized():
            dist.destroy_process_group()
        return
    fn, (x2, t0) = entry(args.device)
    with torch.inference_mode():
        out = fn(x2, t0)
    print("entry OK:", {k: tuple(v.shape) for k, v in out.items()})
    bits = out["bits"].cpu().numpy()
    mpdu = example_mpdu()
    n_ok = sum(_carries(row, len(mpdu), mpdu, False) for row in bits)
    if not (bool(out["lsig_ok"].all()) and n_ok == len(bits)):
        raise SystemExit(f"entry: lsig_ok {out['lsig_ok'].tolist()}, "
                         f"{n_ok}/{len(bits)} exact MPDUs")
    print(f"entry: lsig_ok {len(bits)}/{len(bits)}, {n_ok}/{len(bits)} "
          f"exact MPDUs with a good FCS")


if __name__ == "__main__":
    main()
