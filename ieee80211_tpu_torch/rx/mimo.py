"""Dual-chain receiver: 2x2 SU-MIMO (ZF, max-log ML, or ZF with an ML
retry) and maximal-ratio combining of legacy and SISO packets.

Port of ieee80211_tpu/rx/mimo.py (`_deparser_gather` :30, `_pilot_obs_ref`
:38, `MimoDataDecoder` :58, `MrcDataDecoder` :252, `merge_triggers` :373,
`MimoReceiver` :393). Both chains of a packet are decoded as one batched
program: P-matrix channel estimation from the two HT/VHT-LTFs, joint pilot
phase tracking across chains, per-tone 2x2 Gram-inverse ZF or exact
max-log ML detection, per-stream deinterleave and stream deparser, and the
Viterbi over the re-merged coded stream (two encoder lanes in one launch
where nES = 2). Single-stream packets MRC-combine the chains.

The decoders are `nn.Module`s holding their constant tables as buffers
(`mimo_tables_from_numpy`; the MRC decoder's are the SISO decoder's). The
planner (`_plan_batch`, `_plan_one`) and `merge_triggers` are numpy copies,
since the JAX module imports jax; tests/test_torch_mimo_receiver.py pins
them to the originals. With `mu_gid` set, the downlink MU lanes of the
SISO receiver run over both chains (MRC of the own-stream channels). Left
out, as in the JAX package: a dual-chain device trigger.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
from typing import List, Optional

import numpy as np
import torch

from .. import native
from ..models.pipeline import as_tables
from ..ops import coding, demod, sync
from ..specs import BW, F, Mod, tables
from ..specs import interleaver as ilv
from ..specs.modulation import ppdu_params_nonaggregate
from ..utils.metrics import call_span, on_lane, span
from ..utils.riq import r2c
from .receiver import (MIN_TRIGGER_GAP, OFF_NLLTF, PacketResult,
                       SisoDataDecoder, SisoReceiver, _device,
                       _pick_nl_format, _Plan, _round_64k,
                       capture_windows_mimo, decode_vht_sigb,
                       decoder_tables_from_numpy, next_pow2, pack_bits_le,
                       parse_ht_sig, parse_vht_siga, sig_parse_mimo_capture,
                       sigb_service_crc_ok)

__all__ = ["MimoDataDecoder", "MimoReceiver", "MrcDataDecoder",
           "get_mimo_decoder", "get_mrc_decoder", "merge_triggers",
           "mimo_tables_from_numpy"]


@lru_cache(maxsize=None)
def _deparser_gather(mod: Mod):
    """Per-encoder gather maps [nES][nCBPS/nES]: coded bit i of encoder e
    <- (stream, position), as the standard's stream deparser orders them."""
    ss_idx, pos_idx = ilv.stream_deparser_maps(mod)
    return ss_idx.astype(np.int32), pos_idx.astype(np.int32)


def mimo_tables_from_numpy(mod: Mod, n_sym: int):
    """Every constant table of a 2-stream DATA decoder for (mod, n_sym), as
    numpy, built by copies of the JAX package's helpers: the SISO decoder's
    tables (DFT, LTF references, tone maps, Viterbi radix tables, scrambler,
    and the SIG-B ones for VHT) with the per-stream ones in place of stream
    0's:
    `rx_perm` [2, nCBPSS], for HT `pilot_ref` [nSTS, S, nP] (VHT sends the
    same pilots on both streams: [S, nP]), the P matrix of the LTFs, the
    stream deparser as flat indices into [2 * nCBPSS] per encoder, and the
    ML detector's candidates."""
    out = decoder_tables_from_numpy(mod, n_sym)
    ss_idx, pos_idx = _deparser_gather(mod)
    pts, masks = demod._ml_candidates(mod.mod)
    pidx0 = 3 if mod.fmt == F.HT else 4
    extra = {
        "rx_perm": np.stack([ilv.rx_perm(mod, iss) for iss in range(2)]),
        "p_ltf": tables.P_LTF_4[:2, :2],
        "deparse_idx": ss_idx.astype(np.int64) * mod.nCBPSS + pos_idx,
        "ml_pts": pts,
        "ml_masks": masks,
    }
    if mod.fmt == F.HT:
        extra["pilot_ref"] = np.stack([demod.pilot_refs(mod, n_sym, pidx0,
                                                        iss)
                                       for iss in range(2)])
    out.update(as_tables(extra))
    return out


def _pilot_obs_ref(mod: Mod, h_pil: torch.Tensor,
                   pilot_ref: torch.Tensor) -> torch.Tensor:
    """Expected pilot observations per RX chain [B, S, nRx, nP].

    h_pil: [B, nP, nRx, nSTS] channel at the pilot bins (for VHT the sum
    channel, one column); pilot_ref: the decoder's `pilot_ref` table."""
    if mod.fmt == F.HT:
        # y_exp[r, k, n] = sum_s H[r, s, k] * p_s[k, n]
        return torch.einsum("bprs,snp->bnrp", h_pil,
                            pilot_ref.to(h_pil.dtype))
    hsum = torch.sum(h_pil, dim=-1)                       # [B, nP, nRx]
    return torch.einsum("bpr,np->bnrp", hsum, pilot_ref.to(h_pil.dtype))


class _MultiChainDecoder(SisoDataDecoder):
    """A DATA decoder over windows of every RX chain: the SISO decoder's
    geometry (`data_offset`, `zlen`, `window_capacity`) with one aligned
    window per chain, z [B, nRx, zlen]."""

    def _decode(self, x2: torch.Tensor, ltf_start: torch.Tensor,
                cfo: torch.Tensor, n_valid: Optional[torch.Tensor] = None):
        """x2: [B, nRx, N, 2] float32 raw windows; one aligned slice per
        chain, then the static decode."""
        b, nrx = x2.shape[0], x2.shape[1]
        zl = self.zlen()
        z2 = sync.batch_slice_iq(
            x2.reshape(b * nrx, x2.shape[2], 2),
            (ltf_start - 16 * self.q).repeat_interleave(nrx), zl)
        z = r2c(z2).reshape(b, nrx, zl) * sync.cfo_ramp(cfo, zl)[:, None]
        return self._decode_z(z, n_valid)

    def decode_from_capture(self, cap: torch.Tensor, t_abs: torch.Tensor,
                            ltf_start: torch.Tensor, cfo: torch.Tensor,
                            n_valid: torch.Tensor):
        """Batched decode with one aligned window per packet and chain from
        the device-resident [nRx, Npad, 2] capture. Returns (packed
        descrambled bytes [G, n_bits/8] uint8, EVM SNRs, sigb_ok [G]) on the
        capture's device, without waiting for it."""
        zl = self.zlen()
        x2 = capture_windows_mimo(cap, t_abs + ltf_start - 16 * self.q, zl)
        z = r2c(x2) * sync.cfo_ramp(cfo, zl)[:, None]
        bits, evm, sigb_ok = self._decode_z(z, n_valid)
        return pack_bits_le(bits), evm, sigb_ok

    def _sigb_ok(self, z: torch.Tensor, chan: torch.Tensor,
                 scr: torch.Tensor) -> torch.Tensor:
        """VHT-SIG-B over the chains, MRC-combined through the per-chain
        single-stream channel chan [B, nRx, nfft], checked against the
        SERVICE field's CRC-8 (all True outside VHT)."""
        if self.mod.fmt != F.VHT:
            return torch.ones(z.shape[0], dtype=torch.bool, device=z.device)
        q = self.q
        b, nrx = z.shape[0], z.shape[1]
        sb = self._fft(demod.static_symbol_windows(
            z.reshape(b * nrx, -1), 16 * q + self.data_offset() - 80 * q, 1,
            nfft=64 * q, gi=16 * q, shift=4 * q)).reshape(b, nrx, -1)
        eq = demod.mrc_combine(sb[:, :, None, :], chan)[:, 0]
        acc = torch.sum(eq[:, self.pilot_idx]
                        * torch.conj(self.sigb_pilot_ref)[None], dim=-1)
        ph = acc / torch.clamp_min(torch.abs(acc), 1e-12)
        sigb_bits = decode_vht_sigb(eq / ph[:, None], self.mod.bw,
                                    self.data_idx, self.sigb_perm,
                                    self.vit_w0, self.vit_w1)
        return sigb_service_crc_ok(sigb_bits, scr, self.mod.bw,
                                   self.sigb_crc8_mat, self.sigb_crc8_const)


class MimoDataDecoder(_MultiChainDecoder):
    """Batched 2-stream DATA decoder for one static (Mod, nSym-bucket) over
    two RX chains, with the "ml" (exact max-log) or "zf" (the reference's
    Gram-inverse) detector. n_sym is the symbol capacity; true per-packet
    counts pass through `n_valid`, as in SisoDataDecoder. Its state is the
    constant tables of `mimo_tables_from_numpy`, held as buffers."""

    def __init__(self, mod: Mod, n_sym: int, detector: str = "ml"):
        if mod.nSS != 2:
            raise ValueError(f"MimoDataDecoder decodes 2 streams, got "
                             f"{mod.nSS}")
        if detector not in ("ml", "zf"):
            raise ValueError(f"detector must be 'ml' or 'zf', got "
                             f"{detector!r}")
        super().__init__(mod, n_sym)
        self.detector = detector

    @staticmethod
    def _tables(mod: Mod, n_sym: int):
        return mimo_tables_from_numpy(mod, n_sym)

    def _decode_z(self, z: torch.Tensor,
                  n_valid: Optional[torch.Tensor] = None):
        """z: [B, nRx=2, zlen] complex, CFO-corrected, index 0 == ltf_start
        - gi. Returns (descrambled bits [B, n_bits] int32, per-stream EVM
        SNR [B, 2], sigb_ok [B])."""
        mod = self.mod
        q = self.q
        nfft, gi, sh = 64 * q, 16 * q, 4 * q  # 4q shift, as the SISO decoder
        b = z.shape[0]
        yf = z.reshape(b * 2, -1)

        # both chains' HT/VHT-LTF symbols -> [B, nRx, nLtf, nfft]
        ltf_f = self._fft(demod.static_symbol_windows(
            yf, gi + OFF_NLLTF * q, 2, nfft=nfft, gi=gi, shift=sh)).reshape(
                b, 2, 2, nfft)
        h = demod.mimo_chan_est_2x2(ltf_f, self.ltf_ref_nl, self.p_ltf)
        # at the VHT pilot tones both LTFs carry the same value on every
        # stream: the per-chain sum channel there is LTF1 / ref
        pil = self.pilot_idx
        sum_h_pil = ltf_f[:, :, 0, :][..., pil] / self.ltf_ref_nl[pil]

        gd = self._fft(demod.static_symbol_windows(
            yf, gi + self.data_offset(), self.n_sym, nfft=nfft, gi=gi,
            shift=sh)).reshape(b, 2, self.n_sym, nfft)

        # joint pilot phase tracking across chains
        if mod.fmt == F.HT:
            exp_obs = _pilot_obs_ref(mod, h[:, pil], self.pilot_ref)
        else:
            exp_obs = _pilot_obs_ref(
                mod, sum_h_pil.transpose(1, 2)[..., None], self.pilot_ref)
        obs = gd[..., pil].transpose(1, 2)                # [B, S, nRx, nP]
        acc = torch.sum(obs * torch.conj(exp_obs), dim=(-1, -2))
        ph = acc / torch.clamp_min(torch.abs(acc), 1e-12)  # [B, S]
        gd = gd / ph[:, None, :, None]

        xhat = demod.mimo_equalize_2x2(gd, h)             # [B, 2, S, nfft]
        data = xhat[..., self.data_idx]                   # [B, 2, S, nSD]
        sym_m = None
        if n_valid is not None:
            sym_m = (torch.arange(self.n_sym, device=z.device)[None, :]
                     < n_valid[:, None])                  # [B, S]
        # per-stream EVM SNRs over (S, nSD)
        evm = demod.evm_snr_db(
            data, mod.mod, sym_mask=None if sym_m is None else sym_m[:, None])
        if self.detector == "ml":
            llr = demod.ml_detect_llr_2x2(
                gd[..., self.data_idx], h[:, self.data_idx], mod.mod,
                self.ml_pts, self.ml_masks)
        else:
            llr = demod.demap_llr(data, mod.mod)          # [B, 2, S, nCBPSS]
        # per-stream deinterleave, then the stream deparser re-merges each
        # encoder's coded bits per symbol out of [S, 2 * nCBPSS]
        llr = torch.stack([llr[:, iss][..., self.rx_perm[iss]]
                           for iss in range(2)], dim=2)   # [B, S, 2, nCBPSS]
        llr = llr.reshape(b, self.n_sym, -1)
        lanes = []
        for idx in self.deparse_idx:
            m = llr[..., idx]                             # [B, S, nCBPS/nES]
            if sym_m is not None:
                m = torch.where(sym_m[..., None], m, 0.0)
            lanes.append(m.reshape(b, -1))
        # nES = 2: each encoder's lane (its own zero tail) decodes as a row
        # of one launch; the decoded bits re-merge round-robin
        n_es = len(lanes)
        bits = coding.viterbi_decode(torch.cat(lanes), mod.cr,
                                     self.n_bits // n_es, self.vit_w0,
                                     self.vit_w1)
        bits = torch.stack(bits.split(b), dim=-1).reshape(b, -1)
        scr = coding.descramble(bits, self.prbs, self.seed_inv)
        sum_h = None
        if mod.fmt == F.VHT:
            # SIG-B rides the sum channel over streams (every stream sends
            # the same SIG-B through the spatial expansion)
            null = self.ltf_ref_nl == 0
            sum_h = ltf_f[:, :, 0, :] / torch.where(null, 1.0,
                                                    self.ltf_ref_nl)
        return scr, evm, self._sigb_ok(z, sum_h, scr)


class MrcDataDecoder(_MultiChainDecoder):
    """Batched single-stream DATA decoder over several RX chains: legacy and
    SISO HT/VHT packets on the dual-chain receiver, maximal-ratio combined
    (the reference's 2-chain receiver decodes them from chain 0 only). The
    (Mod, nSym-bucket) contract and tables of SisoDataDecoder."""

    def _decode_z(self, z: torch.Tensor,
                  n_valid: Optional[torch.Tensor] = None):
        """z: [B, nRx, zlen] complex, CFO-corrected, index 0 == ltf_start -
        gi. Returns (descrambled bits, EVM SNR [B], sigb_ok [B])."""
        mod = self.mod
        q = self.q
        nfft, gi, sh = 64 * q, 16 * q, 4 * q
        b, nrx = z.shape[0], z.shape[1]
        yf = z.reshape(b * nrx, -1)
        if mod.fmt == F.L:
            ltf_t = demod.static_symbol_windows(yf, 0, 2, nfft=nfft, gi=gi,
                                                shift=sh, stride=nfft)
            chan = demod.legacy_chan_est(self._fft(ltf_t), self.ltf_ref_l)
        else:
            ltf_t = demod.static_symbol_windows(
                yf, gi + OFF_NLLTF * q, 1, nfft=nfft, gi=gi, shift=sh)
            chan = demod.nonlegacy_chan_est_siso(self._fft(ltf_t)[:, 0],
                                                 self.ltf_ref_nl)
        chan = chan.reshape(b, nrx, nfft)
        gd = self._fft(demod.static_symbol_windows(
            yf, gi + self.data_offset(), self.n_sym, nfft=nfft, gi=gi,
            shift=sh)).reshape(b, nrx, self.n_sym, nfft)
        llrs, evm = demod.demod_data_mrc(
            gd, chan, mod, self.pilot_ref, self.pilot_idx, self.data_idx,
            self.rx_perm, with_snr=True, n_valid_sym=n_valid)
        bits = coding.viterbi_decode(llrs, mod.cr, self.n_bits, self.vit_w0,
                                     self.vit_w1)
        scr = coding.descramble(bits, self.prbs, self.seed_inv)
        return scr, evm, self._sigb_ok(z, chan, scr)


@lru_cache(maxsize=64)
def _cached_mimo(mod: Mod, n_sym_bucket: int, detector: str,
                 device: torch.device) -> MimoDataDecoder:
    with span("rx.decoder_build") as sp:
        if sp:
            sp.attrs.update(kind="mimo_" + detector, mod=str(mod),
                            bucket=n_sym_bucket)
        return MimoDataDecoder(mod, n_sym_bucket, detector).to(device)


def get_mimo_decoder(mod: Mod, n_sym_bucket: int, detector: str = "ml",
                     device=None) -> MimoDataDecoder:
    """The 2-stream decoder of (mod, bucket, detector) with its tables on
    `device` (default the card; "cpu" for the CPU), built once per
    process."""
    return _cached_mimo(mod, n_sym_bucket, detector, _device(device))


@lru_cache(maxsize=64)
def _cached_mrc(mod: Mod, n_sym_bucket: int,
                device: torch.device) -> MrcDataDecoder:
    with span("rx.decoder_build") as sp:
        if sp:
            sp.attrs.update(kind="mrc", mod=str(mod), bucket=n_sym_bucket)
        return MrcDataDecoder(mod, n_sym_bucket).to(device)


def get_mrc_decoder(mod: Mod, n_sym_bucket: int,
                    device=None) -> MrcDataDecoder:
    """The MRC decoder of (mod, bucket) with its tables on `device`
    (default the card; "cpu" for the CPU)."""
    return _cached_mrc(mod, n_sym_bucket, _device(device))


def merge_triggers(per_chain: List[np.ndarray], dedup_gap: int) -> np.ndarray:
    """Union of per-chain trigger positions, deduplicated within dedup_gap:
    triggering on every chain keeps detection alive when one chain fades."""
    t_all = np.sort(np.concatenate([np.asarray(t) for t in per_chain]))
    merged: List[int] = []
    last = -dedup_gap
    for t in t_all:
        if t - last >= dedup_gap:
            merged.append(int(t))
            last = int(t)
    return np.asarray(merged, dtype=np.int64)


class _FutsWithCtx(list):
    """Dispatch futs plus the capture needed for a retry pass."""
    ctx = None


class MimoReceiver(SisoReceiver):
    """Auto-detecting universal dual-chain receiver over captures [2, N], on
    the receiver's device: the card unless `device="cpu"` asks for the
    CPU (without a card, the default raises).

    Batched like SisoReceiver, whose streaming entry `decode_captures[_full]`
    it inherits: one capture upload, one MRC SIG-parse batch (one packed
    meta fetch), one decode per (Mod, bucket) group; 2x2 plans go through
    the MIMO detector, legacy and SISO plans through the MRC decoder, and
    VHT NDPs come back as one NdpCapture per chain. With `mu_gid` set, the
    station's stream of that group's downlink MU PPDUs decodes too, its
    own-stream channels MRC-combined over both chains; the auto detector's
    ML retry leaves MU packets alone.

    detector:
      * "auto" (default): 2x2 plans decode through ZF; any that fail the FCS
        (or the SIG-B CRC) are dispatched once more through exact max-log
        ML, so well-conditioned channels never pay the ML candidate sweep;
      * "ml": exact max-log ML on every 2x2 packet;
      * "zf": the reference's linear detector, no retry.

    ingest="auto" sends float32 up to 2^19 padded samples per chain and
    int8 beyond (the SISO receiver switches at 2^20); each chain is scanned
    and quantized with its own peak, by the native runtime on two threads.
    """

    def __init__(self, sample_rate_hz: float = 20e6, stats=None,
                 ingest: str = "auto", trigger: str = "host",
                 detector: str = "auto", mu_pos: int = 0,
                 mu_gid: Optional[int] = None, device=None):
        super().__init__(sample_rate_hz, stats, ingest, trigger,
                         mu_pos=mu_pos, mu_gid=mu_gid, device=device)
        if trigger == "device":
            raise NotImplementedError(
                "the dual-chain receiver has no device trigger: the JAX "
                "MimoReceiver scans its chains on the host only")
        if detector not in ("auto", "ml", "zf"):
            raise ValueError("detector must be 'auto', 'ml' or 'zf'")
        self.detector = detector

    def _mode(self, npad: int) -> str:
        if self.ingest == "auto":
            return "int8" if npad > (1 << 19) else "f32"
        return self.ingest

    def _upload(self, capture: np.ndarray):
        """See SisoReceiver._upload. Without the native runtime the int8
        path quantizes both chains with ONE peak over both, as the JAX
        package's fallback does. Returns (cap_dev float32 [2, npad, 2],
        npad)."""
        capture = np.ascontiguousarray(capture, dtype=np.complex64)
        n = capture.shape[1]
        npad = next_pow2(n + 4096, lo=1 << 15)
        n_r = min(_round_64k(n), npad)
        if self._mode(npad) == "int8":
            buf = self._host_buffer((2, n_r, 2), torch.int8)
            q8 = buf.numpy()
            peak = float(max(np.abs(capture.real).max(initial=0.0),
                             np.abs(capture.imag).max(initial=0.0), 1e-12))
            s = 126.0 / peak
            q8[:, :n, 0] = np.clip(np.round(capture.real * s), -127, 127)
            q8[:, :n, 1] = np.clip(np.round(capture.imag * s), -127, 127)
            return self._cap_to_device(buf, 1.0 / s, npad), npad
        buf = self._host_buffer((2, n_r, 2), torch.float32)
        buf.numpy()[:, :n] = capture.view(np.float32).reshape(2, -1, 2)
        return self._cap_to_device(buf, None, npad), npad

    def _ingest(self, capture: np.ndarray):
        """Dual-chain trigger scan + quantize + upload. On the int8 path each
        chain runs the native fused STF scan + peak track + int8 quantize
        (it releases the GIL: both chains run at once on a 2-thread pool);
        per-chain triggers are union-merged and the per-chain dequant scales
        apply on the device as a [2, 1, 1] array. Returns (t0s, cap_dev,
        npad)."""
        capture = np.ascontiguousarray(capture, dtype=np.complex64)
        n = capture.shape[1]
        npad = next_pow2(n + 4096, lo=1 << 15)
        with span("rx.ingest") as sp:
            if sp:
                sp.attrs.update(k=sp.n, mode=self._mode(npad), samples=n)
            if self._mode(npad) == "int8" and native.available():
                buf = self._host_buffer((2, min(_round_64k(n), npad), 2),
                                        torch.int8)
                q8 = buf.numpy()

                def scan_one(c):
                    with span("rx.ingest.scan") as sc:
                        if sc:
                            sc.attrs["chain"] = c
                        return native.scan_quantize(
                            capture[c], q8[c, :n], thresh=0.5,
                            plateau=20 * self.q,
                            min_gap=MIN_TRIGGER_GAP * self.q,
                            lag=16 * self.q)

                with ThreadPoolExecutor(max_workers=2) as pool:
                    res = list(pool.map(on_lane(scan_one), range(2)))
                t0s = merge_triggers(
                    [np.asarray(t, np.int64) for t, _ in res],
                    dedup_gap=200 * self.q)
                scales = np.asarray([s for _, s in res],
                                    np.float32).reshape(2, 1, 1)
                return t0s, self._cap_to_device(buf, scales, npad), npad
            with span("rx.ingest.scan"):
                t0s = merge_triggers(
                    [sync.find_triggers_np(capture[c], q=self.q,
                                           min_gap=MIN_TRIGGER_GAP)
                     for c in range(2)], dedup_gap=200 * self.q)
            cap_dev, npad = self._upload(capture)
            return t0s, cap_dev, npad

    def _sig_parse(self, cap_dev, t_clamp, t0, wlen):
        return sig_parse_mimo_capture(cap_dev, t_clamp, t0, wlen, self.sig)

    def _decoder_for(self, mod: Mod, n_sym_bucket: int):
        if mod.nSS == 2:
            det = "zf" if self.detector == "auto" else self.detector
            return get_mimo_decoder(mod, n_sym_bucket, det, self.device)
        return get_mrc_decoder(mod, n_sym_bucket, self.device)

    def _dispatch_plans(self, cap_dev, npad, plans, decoder_for=None):
        futs = super()._dispatch_plans(cap_dev, npad, plans, decoder_for)
        if (decoder_for is None and self.detector == "auto"
                and any(p.mod.nSS == 2 and not p.mu for _, p in plans)):
            futs = _FutsWithCtx(futs)
            futs.ctx = (cap_dev, npad)
        return futs

    def _finish_plans(self, futs):
        """Fetch + assemble, then (detector="auto") one exact-ML pass over
        the 2x2 packets that ZF failed to decode."""
        collected = super()._finish_plans(futs)
        ctx = getattr(futs, "ctx", None)
        if ctx is None:
            return collected
        res_by_i = dict(collected)
        retry = []
        with span("rx.plan"):
            for items, *_ in futs:
                for i, p in items:
                    if p.mu or p.mod.nSS != 2:
                        continue
                    r = res_by_i.get(i)
                    if r is not None and r.fcs_ok and r.sigb_ok is not False:
                        continue
                    retry.append((i, p))
        if not retry:
            return collected
        cap_dev, npad = ctx
        ml_futs = super()._dispatch_plans(
            cap_dev, npad, retry,
            decoder_for=lambda mod, nb: get_mimo_decoder(mod, nb, "ml",
                                                         self.device))
        for i, r in super()._finish_plans(ml_futs):
            if r.fcs_ok or res_by_i.get(i) is None:
                res_by_i[i] = r
        return sorted(res_by_i.items())

    def _plan_batch(self, cap_len: int, meta, n: int):
        """Universal dual-chain planning over all n trigger windows, with
        the per-window gates and SIG-field arithmetic as numpy array ops.
        _plan_one is the single-window reference form. Returns (data_plans
        [(i, _Plan)], ndp_plans)."""
        plans: list = []
        ndps: list = []
        snr = np.asarray(meta["snr"][:n], np.float64)
        cand = snr > 0.0
        if not np.any(cand):
            return plans, ndps
        lsig_ok = np.asarray(meta["lsig_ok"][:n]).astype(bool)
        win_start = np.asarray(meta["win_start"][:n], np.int64)
        ltf_start = np.asarray(meta["ltf_start"][:n], np.int64)
        cfo = np.asarray(meta["cfo"][:n], np.float64)
        cfo_hz = cfo * self.fs / (2 * np.pi) * -1.0
        l_mcs = np.asarray(meta["l_mcs"][:n], np.int64)
        l_len = np.asarray(meta["l_len"][:n], np.int64)
        ht_ok = np.asarray(meta["ht_ok"][:n]).astype(bool)
        vht_ok = np.asarray(meta["vht_ok"][:n]).astype(bool)
        imag_dom = np.asarray(meta["nl1_imag_dom"][:n]).astype(bool)
        hb = np.asarray(meta["ht_bits"][:n], np.int64)
        vb = np.asarray(meta["vht_bits"][:n], np.int64)
        ht_mcs = hb[:, :7] @ (1 << np.arange(7, dtype=np.int64))
        ht_bw40 = hb[:, 7].astype(bool)
        ht_len = hb[:, 8:24] @ (1 << np.arange(16, dtype=np.int64))
        ht_aggre = hb[:, 27].astype(bool)
        ht_sgi = hb[:, 31].astype(bool)
        v_bw = vb[:, 0] + 2 * vb[:, 1]
        v_gid = vb[:, 4:10] @ (1 << np.arange(6, dtype=np.int64))
        v_su = (v_gid == 0) | (v_gid == 63)   # gid 1..62 = downlink MU
        v_nsts = (vb[:, 10:13] @ (1 << np.arange(3, dtype=np.int64))) + 1
        v_sgi = vb[:, 24].astype(bool)
        v_mcs = vb[:, 28:32] @ (1 << np.arange(4, dtype=np.int64))

        # format pick (_plan_one): the non-legacy formats apply when the
        # L-SIG is a valid MCS0 OR failed outright (HT-SIG carries its own
        # CRC); a valid non-MCS0 L-SIG is a legacy payload
        lsig_data = lsig_ok & (l_mcs == 0)
        nl_elig = lsig_data | ~lsig_ok
        pick_vht = vht_ok & (~imag_dom | ~ht_ok)
        pick_ht = ht_ok & ~pick_vht
        is_vht = cand & nl_elig & pick_vht & lsig_data & v_su
        is_ht = cand & nl_elig & pick_ht
        is_l = (cand & lsig_ok & ~(nl_elig & (pick_vht | pick_ht)))

        # vectorized sizing (nES == 1 across this envelope)
        ndbps_l = np.asarray([24, 36, 48, 72, 96, 144, 192, 216],
                             np.int64)[np.clip(l_mcs, 0, 7)]
        l_nsym = -(-(8 * l_len + 16 + 6) // ndbps_l)
        ht_tab = (np.asarray([54, 108, 162, 216, 324, 432, 486, 540],
                             np.int64) if self.bw == BW.BW40 else
                  np.asarray([26, 52, 78, 104, 156, 208, 234, 260],
                             np.int64))
        ht_nss = ht_mcs // 8 + 1
        ndbps_ht = ht_tab[np.clip(ht_mcs % 8, 0, 7)] * np.clip(ht_nss, 1, 2)
        ht_nsym = -(-(8 * ht_len + 16 + 6) // ndbps_ht)
        v_nltf = np.asarray(tables.N_LTF)[np.clip(v_nsts, 0, 4)]
        v_nsym_l = -(-(l_len * 8 + 16 + 6) // 24)
        v_nsym = v_nsym_l - 2 - 1 - v_nltf - 1
        qq = self.q
        lim = cap_len

        for i in np.flatnonzero(cand):
            ws, ls = int(win_start[i]), int(ltf_start[i])
            c, chz, sn = float(cfo[i]), float(cfo_hz[i]), float(snr[i])
            if is_vht[i]:
                if (v_bw[i] != int(self.bw) or v_sgi[i]
                        or not (1 <= v_nsts[i] <= 4)):
                    continue
                if v_nsym[i] <= 0:
                    ndps.append(_Plan(Mod(F.VHT, 0, self.bw,
                                          int(v_nsts[i])), 0, 0, False,
                                      ws, ls, c, chz, sn, ndp=True))
                    continue
                if v_nsts[i] > 2:
                    continue
                mod = Mod(F.VHT, int(v_mcs[i]), self.bw, int(v_nsts[i]))
                n_sym = int(v_nsym[i])
                psdu_len = (n_sym * mod.nDBPS - 16 - 6 * mod.nES) // 8
                if (n_sym * mod.nDBPS > 33000
                        or psdu_len > 4095 * int(v_nsts[i])
                        or ws + ls + (448 + 80 * mod.nLTF + 80
                                      + n_sym * 80) * qq > lim):
                    continue
                plans.append((i, _Plan(mod, n_sym, psdu_len, True, ws, ls,
                                       c, chz, sn)))
            elif is_ht[i]:
                if (ht_bw40[i] != (self.bw == BW.BW40) or ht_mcs[i] > 15
                        or ht_sgi[i] or not (1 <= ht_len[i] <= 4095)):
                    continue
                mod = Mod(F.HT, int(ht_mcs[i]), self.bw, int(ht_nss[i]))
                n_sym = int(ht_nsym[i])
                if (n_sym <= 0 or n_sym * mod.nDBPS > 33000
                        or ws + ls + (448 + 80 * mod.nLTF
                                      + n_sym * 80) * qq > lim):
                    continue
                plans.append((i, _Plan(mod, n_sym, int(ht_len[i]),
                                       bool(ht_aggre[i]), ws, ls, c, chz,
                                       sn)))
            elif is_l[i]:
                if qq != 1 or not (14 <= l_len[i] <= 4095):
                    continue
                n_sym = int(l_nsym[i])
                if (n_sym <= 0 or n_sym * ndbps_l[i] > 33000
                        or ws + ls + 208 + n_sym * 80 > lim):
                    continue
                plans.append((i, _Plan(Mod(F.L, int(l_mcs[i])), n_sym,
                                       int(l_len[i]), False, ws, ls, c,
                                       chz, sn)))
        return plans, ndps

    def decode_capture(self, capture: np.ndarray) -> List[PacketResult]:
        return self.decode_capture_full(capture)[0]

    def decode_capture_full(self, capture: np.ndarray):
        """Decode everything arriving on the dual-chain capture [2, N]:
        legacy and SISO HT/VHT packets by MRC, 2x2 HT/VHT packets by the
        MIMO detector, and VHT NDPs as per-chain channel captures. Returns
        (packets, ndps), ndps a list of per-NDP lists of NdpCapture, one per
        RX chain."""
        capture = np.asarray(capture, dtype=np.complex64)
        if capture.ndim != 2 or capture.shape[0] != 2:
            raise ValueError(f"expected a [2, N] capture, got "
                             f"{capture.shape}")
        with call_span("rx.call") as sp:
            if sp:
                sp.attrs["captures"] = 1
            results: List[PacketResult] = []
            ndps: List[list] = []
            t0s, cap_dev, npad = self._ingest(capture)
            if len(t0s) == 0:
                return results, ndps
            meta = self._parse_sigs(cap_dev, npad, t0s)
            with span("rx.plan"):
                self.stats.n_trigger += len(t0s)
                self.stats.n_sig_ok += int(np.sum(meta["lsig_ok"][:len(t0s)]))
                plans, ndp_plans = self._plan_batch(capture.shape[1], meta,
                                                    len(t0s))
                for p in ndp_plans:
                    nd = self._extract_ndp(capture, p)
                    if nd is not None:
                        ndps.append(nd)
            self.stats.n_ndp += len(ndps)
            futs = self._dispatch_with_mu(cap_dev, npad, plans,
                                          capture.shape[1], meta, len(t0s))
            for i, r in self._finish_plans(futs):
                self.stats.record(r.fmt.name, r.mcs, r.fcs_ok, mu=r.mu)
                results.append(r)
            return results, ndps

    def _extract_ndp(self, capture: np.ndarray, p) -> Optional[list]:
        """CFO-corrected VHT-LTF windows of a detected NDP, one NdpCapture
        per RX chain (host side: the LTFs are a few hundred samples)."""
        from ..mu.sounding import NdpCapture
        n_ltf = p.mod.nLTF
        start = p.win_start + p.ltf_start
        out = []
        for c in range(capture.shape[0]):
            wins = []
            for l in range(n_ltf):
                s = start + (OFF_NLLTF + 80 * l + 16 - 8) * self.q
                seg = capture[c, s:s + 64 * self.q]
                if len(seg) != 64 * self.q:
                    return None
                ramp = np.exp(1j * p.cfo * (np.arange(len(seg)) + s))
                wins.append((seg * ramp).astype(np.complex64))
            out.append(NdpCapture(ltf_iq=np.concatenate(wins),
                                  cfo_rad=p.cfo, snr_db=p.snr))
        return out

    def _plan_one(self, cap_len: int, meta, i):
        """Single-window dual-chain planner: legacy + SISO HT/VHT (MRC
        decode), 2x2 HT/VHT (MIMO decode), VHT NDP (channel capture). The
        SIG parse is MRC-combined and L-SIG validity is not a hard gate for
        HT: the HT-SIG carries its own length and CRC-8."""
        # sync gate (drops mid-packet re-triggers)
        if float(meta["snr"][i]) <= 0.0:
            return None
        lsig_data = bool(meta["lsig_ok"][i]) and int(meta["l_mcs"][i]) == 0
        win_start = int(meta["win_start"][i])
        ltf_start = int(meta["ltf_start"][i])
        cfo = float(meta["cfo"][i])
        cfo_hz = cfo * self.fs / (2 * np.pi) * -1.0
        snr = float(meta["snr"][i])
        l_mcs = int(meta["l_mcs"][i])
        l_len = int(meta["l_len"][i])
        fmt = _pick_nl_format(meta, i) if (lsig_data or not
                                           bool(meta["lsig_ok"][i])) else F.L

        # exact packet ends (the device capture is zero-padded, so a packet
        # ending at cap_len is whole)
        def extent(mod, n_sym):
            off = 448 + 80 * mod.nLTF + (80 if mod.fmt == F.VHT else 0)
            return ltf_start + (off + n_sym * 80) * self.q

        def l_extent(mod, n_sym):
            return ltf_start + (208 + n_sym * 80) * self.q

        if fmt == F.VHT:
            if not lsig_data:
                return None          # VHT nSym derives from the L-SIG length
            bw, gid, nsts, paid, sgi, mcs = parse_vht_siga(meta["vht_bits"][i])
            if not (gid == 0 or gid == 63):
                return None          # downlink MU group, not SU
            if bw != self.bw or sgi or not (1 <= nsts <= 4):
                return None
            mod = Mod(F.VHT, mcs if nsts <= 2 else 0, bw, min(nsts, 2), sgi)
            n_sym_l = int(np.ceil((l_len * 8 + 16 + 6) / 24))
            n_sym = n_sym_l - 2 - 1 - int(tables.N_LTF[nsts]) - 1
            if n_sym <= 0:
                # NDP: channel capture (any announced nSTS up to 4)
                return _Plan(Mod(F.VHT, 0, bw, nsts), 0, 0, False,
                             win_start, ltf_start, cfo, cfo_hz, snr,
                             ndp=True)
            if nsts > 2:
                return None          # data decode envelope: <= 2 streams
            if (win_start + extent(mod, n_sym) > cap_len
                    or n_sym * mod.nDBPS > 33000):
                return None
            psdu_len = (n_sym * mod.nDBPS - 16 - 6 * mod.nES) // 8
            if psdu_len > 4095 * (1 if nsts == 1 else 2):
                return None
            return _Plan(mod, n_sym, psdu_len, True, win_start, ltf_start,
                         cfo, cfo_hz, snr)
        if fmt == F.HT:
            mcs, bw, length, aggre, sgi = parse_ht_sig(meta["ht_bits"][i])
            if bw != self.bw or sgi or mcs > 15:
                return None
            nss = mcs // 8 + 1
            mod = Mod(F.HT, mcs, bw, nss, sgi)
            pp = ppdu_params_nonaggregate(mod, length)
            if (pp.n_sym <= 0 or pp.n_sym * mod.nDBPS > 33000
                    or win_start + extent(mod, pp.n_sym) > cap_len
                    or not (1 <= length <= 4095)):
                return None
            return _Plan(mod, pp.n_sym, length, aggre, win_start, ltf_start,
                         cfo, cfo_hz, snr)
        # legacy payload (MRC decode; 20 MHz only, as in the SISO receiver)
        if not bool(meta["lsig_ok"][i]) or self.q != 1:
            return None
        if not (14 <= l_len <= 4095):
            return None
        mod = Mod(F.L, l_mcs)
        pp = ppdu_params_nonaggregate(mod, l_len)
        if (pp.n_sym <= 0 or pp.n_sym * mod.nDBPS > 33000
                or win_start + l_extent(mod, pp.n_sym) > cap_len):
            return None
        return _Plan(mod, pp.n_sym, l_len, False, win_start, ltf_start,
                     cfo, cfo_hz, snr)
