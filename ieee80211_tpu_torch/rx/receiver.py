"""Batched SISO streaming receiver: trigger -> sync -> CFO -> SIG parse ->
demod -> Viterbi -> MPDU, with automatic format detection.

Port of ieee80211_tpu/rx/receiver.py. A capture is uploaded once to the
receiver's device (float32, or int8 and dequantized there), and every packet
window is gathered from that one device-resident capture:

  * `sig_parse_capture` — config-independent: LTF sync, CFO, L-SIG and
    HT-SIG / VHT-SIG-A decode of every trigger window in one batch, packed
    into nine int32 words per window for one small device->host fetch;
  * `SisoDataDecoder` — one `nn.Module` per (Mod, nSym bucket): the DATA
    field (FFT, equalize, track, demap, deinterleave, Viterbi, descramble,
    VHT-SIG-B check), fetched back as packed bytes.

The dual-chain receiver (rx/mimo.py) reuses this module's windowing and
SIG decode through `capture_windows_mimo` and `sig_parse_mimo_capture`, the
MRC-combined SIG parse of an [nRx, N, 2] capture.

Planning (`_plan_batch`, `_plan_one`) and the byte-level tail (packing, FCS,
A-MPDU walk) are host numpy, copied from the JAX module because that module
imports jax; tests/test_torch_receiver_plan.py pins the copies to it. On a
CUDA receiver every Viterbi decode and every window gather launches a
hand-written kernel (ops/cuda/); device->host fetches go into pinned host
memory behind a CUDA event, so `decode_captures` overlaps the host's work on
one capture with the device's on another.

With `mu_gid` set, downlink MU PPDUs of that group decode in the same
passes (`_plan_mu_batch` -> `_dispatch_mu_sigb` -> `_plan_mu_data`, over
mu/sounding.py's `mu_sigb_parse_capture` and `MuStaDataDecoder` lanes).
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F_nn
from torch import nn

from .. import native
from ..mac import deaggregate_ht, deaggregate_vht
from ..models.pipeline import as_tables, data_tables_from_numpy
from ..ops import coding, demod, sync
from ..ops.cuda.gather import (capture_slice_iq_cuda,
                               capture_slice_iq_mimo_cuda)
from ..specs import BW, CR, F, Mod, tables
from ..specs import interleaver as ilv
from ..specs.crc import fcs_ok
from ..specs.modulation import ppdu_params_nonaggregate
from ..specs.tables import crc8_bits
from ..utils.device import entry_device as _device
from ..utils.metrics import DecodeStats, call_span, on_lane, span
from ..utils.riq import r2c

# field offsets relative to the LTF data start (= STF start + 192 @20 MHz)
OFF_LSIG = 128
OFF_NLSIG = 208      # HT-SIG / VHT-SIG-A first symbol GI
OFF_NLSTF = 368
OFF_NLLTF = 448


def _bits_to_uint(bits: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    w = 1 << torch.arange(n, dtype=torch.int32, device=bits.device)
    return (bits[..., lo:lo + n].to(torch.int32) * w).sum(dim=-1,
                                                           dtype=torch.int32)


@lru_cache(maxsize=None)
def _crc8_matrix(n: int = 34):
    """CRC-8 of n bits as affine map over GF(2): out = M^T b + c."""
    base = np.asarray(crc8_bits([0] * n), dtype=np.int64)
    mat = np.zeros((n, 8), dtype=np.int64)
    for i in range(n):
        v = [0] * n
        v[i] = 1
        mat[i] = (np.asarray(crc8_bits(v)) + base) % 2
    return mat, base


def _gf2_affine(bits: torch.Tensor, mat: torch.Tensor,
                const: torch.Tensor) -> torch.Tensor:
    """(bits @ mat + const) mod 2 for 0/1 bits and float32 tables: a float32
    product of 0/1 values, exact (every sum stays far below 2^24), since the
    card has no integer matmul."""
    return torch.remainder(bits.to(torch.float32) @ mat + const, 2.0)


def _crc8_ok(bits48: torch.Tensor, mat: torch.Tensor,
             const: torch.Tensor) -> torch.Tensor:
    """Batched SIG CRC-8 check: crc8(bits[0:34]) == bits[34:42]. mat, const:
    `_crc8_matrix()` as float32 tensors on the bits' device."""
    calc = _gf2_affine(bits48[..., :34], mat, const)
    return torch.all(calc == bits48[..., 34:42].to(torch.float32), dim=-1)


# --- VHT-SIG-B (SU) decode + SERVICE-field CRC-8 verification -------------
# Dims per 21.3.8.3.6: pre-tail info bits (len+reserved), total info bits
# after the bandwidth repetition (applied BEFORE BCC, tx/golden.py
# vhtsigb_bits).

SIGB_DIMS = {BW.BW20: (20, 26), BW.BW40: (21, 54), BW.BW80: (23, 117)}


def decode_vht_sigb(eq_sym: torch.Tensor, bw: BW, data_idx: torch.Tensor,
                    perm: torch.Tensor, w0: torch.Tensor,
                    w1: torch.Tensor) -> torch.Tensor:
    """Equalized, pilot-corrected SIG-B symbol grid [B, nfft] -> decoded
    SIG-B info bits [B, n_info]. data_idx: `tables.DATA_GRID[(bw, False)]`,
    perm: `rx_perm(Mod(F.VHT, 0, bw, 1))`, (w0, w1): radix tables."""
    _, n_info = SIGB_DIMS[bw]
    llr = eq_sym[..., data_idx].real[..., perm]
    return coding.viterbi_decode(llr.contiguous(), CR.CR12, n_info, w0, w1)


def sigb_service_crc_ok(sigb_bits: torch.Tensor, scr_bits: torch.Tensor,
                        bw: BW, mat: torch.Tensor,
                        const: torch.Tensor) -> torch.Tensor:
    """CRC-8 of the decoded SIG-B pre-tail bits == SERVICE bits 8..15. mat,
    const: `_crc8_matrix(n_pre)` as float32 tensors. [B] bool."""
    n_pre, _ = SIGB_DIMS[bw]
    calc = _gf2_affine(sigb_bits[..., :n_pre], mat, const)
    return torch.all(calc == scr_bits[..., 8:16].to(torch.float32), dim=-1)


# ---------------------------------------------------------------------------
# SIG parsing (config-independent)
# ---------------------------------------------------------------------------

SIGPARSE_WIN = 752   # samples consumed from t0 (x q): sync needs 448
# (80 + n_lag 176 + 192), the SIG region ends at ltf_start(<=270) +
# OFF_NLSIG(208) + 2 symbols(160) + window slack(~76) ~= 714; 752 adds
# margin.

MIN_TRIGGER_GAP = 600  # trigger dedup distance (20 MHz units): the
# non-legacy STF ~560 samples into every HT/VHT packet re-fires the STF
# correlator; real consecutive packets are >= ~880 samples apart (SIFS 320
# + shortest PPDU ~560), so 600 suppresses only the self-re-trigger.


def sig_tables_from_numpy(q: int):
    """Every constant table of the SIG parse at oversample factor q, as
    numpy, built by copies of the JAX package's helpers."""
    bw = {1: BW.BW20, 2: BW.BW40, 4: BW.BW80}[q]
    w0, w1 = coding._radix_tables(coding.RADIX)
    dft_re, dft_im = demod._dft_mats(64 * q)
    d20 = np.asarray(tables.DATA_GRID[(BW.BW20, True)])
    p20 = np.asarray(tables.PILOT_GRID[(BW.BW20, True)])
    pil_l = np.tile(tables.PILOT_L, q)
    mat, const = _crc8_matrix()
    return as_tables({
        "band": sync.ltf_band_mat(q),
        "dft_re": dft_re,
        "dft_im": dft_im,
        "ltf_ref_l": demod.ltf_ref_grid(bw, True),
        "sig_data_idx": np.concatenate([d20 + 64 * c for c in range(q)]),
        "sig_pilot_idx": np.concatenate([p20 + 64 * c for c in range(q)]),
        "lsig_pilot_ref": pil_l[None] * tables.PILOT_POLARITY[0:1, None],
        "nlsig_pilot_ref": pil_l[None] * tables.PILOT_POLARITY[1:3, None],
        "sig_perm": ilv.sig_rx_perm(),
        "rate_tab": tables.LEGACY_RATE_BITS,
        "crc8_mat": mat.astype(np.float32),
        "crc8_const": const.astype(np.float32),
        "vit_w0": w0,
        "vit_w1": w1,
    })


class SigTables(nn.Module):
    """The SIG parse's constant tables at oversample factor q, as buffers."""

    def __init__(self, q: int):
        super().__init__()
        self.q = q
        for name, arr in sig_tables_from_numpy(q).items():
            self.register_buffer(name, torch.from_numpy(arr))


def sig_parse(x2: torch.Tensor, t0: torch.Tensor, tabs: SigTables) -> dict:
    """Parse the preamble of packets at approximate STF starts t0.

    x2: [B, N, 2] float32 I/Q windows; t0: [B] int32; tabs: the SIG tables
    at the capture's oversample factor q (1/2/4 for 20/40/80 MHz). The wide
    legacy-band fields are the 64-bin grid duplicated per 20 MHz subband;
    the duplicate data tones are equal-gain combined after per-subband ZF.
    Returns a dict of per-packet metadata (all [B]-shaped): ltf_start, cfo,
    snr, lsig_ok, l_mcs, l_len, lsig_bits [B, 24], ht_ok, vht_ok, ht_bits
    [B, 48], vht_bits [B, 48], nl1_imag_dom.
    """
    ltf_start, cfo, snr = sync.sync_front_iq(x2, t0, tabs.band, q=tabs.q)
    y = sync.apply_cfo_correction(r2c(x2), cfo)
    chan = _sig_legacy_chan(y, ltf_start, tabs)           # [B, 64q]

    def sig_eq(start, n_sym, pref):
        eq = demod.equalize(_sig_grids(y, start, n_sym, tabs), chan)
        return _sig_tones(eq, pref, tabs)

    lsig_eq = sig_eq(ltf_start + OFF_LSIG * tabs.q, 1,
                     tabs.lsig_pilot_ref)[:, 0]
    # the two post-L-SIG symbols carry HT-SIG (QBPSK) or VHT-SIG-A (BPSK +
    # QBPSK)
    nl_eq = sig_eq(ltf_start + OFF_NLSIG * tabs.q, 2, tabs.nlsig_pilot_ref)
    out = _sig_fields_from_eq(lsig_eq, nl_eq, tabs)
    out.update(ltf_start=ltf_start, cfo=cfo, snr=snr)
    return out


# The SIG symbols are taken 8q samples into their GI, not the DATA decoders'
# 4q, as in the JAX package.


def _sig_grids(y: torch.Tensor, start: torch.Tensor, n_sym: int,
               tabs: SigTables) -> torch.Tensor:
    """FFT grids [B, n_sym, 64q] of n_sym symbols whose first GI is at
    `start` in the CFO-corrected windows y [B, N]."""
    q = tabs.q
    t = demod.extract_symbol_windows(y, start, n_sym, nfft=64 * q,
                                     gi=16 * q, shift=8 * q)
    return demod.fft_syms(t, tabs.dft_re, tabs.dft_im)


def _sig_legacy_chan(y: torch.Tensor, ltf_start: torch.Tensor,
                     tabs: SigTables) -> torch.Tensor:
    """Legacy channel [B, 64q] from the two L-LTF repetitions."""
    q = tabs.q
    t = demod.extract_symbol_windows(y, ltf_start - 16 * q, 2, nfft=64 * q,
                                     gi=16 * q, shift=8 * q, stride=64 * q)
    return demod.legacy_chan_est(demod.fft_syms(t, tabs.dft_re, tabs.dft_im),
                                 tabs.ltf_ref_l)


def _sig_tones(eq: torch.Tensor, pref: torch.Tensor,
               tabs: SigTables) -> torch.Tensor:
    """Pilot-phase-corrected SIG data tones [B, S, 48] of equalized grids
    [B, S, 64q]: the 20 MHz subbands' copies are summed."""
    ph = demod.pilot_phase(eq, pref, tabs.sig_pilot_idx)
    tones = (eq / ph[..., None])[..., tabs.sig_data_idx]  # [B, S, 48q]
    return tones.reshape(tones.shape[:-1] + (tabs.q, 48)).sum(dim=-2)


def sig_parse_mimo(x2: torch.Tensor, t0: torch.Tensor,
                   tabs: SigTables) -> dict:
    """Multi-chain SIG parse with maximal-ratio combining across RX chains.

    x2: [B, nRx, N, 2] float32 I/Q windows; t0: [B] int32. Every chain is
    synced on its own; the chain with the best LTF correlation (the first
    of equals, as jnp.argmax) gives the timing and the CFO, common to the
    chains, which share one LO. Each chain gets its own legacy channel
    estimate and the SIG tones are MRC-combined before demapping. Returns
    the metadata dict of `sig_parse`, with the best chain's SNR.
    """
    b, nrx = x2.shape[0], x2.shape[1]
    xf = x2.reshape((b * nrx,) + tuple(x2.shape[2:]))
    ls_c, cfo_c, snr_c = (v.reshape(b, nrx) for v in sync.sync_front_iq(
        xf, t0.repeat_interleave(nrx), tabs.band, q=tabs.q))
    best = torch.argmax(snr_c, dim=1)[:, None]
    ltf_start = torch.gather(ls_c, 1, best)[:, 0]
    cfo = torch.gather(cfo_c, 1, best)[:, 0]
    snr = snr_c.amax(dim=1)
    y = sync.apply_cfo_correction(r2c(xf), cfo.repeat_interleave(nrx))
    ls2 = ltf_start.repeat_interleave(nrx)
    chan = _sig_legacy_chan(y, ls2, tabs).reshape(b, nrx, -1)

    def sig_eq(off, n_sym, pref):
        g = _sig_grids(y, ls2 + off, n_sym, tabs)
        eq = demod.mrc_combine(g.reshape((b, nrx) + tuple(g.shape[1:])),
                               chan)
        return _sig_tones(eq, pref, tabs)

    lsig_eq = sig_eq(OFF_LSIG * tabs.q, 1, tabs.lsig_pilot_ref)[:, 0]
    nl_eq = sig_eq(OFF_NLSIG * tabs.q, 2, tabs.nlsig_pilot_ref)
    out = _sig_fields_from_eq(lsig_eq, nl_eq, tabs)
    out.update(ltf_start=ltf_start, cfo=cfo, snr=snr)
    return out


def _sig_fields_from_eq(lsig_eq: torch.Tensor, nl_eq: torch.Tensor,
                        tabs: SigTables) -> dict:
    """Decode L-SIG / HT-SIG / VHT-SIG-A bits from equalized SIG tones.

    lsig_eq: [B, 48] equalized L-SIG data tones; nl_eq: [B, 2, 48] the two
    post-L-SIG symbols.
    """
    perm, w0, w1 = tabs.sig_perm, tabs.vit_w0, tabs.vit_w1
    lsig_llr = lsig_eq.real[:, perm]
    lsig_bits = coding.viterbi_decode(lsig_llr, CR.CR12, 24, w0, w1)
    parity = lsig_bits[:, :17].sum(dim=-1) % 2
    lsig_ok = ((parity == lsig_bits[:, 17]) & (lsig_bits[:, 3] == 1)
               & (lsig_bits[:, 4] == 0))
    rate4 = lsig_bits[:, :4]
    match = torch.all(rate4[:, None, :] == tabs.rate_tab[None], dim=-1)
    # the first matching rate (0 when none matches), as jnp.argmax on bools
    l_mcs = torch.argmax(match.to(torch.int32), dim=-1)
    l_len = _bits_to_uint(lsig_bits, 5, 12)

    im = nl_eq.imag
    re = nl_eq.real
    # constellation-rotation discriminator for symbol 1: HT-SIG is QBPSK
    # (energy on imag), VHT-SIG-A1 is BPSK (energy on real); it resolves the
    # 1-in-256 case where both SIG CRCs pass
    imag_dom = (im[:, 0] ** 2).sum(dim=-1) > (re[:, 0] ** 2).sum(dim=-1)
    ht_llr = torch.cat([im[:, 0][:, perm], im[:, 1][:, perm]], dim=-1)
    vht_llr = torch.cat([re[:, 0][:, perm], im[:, 1][:, perm]], dim=-1)
    ht_bits = coding.viterbi_decode(ht_llr, CR.CR12, 48, w0, w1)
    vht_bits = coding.viterbi_decode(vht_llr, CR.CR12, 48, w0, w1)
    ht_ok = _crc8_ok(ht_bits, tabs.crc8_mat, tabs.crc8_const)
    vht_ok = _crc8_ok(vht_bits, tabs.crc8_mat, tabs.crc8_const)
    return dict(lsig_ok=lsig_ok, l_mcs=l_mcs, l_len=l_len,
                lsig_bits=lsig_bits, ht_ok=ht_ok, vht_ok=vht_ok,
                ht_bits=ht_bits, vht_bits=vht_bits, nl1_imag_dom=imag_dom)


def _pick_nl_format(meta, i) -> F:
    """HT vs VHT vs legacy-MCS0 from SIG CRCs + the QBPSK discriminator."""
    vht_ok = bool(meta["vht_ok"][i])
    ht_ok = bool(meta["ht_ok"][i])
    imag_dom = bool(meta["nl1_imag_dom"][i])
    if vht_ok and not imag_dom:
        return F.VHT
    if ht_ok and imag_dom:
        return F.HT
    if vht_ok:
        return F.VHT
    if ht_ok:
        return F.HT
    return F.L


def parse_ht_sig(bits: np.ndarray):
    mcs = int(np.sum(bits[0:7] << np.arange(7)))
    bw = BW.BW40 if bits[7] else BW.BW20
    length = int(np.sum(bits[8:24] << np.arange(16)))
    aggre = bool(bits[27])
    sgi = bool(bits[31])
    return mcs, bw, length, aggre, sgi


def parse_vht_siga(bits: np.ndarray):
    bw = BW(int(bits[0]) | (int(bits[1]) << 1))
    group_id = int(np.sum(bits[4:10] << np.arange(6)))
    su_nsts = int(np.sum(bits[10:13] << np.arange(3))) + 1
    partial_aid = int(np.sum(bits[13:22] << np.arange(9)))
    sgi = bool(bits[24])
    mcs = int(np.sum(bits[28:32] << np.arange(4)))
    return bw, group_id, su_nsts, partial_aid, sgi, mcs


# ---------------------------------------------------------------------------
# on-device capture windowing: the capture is uploaded ONCE and every window
# is gathered from it on the device, so the host<->device traffic is one
# upload + one small meta fetch + one packed-bytes fetch per (Mod, bucket)
# group
# ---------------------------------------------------------------------------


def next_pow2(n: int, lo: int = 1) -> int:
    n = max(int(n), lo)
    return 1 << (n - 1).bit_length()


def group_pad(n: int) -> int:
    """Decode-group batch padding: pow2 below 256, multiples of 256 above
    (the JAX package bounds its compile shapes this way; kept so that the
    port decodes the same batches)."""
    return next_pow2(n) if n <= 256 else -(-n // 256) * 256


def _pad_capture(x: torch.Tensor, npad: int) -> torch.Tensor:
    """Zero-pad an uploaded capture [n, 2] to its pow2 working length
    [npad, 2] on its device (the host uploads the tight buffer)."""
    return F_nn.pad(x, (0, 0, 0, npad - x.shape[-2]))


def _round_64k(n: int) -> int:
    return -(-n // 65536) * 65536


def capture_windows_plain(cap: torch.Tensor, start: torch.Tensor,
                          length: int) -> torch.Tensor:
    """Plain shared-source gather: cap [N, 2] (any dtype), start [G] ->
    [G, length, 2], out[g] = cap[clip(start[g], 0, N - length) + arange]."""
    s = start.long().clamp(0, cap.shape[0] - length)
    return cap[s[:, None] + torch.arange(length, device=cap.device)]


def capture_windows(cap: torch.Tensor, start: torch.Tensor,
                    length: int) -> torch.Tensor:
    """Gather per-packet windows [G, length, 2] from a device-resident
    capture [N, 2], starts clipped to [0, N - length] (as the JAX package's
    dynamic_slice clips them). A CPU tensor takes the plain version; any
    other launches the shared-source slice kernel, which takes float32."""
    if cap.device.type == "cpu":
        return capture_windows_plain(cap, start, length)
    return capture_slice_iq_cuda(cap, start, length)


def capture_windows_mimo_plain(cap: torch.Tensor, start: torch.Tensor,
                               length: int) -> torch.Tensor:
    """Plain multi-chain gather: cap [nRx, N, 2] (any dtype), start [G] ->
    [G, nRx, length, 2], out[g, r] = cap[r, clip(start[g], 0, N - length)
    + arange(length)]."""
    s = start.long().clamp(0, cap.shape[1] - length)
    idx = s[:, None] + torch.arange(length, device=cap.device)
    return cap[:, idx].transpose(0, 1)


def capture_windows_mimo(cap: torch.Tensor, start: torch.Tensor,
                         length: int) -> torch.Tensor:
    """capture_windows for an [nRx, N, 2] multi-chain capture: the same
    window of every chain, [G, nRx, length, 2]. A CPU tensor takes the
    plain version; any other launches the multi-chain slice kernel, which
    takes float32."""
    if cap.device.type == "cpu":
        return capture_windows_mimo_plain(cap, start, length)
    return capture_slice_iq_mimo_cuda(cap, start, length)


def pack_bits_le(bits: torch.Tensor) -> torch.Tensor:
    """[B, n] 0/1 -> [B, ceil(n/8)] uint8, LSB-first (np.packbits
    bitorder='little'): the decoded-bits fetch shrinks 8x."""
    b, n = bits.shape
    bits = F_nn.pad(bits, (0, -n % 8))
    w = 1 << torch.arange(8, dtype=torch.int32, device=bits.device)
    return (bits.reshape(b, -1, 8).to(torch.int32) * w).sum(
        dim=-1, dtype=torch.int32).to(torch.uint8)


# meta packing: every sig_parse field bit-packed into NINE int32 words per
# window, word for word the JAX package's layout:
#   w0: ltf_start | w1: flags/l_mcs/l_len | w2: lsig bits | w3-4: ht bits
#   w5-6: vht bits | w7: cfo (f32 bitcast) | w8: snr (f32 bitcast)


def _bits_to_words(bits: torch.Tensor, n: int) -> list:
    """[B, n] 0/1 -> list of [B] int32 words, 24 bits per word LSB-first."""
    return [_bits_to_uint(bits, lo, min(24, n - lo)) for lo in range(0, n, 24)]


def _pack_meta(meta: dict) -> torch.Tensor:
    i32 = torch.int32
    w1 = (meta["lsig_ok"].to(i32)
          | (meta["ht_ok"].to(i32) << 1)
          | (meta["vht_ok"].to(i32) << 2)
          | (meta["nl1_imag_dom"].to(i32) << 3)
          | (meta["l_mcs"].to(i32) << 4)
          | (meta["l_len"].to(i32) << 8))
    words = ([meta["ltf_start"].to(i32), w1]
             + _bits_to_words(meta["lsig_bits"], 24)
             + _bits_to_words(meta["ht_bits"], 48)
             + _bits_to_words(meta["vht_bits"], 48))
    f32 = torch.stack([meta["cfo"].to(torch.float32),
                       meta["snr"].to(torch.float32)], dim=1)
    return torch.cat([torch.stack(words, dim=1), f32.view(i32)], dim=1)


def _words_to_bits(words: np.ndarray, n: int) -> np.ndarray:
    """[B, ceil(n/24)] int32 -> [B, n] 0/1 (LSB-first, 24 bits/word)."""
    cols = []
    for i in range(words.shape[1]):
        k = min(24, n - 24 * i)
        cols.append((words[:, i:i + 1] >> np.arange(k)) & 1)
    return np.concatenate(cols, axis=1)


def _unpack_meta(packed: np.ndarray) -> dict:
    packed = np.asarray(packed)
    w1 = packed[:, 1]
    out = {
        "ltf_start": packed[:, 0],
        "lsig_ok": w1 & 1,
        "ht_ok": (w1 >> 1) & 1,
        "vht_ok": (w1 >> 2) & 1,
        "nl1_imag_dom": (w1 >> 3) & 1,
        "l_mcs": (w1 >> 4) & 0xF,
        "l_len": (w1 >> 8) & 0xFFF,
        "lsig_bits": _words_to_bits(packed[:, 2:3], 24),
        "ht_bits": _words_to_bits(packed[:, 3:5], 48),
        "vht_bits": _words_to_bits(packed[:, 5:7], 48),
    }
    f32 = packed[:, 7:9].copy().view(np.float32)
    out["cfo"] = f32[:, 0]
    out["snr"] = f32[:, 1]
    return out


def sig_parse_capture(cap: torch.Tensor, t_clamp: torch.Tensor,
                      t0: torch.Tensor, wlen: int,
                      tabs: SigTables) -> torch.Tensor:
    """sig_parse over windows gathered from a device-resident capture.

    cap: [Npad, 2] float32 (the receiver's dequantized upload; the JAX
    function takes the int8 upload and its scale and dequantizes each window
    the same way); t_clamp: [B] window starts (host-clamped to Npad - wlen);
    t0: [B] STF-start offsets within each window. Returns the packed [B, 9]
    int32 meta array (`_unpack_meta` reverses)."""
    return _pack_meta(sig_parse(capture_windows(cap, t_clamp, wlen), t0,
                                tabs))


def sig_parse_mimo_capture(cap: torch.Tensor, t_clamp: torch.Tensor,
                           t0: torch.Tensor, wlen: int,
                           tabs: SigTables) -> torch.Tensor:
    """sig_parse_mimo over windows of an [nRx, Npad, 2] float32 capture (the
    dual-chain receiver's dequantized upload); the packed [B, 9] int32 meta
    array of `sig_parse_capture`."""
    return _pack_meta(sig_parse_mimo(capture_windows_mimo(cap, t_clamp, wlen),
                                     t0, tabs))


# ---------------------------------------------------------------------------
# DATA-field decoding (config-specialized)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PacketResult:
    fmt: F
    mcs: int
    psdu: bytes
    fcs_ok: bool
    mpdus: List[bytes]
    cfo_hz: float
    snr_db: float
    evm_snr_db: float = 0.0   # EVM SNR (joint over streams)
    sssnr: tuple = ()         # per-stream EVM SNRs
    sigb_ok: Optional[bool] = None  # VHT-SIG-B CRC-8 vs SERVICE field
                                    # (None for non-VHT formats)
    mu: bool = False          # decoded as this STA's downlink MU stream


def decoder_tables_from_numpy(mod: Mod, n_sym: int):
    """Every constant table of a DATA decoder for (mod, n_sym), as numpy:
    the receive step's DATA tables plus, for VHT, the SIG-B ones."""
    out = data_tables_from_numpy(mod, n_sym)
    if mod.fmt == F.VHT:
        mat, const = _crc8_matrix(SIGB_DIMS[mod.bw][0])
        out.update(as_tables({
            "sigb_perm": ilv.rx_perm(Mod(F.VHT, 0, mod.bw, 1)),
            "sigb_pilot_ref": (tables.PILOT_VHT[mod.bw]
                               * tables.PILOT_POLARITY[3]),
            "sigb_crc8_mat": mat.astype(np.float32),
            "sigb_crc8_const": const.astype(np.float32),
        }))
    return out


class SisoDataDecoder(nn.Module):
    """Batched DATA-field decoder for one static (Mod, nSym-bucket) config.

    n_sym is the symbol capacity. Packets with fewer true symbols pass their
    count in `n_valid`: LLRs past the true extent are zeroed (path-neutral in
    the Viterbi) and left out of the EVM, so one decoder serves every packet
    length in the bucket. Its state is the constant tables of
    `decoder_tables_from_numpy`, held as buffers.
    """

    def __init__(self, mod: Mod, n_sym: int, psdu_len: int = 0):
        super().__init__()
        self.mod = mod
        self.n_sym = n_sym
        self.psdu_len = psdu_len
        self.n_bits = n_sym * mod.nDBPS
        self.q = tables.NFFT[mod.bw] // 64
        for name, arr in self._tables(mod, n_sym).items():
            self.register_buffer(name, torch.from_numpy(arr))

    @staticmethod
    def _tables(mod: Mod, n_sym: int):
        return decoder_tables_from_numpy(mod, n_sym)

    def data_offset(self) -> int:
        """DATA field GI offset relative to the LTF data start (in samples
        at the capture rate: 20 MHz-unit offsets x q)."""
        if self.mod.fmt == F.L:
            off = OFF_LSIG + 80
        elif self.mod.fmt == F.HT:
            off = OFF_NLLTF + 80 * self.mod.nLTF
        else:
            off = OFF_NLLTF + 80 * self.mod.nLTF + 80   # VHT: + SIG-B
        return off * self.q

    def zlen(self) -> int:
        """Aligned-window length: index 0 == ltf_start - gi."""
        return 32 * self.q + self.data_offset() + 80 * self.q * self.n_sym

    def _fft(self, x: torch.Tensor) -> torch.Tensor:
        return demod.fft_syms(x, self.dft_re, self.dft_im)

    def _decode_z(self, z: torch.Tensor,
                  n_valid: Optional[torch.Tensor] = None):
        """Aligned decode: z [B, zlen] complex, CFO-corrected, index 0 ==
        ltf_start - gi; every symbol extraction is a static slice. Returns
        (descrambled bits [B, n_bits] int32, evm_snr_db [B], sigb_ok [B])."""
        mod = self.mod
        q = self.q
        # data-window shift 4q, not 8q: re-centres the timing margin for
        # delay spread (as the JAX decoder and models/pipeline.py)
        nfft, gi, sh = 64 * q, 16 * q, 4 * q
        if mod.fmt == F.L:
            ltf_t = demod.static_symbol_windows(z, 0, 2, nfft=nfft, gi=gi,
                                                shift=sh, stride=nfft)
            chan = demod.legacy_chan_est(self._fft(ltf_t), self.ltf_ref_l)
        else:
            # channel update from the first non-legacy LTF
            ltf_t = demod.static_symbol_windows(
                z, gi + OFF_NLLTF * q, 1, nfft=nfft, gi=gi, shift=sh)
            chan = demod.nonlegacy_chan_est_siso(self._fft(ltf_t)[:, 0],
                                                 self.ltf_ref_nl)
        g = self._fft(demod.static_symbol_windows(
            z, gi + self.data_offset(), self.n_sym, nfft=nfft, gi=gi,
            shift=sh))
        llrs, evm = demod.demod_data_siso(
            g, chan, mod, self.pilot_ref, self.pilot_idx, self.data_idx,
            self.rx_perm, with_snr=True, n_valid_sym=n_valid)
        bits = coding.viterbi_decode(llrs, mod.cr, self.n_bits, self.vit_w0,
                                     self.vit_w1)
        scr = coding.descramble(bits, self.prbs, self.seed_inv)
        if mod.fmt == F.VHT:
            # VHT-SIG-B decode + SERVICE CRC-8 check
            sb = self._fft(demod.static_symbol_windows(
                z, gi + self.data_offset() - 80 * q, 1, nfft=nfft, gi=gi,
                shift=sh))[:, 0]
            eq = sb / chan
            acc = torch.sum(eq[:, self.pilot_idx]
                            * torch.conj(self.sigb_pilot_ref)[None], dim=-1)
            ph = acc / torch.clamp_min(torch.abs(acc), 1e-12)
            sigb_bits = decode_vht_sigb(eq / ph[:, None], mod.bw,
                                        self.data_idx, self.sigb_perm,
                                        self.vit_w0, self.vit_w1)
            sigb_ok = sigb_service_crc_ok(sigb_bits, scr, mod.bw,
                                          self.sigb_crc8_mat,
                                          self.sigb_crc8_const)
        else:
            sigb_ok = torch.ones(z.shape[0], dtype=torch.bool,
                                 device=z.device)
        return scr, evm, sigb_ok

    def _decode(self, x2: torch.Tensor, ltf_start: torch.Tensor,
                cfo: torch.Tensor, n_valid: Optional[torch.Tensor] = None):
        """x2: [B, N, 2] float32 raw windows; ltf_start, cfo: [B]. One
        aligned slice, then the static decode."""
        gi = 16 * self.q
        z2 = sync.batch_slice_iq(x2, ltf_start - gi, self.zlen())
        z = r2c(z2) * sync.cfo_ramp(cfo, self.zlen())
        return self._decode_z(z, n_valid)

    def decode(self, x2: torch.Tensor, ltf_start: torch.Tensor,
               cfo: torch.Tensor, n_valid: Optional[torch.Tensor] = None):
        """Returns numpy (descrambled bits [B, n_bits], evm_snr_db [B])."""
        bits, evm, _ = self._decode(x2, ltf_start, cfo, n_valid)
        return bits.cpu().numpy(), evm.cpu().numpy()

    def window_capacity(self) -> int:
        """Static window length covering any in-bucket packet: max
        ltf_start (sync search span) + DATA offset + bucket extent."""
        return (272 * self.q + self.data_offset()
                + (self.n_sym * 80 + 80) * self.q)

    def decode_from_capture(self, cap: torch.Tensor, t_abs: torch.Tensor,
                            ltf_start: torch.Tensor, cfo: torch.Tensor,
                            n_valid: torch.Tensor):
        """Batched decode with ONE aligned window gather per packet from the
        device-resident capture (t_abs + ltf_start - gi), so everything
        downstream is static slicing. Returns (packed descrambled bytes
        [G, n_bits/8] uint8, evm [G], sigb_ok [G]) on the capture's
        device, without waiting for it."""
        gi = 16 * self.q
        zl = self.zlen()
        x2 = capture_windows(cap, t_abs + ltf_start - gi, zl)
        z = r2c(x2) * sync.cfo_ramp(cfo, zl)
        bits, evm, sigb_ok = self._decode_z(z, n_valid)
        return pack_bits_le(bits), evm, sigb_ok


N_SYM_BUCKET = 16   # decoder symbol-capacity granularity: a mixed-length
                    # capture uses one decoder per (Mod, bucket), not per
                    # exact n_sym


def _bucket(n_sym: int) -> int:
    return -(-n_sym // N_SYM_BUCKET) * N_SYM_BUCKET


@lru_cache(maxsize=64)
def _cached_decoder(mod: Mod, n_sym_bucket: int,
                    device: torch.device) -> SisoDataDecoder:
    with span("rx.decoder_build") as sp:
        if sp:
            sp.attrs.update(kind="siso", mod=str(mod), bucket=n_sym_bucket)
        return SisoDataDecoder(mod, n_sym_bucket).to(device)


def get_data_decoder(mod: Mod, n_sym_bucket: int,
                     device=None) -> SisoDataDecoder:
    """The decoder of (mod, bucket) with its tables on `device` (default
    the card; "cpu" for the CPU), built once per process."""
    return _cached_decoder(mod, n_sym_bucket, _device(device))


def assemble_packet(fmt: F, mod: Mod, psdu_len: int, scr_bits: np.ndarray,
                    ampdu: bool, cfo_hz: float = 0.0, snr_db: float = 0.0,
                    evm_snr_db: float = 0.0) -> PacketResult:
    """Service-strip + byte-pack + FCS / A-MPDU deaggregation (host side)."""
    psdu_bits = scr_bits[16:16 + psdu_len * 8].astype(np.uint8)
    psdu = np.packbits(psdu_bits, bitorder="little").tobytes()
    return assemble_psdu(fmt, mod, psdu, ampdu, cfo_hz, snr_db, evm_snr_db)


def assemble_psdu(fmt: F, mod: Mod, psdu: bytes, ampdu: bool,
                  cfo_hz: float = 0.0, snr_db: float = 0.0,
                  evm_snr_db: float = 0.0, sssnr: tuple = (),
                  sigb_ok=None) -> PacketResult:
    """FCS / A-MPDU deaggregation from already-packed PSDU bytes."""
    if fmt == F.VHT:
        mpdus = [s.mpdu for s in deaggregate_vht(psdu) if s.fcs_ok]
        ok = len(mpdus) > 0
    elif ampdu:
        mpdus = [s.mpdu for s in deaggregate_ht(psdu) if s.fcs_ok]
        ok = len(mpdus) > 0
    else:
        ok = fcs_ok(psdu)
        mpdus = [psdu] if ok else []
    return PacketResult(fmt=fmt, mcs=mod.mcs, psdu=psdu, fcs_ok=ok,
                        mpdus=mpdus, cfo_hz=cfo_hz, snr_db=snr_db,
                        evm_snr_db=evm_snr_db,
                        sssnr=sssnr if sssnr else (evm_snr_db,),
                        sigb_ok=sigb_ok)


# ---------------------------------------------------------------------------
# capture-level receiver (auto-detecting)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Plan:
    """One detected packet's decode parameters (host-side planning)."""
    mod: Mod
    n_sym: int
    psdu_len: int
    ampdu: bool
    win_start: int       # absolute capture index of its SIG window start
    ltf_start: int       # LTF data start relative to win_start
    cfo: float
    cfo_hz: float
    snr: float
    ndp: bool = False
    mu: bool = False     # downlink MU PPDU (own-stream decode)
    stream_idx: int = 0  # this STA's space-time stream index in the group
    n_sts_tot: int = 0   # group total streams (sets nLTF / data offset)
    sigb_crc: int = 0    # expected CRC-8 of the SIG-B pre-tail bits


@dataclasses.dataclass
class _MuCand:
    """An MU candidate window awaiting its SIG-B (mcs, len) decode."""
    win_start: int
    ltf_start: int
    cfo: float
    cfo_hz: float
    snr: float
    n_sym: int
    stream_idx: int
    n_sts_tot: int


class _Fetch:
    """A device->host copy in flight. On the card the copy goes into pinned
    host memory behind a CUDA event, so the host waits only when it needs
    the values; on the CPU the tensor is already there."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.device.type == "cpu":
            self.host = t
            return
        self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self.host.copy_(t, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(t.device))

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class SisoReceiver:
    """Decode packets from a capture with automatic format detection, on the
    receiver's device: the card unless `device="cpu"` asks for the CPU
    (without a card, the default raises).

    The capture is uploaded once (int8-quantized with `ingest="int8"`, and
    by default beyond ~1M samples), all SIG parsing runs as one batch with a
    single packed-meta fetch, and the DATA pass groups packets by
    (Mod, nSym-bucket) with one decode and one packed-bytes fetch per group.
    Per capture: 1 upload + 1 meta fetch + 1 fetch per group (+ 1 trigger
    fetch with `trigger="device"`). `n_waits` counts the times the host
    waited for the device.
    """

    def __init__(self, sample_rate_hz: float = 20e6, stats=None,
                 ingest: str = "auto", trigger: str = "host",
                 mu_pos: int = 0, mu_gid: Optional[int] = None,
                 device=None):
        """mu_pos/mu_gid: this station's MU-MIMO group position and group
        id. With mu_gid set, downlink MU PPDUs of that group decode in the
        same batched passes as SU traffic; with None (the default) MU
        planning is skipped."""
        self.fs = sample_rate_hz
        self.q = int(round(sample_rate_hz / 20e6))
        if self.q not in (1, 2, 4):
            raise ValueError("sample rate must be 20/40/80 MHz")
        if ingest not in ("auto", "f32", "int8"):
            raise ValueError("ingest must be 'auto', 'f32' or 'int8'")
        if trigger not in ("host", "device"):
            raise ValueError("trigger must be 'host' or 'device'")
        self.bw = {1: BW.BW20, 2: BW.BW40, 4: BW.BW80}[self.q]
        self.ingest = ingest
        self.trigger = trigger
        self.mu_pos = mu_pos
        self.mu_gid = mu_gid
        self.device = _device(device)
        self.sig = SigTables(self.q).to(self.device)
        self.stats = stats if stats is not None else DecodeStats()
        self.n_waits = 0

    # -- host <-> device -----------------------------------------------------
    def _on_card(self) -> bool:
        return self.device.type == "cuda"

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """Small host array -> the receiver's device without a host wait
        (through pinned memory on the card)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if not self._on_card():
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _wait(self, fetch: _Fetch, what: str) -> np.ndarray:
        """The host waits for a fetch: `what` names it in the
        `rx.fetch_wait` span (trigger, meta, data or mu_sigb)."""
        self.n_waits += 1
        with span("rx.fetch_wait") as sp:
            if sp:
                sp.attrs["what"] = what
            return fetch.result()

    def _mode(self, npad: int) -> str:
        if self.ingest == "auto":
            return "int8" if npad > (1 << 20) else "f32"
        return self.ingest

    def _host_buffer(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        """Zeroed host buffer, pinned when the receiver is on the card so
        that its upload does not block."""
        return torch.zeros(shape, dtype=dtype, pin_memory=self._on_card())

    def _cap_to_device(self, buf: torch.Tensor, scale, npad: int
                       ) -> torch.Tensor:
        """Upload the tight host buffer [..., n_r, 2], dequantize it (int8)
        and zero-pad it on the device: float32 [..., npad, 2]. scale is a
        float, or a float32 array that broadcasts over the buffer (one
        scale per chain). An int8 value times the float32 scale is the JAX
        package's per-window dequantization."""
        with span("rx.ingest.upload"):
            dev = buf.to(self.device, non_blocking=True)
            if isinstance(scale, np.ndarray):
                dev = dev.to(torch.float32) * self._to_device(scale)
            elif scale is not None:
                dev = dev.to(torch.float32) * float(np.float32(scale))
            return _pad_capture(dev, npad)

    # -- upload ------------------------------------------------------------
    def _upload(self, capture: np.ndarray):
        """Quantize + zero-pad the capture to a pow2 length and ship it to
        the device once. Returns (cap_dev float32 [npad, 2], npad).

        ingest="auto" sends float32 for short captures and peak-normalized
        int8 beyond ~1M samples (8-bit I/Q costs -48 dB of quantization
        noise). Peak normalization lets one strong impulse compress the
        rest's dynamic range: pass ingest="f32" where the front end does
        not limit impulses."""
        capture = np.ascontiguousarray(capture, dtype=np.complex64)
        n = len(capture)
        npad = next_pow2(n + 4096, lo=1 << 15)
        n_r = min(_round_64k(n), npad)
        if self._mode(npad) == "int8":
            buf = self._host_buffer((n_r, 2), torch.int8)
            q8 = buf.numpy()
            s = native.quantize_int8(capture, q8[:n])
            if s is None:                        # no native toolchain
                peak = float(max(np.abs(capture.real).max(initial=0.0),
                                 np.abs(capture.imag).max(initial=0.0),
                                 1e-12))
                sc = 126.0 / peak
                q8[:n, 0] = np.clip(np.round(capture.real * sc), -127, 127)
                q8[:n, 1] = np.clip(np.round(capture.imag * sc), -127, 127)
                s = 1.0 / sc
            return self._cap_to_device(buf, s, npad), npad
        buf = self._host_buffer((n_r, 2), torch.float32)
        buf.numpy()[:n] = capture.view(np.float32).reshape(-1, 2)
        return self._cap_to_device(buf, None, npad), npad

    def _ingest(self, capture: np.ndarray):
        """Trigger scan + quantize + upload with the fewest host passes.

        On the int8 path the native runtime fuses the STF trigger scan,
        peak tracking and int8 quantization into one call over the capture
        (ieee80211_tpu/native/phyrt.cc phyrt_scan_quantize). Returns
        (t0s, cap_dev, npad)."""
        capture = np.ascontiguousarray(capture, dtype=np.complex64)
        n = len(capture)
        npad = next_pow2(n + 4096, lo=1 << 15)
        with span("rx.ingest") as sp:
            if sp:
                sp.attrs.update(k=sp.n, mode=self._mode(npad), samples=n)
            if self._mode(npad) == "int8" and native.available():
                buf = self._host_buffer((min(_round_64k(n), npad), 2),
                                        torch.int8)
                with span("rx.ingest.scan"):
                    t0s, s = native.scan_quantize(
                        capture, buf.numpy()[:n], thresh=0.5,
                        plateau=20 * self.q, min_gap=MIN_TRIGGER_GAP * self.q,
                        lag=16 * self.q)
                return (np.asarray(t0s, dtype=np.int64),
                        self._cap_to_device(buf, s, npad), npad)
            with span("rx.ingest.scan"):
                t0s = np.asarray(sync.find_triggers_np(
                    capture, q=self.q, min_gap=MIN_TRIGGER_GAP),
                    dtype=np.int64)
            cap_dev, npad = self._upload(capture)
            return t0s, cap_dev, npad

    def _ingest_device(self, capture: np.ndarray, k_max: int = 4096):
        """Quantize + upload + the trigger scan ON THE DEVICE, fetched
        without a wait. Returns (trigger fetch, cap_dev, npad); the fetch
        holds [n_trig, t0_0, ..., t0_{k_max-1}] (see _trigger_starts)."""
        with span("rx.ingest") as sp:
            cap_dev, npad = self._upload(capture)
            if sp:
                sp.attrs.update(k=sp.n, mode=self._mode(npad),
                                samples=capture.shape[-1])
            with span("rx.ingest.scan"):
                trig, ntrig = sync.trigger_scan_capture(
                    cap_dev, k_max=k_max, q=self.q, min_gap=MIN_TRIGGER_GAP)
                return (_Fetch(torch.cat([ntrig[None], trig])), cap_dev,
                        npad)

    def _trigger_starts(self, fetch: _Fetch) -> np.ndarray:
        arr = self._wait(fetch, "trigger")
        n_t = min(int(arr[0]), len(arr) - 1)
        return arr[1:1 + n_t].astype(np.int64)

    def _decode_captures_device(self, caps) -> List[List[PacketResult]]:
        """decode_captures with the trigger scan ON THE DEVICE: a 2-deep
        software pipeline, so that every device fetch (trigger array,
        packed meta) has a full iteration of host work to hide behind
        before the main thread needs it."""
        n = len(caps)
        st1: list = [None] * n      # (trigger fetch, cap_dev, npad)
        st2: list = [None] * n      # (t0s, cap_dev, npad, meta fetch, tc)
        st3: list = [None] * n      # futs

        def stage_a(k):
            """Trigger fetch -> SIG dispatch."""
            fetch, cap_dev, npad = st1[k]
            t0s = self._trigger_starts(fetch)
            if len(t0s) > 0:
                packed, t_clamp = self._dispatch_sigs(cap_dev, npad, t0s)
                st2[k] = (t0s, cap_dev, npad, packed, t_clamp)
            st1[k] = None

        def stage_b(k):
            """Meta fetch -> plan -> DATA dispatch."""
            if st2[k] is None:
                return
            t0s, cap_dev, npad, packed, t_clamp = st2[k]
            meta, plans = self._plan(k, caps[k], t0s, packed, t_clamp)
            st3[k] = self._dispatch_with_mu(cap_dev, npad, plans,
                                            caps[k].shape[-1], meta,
                                            len(t0s))
            st2[k] = None

        out: List[List[PacketResult]] = [[] for _ in range(n)]

        def stage_c(k):
            if st3[k] is None:
                return
            results = []
            for i, r in self._finish_plans(st3[k]):
                self.stats.record(r.fmt.name, r.mcs, r.fcs_ok, mu=r.mu)
                results.append(r)
            out[k] = results
            st3[k] = None

        with ThreadPoolExecutor(max_workers=1) as ex:
            ingest = on_lane(self._ingest_device)
            fut = ex.submit(ingest, caps[0]) if n else None
            for k in range(n):
                with span("rx.ingest_wait"):
                    st1[k] = fut.result()
                fut = ex.submit(ingest, caps[k + 1]) if k + 1 < n else None
                if k >= 1:
                    stage_a(k - 1)
                if k >= 2:
                    stage_b(k - 2)
                if k >= 4:
                    stage_c(k - 4)
            if n:
                stage_a(n - 1)
                if n >= 2:
                    stage_b(n - 2)
                stage_b(n - 1)
        for k in range(n):
            stage_c(k)
        return out

    # -- main entry --------------------------------------------------------
    def decode_capture(self, capture: np.ndarray,
                       max_window: Optional[int] = None) -> List[PacketResult]:
        del max_window  # packet windows are sized from the decoded length
        return self.decode_capture_full(capture)[0]

    def decode_capture_full(self, capture: np.ndarray):
        """Decode data packets AND surface NDP channel reports.

        Returns (packets, ndp_captures): an NDP detected during planning
        (VHT, nSym == 0) yields an mu.sounding.NdpCapture with the
        CFO-corrected VHT-LTF windows.
        """
        with call_span("rx.call") as sp:
            if sp:
                sp.attrs["captures"] = 1
            capture = np.ascontiguousarray(capture, dtype=np.complex64)
            t0s, cap_dev, npad = self._ingest(capture)
            results: List[PacketResult] = []
            ndps = []
            if len(t0s) == 0:
                return results, ndps
            meta = self._parse_sigs(cap_dev, npad, t0s)
            with span("rx.plan"):
                self.stats.n_trigger += len(t0s)
                self.stats.n_sig_ok += int(np.sum(meta["lsig_ok"][:len(t0s)]))
                plans, ndp_plans = self._plan_batch(len(capture), meta,
                                                    len(t0s))
                for p in ndp_plans:
                    ndps.append(self._extract_ndp(capture, p))
            futs = self._dispatch_with_mu(cap_dev, npad, plans, len(capture),
                                          meta, len(t0s))
            self.stats.n_ndp += sum(n is not None for n in ndps)
            for i, r in self._finish_plans(futs):
                self.stats.record(r.fmt.name, r.mcs, r.fcs_ok, mu=r.mu)
                results.append(r)
            return results, [n for n in ndps if n is not None]

    def decode_captures(self, captures) -> List[List[PacketResult]]:
        """Pipelined decode of a STREAM of captures.

        Same per-capture results as decode_capture, but the phases are
        software-pipelined across the stream: (1) ingest (on a worker
        thread, one capture ahead) + SIG dispatch, (2) meta fetch -> plan ->
        DATA dispatch two captures behind, so the meta fetch has two
        ingests of cover, (3) result fetch + MAC assembly four captures
        behind. Run-ahead is bounded, so buffers are freed as the stream
        advances. Data packets only: decode_captures_full also surfaces
        NDP channel reports.
        """
        with call_span("rx.call") as sp:
            caps = [np.ascontiguousarray(c, dtype=np.complex64)
                    for c in captures]
            if sp:
                sp.attrs["captures"] = len(caps)
            if self.trigger == "device":
                return self._decode_captures_device(caps)
            return self._decode_captures_host(caps)

    def _decode_captures_host(self, caps) -> List[List[PacketResult]]:
        """decode_captures with the trigger scan on the host, in the ingest
        worker."""
        n = len(caps)
        st2: list = [None] * n
        st3: list = [None] * n
        done: list = [None] * n

        def phase2(k):
            """Meta fetch -> vectorized plan -> DATA dispatch."""
            if st2[k] is None:
                return None
            t0s, cap_dev, npad, packed, t_clamp = st2[k]
            meta, plans = self._plan(k, caps[k], t0s, packed, t_clamp)
            return self._dispatch_with_mu(cap_dev, npad, plans,
                                          caps[k].shape[-1], meta, len(t0s))

        def phase3(k):
            """Result fetch + MAC assembly."""
            if st3[k] is not None:
                done[k] = self._finish_plans(st3[k])
                st3[k] = None

        with ThreadPoolExecutor(max_workers=1) as ex:
            ingest = on_lane(self._ingest)
            fut = ex.submit(ingest, caps[0]) if n else None
            for k in range(n):
                with span("rx.ingest_wait"):
                    t0s, cap_dev, npad = fut.result()
                fut = ex.submit(ingest, caps[k + 1]) if k + 1 < n else None
                if len(t0s) > 0:
                    packed, t_clamp = self._dispatch_sigs(cap_dev, npad,
                                                          t0s)
                    st2[k] = (t0s, cap_dev, npad, packed, t_clamp)
                del cap_dev
                if k >= 2:
                    st3[k - 2] = phase2(k - 2)
                    st2[k - 2] = None
                if k >= 4:
                    phase3(k - 4)
        for k in (n - 2, n - 1):
            if k >= 0:
                st3[k] = phase2(k)
                st2[k] = None
        for k in range(n):                          # drain the tail
            phase3(k)
        out: List[List[PacketResult]] = [[] for _ in range(n)]
        for k in range(n):
            for i, r in done[k] or ():
                self.stats.record(r.fmt.name, r.mcs, r.fcs_ok, mu=r.mu)
                out[k].append(r)
        return out

    def decode_captures_full(self, captures):
        """decode_captures that ALSO surfaces NDP channel captures.

        Returns (results, ndps): per-capture packet lists plus per-capture
        lists of NDP channel captures.
        """
        self._stream_ndps = ndps = [[] for _ in captures]
        try:
            results = self.decode_captures(captures)
        finally:
            self._stream_ndps = None
        return results, ndps

    _stream_ndps = None

    def _plan(self, k: int, capture: np.ndarray, t0s, packed: _Fetch,
              t_clamp):
        """A stream capture's meta fetch, counters, plan and NDPs. Returns
        (meta, data plans)."""
        with span("rx.plan"):
            meta = self._finish_sigs(packed, t_clamp)
            self.stats.n_trigger += len(t0s)
            self.stats.n_sig_ok += int(np.sum(meta["lsig_ok"][:len(t0s)]))
            plans, ndp_plans = self._plan_batch(capture.shape[-1], meta,
                                                len(t0s))
            self._surface_stream_ndps(k, capture, ndp_plans)
            return meta, plans

    def _surface_stream_ndps(self, k: int, capture: np.ndarray, ndp_plans):
        if self._stream_ndps is None:
            self.stats.n_ndp += len(ndp_plans)
            return
        for p in ndp_plans:
            nd = self._extract_ndp(capture, p)
            if nd is not None:
                self.stats.n_ndp += 1
                self._stream_ndps[k].append(nd)

    def _extract_ndp(self, capture: np.ndarray, p: _Plan):
        """CFO-corrected VHT-LTF windows of a detected NDP (host side: the
        LTFs are a few hundred samples)."""
        from ..mu.sounding import NdpCapture
        n_ltf = p.mod.nLTF
        start = p.win_start + p.ltf_start
        wins = []
        for l in range(n_ltf):
            s = start + (OFF_NLLTF + 80 * l + 16 - 8) * self.q
            seg = capture[s:s + 64 * self.q]
            if len(seg) != 64 * self.q:
                return None
            ramp = np.exp(1j * p.cfo * (np.arange(len(seg)) + s))
            wins.append((seg * ramp).astype(np.complex64))
        return NdpCapture(ltf_iq=np.concatenate(wins), cfo_rad=p.cfo,
                          snr_db=p.snr)

    def _dispatch_sigs(self, cap_dev, npad, t0s):
        """Submit the batched SIG parse; returns (meta fetch, t_clamp) for
        _finish_sigs. The non-legacy STF mid-packet also re-fires the
        trigger; those windows fail the SIG gates in _plan_batch."""
        with span("rx.sig_dispatch"):
            wlen = (SIGPARSE_WIN + 320) * self.q
            bpad = -(-len(t0s) // 32) * 32
            t_clamp = np.zeros(bpad, np.int32)
            delta = np.zeros(bpad, np.int32)
            tc = np.minimum(t0s, npad - wlen)
            t_clamp[:len(t0s)] = tc
            delta[:len(t0s)] = t0s - tc
            idx = self._to_device(np.stack([t_clamp, delta]))
            packed = self._sig_parse(cap_dev, idx[0], idx[1], wlen)
            return _Fetch(packed), t_clamp

    def _sig_parse(self, cap_dev, t_clamp, t0, wlen):
        return sig_parse_capture(cap_dev, t_clamp, t0, wlen, self.sig)

    def _finish_sigs(self, packed: _Fetch, t_clamp) -> dict:
        meta = _unpack_meta(self._wait(packed, "meta"))
        meta["win_start"] = t_clamp
        return meta

    def _parse_sigs(self, cap_dev, npad, t0s) -> dict:
        """Batched SIG parse of all trigger windows; one packed fetch."""
        return self._finish_sigs(*self._dispatch_sigs(cap_dev, npad, t0s))

    def _decoder_for(self, mod: Mod, n_sym_bucket: int):
        return get_data_decoder(mod, n_sym_bucket, self.device)

    def _dispatch_plans(self, cap_dev, npad, plans, decoder_for=None):
        """Group plans by (Mod, bucket, MU, stream, nSTS) and submit one
        decode per group. Returns futs for _finish_plans: each group's
        packed bytes, EVM SNRs (one per stream) and SIG-B flag travel back
        in ONE fetch of its real rows. decoder_for overrides `_decoder_for`
        for SU groups (the dual-chain receiver's exact-ML retry pass
        re-dispatches through it); MU groups decode in MuStaDataDecoder
        lanes, which also check each packet's SIG-B CRC-8."""
        groups: dict = {}
        for i, p in plans:
            groups.setdefault((p.mod, _bucket(p.n_sym), p.mu, p.stream_idx,
                               p.n_sts_tot), []).append((i, p))
        futs = []
        for (mod, nb, mu, si, nt), items in groups.items():
            with span("rx.data_dispatch") as sp:
                futs.append(self._dispatch_group(
                    cap_dev, npad, mod, nb, mu, si, nt, items, decoder_for))
                if sp:
                    sp.attrs.update(mod=str(mod), bucket=nb, rows=len(items),
                                    padded_rows=group_pad(len(items)))
        return futs

    def _dispatch_group(self, cap_dev, npad, mod, nb, mu, si, nt, items,
                        decoder_for):
        """One decode group's launch and its fetch: (items, nb_pad, EVMs
        per packet, fetch)."""
        from ..mu.sounding import get_mu_sta_data_decoder
        if mu:
            dec = get_mu_sta_data_decoder(mod, nb, si, nt, self.device)
        else:
            dec = (decoder_for or self._decoder_for)(mod, nb)
        w = dec.window_capacity()
        g = len(items)
        gp = group_pad(g)
        # t_abs, ltf, n_valid, cfo (float32 bits), SIG-B CRC-8
        rows = np.zeros((5, gp), np.int32)
        cfo = np.zeros(gp, np.float32)
        for j, (i, p) in enumerate(items):
            tc = min(p.win_start, npad - w)
            rows[0, j] = tc
            rows[1, j] = p.ltf_start + (p.win_start - tc)
            rows[2, j] = p.n_sym
            rows[4, j] = p.sigb_crc
            cfo[j] = p.cfo
        if gp > g:       # pad rows replicate row 0 (results ignored)
            rows[:, g:] = rows[:, :1]
            cfo[g:] = cfo[0]
        rows[3] = cfo.view(np.int32)
        dev = self._to_device(rows)
        args = (cap_dev, dev[0], dev[1], dev[3].view(torch.float32), dev[2])
        packed, evm, sigb = (dec.decode_from_capture(*args, dev[4]) if mu
                             else dec.decode_from_capture(*args))
        # fetch only the bytes any packet in the group can use, in 256-byte
        # buckets
        nb_need = 2 + max(p.psdu_len for _, p in items)
        nb_pad = min(-(-nb_need // 256) * 256, int(packed.shape[1]))
        evm = evm[:g].reshape(g, -1)     # [g, 1], or [g, 2] for 2x2
        out = torch.cat([packed[:g, :nb_pad],
                         evm.contiguous().view(torch.uint8),
                         sigb[:g, None].to(torch.uint8)], dim=1)
        return items, nb_pad, evm.shape[1], _Fetch(out)

    def _finish_plans(self, futs):
        collected = []
        for items, nb_pad, n_ev, fetch in futs:
            arr = self._wait(fetch, "data")
            with span("rx.assemble"):
                collected += self._assemble_group(items, nb_pad, n_ev, arr)
        collected.sort(key=lambda t: t[0])
        return collected

    @staticmethod
    def _assemble_group(items, nb_pad: int, n_ev: int, arr: np.ndarray):
        """A decode group's fetched bytes, EVMs and SIG-B flags ->
        [(trigger_idx, PacketResult)]: the byte tail, FCS and A-MPDU
        walk."""
        out = []
        pb = arr[:, :nb_pad]
        # one bulk tolist() per group (per-packet numpy scalars are slow)
        ev = arr[:, nb_pad:nb_pad + 4 * n_ev].copy().view(np.float32).tolist()
        sb = arr[:, nb_pad + 4 * n_ev].astype(bool).tolist()
        for j, (i, p) in enumerate(items):
            if p.mu and not sb[j]:
                # MU SIG-B CRC-8 mismatch vs the SERVICE field: the (mcs,
                # len) decode is unreliable; drop, as the reference does
                # (signalParserVhtB)
                continue
            psdu = pb[j, 2:2 + p.psdu_len].tobytes()
            # the joint EVM SNR is the mean of the per-stream ones
            r = assemble_psdu(
                p.mod.fmt, p.mod, psdu, p.ampdu, p.cfo_hz, p.snr,
                sum(ev[j]) / n_ev, sssnr=tuple(ev[j]),
                sigb_ok=(sb[j] if p.mod.fmt == F.VHT else None))
            r.mu = p.mu
            out.append((i, r))
        return out

    def _run_plans(self, cap_dev, npad, plans):
        """Dispatch all groups, fetch + assemble. Returns [(trigger_idx,
        PacketResult)] in trigger order."""
        return self._finish_plans(self._dispatch_plans(cap_dev, npad, plans))

    def _dispatch_with_mu(self, cap_dev, npad, plans, cap_len, meta, n):
        """SU dispatch plus (when mu_gid is set) the two-stage MU chain: the
        MU SIG-B round trip overlaps the SU decode dispatches. Returns futs
        for _finish_plans."""
        mu_cands = []
        if self.mu_gid is not None:
            with span("rx.plan"):
                mu_cands = self._plan_mu_batch(cap_len, meta, n)
        sigb_futs = []
        if mu_cands:
            with span("rx.sig_dispatch"):
                sigb_futs = self._dispatch_mu_sigb(cap_dev, npad, mu_cands)
        futs = self._dispatch_plans(cap_dev, npad, plans)
        if sigb_futs:
            with span("rx.plan"):
                mu_plans = self._plan_mu_data(sigb_futs)
            futs += self._dispatch_plans(cap_dev, npad, mu_plans)
        return futs

    # -- downlink MU-STA decode (streaming, batched) -----------------------
    # MU windows found in planning go through a batched SIG-B lane (one
    # decode per (stream_idx, nSTS) group, one packed word per window
    # fetched) to learn each packet's (mcs, len), then through bucketed
    # MuStaDataDecoder lanes like every other decoder group.

    def _plan_mu_batch(self, cap_len: int, meta, n: int):
        """MU candidate windows: VHT SIG-A with gid == self.mu_gid whose
        group layout gives this station a single stream, at the capture's
        bandwidth. Returns [(i, _MuCand)] for _dispatch_mu_sigb."""
        if self.mu_gid is None:
            return []
        lsig_ok = np.asarray(meta["lsig_ok"][:n]).astype(bool)
        vht_ok = np.asarray(meta["vht_ok"][:n]).astype(bool)
        snr = np.asarray(meta["snr"][:n], np.float64)
        l_mcs = np.asarray(meta["l_mcs"][:n], np.int64)
        l_len = np.asarray(meta["l_len"][:n], np.int64)
        vb = np.asarray(meta["vht_bits"][:n], np.int64)
        gid = vb[:, 4:10] @ (1 << np.arange(6, dtype=np.int64))
        v_bw = vb[:, 0] + 2 * vb[:, 1]
        v_sgi = vb[:, 24].astype(bool)
        # per-user NSTS fields: 4 users x 3 bits at SIG-A bits 10..21
        nsts_u = np.stack([vb[:, 10 + 3 * u:13 + 3 * u]
                           @ (1 << np.arange(3, dtype=np.int64))
                           for u in range(4)], axis=1)      # [n, 4]
        n_tot = nsts_u.sum(axis=1)
        cand = (lsig_ok & vht_ok & (snr > 0.0) & (l_mcs == 0)
                & (gid == self.mu_gid) & (v_bw == int(self.bw)) & ~v_sgi
                & (nsts_u[:, self.mu_pos] == 1)
                & (n_tot >= 1) & (n_tot <= 4))
        if not np.any(cand):
            return []
        win_start = np.asarray(meta["win_start"][:n], np.int64)
        ltf_start = np.asarray(meta["ltf_start"][:n], np.int64)
        cfo = np.asarray(meta["cfo"][:n], np.float64)
        cfo_hz = cfo * self.fs / (2 * np.pi) * -1.0
        n_ltf = np.asarray(tables.N_LTF)[np.minimum(n_tot, 4)]
        n_sym_l = -(-(l_len * 8 + 16 + 6) // 24)
        n_sym = n_sym_l - 2 - 1 - n_ltf - 1
        stream_idx = np.concatenate(
            [np.zeros((n, 1), np.int64),
             np.cumsum(nsts_u, axis=1)[:, :-1]], axis=1)[:, self.mu_pos]
        out = []
        for i in np.flatnonzero(cand):
            if n_sym[i] <= 0:
                continue            # MU NDPs don't exist; gid'd NDP = junk
            # EXACT packet end (SIG-B + data; the device capture is
            # zero-padded past cap_len)
            ext = (int(ltf_start[i])
                   + (448 + 80 * int(n_ltf[i]) + 80
                      + int(n_sym[i]) * 80) * self.q)
            if int(win_start[i]) + ext > cap_len:
                continue
            out.append((i, _MuCand(int(win_start[i]), int(ltf_start[i]),
                                   float(cfo[i]), float(cfo_hz[i]),
                                   float(snr[i]), int(n_sym[i]),
                                   int(stream_idx[i]), int(n_tot[i]))))
        return out

    def _dispatch_mu_sigb(self, cap_dev, npad, mu_cands):
        """Batched SIG-B decode per (stream_idx, nSTS-total) group, each
        group's words fetched behind an event. Returns futs for
        _plan_mu_data."""
        from ..mu.sounding import get_mu_sigb_tables, mu_sigb_parse_capture
        groups: dict = {}
        for i, c in mu_cands:
            groups.setdefault((c.stream_idx, c.n_sts_tot), []).append((i, c))
        futs = []
        for (si, nt), items in groups.items():
            wlen = (272 + 448 + 80 * int(tables.N_LTF[nt]) + 160) * self.q
            g = len(items)
            gp = group_pad(g)
            rows = np.zeros((3, gp), np.int32)   # t_abs, ltf, cfo bits
            cfo = np.zeros(gp, np.float32)
            for j, (i, c) in enumerate(items):
                tc = min(c.win_start, npad - wlen)
                rows[0, j] = tc
                rows[1, j] = c.ltf_start + (c.win_start - tc)
                cfo[j] = c.cfo
            if gp > g:
                rows[:, g:] = rows[:, :1]
                cfo[g:] = cfo[0]
            rows[2] = cfo.view(np.int32)
            dev = self._to_device(rows)
            words = mu_sigb_parse_capture(
                cap_dev, dev[0], dev[1], dev[2].view(torch.float32), wlen,
                get_mu_sigb_tables(self.q, si, nt, self.device))
            futs.append((items, _Fetch(words[:g])))
        return futs

    def _plan_mu_data(self, sigb_futs):
        """Fetch the SIG-B words, apply the (mcs, len) gates, and build the
        final MU _Plans for _dispatch_plans."""
        from ..mu.sounding import MU_SIGB_LEN
        n_len = MU_SIGB_LEN[self.bw]
        plans = []
        for items, fetch in sigb_futs:
            wd = self._wait(fetch, "mu_sigb")
            for j, (i, c) in enumerate(items):
                bits = (int(wd[j]) >> np.arange(n_len + 4)) & 1
                mcs = int(bits[n_len:n_len + 4] @ (1 << np.arange(4)))
                try:
                    mod = Mod(F.VHT, mcs, self.bw, 1)
                except ValueError:
                    continue          # invalid 1-SS MCS at this bandwidth
                psdu_len = (c.n_sym * mod.nDBPS - 16 - 6 * mod.nES) // 8
                if c.n_sym * mod.nDBPS > 33000 or psdu_len <= 0:
                    continue
                crc = int(np.asarray(crc8_bits(list(bits[:n_len + 4])))
                          @ (1 << np.arange(8)))
                plans.append((i, _Plan(
                    mod, c.n_sym, psdu_len, True, c.win_start, c.ltf_start,
                    c.cfo, c.cfo_hz, c.snr, mu=True,
                    stream_idx=c.stream_idx, n_sts_tot=c.n_sts_tot,
                    sigb_crc=crc)))
        return plans

    def _plan_batch(self, cap_len: int, meta, n: int):
        """Vectorized packet planning over all n trigger windows: the gates
        and geometry of _plan_one, with the SIG-field bit arithmetic and
        the gate masks as numpy array ops.
        Returns (data_plans [(i, _Plan)], ndp_plans [_Plan])."""
        snr = np.asarray(meta["snr"][:n], np.float64)
        lsig_ok = np.asarray(meta["lsig_ok"][:n]).astype(bool)
        cand = lsig_ok & (snr > 0.0)
        plans: list = []
        ndps: list = []
        if not np.any(cand):
            return plans, ndps
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
        # format pick, _pick_nl_format precedence, applied when l_mcs == 0
        pick_vht = vht_ok & (~imag_dom | ~ht_ok)
        pick_ht = ht_ok & ~pick_vht
        is_nl = cand & (l_mcs == 0)
        is_vht = is_nl & pick_vht & v_su
        is_ht = is_nl & pick_ht
        is_l = cand & ~is_vht & ~is_ht & ~(is_nl & pick_vht & ~v_su)
        # VHT nSym budget from the spoofed L-SIG length
        v_nltf = np.asarray(tables.N_LTF)[np.minimum(v_nsts, 4)]
        v_nsym_l = -(-(l_len * 8 + 16 + 6) // 24)
        v_nsym = v_nsym_l - 2 - 1 - v_nltf - 1

        # n_sym vectorized (ppdu_params_nonaggregate's ceil formula; nES
        # == 1 across this SISO envelope)
        ndbps_l = np.asarray([24, 36, 48, 72, 96, 144, 192, 216],
                             np.int64)[np.clip(l_mcs, 0, 7)]
        l_nsym = -(-(8 * l_len + 16 + 6) // ndbps_l)
        ht_tab = (np.asarray([54, 108, 162, 216, 324, 432, 486, 540],
                             np.int64) if self.bw == BW.BW40 else
                  np.asarray([26, 52, 78, 104, 156, 208, 234, 260],
                             np.int64))
        ndbps_ht = ht_tab[np.clip(ht_mcs, 0, 7)]
        ht_nsym = -(-(8 * ht_len + 16 + 6) // ndbps_ht)

        qq = self.q
        # completeness gates use the EXACT per-format packet end (the device
        # capture is zero-padded past cap_len). L data starts at 208, HT at
        # 528 (1 LTF), VHT at 608 (+SIG-B), in 20 MHz units from the LTF
        # data start.
        lim = cap_len

        for i in np.flatnonzero(cand):
            ws, ls = int(win_start[i]), int(ltf_start[i])
            c, chz, sn = float(cfo[i]), float(cfo_hz[i]), float(snr[i])
            if is_l[i]:
                if qq != 1 or not (14 <= l_len[i] <= 4095):
                    continue
                n_sym = int(l_nsym[i])
                if (n_sym * ndbps_l[i] > 33000
                        or ws + ls + (208 + n_sym * 80) > lim):
                    continue
                plans.append((i, _Plan(Mod(F.L, int(l_mcs[i])), n_sym,
                                       int(l_len[i]), False, ws, ls, c,
                                       chz, sn)))
            elif is_ht[i]:
                if (ht_bw40[i] != (self.bw == BW.BW40) or ht_mcs[i] > 7
                        or ht_sgi[i] or not (1 <= ht_len[i] <= 4095)):
                    continue          # mcs>7 (2 streams): MIMO receiver
                n_sym = int(ht_nsym[i])
                if (n_sym * ndbps_ht[i] > 33000
                        or ws + ls + (528 + n_sym * 80) * qq > lim):
                    continue
                plans.append((i, _Plan(Mod(F.HT, int(ht_mcs[i]), self.bw,
                                           1, False), n_sym,
                                       int(ht_len[i]), bool(ht_aggre[i]),
                                       ws, ls, c, chz, sn)))
            elif is_vht[i]:
                if (v_bw[i] != int(self.bw) or v_sgi[i]
                        or not (1 <= v_nsts[i] <= 4)):
                    continue
                if v_nsym[i] <= 0:
                    ndps.append(_Plan(Mod(F.VHT, 0, self.bw, int(v_nsts[i])),
                                      0, 0, False, ws, ls, c, chz, sn,
                                      ndp=True))
                    continue
                if v_nsts[i] != 1:
                    continue          # SISO receiver; 2x2: MIMO receiver
                mod = Mod(F.VHT, int(v_mcs[i]), self.bw, 1, False)
                n_sym = int(v_nsym[i])
                psdu_len = (n_sym * mod.nDBPS - 16 - 6 * mod.nES) // 8
                if (n_sym * mod.nDBPS > 33000 or psdu_len > 4095
                        or ws + ls + (608 + n_sym * 80) * qq > lim):
                    continue
                plans.append((i, _Plan(mod, n_sym, psdu_len, True, ws, ls,
                                       c, chz, sn)))
        return plans, ndps

    def _plan_one(self, cap_len: int, meta, i) -> Optional[_Plan]:
        """Single-window planning: the reference form of _plan_batch."""
        if not bool(meta["lsig_ok"][i]):
            return None
        # sync gate: LTF autocorrelation peak > 0.5, i.e. snr > 0 dB; drops
        # mid-packet re-triggers whose junk L-SIG passes parity by chance
        if float(meta["snr"][i]) <= 0.0:
            return None
        win_start = int(meta["win_start"][i])
        ltf_start = int(meta["ltf_start"][i])
        cfo = float(meta["cfo"][i])
        cfo_hz = cfo * self.fs / (2 * np.pi) * -1.0
        snr = float(meta["snr"][i])
        l_mcs = int(meta["l_mcs"][i])
        l_len = int(meta["l_len"][i])

        # length-consistency guards; extent = the EXACT packet end
        def extent(mod, n_sym):
            if mod.fmt == F.L:
                off = 208
            elif mod.fmt == F.HT:
                off = OFF_NLLTF + 80 * mod.nLTF
            else:
                off = OFF_NLLTF + 80 * mod.nLTF + 80
            return ltf_start + (off + n_sym * 80) * self.q

        def fits(mod, n_sym):
            return (0 < n_sym and n_sym * mod.nDBPS <= 33000
                    and win_start + extent(mod, n_sym) <= cap_len)
        fmt = F.L
        if l_mcs == 0:
            fmt = _pick_nl_format(meta, i)
        if fmt == F.L:
            if self.q != 1:
                return None    # legacy payloads exist only at 20 MHz
            if not (14 <= l_len <= 4095):
                return None
            mod = Mod(F.L, l_mcs)
            pp = ppdu_params_nonaggregate(mod, l_len)
            if not fits(mod, pp.n_sym):
                return None
            return _Plan(mod, pp.n_sym, l_len, False, win_start, ltf_start,
                         cfo, cfo_hz, snr)
        if fmt == F.HT:
            mcs, bw, length, aggre, sgi = parse_ht_sig(meta["ht_bits"][i])
            if bw != self.bw or mcs > 15 or sgi:
                return None    # packet bw must match the capture rate;
                               # SGI out of envelope
            nsts = mcs // 8 + 1
            if nsts != 1:
                return None    # SISO receiver; 2x2: MIMO receiver
            if not (1 <= length <= 4095):
                return None
            mod = Mod(F.HT, mcs, bw, nsts, sgi)
            pp = ppdu_params_nonaggregate(mod, length)
            if not fits(mod, pp.n_sym):
                return None
            return _Plan(mod, pp.n_sym, length, aggre, win_start, ltf_start,
                         cfo, cfo_hz, snr)
        # VHT
        bw, gid, nsts, paid, sgi, mcs = parse_vht_siga(meta["vht_bits"][i])
        if not (gid == 0 or gid == 63):
            return None    # downlink MU group, not SU
        if bw != self.bw or sgi or not (1 <= nsts <= 4):
            return None
        # NDP check BEFORE the nSTS gate: a sounding NDP announces the
        # number of sounded streams, and its nSym budget from the spoofed
        # L-SIG length is <= 0
        n_ltf = int(tables.N_LTF[nsts])
        n_sym_l = int(np.ceil((l_len * 8 + 16 + 6) / 24))
        n_sym = n_sym_l - 2 - 1 - n_ltf - 1
        if n_sym <= 0:
            return _Plan(Mod(F.VHT, 0, bw, nsts), 0, 0, False, win_start,
                         ltf_start, cfo, cfo_hz, snr, ndp=True)
        if nsts != 1:
            return None    # SISO receiver; 2x2 data: MIMO receiver
        mod = Mod(F.VHT, mcs, bw, nsts, sgi)
        psdu_len = (n_sym * mod.nDBPS - 16 - 6 * mod.nES) // 8
        if not fits(mod, n_sym) or psdu_len > 4095:
            return None
        return _Plan(mod, n_sym, psdu_len, True, win_start, ltf_start,
                     cfo, cfo_hz, snr)
