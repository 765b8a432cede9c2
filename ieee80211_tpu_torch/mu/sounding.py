"""MU-MIMO station-side processing: NDP capture and MU packet decode.

Port of ieee80211_tpu/mu/sounding.py (`NdpCapture` :29, `sta_capture_ndp`
:35, `MuStaDecoder` :71, `get_mu_sta_decoder` :128, `sta_decode_mu` :134,
`_mu_sigb_fn` :201, `_decode_mu_sigb` :236, `MU_SIGB_LEN` / `MU_SIGB_INFO`
:273, `mu_sigb_parse_capture` :277, `MuStaDataDecoder` :336,
`get_mu_sta_data_decoder` :448). The station side of the sounding loop:
detect a VHT NDP and hand its VHT-LTF windows to the feedback
(mu/feedback.py), and decode the station's own stream of a downlink MU
PPDU from its group position.

Two forms, as in the JAX package:
  * single-shot (`sta_capture_ndp`, `sta_decode_mu`): one capture, one
    trigger at a time. The capture is uploaded once and each trigger's
    window (the rest of the capture from the trigger, as the JAX functions
    slice it on the host) is cut on the device;
  * streaming (`mu_sigb_parse_capture`, `MuStaDataDecoder`): the batched
    lanes of `SisoReceiver(mu_gid=...)` and `MimoReceiver(mu_gid=...)`,
    with every window gathered from the receiver's device-resident capture
    by the slice kernels, one SIG-B decode per (stream, nSTS) group and one
    DATA decode per (Mod, bucket, stream, nSTS) group.

The decoders are `nn.Module`s whose state is the constant tables of
`mu_sta_tables_from_numpy` / `mu_sigb_tables_from_numpy`, as buffers; their
Viterbi decodes launch the hand-written kernel on the card. The single-shot
decoders take their symbols 8 samples into the GI (`extract_symbol_windows`'
default), the streaming ones 4q, as in the JAX package (ROADMAP §3).
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F_nn
from torch import nn

from ..models.pipeline import as_tables
from ..ops import coding, demod, sync
from ..rx.receiver import (OFF_NLLTF, PacketResult, SigTables,
                           assemble_packet, capture_windows,
                           capture_windows_mimo, pack_bits_le,
                           parse_vht_siga, sig_parse)
from ..specs import BW, CR, F, Mod, tables
from ..specs import interleaver as ilv
from ..specs.tables import crc8_bits
from ..utils.device import entry_device
from ..utils.metrics import span
from ..utils.riq import r2c

# MU VHT-SIG-B geometry per bandwidth: (length-field bits, total info bits
# incl. the standard's pre-BCC repetition; tx/golden.vhtsigb_bits_mu)
MU_SIGB_LEN = {BW.BW20: 16, BW.BW40: 17, BW.BW80: 19}
MU_SIGB_INFO = {BW.BW20: 26, BW.BW40: 54, BW.BW80: 117}
_BW_OF_Q = {1: BW.BW20, 2: BW.BW40, 4: BW.BW80}


@dataclasses.dataclass
class NdpCapture:
    ltf_iq: np.ndarray      # [nLtf * 64] complex time samples, CFO-corrected
    cfo_rad: float
    snr_db: float


# ---------------------------------------------------------------------------
# constant tables
# ---------------------------------------------------------------------------


def _own_stream_tables(bw: BW, stream_idx: int,
                       n_sts_total: int) -> Dict[str, np.ndarray]:
    """The tables of the own-stream channel estimate: DFT, VHT-LTF
    reference, the stream's row of the P matrix over the group's LTFs, the
    pilot and data tone maps, and the radix-4 Viterbi tables."""
    n_ltf = int(tables.N_LTF[n_sts_total])
    w0, w1 = coding._radix_tables(coding.RADIX)
    dft_re, dft_im = demod._dft_mats(tables.NFFT[bw])
    return {
        "dft_re": dft_re,
        "dft_im": dft_im,
        "ltf_ref": demod.ltf_ref_grid(bw, False),
        "p_row": tables.P_LTF_4[:max(n_sts_total, 2), :n_ltf][stream_idx],
        "pilot_idx": tables.PILOT_GRID[(bw, False)],
        "data_idx": tables.DATA_GRID[(bw, False)],
        "vit_w0": w0,
        "vit_w1": w1,
    }


def mu_sigb_tables_from_numpy(q: int, stream_idx: int,
                              n_sts_total: int) -> Dict[str, np.ndarray]:
    """Every constant table of an MU SIG-B decode at oversample factor q
    for one (stream, nSTS) group, as numpy, built by copies of the JAX
    package's helpers."""
    bw = _BW_OF_Q[q]
    out = _own_stream_tables(bw, stream_idx, n_sts_total)
    # 4/7/8-stream groups flip SIG-B's sign on some streams
    # (P_SIGB_NSTS478, 21.3.8.3.6 / tx vht_sigb_field)
    sign = (tables.P_SIGB_NSTS478[stream_idx]
            if n_sts_total in (4, 7, 8) else 1.0)
    out.update({
        "sigb_pilot_ref": tables.PILOT_VHT[bw] * tables.PILOT_POLARITY[3],
        "sigb_perm": ilv.rx_perm(Mod(F.VHT, 0, bw, 1)),
        "sigb_sign": np.float32(sign),
        "info_w": 1 << np.arange(MU_SIGB_LEN[bw] + 4, dtype=np.int32),
    })
    return as_tables(out)


def mu_sta_tables_from_numpy(mod: Mod, n_sym: int, stream_idx: int,
                             n_sts_total: int) -> Dict[str, np.ndarray]:
    """Every constant table of an MU own-stream DATA decode for (mod, n_sym,
    stream, nSTS), as numpy: the own-stream tables, the DATA pilots, the
    deinterleaver and the scrambler tables."""
    out = _own_stream_tables(mod.bw, stream_idx, n_sts_total)
    out.update({
        "pilot_ref": demod.pilot_refs(mod, n_sym, 4),
        "rx_perm": ilv.rx_perm(mod, 0),
        "prbs": coding._prbs_tiled(n_sym * mod.nDBPS),
        "seed_inv": coding._seed_from_first7(),
        "svc_w": 1 << np.arange(8, dtype=np.int32),
    })
    return as_tables(out)


class _TableModule(nn.Module):
    def _register(self, tabs: Dict[str, np.ndarray]):
        for name, arr in tabs.items():
            self.register_buffer(name, torch.from_numpy(arr))

    def _fft(self, x: torch.Tensor) -> torch.Tensor:
        return demod.fft_syms(x, self.dft_re, self.dft_im)

    def _safe_ref(self) -> torch.Tensor:
        return torch.where(self.ltf_ref == 0, 1.0, self.ltf_ref)

    def _own_chan(self, ltf_f: torch.Tensor, n_ltf: int) -> torch.Tensor:
        """Own-stream channel [..., nfft] from the LTF grids [..., nLtf,
        nfft] by P-row combining (the P rows are orthogonal over the
        LTFs); 1 on the null tones."""
        h = (torch.einsum("l,...lk->...k", self.p_row.to(ltf_f.dtype), ltf_f)
             / n_ltf / self._safe_ref())
        return torch.where(self.ltf_ref == 0, 1.0 + 0j, h)


class MuSigbTables(_TableModule):
    """The tables of `mu_sigb_tables_from_numpy(q, stream_idx,
    n_sts_total)` as buffers, for `mu_sigb_parse_capture` and the
    single-shot SIG-B decode."""

    def __init__(self, q: int, stream_idx: int, n_sts_total: int):
        super().__init__()
        self.q = q
        self.bw = _BW_OF_Q[q]
        self.stream_idx = stream_idx
        self.n_sts = n_sts_total
        self.n_ltf = int(tables.N_LTF[n_sts_total])
        self._register(mu_sigb_tables_from_numpy(q, stream_idx,
                                                 n_sts_total))

    def decode_bits(self, llr: torch.Tensor) -> torch.Tensor:
        """Equalized SIG-B data-tone LLRs [G, nSD] -> info bits [G,
        MU_SIGB_INFO]: sign flip, deinterleave, Viterbi."""
        llr = (llr * self.sigb_sign)[..., self.sigb_perm]
        return coding.viterbi_decode(llr.contiguous(), CR.CR12,
                                     MU_SIGB_INFO[self.bw], self.vit_w0,
                                     self.vit_w1)


@lru_cache(maxsize=64)
def _cached_sigb_tables(q: int, stream_idx: int, n_sts_total: int,
                        device: torch.device) -> MuSigbTables:
    with span("rx.decoder_build") as sp:
        if sp:
            sp.attrs.update(kind="mu_sigb", stream=stream_idx,
                            n_sts=n_sts_total)
        return MuSigbTables(q, stream_idx, n_sts_total).to(device)


def get_mu_sigb_tables(q: int, stream_idx: int, n_sts_total: int,
                       device=None) -> MuSigbTables:
    """The MU SIG-B tables of (q, stream, nSTS) on `device` (default the
    card; "cpu" for the CPU), built once per process."""
    return _cached_sigb_tables(q, stream_idx, n_sts_total,
                               entry_device(device))


@lru_cache(maxsize=8)
def _sig_tables(q: int, device: torch.device) -> SigTables:
    return SigTables(q).to(device)


def _upload(capture: np.ndarray, device: torch.device) -> torch.Tensor:
    """A complex64 capture [N] -> float32 I/Q [N, 2] on the device."""
    x = torch.from_numpy(np.ascontiguousarray(capture).view(
        np.float32).reshape(-1, 2))
    return x.to(device)


def _rest_of_capture(cap_dev: torch.Tensor, t0: int, wlen: int
                     ) -> torch.Tensor:
    """capture[t0:t0 + wlen] as a [1, wlen, 2] window, cut on the device
    (t0 + wlen <= N: the window is exact, no start is clipped)."""
    start = torch.tensor([t0], dtype=torch.int32, device=cap_dev.device)
    return capture_windows(cap_dev, start, wlen)


def _meta_np(meta: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in meta.items()}


# ---------------------------------------------------------------------------
# single-shot station processing
# ---------------------------------------------------------------------------


def sta_capture_ndp(capture: np.ndarray, n_sts: int = 2, device=None
                    ) -> Optional[NdpCapture]:
    """Find a VHT NDP in a 1-antenna capture and return its LTF windows.
    The SIG parse runs on `device` (default the card; "cpu" for the CPU)."""
    dev = entry_device(device)
    capture = np.asarray(capture, dtype=np.complex64)
    t0s = sync.find_triggers_np(capture)
    if len(t0s) == 0:
        return None
    cap_dev = _upload(capture, dev)
    tabs = _sig_tables(1, dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    for t0 in t0s:
        wlen = min(len(capture) - int(t0), 1600)
        x2 = F_nn.pad(_rest_of_capture(cap_dev, int(t0), wlen),
                      (0, 0, 0, max(wlen, 1360) - wlen))
        meta = _meta_np(sig_parse(x2, zero, tabs))
        if not (bool(meta["lsig_ok"][0]) and bool(meta["vht_ok"][0])):
            continue
        bw, gid, nsts, paid, sgi, mcs = parse_vht_siga(meta["vht_bits"][0])
        l_len = int(meta["l_len"][0])
        n_sym_l = int(np.ceil((l_len * 8 + 16 + 6) / 24))
        n_ltf = tables.N_LTF[n_sts]
        n_sym = n_sym_l - 2 - 1 - n_ltf - 1
        if n_sym > 0:
            continue   # not an NDP
        ltf_start = int(meta["ltf_start"][0]) + int(t0)
        cfo = float(meta["cfo"][0])
        ramp = np.exp(1j * cfo * np.arange(len(capture)))
        y = capture * ramp
        wins = []
        for l in range(n_ltf):
            s = ltf_start + OFF_NLLTF + 80 * l + 16 - 8
            wins.append(y[s:s + 64])
        return NdpCapture(ltf_iq=np.concatenate(wins), cfo_rad=cfo,
                          snr_db=float(meta["snr"][0]))
    return None


class MuStaDecoder(_TableModule):
    """Decode this station's stream of an MU PPDU (1 RX antenna, 20 MHz).

    mupos is the station's space-time stream index within the group (its
    group position when every user has one stream); n_sts_total is the
    group's total stream count (<= 4). Its state is the constant tables of
    `mu_sta_tables_from_numpy`, as buffers."""

    def __init__(self, mod: Mod, n_sym: int, psdu_len: int, mupos: int,
                 n_sts_total: int = 2):
        super().__init__()
        self.mod = mod
        self.n_sym = n_sym
        self.psdu_len = psdu_len
        self.mupos = mupos
        self.n_sts = n_sts_total
        self.n_ltf = int(tables.N_LTF[n_sts_total])
        self.n_bits = n_sym * mod.nDBPS
        self._register(mu_sta_tables_from_numpy(mod, n_sym, mupos,
                                                n_sts_total))

    def forward(self, x2: torch.Tensor, ltf_start: torch.Tensor,
                cfo: torch.Tensor) -> torch.Tensor:
        """x2 [B, N, 2] float32 windows, ltf_start [B] int32, cfo [B] ->
        descrambled bits [B, n_bits] int32."""
        mod = self.mod
        y = sync.apply_cfo_correction(r2c(x2), cfo)
        ltf_f = self._fft(demod.extract_symbol_windows(
            y, ltf_start + OFF_NLLTF, self.n_ltf))       # [B, nLtf, 64]
        h_u = self._own_chan(ltf_f, self.n_ltf)
        # pilot channel: the sum over streams, from LTF1 (R[0] = +1 for all)
        pil = self.pilot_idx
        sum_h_pil = ltf_f[:, 0, :][..., pil] / self._safe_ref()[pil]
        g = self._fft(demod.extract_symbol_windows(
            y, ltf_start + OFF_NLLTF + 80 * self.n_ltf + 80, self.n_sym))
        exp = sum_h_pil[:, None, :] * self.pilot_ref[None]
        acc = torch.sum(g[..., pil] * torch.conj(exp), dim=-1)
        ph = acc / torch.clamp_min(torch.abs(acc), 1e-12)
        eq = g / ph[..., None] / h_u[:, None, :]
        llr = demod.demap_llr(eq[..., self.data_idx], mod.mod)
        llr = llr[..., self.rx_perm].reshape(llr.shape[0], -1)
        bits = coding.viterbi_decode(llr, mod.cr, self.n_bits, self.vit_w0,
                                     self.vit_w1)
        return coding.descramble(bits, self.prbs, self.seed_inv)

    def decode(self, x2, ltf_start, cfo) -> np.ndarray:
        return self(x2, ltf_start, cfo).cpu().numpy()


@lru_cache(maxsize=64)
def _cached_sta(mod: Mod, n_sym: int, psdu_len: int, mupos: int,
                n_sts_total: int, device: torch.device) -> MuStaDecoder:
    with span("rx.decoder_build") as sp:
        if sp:
            sp.attrs.update(kind="mu_sta", mod=str(mod), n_sym=n_sym)
        return MuStaDecoder(mod, n_sym, psdu_len, mupos,
                            n_sts_total).to(device)


def get_mu_sta_decoder(mod: Mod, n_sym: int, psdu_len: int, mupos: int,
                       n_sts_total: int = 2, device=None) -> MuStaDecoder:
    """The single-shot MU decoder on `device` (default the card; "cpu" for
    the CPU), built once per process."""
    return _cached_sta(mod, n_sym, psdu_len, mupos, n_sts_total,
                       entry_device(device))


def _mu_sigb_bits(x2: torch.Tensor, ltf_start: torch.Tensor,
                  cfo: torch.Tensor, tabs: MuSigbTables) -> torch.Tensor:
    """Single-shot MU SIG-B (20 MHz, one chain, 8-sample shift): windows
    x2 [B, N, 2] -> info bits [B, 26]."""
    y = sync.apply_cfo_correction(r2c(x2), cfo)
    ltf_f = tabs._fft(demod.extract_symbol_windows(
        y, ltf_start + OFF_NLLTF, tabs.n_ltf))
    h_u = tabs._own_chan(ltf_f, tabs.n_ltf)
    g = tabs._fft(demod.extract_symbol_windows(
        y, ltf_start + OFF_NLLTF + 80 * tabs.n_ltf, 1))[:, 0]
    pil = tabs.pilot_idx
    sum_h_pil = ltf_f[:, 0, :][..., pil] / tabs._safe_ref()[pil]
    acc = torch.sum(g[..., pil] * torch.conj(
        sum_h_pil * tabs.sigb_pilot_ref[None]), dim=-1)
    ph = acc / torch.clamp_min(torch.abs(acc), 1e-12)
    eq = (g / ph[:, None]) / h_u
    return tabs.decode_bits(eq[..., tabs.data_idx].real)


def _decode_mu_sigb(x2, ltf_start, cfo, mupos: int, n_sts_total: int = 2):
    """MU VHT-SIG-B: 16-bit len/4 + 4-bit mcs. Returns (mcs, length,
    expected_crc8), the CRC-8 of the 20 pre-tail bits, to be checked
    against SERVICE bits 8..15 of the descrambled DATA field; None for an
    MCS above 9."""
    tabs = get_mu_sigb_tables(1, mupos, n_sts_total, x2.device)
    bits = _mu_sigb_bits(x2, ltf_start, cfo, tabs).cpu().numpy()[0]
    length = int(np.sum(bits[0:16] << np.arange(16))) * 4
    mcs = int(np.sum(bits[16:20] << np.arange(4)))
    if mcs > 9:
        return None
    crc = np.asarray(crc8_bits(list(bits[:20])), dtype=np.int64)
    return mcs, length, crc


def sta_decode_mu(capture: np.ndarray, mupos: int, fs_hz: float = 20e6,
                  device=None) -> List[PacketResult]:
    """Decode this STA's stream from downlink MU PPDUs in a 20 MHz capture,
    on `device` (default the card; "cpu" for the CPU). SIG-B is decoded at
    the user's stream position to learn (mcs, length); a packet whose SIG-B
    CRC-8 disagrees with its SERVICE field is dropped."""
    dev = entry_device(device)
    capture = np.asarray(capture, dtype=np.complex64)
    t0s = sync.find_triggers_np(capture)
    out: List[PacketResult] = []
    if len(t0s) == 0:
        return out
    cap_dev = _upload(capture, dev)
    tabs = _sig_tables(1, dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    for t0 in t0s:
        wlen = len(capture) - int(t0)
        x2 = _rest_of_capture(cap_dev, int(t0), wlen)
        meta = _meta_np(sig_parse(x2, zero, tabs))
        if not (bool(meta["lsig_ok"][0]) and bool(meta["vht_ok"][0])):
            continue
        bw, gid, _, _, sgi, _ = parse_vht_siga(meta["vht_bits"][0])
        if bw != BW.BW20 or sgi or not (1 <= gid <= 62):
            continue
        # MU NSTS fields: 4 users x 3 bits at SIG-A bits 10..21 (0 = user
        # absent); this station's stream index = streams before its
        # position
        vb = np.asarray(meta["vht_bits"][0], np.int64)
        nsts_u = [int(vb[10 + 3 * u:13 + 3 * u] @ (1 << np.arange(3)))
                  for u in range(4)]
        n_sts_total = int(sum(nsts_u))
        if not (1 <= n_sts_total <= 4) or mupos >= 4 or nsts_u[mupos] != 1:
            continue                  # absent / multi-stream user: not ours
        stream_idx = int(sum(nsts_u[:mupos]))
        n_ltf = int(tables.N_LTF[n_sts_total])
        l_len = int(meta["l_len"][0])
        n_sym_l = int(np.ceil((l_len * 8 + 16 + 6) / 24))
        n_sym = n_sym_l - 2 - 1 - n_ltf - 1
        if n_sym <= 0:
            continue
        ltf_start = torch.tensor([int(meta["ltf_start"][0])],
                                 dtype=torch.int32, device=dev)
        cfo = torch.tensor([float(meta["cfo"][0])], dtype=torch.float32,
                           device=dev)
        sigb = _decode_mu_sigb(x2, ltf_start, cfo, stream_idx, n_sts_total)
        if sigb is None:
            continue
        mcs, ampdu_len, sigb_crc = sigb
        mod = Mod(F.VHT, mcs, BW.BW20, 1)
        need = int(meta["ltf_start"][0]) + 448 + 80 * n_ltf + 160 + n_sym * 80
        if need > wlen or n_sym * mod.nDBPS > 33000:
            continue
        psdu_len = (n_sym * mod.nDBPS - 16 - 6 * mod.nES) // 8
        dec = get_mu_sta_decoder(mod, n_sym, psdu_len, stream_idx,
                                 n_sts_total, dev)
        bits = dec.decode(x2, ltf_start, cfo)[0]
        # SIG-B CRC-8 vs SERVICE bits 8..15: a mismatch means the SIG-B
        # (mcs, length) decode is unreliable; drop, as the reference does
        if not bool(np.all(np.asarray(bits[8:16]) == sigb_crc)):
            continue
        r = assemble_packet(F.VHT, mod, psdu_len, bits, True,
                            float(meta["cfo"][0]) * fs_hz / (2 * np.pi)
                            * -1.0, float(meta["snr"][0]))
        r.sigb_ok = True
        out.append(r)
    return out


# ---------------------------------------------------------------------------
# streaming, batched MU-STA decode (the receivers' MU lanes)
# ---------------------------------------------------------------------------


def mu_sigb_parse_capture(cap: torch.Tensor, t_abs: torch.Tensor,
                          ltf_start: torch.Tensor, cfo: torch.Tensor,
                          wlen: int, tabs: MuSigbTables) -> torch.Tensor:
    """Batched MU VHT-SIG-B decode over windows of a device-resident
    capture.

    cap: [Npad, 2] (one chain) or [nRx, Npad, 2] (MRC-combined) float32,
    the receiver's dequantized upload (the JAX function takes the int8
    upload and its scale); t_abs: [G] window starts; ltf_start, cfo: [G]
    sync results; tabs: the (q, stream, nSTS) group's tables. Returns [G]
    int32: the length and MCS bits of SIG-B packed LSB first, one word per
    window for one small fetch."""
    q = tabs.q
    nfft, gi, sh = 64 * q, 16 * q, 4 * q
    if cap.dim() == 3:
        x2 = capture_windows_mimo(cap, t_abs, wlen)
    else:
        x2 = capture_windows(cap, t_abs, wlen)[:, None]
    g, nrx = x2.shape[0], x2.shape[1]
    y = r2c(x2) * sync.cfo_ramp(cfo, x2.shape[2])[:, None, :]
    yf = y.reshape(g * nrx, -1)
    ls2 = ltf_start.repeat_interleave(nrx)
    ltf_f = tabs._fft(demod.extract_symbol_windows(
        yf, ls2 + OFF_NLLTF * q, tabs.n_ltf, nfft=nfft, gi=gi,
        shift=sh)).reshape(g, nrx, tabs.n_ltf, nfft)
    h_u = tabs._own_chan(ltf_f, tabs.n_ltf)               # [G, R, nfft]
    sb = tabs._fft(demod.extract_symbol_windows(
        yf, ls2 + (OFF_NLLTF + 80 * tabs.n_ltf) * q, 1, nfft=nfft, gi=gi,
        shift=sh)).reshape(g, nrx, nfft)
    # pilots ride the SUM channel over the group's streams (every stream
    # carries SIG-B identically through the spatial expansion)
    pil = tabs.pilot_idx
    sum_h_pil = ltf_f[:, :, 0, :][..., pil] / tabs._safe_ref()[pil]
    acc = torch.sum(sb[..., pil] * torch.conj(
        sum_h_pil * tabs.sigb_pilot_ref[None, None]), dim=(1, 2))
    ph = acc / torch.clamp_min(torch.abs(acc), 1e-12)
    sb = sb / ph[:, None, None]
    eq = demod.mrc_combine(sb[:, :, None, :], h_u)[:, 0]  # [G, nfft]
    bits = tabs.decode_bits(eq[..., tabs.data_idx].real)
    n_keep = tabs.info_w.shape[0]
    return (bits[:, :n_keep] * tabs.info_w).sum(dim=-1, dtype=torch.int32)


class MuStaDataDecoder(_TableModule):
    """Batched own-stream DATA decoder for downlink MU PPDUs.

    Static config (Mod, nSym bucket, stream_idx, nSTS total); windows carry
    1..nRx chains and the own-stream channels (P-row combining per chain)
    are MRC-combined. Pilot tracking rides the group's SUM channel (every
    stream carries the same pilots through the spatial expansion). True
    per-packet symbol counts pass through `n_valid`; the expected SIG-B
    CRC-8 byte is checked on the device against the descrambled SERVICE
    field. Its state is the tables of `mu_sta_tables_from_numpy`."""

    def __init__(self, mod: Mod, n_sym: int, stream_idx: int,
                 n_sts_total: int):
        super().__init__()
        if mod.nSS != 1:
            raise ValueError(f"an MU user's stream is one stream, got "
                             f"{mod.nSS}")
        self.mod = mod
        self.n_sym = n_sym
        self.stream_idx = stream_idx
        self.n_sts = n_sts_total
        self.n_ltf = int(tables.N_LTF[n_sts_total])
        self.n_bits = n_sym * mod.nDBPS
        self.q = tables.NFFT[mod.bw] // 64
        self._register(mu_sta_tables_from_numpy(mod, n_sym, stream_idx,
                                                n_sts_total))

    def data_offset(self) -> int:
        return (OFF_NLLTF + 80 * self.n_ltf + 80) * self.q   # + SIG-B

    def window_capacity(self) -> int:
        return (272 * self.q + self.data_offset()
                + (self.n_sym * 80 + 80) * self.q)

    def zlen(self) -> int:
        """Aligned-window length (see SisoDataDecoder.zlen)."""
        return 32 * self.q + self.data_offset() + 80 * self.q * self.n_sym

    def _decode_z(self, z: torch.Tensor, n_valid: torch.Tensor,
                  sigb_crc: torch.Tensor):
        """z: [B, nRx, zlen] complex, CFO-corrected, aligned at ltf_start -
        gi; sigb_crc: [B] int32 expected CRC-8 of the SIG-B pre-tail bits.
        Returns (descrambled bits [B, n_bits] int32, EVM SNR [B], sigb_ok
        [B])."""
        mod = self.mod
        q = self.q
        nfft, gi, sh = 64 * q, 16 * q, 4 * q   # 4q shift (models/pipeline)
        b, nrx = z.shape[0], z.shape[1]
        yf = z.reshape(b * nrx, -1)
        ltf_f = self._fft(demod.static_symbol_windows(
            yf, gi + OFF_NLLTF * q, self.n_ltf, nfft=nfft, gi=gi,
            shift=sh)).reshape(b, nrx, self.n_ltf, nfft)
        h_u = self._own_chan(ltf_f, self.n_ltf)           # [B, R, nfft]
        pil = self.pilot_idx
        sum_h_pil = ltf_f[:, :, 0, :][..., pil] / self._safe_ref()[pil]
        gd = self._fft(demod.static_symbol_windows(
            yf, gi + self.data_offset(), self.n_sym, nfft=nfft, gi=gi,
            shift=sh)).reshape(b, nrx, self.n_sym, nfft)
        exp = sum_h_pil[:, :, None, :] * self.pilot_ref[None, None]
        acc = torch.sum(gd[..., pil] * torch.conj(exp), dim=(1, 3))
        ph = acc / torch.clamp_min(torch.abs(acc), 1e-12)  # [B, S]
        gd = gd / ph[:, None, :, None]
        eq = demod.mrc_combine(gd, h_u)                   # [B, S, nfft]
        data = eq[..., self.data_idx]
        sym_m = (torch.arange(self.n_sym, device=z.device)[None, :]
                 < n_valid[:, None])
        evm = demod.evm_snr_db(data, mod.mod, sym_mask=sym_m)
        llr = demod.demap_llr(data, mod.mod)
        # CSI weight = post-MRC noise inverse (see demod_data_mrc)
        w = torch.sum(torch.abs(h_u) ** 2, dim=1)[..., self.data_idx]
        w = w / torch.clamp_min(torch.mean(w, dim=-1, keepdim=True), 1e-12)
        nb = llr.shape[-1] // data.shape[-1]
        llr = llr * torch.repeat_interleave(w, nb, dim=-1)[:, None, :]
        llr = llr[..., self.rx_perm].reshape(b, -1)
        ncbpss = llr.shape[1] // self.n_sym
        llr = torch.where(torch.repeat_interleave(sym_m, ncbpss, dim=1),
                          llr, 0.0)
        bits = coding.viterbi_decode(llr, mod.cr, self.n_bits, self.vit_w0,
                                     self.vit_w1)
        scr = coding.descramble(bits, self.prbs, self.seed_inv)
        svc = (scr[:, 8:16] * self.svc_w).sum(dim=1, dtype=torch.int32)
        return scr, evm, svc == sigb_crc

    def decode_from_capture(self, cap: torch.Tensor, t_abs: torch.Tensor,
                            ltf_start: torch.Tensor, cfo: torch.Tensor,
                            n_valid: torch.Tensor, sigb_crc: torch.Tensor):
        """Batched decode with one aligned window per packet (and chain)
        from the device-resident capture, [Npad, 2] or [nRx, Npad, 2]
        float32. Returns (packed descrambled bytes [G, n_bits/8] uint8, EVM
        SNR [G], sigb_ok [G]) on the capture's device, without waiting."""
        zl = self.zlen()
        ta = t_abs + ltf_start - 16 * self.q
        if cap.dim() == 3:
            x2 = capture_windows_mimo(cap, ta, zl)
        else:
            x2 = capture_windows(cap, ta, zl)[:, None]
        z = r2c(x2) * sync.cfo_ramp(cfo, zl)[:, None, :]
        bits, evm, sigb_ok = self._decode_z(z, n_valid, sigb_crc)
        return pack_bits_le(bits), evm, sigb_ok


@lru_cache(maxsize=64)
def _cached_data(mod: Mod, n_sym_bucket: int, stream_idx: int,
                 n_sts_total: int, device: torch.device) -> MuStaDataDecoder:
    with span("rx.decoder_build") as sp:
        if sp:
            sp.attrs.update(kind="mu_data", mod=str(mod), bucket=n_sym_bucket)
        return MuStaDataDecoder(mod, n_sym_bucket, stream_idx,
                                n_sts_total).to(device)


def get_mu_sta_data_decoder(mod: Mod, n_sym_bucket: int, stream_idx: int,
                            n_sts_total: int,
                            device=None) -> MuStaDataDecoder:
    """The MU DATA decoder of (mod, bucket, stream, nSTS) on `device`
    (default the card; "cpu" for the CPU), built once per process."""
    return _cached_data(mod, n_sym_bucket, stream_idx, n_sts_total,
                        entry_device(device))
