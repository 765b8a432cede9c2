"""Batched PyTorch transmitter: PSDU bytes in, I/Q samples out, on the card.

Port of ieee80211_tpu/tx/jax_tx.py (`TxPipeline` :27, `_bcc` :178,
`get_tx_pipeline` :197, `_UserEncoder` :210, `MuTxPipeline` :272). For a
static (Mod, PpduParams) config the whole preamble (training and SIG fields)
is a constant from the golden model; only the DATA field is computed per
packet: scramble (PRBS XOR), BCC (shift-XOR taps), puncture and interleave
(gathers), QAM (table lookup), pilot insertion, IFFT (`torch.fft`, as
`jnp.fft` in the JAX package), GI and boundary windowing. Everything is
batched over packets. The MU transmitter takes the spatial mapping Q at run
time and computes the Q-dependent VHT-STF, VHT-LTF and SIG-B on the device.

Each transmitter is an `nn.Module` whose state is its constants, held as
buffers, on the card unless `device="cpu"` asks for the CPU. Bits stay
integers (uint8) from the PSDU unpack to the QAM lookup; the complex math
is complex64 with TF32 off (package __init__).

The JAX `TxPipeline` shapes its DATA symbols as 80 samples whatever the
bandwidth and so raises at 40 and 80 MHz; the port's uses 80q samples (the
MU transmitter's rule) and is held to the golden TX at every bandwidth.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..specs import CR, F, M, Mod, PpduParams, tables
from ..specs import interleaver as ilv
from ..specs.modulation import (ppdu_params_aggregate,
                                ppdu_params_aggregate_mu,
                                ppdu_params_nonaggregate)
from ..utils.device import entry_device
from ..utils.riq import r2c, r_of
from . import golden


def _bcc(bits: torch.Tensor) -> torch.Tensor:
    """[..., N] 0/1 bits -> [..., 2N] rate-1/2 coded bits (zero state)."""
    n = bits.shape[-1]
    pad = torch.nn.functional.pad(bits, (6, 0))

    def taps(mask):
        out = torch.zeros_like(bits)
        for k in range(7):
            if (mask >> k) & 1:
                out = out ^ pad[..., 6 - k:6 - k + n]
        return out

    return torch.stack([taps(tables.G0), taps(tables.G1)],
                       dim=-1).reshape(bits.shape[:-1] + (2 * n,))


def _unpack_bits(psdu: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """[B, L] uint8 -> [B, 8L] uint8 bits, LSB first."""
    return ((psdu[:, :, None] >> shifts) & 1).reshape(psdu.shape[0], -1)


def _to_time(g: torch.Tensor, scale: float) -> torch.Tensor:
    """Shifted frequency grids [..., nfft] -> time symbols with their cyclic
    prefix [..., 5 nfft / 4], divided by scale."""
    s = torch.fft.ifft(torch.fft.ifftshift(g, dim=-1), dim=-1) / scale
    n = s.shape[-1]
    return torch.cat([s[..., 3 * n // 4:], s], dim=-1)


def _edge_window(n_t: int, n: int) -> np.ndarray:
    """Boundary window of n_t symbols of n samples: each symbol's first
    sample halved and every last sample but the packet's."""
    w = np.ones((n_t, n), np.float32)
    w[:, 0] = 0.5
    w[:-1, -1] = 0.5
    return w


class _Encoder(nn.Module):
    """Scramble -> per-encoder BCC -> puncture -> stream parse ->
    interleave -> QAM chips of one config: the DATA field's bit path of
    `TxPipeline._tx` and `_UserEncoder.qam`."""

    def _init_encoder(self, mod: Mod, pp: PpduParams, scrambler: int,
                      service: np.ndarray, fixed_tail: np.ndarray,
                      n_dbits: int):
        self.mod, self.pp = mod, pp
        reps = -(-n_dbits // 127)
        n_in = pp.n_sym * mod.nDBPS // mod.nES
        pat = tables.PUNCTURE[mod.cr].astype(bool)
        keep = np.tile(pat, -(-2 * n_in // len(pat)))[:2 * n_in]
        es_idx, bit_idx = ilv.stream_parser_maps(mod)
        bufs = {
            "shifts": np.arange(8, dtype=np.uint8),
            "prbs": np.tile(tables.SCRAMBLE_SEQ[scrambler],
                            reps)[:n_dbits].astype(np.uint8),
            "service": service.astype(np.uint8),
            "fixed_tail": fixed_tail.astype(np.uint8),
            "punct_idx": np.nonzero(keep)[0].astype(np.int64),
            "es_idx": es_idx.astype(np.int64),
            "bit_idx": bit_idx.astype(np.int64),
            "tx_perms": np.stack([ilv.tx_perm(mod, iss)
                                  for iss in range(mod.nSS)]).astype(
                                      np.int64),
            "chip_w": (1 << np.arange(mod.nBPSCS)).astype(np.int64),
            # the JAX package's float32 real and imaginary tables, as one
            "qam": tables.QAM_TAB[mod.mod].astype(np.complex64),
        }
        for name, arr in bufs.items():
            self.register_buffer(name, torch.from_numpy(
                np.ascontiguousarray(arr)))

    def _chips_qam(self, psdu: torch.Tensor, zero_tail_at=None):
        """[B, len] uint8 -> constellation points [B, nSS, S, nSD]."""
        mod, pp = self.mod, self.pp
        b = psdu.shape[0]
        dbits = torch.cat([self.service.expand(b, -1),
                           _unpack_bits(psdu, self.shifts),
                           self.fixed_tail.expand(b, -1)], dim=1)
        scr = dbits ^ self.prbs
        if zero_tail_at is None:
            # VHT: per-encoder stride slice + zero tail, then BCC
            n_in = pp.n_sym * mod.nDBPS // mod.nES - 6
            zeros = scr.new_zeros((b, 6))
            es = torch.stack([torch.cat([scr[:, ies:n_in * mod.nES:mod.nES],
                                         zeros], dim=1)
                              for ies in range(mod.nES)], dim=1)
        else:
            scr = scr.clone()
            scr[:, zero_tail_at:zero_tail_at + 6 * mod.nES] = 0
            n_in = pp.n_sym * mod.nDBPS // mod.nES
            es = torch.stack([scr[:, ies:n_in * mod.nES:mod.nES]
                              for ies in range(mod.nES)], dim=1)
        coded = _bcc(es)                                  # [B, nES, 2 nIn]
        punct = coded[:, :, self.punct_idx].reshape(b, mod.nES, pp.n_sym, -1)
        streams = []
        for iss in range(mod.nSS):
            if mod.fmt == F.L:
                stream = punct[:, 0]
            else:
                # split advanced indices: the broadcast axis comes first,
                # as in NumPy and JAX
                stream = punct[:, self.es_idx[iss], :, self.bit_idx[iss]]
                stream = torch.movedim(stream, 0, -1)     # [B, S, nCBPSS]
            inted = stream[..., self.tx_perms[iss]]
            chips = inted.reshape(b, pp.n_sym, mod.nSD, mod.nBPSCS)
            chips = (chips.to(torch.int64) * self.chip_w).sum(dim=-1)
            streams.append(self.qam[chips])               # [B, S, nSD]
        return torch.stack(streams, dim=1)


class TxPipeline(_Encoder):
    """Config-specialized batched transmitter, on the card unless
    `device="cpu"` asks for the CPU (without a card, the default raises).

    `step(psdu)`: psdu [B, in_len] uint8 (raw A-MPDU bytes for VHT, the
    MPDU otherwise) -> waveform [B, nSS, nSamp, 2] float32."""

    def __init__(self, mod: Mod, pp: PpduParams,
                 scrambler: int = golden.DEFAULT_SCRAMBLER, device=None):
        super().__init__()
        if pp.mu:
            raise ValueError("TxPipeline is SU: MU TX is MuTxPipeline")
        self.scrambler = scrambler
        self.in_len = pp.ampdu_len if mod.fmt == F.VHT else pp.psdu_len
        q = tables.NFFT[mod.bw] // 64
        # preamble from the golden model with a zero payload: every sample
        # before the DATA field depends only on the config
        probe = bytes(self.in_len)
        if mod.fmt == F.L or (mod.fmt == F.HT and not pp.ampdu):
            ref = golden.gen_mpdu(probe, mod, scrambler)
        else:
            ref = golden.gen_ampdu(probe, mod, scrambler=scrambler)
        wave = ref.waveform
        self.n_samp = wave.shape[-1]
        pre = wave[:, :self.n_samp - pp.n_sym * 80 * q].astype(np.complex64)
        self.sigb_crc = (ref.sigb_crc if ref.sigb_crc is not None
                         else np.zeros(0, np.int64))
        if mod.fmt == F.VHT:
            n_dbits = pp.n_sym * mod.nDBPS - 6 * mod.nES
            service = np.concatenate([np.zeros(8, np.int64),
                                      np.asarray(self.sigb_crc, np.int64)])
            eof = np.tile(tables.EOF_PAD_SUBFRAME.astype(np.int64),
                          pp.n_pad_eof)
            fixed_tail = np.concatenate(
                [eof, np.zeros(8 * pp.n_pad_octet + pp.n_pad_bits, np.int64)])
        else:
            n_dbits = pp.n_sym * mod.nDBPS
            service = np.zeros(16, np.int64)
            fixed_tail = np.zeros(6 * mod.nES + pp.n_pad_bits, np.int64)
        self._init_encoder(mod, pp, scrambler, service, fixed_tail, n_dbits)
        tab = tables.CSD_NONLEGACY_NS
        if mod.fmt == F.L:
            scale = tables.SCALE_DATA_L[mod.bw]
        elif mod.fmt == F.HT:
            scale = tables.SCALE_DATA_HT[mod.bw]
        else:
            scale = tables.SCALE_DATA_VHT[mod.bw]
        self.scale = float(np.float32(np.sqrt(scale * mod.nSS)))
        legacy = mod.fmt == F.L
        bufs = {
            "preamble": pre,                                  # [nSS, nPre]
            "pilots": np.stack([golden.pilot_sequence(mod, pp.n_sym, iss)
                                for iss in range(mod.nSS)]).astype(
                                    np.complex64),            # [nSS, S, nP]
            "csd": np.stack([golden.csd_phase(mod.bw, tab[mod.nSS - 1, iss])
                             for iss in range(mod.nSS)]).astype(np.complex64),
            "window": _edge_window(pp.n_sym, 80 * q),
            "data_bins": np.asarray(tables.DATA_GRID[(mod.bw, legacy)],
                                    np.int64),
            "pilot_bins": np.asarray(tables.PILOT_GRID[(mod.bw, legacy)],
                                     np.int64),
        }
        for name, arr in bufs.items():
            self.register_buffer(name, torch.from_numpy(
                np.ascontiguousarray(arr)))
        self.to(entry_device(device))

    def forward(self, psdu: torch.Tensor) -> torch.Tensor:
        mod, pp = self.mod, self.pp
        psdu = torch.as_tensor(psdu, device=self.preamble.device)
        b = psdu.shape[0]
        tail_at = None if mod.fmt == F.VHT else 16 + pp.psdu_len * 8
        qam = self._chips_qam(psdu, tail_at)              # [B, nSS, S, nSD]
        nfft = tables.NFFT[mod.bw]
        grid = qam.new_zeros((b, mod.nSS, pp.n_sym, nfft))
        grid[..., self.data_bins] = qam
        grid[..., self.pilot_bins] = self.pilots[None]
        grid = grid * self.csd[None, :, None, :]
        sym = _to_time(grid, self.scale) * self.window
        data = sym.reshape(b, mod.nSS, -1)
        pre = self.preamble[None].expand(b, -1, -1)
        return r_of(torch.cat([pre, data], dim=-1))

    step = forward


@lru_cache(maxsize=64)
def _cached_tx(mod: Mod, psdu_len: int, ampdu: bool,
               device: torch.device) -> TxPipeline:
    if mod.fmt == F.VHT or (mod.fmt == F.HT and ampdu):
        pp = ppdu_params_aggregate(mod, psdu_len)
    else:
        pp = ppdu_params_nonaggregate(mod, psdu_len)
    return TxPipeline(mod, pp, device=device)


def get_tx_pipeline(mod: Mod, psdu_len: int, ampdu: bool,
                    device=None) -> TxPipeline:
    """The transmitter of (mod, psdu_len, ampdu) on `device` (default the
    card; "cpu" for the CPU), built once per process."""
    return _cached_tx(mod, psdu_len, ampdu, entry_device(device))


# ---------------------------------------------------------------------------
# MU-MIMO downlink transmitter (spatial mapping Q as a runtime argument)
# ---------------------------------------------------------------------------


class _UserEncoder(_Encoder):
    """One MU user's constants and its PSDU -> constellation path: the VHT
    branch of TxPipeline for one user, sized to the group's symbol count
    (each user's PSDU is encoded at its own MCS)."""

    def __init__(self, mod: Mod, pp: PpduParams, sigb_crc: np.ndarray,
                 scrambler: int):
        super().__init__()
        if mod.fmt != F.VHT:
            raise ValueError(f"an MU user is VHT, got {mod.fmt.name}")
        service = np.concatenate([np.zeros(8, np.int64),
                                  np.asarray(sigb_crc, np.int64)])
        eof = np.tile(tables.EOF_PAD_SUBFRAME.astype(np.int64),
                      pp.n_pad_eof)
        fixed_tail = np.concatenate(
            [eof, np.zeros(8 * pp.n_pad_octet + pp.n_pad_bits, np.int64)])
        self._init_encoder(mod, pp, scrambler, service, fixed_tail,
                           pp.n_sym * mod.nDBPS - 6 * mod.nES)

    def forward(self, psdu: torch.Tensor) -> torch.Tensor:
        """[B, ampdu_len] uint8 -> constellations [B, nSS, S, nSD]."""
        return self._chips_qam(psdu)


class MuTxPipeline(nn.Module):
    """Batched VHT MU-MIMO downlink transmitter, on the card unless
    `device="cpu"` asks for the CPU.

    The spatial mapping Q is a run-time argument (a serving loop refreshes
    it every sounding round while the packet configs stay), so the
    Q-dependent VHT-STF, VHT-LTF and SIG-B are computed on the device from
    constant per-STS grids; the legacy fields and VHT-SIG-A are constants.

    `step(psdus, q2)`: psdus, one [B, len_u] uint8 per user; q2
    [nfft, nSTS, nSTS, 2] float32 I/Q -> [B, nSTS, nSamp, 2] float32."""

    def __init__(self, mods: Sequence[Mod], ampdu_lens: Sequence[int],
                 group_id: int = 1,
                 scrambler: int = golden.DEFAULT_SCRAMBLER, device=None):
        super().__init__()
        self.mods = list(mods)
        self.lens = list(ampdu_lens)
        n_user = len(self.mods)
        pps0 = [ppdu_params_aggregate(m, n)
                for m, n in zip(self.mods, self.lens)]
        self.n_sym = max(p.n_sym for p in pps0)
        self.n_sts = sum(m.nSTS for m in self.mods)
        bw = self.mods[0].bw
        self.nfft = tables.NFFT[bw]
        self.gmod = Mod(F.VHT, 0, bw, self.n_sts, self.mods[0].sgi)
        self.gpp = ppdu_params_aggregate_mu(self.gmod, 0, self.n_sym)
        self.pps = [ppdu_params_aggregate_mu(m, n, self.n_sym)
                    for m, n in zip(self.mods, self.lens)]

        # constant legacy preamble + VHT-SIG-A (Q-independent; boundary with
        # the Q-dependent VHT-STF pre-halved)
        lt = golden.legacy_training(self.gmod)
        ls = golden.legacy_sig_field(self.gmod, self.gpp)
        va = golden.vht_siga_field(self.gmod, self.gpp, group_id, 0,
                                   mu_nsts=[m.nSTS for m in self.mods])
        pre = np.stack([golden.concat_blocks([lt[i], ls[i], va[i]])
                        for i in range(self.n_sts)]).astype(np.complex64)
        pre[:, -1] *= 0.5

        # constant per-STS frequency grids of the Q-dependent fields
        def csd_all(g):
            return np.stack([golden.apply_csd(g[i] if g.ndim > 1 else g,
                                              bw, self.n_sts, i, False)
                             for i in range(self.n_sts)])
        stf = golden._nl_grid_from_occ(tables.STF_VHT[bw], bw)
        n_ltf = tables.N_LTF[self.n_sts]
        ltf_grids = np.stack([
            csd_all(np.stack([golden._nl_grid_from_occ(
                golden._vht_ltf_occ(bw, i, il), bw)
                for i in range(self.n_sts)]))
            for il in range(n_ltf)])                   # [nLTF, nSTS, nfft]
        sigb_ints = []
        self.sigb_crcs = []
        for u in range(n_user):
            sb_bits, crc = golden.vhtsigb_bits_mu(self.mods[u],
                                                  self.lens[u], bw)
            inted = golden.interleave_sigb(self.gmod,
                                           golden.bcc(sb_bits, CR.CR12))
            self.sigb_crcs.append(crc)
            sigb_ints += [inted] * self.mods[u].nSTS
        sigb_grids = []
        for i in range(self.n_sts):
            qam = tables.QAM_TAB[M.BPSK][sigb_ints[i]]
            if self.n_sts in (4, 7, 8):
                qam = qam * tables.P_SIGB_NSTS478[i]
            sigb_grids.append(golden.build_grid(
                qam, tables.PILOT_VHT[bw], bw, False))

        self.users = nn.ModuleList([
            _UserEncoder(m, p, c, scrambler)
            for m, p, c in zip(self.mods, self.pps, self.sigb_crcs)])
        # every STS sends the iss-0 pilot sequence (the golden MU path)
        scales = {name: float(np.float32(np.sqrt(tab[bw] * self.n_sts)))
                  for name, tab in (("stf", tables.SCALE_STF_VHT),
                                    ("ltf", tables.SCALE_LTF_VHT),
                                    ("sigb", tables.SCALE_SIG_VHT_B),
                                    ("data", tables.SCALE_DATA_VHT))}
        self.scales = scales
        bufs = {
            "preamble": pre,                                  # [nSTS, nPre]
            "stf_grid": csd_all(stf[None].repeat(self.n_sts, 0)),
            "ltf_grids": ltf_grids,
            "sigb_grid": csd_all(np.stack(sigb_grids)),
            "pilots": golden.pilot_sequence(self.gmod, self.n_sym,
                                            0).astype(np.complex64),
            "csd": np.stack([
                golden.csd_phase(bw, tables.CSD_NONLEGACY_NS[self.n_sts - 1,
                                                             i])
                for i in range(self.n_sts)]),
            "window": _edge_window(1 + n_ltf + 1 + self.n_sym,
                                   80 * self.nfft // 64),
            "data_bins": np.asarray(tables.DATA_GRID[(bw, False)], np.int64),
            "pilot_bins": np.asarray(tables.PILOT_GRID[(bw, False)],
                                     np.int64),
        }
        for name, arr in bufs.items():
            arr = np.asarray(arr)
            if np.iscomplexobj(arr):
                arr = arr.astype(np.complex64)
            self.register_buffer(name, torch.from_numpy(
                np.ascontiguousarray(arr)))
        self.n_samp = (pre.shape[-1]
                       + 80 * (1 + n_ltf + 1 + self.n_sym)
                       * (self.nfft // 64))
        self.to(entry_device(device))

    def forward(self, psdus, q2: torch.Tensor) -> torch.Tensor:
        dev = self.preamble.device
        q = r2c(torch.as_tensor(q2, device=dev))         # [nfft, nSTS, nSTS]
        psdus = [torch.as_tensor(p, device=dev) for p in psdus]
        b = psdus[0].shape[0]
        qam = torch.cat([u(p) for u, p in zip(self.users, psdus)], dim=1)
        grid = qam.new_zeros((b, self.n_sts, self.n_sym, self.nfft))
        grid[..., self.data_bins] = qam
        grid[..., self.pilot_bins] = self.pilots
        grid = grid * self.csd[None, :, None, :]
        grid = torch.einsum("kij,bjsk->bisk", q, grid)
        data = _to_time(grid, self.scales["data"])       # [B, nSTS, S, 80q]

        def map1(g_const, scale):
            return _to_time(torch.einsum("kij,jk->ik", q, g_const), scale)

        head = torch.stack(
            [map1(self.stf_grid, self.scales["stf"])]
            + [map1(g, self.scales["ltf"]) for g in self.ltf_grids]
            + [map1(self.sigb_grid, self.scales["sigb"])],
            dim=1)                                        # [nSTS, nT0, 80q]
        syms = torch.cat([head[None].expand(b, -1, -1, -1), data], dim=2)
        tail = (syms * self.window).reshape(b, self.n_sts, -1)
        pre = self.preamble[None].expand(b, -1, -1)
        return r_of(torch.cat([pre, tail], dim=-1))

    step = forward
