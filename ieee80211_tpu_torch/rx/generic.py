"""Table-driven GENERIC data decoder: one program, every (fmt, mcs).

Port of ieee80211_tpu/rx/generic.py (`_depuncture_map` :60, `_cfg_tables`
:71, `_pilot_ref_table` :108, `GenericSisoDecoder` :116). Its one caller is
`parallel/sharded.py::sharded_capture_decode_auto(generic=True)`.

Inside the one-program sharded loop every configured branch is a decode of
its own; this module collapses the branches into DATA. One decoder, whose
per-window behaviour is driven by a config index, replaces them:

  * channel estimate: the legacy and non-legacy estimates are both computed
    and selected per window by format;
  * data-symbol position: one per-window slice at the format's data offset
    (the window-slice kernel on the card);
  * constellation: the piecewise-linear demapper runs for every
    constellation into a 21-plane "LLR bank" per tone (1+2+4+6+8 bit
    planes);
  * deinterleave + depuncture + stream layout: ONE gather per window,
    `src[cfg, t, j]` maps trellis slot (t, j) into the flat LLR bank
    (punctured slots read a constant zero slot);
  * coding rate / trellis length: every window runs one shared Viterbi of
    n_bits_max steps (`coding.viterbi_decode_pairs`, the Viterbi kernel on
    the card); configs shorter than the max see zero LLRs past their
    stream, which is path-neutral.

Envelope: 20 MHz SISO data configs (L0-7 / HT0-7 / VHT0-8), the sharded
loop's planner envelope. The numpy table builders are copies of the JAX
module's; the decoder is an `nn.Module` whose tables are buffers.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..models.pipeline import as_tables
from ..ops import coding, demod, sync
from ..specs import BW, F, M, Mod, tables
from ..specs import interleaver as ilv
from ..utils.device import entry_device
from ..utils.riq import r2c, r_of

# demap bank: plane offsets of each constellation's bit planes (1+2+4+6+8)
_BANK_MODS = (M.BPSK, M.QPSK, M.QAM16, M.QAM64, M.QAM256)
_NB = {M.BPSK: 1, M.QPSK: 2, M.QAM16: 4, M.QAM64: 6, M.QAM256: 8}
_MOFF = {M.BPSK: 0, M.QPSK: 1, M.QAM16: 3, M.QAM64: 7, M.QAM256: 13}
_NPLANE = 21
_DATA_OFF = {F.L: 208, F.HT: 528, F.VHT: 608}   # vs ltf_start, nLTF=1


def _depuncture_map(cr, n_bits: int) -> np.ndarray:
    """[n_bits, 2] source index into the punctured coded stream, -1 for
    punctured slots (numpy mirror of ops/coding.depuncture)."""
    pat = tables.PUNCTURE[cr].astype(bool)
    tiled = np.tile(pat, -(-2 * n_bits // len(pat)))[:2 * n_bits]
    src = np.full(2 * n_bits, -1, np.int64)
    src[tiled] = np.arange(int(tiled.sum()))
    return src.reshape(n_bits, 2)


@lru_cache(maxsize=None)
def _cfg_tables(configs: Tuple[Tuple[F, int], ...], n_sym: int):
    """Per-config gather tables into the flat per-window LLR bank.

    Bank layout: [n_sym, 52 NL data tones, 21 planes] flattened, plus one
    trailing ZERO slot (index bank_n) that punctured / out-of-stream
    trellis slots read. Returns (src [n_cfg, n_bits_max, 2] int32,
    fmt_code [n_cfg], n_bits [n_cfg], bank_n)."""
    nl_grid = list(np.asarray(tables.DATA_GRID[(BW.BW20, False)]))
    l_grid = np.asarray(tables.DATA_GRID[(BW.BW20, True)])
    l_to_nl = np.asarray([nl_grid.index(b) for b in l_grid])
    bank_n = n_sym * 52 * _NPLANE
    mods = [Mod(f, m) for f, m in configs]
    n_bits_max = n_sym * max(mo.nDBPS for mo in mods)
    src = np.full((len(configs), n_bits_max, 2), bank_n, np.int32)
    for c, mo in enumerate(mods):
        nb = _NB[mo.mod]
        perm = np.asarray(ilv.rx_perm(mo))             # [nCBPS]
        tone = perm // nb
        bit = perm % nb
        if mo.fmt == F.L:
            tone = l_to_nl[tone]
        sym_idx = tone * _NPLANE + _MOFF[mo.mod] + bit  # [nCBPS]
        n_bits_c = n_sym * mo.nDBPS
        dep = _depuncture_map(mo.cr, n_bits_c)          # [n_bits_c, 2]
        coded = dep.reshape(-1)                         # flat coded idx/-1
        s_of = np.where(coded >= 0, coded // mo.nCBPS, 0)
        r_of_ = np.where(coded >= 0, coded % mo.nCBPS, 0)
        flat = s_of * (52 * _NPLANE) + sym_idx[r_of_]
        flat = np.where(coded >= 0, flat, bank_n)
        src[c, :n_bits_c] = flat.reshape(n_bits_c, 2)
    fmt_code = np.asarray([{F.L: 0, F.HT: 1, F.VHT: 2}[f]
                           for f, _ in configs], np.int32)
    n_bits = np.asarray([n_sym * mo.nDBPS for mo in mods], np.int32)
    return src, fmt_code, n_bits, bank_n


@lru_cache(maxsize=None)
def _pilot_ref_table(n_sym: int) -> np.ndarray:
    """[3 formats, n_sym, nP] expected pilot values (L/HT/VHT pidx0)."""
    refs = [np.asarray(demod.pilot_refs(Mod(f, 0), n_sym,
                                        {F.L: 1, F.HT: 3, F.VHT: 4}[f]))
            for f in (F.L, F.HT, F.VHT)]
    return np.stack(refs).astype(np.complex64)


def generic_tables_from_numpy(configs: Tuple[Tuple[F, int], ...],
                              n_sym: int):
    """Every constant table of the generic decoder, as numpy: the config
    gather tables, DFT, LTF references, pilot tables, tone maps, Viterbi
    radix tables and scrambler tables."""
    src, fmtc, _, _ = _cfg_tables(configs, n_sym)
    w0, w1 = coding._radix_tables(coding.RADIX)
    dft_re, dft_im = demod._dft_mats(64)
    return as_tables({
        "src_idx": src,
        "fmt_idx": fmtc,
        "data_off_idx": np.asarray([_DATA_OFF[F.L], _DATA_OFF[F.HT],
                                    _DATA_OFF[F.VHT]]),
        "pilot_ref": _pilot_ref_table(n_sym),
        "pilot_idx": tables.PILOT_GRID[(BW.BW20, False)],
        "nl_idx": tables.DATA_GRID[(BW.BW20, False)],
        "l_idx": tables.DATA_GRID[(BW.BW20, True)],
        "dft_re": dft_re,
        "dft_im": dft_im,
        "ltf_ref_l": demod.ltf_ref_grid(BW.BW20, True),
        "ltf_ref_nl": demod.ltf_ref_grid(BW.BW20, False),
        "vit_w0": w0,
        "vit_w1": w1,
        "prbs": coding._prbs_tiled(src.shape[1]),
        "seed_inv": coding._seed_from_first7(),
    })


class GenericSisoDecoder(nn.Module):
    """Every-config 20 MHz SISO DATA decoder (one batched decode).

    configs: static tuple of (F, mcs); n_sym: static symbol capacity. Its
    tables are buffers on `device` (default the card; "cpu" for the CPU).
    decode(x2, ltf_start, cfo, cfg_idx, n_valid): raw [G, N, 2] float32
    windows, their LTF starts and CFOs; cfg_idx [G] rows into `configs`
    (invalid windows: pass 0 and mask outside); n_valid [G] true symbol
    counts. Returns descrambled bits [G, n_bits_max] int32.
    """

    def __init__(self, configs: Sequence[Tuple[F, int]], n_sym: int, *,
                 device=None):
        super().__init__()
        self.configs = tuple((F(f), int(m)) for f, m in configs)
        self.n_sym = n_sym
        src, _, nbits, bank_n = _cfg_tables(self.configs, n_sym)
        self.n_bits_max = src.shape[1]
        self.n_bits = nbits
        self._bank_n = bank_n
        for name, arr in generic_tables_from_numpy(self.configs,
                                                   n_sym).items():
            self.register_buffer(name, torch.from_numpy(arr))
        self.to(entry_device(device))

    def zlen(self) -> int:
        return 32 + _DATA_OFF[F.VHT] + 80 * self.n_sym

    def window_capacity(self) -> int:
        return 272 + self.zlen() + 80

    def _fft(self, x: torch.Tensor) -> torch.Tensor:
        return demod.fft_syms(x, self.dft_re, self.dft_im)

    def _decode_z(self, z: torch.Tensor, cfg_idx: torch.Tensor,
                  n_valid: torch.Tensor) -> torch.Tensor:
        g_n = z.shape[0]
        nfft, gi, sh = 64, 16, 4
        cfg_idx = cfg_idx.long()
        fmt = self.fmt_idx[cfg_idx]                          # [G]

        # both channel estimates; select by format
        ltf_l = demod.static_symbol_windows(z, 0, 2, nfft=nfft, gi=gi,
                                            shift=sh, stride=nfft)
        lchan = demod.legacy_chan_est(self._fft(ltf_l), self.ltf_ref_l)
        ltf_n = demod.static_symbol_windows(z, gi + 448, 1, nfft=nfft,
                                            gi=gi, shift=sh)
        nchan = demod.nonlegacy_chan_est_siso(self._fft(ltf_n)[:, 0],
                                              self.ltf_ref_nl)
        chan = torch.where((fmt == 0)[:, None], lchan, nchan)  # [G, 64]

        # data symbols at the per-format offset (ONE per-row slice of
        # EXACTLY gi + 80*S samples: any longer and the VHT-offset slice
        # would overrun zlen and the clipped start would shift the window)
        off = self.data_off_idx[fmt]
        zd = r2c(sync.batch_slice_iq(r_of(z), gi + off,
                                     80 * self.n_sym + gi))
        gd = self._fft(demod.static_symbol_windows(
            zd, 0, self.n_sym, nfft=nfft, gi=gi, shift=sh))  # [G, S, 64]
        eq = gd / chan[:, None, :]

        # pilot common-phase (L/HT/VHT polarity offsets differ)
        pref = self.pilot_ref[fmt]                           # [G, S, nP]
        acc = torch.sum(eq[..., self.pilot_idx] * torch.conj(pref), dim=-1)
        mag = torch.abs(acc)
        eq = eq / (acc / torch.where(mag > 0, mag, 1.0))[..., None]

        # CSI weight over the format's own data-tone set
        w_all = torch.abs(chan) ** 2                         # [G, 64]
        mean_nl = torch.mean(w_all[:, self.nl_idx], dim=-1)
        mean_l = torch.mean(w_all[:, self.l_idx], dim=-1)
        wmean = torch.where(fmt == 0, mean_l, mean_nl)
        w = w_all[:, self.nl_idx] / torch.clamp_min(wmean, 1e-12)[:, None]

        # LLR bank: every constellation's planes per NL tone
        tones = eq[..., self.nl_idx]                         # [G, S, 52]
        planes = [demod.demap_llr(tones, m).reshape(g_n, self.n_sym, 52,
                                                    _NB[m])
                  for m in _BANK_MODS]
        bank = torch.cat(planes, dim=-1) * w[:, None, :, None]
        sym_ok = (torch.arange(self.n_sym, device=z.device)[None, :]
                  < n_valid[:, None])
        bank = torch.where(sym_ok[:, :, None, None], bank, 0.0)
        bank = torch.cat([bank.reshape(g_n, -1), bank.new_zeros(g_n, 1)],
                         dim=1)

        # deinterleave + depuncture + rate select: ONE gather per window
        src = self.src_idx[cfg_idx].reshape(g_n, -1)     # [G, n_bits_max*2]
        lp = torch.gather(bank, 1, src).reshape(g_n, self.n_bits_max, 2)
        bits = coding.viterbi_decode_pairs(lp, self.n_bits_max, self.vit_w0,
                                           self.vit_w1)
        return coding.descramble(bits, self.prbs, self.seed_inv)

    def decode(self, x2: torch.Tensor, ltf_start: torch.Tensor,
               cfo: torch.Tensor, cfg_idx: torch.Tensor,
               n_valid: torch.Tensor) -> torch.Tensor:
        """x2: [G, N, 2] raw float32 windows (like SisoDataDecoder)."""
        zl = self.zlen()
        z2 = sync.batch_slice_iq(x2, ltf_start - 16, zl)
        z = r2c(z2) * sync.cfo_ramp(cfo, zl)
        return self._decode_z(z, cfg_idx, n_valid)
