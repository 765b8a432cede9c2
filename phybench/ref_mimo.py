"""The plain reference of the dual-chain 20 MHz receiver: numpy, float64,
from the receive semantics the configuration states, importing nothing of
the program it judges (the shared helpers are phybench/ref.py's).

Per capture [2, N]: each chain's STF triggers, merged (a trigger kept when
at least 200 samples after the last kept one); each chain's own int8
ingest; per trigger, each chain's sync, the chain with the best LTF
correlation giving timing and CFO, the legacy channel per chain and the
SIG tones maximal-ratio combined. One-stream packets decode through MRC
of both chains (EVM of the combined tones); two-stream packets through the
P-matrix channel from both HT/VHT-LTFs, joint pilot phase across chains,
zero-forcing (EVM per stream, their mean reported), per-stream
deinterleave and the stream deparser. A two-stream packet that ZF leaves
with a bad FCS decodes once more by exact max-log ML.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from . import ref
from .ref import Plan, Prec, Result
from .wifi.specs import BW, F, M, Mod, interleaver as ilv, tables
from .wifi.tx.golden import pilot_sequence

P2 = tables.P_LTF_4[:2, :2]
# chains whose LTF SNRs lie this close are equally the best one: float32
# and float64 readings of one SNR differ by up to ~0.02 dB, so the program
# may pick either, and its timing and CFO are those of the one it picked
TIE_DB = 0.1


def merge(per_chain: List[np.ndarray], gap: int = 200) -> np.ndarray:
    out, last = [], -gap
    for t in np.sort(np.concatenate(per_chain)):
        if t - last >= gap:
            out.append(int(t))
            last = int(t)
    return np.asarray(out, np.int64)


def mrc(grids: np.ndarray, chan: np.ndarray, p: Prec) -> np.ndarray:
    """grids [B, nRx, S, 64], chan [B, nRx, 64] -> combined [B, S, 64]."""
    den = np.sum(np.abs(chan) ** 2, axis=1) + 1e-9
    num = np.einsum("brsk,brk->bsk", grids, np.conj(chan))
    return p(num / den[:, None, :])


def sig_fields(x: np.ndarray, t0: np.ndarray, p: Prec) -> Dict:
    """The dual-chain SIG parse of windows at t0 in x [2, Npad]."""
    b = len(t0)
    per = [ref.sync_front(x, np.full(b, c), t0, p) for c in range(2)]
    snr_c = np.stack([s[2] for s in per], axis=1)            # [B, 2]
    best = np.argmax(snr_c, axis=1)
    ltf = np.stack([s[0] for s in per], axis=1)[np.arange(b), best]
    cfo = np.stack([s[1] for s in per], axis=1)[np.arange(b), best]
    n = ref.SIG_WIN
    ramp = p(np.exp(1j * cfo[:, None] * np.arange(n)))
    ys = [p(x[c][t0[:, None] + np.arange(n)] * ramp) for c in range(2)]
    rel = ltf - t0
    chan = np.stack([ref.chan_from(np.mean(ref.dft(ref._windows(
        y, rel - 16, 2, 8, 64), p), axis=1), ref._LREF) for y in ys], axis=1)

    def tones(start, n_sym, pol):
        g = np.stack([ref.dft(ref._windows(y, start, n_sym, 8), p)
                      for y in ys], axis=1)
        eq = mrc(g, chan, p)
        pref = tables.PILOT_L[None] * tables.PILOT_POLARITY[pol][:, None]
        ph = ref.pilot_phase(eq, pref, ref._SIG_PIL, p)
        return p((eq / ph[..., None])[..., ref._SIG_DATA])
    out = ref.fields_from_tones(tones(rel + ref.OFF_LSIG, 1, [0])[:, 0],
                                tones(rel + ref.OFF_NLSIG, 2, [1, 2]))
    # tied readings: the best chain's plateau ties, and where the chains'
    # SNRs tie, the other chain's reading with its own plateau ties
    alts = []
    for i in range(b):
        c, o = int(best[i]), 1 - int(best[i])
        a = list(per[c][3][i])
        if abs(snr_c[i, 0] - snr_c[i, 1]) < TIE_DB:
            a += [(int(per[o][0][i]), float(per[o][1][i]))] + per[o][3][i]
        alts.append(a)
    out.update(ltf=ltf, cfo=cfo, snr=snr_c.max(axis=1), alts=alts)
    return out


_NDBPS_HT = np.array([26, 52, 78, 104, 156, 208, 234, 260])


def plan(meta: Dict, cap_len: int) -> List[Tuple[int, Plan]]:
    """The dual-chain 20 MHz receiver's plan: legacy and one-stream HT/VHT
    through MRC, two-stream HT/VHT through the 2x2 decoder."""
    out = []
    for i in range(len(meta["ltf"])):
        if not meta["snr"][i] > 0:
            continue
        lsig_ok = bool(meta["lsig_ok"][i])
        ls, l_mcs, l_len = (int(meta[k][i]) for k in ("ltf", "l_mcs",
                                                      "l_len"))
        hb, vb = meta["ht_bits"][i:i + 1], meta["vht_bits"][i:i + 1]
        pick_ht, pick_vht = ref.sig_format(meta, i)
        lsig_data = lsig_ok and l_mcs == 0
        nl_elig = lsig_data or not lsig_ok
        args = (ls, float(meta["cfo"][i]), float(meta["snr"][i]))
        if nl_elig and pick_vht and lsig_data and int(
                ref.uint(vb, 4, 6)[0]) in (0, 63):
            nsts = int(ref.uint(vb, 10, 3)[0]) + 1
            if int(ref.uint(vb, 0, 2)[0]) != 0 or vb[0, 24] or nsts > 2:
                continue
            n_sym = -(-(l_len * 8 + 22) // 24) - 4 - tables.N_LTF[nsts]
            if n_sym <= 0:
                continue
            mod = Mod(F.VHT, int(ref.uint(vb, 28, 4)[0]), BW.BW20, nsts)
            psdu_len = (n_sym * mod.nDBPS - 16 - 6 * mod.nES) // 8
            if (n_sym * mod.nDBPS > 33000 or psdu_len > 4095 * nsts
                    or ls + 448 + 80 * mod.nLTF + 80 + n_sym * 80 > cap_len):
                continue
            out.append((i, Plan(mod, n_sym, psdu_len, True, *args)))
        elif nl_elig and pick_ht:
            mcs, length = int(ref.uint(hb, 0, 7)[0]), int(
                ref.uint(hb, 8, 16)[0])
            if hb[0, 7] or mcs > 15 or hb[0, 31] or not 1 <= length <= 4095:
                continue
            nss = mcs // 8 + 1
            mod = Mod(F.HT, mcs, BW.BW20, nss)
            n_sym = -(-(8 * length + 22) // (int(_NDBPS_HT[mcs % 8]) * nss))
            if (n_sym * mod.nDBPS > 33000
                    or ls + 448 + 80 * mod.nLTF + n_sym * 80 > cap_len):
                continue
            out.append((i, Plan(mod, n_sym, length, bool(hb[0, 27]), *args)))
        elif lsig_ok and not (nl_elig and (pick_vht or pick_ht)):
            if not 14 <= l_len <= 4095:
                continue
            n_sym = -(-(8 * l_len + 22) // int(ref._NDBPS_L[l_mcs]))
            if (n_sym * ref._NDBPS_L[l_mcs] > 33000
                    or ls + 208 + n_sym * 80 > cap_len):
                continue
            out.append((i, Plan(Mod(F.L, l_mcs), n_sym, l_len, False,
                                *args)))
    return out


def _z(x: np.ndarray, ltf: np.ndarray, cfo: np.ndarray, zl: int,
       p: Prec) -> np.ndarray:
    """Aligned, CFO-corrected windows [B, 2, zl] of both chains."""
    idx = (ltf - 16)[:, None] + np.arange(zl)
    ramp = p(np.exp(1j * cfo[:, None] * np.arange(zl)))
    return np.stack([p(x[c][idx] * ramp) for c in range(2)], axis=1)


def _syms(z: np.ndarray, off: int, n_sym: int, stride: int = 80,
          p: Prec = None) -> np.ndarray:
    """DFT grids [B, 2, n_sym, 64] of both chains, 4 samples into the GI."""
    b = z.shape[0]
    zero = np.zeros(b, np.int64)
    return np.stack([ref.dft(ref._windows(z[:, c], zero + off, n_sym, 4,
                                          stride), p) for c in range(2)],
                    axis=1)


def demod_mrc(x, ltf, cfo, mod: Mod, n_sym: int, p: Prec):
    """One-stream packets on both chains: (LLR pairs, EVM SNR [B])."""
    b = len(ltf)
    doff = ref.data_offset(mod)
    z = _z(x, ltf, cfo, 32 + doff + 80 * n_sym, p)
    legacy = mod.fmt == F.L
    if legacy:
        chan = ref.chan_from(np.mean(_syms(z, 0, 2, 64, p), axis=2),
                             ref._LREF)
    else:
        chan = ref.chan_from(_syms(z, 16 + ref.OFF_NLLTF, 1, p=p)[:, :, 0],
                             ref._NLREF)
    chan = p(chan)
    eq = mrc(_syms(z, 16 + doff, n_sym, p=p), chan, p)
    pidx0 = {F.L: 1, F.HT: 3}.get(mod.fmt, 4)
    ph = ref.pilot_phase(eq, pilot_sequence(mod, n_sym, 0, pidx0=pidx0),
                         tables.PILOT_GRID[(BW.BW20, legacy)], p)
    didx = tables.DATA_GRID[(BW.BW20, legacy)]
    data = p((eq / ph[..., None])[..., didx])
    llr = ref.csi_weighted(p(ref.demap(data, mod.mod)),
                           np.sum(np.abs(chan[..., didx]) ** 2, axis=1),
                           p)[..., ilv.rx_perm(mod, 0)].reshape(b, -1)
    return (ref.depuncture(llr, mod.cr, n_sym * mod.nDBPS),
            ref.evm_snr_db(data, mod.mod, p))


def _chan_2x2(z: np.ndarray, p: Prec):
    """The 2x2 channel H [B, 64, nRx, nSTS] from both HT/VHT-LTFs, and the
    LTF grids [B, nRx, 2, 64]."""
    lf = _syms(z, 16 + ref.OFF_NLLTF, 2, p=p)
    h = np.einsum("sl,brlk->bkrs", P2, lf)
    null = ref._NLREF == 0
    h = h / 2.0 / np.where(null, 1.0, ref._NLREF)[None, :, None, None]
    return p(np.where(null[None, :, None, None], 0.0, h)), lf


def _zf(gd: np.ndarray, h: np.ndarray, p: Prec) -> np.ndarray:
    """ZF of grids [B, nRx, S, 64] through H [B, 64, 2, 2]: [B, 2, S, 64],
    the Gram determinant floored to 1e-12 where it is not above it."""
    hh = np.conj(np.swapaxes(h, -1, -2))
    g = hh @ h
    a, b_, c, d = g[..., 0, 0], g[..., 0, 1], g[..., 1, 0], g[..., 1, 1]
    det = a * d - b_ * c
    det = np.where(np.abs(det) > 1e-12, det, 1e-12)
    inv = np.stack([np.stack([d, -b_], -1), np.stack([-c, a], -1)], -2)
    w = p((inv / det[..., None, None]) @ hh)
    return p(np.einsum("bksr,brSk->bsSk", w, gd))


def _ml_llr(gd: np.ndarray, h: np.ndarray, mod: M) -> np.ndarray:
    """Exact max-log ML LLRs of both streams: grids [B, nRx, S, nSD] and H
    [B, nSD, nRx, 2] -> [B, 2, S, nSD * nBPSCS] (positive = 1)."""
    pts = np.asarray(tables.QAM_TAB[mod], np.complex128)
    nb = int(np.log2(len(pts)))
    idx = np.arange(len(pts))
    ii, jj = np.meshgrid(idx, idx, indexing="ij")
    s0, s1 = pts[ii].ravel(), pts[jj].ravel()                 # [Nc^2]
    y = np.moveaxis(gd, 1, -1)                                # [B, S, K, r]
    out = np.empty((2,) + y.shape[:3] + (nb,))
    for t in range(y.shape[1]):                       # one symbol at a time
        pred = (h[..., 0, None] * s0 + h[..., 1, None] * s1)  # [B,K,r,Nc2]
        dist = np.sum(np.abs(y[:, t, ..., None] - pred) ** 2, axis=-2)
        for st, sel in enumerate((ii.ravel(), jj.ravel())):
            for k in range(nb):
                one = (sel >> k) & 1 == 1
                out[st, :, t, :, k] = (
                    np.min(np.where(one, np.inf, dist), axis=-1)
                    - np.min(np.where(one, dist, np.inf), axis=-1))
    out = np.moveaxis(out, 0, 1)
    return out.reshape(out.shape[:3] + (-1,))


def demod_2x2(x, ltf, cfo, mod: Mod, n_sym: int, p: Prec, ml: bool = False):
    """Two-stream packets: (LLR pairs, per-stream EVM SNR [B, 2])."""
    b = len(ltf)
    doff = ref.data_offset(mod)
    z = _z(x, ltf, cfo, 32 + doff + 80 * n_sym, p)
    h, lf = _chan_2x2(z, p)
    pil = tables.PILOT_GRID[(BW.BW20, False)]
    gd = _syms(z, 16 + doff, n_sym, p=p)                      # [B, 2, S, 64]
    if mod.fmt == F.HT:
        pref = np.stack([pilot_sequence(mod, n_sym, s, pidx0=3)
                         for s in range(2)])                  # [2, S, nP]
        exp = np.einsum("bprs,snp->bnrp", h[:, pil], pref)
    else:
        hsum = lf[:, :, 0, :][..., pil] / ref._NLREF[pil]     # [B, 2, nP]
        exp = np.einsum("brp,np->bnrp", hsum,
                        pilot_sequence(mod, n_sym, 0, pidx0=4))
    obs = np.swapaxes(gd[..., pil], 1, 2)                     # [B, S, 2, nP]
    acc = p(np.sum(obs * np.conj(exp), axis=(-1, -2)))
    gd = p(gd / (acc / np.maximum(np.abs(acc), 1e-12))[:, None, :, None])
    didx = tables.DATA_GRID[(BW.BW20, False)]
    data = _zf(gd, h, p)[..., didx]                           # [B, 2, S, nSD]
    evm = np.stack([ref.evm_snr_db(data[:, s], mod.mod, p) for s in range(2)],
                   axis=1)
    llr = (_ml_llr(gd[..., didx], h[:, didx], mod.mod) if ml
           else p(ref.demap(data, mod.mod)))                  # [B, 2, S, nCB]
    llr = np.stack([llr[:, s][..., ilv.rx_perm(mod, s)] for s in range(2)],
                   axis=2).reshape(b, n_sym, -1)              # [B, S, 2nCB]
    ss, pos = ilv.stream_deparser_maps(mod)
    lanes = [llr[..., np.asarray(ss[e]) * mod.nCBPSS + np.asarray(pos[e])]
             .reshape(b, -1) for e in range(mod.nES)]
    if mod.nES != 1:
        raise NotImplementedError("two encoders do not occur at 20 MHz, "
                                  "two streams")
    return ref.depuncture(lanes[0], mod.cr, n_sym * mod.nDBPS), evm


def decode_captures(caps, int8: bool, p: Prec
                    ) -> List[Tuple[int, List[Result]]]:
    """Captures [2, N] complex64 as the dual-chain 20 MHz receiver reads
    them. Returns, per capture, (triggers, results in trigger order)."""
    n = max(c.shape[1] for c in caps)
    npad = ref.next_pow2(n + 4096, lo=1 << 15)
    xs = np.zeros((len(caps), 2, npad), np.complex128)
    per_cap, jobs = [], []
    for k, cap in enumerate(caps):
        t0 = merge([ref.triggers(cap[c]) for c in range(2)])
        for c in range(2):
            xs[k, c, :cap.shape[1]] = (ref.ingest_int8(cap[c]) if int8
                                       else cap[c])
        xs[k] = p(xs[k])
        per_cap.append([len(t0), []])
        if len(t0) == 0:
            continue
        meta = sig_fields(xs[k], t0, p)
        jobs += ref.plan_jobs(k, meta, plan(meta, cap.shape[1]))

    def demod(items, mod, n_sym, ml):
        fn = demod_2x2 if mod.nSS == 2 else demod_mrc
        kw = dict(ml=ml) if mod.nSS == 2 else {}
        got = [fn(xs[key[0]], np.array([pl.ltf]), np.array([pl.cfo]), mod,
                  n_sym, p, **kw) for key, pl in items]
        return (np.concatenate([g[0] for g in got]),
                np.concatenate([g[1] for g in got]))

    res = ref.decode_jobs(jobs, demod)
    retry = [(key, pl) for key, pl in jobs
             if pl.mod.nSS == 2 and not res[key].fcs_ok]
    for key, r in ref.decode_jobs(retry, demod, ml=True).items():
        if r.fcs_ok:
            res[key] = r
    return ref.attach(per_cap, res)
