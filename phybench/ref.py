"""The plain reference receiver: numpy, float64, written from the receive
semantics the configurations state and from the standard, importing nothing
of the program it judges.

It works out again, from the same captures or rows the program was given:
the STF triggers (lag-16 autocorrelation above 0.5 for 20 samples, 600
apart), the int8 ingest of a long capture (peak-normalized to +-126, round
half to even), each trigger's coarse STF CFO over 144 lag products, the
L-LTF plateau (lags within 0.88 of the peak, their midpoint) with its fine
CFO and correlation SNR, L-SIG / HT-SIG / VHT-SIG-A, the packet plan, and
the DATA field (channel from the L-LTF or the first HT/VHT-LTF, pilot phase
per symbol, max-log demap weighted by each tone's channel power, soft
Viterbi with its decision margin, descrambler) down to the PSDU,
its FCS and its MPDUs, with the EVM SNR of the equalized data tones.

`Prec("bf16")` rounds the signal path (samples after the ingest, every
product, sum, DFT, channel estimate, equalized tone, LLR and the EVM's
sums) to bfloat16: the benchmark's lower-precision control. The trigger
decision and the Viterbi's path metrics stay in float64 in both.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from .wifi.mac import deaggregate_ht, deaggregate_vht
from .wifi.specs import BW, CR, F, M, Mod, interleaver as ilv, tables
from .wifi.specs.crc import fcs_ok
from .wifi.tx.golden import pilot_sequence

OFF_LSIG, OFF_NLSIG, OFF_NLLTF = 128, 208, 448
MIN_GAP, PLATEAU, LAG, THRESH = 600, 20, 16, 0.5
N_PROD, N_LAG, LTF_P, PLATEAU_EDGE = 144, 176, 64, 0.88
# a lag whose correlation lies this close (relative) to the plateau's edge
# is above it or below it to float32's precision: the program may read the
# plateau either way, and its timing and fine CFO follow
EDGE_TIE = 1e-4
SIG_WIN = 752 + 320
KMOD = {M.QPSK: np.sqrt(2.0), M.QAM16: np.sqrt(10.0), M.QAM64: np.sqrt(42.0),
        M.QAM256: np.sqrt(170.0)}
AXIS_BITS = {M.QPSK: 1, M.QAM16: 2, M.QAM64: 3, M.QAM256: 4}


class Prec:
    """The arithmetic precision of the signal path: "f64" leaves values as
    they are; "bf16" rounds each to bfloat16 (round to nearest even)."""

    def __init__(self, name: str = "f64"):
        if name not in ("f64", "bf16"):
            raise ValueError(name)
        self.name = name

    def __call__(self, x):
        if self.name == "f64":
            return x
        x = np.asarray(x)
        if np.iscomplexobj(x):
            return self(x.real) + 1j * self(x.imag)
        u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
        u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
        return u.astype(np.uint32).view(np.float32).astype(np.float64)


# -- the STF trigger and the int8 ingest --------------------------------------
def triggers(x: np.ndarray) -> np.ndarray:
    """STF trigger positions of a 1-D capture: where |sum of 16 lag-16
    products|^2 > 0.25 * (power at both ends) for 20 consecutive samples,
    the first of each such run, a trigger at least 600 after the last kept
    one."""
    x = x.astype(np.complex128)
    prod = x[:-LAG] * np.conj(x[LAG:])
    pwr = np.abs(x) ** 2

    def movsum(a):
        c = np.concatenate([[0], np.cumsum(a)])
        return c[LAG:] - c[:-LAG]
    acc = movsum(prod)
    p1 = movsum(pwr[:-LAG])
    p2 = movsum(pwr[LAG:])
    n_pos = len(x) - 2 * LAG + 1
    acc, p1, p2 = acc[:n_pos], p1[:n_pos], p2[:n_pos]
    pp = np.where((p1 > 0) & (p2 > 0), p1 * p2, 0.0)
    above = (np.abs(acc) ** 2 > THRESH ** 2 * pp + 1e-24).astype(np.int32)
    run = np.concatenate([[0], np.cumsum(above)])
    full = (run[PLATEAU:] - run[:-PLATEAU]) == PLATEAU   # [i - 19, i] all
    prev = np.concatenate([[0], above[:-1]])[:len(full)]
    starts = np.flatnonzero(full & (prev == 0))
    out, last = [], -MIN_GAP
    for s in starts:
        if s - last >= MIN_GAP:
            out.append(int(s))
            last = int(s)
    return np.asarray(out, np.int64)


def ingest_int8(x: np.ndarray) -> np.ndarray:
    """The int8 ingest of a capture [..., N] complex64: float32 samples
    times 126 / peak (the largest |I| or |Q| over the capture), clipped to
    +-127, rounded half to even, then times peak / 126 in float32."""
    iq = np.ascontiguousarray(x, np.complex64).view(np.float32)
    peak = np.float32(max(float(np.abs(iq).max(initial=0.0)), 1e-12))
    s = np.float32(126.0) / peak
    q = np.rint(np.clip(iq * s, -127.0, 127.0)).astype(np.int8)
    deq = q.astype(np.float32) * np.float32(peak / np.float32(126.0))
    return deq.view(np.complex64)


def next_pow2(n: int, lo: int = 1) -> int:
    n = max(int(n), lo)
    return 1 << (n - 1).bit_length()


# -- OFDM helpers ----------------------------------------------------------
def dft(x: np.ndarray, p: Prec) -> np.ndarray:
    """Shifted 64-point DFT over the last axis (bin -32 first)."""
    return p(np.fft.fftshift(np.fft.fft(x, axis=-1), axes=-1))


def ltf_ref(legacy: bool) -> np.ndarray:
    lim = 26 if legacy else 28
    seq = tables.LTF_L[BW.BW20] if legacy else tables.LTF_HT[BW.BW20]
    g = np.zeros(64, np.complex128)
    g[32 - lim:32 + lim + 1] = seq
    return g


def chan_from(avg: np.ndarray, ref: np.ndarray) -> np.ndarray:
    null = ref == 0
    return np.where(null, 1.0, avg / np.where(null, 1.0, ref))


def pilot_phase(eq: np.ndarray, ref: np.ndarray, bins, p: Prec) -> np.ndarray:
    acc = p(np.sum(eq[..., bins] * np.conj(ref), axis=-1))
    mag = np.abs(acc)
    return acc / np.where(mag > 0, mag, 1.0)


def demap(eq: np.ndarray, mod: M) -> np.ndarray:
    """Max-log LLRs (positive = 1) of tones [..., nSD]: [..., nSD * nBPSCS],
    I-axis bits then Q-axis bits per tone."""
    if mod == M.BPSK:
        return eq.real
    nb = AXIS_BITS[mod]
    v = eq * KMOD[mod]
    lv = []
    for axis in (v.real, v.imag):
        a = axis
        lv.append(a)
        for k in range(1, nb):
            a = (1 << (nb - k)) - np.abs(a)
            lv.append(a)
    return np.stack(lv, axis=-1).reshape(eq.shape[:-1] + (-1,))


def evm_snr_db(data: np.ndarray, mod: M, p: Prec) -> np.ndarray:
    """EVM SNR of tones [B, S, nSD] against per-axis hard decisions."""
    if mod == M.BPSK:
        v = data
        re, im = np.sign(v.real), np.zeros(v.shape)
    else:
        v = data * KMOD[mod]
        lim = 2 * (1 << (AXIS_BITS[mod] - 1)) - 1

        def quant(a):
            return np.clip(2 * np.round((a - 1) / 2) + 1, -lim, lim)
        re, im = quant(v.real), quant(v.imag)
    err = p((v.real - re) ** 2 + (v.imag - im) ** 2)
    sig = re ** 2 + im ** 2
    pe = p(np.mean(err, axis=(-2, -1)))
    ps = np.mean(sig, axis=(-2, -1))
    return 10 * np.log10(np.maximum(ps, 1e-12) / np.maximum(pe, 1e-12))


# -- soft Viterbi, descrambler ---------------------------------------------
_NS = np.arange(64)
_PRED = np.stack([((_NS & 31) << 1) | d for d in (0, 1)], axis=1)   # [64, 2]
_OUT = tables.SV_PREV_OUTPUT2                                        # [64, 2]
# the sign of each coded bit's LLR in each branch: +1 for a 1, -1 for a 0
_SGN0 = 2.0 * ((_OUT >> 1) & 1) - 1.0
_SGN1 = 2.0 * (_OUT & 1) - 1.0


def depuncture(llr: np.ndarray, cr: CR, n_steps: int) -> np.ndarray:
    """[B, n_coded] -> [B, n_steps, 2] with zeros in the punctured slots."""
    pat = tables.PUNCTURE[cr].astype(bool)
    keep = np.flatnonzero(np.tile(pat, -(-2 * n_steps // len(pat)))
                          [:2 * n_steps])
    out = np.zeros((llr.shape[0], 2 * n_steps))
    k = min(len(keep), llr.shape[1])
    out[:, keep[:k]] = llr[:, :k]
    return out.reshape(llr.shape[0], n_steps, 2)


def viterbi(llr: np.ndarray, cr: CR, n_bits: int) -> np.ndarray:
    """Soft-decision Viterbi (K = 7, 133/171 octal) from state 0, path
    metrics in float64, traceback from the best final state: [B, n_coded]
    -> [B, n_bits] uint8."""
    return viterbi_pairs([depuncture(llr, cr, n_bits)])[0]


def viterbi_pairs(pairs: List[np.ndarray], margins: bool = False):
    """The Viterbi over lists of depunctured LLR pairs [B_i, T_i, 2], all
    at once: rows sorted by length and decoded in blocks, each block's
    shorter rows padded with zero LLRs (path-neutral: the best final state
    after them traces back through the best state at the row's own end).
    State s holds the last six inputs, the newest in bit 5, so the two
    predecessors of s are 2 (s mod 32) and 2 (s mod 32) + 1. Runs in plain
    PyTorch on the card when there is one (after the program's window),
    else on the host. Returns [B_i, T_i] uint8 per input; with `margins`
    also, per input, each row's decision margin [B_i]: the smallest gap
    between the two paths that meet at a state of the traced path, over
    the row's own steps, as a share of the row's mean nonzero |LLR|. A
    decode whose margin is wide is the same under any perturbation of its
    LLRs and path metrics that moves no such gap by that much; one whose
    margin is narrow may decode otherwise in another precision."""
    import torch
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    rows = [(i, j) for i, p in enumerate(pairs) for j in range(len(p))]
    rows.sort(key=lambda r: pairs[r[0]].shape[1])
    out = [np.empty(p.shape[:2], np.uint8) for p in pairs]
    marg = [np.empty(len(p)) for p in pairs]
    s0 = torch.tensor(_SGN0.reshape(2, 32, 2), dtype=torch.float64,
                      device=dev)
    s1 = torch.tensor(_SGN1.reshape(2, 32, 2), dtype=torch.float64,
                      device=dev)
    budget = 1 << 31 if dev.type == "cuda" else 1 << 27   # decision bytes
    k = 0
    while k < len(rows):
        t_max = pairs[rows[k][0]].shape[1]
        n = 1
        while k + n < len(rows):
            t_next = pairs[rows[k + n][0]].shape[1]
            if (n + 1) * max(t_max, t_next) * 64 > budget:
                break
            t_max = max(t_max, t_next)
            n += 1
        blk = rows[k:k + n]
        lp = np.zeros((n, t_max, 2))
        lens = np.array([pairs[i].shape[1] for i, _ in blk])
        for r, (i, j) in enumerate(blk):
            lp[r, :lens[r]] = pairs[i][j]
        bits, mg = _viterbi_block(torch.from_numpy(lp).to(dev), s0, s1,
                                  lens if margins else None)
        for r, (i, j) in enumerate(blk):
            out[i][j] = bits[r, :lens[r]]
            if margins:
                marg[i][j] = mg[r]
        k += n
    return (out, marg) if margins else out


def _viterbi_block(lp, s0, s1, lens=None):
    """One block of rows [b, t_max, 2]: (bits [b, t_max], with `lens` the
    rows' decision margins [b], else None)."""
    import torch
    b, t_max, _ = lp.shape
    m = torch.full((b, 64), -1e300, dtype=torch.float64, device=lp.device)
    m[:, 0] = 0.0
    dec = torch.empty((t_max, b, 64), dtype=torch.bool, device=lp.device)
    if lens is not None:        # float16: an overflow is a wide margin
        gap = torch.empty((t_max, b, 64), dtype=torch.float16,
                          device=lp.device)
    for t in range(t_max):
        cand = (m.view(b, 1, 32, 2) + lp[:, t, 0, None, None, None] * s0
                + lp[:, t, 1, None, None, None] * s1)
        d = cand[..., 1] > cand[..., 0]
        if lens is not None:
            gap[t] = (cand[..., 1] - cand[..., 0]).abs().reshape(b, 64)
        m = torch.where(d, cand[..., 1], cand[..., 0]).reshape(b, 64)
        dec[t] = d.reshape(b, 64)
        if t % 64 == 63:
            m = m - m.amax(dim=1, keepdim=True)
    s = torch.argmax(m, dim=1)
    rows = torch.arange(b, device=lp.device)
    path = torch.empty((t_max, b), dtype=torch.long, device=lp.device)
    for t in range(t_max - 1, -1, -1):
        path[t] = s
        s = ((s & 31) << 1) | dec[t, rows, s].long()
    bits = (path >> 5).to(torch.uint8).T.cpu().numpy()
    if lens is None:
        return bits, None
    on = gap.gather(2, path[..., None])[..., 0].float()      # [t_max, b]
    own = torch.arange(t_max, device=lp.device)[:, None] < torch.as_tensor(
        lens, device=lp.device)[None]
    nz = lp != 0
    scale = (lp.abs().sum(dim=(1, 2))
             / nz.sum(dim=(1, 2)).clamp(min=1)).clamp(min=1e-300)
    mg = torch.where(own, on, float("inf")).amin(dim=0) / scale
    return bits, mg.cpu().numpy()


def _seed_table() -> np.ndarray:
    inv = np.zeros(128, np.int64)
    for seed in range(1, 128):
        key = sum(int(tables.SCRAMBLE_SEQ[seed, i]) << i for i in range(7))
        inv[key] = seed
    return inv


_SEED_OF = _seed_table()


def descramble(bits: np.ndarray) -> np.ndarray:
    """The scrambler seed from the first 7 bits (zero before scrambling),
    then the PRBS removed: [B, n] -> [B, n]."""
    key = (bits[:, :7].astype(np.int64) << np.arange(7)).sum(axis=1)
    seq = tables.SCRAMBLE_SEQ[_SEED_OF[key]]                 # [B, 127]
    reps = -(-bits.shape[1] // 127)
    return bits ^ np.tile(seq, (1, reps))[:, :bits.shape[1]].astype(np.uint8)


def crc8_ok(bits: np.ndarray) -> np.ndarray:
    """CRC-8 of bits [:, :34] equals bits [:, 34:42] (SIG fields)."""
    return np.array([list(r[34:42]) == tables.crc8_bits(list(r[:34]))
                     for r in bits.astype(int)], bool)


def uint(bits: np.ndarray, lo: int, n: int) -> np.ndarray:
    return (bits[:, lo:lo + n].astype(np.int64) << np.arange(n)).sum(axis=1)


# -- sync and the SIG fields -----------------------------------------------
def sync_front(x: np.ndarray, row: np.ndarray, t0: np.ndarray, p: Prec):
    """Coarse STF CFO, LTF plateau and fine CFO of windows at t0 in rows
    `row` of x [R, N] (row, t0 [B]). Returns (ltf_start [B] int, cfo [B]
    rad per sample, snr [B] dB, alts: per window the (ltf_start, cfo) of
    the plateau read with its edge lags that tie (EDGE_TIE) on the other
    side)."""
    b = len(t0)
    idx = t0[:, None] + np.arange(80 + N_LAG + 3 * LTF_P)
    w = p(x[row[:, None], idx])
    acc = p(np.sum(p(w[:, :N_PROD] * np.conj(w[:, LAG:LAG + N_PROD])),
                   axis=1))
    cfo_c = np.arctan2(acc.imag, acc.real) / LAG
    y = p(w[:, 80:] * p(np.exp(1j * cfo_c[:, None]
                               * np.arange(w.shape[1] - 80))))
    prod = p(y[:, :-LTF_P] * np.conj(y[:, LTF_P:]))
    pwr = p(np.abs(y) ** 2)

    def movsum(a):
        c = np.concatenate([np.zeros((b, 1)), np.cumsum(a, axis=1)], axis=1)
        return p(c[:, LTF_P:] - c[:, :-LTF_P])
    num = movsum(prod.real) + 1j * movsum(prod.imag)
    den = np.sqrt(movsum(pwr[:, :-LTF_P]) * movsum(pwr[:, LTF_P:]))
    ac = p(np.abs(num) / (den + 1e-12))[:, :N_LAG]
    mx = ac.max(axis=1)
    thr = PLATEAU_EDGE * mx[:, None]
    mask = ac >= thr
    near = np.abs(ac - thr) <= EDGE_TIE * thr

    def mid(m):
        return (np.argmax(m, axis=1) + N_LAG - 1
                - np.argmax(m[:, ::-1], axis=1)) // 2
    d_mid = mid(mask)

    def reading(d, r=slice(None)):
        a2 = num[np.arange(b)[r], d + 16]
        return t0[r] + 80 + d + 16 - 2, cfo_c[r] + np.arctan2(
            a2.imag, a2.real) / LTF_P
    ltf_start, cfo = reading(d_mid)
    alts = [[] for _ in range(b)]
    for r in np.flatnonzero(near.any(axis=1)):
        wide, narrow = mask[r] | near[r], mask[r] & ~near[r]
        # the plateau's first lag read from one mask, its last from another
        ds = {(int(np.argmax(f)) + N_LAG - 1 - int(np.argmax(l[::-1]))) // 2
              for f in (wide, narrow) for l in (wide, narrow)
              if f.any() and l.any()}
        for d in sorted(ds - {d_mid[r]}):
            lt, cf = reading(np.array([d]), slice(r, r + 1))
            alts[r].append((int(lt[0]), float(cf[0])))
    snr = 10 * np.log10(np.maximum(mx / np.maximum(1 - mx, 1e-6), 1e-6))
    return ltf_start, cfo, snr, alts


def _windows(y: np.ndarray, start: np.ndarray, n_sym: int, shift: int,
             stride: int = 80) -> np.ndarray:
    """Symbol windows [B, n_sym, 64] of rows y [B, N]: symbol k's 64
    samples begin `shift` samples into its 16-sample GI at start + k *
    stride."""
    idx = (start[:, None, None] + 16 - shift + stride * np.arange(n_sym)
           [None, :, None] + np.arange(64))
    return y[np.arange(len(start))[:, None, None], idx]


_LREF = ltf_ref(True)
_NLREF = ltf_ref(False)
_SIG_DATA = tables.DATA_GRID[(BW.BW20, True)]
_SIG_PIL = tables.PILOT_GRID[(BW.BW20, True)]
_SIG_PERM = ilv.sig_rx_perm()
_RATE_BITS = np.asarray(tables.LEGACY_RATE_BITS)


def sig_fields(x: np.ndarray, t0: np.ndarray, p: Prec) -> Dict:
    """Sync and SIG of windows at t0 in one capture x [N]: ltf_start, cfo,
    snr, lsig_ok, l_mcs, l_len, ht_ok / vht_ok / q_dom and the HT-SIG
    and VHT-SIG-A bits [B, 48]."""
    ltf, cfo, snr, alts = sync_front(x[None], np.zeros(len(t0), np.int64),
                                     t0, p)
    # the CFO ramp runs from each window's first sample
    n = SIG_WIN
    rows = x[t0[:, None] + np.arange(n)]
    y = p(rows * p(np.exp(1j * cfo[:, None] * np.arange(n))))
    rel = ltf - t0
    chan = chan_from(np.mean(dft(_windows(y, rel - 16, 2, 8, 64), p), axis=1),
                     _LREF)

    def tones(start, n_sym, pol):
        eq = p(dft(_windows(y, start, n_sym, 8), p) / chan[:, None])
        ref = tables.PILOT_L[None] * tables.PILOT_POLARITY[pol][:, None]
        ph = pilot_phase(eq, ref, _SIG_PIL, p)
        return p((eq / ph[..., None])[..., _SIG_DATA])
    out = fields_from_tones(tones(rel + OFF_LSIG, 1, [0])[:, 0],
                            tones(rel + OFF_NLSIG, 2, [1, 2]))
    out.update(ltf=ltf, cfo=cfo, snr=snr, alts=alts)
    return out


def fields_from_tones(lsig: np.ndarray, nl: np.ndarray) -> Dict:
    """L-SIG, HT-SIG and VHT-SIG-A from the equalized, pilot-corrected data
    tones of the L-SIG symbol [B, 48] and the two symbols after it [B, 2,
    48]: lsig_ok, l_mcs, l_len, ht_ok / vht_ok (CRC-8), q_dom [B, 2]
    (each symbol's energy on Q: QBPSK) and both field's bits."""
    lbits = viterbi(lsig.real[:, _SIG_PERM], CR.CR12, 24)
    lsig_ok = ((lbits[:, :17].sum(axis=1) % 2 == lbits[:, 17])
               & (lbits[:, 3] == 1) & (lbits[:, 4] == 0))
    match = np.all(lbits[:, None, :4] == _RATE_BITS[None], axis=-1)
    im, re = nl.imag, nl.real
    ht = viterbi(np.concatenate([im[:, 0][:, _SIG_PERM],
                                 im[:, 1][:, _SIG_PERM]], axis=1),
                 CR.CR12, 48)
    vht = viterbi(np.concatenate([re[:, 0][:, _SIG_PERM],
                                  im[:, 1][:, _SIG_PERM]], axis=1),
                  CR.CR12, 48)
    return dict(lsig_ok=lsig_ok, l_mcs=np.argmax(match, axis=1),
                l_len=uint(lbits, 5, 12), ht_ok=crc8_ok(ht),
                vht_ok=crc8_ok(vht),
                q_dom=(im ** 2).sum(-1) > (re ** 2).sum(-1),
                ht_bits=ht, vht_bits=vht)


# -- the packet plan --------------------------------------------------------
@dataclasses.dataclass
class Plan:
    mod: Mod
    n_sym: int
    psdu_len: int
    ampdu: bool
    ltf: int
    cfo: float
    snr: float


_NDBPS_L = np.array([24, 36, 48, 72, 96, 144, 192, 216])
_NDBPS_HT = np.array([26, 52, 78, 104, 156, 208, 234, 260])


def sig_format(meta: Dict[str, np.ndarray], i: int) -> Tuple[bool, bool]:
    """(HT, VHT) of trigger i after a 6 Mbps L-SIG, by the standard's
    constellations and CRCs: HT-SIG is QBPSK in both symbols, VHT-SIG-A is
    BPSK then QBPSK; anything else (a legacy packet's BPSK DATA) is
    legacy, whatever a CRC-8 over its bits says."""
    q0, q1 = (bool(v) for v in meta["q_dom"][i])
    return (bool(meta["ht_ok"][i]) and q0 and q1,
            bool(meta["vht_ok"][i]) and not q0 and q1)


def plan(meta: Dict[str, np.ndarray], cap_len: int) -> List[Tuple[int, Plan]]:
    """The single-stream 20 MHz receiver's plan of each trigger: which
    windows decode, as what, with how many symbols. Returns [(trigger
    index, Plan)] in trigger order."""
    out = []
    for i in range(len(meta["ltf"])):
        if not (meta["lsig_ok"][i] and meta["snr"][i] > 0):
            continue
        ls, l_mcs, l_len = int(meta["ltf"][i]), int(meta["l_mcs"][i]), \
            int(meta["l_len"][i])
        hb, vb = meta["ht_bits"][i:i + 1], meta["vht_bits"][i:i + 1]
        pick_ht, pick_vht = sig_format(meta, i)
        v_gid = int(uint(vb, 4, 6)[0])
        v_su = v_gid in (0, 63)
        nl = l_mcs == 0
        args = (ls, float(meta["cfo"][i]), float(meta["snr"][i]))
        if nl and pick_vht and v_su:
            if (int(uint(vb, 0, 2)[0]) != 0 or vb[0, 24]
                    or not 1 <= int(uint(vb, 10, 3)[0]) + 1 <= 4):
                continue
            nsts = int(uint(vb, 10, 3)[0]) + 1
            n_sym = -(-(l_len * 8 + 22) // 24) - 4 - tables.N_LTF[nsts]
            if n_sym <= 0 or nsts != 1:
                continue
            mod = Mod(F.VHT, int(uint(vb, 28, 4)[0]), BW.BW20, 1)
            psdu_len = (n_sym * mod.nDBPS - 16 - 6 * mod.nES) // 8
            if (n_sym * mod.nDBPS > 33000 or psdu_len > 4095
                    or ls + 608 + n_sym * 80 > cap_len):
                continue
            out.append((i, Plan(mod, n_sym, psdu_len, True, *args)))
        elif nl and pick_ht:
            mcs, length = int(uint(hb, 0, 7)[0]), int(uint(hb, 8, 16)[0])
            if hb[0, 7] or mcs > 7 or hb[0, 31] or not 1 <= length <= 4095:
                continue
            n_sym = -(-(8 * length + 22) // int(_NDBPS_HT[mcs]))
            if (n_sym * _NDBPS_HT[mcs] > 33000
                    or ls + 528 + n_sym * 80 > cap_len):
                continue
            out.append((i, Plan(Mod(F.HT, mcs, BW.BW20, 1), n_sym, length,
                                bool(hb[0, 27]), *args)))
        elif not (nl and pick_vht and not v_su):
            if not 14 <= l_len <= 4095:
                continue
            n_sym = -(-(8 * l_len + 22) // int(_NDBPS_L[l_mcs]))
            if (n_sym * _NDBPS_L[l_mcs] > 33000
                    or ls + 208 + n_sym * 80 > cap_len):
                continue
            out.append((i, Plan(Mod(F.L, l_mcs), n_sym, l_len, False,
                                *args)))
    return out


# -- the DATA field --------------------------------------------------------
def data_offset(mod: Mod) -> int:
    if mod.fmt == F.L:
        return OFF_LSIG + 80
    return OFF_NLLTF + 80 * mod.nLTF + (80 if mod.fmt == F.VHT else 0)


def demod_data(x: np.ndarray, row: np.ndarray, ltf: np.ndarray,
               cfo: np.ndarray, mod: Mod, n_sym: int, p: Prec):
    """DATA demod of packets of one (mod, n_sym): packet j lies in row
    row[j] of x [R, N], its LTF data starting at ltf[j], with CFO cfo[j].
    Returns (depunctured LLR pairs [B, n_sym * nDBPS, 2], EVM SNR [B]
    dB)."""
    b = len(ltf)
    doff = data_offset(mod)
    zl = 32 + doff + 80 * n_sym
    z = x[row[:, None], (ltf - 16)[:, None] + np.arange(zl)]
    z = p(p(z) * p(np.exp(1j * cfo[:, None] * np.arange(zl))))
    zero = np.zeros(b, np.int64)
    if mod.fmt == F.L:
        chan = chan_from(np.mean(dft(_windows(z, zero, 2, 4, 64), p), axis=1),
                         _LREF)
    else:
        chan = chan_from(dft(_windows(z, zero + 16 + OFF_NLLTF, 1, 4),
                             p)[:, 0],
                         _NLREF)
    chan = p(chan)
    legacy = mod.fmt == F.L
    g = dft(_windows(z, zero + 16 + doff, n_sym, 4), p)
    eq = p(g / chan[:, None])
    pidx0 = {F.L: 1, F.HT: 3}.get(mod.fmt, 4)
    ph = pilot_phase(eq, pilot_sequence(mod, n_sym, 0, pidx0=pidx0),
                     tables.PILOT_GRID[(BW.BW20, legacy)], p)
    didx = tables.DATA_GRID[(BW.BW20, legacy)]
    data = p((eq / ph[..., None])[..., didx])
    llr = csi_weighted(p(demap(data, mod.mod)), np.abs(chan[:, didx]) ** 2,
                       p)[..., ilv.rx_perm(mod, 0)].reshape(b, -1)
    return (depuncture(llr, mod.cr, n_sym * mod.nDBPS),
            evm_snr_db(data, mod.mod, p))


def csi_weighted(llr: np.ndarray, w: np.ndarray, p: Prec) -> np.ndarray:
    """LLRs [B, S, nSD * bits] of a single-stream packet, each tone's
    scaled by its channel power w [B, nSD] over w's mean: the max-log
    metric of an equalized tone, whose noise the equalizer raised by
    1 / |H|^2."""
    w = w / np.maximum(np.mean(w, axis=-1, keepdims=True), 1e-12)
    return p(llr * np.repeat(w, llr.shape[-1] // w.shape[-1],
                             axis=-1)[:, None, :])


@dataclasses.dataclass
class Result:
    """One decoded packet as the reference reads it."""
    fmt: str
    mcs: int
    psdu: bytes
    fcs_ok: bool
    mpdus: Tuple[bytes, ...]
    cfo_hz: float
    snr_db: float
    evm_snr_db: float
    margin: float = float("inf")   # the DATA Viterbi's (viterbi_pairs)
    alts: tuple = ()     # equally valid readings (tied timings, chains)


def assemble(fmt: F, psdu: bytes, ampdu: bool) -> Tuple[bool, tuple]:
    """FCS and MPDUs of a PSDU: a VHT PSDU and an aggregated HT one are
    A-MPDUs (MPDUs with a good FCS kept), any other one MPDU."""
    if fmt == F.VHT or ampdu:
        subs = (deaggregate_vht if fmt == F.VHT else deaggregate_ht)(psdu)
        mp = tuple(s.mpdu for s in subs if s.fcs_ok)
        return len(mp) > 0, mp
    ok = fcs_ok(psdu)
    return ok, (psdu,) if ok else ()


def decode_captures(caps, int8: bool, p: Prec
                    ) -> List[Tuple[int, List[Result]]]:
    """Captures [N] complex64 as the single-stream 20 MHz receiver reads
    them, each on its own; the DATA decodes of one (mod, n_sym) are batched
    over all of them. Returns, per capture, (triggers, results in trigger
    order), each result with the readings of its tied timings as `alts`."""
    n = max(len(c) for c in caps)
    x = np.zeros((len(caps), next_pow2(n + 4096, lo=1 << 15)), np.complex128)
    per_cap, jobs = [], []
    for k, cap in enumerate(caps):
        t0 = triggers(cap)
        x[k, :len(cap)] = ingest_int8(cap) if int8 else cap
        x[k] = p(x[k])
        per_cap.append([len(t0), []])
        if len(t0) == 0:
            continue
        meta = sig_fields(x[k], t0, p)
        jobs += plan_jobs(k, meta, plan(meta, len(cap)))

    def demod(key_pls, mod, n_sym, ml):
        return demod_data(x, np.array([key[0] for key, _ in key_pls]),
                          np.array([pl.ltf for _, pl in key_pls]),
                          np.array([pl.cfo for _, pl in key_pls]), mod,
                          n_sym, p)
    return attach(per_cap, decode_jobs(jobs, demod))


def plan_jobs(k: int, meta: Dict, plans) -> list:
    """The decodes of capture k's plans: ((k, i, 0), plan) and, per tied
    reading j of its timing, ((k, i, j), the plan at that reading)."""
    out = []
    for i, pl in plans:
        out.append(((k, i, 0), pl))
        for j, (lt, cf) in enumerate(meta["alts"][i], 1):
            out.append(((k, i, j), dataclasses.replace(pl, ltf=lt, cfo=cf)))
    return out


def decode_jobs(jobs, demod, ml: bool = False) -> Dict:
    """Every job's Result: the demods of one (mod, n_sym) together
    (demod(jobs, mod, n_sym, ml) -> (LLR pairs, EVM SNRs [B] or [B, nSS])),
    then one Viterbi over all."""
    groups: Dict = {}
    for key, pl in jobs:
        groups.setdefault((pl.mod, pl.n_sym), []).append((key, pl))
    demods = [demod(items, mod, n_sym, ml)
              for (mod, n_sym), items in groups.items()]
    decoded, margins = viterbi_pairs([lp for lp, _ in demods], True)
    res = {}
    for ((mod, _), items), bits, mg, (_, evm) in zip(
            groups.items(), decoded, margins, demods):
        for (key, pl), bb, m, ev in zip(items, descramble(bits), mg, evm):
            psdu = np.packbits(bb[16:16 + 8 * pl.psdu_len],
                               bitorder="little").tobytes()
            ok, mp = assemble(mod.fmt, psdu, pl.ampdu)
            res[key] = Result(mod.fmt.name, mod.mcs, psdu, ok, mp,
                              -pl.cfo * 20e6 / (2 * np.pi), pl.snr,
                              float(np.mean(ev)), float(m))
    return res


def attach(per_cap: list, res: Dict) -> List[Tuple[int, List[Result]]]:
    """Per capture (triggers, results in trigger order), each main reading
    (j = 0) carrying its tied readings as `alts`."""
    for (k, i, j), r in sorted(res.items()):
        if j == 0:
            r.alts = tuple(res[(k, i, jj)] for jj in range(1, 64)
                           if (k, i, jj) in res)
            per_cap[k][1].append((i, r))
    return [(nt, [r for _, r in sorted(found, key=lambda t: t[0])])
            for nt, found in per_cap]


def decode_rows(x: np.ndarray, t0: np.ndarray, mod: Mod, n_sym: int,
                p: Prec) -> Dict[str, np.ndarray]:
    """The fixed-config receive step on rows x [B, W] complex64 triggered
    at t0 [B]: bits [B, n_sym * nDBPS], cfo [B] (rad per sample), snr [B]
    (dB), cfo_alts [B] (the CFOs of tied plateau readings)."""
    xr = p(np.asarray(x, np.complex128))
    rows = np.arange(len(xr))
    ltf, cfo, snr, alts = sync_front(xr, rows, np.asarray(t0, np.int64), p)
    lp, _ = demod_data(xr, rows, ltf, cfo, mod, n_sym, p)
    return dict(bits=descramble(viterbi_pairs([lp])[0]), cfo=cfo, snr=snr,
                cfo_alts=[[c for _, c in a] for a in alts])
