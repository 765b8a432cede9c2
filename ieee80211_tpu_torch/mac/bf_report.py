"""VHT compressed beamforming report codec (IEEE 802.11-2020 9.4.1.48/9.6.22).

Wire parity with the reference codec (tools/mac80211header.py:568-731
genVhtCompressedBfReport / genMgmtActVhtCompressBf /
mgmtVhtActCompressBfParser): MIMO control field, per-tone Givens angles at
the standard's feedback subcarrier indices, average-SNR field.

Copy of ieee80211_tpu/mac/bf_report.py over the port's copy of
mu/feedback.py; tests/test_torch_mu.py holds it equal to the original.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..mu.feedback import ANGLE_IS_PHI, N_ANGLES, compress_v, recover_v
from ..specs import BW, tables

#: Feedback subcarrier indices, 20 MHz, by grouping (table 9-76).
BFFB_SCIDX_20 = {
    1: [k for k in range(-28, 29) if k not in (-21, -7, 0, 7, 21)],
    2: [-28, -26, -24, -22, -20, -18, -16, -14, -12, -10, -8, -6, -4, -2, -1,
        1, 2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24, 26, 28],
    4: [-28, -24, -20, -16, -12, -8, -4, -1, 1, 4, 8, 12, 16, 20, 24, 28],
}


def _angle_bits(nr: int, codebook: int) -> List[int]:
    nbit_phi, nbit_psi = (9, 7) if codebook else (7, 5)
    return [nbit_phi if is_phi else nbit_psi for is_phi in ANGLE_IS_PHI[nr]]


def build_bf_report(v56: np.ndarray, snr_db: Sequence[float], group: int = 1,
                    codebook: int = 0) -> bytes:
    """Per-tone V [56, nr, nc] (tones -28..28 excl DC) -> report bytes."""
    nr, nc = v56.shape[-2], v56.shape[-1]
    bits: List[int] = []
    for s in snr_db:
        # SNR table: -10 dB .. 53.75 dB in 0.25 dB steps, biased by -128
        q = int(np.clip(int(round(s * 4)) + 40 - 128, -128, 127))
        for j in range(8):
            bits.append((q >> j) & 1)
    occ = [k for k in range(-28, 29) if k != 0]
    sc_idx = BFFB_SCIDX_20[group]
    nbits = _angle_bits(nr, codebook)
    for k in sc_idx:
        vk = v56[occ.index(k)]
        angles, kinds = compress_v(vk, codebook)
        for a, nb in zip(angles, nbits[:len(angles)]):
            for j in range(nb):
                bits.append((a >> j) & 1)
    bits += [0] * (-len(bits) % 8)
    out = bytearray()
    for i in range(len(bits) // 8):
        byte = 0
        for j in range(8):
            byte |= bits[i * 8 + j] << j
        out.append(byte)
    return bytes(out)


def build_mimo_control(nr: int, nc: int, bw: BW, group: int, codebook: int,
                       fb_type: int, token: int) -> bytes:
    ctrl = (nc - 1)
    ctrl |= (nr - 1) << 3
    ctrl |= bw.value << 6
    ctrl |= {1: 0, 2: 1, 4: 2}[group] << 8
    ctrl |= codebook << 10
    ctrl |= fb_type << 11
    ctrl |= 0 << 12          # first (only) feedback segment
    ctrl |= 1 << 15
    ctrl |= token << 18
    return struct.pack("<L", ctrl)[:3]


def build_vht_compressed_bf_action(v56: np.ndarray, snr_db: Sequence[float],
                                   bw: BW = BW.BW20, group: int = 1,
                                   codebook: int = 0, fb_type: int = 1,
                                   token: int = 0) -> bytes:
    """VHT Action frame body: category handled by the caller
    (mac.frames.build_mgmt_action_no_ack with category 21)."""
    nr, nc = v56.shape[-2], v56.shape[-1]
    body = b"\x00"  # VHT action: compressed beamforming
    body += build_mimo_control(nr, nc, bw, group, codebook, fb_type, token)
    body += build_bf_report(v56, snr_db, group, codebook)
    return body


def parse_vht_compressed_bf_action(body: bytes
                                   ) -> Tuple[np.ndarray, dict]:
    """Action body -> (per-feedback-tone recovered V [nTones, nr, nc], info).

    Tones are at BFFB_SCIDX_20[group]; interpolation back to all 56 tones is
    the caller's choice (parity: mgmtVhtActCompressBfParser).
    """
    assert body[0] == 0
    ctrl = struct.unpack("<L", body[1:4] + b"\x00")[0]
    nc = (ctrl & 7) + 1
    nr = ((ctrl >> 3) & 7) + 1
    bw = BW((ctrl >> 6) & 3)
    group = 1 << ((ctrl >> 8) & 3)
    codebook = (ctrl >> 10) & 1
    fb_type = (ctrl >> 11) & 1
    token = (ctrl >> 18) & 63
    sc_idx = BFFB_SCIDX_20[group]
    n_ang = N_ANGLES[(nr, nc)]
    nbits = _angle_bits(nr, codebook)[:n_ang]
    payload = body[4 + nc:]
    bits = []
    for byte in payload:
        for j in range(8):
            bits.append((byte >> j) & 1)
    vs = []
    it = 0
    for _ in sc_idx:
        angles = []
        for nb in nbits:
            a = 0
            for j in range(nb):
                a |= bits[it] << j
                it += 1
            angles.append(a)
        vs.append(recover_v(nr, nc, angles, codebook))
    info = dict(nr=nr, nc=nc, bw=bw, group=group, codebook=codebook,
                fb_type=fb_type, token=token, sc_idx=sc_idx)
    return np.stack(vs), info
