"""Batched synchronization ops (PyTorch): window slice, STF coarse CFO, LTF
plateau timing and fine CFO.

Port of the receive-step half of ieee80211_tpu/ops/sync.py
(`batch_slice_iq` :89, `sync_front_iq` :109, `_ltf_sync_window` :132,
`cfo_ramp` :216). `coarse_cfo`, `sync_front` and `ltf_sync` have no callers
there and are not ported. The window slice runs in the hand-written kernel
(ops/cuda/gather.py, csrc/gather.cu) on a CUDA tensor and in the plain
version below on a CPU tensor.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..utils.riq import r2c
from .cuda.gather import batch_slice_iq_cuda

# Preamble search geometry in 20 MHz samples (the JAX defaults of
# sync_front_iq); every length scales with the oversample factor q.
N_PROD = 144    # STF lag products averaged for the coarse CFO
LAG = 16        # STF period
N_LAG = 176     # LTF correlation lags searched for the plateau
THRESH = 0.88   # plateau edge: fraction of the peak correlation
LTF_PERIOD = 64


@lru_cache(maxsize=None)
def _band_mat(n: int, w: int) -> np.ndarray:
    """Banded 0/1 matrix [n, n-w+1]: x @ B = moving sum of window w."""
    m = np.zeros((n, n - w + 1), dtype=np.float32)
    for i in range(n - w + 1):
        m[i:i + w, i] = 1.0
    return m


def ltf_band_mat(q: int) -> np.ndarray:
    """The banded matrix of `_ltf_sync_window`'s four moving sums."""
    return _band_mat((N_LAG + 2 * LTF_PERIOD) * q, LTF_PERIOD * q)


def batch_slice_iq_plain(x2: torch.Tensor, start: torch.Tensor,
                         length: int) -> torch.Tensor:
    """Plain per-row window slice: [B, N, 2] -> [B, length, 2], each start
    clipped to [0, N - length]."""
    b, n, _ = x2.shape
    s = start.long().clamp(0, n - length)
    idx = s[:, None] + torch.arange(length, device=x2.device)
    return x2[torch.arange(b, device=x2.device)[:, None], idx]


def batch_slice_iq(x2: torch.Tensor, start: torch.Tensor,
                   length: int) -> torch.Tensor:
    """Per-row window slice on float32 I/Q: [B, N, 2] -> [B, length, 2],
    starts clipped to [0, N - length]. A CPU tensor takes the plain version;
    any other launches the kernel, which raises on what it does not take."""
    if x2.device.type == "cpu":
        return batch_slice_iq_plain(x2, start, length)
    return batch_slice_iq_cuda(x2, start, length)


def cfo_ramp(cfo_rad: torch.Tensor, n: int) -> torch.Tensor:
    """exp(j * cfo * arange(n)) per row, [B] -> [B, n] complex64."""
    ph = cfo_rad[:, None] * torch.arange(n, dtype=torch.float32,
                                         device=cfo_rad.device)
    return torch.complex(torch.cos(ph), torch.sin(ph))


def _ltf_sync_window(y: torch.Tensor, t0: torch.Tensor,
                     cfo_rad: torch.Tensor, band: torch.Tensor, q: int):
    """LTF plateau timing + fine CFO on the pre-sliced window
    y = x[t0 + 80q :][:win].

    The 64q-lag correlation over the window is a trapezoid whose plateau is
    centred where the 128q-sample correlation window sits wholly inside the
    periodic LTF; the midpoint of the above-threshold lags locates the LTF.
    The fine CFO reuses the complex lag-64q moving sum at d_mid + 16q.
    band: `ltf_band_mat(q)` on y's device.
    Returns (ltf_data_start int32 [B], cfo_total [B], snr [B]).
    """
    p = LTF_PERIOD * q
    n_lag = N_LAG * q
    win = n_lag + 3 * p
    y = y * cfo_ramp(cfo_rad, win)
    prod = y[:, :-p] * torch.conj(y[:, p:])
    pwr = torch.abs(y) ** 2
    # the four real moving sums as ONE banded matmul, stacked on the batch
    b = y.shape[0]
    stacked = torch.cat([prod.real, prod.imag, pwr[:, :-p], pwr[:, p:]],
                        dim=0)
    ms = torch.matmul(stacked, band)
    num = torch.complex(ms[:b], ms[b:2 * b])
    p1 = ms[2 * b:3 * b]
    p2 = ms[3 * b:]
    ac = (torch.abs(num) / (torch.sqrt(p1 * p2) + 1e-12))[:, :n_lag]
    mx = ac.amax(dim=-1)
    mask = ac >= THRESH * mx[:, None]
    idx = torch.arange(n_lag, device=y.device)
    first = torch.where(mask, idx, n_lag).amin(dim=-1)
    last = torch.where(mask, idx, -1).amax(dim=-1)
    d_mid = (first + last) // 2
    # plateau centre d = 96q is the LTF data start at t0 + 80q + d + 16q;
    # bias 2q samples early (late errors cause ISI, early ones do not)
    ltf_start = (t0 + 80 * q + d_mid + 16 * q - 2 * q).to(torch.int32)
    acc = torch.gather(num, 1, (d_mid + 16 * q)[:, None])[:, 0]
    fine = torch.atan2(acc.imag, acc.real) / p
    snr = 10.0 * torch.log10(torch.clamp_min(
        mx / torch.clamp_min(1 - mx, 1e-6), 1e-6))
    return ltf_start, cfo_rad + fine, snr


def sync_front_iq(x2: torch.Tensor, t0: torch.Tensor, band: torch.Tensor,
                  q: int = 1):
    """Coarse STF CFO + LTF fine sync from ONE window slice of the raw
    [B, N, 2] float32 I/Q; t0 [B] int32 is the approximate STF start.
    q = oversample factor vs 20 MHz (1/2/4 for 20/40/80 MHz).
    Returns (ltf_data_start int32 [B], cfo_total_rad [B], snr_metric [B]).
    """
    n_prod, lag, n_lag = N_PROD * q, LAG * q, N_LAG * q
    win = n_lag + 3 * LTF_PERIOD * q
    w = r2c(batch_slice_iq(x2, t0, 80 * q + win))
    acc = torch.sum(w[:, :n_prod] * torch.conj(w[:, lag:lag + n_prod]),
                    dim=-1)
    cfo_c = torch.atan2(acc.imag, acc.real) / lag
    return _ltf_sync_window(w[:, 80 * q:], t0, cfo_c, band, q)
