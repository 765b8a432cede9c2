"""Batched synchronization ops (PyTorch): window slice, STF coarse CFO, LTF
plateau timing and fine CFO, CFO correction, and the STF trigger scan of a
whole capture (on the host and on the device).

Port of ieee80211_tpu/ops/sync.py (`_movsum` :37, `stf_autocorr` :60,
`batch_slice_iq` :89, `sync_front_iq` :109, `_ltf_sync_window` :132,
`cfo_ramp` :216, `apply_cfo_correction` :231, `_movsum_i32` :243,
`trigger_scan_capture` :259, `find_triggers_np` :301). `coarse_cfo`,
`sync_front` and `ltf_sync` have no callers there and are not ported. The
window slice runs in the hand-written kernel (ops/cuda/gather.py,
csrc/gather.cu) on a CUDA tensor and in the plain version below on a CPU
tensor.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

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


def ltf_sync_products(y: torch.Tensor, cfo_rad: torch.Tensor,
                      q: int) -> torch.Tensor:
    """The four real sequences whose moving sums of 64q `_ltf_sync_window`
    takes, stacked on the batch: Re and Im of the lag-64q products, then
    the power at both ends of the lag, of the CFO-corrected window
    y [B, (N_LAG + 3 * 64) q] -> [4B, (N_LAG + 2 * 64) q] float32."""
    p = LTF_PERIOD * q
    y = y * cfo_ramp(cfo_rad, N_LAG * q + 3 * p)
    prod = y[:, :-p] * torch.conj(y[:, p:])
    pwr = torch.abs(y) ** 2
    return torch.cat([prod.real, prod.imag, pwr[:, :-p], pwr[:, p:]], dim=0)


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
    p, n_lag = LTF_PERIOD * q, N_LAG * q
    # the four real moving sums as ONE banded matmul, stacked on the batch
    b = y.shape[0]
    ms = torch.matmul(ltf_sync_products(y, cfo_rad, q), band)
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
    y, cfo_c = stf_coarse(x2, t0, q)
    return _ltf_sync_window(y, t0, cfo_c, band, q)


def stf_coarse(x2: torch.Tensor, t0: torch.Tensor, q: int = 1):
    """The first half of `sync_front_iq`: one window slice of the raw
    [B, N, 2] I/Q from t0, and the coarse CFO of its STF. Returns (the
    window past the STF [B, (N_LAG + 3 * 64) q] complex64, coarse CFO [B]
    rad/sample)."""
    n_prod, lag, n_lag = N_PROD * q, LAG * q, N_LAG * q
    win = n_lag + 3 * LTF_PERIOD * q
    w = r2c(batch_slice_iq(x2, t0, 80 * q + win))
    acc = torch.sum(w[:, :n_prod] * torch.conj(w[:, lag:lag + n_prod]),
                    dim=-1)
    return w[:, 80 * q:], torch.atan2(acc.imag, acc.real) / lag


def apply_cfo_correction(x: torch.Tensor, cfo_rad: torch.Tensor
                         ) -> torch.Tensor:
    """Multiply [B, N] by exp(j * cfo_rad * n) (compensation ramp)."""
    return x * cfo_ramp(cfo_rad, x.shape[-1])


# ---------------------------------------------------------------------------
# STF trigger scan of a whole capture
# ---------------------------------------------------------------------------


def _movsum(x: torch.Tensor, w: int) -> torch.Tensor:
    """Moving sum of window w over the trailing axis, length N - w + 1.

    As in the JAX package: a banded 0/1 matmul for N <= 2048 (the band is
    built on x's device), a cumsum difference above (the whole-capture
    trigger scan). The cumsum accumulates in float64 on every device: a
    float32 prefix sum over a 4M-sample capture is too coarse for 16-sample
    windows, and PyTorch's CUDA cumsum accumulates float32 in float32
    (its CPU cumsum in double). Complex inputs sum their real and imaginary
    parts apart.
    """
    if x.is_complex():
        return torch.complex(_movsum(x.real, w), _movsum(x.imag, w))
    n = x.shape[-1]
    if n <= 2048:
        i = torch.arange(n, device=x.device)[:, None]
        j = torch.arange(n - w + 1, device=x.device)[None, :]
        band = ((i >= j) & (i < j + w)).to(x.dtype)
        return torch.matmul(x, band)
    c = F.pad(torch.cumsum(x, dim=-1, dtype=torch.float64), (1, 0))
    return (c[..., w:] - c[..., :-w]).to(x.dtype)


def stf_autocorr(x: torch.Tensor, lag: int = 16, win: int = 16
                 ) -> torch.Tensor:
    """Normalized lag-`lag` auto-correlation magnitude of [..., N] complex:
    [..., N - lag - win + 1] in [0, 1]."""
    prod = x[..., :-lag] * torch.conj(x[..., lag:])
    pwr = torch.abs(x) ** 2
    num = torch.abs(_movsum(prod, win))
    p1 = _movsum(pwr[..., :-lag], win)
    p2 = _movsum(pwr[..., lag:], win)
    den = torch.sqrt(p1 * p2) + 1e-12
    return num / den


def _movsum_i32(x: torch.Tensor, w: int) -> torch.Tensor:
    """Exact integer moving sum of a 1-D 0/1 tensor (int32 cumsum
    difference): length N - w + 1."""
    c = F.pad(torch.cumsum(x.to(torch.int32), dim=0, dtype=torch.int32),
              (1, 0))
    return c[w:] - c[:-w]


def trigger_scan_capture(cap: torch.Tensor, k_max: int = 4096, q: int = 1,
                         thresh: float = 0.5, plateau: int = 20,
                         min_gap: int = 400):
    """STF trigger scan of a whole capture on its device, with no host sync.

    cap: [Npad, 2] float32 I/Q (the receiver's dequantized upload; the JAX
    function takes the int8 upload and its scale and dequantizes the same
    way). Returns (t0s [k_max] int32 ascending, Npad in empty slots, and
    n_trig [] int32, which may exceed k_max when the capacity was hit).

    The plateau / rising-edge / windowed min_gap semantics of the JAX
    function. Its `jnp.nonzero(size=k_max, fill_value=Npad)` becomes a
    binary search of the running count of kept rises: slot j holds the
    first position where that count reaches j + 1.
    """
    x = r2c(cap)
    n = x.shape[0]
    lag = 16 * q
    plateau, min_gap = plateau * q, min_gap * q
    ac = stf_autocorr(x[None], lag=lag, win=lag)[0]
    above = ac > thresh
    runp = _movsum_i32(above, plateau) == plateau
    prev = torch.cat([above.new_zeros(1), above[:-1]])[:runp.shape[0]]
    rise = runp & ~prev
    prior = _movsum_i32(torch.cat([rise.new_zeros(min_gap), rise]), min_gap)
    keep = rise & (prior[:rise.shape[0]] == 0)
    count = torch.cumsum(keep.to(torch.int32), dim=0, dtype=torch.int32)
    want = torch.arange(1, k_max + 1, dtype=torch.int32, device=cap.device)
    pos = torch.searchsorted(count, want).to(torch.int32)
    n_trig = count[-1]
    return torch.where(want <= n_trig, pos, n), n_trig


def find_triggers_np(x: np.ndarray, thresh: float = 0.5, plateau: int = 20,
                     min_gap: int = 400, q: int = 1) -> np.ndarray:
    """STF trigger positions of a 1-D complex capture, on the host: where
    the 16q-lag auto-correlation stays above `thresh` for `plateau`
    consecutive samples (20 MHz units, scaled by q), at least min_gap
    apart. Uses the native host runtime (the port's copy,
    ieee80211_tpu_torch.native) when it is available, as the JAX function
    does; a numpy scan otherwise."""
    from ..native import find_triggers as _native_triggers
    x = np.asarray(x)
    plateau, min_gap = plateau * q, min_gap * q
    nt = _native_triggers(x, thresh=thresh, plateau=plateau,
                          min_gap=min_gap, lag=16 * q)
    if nt is not None:
        return nt
    lag = 16 * q
    prod = x[:-lag] * np.conj(x[lag:])
    pwr = np.abs(x) ** 2
    kern = np.ones(lag)
    num = np.abs(np.convolve(prod, kern, mode="valid"))
    p1 = np.convolve(pwr[:-lag], kern, mode="valid")
    p2 = np.convolve(pwr[lag:], kern, mode="valid")
    ac = num / (np.sqrt(p1 * p2) + 1e-12)
    cnt = 0
    starts = []
    last = -min_gap
    for i, a in enumerate(ac > thresh):
        cnt = cnt + 1 if a else 0
        if cnt == plateau:
            s = i - plateau + 1
            if s - last >= min_gap:
                starts.append(s)
                last = s
    return np.asarray(starts, dtype=np.int64)
