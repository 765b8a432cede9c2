"""Real <-> complex boundary helpers.

The public receive step takes float32 I/Q with a trailing axis of size 2,
the layout of the JAX package's jit boundary (ieee80211_tpu/utils/riq.py),
so that both packages share test inputs. Inside, the math runs on
complex64 views of that memory.
"""
from __future__ import annotations

import numpy as np
import torch


def c2r(x) -> np.ndarray:
    """Host-side: complex array -> float32 [..., 2]."""
    x = np.asarray(x)
    return np.stack([np.real(x), np.imag(x)], axis=-1).astype(np.float32)


def r2c(x2: torch.Tensor) -> torch.Tensor:
    """float32 [..., 2] -> complex64 [...] (a view of contiguous input)."""
    return torch.view_as_complex(x2.contiguous())


def r_of(x: torch.Tensor) -> torch.Tensor:
    """complex [...] -> float [..., 2] (a view)."""
    return torch.view_as_real(x)
