"""The Viterbi floor probe of the port (ieee80211_tpu_torch/perf/vit_floor.py,
kernel csrc/vit_floor.cu) against the TPU probe it replaces.

perf_vit_floor.py runs main() when imported and needs a TPU, so its
computation (:20-35) is restated here in numpy, in its own layout
[n_blk, 8, TB] -> [64, TB]: per block every metric takes
`m + sum(llr[t, :1]) * 1e-30 + 1.0` in float32, so every entry ends at
n_blk. The port's plain probe, in the port's packet-major layout
[B, n_blk, 8] -> [B, 64], must equal its transpose exactly. The kernel is
held to the plain probe on the card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

from ieee80211_tpu_torch.ops.cuda import vit_floor as kf
from ieee80211_tpu_torch.perf import vit_floor
import torch_parity  # noqa: F401  (caps torch's threads)


def _tpu_probe(x: np.ndarray) -> np.ndarray:
    """perf_vit_floor.py:20-35 in numpy: x [n_blk, 8, TB] float32."""
    n_blk, _, tb = x.shape
    m = np.zeros((64, tb), np.float32)
    for t in range(n_blk):
        m = m + np.sum(x[t, :1]) * 1e-30 + 1.0
    return m.astype(np.int32)


@pytest.mark.parametrize("b,n_blk,scale", [(8, 37, 1.0), (5, 64, 1.0),
                                           (3, 12, 1e6)])
def test_plain_probe_equals_tpu_probe(b, n_blk, scale):
    rng = np.random.default_rng(b * 100 + n_blk)
    x = (rng.standard_normal((b, n_blk, 8)) * scale).astype(np.float32)
    ref = _tpu_probe(np.ascontiguousarray(np.transpose(x, (1, 2, 0))))
    got = vit_floor.vit_floor_plain(torch.from_numpy(x))
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, 64)
    np.testing.assert_array_equal(got.numpy(), ref.T)
    assert bool((got == n_blk).all())


def test_probe_reads_the_viterbi_pair_layout():
    """The probe's [B, n_blk, 8] blocks are the Viterbi kernel's
    depunctured pairs [B, 4 n_blk, 2] of the same memory (radix 4)."""
    lp = torch.arange(2 * 12 * 2, dtype=torch.float32).reshape(2, 12, 2)
    blocks = lp.view(2, 12 // kf.K, 2 * kf.K)
    assert torch.equal(blocks[1, 2], lp[1, 8:12].reshape(-1))


def test_cpu_dispatch_takes_plain_and_kernel_rejects_cpu():
    before = kf.LAUNCHES
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 9, 8))
                         .astype(np.float32))
    assert torch.equal(vit_floor.vit_floor(x), vit_floor.vit_floor_plain(x))
    with pytest.raises(ValueError):
        kf.vit_floor_cuda(x)
    assert kf.LAUNCHES == before


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert vit_floor.main() == 1
