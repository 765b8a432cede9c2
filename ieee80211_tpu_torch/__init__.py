"""ieee80211_tpu_torch — the PyTorch + CUDA port of ieee80211_tpu.

The JAX package `ieee80211_tpu` stays the reference that this port is held
against. This package mirrors its layout so that each module's counterpart
is easy to find:

  * utils/     real <-> complex boundary helpers (riq.py)
  * ops/       batched PHY ops: coding, sync, demod (plain PyTorch)
  * ops/cuda/  wrappers of the hand-written Hopper kernels (where the JAX
               package has ops/pallas/)
  * csrc/      the kernels' CUDA C++ sources, built with nvcc at first use
  * models/    the flagship fixed-config receiver (`RxPipeline`)
  * rx/        the streaming receivers (`SisoReceiver`, `MimoReceiver`)
  * perf/      timing helpers and the Viterbi floor probe

It imports nothing of the JAX package and never imports jax: the machine
with the GPU has none. It carries its own copies of the JAX package's
jax-free modules instead, each held equal to its original by a test:

  * specs/     tables, enums, PPDU descriptors, interleavers, CRCs
  * mac/       MAC frame build/parse and A-MPDU (de)aggregation
  * native/    the C++ host runtime, built with g++ into _build/ at first use
  * tx/        the golden numpy transmitter (golden.py), the oracle

Its entry points (`RxPipeline`, `SisoReceiver`, `MimoReceiver` and the
decoder getters) run on the card unless the caller asks for the CPU with
device="cpu".
"""
import torch

# The DFT and banded moving-sum matmuls feed the plateau sync and the LLRs:
# float32 products stay in full float32 on the card (TF32 keeps about three
# decimal digits).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
