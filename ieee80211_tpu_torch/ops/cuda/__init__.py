"""Wrappers of the hand-written Hopper kernels (sources in ../../csrc/).

Each wrapper checks device, dtype, shape and contiguity, launches on
PyTorch's current stream, raises on a launch error and counts its launches
in a plain integer `LAUNCHES`. It takes CUDA tensors only: the dispatchers
in ops/coding.py and ops/sync.py route CPU tensors to the plain PyTorch
versions. The library is built with nvcc at the first launch, never at
import.
"""
