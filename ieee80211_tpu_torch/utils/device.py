"""The device of the port's entry points: the card unless the caller asks
for the CPU."""
from __future__ import annotations

import torch


def entry_device(device=None) -> torch.device:
    """`device` as a torch.device; None means "cuda". A bare "cuda" gets the
    current card's index, so that one card gives one cache key. Asking for
    the card where there is none raises: the CPU runs only when it is asked
    for, with device="cpu"."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the entry points run on the card unless "
                "the CPU is asked for with device=\"cpu\"")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
