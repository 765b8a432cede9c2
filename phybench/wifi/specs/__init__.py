"""Spec layer: standard-derived constant tables and static PPDU descriptors.

The benchmark's frozen copy of ieee80211_tpu_torch/specs/__init__.py:
the traffic generator builds its packets with it and imports
nothing of the program it measures.
"""
from . import crc, interleaver, tables
from .enums import BW, CR, F, GRF, M
from .modulation import (Mod, PpduParams, ppdu_params_aggregate,
                         ppdu_params_nonaggregate)

__all__ = [
    "BW", "CR", "F", "GRF", "M", "Mod", "PpduParams", "crc", "interleaver",
    "tables", "ppdu_params_aggregate", "ppdu_params_nonaggregate",
]
