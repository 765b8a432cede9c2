"""Spec layer: standard-derived constant tables and static PPDU descriptors.

Copy of ieee80211_tpu/specs/__init__.py: the port imports nothing of the JAX
package, so it carries its own copy; tests/test_torch_specs.py holds it
equal to the original.
"""
from . import crc, interleaver, tables
from .enums import BW, CR, F, GRF, M
from .modulation import (Mod, PpduParams, ppdu_params_aggregate,
                         ppdu_params_aggregate_mu, ppdu_params_nonaggregate)

__all__ = [
    "BW", "CR", "F", "GRF", "M", "Mod", "PpduParams", "crc", "interleaver",
    "tables", "ppdu_params_aggregate", "ppdu_params_aggregate_mu",
    "ppdu_params_nonaggregate",
]
