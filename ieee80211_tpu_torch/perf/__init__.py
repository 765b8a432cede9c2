"""Measurement entry points of the port (run on a CUDA card unless the
CPU is asked for): the PDR-vs-SNR harnesses (pdr.py, acceptance.py), the
port's copy of bench.py (bench.py) and its profiling probes (stages.py,
floor.py, branch_floor.py), the sharded loops across cards (multicard.py,
scaling.py), timing helpers and the Viterbi floor probe."""
from .pdr import mimo_pdr_sweep, pdr_sweep

__all__ = ["pdr_sweep", "mimo_pdr_sweep"]
