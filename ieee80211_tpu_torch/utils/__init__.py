from .binio import load_complex_bin, save_complex_bin
from .metrics import SPANS, DecodeStats
from .riq import c2r, r2c, r_of

__all__ = ["DecodeStats", "SPANS", "c2r", "load_complex_bin", "r2c", "r_of",
           "save_complex_bin"]
