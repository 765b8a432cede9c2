from .metrics import DecodeStats, JsonlEmitter
from .riq import c2r, r2c, r_of

__all__ = ["DecodeStats", "JsonlEmitter", "c2r", "r2c", "r_of"]
