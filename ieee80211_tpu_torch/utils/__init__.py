from .riq import c2r, r2c, r_of

__all__ = ["c2r", "r2c", "r_of"]
