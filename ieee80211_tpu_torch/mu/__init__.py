"""MU-MIMO station side. Only the NDP capture record is ported so far."""
from .sounding import NdpCapture

__all__ = ["NdpCapture"]
