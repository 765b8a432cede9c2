"""Receivers: the batched SISO streaming receiver with automatic format
detection."""
from .receiver import (PacketResult, SisoDataDecoder, SisoReceiver,
                       assemble_packet, get_data_decoder, sig_parse)

__all__ = ["PacketResult", "SisoDataDecoder", "SisoReceiver",
           "assemble_packet", "get_data_decoder", "sig_parse"]
