"""Receivers: the batched SISO streaming receiver with automatic format
detection, and the dual-chain receiver (2x2 SU-MIMO and MRC)."""
from .mimo import (MimoDataDecoder, MimoReceiver, MrcDataDecoder,
                   get_mimo_decoder, get_mrc_decoder)
from .receiver import (PacketResult, SisoDataDecoder, SisoReceiver,
                       assemble_packet, get_data_decoder, sig_parse)

__all__ = ["MimoDataDecoder", "MimoReceiver", "MrcDataDecoder",
           "PacketResult", "SisoDataDecoder", "SisoReceiver",
           "assemble_packet", "get_data_decoder", "get_mimo_decoder",
           "get_mrc_decoder", "sig_parse"]
