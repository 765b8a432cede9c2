"""MU-MIMO sounding subsystem: NDP channel capture, compressed beamforming
feedback, ZF spatial mapping (the names of ieee80211_tpu/mu/__init__.py).
The station side, `sta_capture_ndp` and the MU decoders, is in
mu/sounding.py."""
from .feedback import (compress_v, map_q_to_grid, ndp_ltf_channel,
                       recover_v, vht_channel_feedback, zf_q)

__all__ = ["compress_v", "map_q_to_grid", "ndp_ltf_channel", "recover_v",
           "vht_channel_feedback", "zf_q"]
