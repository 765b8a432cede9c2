"""MU-MIMO station-side processing: the NDP capture record.

Port of the `NdpCapture` dataclass of ieee80211_tpu/mu/sounding.py (:29),
with the same fields, so that the streaming receiver's NDP path
(rx/receiver.py `_extract_ndp`) returns the same record. The MU decoders
of that module are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class NdpCapture:
    ltf_iq: np.ndarray      # [nLtf * 64] complex time samples, CFO-corrected
    cfo_rad: float
    snr_db: float
