"""Golden transmitter (frozen copy of ieee80211_tpu_torch/tx/golden.py)."""
from .golden import gen_ampdu, gen_mpdu

__all__ = ["gen_ampdu", "gen_mpdu"]
