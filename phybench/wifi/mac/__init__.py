"""MAC frame builders (frozen copy of ieee80211_tpu_torch/mac/frames.py)."""
from .frames import (AmpduSubframe, MacConfig, aggregate_vht, build_udp_mpdu,
                     deaggregate_ht, deaggregate_vht)

__all__ = ["AmpduSubframe", "MacConfig", "aggregate_vht", "build_udp_mpdu",
           "deaggregate_ht", "deaggregate_vht"]
