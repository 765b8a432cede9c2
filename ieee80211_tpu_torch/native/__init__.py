"""The native host runtime: copy of ieee80211_tpu/native/__init__.py."""
from .lib import (available, crc32, deagg, find_triggers, pack_bits,
                  quantize_int8, scan_quantize)

__all__ = ["available", "crc32", "deagg", "find_triggers", "pack_bits"]
