"""MAC layer: frame build/parse, A-MPDU aggregation.

Copy of ieee80211_tpu/mac/__init__.py; the BF report codec is
mac/bf_report.py, which the package does not import here either.
"""
from .frames import (AmpduSubframe, MacConfig, ParsedMpdu, ParsedUdp,
                     aggregate_ht, aggregate_vht, build_bf_report_poll,
                     build_data_frame, build_ipv4, build_llc,
                     build_mgmt_action_no_ack, build_udp, build_udp_mpdu,
                     build_vht_ndp_announcement, deaggregate_ht,
                     deaggregate_vht, parse_mpdu, parse_udp_mpdu)
from .parse import (FrameControl, MgmtElement, ParsedFrame, build_beacon,
                    build_element, parse_frame, parse_mgmt_elements)

__all__ = [
    "AmpduSubframe", "MacConfig", "ParsedMpdu", "ParsedUdp", "aggregate_ht",
    "aggregate_vht", "build_bf_report_poll", "build_data_frame", "build_ipv4",
    "build_llc", "build_mgmt_action_no_ack", "build_udp", "build_udp_mpdu",
    "build_vht_ndp_announcement", "deaggregate_ht", "deaggregate_vht",
    "parse_mpdu", "parse_udp_mpdu",
    "FrameControl", "MgmtElement", "ParsedFrame", "build_beacon",
    "build_element", "parse_frame", "parse_mgmt_elements",
]
