"""MAC<->PHY control-plane API: packet descriptors and the PHY service
(the names of ieee80211_tpu/api/__init__.py)."""
from .descriptors import (BfqMessage, ChannelReport, DataRequest,
                          MuDataRequest, NdpRequest, RxRecord, pack_bfq,
                          pack_channel_report, pack_data, pack_mu_data,
                          pack_ndp, pack_rx_record, unpack_request,
                          unpack_rx_record)
from .service import PhyService

__all__ = ["BfqMessage", "ChannelReport", "DataRequest", "MuDataRequest",
           "NdpRequest", "RxRecord", "PhyService", "pack_bfq",
           "pack_channel_report", "pack_data", "pack_mu_data", "pack_ndp",
           "pack_rx_record", "unpack_request", "unpack_rx_record"]
