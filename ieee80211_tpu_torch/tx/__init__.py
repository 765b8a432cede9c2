"""The golden numpy transmitter (oracle), copied from ieee80211_tpu/tx."""
from . import golden
from .golden import (TxResult, finalize, gen_ampdu, gen_ampdu_mu, gen_mpdu)

__all__ = ["TxResult", "finalize", "gen_ampdu", "gen_ampdu_mu", "gen_mpdu",
           "golden"]
