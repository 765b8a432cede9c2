"""Transmitters: the golden numpy model (oracle), copied from
ieee80211_tpu/tx, and the batched PyTorch TX (torch_tx.py, the counterpart
of ieee80211_tpu/tx/jax_tx.py)."""
from . import golden
from .golden import (TxResult, finalize, gen_ampdu, gen_ampdu_mu, gen_mpdu)
from .torch_tx import MuTxPipeline, TxPipeline, get_tx_pipeline

__all__ = ["MuTxPipeline", "TxPipeline", "TxResult", "finalize", "gen_ampdu",
           "gen_ampdu_mu", "gen_mpdu", "get_tx_pipeline", "golden"]
