"""Batched PHY ops in PyTorch (counterparts of ieee80211_tpu/ops/)."""
