"""Device-mesh parallelism on `torch.distributed`: batch DP, time-block halo
SP, plus multi-process launch scaffolding (one rank per device; NCCL on the
card, gloo on the CPU). Port of ieee80211_tpu/parallel/__init__.py."""
from .distributed import (init_distributed, make_global_phy_mesh,
                          process_summary)
from .mesh import make_phy_mesh
from .sharded import (multichip_step, sharded_capture_decode,
                      sharded_frontend, sharded_rx)

__all__ = ["init_distributed", "make_global_phy_mesh", "make_phy_mesh",
           "multichip_step", "process_summary", "sharded_capture_decode",
           "sharded_frontend", "sharded_rx"]
