"""Published peaks of one NVIDIA H100 (SXM5, 80 GB HBM3): NVIDIA's H100
Tensor Core GPU data sheet, dense rates.

  float32 outside the tensor cores  67 TFLOP/s, an FMA counted as two
                                    flops: 3.35e13 float32 lane operations
                                    per second
  HBM3 bandwidth                    3.35 TB/s

The rates assume the card's full power limit of 700 W. A card set below it
runs slower under load, so every roofline share is stated against these
published peaks with the card's power limit beside it (the run's stderr
and PERF.md give nvidia-smi's power.limit).
"""
FP32_LANE_OPS_PER_S = 67e12 / 2
HBM_BYTES_PER_S = 3.35e12
POWER_LIMIT_W = 700.0


def least_seconds(ops: float, bytes_moved: float) -> tuple:
    """(the least time for the work, which bound sets it: "ops" or
    "bytes")."""
    t_ops = ops / FP32_LANE_OPS_PER_S
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
