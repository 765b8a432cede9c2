"""Per-layer metric readers (one file per metric, named as in
BENCHMARK.json) and the yardstick they share: the H100's published peaks
(`peaks.py`) and the trellis work of a decode (`work.py`)."""
