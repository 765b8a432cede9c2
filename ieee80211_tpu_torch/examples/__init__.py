"""Command-line examples of the port, run as modules:

    python -m ieee80211_tpu_torch.examples.gen_test_captures OUTDIR
    python -m ieee80211_tpu_torch.examples.inspect_bin FILE [FS_HZ]
    python -m ieee80211_tpu_torch.examples.stream_decode [--dual]
    python -m ieee80211_tpu_torch.examples.mu_sounding_demo

Ports of examples/*.py. Those that decode run on the card unless
`--device cpu` (or `device="cpu"` to `main`) asks for the CPU.
"""
