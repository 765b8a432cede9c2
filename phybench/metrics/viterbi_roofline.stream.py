"""The Viterbi kernel's share of its roofline, in %: the least time the
traced calls' trellis work needs on an H100 (`work.py`'s count at
`peaks.py`'s published peaks, the larger of the ops and the bytes bound)
over the summed device time of every `viterbi_r4_kernel` launch in the
slice."""
from phybench.metrics import peaks, work


def read(ctx):
    t = ctx["trace"].kernel_s("viterbi_r4_kernel")
    steps = ctx["counts"].get("viterbi_steps")
    if not t or not steps:
        return None
    least, _ = peaks.least_seconds(work.ops(steps), work.bytes_moved(steps))
    return 100.0 * least / t
