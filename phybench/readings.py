"""The readings that the comparison's limits are set from, for one cell at
its own size, in one process:

    python3 phybench/readings.py --workload <cell> --seconds <s>
        --seeds <n,n,...> [--control-seeds <n,n,...>]

For each of --seeds, a whole run of the cell (set-up, a window of
--seconds, the reference, the comparison): the program's numbers, the lower
readings. For each of --control-seeds, the cell's inputs decoded by the
reference twice, in float64 and with its signal path in bfloat16, and the
bfloat16 outputs judged in the program's place: the control's numbers, the
upper readings. One JSON line per reading, then a summary line: per
number, the largest program reading and the smallest control reading.
Needs the card for the program's runs; the control runs on the host.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from phybench import harness, run  # noqa: E402


def control_numbers(name: str, seed: int, bench: dict) -> dict:
    """The control's numbers of cell `name` on the inputs of `seed`."""
    w = harness.workload(bench, name)
    cfg, trf = harness.config(w["config"]), harness.traffic(w["traffic"])
    cell = harness.entry(trf["kind"]).build(cfg, trf, seed, None)
    return cell.numbers(cell.reference(), kept=cell.as_kept(
        cell.reference("bf16")))


def _ints(s: str):
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    args = ap.parse_args(argv)
    bench = harness.benchmark()
    lower, upper = {}, {}
    if args.seeds:
        import torch
        if not torch.cuda.is_available():
            print("readings: the program's runs need a CUDA device",
                  file=sys.stderr)
            return 2
        dev = torch.device("cuda", 0)
    for seed in args.seeds:
        line, checks, _ = run.run_cell(args.workload, seed, args.seconds,
                                       False, dev, time.time(), bench)
        print(json.dumps({"kind": "program", "seed": seed,
                          "correct": line["correct"],
                          "checks": line["checks"],
                          "metrics": line["metrics"],
                          "device": line["device"]}), flush=True)
        for k, (v, _) in checks.items():
            lower[k] = max(lower.get(k, v), v)
    for seed in args.control_seeds:
        t = time.perf_counter()
        nums = control_numbers(args.workload, seed, bench)
        print(json.dumps({"kind": "control", "seed": seed, "numbers": nums,
                          "seconds": time.perf_counter() - t}), flush=True)
        for k, v in nums.items():
            upper[k] = min(upper.get(k, v), v)
    print(json.dumps({"kind": "summary", "workload": args.workload,
                      "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
