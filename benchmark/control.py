#!/usr/bin/env python3
"""The readings the limits of ``benchmark/limits/<cell>.json`` are set
from, on the chip at the cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 2] [--out FILE]

For every seed, in one process: the program as a run drives it (set-up,
a short window at the cell's own load, what the check needs after it),
then every number its check compares (``compare``), then the same with
the control in the program's place: the reference in TF32 (float32
products with TF32 on, the nearest precision below the configuration's
float32).  For a training cell also the faults planted in the reference
put in the program's place: half of each batch left out (each step on
the first half, the mean over it), in both stages, and in the replay
stage inputs that were not copied in (each step on the batch before its
own).  One JSON line a seed and side, each with ``correct``: whether its
numbers keep to the limits, by the rule of a run's check.  The
benchmark's own runs never run this.
"""
import json
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from benchmark.entries import common  # noqa: E402
from benchmark.entries.train import readings_gaps  # noqa: E402
from benchmark.harness.main import (  # noqa: E402
    entry_class, load_cell, require_cards, run_window)


def train_faults(cell) -> dict:
    """Each planted fault's numbers, by side."""
    start, stage = cell.reference_readings(), cell.reference_stage()

    def gaps(prog, ref, prefix=""):
        return {prefix + k: v for k, (v, _) in readings_gaps(prog, ref)
                .items()}

    return {
        "fault_half_batch": dict(
            gaps(cell.reference_readings(half=True), start),
            **gaps(cell.reference_stage(half=True), stage, "replay.")),
        "fault_stale_input": gaps(cell.reference_stage(stale=True), stage,
                                  "replay.")}


def keeps(numbers: dict, limits: dict) -> bool:
    return all(math.isfinite(numbers.get(k, math.inf))
               and numbers.get(k, math.inf) <= lim
               for k, lim in limits.items())


def main(argv) -> int:
    import argparse

    p = argparse.ArgumentParser("benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    spec = load_cell(args.workload)
    why = require_cards(spec["chips"])
    if why:
        print(why, file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.monotonic()
        cell = entry_class(spec["traffic"])(dict(spec), seed,
                                             torch.device("cuda", 0))
        cell.setup()
        run_window(cell, args.seconds)
        cell.after_window()
        cell.release()
        sides = {"program": cell.compare()}
        cell.spec["control"] = "tf32"
        sides["control_tf32"] = cell.compare()
        if spec["traffic"]["entry"] == "train":
            sides.update(train_faults(cell))
        for side, numbers in sides.items():
            line = dict(side=side, correct=keeps(numbers, spec["limits"]),
                        **numbers, cell=spec["name"], seed=seed,
                        seconds=round(time.monotonic() - t0, 3))
            text = json.dumps(line)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
        del cell
        common.free()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
