#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference put in the
program's place with one guarantee of the configuration broken.

    python3 tmbench/control.py --workload <cell> --seed <n> --seconds <s>

The configurations state that the ids are exactly the ungreedy
tokenizer's; the control takes the longest match at every step instead
(greedy, the shortcut that would tempt a faster tokenizer).  It runs the
cell as ``run.py`` does, then compares the same sample with what the
program produced (the lower reading), with what the control produces in
its place (the upper reading), and with the reference broken by each
fault a cell can have (half of a text left out, an answer altered),
which the numbers must catch too.  Prints one JSON line of them all.  The benchmark's own runs never run it."""

import json
import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def readings(cell, seed: int, seconds: float, device: str, reference,
             count=None, t_start: float = T_START) -> dict:
    """{"program": checks, stand-in: checks} of one run of ``cell``, for
    the control ("greedy") and each fault planted in the reference put in
    the program's place ("half" of a text left out, an answer
    "altered")."""
    from tmbench.harness import cells
    runner = cells.runner(cell.traffic["kind"])
    out = runner.run(cell, seed, seconds, False, device, t_start, reference)
    count = count or cell.traffic["check"]
    got = {"program": runner.check(out, seed, count, reference)}
    for how in runner.STAND_INS:
        got[how] = runner.check(out, seed, count, reference, stand_in=how)
    return got


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from tmbench.harness import cells
    from tmbench.reference.pool import Reference
    from tmbench.run import _paths
    _paths()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    with Reference() as reference:
        got = readings(cells.find(args.workload), args.seed, args.seconds,
                       "cuda", reference)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      **{side: {k: v for k, (v, _lim) in nums.items()}
                         for side, nums in got.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
