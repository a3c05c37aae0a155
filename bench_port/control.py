#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, in one
process on the card: the program as configured (the lower reading, the
largest over the seeds) and its control, the program with its own int8 path
switched on, or with `--fault` a fault of `bench_port.faults.for_cell`
(those of any architecture, and the cell's architecture module's own)
planted underneath (the upper reading, the smallest over the seeds), each through
the same timed path and comparison as a run, with a short window.

    python3 bench_port/control.py --workload <cell> --seeds 11 12 13 \
        [--control-seeds 21 22 23] [--fault NAME ...] [--seconds 6] [--out FILE]

Each run prints one JSON line of its compared numbers; the last line holds
the largest program reading and the smallest control reading of each
number, and one line more for each fault. The benchmark's own runs never
run the control or a fault.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the package is imported as `bench_port` from the checkout's root; the
# script's own folder comes off the path, so that its modules shadow none
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path.pop(0)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(workload, seeds, seconds, control, out, run_cell, fault=None):
    from bench_port import faults, spec

    planted = faults.for_cell(spec.workload(workload))
    rows = []
    for seed in seeds:
        result, numbers = run_cell(workload, seed, seconds, False, control=control,
                                   fault=planted[fault] if fault else None)
        row = dict(workload=workload, seed=seed, control=control, fault=fault,
                   attempted=result["attempted"], correct=result["correct"], numbers=numbers)
        print(json.dumps(row), flush=True)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(row) + "\n")
        rows.append(row["numbers"])
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=None)
    ap.add_argument("--fault", nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from bench_port.run import few_threads, run_cell

    few_threads()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(1)

    sound = readings(args.workload, args.seeds, args.seconds, False, args.out, run_cell)
    ctrl_seeds = args.seeds if args.control_seeds is None else args.control_seeds
    ctrl = readings(args.workload, ctrl_seeds, args.seconds, True, args.out, run_cell) \
        if ctrl_seeds else []
    faulted = {f: readings(args.workload, ctrl_seeds or args.seeds, args.seconds, False,
                           args.out, run_cell, f) for f in args.fault}
    keys = sorted(set().union(*sound, *ctrl))
    summary = {k: dict(lower=max((r[k] for r in sound if k in r), default=None),
                       upper=min((r[k] for r in ctrl if k in r), default=None)) for k in keys}
    print(json.dumps(dict(workload=args.workload, readings=summary)), flush=True)
    for f, rows in faulted.items():
        print(json.dumps(dict(workload=args.workload, fault=f,
                              least={k: min(r[k] for r in rows) for k in keys})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
