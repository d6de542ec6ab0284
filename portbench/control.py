#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, on the card.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--precision 32]

For each seed: the cell's state pool from the seed, a window of
``seconds`` at the cell's own width and load, and the comparison of a
sample of its calls with the reference (portbench/harness/correct.py),
as a run makes them.  One program context serves every seed, so its
set-up is paid once.  ``--precision 32`` runs the program at the
configuration's next lower precision: the control, which has to read
above the limit.  Prints one JSON line a seed.  The benchmark's runs do
not run this.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import numpy as np  # noqa: E402

from portbench.harness import correct, run_cell, spec  # noqa: E402


def readings(cell, seeds, seconds, precision, device="cuda",
             traffic_overrides=None):
    """{seed: (max_rel_err, calls checked, where)} for the program at
    ``precision``."""
    traffic = run_cell._traffic(cell, traffic_overrides)
    groups = run_cell.make_groups(cell)
    program = run_cell.Program(cell, groups, device,
                               {"precision": precision})
    out = {}
    for seed in seeds:
        pool = run_cell.make_pool(cell, traffic, seed)
        run_cell.warm_up(program, pool, traffic)
        sample = correct.Sample(int(traffic["check"]["calls"]),
                                np.random.default_rng([seed, 1]))
        run_cell.window(program, pool, traffic, seconds, sample)
        checks, note = run_cell.check(cell, groups, sample, traffic, device)
        out[seed] = (checks["max_rel_err"][0], len(sample.kept), note)
    return out


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--precision", type=int, default=None)
    args = parser.parse_args(argv)
    cell = spec.cell(args.workload, ROOT)
    precision = args.precision or int(cell.config["parameters"]["precision"])
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed, (err, n, note) in readings(cell, seeds, args.seconds,
                                         precision).items():
        print(json.dumps({"workload": cell.name, "precision": precision,
                          "seed": seed, "max_rel_err": err,
                          "calls_checked": n, "note": note}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
