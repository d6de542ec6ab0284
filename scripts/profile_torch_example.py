#!/usr/bin/env python3
"""Where a port example's time goes: one example's ``run`` under cProfile.

The examples are loops of one-cell (or 101-cell) solves, so their time is
the host's work per subcycle, not the device's.  This prints the wall
seconds, the solve_chemistry calls, the subcycles (network launches) and
the ms of each per subcycle, then the functions with the most cumulative
time.  cProfile adds cost to every Python call, so its shares are
indicative; the wall without it is printed first.

    python3 scripts/profile_torch_example.py cooling_rate --arg 2 --device cpu
    python3 scripts/profile_torch_example.py freefall --arg 1   # on the card

``--arg`` is the example's first argument (cooling_rate's chemistry,
freefall's metal_cooling, cooling_cell's final time in Myr).
"""

from __future__ import annotations

import argparse
import cProfile
import contextlib
import importlib
import io
import os
import pstats
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, REPO)
    parser = argparse.ArgumentParser()
    parser.add_argument("example", choices=["cooling_rate", "cooling_cell",
                                            "freefall"])
    parser.add_argument("--arg", type=float, default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--top", type=int, default=25)
    args = parser.parse_args()

    import torch

    from grackle_tpu_torch import api
    from grackle_tpu_torch.data.synthetic import synthetic_cloudy_groups
    from grackle_tpu_torch.ops import solver

    torch.set_num_threads(1)
    example = importlib.import_module(
        f"grackle_tpu_torch.examples.{args.example}")
    first = [] if args.arg is None else [
        args.arg if args.example == "cooling_cell" else int(args.arg)]
    tables = synthetic_cloudy_groups()

    counts = {"solves": 0, "subcycles": 0}
    solve, subcycle = api.ChemistryData.solve_chemistry, solver.subcycle

    def counted_solve(cd, *a, **kw):
        counts["solves"] += 1
        return solve(cd, *a, **kw)

    def counted_subcycle(*a, **kw):
        counts["subcycles"] += 1
        return subcycle(*a, **kw)

    api.ChemistryData.solve_chemistry = counted_solve
    solver.subcycle = counted_subcycle

    def run():
        with contextlib.redirect_stderr(io.StringIO()):
            example.run(*first, device=args.device, cloudy_data=tables,
                        verbose=False)
        if args.device.startswith("cuda"):
            torch.cuda.synchronize()

    t0 = time.time()
    run()
    wall = time.time() - t0
    n_sub = counts["subcycles"]
    print(f"{args.example} {first} on {args.device}"
          + (f" ({torch.cuda.get_device_name(0)})"
             if args.device.startswith("cuda") else "")
          + f": {wall:.3f} s, {counts['solves']} solve calls "
          f"({wall / max(counts['solves'], 1):.4f} s a step), {n_sub} "
          f"subcycles, {1e3 * wall / max(n_sub, 1):.2f} ms a subcycle")

    counts.update(solves=0, subcycles=0)
    prof = cProfile.Profile()
    prof.enable()
    run()
    prof.disable()
    stats = pstats.Stats(prof)
    print(f"under cProfile: {stats.total_tt:.3f} s; per subcycle, "
          f"cumulative ms:")
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][3])
    for (path, line, name), (_, ncalls, _, cum, _) in rows[:args.top]:
        where = os.path.relpath(path, REPO) if path.startswith(REPO) \
            else os.path.basename(path)
        print(f"  {1e3 * cum / max(n_sub, 1):9.3f}  {ncalls:8d} calls  "
              f"{where}:{line}({name})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
