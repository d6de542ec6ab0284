#!/usr/bin/env python3
"""Run one cell of the benchmark of grackle_tpu_torch once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout holding BENCHMARK.json, portbench/ and
grackle_tpu_torch/.  Prints the result as one JSON object, the last line
of standard output; the numbers compared against the reference, each
beside its limit, are the last lines of standard error.  Exits 2,
printing no result, without a CUDA device for the cell, or where a JAX
module or the JAX package is loaded once the window has closed.
"""

import json
import os
import sys

# the checkout's root, not portbench/, heads the import path
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from portbench.harness import run_cell, spec  # noqa: E402

T_START = run_cell.process_start()


def _args(argv):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    cell = spec.cell(args.workload, ROOT)
    # a library that would load JAX by itself is kept from it
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f": nothing measured", file=sys.stderr)
        return 2
    result, note = run_cell.run(cell, args.seed, args.seconds,
                                bool(args.trace), T_START, device="cuda")
    found = run_cell.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}: no result",
              file=sys.stderr)
        return 2
    print(f"portbench: {note}", file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"{name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
