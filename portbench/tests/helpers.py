"""Shared pieces of the benchmark's CPU tests: a cell run on the CPU at
a tiny width (the rehearsal path; it reads no device metric)."""

import time

from portbench.harness import run_cell, spec

#: the rehearsal's traffic, by cell: a few cells a call, a few calls
TINY = {"cells": 48, "pool": 2, "check": {"calls": 4, "rows": 4096}}
TINY_ONE = {"cells": 1, "pool": 6, "check": {"calls": 4, "rows": 4096}}


def tiny(cell):
    return TINY_ONE if cell.traffic["cells"] == 1 else TINY


def rehearse(name, seed=2**31 + 7, trace=False, cells=None, **kw):
    """A run of cell ``name`` on the CPU, at ``cells`` a call where given:
    (result, note)."""
    cell = spec.cell(name)
    traffic = dict(tiny(cell), **({"cells": cells, "pool": 1}
                                  if cells else {}))
    return run_cell.run(cell, seed, 0.3, trace, time.perf_counter(),
                        device="cpu", traffic_overrides=traffic, **kw)
