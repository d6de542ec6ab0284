#!/usr/bin/env python3
"""Device time of the Cloudy kernels against their twins.

Times csrc/cloudy_interp.cu's two launches, the tabulated mu fixed point
(ops/cloudy_kernel.fixed_point_cuda) and the new-style Cloudy cooling
(cooling_cuda), against their plain twins on the card
(ops/tabulated_temp.tabulated_temperature, ops/cloudy_cool.cloudy_cooling),
at 81,920 and 1,048,576 cells, in f64 and f32: chip_smoke.cuda_median_ms,
CUDA events around the call after a 256 MB L2 flush, median of 20.  The
state is chip_smoke.tabulated_state's (tabulated mode with metals:
density 0.1 to 100, T 10^4.5 to 10^7.5 K) at z = 0 on two sizes of the
synthetic rank-3 tables (data/synthetic.py): the benchmark's 25 x 10 x
121 and HM2012's axis sizes, 29 x 26 x 161 (log n_H -10 to 4, z 0 to 15,
log T 1 to 9); the fixed point runs with the metal correction,
the cooling on the metal table with the CMB floor, the heating and the
metallicity scaling, as the tabulated cell's subcycle body runs them.
Beside each time: the launch's bound (the bytes it must move, each
operand read once and each result written once, at 3.35 TB/s) and its
share of it, the host time of one call of the wrapper (a host clock
around the call on an idle device, median of 200), and the cells the
fixed point leaves unconverged at TI_MAX (chip_smoke.cells_at_ti_max:
every cell has metal).  Run from the repository root
on a machine with a CUDA device:

    python3 scripts/time_cloudy_kernel.py

Prints the card's name and power limit, the build's ptxas report and one
JSON line per table size, dtype, kernel and width.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

WIDTHS = (81_920, 1_048_576)
#: the synthetic tables' axis sizes and last redshift
GRIDS = {"25x10x121": dict(n_density=25, n_redshift=10, n_temperature=121,
                           z_max=10.0),
         "29x26x161": dict(n_density=29, n_redshift=26, n_temperature=161,
                           z_max=15.0)}
HOST_REPS = 200


def host_ms(fn, reps=HOST_REPS):
    """Median host ms of ``fn()``, each call made on an idle device."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e3


def main() -> int:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("time_cloudy_kernel: no CUDA device", file=sys.stderr)
        return 2
    from grackle_tpu_torch.api import call_scalars
    from grackle_tpu_torch.data.synthetic import synthetic_cloudy_groups
    from grackle_tpu_torch.ops import cloudy_cool, tabulated_temp
    from grackle_tpu_torch.ops import cloudy_kernel as ck
    from grackle_tpu_torch.ops.common import block_scalars

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    ck.library.load()
    log = " ".join(ck.library.build_log.split())
    print("ptxas: " + (log or "(cached build)"), flush=True)
    for (grid, sizes), precision in itertools.product(GRIDS.items(),
                                                      (64, 32)):
        cd = cs.answer_chem("cuda", synthetic_cloudy_groups(**sizes),
                            primordial_chemistry=0, metal_cooling=1,
                            UVbackground=1, precision=precision)
        ctx = cd.context
        cfg = ctx.config
        dtype = ctx.cloudy_primordial.mmw.dtype
        us, _, _ = block_scalars(call_scalars(ctx, "cuda"))
        state = cs.tabulated_state(cd, max(WIDTHS))
        f = {k: torch.as_tensor(v, dtype=dtype, device="cuda")
             for k, v in state.items()}
        rhoH = cfg.HydrogenFractionByMass * (f["density"] - f["metal"])
        fp_args = (ctx.cloudy_primordial, f["density"], f["metal"],
                   f["energy"], rhoH, us.dom, us.zr, cfg.TemperatureStart,
                   cfg.Gamma, us.utem, True)
        tgas, _ = ck.fixed_point_cuda(*fp_args)
        metallicity = (f["metal"] / f["density"]
                       / cfg.SolarMetalFractionByMass)
        cool_args = (ctx.cloudy_metal, torch.log(tgas), rhoH, metallicity,
                     us.dom, us.zr, us.comp2, 1, 1, 1)
        size = f["energy"].element_size()
        for n in WIDTHS:
            def head(args, k=len(fp_args)):
                return tuple(a[:n] if isinstance(a, torch.Tensor)
                             and a.dim() == 1 and a.shape[0] == max(WIDTHS)
                             else a for a in args[:k]) + args[k:]

            stuck = cs.cells_at_ti_max(ck.fixed_point_cuda, head(fp_args),
                                       f["metal"][:n])
            runs = (("fixed_point", head(fp_args, 5), ck.fixed_point_cuda,
                     tabulated_temp.tabulated_temperature, 6),
                    ("cooling", head(cool_args, 4), ck.cooling_cuda,
                     cloudy_cool.cloudy_cooling, 4))
            for name, args, kern, twin, operands in runs:
                ms = cs.cuda_median_ms(lambda: kern(*args))
                twin_ms = cs.cuda_median_ms(lambda: twin(*args))
                wrapper_ms = host_ms(lambda: kern(*args))
                moved = operands * size * n
                bound = moved / cs.HBM_BYTES_PER_S * 1e3
                print(json.dumps({
                    "card": card, "tables": grid, "precision": precision,
                    "kernel": name,
                    "cells": n, "ms": ms, "twin_ms": twin_ms,
                    "bound_ms": bound, "share": bound / ms, "bytes": moved,
                    "host_ms_per_call": wrapper_ms,
                    "unconverged_cells": stuck,
                }), flush=True)
        del cd, ctx, f, state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
