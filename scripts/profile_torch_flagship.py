#!/usr/bin/env python3
"""Where one flagship subcycle of grackle_tpu_torch spends its time on a
CUDA card.

Builds the flagship state of chip_smoke.py (12 species, dust, metal
cooling, CMB floor; 1,048,576 cells, seed 11, dt 1e-4), runs WARM
subcycles, then times the stages of the next STEPS subcycles with a
synchronise around each (cool1d_multi with its dust-temperature solve,
lookup_cool_rates, the H2-equilibrium limit, the network kernel), and
profiles the same STEPS subcycles with torch.profiler for device busy
time and the costliest device kernels.  Run from the repository root:

    python3 scripts/profile_torch_flagship.py [--precision 64|32]
        [--cells N] [--steps 8]

It needs a CUDA device and prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_flagship: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from grackle_tpu_torch.api import _prep_fields
    from grackle_tpu_torch.ops import chemistry_step, cooling, solver
    from grackle_tpu_torch.ops.common import (make_unit_scalars,
                                              photo_rates_from_tables)
    from grackle_tpu_torch.ops.network_kernel import network_update

    ap = argparse.ArgumentParser()
    ap.add_argument("--precision", type=int, default=64)
    ap.add_argument("--cells", type=int, default=cs.N_FLAGSHIP)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--warm", type=int, default=24)
    opt = ap.parse_args()

    cd = cs.flagship_chem(opt.precision, "cuda")
    ctx, cfg = cd.context, cd.context.config
    f, imetal = _prep_fields(ctx, cs.flagship_fields(cd, opt.cells))
    us = make_unit_scalars(cfg, ctx.tables, ctx.units)
    pr = photo_rates_from_tables(ctx.tables)
    f, itmask0 = solver.prepare_fields(cfg, f, us, imetal, False)
    f_state, f_const = solver.split_state(cfg, f)
    carry = solver.init_carry(f_state, itmask0, cfg)
    dt = cs.DT_FLAGSHIP
    tabs = (cfg, ctx.tables, ctx.cloudy_primordial, ctx.cloudy_metal, pr,
            us)

    def stages(carry, clock):
        """solver.subcycle, with a synchronised clock around each
        stage."""
        ff = dict(f_const)
        ff.update(carry["fields"])

        def timed(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            clock[name] = clock.get(name, 0.0) + time.perf_counter() - t0
            return out

        cool = timed("cool1d_multi", lambda: cooling.cool1d_multi(
            *tabs, ff, carry["tgasold"], carry["cell_it"] == 0, imetal,
            ctx.cloudy_data_new, tdust_prev=carry["tdust"]))
        rs = timed("lookup_cool_rates", lambda: chemistry_step
                   .lookup_cool_rates(cfg, ctx.tables, pr, us, ff, cool.tgas,
                                      cool.mmw, cool.tdust, cool.dust2gas,
                                      None, imetal))
        h2 = timed("h2_limit", lambda: solver._h2_equilibrium_limit(
            cfg, ctx.tables, rs, cool, ff, us, carry["itmask"]))
        cool_v = dict(edot=cool.edot, tgas=cool.tgas, p2d=cool.p2d,
                      rhoH=cool.rhoH, tgasold=cool.tgasold,
                      tdust=cool.tdust)
        carry_v = {k: v for k, v in carry.items() if k != "fields"}
        f_net = {k: ff[k] for k in solver.network_field_keys(cfg)}
        return timed("network kernel", lambda: network_update(
            cfg, us, dt, f_net, rs, cool_v, carry_v, h2))

    for _ in range(opt.warm):
        carry = solver.subcycle(*tabs, carry, dt, imetal,
                                ctx.cloudy_data_new, f_const)
    torch.cuda.synchronize()
    start = carry
    clock: dict = {}
    t0 = time.perf_counter()
    for _ in range(opt.steps):
        carry = stages(carry, clock)
    staged = time.perf_counter() - t0

    from torch.profiler import ProfilerActivity, profile

    carry = start
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(opt.steps):
            carry = solver.subcycle(*tabs, carry, dt, imetal,
                                    ctx.cloudy_data_new, f_const)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the device's own entries (kernels, copies, fills), not the host
    # operators that launched them
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "precision": opt.precision, "cells": opt.cells,
        "steps": opt.steps, "after_subcycles": opt.warm,
        "active_cells": int(start["itmask"].sum()),
        "staged_ms_per_subcycle": {k: 1e3 * v / opt.steps
                                   for k, v in clock.items()},
        "staged_total_ms_per_subcycle": 1e3 * staged / opt.steps,
        "profiled_wall_ms_per_subcycle": 1e3 * wall / opt.steps,
        "profiled_device_entries": len(events),
        "device_busy_ms_per_subcycle": busy_us / 1e3 / opt.steps,
        "device_idle_share": max(0.0, 1.0 - busy_us / 1e6 / wall),
        "device_launches_per_subcycle": sum(e.count for e in events)
        / opt.steps,
        "top_kernels_ms_per_subcycle": [
            [e.key[:80], e.self_device_time_total / 1e3 / opt.steps,
             e.count / opt.steps] for e in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
