#!/usr/bin/env python3
"""Device time of the port's hand-written CUDA kernels, each a bare launch.

Each kernel is timed as the ``launch()`` closure its wrapper prepares
(operands checked and outputs allocated beforehand) with
chip_smoke.cuda_median_ms: CUDA events around the launch after a 256 MB
L2 flush, median of 20.  Beside each time: the launch's bound, its bytes
(ops/kernel_lib.Library.bind: its per-cell and 0-d operands read once
and its results written once; no table) at HBM_BYTES_PER_S
(portbench/yardstick/peaks.py), and its share of the bound; and, apart,
the host time of one call of the wrapper the solver calls (operand
checks, output allocation, launch; a host clock around the call on an
idle device, median of 200).  The kernels:

- ``network``: the network-region inputs of chip_smoke.py's flagship
  state (12 species, dust, metal cooling, CMB floor; seed 11, dt 1e-4)
  at subcycle 24, f64 and f32, at 1,048,576, 262,144 and 81,920 cells
  (every cell, the compacted path's warm tile, its batch), with the
  launch's grid and CTAs per SM, and each kernel's floating-point
  instructions in its sm_90a code (a static count from ``cuobjdump
  -sass``: chip_smoke.OPS_PER_CELL);
- ``cloudy``: the tabulated mu fixed point (with the metal correction)
  and the new-style Cloudy cooling (metal table, CMB floor, heating,
  metallicity scaling), as the tabulated cell's subcycle body runs them,
  on chip_smoke.tabulated_state (density 0.1 to 100, T 10^4.5 to 10^7.5
  K) at z = 0, against their plain twins on the card, at 81,920 and
  1,048,576 cells, f64 and f32, on two sizes of the synthetic rank-3
  tables: the benchmark's 25 x 10 x 121 and HM2012's 29 x 26 x 161; with
  the cells the fixed point leaves at TI_MAX;
- ``dust``: the equilibrium dust temperature on the solve's arguments
  at the first subcycle (a cold start) and at subcycle 24 of the
  monolithic solve of the first state of the benchmark cell
  chem3_dust.grid1m's pool, at 4,096, 81,920 and 1,048,576 cells, f64
  and f32, against its twin captured into a CUDA graph and replayed (its
  nodes and the steps of its sweeps), and whether the kernel holds the
  twin's bits;
- ``rates``: the rate lookup with the H2-equilibrium limit on the solve's
  arguments at the first subcycle and at subcycle 24 of the monolithic
  solve of the first state of the pools of chem3_dust.grid1m (12
  species, dust, three_body_rate 0) and chem2_uvb_shield.grid1m_z3 (9
  species, the UVB at z = 3, self_shielding_method 3, H2_self_shielding
  3), at 4,096, 81,920 and 1,048,576 cells, f64 and f32, against its twin
  captured into a CUDA graph and replayed (its nodes), and whether the
  kernel holds the twin's bits.

Run from the repository root on a machine with a CUDA device:

    python3 scripts/time_kernels.py [--kernel network|cloudy|dust|rates
        ...]
        [--root DIR]

``--root`` times the grackle_tpu_torch package of another checkout (its
kernel sources, wrappers and solver), still with this checkout's timing
and states, so that two commits' kernels can be held against each other
in one call, one process each.  It holds for checkouts whose kernels all
prepare ``launch()`` closures on ops/kernel_lib.Library, this script's
own commit and later ones.  Prints the card's name and power limit, each
library's ptxas report and one JSON line per kernel, table size, dtype,
subcycle and width.
"""

from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_REPS = 200
#: the network kernel's subcycle
STEP = 24
#: the add, multiply, FMA and compare instructions of each float type
FLOAT_OPS = {"f64": ("DADD", "DMUL", "DFMA", "DSETP"),
             "f32": ("FADD", "FMUL", "FFMA", "FSETP")}
#: the Cloudy kernels' widths and the synthetic tables' axis sizes and
#: last redshift
CLOUDY_WIDTHS = (81_920, 1_048_576)
GRIDS = {"25x10x121": dict(n_density=25, n_redshift=10, n_temperature=121,
                           z_max=10.0),
         "29x26x161": dict(n_density=29, n_redshift=26, n_temperature=161,
                           z_max=15.0)}
DUST_WIDTHS = (4096, 81_920, 1_048_576)
#: the rate lookup's widths and subcycles
RATE_WIDTHS = (4096, 81_920, 1_048_576)
RATE_AT = (0, 24)


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


def float_instructions(lib_path, nvcc):
    """{dtype: {opcode: count}} over the SASS of each network kernel."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump") \
        if os.path.dirname(nvcc) else "cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts = {}
    for func in sass.split("Function : ")[1:]:
        name = func.split("\n", 1)[0]
        dtype = "f64" if "network_update_kernelId" in name else "f32"
        ops = re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", func)
        counts[dtype] = {op: ops.count(op) for op in FLOAT_OPS[dtype]}
    return counts


def ptxas(library):
    """Build and load ``library`` and print its ptxas report."""
    library.load()
    log = " ".join(library.build_log.split()) or "(cached build)"
    print(f"{library.what} ptxas: {log}", flush=True)


def time_network(cs, emit):
    from grackle_tpu_torch.api import _compact_batch
    from grackle_tpu_torch.ops import kernel_lib
    from grackle_tpu_torch.ops import network_kernel as nk
    from grackle_tpu_torch.ops.solver import warm_tile_width

    ptxas(nk.library)
    sass = float_instructions(nk.library.build(), kernel_lib.nvcc())
    print(json.dumps({"float_instructions": sass, "total": {
        k: sum(v.values()) for k, v in sass.items()}}), flush=True)
    batch = _compact_batch(cs.N_FLAGSHIP)
    widths = (cs.N_FLAGSHIP, min(warm_tile_width(batch), cs.N_FLAGSHIP),
              batch)
    for precision in (64, 32):
        cd = cs.flagship_chem(precision, "cuda")
        fields = cs.flagship_fields(cd, cs.N_FLAGSHIP)
        [(_, inp)] = cs.capture_network_inputs(cd, fields, cs.DT_FLAGSHIP,
                                               (STEP,))
        for n in widths:
            view = cs.head_inputs(inp, n)
            args = (cd.context.config, view["us"], view["dt"], view["f"],
                    view["rs"], view["cool_v"], view["carry_v"],
                    view["h2_limit"])
            launch, _ = nk.prepare_launch(*args)
            emit(launch, lambda: nk.network_update_cuda(*args),
                 kernel="network", precision=precision, subcycle=STEP,
                 cells=n, grid=launch.grid, ctas_per_sm=launch.ctas_per_sm)
        del cd, fields, inp


def time_cloudy(cs, emit):
    import torch

    from grackle_tpu_torch.api import call_scalars
    from grackle_tpu_torch.data.synthetic import synthetic_cloudy_groups
    from grackle_tpu_torch.ops import cloudy_cool, tabulated_temp
    from grackle_tpu_torch.ops import cloudy_kernel as ck
    from grackle_tpu_torch.ops.common import block_scalars

    ptxas(ck.library)
    width = max(CLOUDY_WIDTHS)
    for (grid, sizes), precision in itertools.product(GRIDS.items(),
                                                      (64, 32)):
        cd = cs.answer_chem("cuda", synthetic_cloudy_groups(**sizes),
                            primordial_chemistry=0, metal_cooling=1,
                            UVbackground=1, precision=precision)
        ctx = cd.context
        cfg = ctx.config
        dtype = ctx.cloudy_primordial.mmw.dtype
        us, _, _ = block_scalars(call_scalars(ctx, "cuda"))
        f = {k: torch.as_tensor(v, dtype=dtype, device="cuda")
             for k, v in cs.tabulated_state(cd, width).items()}
        rhoH = cfg.HydrogenFractionByMass * (f["density"] - f["metal"])
        fp_args = (ctx.cloudy_primordial, f["density"], f["metal"],
                   f["energy"], rhoH, us.dom, us.zr, cfg.TemperatureStart,
                   cfg.Gamma, us.utem, True)
        tgas, _ = ck.fixed_point_cuda(*fp_args)
        metallicity = (f["metal"] / f["density"]
                       / cfg.SolarMetalFractionByMass)
        cool_args = (ctx.cloudy_metal, torch.log(tgas), rhoH, metallicity,
                     us.dom, us.zr, us.comp2, 1, 1, 1)
        for n in CLOUDY_WIDTHS:
            def head(args):
                return [a[:n] if isinstance(a, torch.Tensor)
                        and a.shape == (width,) else a for a in args]

            stuck = cs.cells_at_ti_max(ck.fixed_point_cuda, head(fp_args),
                                       f["metal"][:n])
            runs = (("fixed_point", head(fp_args), ck.prepare_fixed_point,
                     ck.fixed_point_cuda,
                     tabulated_temp.tabulated_temperature),
                    ("cooling", head(cool_args), ck.prepare_cooling,
                     ck.cooling_cuda, cloudy_cool.cloudy_cooling))
            for name, args, prepare, wrapper, twin in runs:
                launch, _ = prepare(*args)
                emit(launch, lambda: wrapper(*args), kernel=name,
                     tables=grid, precision=precision, cells=n,
                     twin_ms=cs.cuda_median_ms(lambda: twin(*args)),
                     unconverged_cells=stuck)
        del cd, ctx, f


def time_dust(cs, emit):
    import torch

    from grackle_tpu_torch.ops import device_loop, dust_temp
    from grackle_tpu_torch.ops import dust_kernel as dk

    ptxas(dk.library)
    for precision in (64, 32):
        cd, state = cs.cell_chem(cs.DUST_CELL, precision, cs.DUST_SEED)
        captured = cs.capture_dust_inputs(cd, state, cs.DT_FLAGSHIP)
        for (step, args, init), n in itertools.product(captured,
                                                       DUST_WIDTHS):
            head = [a[:n] if isinstance(a, torch.Tensor) and a.dim() else a
                    for a in args]
            start = init[:n]
            newton, bisection = cs.dust_steps(head, start)

            def twin():
                return dust_temp.calc_tdust_1d(*head, tdust_init=start)

            twin()
            graph, twin_out, stats = cs.capture_graph(twin)
            launch, out = dk.prepare_launch(*head, tdust_init=start)
            launch()
            emit(launch,
                 lambda: dk.dust_temperature_cuda(*head, tdust_init=start),
                 kernel="dust", precision=precision, subcycle=step, cells=n,
                 twin_replay_ms=cs.cuda_median_ms(graph.replay),
                 twin_nodes=stats["nodes"], twin_newton_steps=newton,
                 twin_bisection_steps=bisection,
                 bit_identical=cs.same_bits(out, twin_out))
            del graph, twin_out
            device_loop.release_pools()
        del cd, state, captured


def time_rates(cs, emit):
    from grackle_tpu_torch.ops import device_loop
    from grackle_tpu_torch.ops import rates_kernel as rk

    ptxas(rk.library)
    for precision, (cell, seed) in itertools.product(
            (64, 32), ((cs.DUST_CELL, cs.DUST_SEED),
                       (cs.SHIELD_CELL, cs.SHIELD_SEED))):
        cd, state = cs.cell_chem(cell, precision, seed)
        captured = cs.capture_rate_inputs(cd, state, cs.DT_FLAGSHIP,
                                          RATE_AT)
        for (step, args), n in itertools.product(captured, RATE_WIDTHS):
            head = cs.head_rate_args(args, n)
            cfg = head[0]

            def twin():
                return rk.twin(*head)

            twin()
            graph, twin_out, stats = cs.capture_graph(twin)
            launch, _ = rk.prepare_launch(
                cfg, head[1], *rk.operands(cfg, *head[2:8]))
            got = rk.rate_lookup_cuda(*head)
            bad, _ = cs.cloudy_bit_differences(
                cs.rate_rows(cfg, got), cs.rate_rows(cfg, twin_out))
            emit(launch, lambda: rk.rate_lookup_cuda(*head),
                 kernel="rates", cell=cell, precision=precision,
                 subcycle=step, cells=n,
                 twin_replay_ms=cs.cuda_median_ms(graph.replay),
                 twin_nodes=stats["nodes"], bit_identical=bad == 0)
            del graph, twin_out, got
            device_loop.release_pools()
        del cd, state, captured


TIMERS = {"network": time_network, "cloudy": time_cloudy,
          "dust": time_dust, "rates": time_rates}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", nargs="+", choices=list(TIMERS),
                    default=list(TIMERS))
    ap.add_argument("--root", default=REPO)
    opt = ap.parse_args()
    root = os.path.abspath(opt.root)
    # grackle_tpu_torch from --root; the timing and the states from this
    # checkout's chip_smoke.py
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "smoke_timing", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    import grackle_tpu_torch
    from portbench.yardstick.peaks import HBM_BYTES_PER_S

    if not os.path.abspath(grackle_tpu_torch.__file__).startswith(
            root + os.sep):
        raise RuntimeError(f"imported {grackle_tpu_torch.__file__}, not "
                           f"from {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    def emit(launch, wrapper, **line):
        ms = cs.cuda_median_ms(launch)
        bound = launch.bytes / HBM_BYTES_PER_S * 1e3
        print(json.dumps({
            "root": os.path.relpath(root, REPO), "card": card, **line,
            "ms": ms, "bound_ms": bound, "share": bound / ms,
            "bytes": launch.bytes, "host_ms_per_call": host_ms(wrapper),
        }), flush=True)

    for name in opt.kernel:
        TIMERS[name](cs, emit)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
