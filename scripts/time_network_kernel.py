#!/usr/bin/env python3
"""Device time of the network-region kernel at the flagship's launch widths.

Captures the network-region inputs of chip_smoke.py's flagship state (12
species, dust, metal cooling, CMB floor; 1,048,576 cells, seed 11, dt
1e-4) at subcycle 24, in f64 and f32, and times the bare kernel launch at
1,048,576, 262,144 and 81,920 cells (every cell, the compacted path's
warm tile, its batch) with chip_smoke.cuda_median_ms: CUDA events around
the launch after a 256 MB L2 flush, median of 20.  Beside each time: the
launch's bound (its bytes at 3.35 TB/s) and its share of it, and the host
time of one call of the wrapper the solver calls
(network_kernel.network_update_cuda: operand checks, output allocation,
launch; a host clock around the call on an idle device, median of 200).
Run from the repository root on a machine with a CUDA device:

    python3 scripts/time_network_kernel.py [--root DIR]

``--root`` times the grackle_tpu_torch package of another checkout (its
kernel source, wrapper and solver), still with this checkout's timing,
so that two commits' kernels can be held against each other in one call,
one process each.  Prints the card's name and power limit, the build's
ptxas report, each kernel's floating-point instructions in its sm_90a
code (a static count from ``cuobjdump -sass``: chip_smoke.OPS_PER_CELL),
and one JSON line per dtype and width.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP = 24
HOST_REPS = 200
#: the add, multiply, FMA and compare instructions of each float type
FLOAT_OPS = {"f64": ("DADD", "DMUL", "DFMA", "DSETP"),
             "f32": ("FADD", "FMUL", "FFMA", "FSETP")}


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
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    opt = ap.parse_args()
    root = os.path.abspath(opt.root)
    # grackle_tpu_torch from --root; the timing and the flagship recipe
    # from this checkout's chip_smoke.py
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "smoke_timing", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    if not torch.cuda.is_available():
        print("time_network_kernel: no CUDA device", file=sys.stderr)
        return 2
    from grackle_tpu_torch.api import _compact_batch
    from grackle_tpu_torch.ops import network_kernel as nk
    from grackle_tpu_torch.ops.solver import warm_tile_width

    if not os.path.abspath(nk.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {nk.__file__}, not from {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    nk.load()
    print("ptxas: " + " ".join(nk.build_log.split()), flush=True)
    sass = float_instructions(nk.library_path(), nk._nvcc())
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
            ms = cs.cuda_median_ms(launch)
            wrapper_ms = host_ms(lambda: nk.network_update_cuda(*args))
            bound = launch.bytes / cs.HBM_BYTES_PER_S * 1e3
            print(json.dumps({
                "root": os.path.relpath(root, REPO), "card": card,
                "precision": precision, "subcycle": STEP, "cells": n,
                "ms": ms, "bound_ms": bound, "share": bound / ms,
                "bytes": launch.bytes, "host_ms_per_call": wrapper_ms,
                "grid": getattr(launch, "grid", None),
                "ctas_per_sm": getattr(launch, "ctas_per_sm", None),
            }), flush=True)
        del cd, fields, inp
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
