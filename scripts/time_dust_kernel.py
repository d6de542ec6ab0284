#!/usr/bin/env python3
"""Device time of the dust temperature kernel against its twin.

Times csrc/dust_temp.cu's launch (ops/dust_kernel.dust_temperature_cuda)
against its plain twin (ops/dust_temp.calc_tdust_1d) captured into a CUDA
graph, as a subcycle body replays it (its Newton and bisection loops
conditional WHILE nodes of BLOCK masked steps), at 4,096, 81,920 and
1,048,576 cells, in f64 and f32: chip_smoke.cuda_median_ms, CUDA events
around the launch or the replay after a 256 MB L2 flush, median of 20.
The inputs are the dust solve's arguments at the first subcycle (a cold
start: every cell above T_SUBL, bisection from [T_CMB, T_gas]) and at
subcycle 24 (warm) of the monolithic solve of the first state of the
benchmark cell chem3_dust.grid1m's pool (chip_smoke.dust_cell_chem,
capture_dust_inputs).  Beside each time: the launch's bound (the bytes it
must move, five operands read once and the result written once, 48 B a
cell in f64, at 3.35 TB/s) and its share of it, the twin graph's nodes
(its own and its WHILE bodies'), the steps of the twin's sweeps, the
host time of one call of the wrapper (a host clock around the call on an
idle device, median of 200), and whether the kernel's result holds the
twin's bits.  Run from the repository root on a machine with a CUDA
device:

    python3 scripts/time_dust_kernel.py

Prints the card's name and power limit, the build's ptxas report and one
JSON line per dtype, subcycle and width.
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

WIDTHS = (4096, 81_920, 1_048_576)
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
        print("time_dust_kernel: no CUDA device", file=sys.stderr)
        return 2
    from grackle_tpu_torch.ops import device_loop, dust_temp
    from grackle_tpu_torch.ops import dust_kernel as dk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dk.library.load()
    log = " ".join(dk.library.build_log.split())
    print("ptxas: " + (log or "(cached build)"), flush=True)
    for precision in (64, 32):
        cd, state = cs.dust_cell_chem(precision)
        captured = cs.capture_dust_inputs(cd, state, cs.DT_FLAGSHIP)
        for (step, args, init), n in itertools.product(captured, WIDTHS):
            head = [a[:n] if isinstance(a, torch.Tensor) and a.dim() else a
                    for a in args]
            start = init[:n]
            steps = cs.dust_steps(head, start)

            def twin():
                return dust_temp.calc_tdust_1d(*head, tdust_init=start)

            twin()
            graph, twin_out, stats = cs.capture_graph(twin)
            kern = dk.dust_temperature_cuda(*head, tdust_init=start)
            same = cs.same_bits(kern, twin_out)
            ms = cs.cuda_median_ms(
                lambda: dk.dust_temperature_cuda(*head, tdust_init=start))
            twin_ms = cs.cuda_median_ms(graph.replay)
            wrapper_ms = host_ms(
                lambda: dk.dust_temperature_cuda(*head, tdust_init=start))
            moved = 6 * kern.element_size() * n
            bound = moved / cs.HBM_BYTES_PER_S * 1e3
            print(json.dumps({
                "card": card, "precision": precision, "subcycle": step,
                "cells": n, "ms": ms, "bound_ms": bound,
                "share": bound / ms, "bytes": moved,
                "twin_replay_ms": twin_ms, "twin_nodes": stats["nodes"],
                "twin_newton_steps": steps[0],
                "twin_bisection_steps": steps[1],
                "host_ms_per_call": wrapper_ms, "bit_identical": same,
            }), flush=True)
            del graph, twin_out
            device_loop.release_pools()
        del cd, state, captured
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
