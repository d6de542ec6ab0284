#!/usr/bin/env python3
"""How far an ulp moves examples/functional_jit.py's stored answer.

The example (6 species with metal cooling, 64 cells at 0.1 cm^-3 from
10^4.5 to 10^6.5 K, steps of 1 Myr) cools every cell to the CMB
temperature within its first step, where no cell settles: each runs into
the 10,000-subcycle cap.  This script runs one step of the example's
closures on the CPU and prints, as one JSON line each:

* the JAX package against itself, with the input energy moved by a
  relative 1e-15 and 1e-13: the largest relative change of the energy,
  the electron density and HI after the step;
* the port (grackle_tpu_torch, on the CPU) against the JAX package, with
  the step capped at 300 subcycles (where both still agree to f64
  rounding), at 1,000, and uncapped;
* the range of the temperatures of the stored answer's first step.

With ``--card`` it imports no JAX and runs one uncapped step of the
port on the CUDA device instead: its wall seconds and seconds a
subcycle, and its temperatures' range beside the stored first step's.

Run from the repository root (about a minute on one CPU core, most of it
the port's uncapped step; about a minute and a half with ``--card``):

    JAX_PLATFORMS=cpu python3 scripts/functional_jit_sensitivity.py
    python3 scripts/functional_jit_sensitivity.py --card
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_state(max_iterations=None):
    import grackle_tpu
    from tests.answer_workloads import _data_file

    import chip_smoke

    cd = chip_smoke.functional_jit_chem(grackle_tpu, max_iterations)
    cd.grackle_data_file = _data_file()
    cd.initialize()
    fc = grackle_tpu.setup_fluid_container(
        cd, density=0.1, temperature=np.logspace(4.5, 6.5, 64),
        converge=False)
    fields = {k: np.array(v) for k, v in fc.items()
              if k in fc.density_fields or k == "energy"}
    return cd, fields


def _step(solve, fields):
    import chip_smoke

    out, _ = solve(fields, chip_smoke.FUNCTIONAL_JIT_DT)
    return {k: np.asarray(out[k]) for k in ("energy", "de", "HI")}


def _max_rel(got, want):
    return {k: float(np.max(np.abs(got[k] - want[k]) / np.abs(want[k])))
            for k in want}


def _stored_first_step():
    stored = np.load(os.path.join(REPO, "tests", "answers", "examples",
                                  "functional_jit.npz"))["temperature"][0]
    return [float(stored.min()), float(stored.max())]


def card_step() -> int:
    """One uncapped step of the port's example on the CUDA device."""
    import torch

    import chip_smoke
    from grackle_tpu_torch.ops.network_kernel import library

    if not torch.cuda.is_available():
        print("functional_jit_sensitivity: --card needs a CUDA device",
              file=sys.stderr)
        return 2
    library.zero()
    t0 = time.time()
    out = chip_smoke.functional_jit_answer("cuda", max_iterations=None)
    wall = time.time() - t0
    subcycles = library.executed()
    temperature = out["temperature"][0]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "wall_s": wall,
        "subcycles": subcycles, "s_per_subcycle": wall / subcycles,
        "temperature_K": [float(temperature.min()),
                          float(temperature.max())],
        "stored_first_step_temperature_K": _stored_first_step()}))
    return 0


def main() -> int:
    sys.path.insert(0, REPO)
    if "--card" in sys.argv[1:]:
        return card_step()
    import torch

    import grackle_tpu.functional as jfn
    import grackle_tpu_torch
    import grackle_tpu_torch.functional as gfn
    from grackle_tpu_torch.data.synthetic import synthetic_cloudy_groups

    import chip_smoke

    torch.set_num_threads(1)
    cd, fields = _jax_state()
    solve = jfn.make_solve_fn(cd)
    base = _step(solve, fields)
    for eps in (1e-15, 1e-13):
        moved = dict(fields, energy=fields["energy"] * (1.0 + eps))
        print(json.dumps({"jax_vs_jax_input_moved_by": eps,
                          "max_rel": _max_rel(_step(solve, moved), base)}),
              flush=True)

    for cap in (300, 1000, None):
        jcd, jfields = _jax_state(cap)
        want = _step(jfn.make_solve_fn(jcd), jfields)
        pcd = chip_smoke.functional_jit_chem(grackle_tpu_torch, cap)
        fc = grackle_tpu_torch.setup_fluid_container(
            pcd, density=0.1, temperature=np.logspace(4.5, 6.5, 64),
            converge=False, device="cpu",
            cloudy_data=synthetic_cloudy_groups())
        pfields = {k: np.array(v) for k, v in fc.items()
                   if k in fc.density_fields or k == "energy"}
        got = _step(gfn.make_solve_fn(pcd), pfields)
        print(json.dumps({"port_vs_jax_subcycle_cap": cap or 10000,
                          "max_rel": _max_rel(got, want)}), flush=True)

    print(json.dumps({"stored_first_step_temperature_K":
                      _stored_first_step()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
