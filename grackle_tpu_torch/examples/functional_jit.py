"""Functional-API example: the chemistry solve as a closure inside the
caller's time loop (port of examples/functional_jit.py).

The JAX example fuses the chemistry into the caller's ``jax.jit`` through
a ``lax.scan``; PyTorch runs eagerly, so here the scan is a Python loop
over the closures of ``grackle_tpu_torch.functional``: each step solves,
then computes the temperature of the new state, the caller-side work of
the scan body.  Evolves 64 constant-density cells for N_STEPS steps of
DT_MYR Myr and writes temperature/energy trajectories to
functional_jit.npz.

    python -m grackle_tpu_torch.examples.functional_jit
"""

import os

import numpy as np
import torch

from grackle_tpu_torch import chemistry_data, setup_fluid_container
import grackle_tpu_torch.functional as gfn
from grackle_tpu_torch.examples.common import get_data_file, get_device
from grackle_tpu_torch.utilities.physical_constants import (
    cm_per_mpc,
    mass_hydrogen_cgs,
    sec_per_Myr,
)


def run(n_steps=32, dt=1.0, device=None, cloudy_data=None,
        max_iterations=None):
    """The example's computation: {"temperature", "energy"} [n_steps, 64]
    after each step and "final_energy" [64]; each step is capped at
    ``max_iterations`` subcycles (None: the default 10,000), and "n_iterations"
    lists the subcycles each step ran."""
    my_chemistry = chemistry_data()
    my_chemistry.use_grackle = 1
    my_chemistry.with_radiative_cooling = 1
    my_chemistry.primordial_chemistry = 1
    my_chemistry.metal_cooling = 1
    my_chemistry.UVbackground = 0
    my_chemistry.density_units = mass_hydrogen_cgs
    my_chemistry.length_units = cm_per_mpc
    my_chemistry.time_units = sec_per_Myr
    if max_iterations is not None:
        my_chemistry.max_iterations = max_iterations
    my_chemistry.set_velocity_units()

    # setup_fluid_container initializes my_chemistry
    fc = setup_fluid_container(
        my_chemistry, density=0.1,
        temperature=np.logspace(4.5, 6.5, 64),
        converge=False, device=device or get_device(),
        cloudy_data=cloudy_data if cloudy_data is not None
        else get_data_file(),
    )
    f = {k: np.array(v) for k, v in fc.items()
         if k in fc.density_fields or k == "energy"}

    solve = gfn.make_solve_fn(my_chemistry)
    temperature = gfn.make_temperature_fn(my_chemistry)

    temps, energies, iters = [], [], []
    for _ in range(n_steps):
        f, diag = solve(f, dt)
        # caller-side work in the same loop body
        temps.append(temperature(f))
        energies.append(f["energy"])
        iters.append(int(diag["n_iterations"]))
    return {"temperature": torch.stack(temps).cpu().numpy(),
            "energy": torch.stack(energies).cpu().numpy(),
            "final_energy": f["energy"].cpu().numpy(),
            "n_iterations": iters}


def main():
    out = run(int(os.environ.get("N_STEPS", 32)),
              float(os.environ.get("DT_MYR", 1.0)))
    iters = out.pop("n_iterations")
    print(f"{len(iters)} steps x {out['temperature'].shape[1]} cells; "
          f"subcycles/step: min {min(iters)}, max {max(iters)}")
    np.savez("functional_jit.npz", **out)
    print("wrote functional_jit.npz")


if __name__ == "__main__":
    main()
