"""States of gas cells with log-uniform density and temperature.

The general generator of the benchmark's traffic: a traffic file names
it as ``"recipe": "log_uniform"`` and gives its parameters:

- ``cells``: cells a state (a call's width); ``pool``: states drawn;
- ``log_density``, ``log_temperature``: [low, high] of log10 density (code
  units) and log10 temperature (K); equal ends fix the value;
- ``metal_fraction``: the metal field over the density;
- ``species``: each species field as ``{"of_density": x}`` (x times the
  density) or ``{"value": x}``; the electron density ``de`` is
  HII + HeII / 4 + HeIII / 2 wherever HII is given;
- ``mu``: the mean molecular weight the energy is set with,
  ``T / temperature_units / mu / (Gamma - 1)``.

chip_smoke.flagship_fields (chemistry 3, mu 1: its FluidContainer holds
a dust field of zeros, so calculate_mean_molecular_weight keeps mu = 1)
and bench.py's chem-0 recipe (mu 0.6) are two sets of these parameters.

The values are stratified: each state's cells (or, for one-cell
states, the pool's states) take one value from each of N equal strata
of each range, at offsets and in a pairing of densities with
temperatures drawn from the traffic's ``design_seed``.  The run's seed
orders them: the cells within each state and the states within the
pool.  So every seed sends the same cells, in another order, and a
call's work does not change from seed to seed (a call runs as many
subcycles as its slowest cell, so a state drawn anew for each seed
moved a 4,096-cell call's time by 1.4%, PERF.md).
"""

from __future__ import annotations

import numpy as np


def _stratified(rng, lo, hi, n):
    """n values over [lo, hi], one from each of n equal strata, shuffled."""
    u = (rng.permutation(n) + rng.random(n)) / n
    return lo + (hi - lo) * u


def states(traffic: dict, parameters: dict, units, rng) -> list:
    """The traffic's pool of states, each a dict of float64 arrays of
    ``traffic["cells"]`` cells, for a configuration with ``parameters``
    in ``units`` (a ``CodeUnits``), in an order drawn with ``rng`` (a
    numpy Generator made from the run's seed)."""
    n, pool = int(traffic["cells"]), int(traffic["pool"])
    design = np.random.default_rng(int(traffic["design_seed"]))
    gamma = float(parameters.get("Gamma", 5.0 / 3.0))
    chemistry = int(parameters.get("primordial_chemistry", 0))
    strata = n if n > 1 else pool
    draws = [(_stratified(design, *traffic["log_density"], strata),
              _stratified(design, *traffic["log_temperature"], strata))
             for _ in range(pool if n > 1 else 1)]
    if n == 1:
        draws = [(d[i:i + 1], t[i:i + 1]) for d, t in draws
                 for i in range(pool)]
    else:
        draws = [(d[order], t[order]) for d, t in draws
                 for order in [rng.permutation(n)]]
    draws = [draws[i] for i in rng.permutation(len(draws))]
    out = []
    for log_d, log_t in draws:
        d = 10.0 ** log_d
        f = {"density": d}
        if chemistry > 0:
            for name, rule in traffic["species"].items():
                f[name] = (rule["of_density"] * d if "of_density" in rule
                           else np.full(n, float(rule["value"])))
            if "HII" in f:
                f["de"] = (f["HII"] + f.get("HeII", 0.0) / 4.0
                           + f.get("HeIII", 0.0) / 2.0)
        if parameters.get("metal_cooling", 0):
            f["metal"] = traffic["metal_fraction"] * d
        f["energy"] = (10.0 ** log_t / units.temperature_units
                       / traffic["mu"] / (gamma - 1.0))
        out.append(f)
    return out
