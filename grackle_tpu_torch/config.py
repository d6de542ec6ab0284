"""Chemistry parameter registry (port of grackle_tpu/config.py).

Analogue of the reference's X-macro parameter registry
(grackle: src/clib/grackle_chemistry_data_fields.def:22-204 and
src/clib/grackle_chemistry_data.h:20-178).  Every runtime parameter keeps the
reference's name and default so that a pygrackle user can move over without
relearning the configuration surface.

Two layers:

* ``PARAMETER_REGISTRY`` — ordered mapping name -> (python type, default),
  the analogue of the ``ENTRY(name, TYPE, default)`` X-macro list.  It powers
  the string-keyed dynamic API (grackle: src/clib/dynamic_api.c:35-116).
* ``ChemistryConfig`` — a frozen (hashable) dataclass snapshot; every
  integer flag is a plain Python int read by the solver's host code, so
  only the enabled physics is ever dispatched.

The registry is the JAX package's, name for name, type for type and
default for default: a parameter set moves between the two packages
unchanged.  ``use_fused_lookup`` is accepted and has no effect here (the
port always gathers; the fused matmul lookup is a TPU mechanism).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

FLOAT_UNDEFINED = -99999.0

# name -> (type, default); order follows the reference registry.
PARAMETER_REGISTRY: Dict[str, Tuple[type, Any]] = {
    "use_grackle": (int, 0),
    "with_radiative_cooling": (int, 1),
    "primordial_chemistry": (int, 0),
    "dust_chemistry": (int, 0),
    "metal_cooling": (int, 0),
    "UVbackground": (int, 0),
    "grackle_data_file": (str, ""),
    "cmb_temperature_floor": (int, 1),
    "Gamma": (float, 5.0 / 3.0),
    "h2_on_dust": (int, 0),
    "use_dust_density_field": (int, 0),
    "dust_recombination_cooling": (int, -1),  # unset
    "photoelectric_heating": (int, -1),  # unset
    "photoelectric_heating_rate": (float, 8.5e-26),
    "use_isrf_field": (int, 0),
    "interstellar_radiation_field": (float, 1.7),
    "use_volumetric_heating_rate": (int, 0),
    "use_specific_heating_rate": (int, 0),
    "three_body_rate": (int, 0),
    "cie_cooling": (int, 0),
    "h2_optical_depth_approximation": (int, 0),
    "ih2co": (int, 1),
    "ipiht": (int, 1),
    "HydrogenFractionByMass": (float, 0.76),
    "DeuteriumToHydrogenRatio": (float, 2.0 * 3.4e-5),
    "SolarMetalFractionByMass": (float, 0.01295),
    "local_dust_to_gas_ratio": (float, 0.009387),
    "CaseBRecombination": (int, 0),
    "NumberOfTemperatureBins": (int, 600),
    "TemperatureStart": (float, 1.0),
    "TemperatureEnd": (float, 1.0e9),
    "NumberOfDustTemperatureBins": (int, 250),
    "DustTemperatureStart": (float, 1.0),
    "DustTemperatureEnd": (float, 1500.0),
    "Compton_xray_heating": (int, 0),
    "LWbackground_sawtooth_suppression": (int, 0),
    "LWbackground_intensity": (float, 0.0),
    "UVbackground_redshift_on": (float, FLOAT_UNDEFINED),
    "UVbackground_redshift_off": (float, FLOAT_UNDEFINED),
    "UVbackground_redshift_fullon": (float, FLOAT_UNDEFINED),
    "UVbackground_redshift_drop": (float, FLOAT_UNDEFINED),
    "cloudy_electron_fraction_factor": (float, 9.153959e-3),
    "use_radiative_transfer": (int, 0),
    "radiative_transfer_coupled_rate_solver": (int, 0),
    "radiative_transfer_intermediate_step": (int, 0),
    "radiative_transfer_hydrogen_only": (int, 0),
    "self_shielding_method": (int, 0),
    "H2_self_shielding": (int, 0),
    "H2_custom_shielding": (int, 0),
    "h2_charge_exchange_rate": (int, 1),
    "h2_dust_rate": (int, 1),
    "h2_h_cooling_rate": (int, 1),
    "collisional_excitation_rates": (int, 1),
    "collisional_ionisation_rates": (int, 1),
    "recombination_cooling_rates": (int, 1),
    "bremsstrahlung_cooling_rates": (int, 1),
    # Extension: fused table lookups. TPU has no fast per-lane gather
    # inside device loops (measured ~0.4 ms per gathered table per
    # subcycle); with this on, all log-T table lookups in the subcycle
    # body become ONE two-hot matmul against a stacked table matrix on
    # the MXU (the linear-interpolation weights are folded into the
    # one-hot rows), ~50x faster. -1 = auto (on for TPU backends, off for
    # CPU where native gathers win), 0 = off, 1 = on.
    "use_fused_lookup": (int, -1),
    # Extension: solver floating-point precision, the runtime analogue of
    # the reference's compile-time CONFIG_PRECISION=32/64 gr_float choice
    # (grackle_types.h:24-34, Make.config.settings:23).  64 matches the
    # double-precision reference bit-for-bit in logic; 32 runs natively on
    # the TPU VPU (v5e has no hardware f64) at ~1e-5 relative accuracy,
    # the same tolerance class as the reference's float build.
    "precision": (int, 64),
    # Extension (not in the reference registry): selects the H2 cooling
    # function, replacing the reference's compile-time choice
    # (cool1d_multi_g.F:470-624). 0 = Glover & Abel 2008 (the reference's
    # compiled-in default), 1 = Galli & Palla 1999, 2 = Lepp & Shull.
    "h2_cooling_variant": (int, 0),
    # Extension: converged-cell compaction for solve_chemistry.  The
    # subcycle iteration count is strongly heavy-tailed (median ~20,
    # tail ~240 on log-uniform states); after `solver_compaction` warm
    # subcycles on the full array, the still-unconverged cells are
    # batched by predicted residual work and run to convergence in
    # compact batches (see ops/solver.py:solve_rate_cool_compacted).
    # Bit-identical to the monolithic loop (the update is purely
    # per-cell).  The value is the warm-phase subcycle count; 0 disables;
    # the driver also auto-disables below 4*8192 cells where batching
    # overhead would dominate.
    "solver_compaction": (int, 24),
    # Extension (no reference analogue): compensated (Neumaier two-sum)
    # accumulation of the gas energy and the per-cell subcycle clock in
    # the f32 solver.  The 32-bit mode's long-horizon error is dominated
    # by summation drift in `energy += edot/rho * dtit` over hundreds of
    # subcycles x thousands of calls; carrying an f32 compensation term
    # for energy and ttot removes that drift at a few extra VPU ops per
    # subcycle (the per-step rate/network error, ~1e-7 median, is
    # unaffected -- see docs/Performance.md "Accuracy").  No effect in
    # the f64 mode.
    "compensated_sums": (int, 0),
    # Extension (no reference analogue): exact-integration radiative
    # cooling for tabulated mode (primordial_chemistry=0).  Replaces the
    # subcycled energy integration with the closed-form Townsend (2009)
    # temporal-evolution-function scheme on the Cloudy temperature grid
    # (ops/exact_cool.py).  Requires a cooling-only configuration:
    # UVbackground, radiative transfer, user heating arrays,
    # photoelectric heating, and dust must all be off (validated at
    # initialize).
    "exact_cooling": (int, 0),
    # Extension: the per-subcycle relative change limit.  The reference
    # hard-codes 10% of de/HI/energy per subcycle
    # (solve_rate_cool_g.F:554-718); exposing the fraction makes the
    # integrator's accuracy tunable and testable — the subcycled
    # trajectory's global error is first-order in this fraction
    # (tests/test_ode_reference.py verifies convergence against a BDF
    # integration of the same network).
    "subcycle_accuracy": (float, 0.1),
    # Extension: exact coupled backward-Euler solve of the stiff
    # (DI, DII) charge-exchange pair.  The reference updates DI and DII
    # Jacobi-style — each species' source uses the OTHER's pre-step
    # value (solve_rate_cool_g.F:2310-2345) — so when the subcycle dt
    # exceeds the k50/k51 charge-exchange time (no dt limiter covers D,
    # unlike de/HI/energy) the pair hands its whole budget back and
    # forth each subcycle instead of equilibrating: the endpoint D
    # ionization state is O(1) wrong and depends on subcycle parity.
    # 1 (default) = solve the 2x2 linear BE system exactly
    # (unconditionally stable, lands on the staged equilibrium, same
    # cost); 0 = reference-parity Jacobi update.  Validated against a
    # BDF integration of the identical network in
    # tests/test_ode_reference.py.
    "deuterium_coupled_solve": (int, 1),
    "max_iterations": (int, 10000),
    "exit_after_iterations_exceeded": (int, 0),
    # Analogue of omp_nthreads: number of host threads used by the async
    # dispatch layer (no effect on TPU compute, kept for API parity).
    "omp_nthreads": (int, 1),
}

def _make_config_class():
    fields = []
    for name, (ftype, default) in PARAMETER_REGISTRY.items():
        fields.append((name, ftype, dataclasses.field(default=default)))
    return dataclasses.make_dataclass(
        "ChemistryConfig", fields, frozen=True, eq=True
    )


ChemistryConfig = _make_config_class()


def _anydust(cfg) -> bool:
    """Reference: solve_rate_cool_g.F:327 / initialize_rates.c:218."""
    return (cfg.h2_on_dust > 0) or (cfg.dust_chemistry > 0) or (
        cfg.dust_recombination_cooling > 0
    )


def resolve_config(cfg: "ChemistryConfig") -> "ChemistryConfig":
    """Apply the derivation/validation rules the reference applies at
    initialization (grackle: src/clib/initialize_chemistry_data.c:71-136).

    Returns a new frozen config with derived flags resolved.
    """
    updates = {}
    if cfg.dust_chemistry > 0:
        if cfg.metal_cooling < 1:
            raise ValueError("dust_chemistry > 0 requires metal_cooling > 0.")
        if cfg.photoelectric_heating < 0:
            updates["photoelectric_heating"] = 2
        if cfg.dust_recombination_cooling < 0:
            updates["dust_recombination_cooling"] = 1
        if cfg.primordial_chemistry > 1 and cfg.h2_on_dust == 0:
            updates["h2_on_dust"] = 1
    if cfg.photoelectric_heating < 0 and "photoelectric_heating" not in updates:
        updates["photoelectric_heating"] = 0
    if cfg.primordial_chemistry == 0:
        # Tabulated mode: H fraction forced to Cloudy's n_He/n_H = 0.1
        # abundance (initialize_chemistry_data.c:129-136).
        updates["HydrogenFractionByMass"] = 1.0 / (1.0 + 0.1 * 3.971)
    if cfg.exact_cooling == 1:
        # exact-integration tabulated cooling: cooling-only scope
        if cfg.primordial_chemistry != 0:
            raise ValueError(
                "exact_cooling = 1 requires primordial_chemistry = 0 "
                "(tabulated mode)."
            )
        bad = [name for name in (
            "UVbackground", "use_radiative_transfer",
            "use_volumetric_heating_rate", "use_specific_heating_rate",
            "dust_chemistry",
        ) if getattr(cfg, name)]
        if cfg.photoelectric_heating > 0:
            bad.append("photoelectric_heating")
        if bad:
            raise ValueError(
                "exact_cooling = 1 is a cooling-only scheme; disable: "
                + ", ".join(bad)
            )
    if updates:
        cfg = dataclasses.replace(cfg, **updates)
    return cfg


def default_config(**overrides) -> "ChemistryConfig":
    """Build a ChemistryConfig from defaults plus keyword overrides."""
    return ChemistryConfig(**overrides)
