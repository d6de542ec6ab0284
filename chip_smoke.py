#!/usr/bin/env python3
"""Smoke test of grackle_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA device:

    python3 chip_smoke.py

It builds the port's CUDA kernel from the sources in the checkout, holds
it against its plain PyTorch twin on the card, holds the port against the
stored answers, and drives the flagship ``solve_chemistry`` (12 species +
dust + metal cooling + CMB floor, 1,048,576 cells) in f64 and f32 through
the kernel, on the default compacted path and, in f64, the monolithic
one.  Phases:

0. device: the card's name and power limit (nvidia-smi);
1. build: nvcc of csrc/network_update.cu, with its build seconds;
2. kernel vs twin: the network-region inputs of the flagship state at the
   first and at a later subcycle, f64 and f32, at every cell and at the
   compacted path's tile and batch widths; masks and counters must be
   identical, per-field max relative error <= 1e-12 (f64) / 1e-4 (f32);
   the median of 20 bare kernel launches and of 20 twin calls, timed with
   CUDA events, beside the launch's bound (its bytes at 3.35 TB/s);
2b. the same check for every network configuration the kernel takes
   (primordial_chemistry 0-3, with and without dust, both deuterium
   updates, compensated_sums, radiative transfer with and without
   radiative_transfer_hydrogen_only, tabulated mode with the UVB) at
   4,096 cells, subcycles 0 and 6;
3. stored answers: every workload of tests/answer_workloads.py but
   rate_tables (tabulated, 6species, 9species_shield, 12species_dust on
   32 cells; grid_full on its 32^3 grid with ghost zones), every key,
   against tests/answers/*.npz at rtol 1e-6;
4. flagship at the default solver_compaction (the compacted path): wall
   seconds after one warm-up, cells/s, outer trips, subcycles, converged
   share, peak CUDA memory, and kernel launches (must equal the
   subcycles run over every warm tile and trip), at precision 64 and 32;
4b. one monolithic f64 flagship solve: its fields and per-cell subcycle
   counts must be bit-identical to phase 4's compacted f64 solve.

Each phase prints one line.  Then one JSON line lists the kernels, and the
last line is ``{"ok": true, "device": {...}}``.  Any failed phase makes the
script exit non-zero without that line; so does a machine without CUDA or
a directory without the grackle_tpu_torch package.  It imports neither
jax nor grackle_tpu.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
N_FLAGSHIP = 1_048_576
DT_FLAGSHIP = 1.0e-4
CAPTURE_AT = (0, 24)  # subcycles whose network inputs phase 2 replays
N_CONFIGS = 4096  # cells of phase 2b's per-configuration checks
TIMING_REPS = 20
#: the least time of one network launch: its bytes at the published
#: 3.35 TB/s of an H100 SXM, or its arithmetic (about 500 operations a
#: cell on the flagship path, counted from the source) at the published
#: 34 TFLOP/s of float64 outside the tensor cores (67 in float32)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_CELL = 500
PEAK_OPS_PER_S = {8: 34.0e12, 4: 67.0e12}
F64_RTOL = 1.0e-12
F32_RTOL = 1.0e-4
ANSWER_RTOL = 1.0e-6


def _units(cd):
    from grackle_tpu_torch.utilities.physical_constants import (
        mass_hydrogen_cgs,
    )

    cd.density_units = mass_hydrogen_cgs
    cd.length_units = 3.0857e21
    cd.time_units = 3.1556952e13


def flagship_chem(precision, device, **kw):
    """BASELINE config 4: 12 species, dust, metal cooling, CMB floor, with
    the synthetic Cloudy tables built in memory, at the default
    solver_compaction (the compacted path at the flagship's width) unless
    ``kw`` sets it."""
    from grackle_tpu_torch.api import ChemistryData
    from grackle_tpu_torch.data.synthetic import synthetic_cloudy_groups

    cd = ChemistryData()
    cd.use_grackle = 1
    cd.with_radiative_cooling = 1
    cd.primordial_chemistry = 3
    cd.precision = precision
    cd.metal_cooling = 1
    cd.dust_chemistry = 1
    cd.cmb_temperature_floor = 1
    for k, v in kw.items():
        setattr(cd, k, v)
    _units(cd)
    cd.initialize(device=device, cloudy_data=synthetic_cloudy_groups())
    return cd


def flagship_fields(cd, n, seed=11):
    """The flagship state recipe (__graft_entry__._make_fields)."""
    from grackle_tpu_torch.fluid_container import FluidContainer

    rng = np.random.RandomState(seed)
    fc = FluidContainer(cd, n)
    tiny = 1e-20
    fc["density"][:] = 10.0 ** rng.uniform(-1, 3, n)
    fc["HI"][:] = 0.5 * 0.76 * fc["density"]
    fc["HII"][:] = 0.5 * 0.76 * fc["density"]
    fc["HeI"][:] = 0.24 * fc["density"]
    fc["HeII"][:] = tiny
    fc["HeIII"][:] = tiny
    fc["de"][:] = fc["HII"] + fc["HeII"] / 4 + fc["HeIII"] / 2
    fc["HM"][:] = tiny * fc["density"]
    fc["H2I"][:] = 1e-5 * fc["density"]
    fc["H2II"][:] = tiny * fc["density"]
    fc["DI"][:] = 2.0 * 3.4e-5 * fc["density"]
    fc["DII"][:] = tiny
    fc["HDI"][:] = tiny
    fc["metal"][:] = 1.0e-3 * fc["density"]
    T = 10.0 ** rng.uniform(3.5, 6.5, n)
    fc.calculate_mean_molecular_weight()
    fc["energy"] = (T / cd.temperature_units / fc["mu"]
                    / (cd.Gamma - 1.0))
    return fc._solver_fields()


def answer_chem(device, **kw):
    """tests/answer_workloads._base_chem on the port."""
    from grackle_tpu_torch.api import ChemistryData
    from grackle_tpu_torch.data.synthetic import synthetic_cloudy_groups

    cd = ChemistryData()
    cd.use_grackle = 1
    cd.with_radiative_cooling = 1
    cd.precision = 64
    cd.use_fused_lookup = 0
    _units(cd)
    for k, v in kw.items():
        setattr(cd, k, v)
    reads_tables = (cd.metal_cooling or cd.UVbackground
                    or cd.primordial_chemistry == 0)
    cd.initialize(device=device, cloudy_data=(
        synthetic_cloudy_groups() if reads_tables else None))
    return cd


def answer_state(cd, n=32, seed=4):
    """tests/answer_workloads._state."""
    rng = np.random.RandomState(seed)
    tiny = 1e-20
    f = {"density": 10.0 ** rng.uniform(-1, 2, n)}
    if cd.primordial_chemistry > 0:
        f["HI"] = 0.5 * 0.76 * f["density"]
        f["HII"] = 0.5 * 0.76 * f["density"]
        f["HeI"] = 0.24 * f["density"]
        f["HeII"] = np.full(n, tiny)
        f["HeIII"] = np.full(n, tiny)
        f["de"] = f["HII"].copy()
    if cd.primordial_chemistry > 1:
        f["HM"] = np.full(n, tiny)
        f["H2I"] = 1e-5 * f["density"]
        f["H2II"] = np.full(n, tiny)
    if cd.primordial_chemistry > 2:
        f["DI"] = 2.0 * 3.4e-5 * f["density"]
        f["DII"] = np.full(n, tiny)
        f["HDI"] = np.full(n, tiny)
    if cd.metal_cooling:
        f["metal"] = 1e-3 * f["density"]
    T = 10.0 ** rng.uniform(3.5, 6.5, n)
    f["energy"] = T / cd.temperature_units / 0.8 / (cd.Gamma - 1.0)
    if cd.use_radiative_transfer:
        # radiative-transfer fields, drawn after the recipe's own: 1e-13
        # to 1e-11 per second (in 1/time_units) ionizing and
        # dissociating, 1e-25 to 1e-23 erg/s heating per HI
        def rate():
            return 10.0 ** rng.uniform(-13, -11, n) * cd.time_units

        for name in ["RT_HI_ionization_rate", "RT_HeI_ionization_rate",
                     "RT_HeII_ionization_rate", "RT_H2_dissociation_rate"]:
            f[name] = rate()
        f["RT_heating_rate"] = 10.0 ** rng.uniform(-25, -23, n)
    return f


#: tests/answer_workloads.py's config-5 grid: shape, inclusive active
#: region (26 x 28 x 30 cells), dt and cell width
GRID_SHAPE = (32, 32, 32)
GRID_START = (3, 2, 1)
GRID_END = (28, 29, 30)
GRID_DT = 1.0e-4
GRID_DX = 1.0e-3
GRID_DERIVED = ["cooling_time", "temperature", "pressure", "gamma",
                "dust_temperature"]


def grid_full_setup(device, shape=GRID_SHAPE, start=GRID_START,
                    end=GRID_END, seed=11):
    """tests/answer_workloads.grid_full_setup on the port: (cd, grid
    fields, active-region slice).  Ghost zones hold seeded garbage that
    must pass through untouched."""
    cd = answer_chem(
        device, primordial_chemistry=3, metal_cooling=1, dust_chemistry=1,
        UVbackground=1, H2_self_shielding=1, use_volumetric_heating_rate=1,
        use_specific_heating_rate=1)
    rng = np.random.RandomState(seed)
    tiny = 1e-20
    sl = tuple(slice(s, e + 1) for s, e in zip(start, end))
    f = {}
    for name in ["density", "HI", "HII", "HeI", "HeII", "HeIII", "de",
                 "HM", "H2I", "H2II", "DI", "DII", "HDI", "metal",
                 "energy", "volumetric_heating_rate",
                 "specific_heating_rate"]:
        f[name] = 10.0 ** rng.uniform(-2, 2, shape)
    d = 10.0 ** rng.uniform(-1, 2, shape)
    f["density"][sl] = d[sl]
    f["HI"][sl] = 0.5 * 0.76 * d[sl]
    f["HII"][sl] = 0.5 * 0.76 * d[sl]
    f["HeI"][sl] = 0.24 * d[sl]
    for k in ("HeII", "HeIII", "HM", "H2II", "DII", "HDI"):
        f[k][sl] = tiny
    f["H2I"][sl] = 1e-5 * d[sl]
    f["DI"][sl] = 2.0 * 3.4e-5 * d[sl]
    f["de"][sl] = f["HII"][sl]
    f["metal"][sl] = 1e-3 * d[sl]
    nH = 0.76 * d[sl]
    f["volumetric_heating_rate"][sl] = 1e-27 * nH ** 2
    f["specific_heating_rate"][sl] = 1e-3
    T = 10.0 ** rng.uniform(3.5, 6.5, shape)
    f["energy"][sl] = (T[sl] / cd.temperature_units / 0.8
                       / (cd.Gamma - 1.0))
    return cd, f, sl


def grid_full_answer(device):
    """tests/answer_workloads.workload_grid_full on the port: the grid
    solve, then every derived field of the active region."""
    cd, f, sl = grid_full_setup(device)
    new_f, diag = cd.solve_chemistry_grid(f, GRID_DT, grid_start=GRID_START,
                                          grid_end=GRID_END,
                                          grid_dx=GRID_DX)
    if not bool(diag["converged"].all()):
        raise AssertionError("grid_full: a cell hit max_iterations")
    active = {k: v[sl].reshape(-1) for k, v in new_f.items()}
    out = {k: active[k] for k in ["HI", "H2I", "HDI", "de", "energy"]}
    for name in GRID_DERIVED:
        out[name] = getattr(cd, f"calculate_{name}")(active)
    return out


#: network-region configurations phase 2b holds the kernel to its twin in
NETWORK_CASES = {
    "chem1": dict(primordial_chemistry=1),
    "chem2": dict(primordial_chemistry=2),
    "chem2_h2dust": dict(primordial_chemistry=2, h2_on_dust=1),
    "chem3": dict(primordial_chemistry=3),
    "chem3_dust_metal": dict(primordial_chemistry=3, metal_cooling=1,
                             dust_chemistry=1),
    "chem3_jacobi_shield": dict(primordial_chemistry=3,
                                deuterium_coupled_solve=0,
                                LWbackground_intensity=10.0,
                                H2_self_shielding=3),
    "chem3_dust_compensated": dict(primordial_chemistry=3, metal_cooling=1,
                                   dust_chemistry=1, compensated_sums=1),
    "chem1_rt": dict(primordial_chemistry=1, use_radiative_transfer=1),
    "chem2_rt": dict(primordial_chemistry=2, use_radiative_transfer=1),
    "chem3_rt_hydrogen_only": dict(primordial_chemistry=3,
                                   use_radiative_transfer=1,
                                   radiative_transfer_hydrogen_only=1),
    "chem0_metal_uvb": dict(primordial_chemistry=0, metal_cooling=1,
                            UVbackground=1),
}


def _solve(cd, f, dt):
    new_f, diag = cd.solve_chemistry(f, dt)
    if not bool(diag["converged"].all()):
        raise AssertionError("a cell hit max_iterations")
    return new_f


def answer_tabulated(device):
    """tests/answer_workloads.workload_tabulated: tabulated cooling with
    the UVB heating tables."""
    cd = answer_chem(device, primordial_chemistry=0, metal_cooling=1,
                     UVbackground=1)
    f = answer_state(cd)
    f["metal"] = 0.01 * f["density"]
    return {"temperature": cd.calculate_temperature(f),
            "cooling_time": cd.calculate_cooling_time(f),
            "energy_after": _solve(cd, f, 1.0e-3)["energy"]}


def answer_6species(device):
    cd = answer_chem(device, primordial_chemistry=1)
    f = answer_state(cd)
    out = {"cooling_time": cd.calculate_cooling_time(f)}
    new_f = _solve(cd, f, 1.0e-3)
    out.update({k: new_f[k] for k in ["HI", "HII", "de", "energy"]})
    return out


def answer_9species_shield(device):
    cd = answer_chem(device, primordial_chemistry=2,
                     LWbackground_intensity=10.0, H2_self_shielding=3)
    new_f = _solve(cd, answer_state(cd), 1.0e-4)
    return {k: new_f[k] for k in ["HI", "H2I", "de", "energy"]}


def answer_12species_dust(device):
    cd = answer_chem(device, primordial_chemistry=3, metal_cooling=1,
                     dust_chemistry=1)
    f = answer_state(cd)
    out = {"dust_temperature": cd.calculate_dust_temperature(f)}
    new_f = _solve(cd, f, 1.0e-4)
    out.update({k: new_f[k] for k in ["HI", "H2I", "HDI", "de", "energy"]})
    return out


#: tests/answer_workloads.WORKLOADS on the port (rate_tables aside: its
#: stored SVD factors are the JAX package's, ROADMAP queue 3): name ->
#: function of the device returning every key of tests/answers/<name>.npz
ANSWERS = {
    "tabulated": answer_tabulated,
    "6species": answer_6species,
    "9species_shield": answer_9species_shield,
    "12species_dust": answer_12species_dust,
    "grid_full": grid_full_answer,
}


def answer_errors(name, out):
    """Per-key max relative error of one workload's outputs against its
    stored answer; raises unless the keys are the stored ones and every
    output is finite and of the stored shape."""
    stored = np.load(os.path.join(REPO, "tests", "answers", f"{name}.npz"))
    if sorted(out) != sorted(stored.files):
        raise AssertionError(f"{name}: keys {sorted(out)} != stored "
                             f"{sorted(stored.files)}")
    errors = {}
    for key in stored.files:
        got = out[key]
        got = got.cpu().numpy() if hasattr(got, "cpu") else np.asarray(got)
        want = stored[key]
        if got.shape != want.shape or not np.all(np.isfinite(got)):
            raise AssertionError(f"{name}/{key}: bad output")
        errors[key] = float(np.max(np.abs(got - want) / np.abs(want)))
    return errors


def capture_network_inputs(cd, fields, dt, at):
    """Run the solve's subcycles (through the kernel) and keep the
    network region's inputs at each subcycle index in ``at``."""
    from grackle_tpu_torch.api import _photo_rates, _prep_fields
    from grackle_tpu_torch.ops import solver
    from grackle_tpu_torch.ops.common import make_unit_scalars

    ctx = cd.context
    cfg = ctx.config
    f, imetal = _prep_fields(ctx, fields)
    us = make_unit_scalars(cfg, ctx.tables, ctx.units)
    pr = _photo_rates(cfg, ctx.tables, ctx.uvb, ctx.units)
    f, itmask0 = solver.prepare_fields(cfg, f, us, imetal, False)
    f_state, f_const = solver.split_state(cfg, f)
    carry = solver.init_carry(f_state, itmask0, cfg)
    captured = []
    for step in range(max(at) + 1):
        inputs = {} if step in at else None
        carry = solver.subcycle(
            cfg, ctx.tables, ctx.cloudy_primordial, ctx.cloudy_metal, pr,
            us, carry, dt, imetal, ctx.cloudy_data_new, f_const,
            inputs_out=inputs)
        if inputs is not None:
            captured.append((step, inputs))
    return captured


def head_inputs(inp, n):
    """Captured network inputs cut to their first ``n`` cells (each
    tensor a contiguous prefix)."""
    import dataclasses

    import torch

    def head(x):
        if isinstance(x, dict):
            return {k: head(v) for k, v in x.items()}
        return x[:n] if isinstance(x, torch.Tensor) else x

    out = {k: head(v) for k, v in inp.items() if k != "rs"}
    rs = inp["rs"]
    out["rs"] = None if rs is None else dataclasses.replace(
        rs, k=head(rs.k), shields=head(rs.shields), h2dust=head(rs.h2dust),
        k13dd=None, ti=None)
    return out


def compare_outputs(kern, twin):
    """(max relative error over float outputs, max absolute error,
    identical masks and counters)."""
    import torch

    worst_rel = worst_abs = 0.0
    flat_k = dict(kern["fields"], **{k: v for k, v in kern.items()
                                     if k != "fields"})
    flat_t = dict(twin["fields"], **{k: v for k, v in twin.items()
                                     if k != "fields"})
    exact = True
    for name, t in flat_t.items():
        k = flat_k[name]
        if t.dtype in (torch.bool, torch.int32):
            exact = exact and bool(torch.equal(k, t))
            continue
        diff = (k - t).abs()
        rel = torch.where(t == 0, diff, diff / t.abs())
        same = (k == t) | (torch.isnan(k) & torch.isnan(t))
        rel = torch.where(same, torch.zeros_like(rel), rel)
        diff = torch.where(same, torch.zeros_like(diff), diff)
        worst_rel = max(worst_rel, float(rel.max()))
        worst_abs = max(worst_abs, float(diff.max()))
    return worst_rel, worst_abs, exact


def cuda_median_ms(fn, reps=TIMING_REPS):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


class Smoke:
    def __init__(self):
        self.ok = True
        self.kernel = dict(
            name="network_update", route="cuda",
            source="grackle_tpu_torch/csrc/network_update.cu",
            replaces="grackle_tpu/ops/network_kernel.py:136",
            launches=None, max_abs_err=None, ms=None, plain_ms=None,
            bound_ms=None, bound_by=None, library_ms=None,
        )

    def phase(self, label, fn):
        t0 = time.time()
        try:
            msg = fn()
            print(f"[{label}] ok ({time.time() - t0:.1f} s): {msg}",
                  flush=True)
        except Exception as exc:  # report and go on; the exit code fails
            self.ok = False
            print(f"[{label}] FAILED ({time.time() - t0:.1f} s): "
                  f"{type(exc).__name__}: {exc}", flush=True)
            traceback.print_exc(file=sys.stderr)

    def device(self):
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
        # the card's own line, exactly as nvidia-smi gives it
        print(out[0], flush=True)
        return f"nvidia-smi: {out[0]}"

    def build(self):
        from grackle_tpu_torch.ops import network_kernel

        t0 = time.time()
        path = network_kernel.build()
        secs = time.time() - t0
        network_kernel.load()
        log = " ".join(network_kernel.build_log.split())
        return (f"built {os.path.relpath(path, REPO)} in {secs:.2f} s; "
                f"ptxas: {log or '(cached build)'}")

    def check_kernel(self, label, cfg, inp, bound):
        """Kernel vs twin on one set of captured network inputs; raises
        unless masks and counters are identical and the worst relative
        error is within ``bound``.  Returns (message, kernel arguments,
        worst relative error)."""
        import torch

        from grackle_tpu_torch.ops import network as plain
        from grackle_tpu_torch.ops.network_kernel import network_update_cuda

        args = (cfg, inp["us"], inp["dt"], inp["f"], inp["rs"],
                inp["cool_v"], inp["carry_v"], inp["h2_limit"])
        kern = network_update_cuda(*args)
        twin = plain.network_update(*args)
        torch.cuda.synchronize()
        rel, abs_err, exact = compare_outputs(kern, twin)
        self.kernel["max_abs_err"] = max(self.kernel["max_abs_err"] or 0.0,
                                         abs_err)
        active = int(inp["carry_v"]["itmask"].sum())
        msg = (f"{label} ({active} active): max rel {rel:.3e} abs "
               f"{abs_err:.3e}, masks {'identical' if exact else 'DIFFER'}")
        if not (exact and rel <= bound):
            raise AssertionError(msg + f" (bound {bound:.0e})")
        return msg, args, rel

    def kernel_vs_twin(self):
        """The flagship network inputs, f64 and f32, at the widths the
        solves launch the kernel with: every cell (the monolithic path),
        the compacted path's warm tile and its batch (the first cells of
        the same inputs).  CUDA-event times of the bare kernel launch and
        of the twin, beside the launch's bound.  The kernel line reports
        f64 at the batch width, the shape of most of the main path's
        launches."""
        import torch

        from grackle_tpu_torch.api import _compact_batch
        from grackle_tpu_torch.ops import network as plain
        from grackle_tpu_torch.ops.network_kernel import prepare_launch
        from grackle_tpu_torch.ops.solver import warm_tile_width

        batch = _compact_batch(N_FLAGSHIP)
        widths = (N_FLAGSHIP, min(warm_tile_width(batch), N_FLAGSHIP), batch)
        parts = []
        for precision, bound in ((64, F64_RTOL), (32, F32_RTOL)):
            cd = flagship_chem(precision, "cuda")
            cfg = cd.context.config
            fields = flagship_fields(cd, N_FLAGSHIP)
            for step, inp in capture_network_inputs(
                    cd, fields, DT_FLAGSHIP, CAPTURE_AT):
                for n in widths:
                    msg, args, _ = self.check_kernel(
                        f"f{precision} subcycle {step} {n} cells", cfg,
                        head_inputs(inp, n), bound)
                    launch, _ = prepare_launch(*args)
                    ms_k = cuda_median_ms(launch)
                    ms_t = cuda_median_ms(
                        lambda: plain.network_update(*args))
                    size = inp["f"]["density"].element_size()
                    bytes_ms = launch.bytes / HBM_BYTES_PER_S * 1e3
                    ops_ms = OPS_PER_CELL * n / PEAK_OPS_PER_S[size] * 1e3
                    parts.append(f"{msg}; kernel {ms_k:.4f} ms, twin "
                                 f"{ms_t:.4f} ms, {launch.bytes} B, bound "
                                 f"{max(bytes_ms, ops_ms):.4f} ms")
                    if (precision, step, n) == (64, CAPTURE_AT[1], batch):
                        self.kernel.update(
                            ms=ms_k, plain_ms=ms_t,
                            bound_ms=max(bytes_ms, ops_ms),
                            bound_by="bytes" if bytes_ms >= ops_ms
                            else "operations")
            del cd, fields
            torch.cuda.empty_cache()
        return "; ".join(parts)

    def kernel_configs(self):
        """Kernel vs twin for every network configuration the kernel
        takes (NETWORK_CASES: primordial_chemistry 0-3, dust, both
        deuterium updates, compensated_sums, radiative transfer), f64
        and f32, at subcycles 0 and 6 of the answer-workload state."""
        parts = []
        for name, kw in NETWORK_CASES.items():
            for precision, bound in ((64, F64_RTOL), (32, F32_RTOL)):
                cd = answer_chem("cuda", precision=precision, **kw)
                state = answer_state(cd, n=N_CONFIGS)
                worst = []
                for step, inp in capture_network_inputs(
                        cd, state, 1.0e-4, (0, 6)):
                    _, _, rel = self.check_kernel(
                        f"{name} f{precision} subcycle {step}",
                        cd.context.config, inp, bound)
                    worst.append(f"{rel:.3e}")
                parts.append(f"{name} f{precision} max rel "
                             f"{'/'.join(worst)}")
        return "; ".join(parts)

    def answers(self):
        parts = []
        for name, workload in ANSWERS.items():
            errors = answer_errors(name, workload("cuda"))
            worst = max(errors.values())
            parts.append(f"{name} {'/'.join(errors)} max rel {worst:.3e}")
            if worst > ANSWER_RTOL:
                raise AssertionError("; ".join(parts))
        return "; ".join(parts)

    def flagship(self, precision):
        """The flagship at the default solver_compaction (the compacted
        path): wall seconds after one warm-up, outer trips, and kernel
        launches, which must equal the subcycles run over every warm tile
        and trip.  The f64 run is the main path whose launches the kernel
        line reports."""
        import torch

        from grackle_tpu_torch.api import solve_path
        from grackle_tpu_torch.ops.network_kernel import network_update_cuda

        def run():
            cd = flagship_chem(precision, "cuda")
            if solve_path(cd.config, N_FLAGSHIP) != "compact":
                raise AssertionError("the flagship does not take the "
                                     "compacted path")
            fields = flagship_fields(cd, N_FLAGSHIP)
            torch.cuda.synchronize()
            network_update_cuda.launches = 0
            t0 = time.time()
            new_f, diag = cd.solve_chemistry(fields, DT_FLAGSHIP)
            torch.cuda.synchronize()
            wall = time.time() - t0
            return new_f, diag, wall, network_update_cuda.launches

        run()  # warm-up: same solve, discarded
        torch.cuda.reset_peak_memory_stats()
        new_f, diag, wall, launches = run()
        peak = torch.cuda.max_memory_allocated() / 2**30
        subcycles = diag["subcycles"]
        n_it = int(diag["n_iterations"])
        conv = float(diag["converged"].float().mean())
        for key, val in new_f.items():
            if val.shape != (N_FLAGSHIP,) or not bool(
                    torch.isfinite(val).all()):
                raise AssertionError(f"f{precision} {key}: bad output")
        if launches != subcycles or launches == 0:
            raise AssertionError(
                f"f{precision}: {launches} kernel launches for "
                f"{subcycles} subcycles")
        if diag["trips"] == 0:
            raise AssertionError(f"f{precision}: no outer trip ran")
        if precision == 64:
            self.kernel["launches"] = launches
            self.compact64 = (new_f, diag, wall)
        msg = (f"f{precision} compacted, {N_FLAGSHIP} cells dt "
               f"{DT_FLAGSHIP}: {wall:.3f} s, {N_FLAGSHIP / wall:.0f} "
               f"cells/s, n_iterations {n_it}, outer trips "
               f"{diag['trips']}, subcycles run {subcycles}, converged "
               f"{conv:.6f}, peak {peak:.2f} GiB, kernel launches "
               f"{launches}")
        if precision == 32 and getattr(self, "compact64", None) is not None:
            e64 = self.compact64[0]["energy"]
            rel = (new_f["energy"].double() - e64).abs() / e64.abs()
            msg += (f"; energy vs f64: median rel {float(rel.median()):.2e}"
                    f" max {float(rel.max()):.2e}")
        return msg

    def monolithic(self):
        """One monolithic f64 flagship solve (solver_compaction = 0, no
        warm-up): its fields and per-cell subcycle counts must equal the
        compacted f64 solve of phase 4 bit for bit."""
        import torch

        from grackle_tpu_torch.ops.network_kernel import network_update_cuda

        if getattr(self, "compact64", None) is None:
            raise AssertionError("phase 4 f64 did not complete")
        comp_f, comp_d, comp_wall = self.compact64
        cd = flagship_chem(64, "cuda", solver_compaction=0)
        fields = flagship_fields(cd, N_FLAGSHIP)
        torch.cuda.synchronize()
        network_update_cuda.launches = 0
        t0 = time.time()
        new_f, diag = cd.solve_chemistry(fields, DT_FLAGSHIP)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = network_update_cuda.launches
        if diag["trips"] != 0 or launches != diag["subcycles"]:
            raise AssertionError(f"monolithic: {diag['trips']} trips, "
                                 f"{launches} launches for "
                                 f"{diag['subcycles']} subcycles")
        differ = [k for k in new_f if not torch.equal(new_f[k], comp_f[k])]
        if not torch.equal(diag["cell_iterations"],
                           comp_d["cell_iterations"]):
            differ.append("cell_iterations")
        if sorted(new_f) != sorted(comp_f) or differ:
            raise AssertionError(f"monolithic vs compacted differ in "
                                 f"{differ or 'keys'}")
        return (f"f64 monolithic {wall:.3f} s ({N_FLAGSHIP / wall:.0f} "
                f"cells/s, {launches} launches) against compacted "
                f"{comp_wall:.3f} s ({comp_d['subcycles']} launches, "
                f"{comp_d['trips']} trips): {len(new_f)} fields and "
                f"cell_iterations bit-identical")


def main() -> int:
    sys.path.insert(0, REPO)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on "
              "the card", file=sys.stderr)
        return 2
    try:
        import grackle_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: cannot import grackle_tpu_torch from {REPO}: "
              f"{exc}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smoke = Smoke()
    t0 = time.time()
    smoke.phase("0 device", smoke.device)
    smoke.phase("1 build", smoke.build)
    smoke.phase("2 kernel vs twin", smoke.kernel_vs_twin)
    smoke.phase("2b kernel vs twin, every configuration",
                smoke.kernel_configs)
    smoke.phase("3 stored answers", smoke.answers)
    smoke.phase("4 flagship f64", lambda: smoke.flagship(64))
    smoke.phase("4 flagship f32", lambda: smoke.flagship(32))
    smoke.phase("4b monolithic f64 vs compacted", smoke.monolithic)
    print(f"[total] {time.time() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": [smoke.kernel]}), flush=True)
    if not smoke.ok:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
