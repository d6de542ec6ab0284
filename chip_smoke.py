#!/usr/bin/env python3
"""Smoke test of grackle_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA device:

    python3 chip_smoke.py

It builds the port's CUDA kernel from the sources in the checkout, holds
it against its plain PyTorch twin on the card, holds the port's solve
against the stored answers, and drives the flagship ``solve_chemistry``
(12 species + dust + metal cooling + CMB floor, 1,048,576 cells) in f64
and f32 through the kernel.  Phases:

0. device: the card's name and power limit (nvidia-smi);
1. build: nvcc of csrc/network_update.cu, with its build seconds;
2. kernel vs twin: the network-region inputs of the flagship state at the
   first and at a later subcycle, f64 and f32; masks and counters must be
   identical, per-field max relative error <= 1e-12 (f64) / 1e-4 (f32);
   the median of 20 bare kernel launches and of 20 twin calls, timed with
   CUDA events;
2b. the same check for every network configuration the kernel takes
   (primordial_chemistry 1-3, with and without dust, both deuterium
   updates) at 4,096 cells;
3. stored answers: the 6species, 9species_shield and 12species_dust
   workloads of tests/answer_workloads.py (32 cells, seed 4) on the card,
   against tests/answers/*.npz at rtol 1e-6;
4. flagship: wall seconds after one warm-up, cells/s, subcycles, converged
   share, peak CUDA memory, and kernel launches (must equal the subcycles
   run), at precision 64 and 32.

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


def flagship_chem(precision, device):
    """BASELINE config 4: 12 species, dust, metal cooling, CMB floor, with
    the synthetic Cloudy tables built in memory."""
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
    cd.solver_compaction = 0  # the compacted path is not ported yet
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
    cd.initialize(device=device, cloudy_data=(
        synthetic_cloudy_groups() if cd.metal_cooling else None))
    return cd


def answer_state(cd, n=32, seed=4):
    """tests/answer_workloads._state."""
    rng = np.random.RandomState(seed)
    tiny = 1e-20
    f = {"density": 10.0 ** rng.uniform(-1, 2, n)}
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
    return f


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
}

ANSWERS = [
    ("6species", dict(primordial_chemistry=1), 1.0e-3),
    ("9species_shield", dict(primordial_chemistry=2,
                             LWbackground_intensity=10.0,
                             H2_self_shielding=3), 1.0e-4),
    ("12species_dust", dict(primordial_chemistry=3, metal_cooling=1,
                            dust_chemistry=1), 1.0e-4),
]


def capture_network_inputs(cd, fields, dt, at):
    """Run the solve's subcycles (through the kernel) and keep the
    network region's inputs at each subcycle index in ``at``."""
    from grackle_tpu_torch.api import _prep_fields
    from grackle_tpu_torch.ops import solver
    from grackle_tpu_torch.ops.common import (make_unit_scalars,
                                              photo_rates_from_tables)

    ctx = cd.context
    cfg = ctx.config
    f, imetal = _prep_fields(ctx, fields)
    us = make_unit_scalars(cfg, ctx.tables, ctx.units)
    pr = photo_rates_from_tables(ctx.tables)
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
        """The flagship network inputs at full width, f64 and f32, with
        CUDA-event times of the bare kernel launch and of the twin."""
        import torch

        from grackle_tpu_torch.ops import network as plain
        from grackle_tpu_torch.ops.network_kernel import prepare_launch

        parts = []
        for precision, bound in ((64, F64_RTOL), (32, F32_RTOL)):
            cd = flagship_chem(precision, "cuda")
            cfg = cd.context.config
            fields = flagship_fields(cd, N_FLAGSHIP)
            for step, inp in capture_network_inputs(
                    cd, fields, DT_FLAGSHIP, CAPTURE_AT):
                msg, args, _ = self.check_kernel(
                    f"f{precision} subcycle {step}", cfg, inp, bound)
                launch, _ = prepare_launch(*args)
                ms_k = cuda_median_ms(launch)
                ms_t = cuda_median_ms(lambda: plain.network_update(*args))
                parts.append(f"{msg}; kernel {ms_k:.3f} ms, twin "
                             f"{ms_t:.3f} ms")
                if precision == 64 and step == CAPTURE_AT[0]:
                    self.kernel["ms"] = ms_k
                    self.kernel["plain_ms"] = ms_t
            del cd, fields
            torch.cuda.empty_cache()
        return "; ".join(parts)

    def kernel_configs(self):
        """Kernel vs twin for every network configuration the kernel
        takes (primordial_chemistry 1-3, with and without dust, both
        deuterium updates), f64 and f32, at subcycles 0 and 6 of the
        answer-workload state."""
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
        for name, kw, dt in ANSWERS:
            cd = answer_chem("cuda", **kw)
            new_f, diag = cd.solve_chemistry(answer_state(cd), dt)
            stored = np.load(os.path.join(REPO, "tests", "answers",
                                          f"{name}.npz"))
            keys = [k for k in stored.files if k in new_f]
            worst = 0.0
            for key in keys:
                got = new_f[key].cpu().numpy()
                want = stored[key]
                if got.shape != want.shape or not np.all(np.isfinite(got)):
                    raise AssertionError(f"{name}/{key}: bad output")
                worst = max(worst, float(np.max(
                    np.abs(got - want) / np.abs(want))))
            parts.append(f"{name} {'/'.join(keys)} max rel {worst:.3e}")
            if worst > ANSWER_RTOL:
                raise AssertionError("; ".join(parts))
        return "; ".join(parts)

    def flagship(self, precision):
        import torch

        from grackle_tpu_torch.ops.network_kernel import network_update_cuda

        def run():
            cd = flagship_chem(precision, "cuda")
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
        if precision == 64:
            self.kernel["launches"] = launches
            self.energy64 = new_f["energy"]
        msg = (f"f{precision} {N_FLAGSHIP} cells dt {DT_FLAGSHIP}: "
               f"{wall:.3f} s, {N_FLAGSHIP / wall:.0f} cells/s, "
               f"n_iterations {n_it}, subcycles run {subcycles}, "
               f"converged {conv:.6f}, peak {peak:.2f} GiB, "
               f"kernel launches {launches}")
        if precision == 32 and getattr(self, "energy64", None) is not None:
            e32 = new_f["energy"].double()
            rel = ((e32 - self.energy64).abs() / self.energy64.abs())
            msg += (f"; energy vs f64: median rel {float(rel.median()):.2e}"
                    f" max {float(rel.max()):.2e}")
        return msg


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
