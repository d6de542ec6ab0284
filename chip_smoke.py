#!/usr/bin/env python3
"""Smoke test of grackle_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA device:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, holds
each against its plain PyTorch version on the card, holds the port against
the stored answers, and drives the flagship ``solve_chemistry`` (12
species + dust + metal cooling + CMB floor, 1,048,576 cells) in f64 and
f32 through the network kernel, on the default compacted path and, in
f64, the monolithic one; then captures ``functional.make_solve_fn`` into
CUDA graphs, whose loops are conditional WHILE nodes, and replays them;
and holds the stateful API's own graphs (graph_cache.py: a context's
second call with a key captures, later ones replay) to the uncached
body.  Phases:

0. device: the card's name and power limit (nvidia-smi), torch and its
   CUDA, nvcc and the driver;
1. build: nvcc of csrc/network_update.cu, csrc/graph_loop.cu,
   csrc/cloudy_interp.cu, csrc/dust_temp.cu and csrc/rate_lookup.cu,
   started together, with their build seconds;
2. kernel vs twin: the network-region inputs of the flagship state at the
   first and at a later subcycle, f64 and f32, at every cell and at the
   compacted path's tile and batch widths, then at the batch width plus
   one cell, with operands at odd element offsets and with the compacted
   solve's packed carry, the kernel reading dt from a 0-d float64 tensor
   on the card as every solve passes it, and dom, chunit and k27 from
   the call's scalar block on the card; masks and counters must be
   identical and every float output bit-identical (max rel 0); the
   median device time of 20 bare kernel launches and of 20 twin calls,
   each after an L2 flush, beside the launch's bound (its bytes at 3.35
   TB/s);
2b. the same check for every network configuration the
   kernel takes (primordial_chemistry 0-3, with and without dust, both
   deuterium updates, compensated_sums, radiative transfer with and
   without radiative_transfer_hydrogen_only, tabulated mode with the
   UVB) at 4,096 cells, subcycles 0 and 6;
2c. the Cloudy kernels (csrc/cloudy_interp.cu) against their twins, bit
   for bit, f64 and f32: the tabulated mu fixed point (imetal 0 and 1, on
   the table's mmw and on a zigzag mmw that leaves about half of the
   cells at TI_MAX) and the new-style Cloudy cooling (icmbTfloor, iClHeat
   and iZscale each on and off) on rank 1, 2 and 3 tables, rank 3 below
   its first redshift, between two, on a node, at its second-to-last and
   past its last, at 1, 4,096 and 262,144 cells whose n_H and T lie past
   both edges of the grid; the Cloudy launches of every subcycle body of
   an eager and a capturing stateful call (3 a tabulated body, 1 a
   flagship body) with no interpolate_3dz on the card; a fixed-point and
   a cooling call whose input requires grad, each one launch with the
   twin's gradient; tabulated stateful calls replayed at changing
   a_values (across the table's redshift edges), each bit-identical to
   the uncached body, with 3 Cloudy launches run a subcycle;
2d. the dust temperature kernel (csrc/dust_temp.cu) against its twin,
   bit for bit, f64 and f32: on the dust inputs of the first subcycle
   (a cold start) and of subcycle 24 (warm) of the first state of the
   benchmark cell chem3_dust.grid1m's pool, at 4,096, 81,920 and
   1,048,576 cells, and without the warm start; a call whose input
   requires grad (one launch, the twin's gradient); the flagship's
   stateful calls at 4,096 cells, one dust launch a subcycle body and a
   subcycle run, 1 to 3 dust nodes in the captured body, replays at
   changing a_values bit-identical to the uncached body; the bare
   launch's device time beside its bound and the captured twin's replay
   time;
2e. the rate lookup kernel (csrc/rate_lookup.cu) against its twin
   (lookup_cool_rates, then the H2-equilibrium limit), bit for bit, f64
   and f32: on the lookups of the first subcycle and of a later one of a
   12-species state with dust, metal cooling and the UVB at 4,096 cells,
   a quarter of them moved to the rarer branches, under every
   combination of chemistry 1 to 3, dust on and off, three_body_rate 0
   and 1, H2_self_shielding 0 to 3, H2_custom_shielding, the four
   self_shielding_method values and radiative transfer on and off; at
   the main path's widths (4,096, 81,920 and 1,048,576 cells), the
   lookups of the first subcycle and of a later one of the first pool
   states of the benchmark cells chem3_dust.grid1m and
   chem2_uvb_shield.grid1m_z3 under their own flags; a
   call whose input requires grad (one launch, the twin's gradient); the
   stateful calls of the benchmark cell chem2_uvb_shield.grid1m_z3's
   configuration at 4,096 cells, one rate launch a subcycle body and a
   subcycle run, the launch and its replay count the captured body's
   only rate nodes, replays at
   a_values with other photo rates bit-identical to the uncached body;
   the bare launch's device time at 81,920 and 1,048,576 cells of
   chem3_dust.grid1m's later subcycle beside its bound and the captured
   twin's replay time;
3. stored answers: every workload of tests/answer_workloads.py but
   rate_tables (tabulated, 6species, 9species_shield, 12species_dust on
   32 cells; grid_full on its 32^3 grid with ghost zones), every key,
   against tests/answers/*.npz at rtol 1e-6; then the functional_jit
   example (setup_fluid_container and the functional closures, one step
   of FUNCTIONAL_JIT_SUBCYCLES subcycles) and the old-style rank-4
   cooling time, each against the port's CPU run at rtol 1e-6;
4. flagship at the default solver_compaction (the compacted path), three
   stateful calls of one context (eager, capturing, replayed), each
   bit-identical to the first: the replay's wall seconds (the others'
   beside it), cells/s, outer trips, subcycles, converged share, peak
   CUDA memory, and kernel launches (the replay's, which must equal the
   subcycles run over every warm tile and trip), at precision 64 and 32;
4b. one monolithic f64 flagship solve, the uncached body: its fields and
   per-cell subcycle counts must be bit-identical to phase 4's replayed
   compacted f64 solve;
4c. exact-integration tabulated cooling at 1,048,576 cells, f64 and f32,
   three stateful calls (eager, capturing, replayed; the replay timed):
   cells/s, the eager call's peak memory, the graph's pool and no kernel
   launch, against the uncached subcycled tabulated solve and on its
   first 4,096 cells against the CPU;
4d. functional.make_solve_fn on the f64 flagship, bit-identical to phase
   4's solve, one kernel launch a subcycle;
4e. old-style rank-5 Cloudy metal cooling with primordial_chemistry 1 at
   1,048,576 cells, f64: wall seconds, launches, converged share, and its
   first 4,096 cells against the CPU at rtol 1e-6;
4f. serialization: phase 4's f64 ChemistryData through to_dict, JSON and
   from_dict on the card, the restored solve bit-identical to phase 4's
   with as many launches;
4g. parallel: the f64 flagship on four shards of the card
   (solve_chemistry_sharded, each shard on its compacted path),
   bit-identical to phase 4b; a one-rank NCCL group
   (initialize_distributed) with one all_reduce, in a child process;
4h. the Python examples (grackle_tpu_torch/examples): cooling_rate with
   chemistry 0-3 and both freefall runs in full, cooling_cell over its
   first COOLING_CELL_STEPS steps, against tests/answers/examples at rtol
   1e-6, with wall seconds and seconds a step (their steps replay graphs
   after the first two of a width; each line counts the kinds of call);
4i. the C ABI: the port's libgrackle_tpu.so built with g++, the unedited
   C examples linked against it and run on the card and on the CPU: the
   success marker, the same printed values, and kernel launches on the
   card;
4j. grackle data files: each committed HDF5 fixture of tests/data/h5
   read by data/h5read.py (numpy and zlib; the card's machine has no
   h5py) with its read time, every table and attribute of
   synthetic_gz.h5 bit-identical to the synthetic tables in memory (the
   old-style rank-4 file likewise, latest_small.h5 to what its script
   wrote); the monolithic f64 flagship initialized from synthetic_gz.h5,
   bit-identical to phase 4b; the cooling_rate example (chemistry 1)
   with GRACKLE_DATA_FILE naming the fixture, against its stored answer;
4k. the remaining host programs: the f64 and the float library built,
   cxx_example, cxx_grid_example (with a new-style data file the port's
   writer wrote, data/synthetic.make_synthetic_data_file), cxx_omp_example
   (g++ -fopenmp), dynamic_api_example and c_example against the float
   library, each run on the card and on the CPU as its own process: the
   success marker, the same standard output, and on the card a kernel
   launch in every host that solves; fortran_example.f90 with the
   port's generated module where gfortran is on PATH (a line says so
   where it is not);
4l. data files written by the port (data/h5write.py, no h5py): the
   new-style synthetic file and the old-style rank-4 and rank-5 files
   written into a temporary directory, with each write's seconds and
   bytes, each read back by data/h5read.py bit-identical to the tables
   in memory; the monolithic f64 flagship initialized from the written
   new-style file, bit-identical to phase 4b; phase 4e's old-style
   rank-5 chemistry-1 solve from the written rank-5 file, bit-identical
   to phase 4e's from memory;
4m. the solve as one device program: the loop-control kernel
   (csrc/graph_loop.cu) against its plain predicate on masks up to the
   flagship's width, toy WHILE nodes that must run exactly their
   iterations, and its time a launch inside a WHILE node;
   then make_solve_fn captured into a torch.cuda.CUDAGraph under
   set_sync_debug_mode("error") and replayed, each replay bit-identical
   to the eager solve (fields, cell_iterations, converged, subcycles):
   the f64 flagship on the compacted path (after one eager warm-up of
   the closure), the same graph with dt = DT_SECOND copied into its dt,
   STEPS_GRAPH steps and an energy floor in one graph at N_STEPS_GRAPH
   cells, then that graph and a one-step graph of another state replayed
   at the same time on two streams (each bit-identical to its eager
   solve), the f32 flagship, the monolithic f64 flagship, phase 4c's
   chemistry-0 tabulated state and one cooling_cell step of one cell;
   make_cooling_time_fn and make_dust_temperature_fn on the f64
   flagship state, captured and replayed bit-identical to their eager
   calls; each run's line gives capture, end-and-instantiate and replay
   seconds (median of REPLAYS), node count (the graph's own and every
   WHILE body's) and the graph's and its loop bodies' pool bytes; last,
   the loop-body pools left once every graph is deleted (none);
4n. the stateful API replayed (graph_cache.py): for each entry, the
   eager first call, the capturing second call and replays with new
   inputs and a new dt, each bit-identical to the uncached body on the
   same inputs (fields, cell_iterations, converged, subcycles), one
   kernel launch a subcycle, the previous call's returned tensors
   unchanged, the cache within its bound, and a call at a changed
   a_value a replay under the same key, bit-identical to the uncached
   body at that a_value (the unit scalars and photo rates reach the
   graph as the call's scalar block):
   the f64 flagship (compacted) and exact cooling at 1,048,576 cells,
   4e's old-style rank-5 chemistry 1, solve_chemistry_grid with
   chemistry 2, the UVB and H2 self-shielding 1 on phase 3's grid, the
   five calculate_* on the flagship state, CELL_STEPS cooling_cell steps
   of one cell (then more widths than the bound holds, then a host
   cycling through the CYCLE_WIDTHS for CYCLE_ROUNDS rounds, its
   per-call wall beside the uncached body's), and the flagship on four
   shards; per kind of call its wall seconds, per capture the graph's
   nodes and pools; a cosmological host, the f64 flagship replayed at
   each of COSMO_A_VALUES and the UVB grid at each of UVB_A_VALUES
   (across the UVB's switch-on, each against the uncached body), each
   call's kind and wall; the scalar block's host work and copy timed;
   a host holding all of the card but a little, under which a key's
   second call stays eager, then captures once the memory is let go;
   no loop-body pool left after;
5. the launch the kernel line reports (f64, subcycle 24, the batch
   width), timed again with CUDA events and by torch.profiler's kernel
   duration.  It runs last because a profiler session slows every later
   launch of the process, and with it phases 3 to 4e.

Each phase prints one line (4m and 4n one for each run).  Then one JSON
line lists the kernels (the network, the Cloudy, the dust and the rate
kernels' launches are the sums over the runs of phases 4 f64, 4d, 4e,
4f, 4g, 4h, 4i, 4j, 4k, 4l and 4n's stateful calls, each counted from 0
just before it, and 4m's replays: an eager launch counted on the host, a
launch recorded into a graph counted on the card at every replay by a
node beside it (ops/kernel_lib.count_replays), a host program of 4i or
4k counting its network launches through GRACKLE_TPU_TORCH_LAUNCH_LOG;
each solve of these runs one rate launch a subcycle at chemistry 1 to 3
and none at chemistry 0; phases 2 to 2e's direct calls are not counted;
the loop kernel's are 4m's and 4n's replays' launches, which it counts
on the device), and
the last line is ``{"ok": true, "device": {...}}``.  Any failed phase makes the
script exit non-zero without that line; so does a machine without CUDA or
a directory without the grackle_tpu_torch package.  It imports neither
jax nor grackle_tpu.

    python3 chip_smoke.py --cooling-cell-full

runs, instead of the phases, phases 0 and 1 and then the cooling_cell
example on the card in full (all 28,443 steps of its stored trajectory,
about 1,000 s) against every array of tests/answers/examples/
cooling_cell.npz at rtol 1e-6; its last line is a JSON object
``{"cooling_cell_full": {...}}`` with the steps, the wall, the kinds of
call and the worst relative error, and it exits 0 only where every array
holds.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

from portbench.yardstick.peaks import HBM_BYTES_PER_S

REPO = os.path.dirname(os.path.abspath(__file__))
#: the kernel libraries' names (ops/kernel_lib.Library.what): the keys of
#: launches_run()
NETWORK, CLOUDY, DUST = "network kernel", "Cloudy kernel", "dust kernel"
RATES = "rate kernel"
N_FLAGSHIP = 1_048_576
DT_FLAGSHIP = 1.0e-4
CAPTURE_AT = (0, 24)  # subcycles whose network inputs phase 2 replays
N_CONFIGS = 4096  # cells of phase 2b's per-configuration checks
TIMING_REPS = 20
#: bytes zeroed before each timed launch: five times the H100's 50 MB L2
FLUSH_BYTES = 256 * 2**20
#: the least time of one network launch: its bytes at HBM_BYTES_PER_S
#: (the published 3.35 TB/s of an H100 SXM), or its arithmetic at the
#: card's rate of floating-point instructions.  OPS_PER_CELL is, per
#: element size, the
#: add, multiply, FMA and compare instructions of that type in the
#: kernel's sm_90a code, a static count (scripts/time_kernels.py, from
#: `cuobjdump -sass`): the body has no loops, so it is about what a cell
#: runs, with the branches of other configurations in it.  The published
#: 34 TFLOP/s of float64 outside the tensor cores (67 in float32) count
#: an FMA as two operations: half of it is the rate of instructions
OPS_PER_CELL = {8: 971, 4: 858}
PEAK_OPS_PER_S = {8: 17.0e12, 4: 33.5e12}
#: the kernel runs its twin's IEEE operations in the same order: every
#: float output must be bit-identical, in f32 and f64
KERNEL_RTOL = 0.0
ANSWER_RTOL = 1.0e-6
#: phase 2c: the Cloudy kernels' widths; the redshift and density
#: indices at which its rank-2 and rank-1 tables are cut from the rank-3
#: ones; the cells of its tabulated stateful calls and their a_values
#: (eager and capturing at the first, then replays: z = 2.3, -0.2, 9.5
#: and 12, the last two past the second-to-last table redshift)
CLOUDY_WIDTHS = (1, 4096, 262_144)
CLOUDY_SLICE = (3, 12)
N_CLOUDY_STATE = 4096
CLOUDY_A_VALUES = (1.0, 1.0, 1 / 3.3, 1.25, 1 / 10.5, 1 / 13.0)
#: phase 2d: the dust kernel's widths, the subcycles whose dust inputs it
#: replays (the first, a cold start, and a later, warm one), the
#: benchmark cell whose state pool it draws them from and the pool's seed
DUST_WIDTHS = (4096, 81_920, N_FLAGSHIP)
DUST_AT = (0, 24)
DUST_CELL = "chem3_dust.grid1m"
DUST_SEED = 2**31 + 101
#: phase 2d: the a_values of its stateful replays (the CMB temperature
#: the kernel reads from the call's scalar block changes with them)
DUST_A_VALUES = (1.0, 1.0, 0.5, 0.25)
#: phase 2e: the rate kernel's flags, every value of each branch of its
#: twin; the kernel is held to the twin on every combination of them
RATE_FLAGS = {
    "primordial_chemistry": (1, 2, 3),
    "dust_chemistry": (0, 1),
    "three_body_rate": (0, 1),
    "H2_self_shielding": (0, 1, 2, 3),
    "H2_custom_shielding": (0, 1),
    "self_shielding_method": (0, 1, 2, 3),
    "use_radiative_transfer": (0, 1),
}
#: phase 2e: the cells of its state, the subcycles whose rate lookups it
#: records, the benchmark cell of its stateful replays (the shielding's
#: photo rates change with a_value) and their a_values
N_RATE_CELLS = 4096
RATE_AT = (0, 5)
SHIELD_CELL = "chem2_uvb_shield.grid1m_z3"
SHIELD_SEED = 2**31 + 103
RATE_A_VALUES = (0.25, 0.25, 0.2, 0.3)
#: phase 2e: the main path's widths (a tile, a compacted batch, the
#: flagship), the benchmark cells at whose first pool states it holds
#: the kernel to its twin under their own flags, and the subcycles of
#: those states whose rate lookups it records
RATE_WIDTHS = (4096, 81_920, N_FLAGSHIP)
RATE_CELLS = ((DUST_CELL, DUST_SEED), (SHIELD_CELL, SHIELD_SEED))
RATE_CELL_AT = (0, 24)
#: phase 4c: the dt of tests/test_exact_cooling.py's exact-vs-subcycled
#: check, where the subcycled solve takes a handful of accurate steps, and
#: its bounds on the relative energy difference (test_exact_cooling.py:
#: 137-141), set on 256 cells.  The median bound holds over every cell.
#: Over a million cells the max is set by the subcycled solve's own step
#: error in the densest cells near 3e4 K, which cool by a fifth within
#: dt: the EXACT_TAIL cells furthest apart are solved again on the CPU in
#: EXACT_REFINE_STEPS substeps, and there the exact step must be within
#: the max bound of that refined solve (the subcycled one is further off).
DT_EXACT = 3.0e-5
EXACT_VS_SUBCYCLED = {"max": 2.0e-2, "median": 5.0e-3}
EXACT_TAIL = 64
EXACT_REFINE_STEPS = 300
#: cells of each card solve that phases 4c and 4e run again on the CPU
N_CPU_CHECK = 4096
#: phase 4g: the flagship cut into this many shards on one card
N_SHARDS = 4
#: phase 4h: the steps of the cooling_cell example's stored trajectory
#: (28,443 in all) run on the card, chosen from its measured step time
COOLING_CELL_STEPS = 500
#: phase 4m: the second timestep a graph replays with; the cells and
#: steps of the graph that holds several steps and the caller's energy
#: floor; replays timed per graph (median) and for the one-cell step
DT_SECOND = 2.0e-4
N_STEPS_GRAPH = 65536
STEPS_GRAPH = 3
ENERGY_FLOOR = 0.5
REPLAYS = 3
CELL_REPLAYS = 20
#: phase 4n: the kinds of a stateful call, in the order a key meets them
#: (graph_cache.py); the dt of the new inputs each entry replays with;
#: the a_value that makes each entry's key new; the cooling_cell steps
CALL_KINDS = ("eager", "capture", "replay")
#: the device the stateful calls' graphs are held on, as graph_cache
#: names it
CARD_DEVICE = "cuda:0"
DT_REPLAY = 5.0e-5
A_VALUE_CHANGED = 0.5
CELL_STEPS = 100
#: phase 4n: the dt of a solve entry's replay on the changed a_value: a
#: short step runs few subcycles, so the uncached reference it is held
#: to (an eager solve) stays short at 1,048,576 cells
DT_CHANGED_A = 1.0e-8
#: phase 4n: a cosmological host's a_values (z = 1 to 0.89), one call
#: each at DT_REPLAY on the f64 flagship; and those of the UVB grid
#: entry, across the synthetic UVB's switch-on at z = 10 (z = 11 and
#: 10.5, the rates 0; z = 9.5 and 3)
COSMO_A_VALUES = (0.50, 0.51, 0.52, 0.53)
UVB_A_VALUES = (1 / 12, 1 / 11.5, 1 / 10.5, 1 / 4)
#: phase 4n: calls timed of the scalar block's host work and copy
COPY_IN_CALLS = 200
#: phase 4n: the patch widths (cubes of 8 to 22 cells a side, as an AMR
#: host's grids) a host cycles through, more than the card's bound on
#: graphs, and the rounds of the cycle
CYCLE_WIDTHS = tuple(side**3 for side in range(8, 24, 2))
CYCLE_ROUNDS = 4
#: phase 4m: the loop-control kernel's checks: mask widths (one at an odd
#: byte offset) and (step, advance, cap) triples
LOOP_WIDTHS = (1, 17, 4099, N_FLAGSHIP)
LOOP_STEPS = ((0, 0, 10), (7, 8, 16), (8, 8, 16), (3, 1, 3), (0, 4, 2**62))
#: phase 4m: WHILE iterations timed for the loop kernel's time a launch
LOOP_TIMED = 1000
#: phase 4i: the C examples, their success markers and extra cflags
C_EXAMPLES = [
    ("c_example.c", "C_EXAMPLE_SUCCESS", ()),
    ("c_legacy_api_example.c", "C_LEGACY_EXAMPLE_SUCCESS",
     ("-Wno-deprecated-declarations",)),
]
#: phase 4j: the committed HDF5 fixtures (scripts/make_h5_fixtures.py)
H5_FIXTURES = os.path.join(REPO, "tests", "data", "h5")
#: phase 4k: the host programs of examples/: source, success marker,
#: compiler flags, gr_float bytes of the library it links, arguments
#: ("{data_file}": a new-style data file the port's writer wrote)
HOSTS = [
    ("cxx_example.cpp", "CXX_EXAMPLE_SUCCESS", (), 8, ()),
    ("cxx_grid_example.cpp", "CXX_GRID_EXAMPLE_SUCCESS", (), 8,
     ("{data_file}",)),
    ("cxx_omp_example.cpp", "CXX_OMP_EXAMPLE_SUCCESS", ("-fopenmp",), 8,
     ()),
    ("dynamic_api_example.c", "DYNAPI_EXAMPLE_SUCCESS", (), 8, ()),
    ("c_example.c", "C_EXAMPLE_SUCCESS", ("-DGRACKLE_FLOAT_4",), 4, ()),
]
#: the exact step on the card against the CPU, by element size.  In f64
#: the two builds' log, exp, pow and prefix sums differ by ulps, which
#: the closed form carries through.  In f32 the step's Y(e0) - dt cancels
#: about three of the seven digits in those dense cells, so two f32
#: builds differ as much as the f32 step differs from the f64 one; phase
#: 4c holds that difference to the same bound
EXACT_CPU_RTOL = {8: 1.0e-9, 4: 1.0e-2}


def _units(cd):
    from grackle_tpu_torch.utilities.physical_constants import (
        mass_hydrogen_cgs,
    )

    cd.density_units = mass_hydrogen_cgs
    cd.length_units = 3.0857e21
    cd.time_units = 3.1556952e13


def flagship_chem(precision, device, **kw):
    """BASELINE config 4: 12 species, dust, metal cooling, CMB floor, with
    the synthetic Cloudy tables built in memory (or read from the file
    ``kw`` names as ``grackle_data_file``), at the default
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
    cd.initialize(device=device, cloudy_data=(
        None if cd.grackle_data_file else synthetic_cloudy_groups()))
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


def answer_chem(device, cloudy_data=None, **kw):
    """tests/answer_workloads._base_chem on the port (on ``cloudy_data``,
    by default the synthetic Cloudy groups, where it reads tables)."""
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
    if reads_tables and cloudy_data is None:
        cloudy_data = synthetic_cloudy_groups()
    cd.initialize(device=device,
                  cloudy_data=cloudy_data if reads_tables else None)
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
    f, sl = grid_fields(cd, shape, start, end, seed)
    return cd, f, sl


def grid_fields(cd, shape=GRID_SHAPE, start=GRID_START, end=GRID_END,
                seed=11):
    """The grid state of grid_full_setup for ``cd``'s fields (its
    species, the metal and heating-rate fields it reads): (fields,
    active-region slice)."""
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
    drop = []
    if cd.primordial_chemistry < 2:
        drop += ["HM", "H2I", "H2II"]
    if cd.primordial_chemistry < 3:
        drop += ["DI", "DII", "HDI"]
    if not cd.metal_cooling:
        drop.append("metal")
    if not cd.use_volumetric_heating_rate:
        drop.append("volumetric_heating_rate")
    if not cd.use_specific_heating_rate:
        drop.append("specific_heating_rate")
    for name in drop:
        del f[name]
    return f, sl


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


#: examples/functional_jit.py's step (Myr).  Its stored answer
#: (tests/answers/examples/functional_jit.npz, 8 steps) runs every cell
#: into the 10,000-subcycle cap near the CMB temperature, where the JAX
#: package's own answer moves by 29% when its input energy moves by 1e-15
#: (scripts/functional_jit_sensitivity.py).  No other build reproduces it
#: at rtol 1e-6, so the port is held to the JAX closures, and on the card
#: to its CPU run, over the first FUNCTIONAL_JIT_SUBCYCLES subcycles of
#: one step, where both trajectories still agree to f64 rounding.
FUNCTIONAL_JIT_DT = 1.0
FUNCTIONAL_JIT_SUBCYCLES = 300


def functional_jit_chem(module, max_iterations=None):
    """examples/functional_jit.py's chemistry_data, not yet initialized:
    6 species with metal cooling in Mpc/Myr units.  ``module`` is the
    package that provides ``chemistry_data`` (the port here; the tests
    pass the JAX package too)."""
    from grackle_tpu_torch.utilities.physical_constants import (
        cm_per_mpc, mass_hydrogen_cgs, sec_per_Myr)

    my_chemistry = module.chemistry_data()
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
    return my_chemistry


def functional_jit_answer(device, steps=1,
                          max_iterations=FUNCTIONAL_JIT_SUBCYCLES):
    """examples/functional_jit.py on the port
    (grackle_tpu_torch/examples/functional_jit.run): 64 cells of constant
    density from setup_fluid_container, evolved ``steps`` steps by a
    Python loop over functional.make_solve_fn, with the temperature
    closure after each step (the example's lax.scan body), each step
    capped at ``max_iterations`` subcycles (None: the default 10,000)."""
    from grackle_tpu_torch.data.synthetic import synthetic_cloudy_groups
    from grackle_tpu_torch.examples import functional_jit

    out = functional_jit.run(steps, FUNCTIONAL_JIT_DT, device=device,
                             cloudy_data=synthetic_cloudy_groups(),
                             max_iterations=max_iterations)
    del out["n_iterations"]
    return out


def refined_tabulated_energy(fields, dt, steps=EXACT_REFINE_STEPS):
    """The energy after dt of the subcycled tabulated solve (metal
    cooling, f64, on the CPU) taken in ``steps`` equal substeps: an
    accurate reference for the exact step."""
    cd = answer_chem("cpu", primordial_chemistry=0, metal_cooling=1)
    f = {k: _numpy(v) for k, v in fields.items()}
    for _ in range(steps):
        f["energy"] = cd.solve_chemistry(f, dt / steps)[0]["energy"].numpy()
    return f["energy"]


def old_style_chem(device, rank, data_file=None):
    """tests/test_old_style_tables.py's chemistry: 6 species with metal
    cooling from a legacy rank-4 or rank-5 Cloudy table, built in memory
    (data/synthetic.synthetic_old_style_groups) or read from
    ``data_file``."""
    from grackle_tpu_torch.api import ChemistryData
    from grackle_tpu_torch.data.synthetic import synthetic_old_style_groups

    cd = ChemistryData()
    cd.use_grackle = 1
    cd.with_radiative_cooling = 1
    cd.primordial_chemistry = 1
    cd.metal_cooling = 1
    _units(cd)
    if data_file is None:
        cd.initialize(device=device,
                      cloudy_data=synthetic_old_style_groups(rank))
    else:
        cd.grackle_data_file = data_file
        cd.initialize(device=device)
    return cd


def old_style_state(cd, zfrac, n=12):
    """tests/test_old_style_tables.py's state: density 10, half-ionized
    hydrogen, metal fraction ``zfrac``, T from 10^4.3 to 10^6 K."""
    from grackle_tpu_torch.fluid_container import FluidContainer

    fc = FluidContainer(cd, n)
    fc["density"][:] = 10.0
    fc["HII"][:] = 0.5 * 0.76 * fc["density"]
    fc["HI"][:] = 0.5 * 0.76 * fc["density"]
    fc["HeI"][:] = 0.24 * fc["density"]
    fc["HeII"][:] = 1e-20
    fc["HeIII"][:] = 1e-20
    fc["de"][:] = fc["HII"]
    fc["metal"][:] = zfrac * fc["density"]
    fc.calculate_mean_molecular_weight()
    fc["energy"] = (np.logspace(4.3, 6, n) / cd.temperature_units
                    / fc["mu"] / (cd.Gamma - 1.0))
    return fc._solver_fields()


def tabulated_state(cd, n, metal=True, seed=9):
    """tests/test_exact_cooling._tab_setup's state: tabulated mode, with
    metal unless ``metal`` is false, density 0.1 to 100, T from 10^4.5 to
    10^7.5 K at mu 0.6."""
    rng = np.random.RandomState(seed)
    f = {"density": 10.0 ** rng.uniform(-1, 2, n)}
    if metal:
        f["metal"] = 1.0e-3 * f["density"]
    T = 10.0 ** rng.uniform(4.5, 7.5, n)
    f["energy"] = T / cd.temperature_units / 0.6 / (cd.Gamma - 1.0)
    return f


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


def _numpy(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _same_bits(got, want, where):
    got, want = np.asarray(got), np.asarray(want)
    if (got.shape != want.shape or got.dtype != want.dtype
            or got.tobytes() != want.tobytes()):
        raise AssertionError(f"{where}: {got.dtype}{got.shape} differs "
                             f"from {want.dtype}{want.shape}")


def file_vs_groups(path, groups):
    """Every table and attribute of a grackle data file, read by
    data/h5read.py, against the in-memory groups of data/synthetic.py
    (``synthetic_cloudy_groups()`` or ``synthetic_old_style_groups()``):
    the same names, and each value bit for bit (``Info`` is bytes in
    the file, str in memory).  Returns the count of values compared."""
    from grackle_tpu_torch.data import h5read

    count = 0
    with h5read.File(path) as f:
        top = sorted(k for k in groups if k == "old_style")
        if sorted(f.attrs) != top:
            raise AssertionError(f"file attributes {sorted(f.attrs)}")
        for key in top:
            _same_bits(f.attrs[key], groups[key], key)
            count += 1
        tables = sorted(k for k in groups if k in ("Primordial", "Metals"))
        if f["CoolingRates"].keys() != tables:
            raise AssertionError(f"CoolingRates {f['CoolingRates'].keys()}")
        for name in tables:
            mem = groups[name]
            data = [k for k in ("Cooling", "Heating", "MMW") if k in mem]
            group = f[f"/CoolingRates/{name}"]
            if group.keys() != sorted(data):
                raise AssertionError(f"{name}: {group.keys()}")
            for dname in data:
                dset = group[dname]
                _same_bits(dset[...], mem[dname], f"{name}/{dname}")
                attrs = dset.attrs
                names = sorted(k for k in mem if k not in data)
                if sorted(attrs) != names:
                    raise AssertionError(f"{name}/{dname} attributes "
                                         f"{sorted(attrs)}")
                for key in names:
                    _same_bits(attrs[key], mem[key], f"{name}/{dname}@{key}")
                count += 1 + len(names)

        def walk(group, mem, where):
            nonlocal count
            if group.keys() != sorted(mem):
                raise AssertionError(f"{where}: {group.keys()}")
            for key, val in mem.items():
                if isinstance(val, dict):
                    walk(group[key], val, f"{where}/{key}")
                elif key == "Info":
                    if bytes(group[key][()]).decode() != val:
                        raise AssertionError(f"{where}/Info differs")
                else:
                    _same_bits(group[key][...], val, f"{where}/{key}")
                count += 1

        if "UVBRates" in groups:
            walk(f["UVBRates"], groups["UVBRates"], "UVBRates")
        elif "UVBRates" in f:
            raise AssertionError("the file has UVBRates, memory has none")
    return count


def run_host(exe, device, work, args=()):
    """A host program linked against the port's C library, run in
    ``work`` as its own process with GRACKLE_TPU_TORCH_DEVICE=``device``:
    (the completed process, wall seconds, the network kernel launches it
    counted through GRACKLE_TPU_TORCH_LAUNCH_LOG)."""
    from grackle_tpu_torch import cshim_build

    log = os.path.join(work, "launches")
    if os.path.exists(log):
        os.remove(log)
    env = cshim_build.run_env(device)
    env["GRACKLE_TPU_TORCH_LAUNCH_LOG"] = log
    t0 = time.time()
    res = subprocess.run([exe, *args], capture_output=True, text=True,
                         timeout=300, env=env, cwd=work)
    wall = time.time() - t0
    launches = 0
    if os.path.exists(log):
        with open(log) as fh:
            launches = int(fh.read())
    return res, wall, launches


def latest_small_content():
    """What scripts/make_h5_fixtures.py writes into latest_small.h5, as
    {"path": value, "path@attribute": value}; read back, each value's
    dtype is the native-order one."""
    return {
        "/@old_style": np.int64(1),
        "/@title": "h5read fixture",
        "/@grid": np.linspace(0.0, 1.0, 5),
        "/Tables@Rank": np.int32(2),
        "/Tables/contiguous": np.arange(24.0).reshape(4, 6),
        "/Tables/contiguous@Dimension": np.array([4, 6], dtype=np.int64),
        "/Tables/contiguous@units": np.bytes_("erg/s"),
        "/Tables/compact": np.arange(7, dtype="<i4") - 3,
        "/Tables/big_endian": np.linspace(-2.0, 2.0, 9).astype("=f4"),
        "/Info": np.bytes_("fixed-length info"),
        "/VlenInfo": b"variable-length info",
    }


def read_whole(path):
    """Every dataset and attribute of an HDF5 file through
    data/h5read.py; returns the count of values read."""
    from grackle_tpu_torch.data import h5read

    count = 0

    def walk(obj):
        nonlocal count
        count += len(obj.attrs)
        if isinstance(obj, h5read.Group):
            for _, item in obj.items():
                walk(item)
        else:
            obj[()]
            count += 1

    with h5read.File(path) as f:
        walk(f)
    return count


def latest_vs_content(path):
    """latest_small.h5 through data/h5read.py against
    latest_small_content(), bit for bit; returns the count compared."""
    from grackle_tpu_torch.data import h5read

    want = latest_small_content()
    with h5read.File(path) as f:
        for key, val in want.items():
            where, _, attr = key.partition("@")
            obj = f[where]
            got = obj.attrs[attr] if attr else obj[()]
            if isinstance(val, (str, bytes)):
                if type(got) is not type(val) or got != val:
                    raise AssertionError(f"{key}: {got!r}")
            else:
                _same_bits(got, val, key)
    return len(want)


def max_rel(got, want):
    """The largest relative difference of ``got`` from ``want`` (arrays
    or tensors on any device)."""
    got, want = _numpy(got), _numpy(want)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def answer_errors(name, out, steps=None):
    """Per-key max relative error of one workload's outputs against its
    stored answer tests/answers/<name>.npz (``name`` may be
    "examples/<tag>"), or against its first ``steps`` records; where a
    stored value is 0, the absolute error.  Raises unless the keys are
    the stored ones and every output is finite and of the stored
    shape."""
    stored = np.load(os.path.join(REPO, "tests", "answers", f"{name}.npz"))
    if sorted(out) != sorted(stored.files):
        raise AssertionError(f"{name}: keys {sorted(out)} != stored "
                             f"{sorted(stored.files)}")
    errors = {}
    for key in stored.files:
        got = _numpy(out[key])
        want = stored[key] if steps is None else stored[key][:steps]
        if got.shape != want.shape or not np.all(np.isfinite(got)):
            raise AssertionError(f"{name}/{key}: bad output")
        diff = np.abs(got - want)
        errors[key] = float(np.max(np.where(
            want == 0, diff, diff / np.where(want == 0, 1.0, np.abs(want)))))
    return errors


def bit_differences(new_f, new_d, ref_f, ref_d):
    """The fields (and ``cell_iterations``) in which one solve's result
    is not bit-identical to another's; ["keys"] when their fields
    differ."""
    import torch

    if sorted(new_f) != sorted(ref_f):
        return ["keys"]
    differ = [k for k in ref_f if not torch.equal(new_f[k], ref_f[k])]
    if not torch.equal(new_d["cell_iterations"], ref_d["cell_iterations"]):
        differ.append("cell_iterations")
    return differ


def device_fields(fields, device="cuda"):
    """A field dict as tensors on ``device``: the static inputs a captured
    graph reads."""
    import torch

    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in fields.items()}


def zero_launches():
    """Set every kernel library's launch counts to 0: the host launches
    and, counted on the card, those of graph replays (armed here for the
    graphs captured from now on)."""
    from grackle_tpu_torch.ops import kernel_lib

    kernel_lib.count_replays("cuda")
    kernel_lib.zero_counts()


def launches_run():
    """{NETWORK, CLOUDY, DUST: the launches since zero_launches() that
    ran on the card}: the eager ones and the graph replays' (counted on
    the card, read here)."""
    from grackle_tpu_torch.ops import kernel_lib

    return kernel_lib.executed()


def check_dust_launches(where, cfg, ran, subcycles):
    """Raise unless a solve of ``subcycles`` subcycles under ``cfg`` ran
    one dust launch a subcycle where its cooling solves a dust
    temperature, and none where it does not."""
    from grackle_tpu_torch.config import _anydust

    subcycles = int(subcycles)
    want = subcycles if _anydust(cfg) else 0
    if ran != want:
        raise AssertionError(f"{where}: {ran} dust launches ran for "
                             f"{subcycles} subcycles (want {want})")


def check_rates_launches(where, cfg, ran, subcycles):
    """Raise unless a solve of ``subcycles`` subcycles under ``cfg`` ran
    one rate-lookup launch a subcycle at primordial_chemistry 1 to 3, and
    none at chemistry 0."""
    subcycles = int(subcycles)
    want = subcycles if cfg.primordial_chemistry > 0 else 0
    if ran != want:
        raise AssertionError(f"{where}: {ran} rate-lookup launches ran for "
                             f"{subcycles} subcycles (want {want})")


@contextlib.contextmanager
def uncached():
    """The stateful entry points with their graph cache bypassed, as on
    the CPU: every call runs its body (api.solve_prepared, an ops/derived
    function) eagerly on the inputs it is given.  The eager reference of
    a stateful call."""
    from grackle_tpu_torch import graph_cache

    on_card = graph_cache._on_card
    graph_cache._on_card = lambda device: False
    try:
        yield
    finally:
        graph_cache._on_card = on_card


def stateful_call(graphs, fn, *args, **kw):
    """``fn(*args, **kw)`` on the card, timed to its end: (a Counter of
    the kinds of call the graph cache ``graphs`` made of it, its result,
    wall seconds)."""
    import torch

    torch.cuda.synchronize()
    before = graphs.calls.copy()
    t0 = time.time()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return graphs.calls - before, out, time.time() - t0


def tree_clone(tree):
    """A copy of every tensor and array in a result."""
    import torch

    if isinstance(tree, dict):
        return {k: tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_clone(v) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return tree.copy() if isinstance(tree, np.ndarray) else tree.clone()
    return tree


def tree_differences(got, want, where=""):
    """The places in which two results (dicts, tuples, tensors, arrays,
    numbers) do not hold the same bits."""
    import torch

    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(want):
            return [f"{where}keys"]
        return [d for k in want
                for d in tree_differences(got[k], want[k], f"{where}{k}/")]
    if isinstance(want, (tuple, list)):
        return [d for i, (g, w) in enumerate(zip(got, want))
                for d in tree_differences(g, w, f"{where}{i}/")]
    if isinstance(want, torch.Tensor):
        ok = isinstance(got, torch.Tensor) and (
            same_bits(got, want) if want.is_floating_point()
            else torch.equal(got, want))
    elif isinstance(want, np.ndarray):
        ok = (got.dtype == want.dtype and got.shape == want.shape
              and np.array_equal(got.view(np.uint8), want.view(np.uint8)))
    else:
        ok = got == want
    return [] if ok else [where.rstrip("/") or "value"]


def pool_bytes(pool_id):
    """Bytes the caching allocator holds in the memory pool ``pool_id``
    (its segments), or None where the snapshot does not name pools."""
    import torch

    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(s["total_size"] for s in segs
               if tuple(s["segment_pool_id"]) == tuple(pool_id))


def capture_graph(fn, reps=REPLAYS):
    """``fn()`` captured into a CUDA graph under
    ``torch.cuda.set_sync_debug_mode("error")`` (any synchronisation
    raises), instantiated and replayed ``reps`` times.  Returns (graph,
    fn's outputs, stats): capture, instantiate and median replay seconds,
    the graph's nodes (its own and every WHILE body's) and the bytes of
    the graph's pool and of its loop bodies' pool.  The caller has run
    ``fn`` eagerly first."""
    import torch

    from grackle_tpu_torch.ops import device_loop, graph_loop

    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    device_loop.body_nodes = 0
    pools = set(device_loop._pools)
    with torch.cuda.graph(graph):
        t0 = time.time()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        t1 = time.time()
    t2 = time.time()
    graph.instantiate()
    t3 = time.time()
    nodes = graph_loop.graph_nodes(graph.raw_cuda_graph()) \
        + device_loop.body_nodes
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.time()
        graph.replay()
        torch.cuda.synchronize()
        times.append(time.time() - t)
    body = [p for cid, p in device_loop._pools.items() if cid not in pools]
    stats = dict(capture=t1 - t0, instantiate=t3 - t2 + (t2 - t1),
                 replay=float(np.median(times)), nodes=nodes,
                 pool=pool_bytes(graph.pool()),
                 body_pool=(pool_bytes(body[0].id) if len(body) == 1
                            else 0 if not body else None))
    return graph, out, stats


def capture_measured(body, inputs, stats):
    """graph_cache._capture, timed, under set_sync_debug_mode("error")
    (any synchronisation raises), its graph kept to count the nodes; the
    capture's numbers are appended to ``stats``: capture and
    end-and-instantiate seconds, the graph's nodes (its own and every
    WHILE body's) and the bytes of its pool and its loop bodies' pool."""
    import torch

    from grackle_tpu_torch.ops import device_loop, graph_loop

    graph = torch.cuda.CUDAGraph(keep_graph=True)
    device_loop.body_nodes = 0
    held = set(device_loop._pools)
    t0 = time.time()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        torch.cuda.set_sync_debug_mode("error")
        try:
            outputs = body(inputs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    t1 = time.time()
    graph.instantiate()
    sizes = [pool_bytes(p.id) for cid, p in device_loop._pools.items()
             if cid not in held]
    stats.append(dict(
        capture=t1 - t0, instantiate=time.time() - t1,
        nodes=graph_loop.graph_nodes(graph.raw_cuda_graph())
        + device_loop.body_nodes, pool=pool_bytes(graph.pool()),
        body_pool=None if None in sizes else sum(sizes)))
    return graph, outputs


def graph_stats(stats):
    def gib(b):
        return "not measured" if b is None else f"{b / 2**30:.3f} GiB"

    return (f"capture {stats['capture']:.3f} s, end and instantiate "
            f"{stats['instantiate']:.3f} s, replay {stats['replay']:.4f} s "
            f"(median of its replays), {stats['nodes']} nodes, graph pool "
            f"{gib(stats['pool'])}, loop-body pool {gib(stats['body_pool'])}")


def same_bits(a, b):
    """Whether two float tensors hold the same bits (NaNs included)."""
    import torch

    ints = {torch.float64: torch.int64, torch.float32: torch.int32}
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype])))


def concurrent_replays(pairs, inputs):
    """Replay the graphs of ``pairs`` (graph, its field and diag outputs,
    the eager solve's) at the same time, each on a stream of its own,
    after poisoning every output that shares no memory with the
    ``inputs`` (field dicts and tensors the graphs read); raises unless
    each graph's outputs equal its eager solve's bit for bit.  Returns
    the line."""
    import torch

    def storage(t):
        return t.untyped_storage().data_ptr()

    ptrs = set()
    for item in inputs:
        for t in (item.values() if isinstance(item, dict) else [item]):
            ptrs.add(storage(t))
    for _, out_f, out_d, _, _ in pairs:
        for t in list(out_f.values()) + list(out_d.values()):
            if storage(t) not in ptrs:
                t.fill_(float("nan") if t.is_floating_point() else -1)
    streams = [torch.cuda.Stream() for _ in pairs]
    torch.cuda.synchronize()
    t0 = time.time()
    for stream, (graph, *_) in zip(streams, pairs):
        with torch.cuda.stream(stream):
            graph.replay()
    torch.cuda.synchronize()
    wall = time.time() - t0
    differ = []
    for j, (_, out_f, out_d, ref_f, ref_d) in enumerate(pairs):
        bad = bit_differences(out_f, out_d, ref_f, ref_d)
        if not torch.equal(out_d["converged"], ref_d["converged"]):
            bad.append("converged")
        if int(out_d["subcycles"]) != int(ref_d["subcycles"]):
            bad.append("subcycles")
        differ += [f"graph {j}: {k}" for k in bad]
    msg = (f"{len(pairs)} graphs replayed at once on {len(pairs)} streams: "
           f"{wall:.4f} s together; "
           + ("each bit-identical to its eager solve" if not differ
              else f"DIFFER from their eager solves in {differ}"))
    if differ:
        raise AssertionError(msg)
    return msg


def released_pools(before=(), wait_s=2.0):
    """Once the graphs captured since the loop-body pools ``before`` were
    held are deleted: release their pools and return the line; raises if
    one of them is left after ``wait_s`` seconds (the CUDA driver reports
    a destroyed graph on a thread of its own).  Pools held before, by
    graphs another phase keeps, are not counted."""
    import torch

    from grackle_tpu_torch.ops import device_loop

    def mine():
        return [cid for cid in device_loop._pools if cid not in before]

    held = len(mine())
    torch.cuda.synchronize()
    t0 = time.time()
    while True:
        device_loop.release_pools()
        if not mine() or time.time() - t0 > wait_s:
            break
        time.sleep(0.05)
    torch.cuda.empty_cache()
    left = len(mine())
    msg = (f"loop-body pools: {held} held before the graphs' deletion was "
           f"reported, {left} left after ({time.time() - t0:.3f} s)")
    if left:
        raise AssertionError(msg)
    return msg


#: phase 4g's one-rank NCCL group, run in a process of its own so that
#: a hang ends at its time limit
NCCL_CHILD = """
import socket, sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from grackle_tpu_torch.parallel.distributed import (
    global_cell_mesh, initialize_distributed)
with socket.socket() as s:
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
size, rank = initialize_distributed(f"tcp://localhost:{port}", 1, 0)
mesh = global_cell_mesh()
x = torch.full((4,), 3.0, device=mesh[0])
dist.all_reduce(x)
total = float(x.sum())
backend = dist.get_backend()
dist.destroy_process_group()
assert (size, rank, backend, total) == (1, 0, "nccl", 12.0), (
    size, rank, backend, total)
print(f"NCCL_OK world {size} rank {rank} backend {backend} mesh "
      f"{[str(d) for d in mesh]} all_reduce sum {total}")
"""


def capture_network_inputs(cd, fields, dt, at):
    """Run the solve's subcycles (through the kernel) and keep the
    network region's inputs at each subcycle index in ``at``."""
    captured = []
    eager_subcycles(cd, fields, dt, max(at) + 1, inputs_at=at,
                    captured=captured)
    return captured


def eager_subcycles(cd, fields, dt, steps, inputs_at=(), captured=None):
    """Run the first ``steps`` subcycles of the monolithic solve of
    ``fields`` eagerly; append (step, the network region's inputs) to
    ``captured`` at each step in ``inputs_at``."""
    from grackle_tpu_torch.api import _prep_fields, call_scalars
    from grackle_tpu_torch.ops import solver
    from grackle_tpu_torch.ops.common import block_scalars

    ctx = cd.context
    cfg = ctx.config
    f, imetal = _prep_fields(ctx, fields)
    # the unit scalars and photo rates as a body reads them: 0-d views of
    # the call's scalar block on the fields' device
    us, pr, _ = block_scalars(call_scalars(ctx, f["density"].device))
    f, itmask0 = solver.prepare_fields(cfg, f, us, imetal, False)
    f_state, f_const = solver.split_state(cfg, f)
    carry = solver.init_carry(f_state, itmask0, cfg)
    for step in range(steps):
        inputs = {} if step in inputs_at else None
        carry = solver.subcycle(
            cfg, ctx.tables, ctx.cloudy_primordial, ctx.cloudy_metal, pr,
            us, carry, dt, imetal, ctx.cloudy_data_new, f_const,
            inputs_out=inputs)
        if inputs is not None:
            captured.append((step, inputs))


def cell_chem(name, precision, seed, device="cuda"):
    """The context of the benchmark cell ``name`` (its configuration and
    synthetic tables, at its own a_value) at ``precision``, and the first
    state of the cell's pool drawn with ``seed`` (numpy arrays)."""
    from portbench.harness import run_cell, spec

    cell = spec.cell(name)
    program = run_cell.Program(cell, run_cell.make_groups(cell), device,
                               {"precision": precision})
    return program.cd, run_cell.make_pool(cell, cell.traffic, seed)[0]


def capture_dust_inputs(cd, fields, dt, at=DUST_AT):
    """Run the monolithic solve's first subcycles and keep the dust
    temperature's arguments (ops/cooling.cool1d_multi's call, once a
    subcycle) at each subcycle index in ``at``: [(step, positional
    arguments, tdust_init)], the tensors cloned."""
    import torch

    from grackle_tpu_torch.ops import dust_kernel

    calls = []
    route = dust_kernel.dust_temperature

    def record(*args, tdust_init=None):
        calls.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in (*args, tdust_init)))
        return route(*args, tdust_init=tdust_init)

    dust_kernel.dust_temperature = record
    try:
        eager_subcycles(cd, fields, dt, max(at) + 1)
    finally:
        dust_kernel.dust_temperature = route
    if len(calls) != max(at) + 1:
        raise AssertionError(f"{len(calls)} dust calls in {max(at) + 1} "
                             f"subcycles")
    return [(step, calls[step][:-1], calls[step][-1]) for step in at]


def dust_steps(args, init):
    """(most Newton steps, most bisection steps) that the twin's masked
    sweeps take on the dust call (``args``, ``init``): its loops' own
    step counts, from ops/device_loop.device_while."""
    from grackle_tpu_torch.ops import dust_temp

    counts = []
    loop = dust_temp.device_while

    def counted(*a, **kw):
        out = loop(*a, **kw)
        counts.append(out[1])
        return out

    dust_temp.device_while = counted
    try:
        dust_temp.calc_tdust_1d(*args, tdust_init=init)
    finally:
        dust_temp.device_while = loop
    return tuple(counts)


def rate_chem(precision, device="cuda"):
    """Phase 2e's context: 12 species with dust, metal cooling and the
    UVB (so the photo rates and cross sections the shields read are not
    zero), on the synthetic Cloudy tables, at ``precision``."""
    return answer_chem(device, primordial_chemistry=3, metal_cooling=1,
                       dust_chemistry=1, UVbackground=1, precision=precision)


def rate_state(cd, n, seed=13):
    """Phase 2e's state (numpy arrays): n_H 1e-4 to 1e12 (above and below
    the H2-equilibrium limiter's 1e8), T 10 to 1e8 K, molecular fractions
    1e-8 to 0.3."""
    rng = np.random.RandomState(seed)
    d = 10.0 ** rng.uniform(-4, 12, n)
    fh2 = 10.0 ** rng.uniform(-8, np.log10(0.3), n)
    f = {"density": d, "HI": 0.38 * d * (1.0 - fh2),
         "HII": 0.38 * d * (1.0 - fh2), "HeI": 0.24 * d,
         "HeII": 1.0e-4 * d, "HeIII": 1.0e-4 * d, "HM": 1.0e-12 * d,
         "H2I": 0.76 * d * fh2, "H2II": 1.0e-12 * d,
         "DI": 2.0 * 3.4e-5 * d, "DII": 1.0e-8 * d, "HDI": 1.0e-8 * d,
         "metal": 1.0e-3 * d}
    f["de"] = f["HII"] + f["HeII"] / 4 + f["HeIII"] / 2
    T = 10.0 ** rng.uniform(1, 8, n)
    f["energy"] = T / cd.temperature_units / 0.8 / (cd.Gamma - 1.0)
    return f


def capture_rate_inputs(cd, fields, dt, at=RATE_AT):
    """Run the monolithic solve's first subcycles and keep the rate
    lookup's arguments (ops/rates_kernel.rate_lookup, once a subcycle) at
    each subcycle index in ``at``: [(step, arguments)], the per-cell
    tensors cloned and the cooling's values the lookup reads as a
    namespace."""
    import types

    import torch

    from grackle_tpu_torch.ops import rates_kernel

    calls, kept = [0], []
    route = rates_kernel.rate_lookup

    def record(cfg, tables, pr, us, f, cool, itmask, *rest):
        if calls[0] in at:
            cool_v = types.SimpleNamespace(**{
                k: getattr(cool, k).clone()
                for k in rates_kernel.COOL_SLOTS})
            kept.append((calls[0], (
                cfg, tables, pr, us, {k: v.clone() for k, v in f.items()},
                cool_v, itmask.clone(), *rest)))
        calls[0] += 1
        return route(cfg, tables, pr, us, f, cool, itmask, *rest)

    rates_kernel.rate_lookup = record
    try:
        eager_subcycles(cd, fields, dt, max(at) + 1)
    finally:
        rates_kernel.rate_lookup = route
    if calls[0] != max(at) + 1:
        raise AssertionError(f"{calls[0]} rate lookups in {max(at) + 1} "
                             f"subcycles")
    return kept


def head_rate_args(args, n):
    """A recorded rate lookup's arguments on its first ``n`` cells."""
    import types

    cfg, tables, pr, us, f, cool, itmask, l_h2 = args
    cool = types.SimpleNamespace(**{k: v[:n] for k, v in vars(cool).items()})
    return (cfg, tables, pr, us, {k: v[:n] for k, v in f.items()}, cool,
            itmask[:n], None if l_h2 is None else l_h2[:n])


def rate_cases(args, seed=17):
    """Phase 2e's cases from one recorded rate lookup (``args``): the
    inputs with a quarter of the cells moved to where the twin's rarer
    branches run (net heating, an inactive cell, T outside the table,
    dust above its table's end), the fields that only some options read
    drawn, and then, for every combination of RATE_FLAGS, the
    configuration with those flags: [(flags, arguments)]."""
    import dataclasses
    import itertools
    import types

    import torch

    cfg, tables, pr, us, f, cool, itmask, _ = args
    like = cool.tgas
    n = like.shape[0]
    rng = np.random.RandomState(seed)

    def drawn(lo, hi):
        return torch.as_tensor(10.0 ** rng.uniform(lo, hi, n),
                               dtype=like.dtype, device=like.device)

    i = torch.arange(n, device=like.device)
    cool = types.SimpleNamespace(**vars(cool))
    cool.edot = torch.where(i % 3 == 0, cool.edot.abs(), cool.edot)
    cool.tgas = torch.where(i % 16 == 0, like.new_full(
        (), 0.5 * cfg.TemperatureStart), cool.tgas)
    cool.tgas = torch.where(i % 16 == 8, like.new_full(
        (), 2.0 * cfg.TemperatureEnd), cool.tgas)
    cool.tdust = torch.where(i % 8 == 3, like.new_full(
        (), 2.0 * cfg.DustTemperatureEnd), cool.tdust)
    itmask = itmask & (i % 5 != 4)
    f = dict(f, RT_H2_dissociation_rate=drawn(0, 3),
             H2_self_shielding_length=drawn(-3, 1),
             H2_custom_shielding_factor=drawn(-3, 0))
    l_h2 = drawn(17, 22)
    cases = []
    for values in itertools.product(*RATE_FLAGS.values()):
        flags = dict(zip(RATE_FLAGS, values))
        case = dataclasses.replace(cfg, h2_on_dust=0, **flags)
        cases.append((flags, (case, tables, pr, us, f, cool, itmask,
                              l_h2)))
    return cases


def rate_rows(cfg, out):
    """A rate lookup's result ``(RateState, h2_limit)`` as its rows, in
    the kernel's order (ops/rates_kernel.row_names), then k27."""
    from grackle_tpu_torch.ops import rates_kernel

    rs, h2_limit = out
    return (*rates_kernel.rows_of(cfg, rs, h2_limit), rs.shields["k27"])


def cloudy_tables(cd):
    """Phase 2c's new-style Cloudy tables on ``cd``'s device, in its
    dtype: {rank: (primordial, metals)}.  Rank 3 are the context's (the
    synthetic 25 x 10 x 121 groups, with their heating tables and the
    primordial mmw), rank 2 their slices at redshift index
    CLOUDY_SLICE[0], rank 1 those slices' rows at density index
    CLOUDY_SLICE[1]."""
    import dataclasses

    zs, ns = CLOUDY_SLICE

    def cut(t, rank):
        if rank == 3:
            return t
        index = (slice(None), zs) if rank == 2 else (ns, zs)
        pars = (t.par1, t.par3) if rank == 2 else (t.par3,)
        return dataclasses.replace(
            t, grid_rank=rank, grid_dimension=tuple(p.shape[0] for p in pars),
            par1=pars[0], par2=pars[1] if rank == 2 else None, par3=None,
            **{k: None if getattr(t, k) is None
               else getattr(t, k)[index].contiguous()
               for k in ("cooling", "heating", "mmw")})

    ctx = cd.context
    return {rank: (cut(ctx.cloudy_primordial, rank),
                   cut(ctx.cloudy_metal, rank)) for rank in (1, 2, 3)}


def zigzag_mmw(table):
    """``table`` with a mmw that alternates 0.6, 1.25 from one temperature
    node to the next: the damped fixed point bounces on it, and about
    half of the cells reach TI_MAX unconverged."""
    import dataclasses

    import torch

    n_t = table.grid_dimension[-1]
    zig = torch.where(torch.arange(n_t, device=table.mmw.device) % 2 == 0,
                      0.6, 1.25).to(table.mmw.dtype)
    return dataclasses.replace(
        table, mmw=zig.expand(table.grid_dimension).contiguous())


def cloudy_cells(table, n, us, gamma, seed=5):
    """Phase 2c's cells on ``table``'s device, in its dtype: log10 n_H a
    decade and log10 T half a decade past both edges of the table's axes
    (from -6 to 4 in n_H for rank 1), metal fractions 0 to 0.04 (every
    seventh cell none), mu 0.55 to 1.3 in the energy.  Returns the fixed
    point's d, metal, e, rhoH and the cooling's logtem, rhoH and
    metallicity."""
    import torch

    rng = np.random.default_rng(seed)
    axes = [table.par1, table.par2, table.par3][:table.grid_rank]
    t_lo, t_hi = float(axes[-1][0]), float(axes[-1][-1])
    n_lo, n_hi = ((float(axes[0][0]) - 1.0, float(axes[0][-1]) + 1.0)
                  if table.grid_rank > 1 else (-6.0, 4.0))
    log_t = rng.uniform(t_lo - 0.5, t_hi + 0.5, n)
    z = rng.uniform(0.0, 0.04, n)
    z[::7] = 0.0
    rhoH = 10.0 ** rng.uniform(n_lo, n_hi, n) / float(us.dom)
    d = rhoH / (0.76 * (1.0 - z))
    e = 10.0 ** log_t / ((gamma - 1.0) * rng.uniform(0.55, 1.3, n)
                         * float(us.utem))
    arrays = dict(d=d, metal=z * d, e=e, rhoH=rhoH,
                  logtem=np.log(10.0) * log_t, metallicity=z / 0.01295)
    return {k: torch.as_tensor(v, dtype=table.par1.dtype,
                               device=table.par1.device)
            for k, v in arrays.items()}


def cloudy_redshifts(table):
    """Phase 2c's redshifts of a rank-3 table, named: below its first
    redshift, between two, on a node, at its second-to-last (where the
    2-D fallback starts) and past its last.  Each is a 0-d tensor of the
    table's dtype on its device."""
    import torch

    par2 = table.par2
    d2 = par2.shape[0]

    def full(z):
        return torch.full((), z, dtype=par2.dtype, device=par2.device)

    return [("below the first", full(-0.2)),
            ("between", full(0.5 * float(par2[2] + par2[3]))),
            ("on a node", par2[4].clone()),
            ("at the second-to-last", par2[d2 - 2].clone()),
            ("past the last", full(float(par2[d2 - 1]) + 2.0))]


def cells_at_ti_max(fixed_point, args, metal):
    """The cells with metal that ``fixed_point`` (the kernel or its twin,
    called with ``args`` as ops/tabulated_temp.tabulated_temperature is,
    imetal last) leaves at TI_MAX unconverged: those whose mu the metal
    correction, which applies at convergence, leaves as it was."""
    raw = fixed_point(*args[:-1], False)[1]
    corrected = fixed_point(*args[:-1], True)[1]
    return int(((raw == corrected) & (metal > 0)).sum())


def cloudy_bit_differences(kern, twin):
    """(elements whose bits differ, their largest absolute difference)
    of two tuples of float tensors."""
    import torch

    ints = {torch.float64: torch.int64, torch.float32: torch.int32}
    n, worst = 0, 0.0
    for k, t in zip(kern, twin):
        if k.dtype != t.dtype or k.shape != t.shape:
            raise AssertionError(f"kernel {k.dtype}{tuple(k.shape)} against "
                                 f"twin {t.dtype}{tuple(t.shape)}")
        bad = k.view(ints[k.dtype]) != t.view(ints[t.dtype])
        n += int(bad.sum())
        if bad.any():
            worst = max(worst, float((k - t).abs()[bad].max()))
    return n, worst


def cloudy_launches_per_body(cd, fields, dt, calls=1):
    """Cloudy kernel launches of each subcycle body (ops/solver.subcycle)
    that ``calls`` stateful solves of ``fields`` issue (eager, capturing,
    replayed: a replay runs no Python), and the calls of
    ops/interp.interpolate_3dz on CUDA tensors meanwhile."""
    from grackle_tpu_torch.ops import cloudy_kernel, interp, solver

    per_body, on_card = [], 0
    subcycle, interpolate_3dz = solver.subcycle, interp.interpolate_3dz

    def counted(*args, **kw):
        before = cloudy_kernel.library.issued()
        out = subcycle(*args, **kw)
        per_body.append(cloudy_kernel.library.issued() - before)
        return out

    def watched(x1, *args, **kw):
        nonlocal on_card
        on_card += x1.device.type == "cuda"
        return interpolate_3dz(x1, *args, **kw)

    solver.subcycle, interp.interpolate_3dz = counted, watched
    try:
        for _ in range(calls):
            cd.solve_chemistry(dict(fields), dt)
    finally:
        solver.subcycle, interp.interpolate_3dz = subcycle, interpolate_3dz
    return per_body, on_card


def map_inputs(inp, fn):
    """Captured network inputs with ``fn`` applied to every tensor."""
    import dataclasses

    import torch

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        # a 0-d tensor is a scalar of the call's block (the shields' k27)
        return fn(x) if isinstance(x, torch.Tensor) and x.dim() else x

    out = {k: walk(v) for k, v in inp.items() if k != "rs"}
    rs = inp["rs"]
    out["rs"] = None if rs is None else dataclasses.replace(
        rs, k=walk(rs.k), shields=walk(rs.shields), h2dust=walk(rs.h2dust),
        k13dd=None, ti=None)
    return out


def head_inputs(inp, n):
    """Captured network inputs cut to their first ``n`` cells (each
    tensor a contiguous prefix)."""
    return map_inputs(inp, lambda x: x[:n])


def offset_inputs(inp, n, every=1):
    """Captured network inputs cut to ``n`` cells, every ``every``-th
    tensor handed over as the view ``buf[1:n+1]`` of a buffer one element
    longer: an odd element offset, so that operand's loads are not
    aligned to 16 bytes."""
    import torch

    seen = [0]

    def view(x):
        seen[0] += 1
        if (seen[0] - 1) % every:
            return x[:n]
        buf = torch.empty(n + 1, dtype=x.dtype, device=x.device)
        buf[1:] = x[:n]
        return buf[1:]

    return map_inputs(inp, view)


def packed_inputs(inp, n, start=3):
    """Captured network inputs cut to ``n`` cells, with the float fields
    and carry as rows of one ``(C, start + n)`` tensor, taken as
    ops/solver.solve_rate_cool_compacted takes its last warm tile
    (``M[:, start:start + n]``, one row per operand): the rows sit at
    offsets that are 16-byte aligned for some rows and not for others."""
    import torch

    out = head_inputs(inp, n)
    rows = [(d, k) for d in (out["f"], out["carry_v"])
            for k, v in d.items() if v.is_floating_point()]
    ref = out["f"]["density"]
    packed = torch.zeros(len(rows), start + n, dtype=ref.dtype,
                         device=ref.device)
    for r, (d, k) in enumerate(rows):
        packed[r, start:] = d[k]
    cols = packed[:, start:start + n]
    for r, (d, k) in enumerate(rows):
        d[k] = cols[r]
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
    """Median device time in ms of ``fn``'s work on the current stream,
    after one warm-up call.  Before each timed call a zero fill of
    FLUSH_BYTES evicts the L2 (so ``fn`` finds its operands in device
    memory, as a subcycle does) and keeps the device busy while the host
    records the start event, submits ``fn`` and records the end event:
    the two events bracket the device's work, not the host's."""
    import torch

    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def profiler_kernel_ms(fn, kernel, reps=TIMING_REPS):
    """The same launches as cuda_median_ms, under torch.profiler: the
    median duration in ms of the device kernels whose name contains
    ``kernel``, or None when the profiler recorded none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type.name == "CUDA" and kernel in e.name]
    return float(np.median(times)) if times else None


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
        self.loop = dict(
            name="graph_loop_cond", route="cuda",
            source="grackle_tpu_torch/csrc/graph_loop.cu",
            # no TPU kernel: it evaluates the condition of the loop that
            # is lax.while_loop here in the JAX package
            replaces="grackle_tpu/ops/solver.py:559",
            launches=None, max_abs_err=None, ms=None, plain_ms=None,
            bound_ms=None, bound_by=None, library_ms=None,
        )
        self.cloudy = dict(
            name="cloudy_interp", route="cuda",
            source="grackle_tpu_torch/csrc/cloudy_interp.cu",
            # no TPU kernel: the Cloudy lookups are gathers in the JAX
            # package (grackle_tpu/ops/interp.py, tabulated_temp.py,
            # cloudy_cool.py)
            replaces="grackle_tpu/ops/interp.py:interpolate_3dz",
            launches=None, max_abs_err=None, ms=None, plain_ms=None,
            bound_ms=None, bound_by=None, library_ms=None,
        )
        self.dust = dict(
            name="dust_temp", route="cuda",
            source="grackle_tpu_torch/csrc/dust_temp.cu",
            # no TPU kernel: the dust solve is two lax while loops of
            # masked sweeps in the JAX package
            replaces="grackle_tpu/ops/dust_temp.py:calc_tdust_1d",
            launches=None, max_abs_err=None, ms=None, plain_ms=None,
            bound_ms=None, bound_by=None, library_ms=None,
        )
        self.rates = dict(
            name="rate_lookup", route="cuda",
            source="grackle_tpu_torch/csrc/rate_lookup.cu",
            # no TPU kernel: the rate lookup and the H2-equilibrium limit
            # are XLA gathers and elementwise ops in the JAX package
            replaces="grackle_tpu/ops/chemistry_step.py:lookup_cool_rates",
            launches=None, max_abs_err=None, ms=None, plain_ms=None,
            bound_ms=None, bound_by=None, library_ms=None,
        )
        #: each main-path run's launches_run(), counted from 0 just
        #: before it (the host programs of 4i and 4k count only the
        #: network kernel's): each kernel line's launches are their sum
        self.path_launches = {}
        #: nvidia-smi's name and power limit of the card (phase 0)
        self.card = "not read"

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
        self.card = out[0]
        import torch

        def run(cmd):
            try:
                return subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=60).stdout.strip()
            except OSError as exc:
                return f"({exc})"

        from grackle_tpu_torch.ops.kernel_lib import nvcc as nvcc_path

        nvcc = run([nvcc_path(), "--version"]).splitlines()
        driver = run(["nvidia-smi", "--query-gpu=driver_version",
                      "--format=csv,noheader"])
        return (f"nvidia-smi: {out[0]}; torch {torch.__version__} (CUDA "
                f"{torch.version.cuda}); nvcc: "
                f"{nvcc[-1] if nvcc else 'not found'}; driver {driver}")

    def build(self):
        """The kernels' libraries, one nvcc each, started together."""
        from concurrent.futures import ThreadPoolExecutor

        from grackle_tpu_torch.ops import (cloudy_kernel, dust_kernel,
                                           graph_loop, network_kernel,
                                           rates_kernel)

        def timed(mod):
            t0 = time.time()
            path = mod.build()
            return path, time.time() - t0

        mods = (network_kernel.library, graph_loop, cloudy_kernel.library,
                dust_kernel.library, rates_kernel.library)
        t0 = time.time()
        with ThreadPoolExecutor(len(mods)) as pool:
            builds = list(pool.map(timed, mods))
        wall = time.time() - t0
        for mod in mods:
            mod.load()
        built = ", ".join(f"{os.path.relpath(path, REPO)} in {secs:.2f} s"
                          for path, secs in builds)
        rt, drv = graph_loop.versions
        logs = "; ".join(
            f"{name} ptxas: {' '.join(mod.build_log.split()) or '(cached)'}"
            for name, mod in (("network", network_kernel.library),
                              ("Cloudy", cloudy_kernel.library),
                              ("dust", dust_kernel.library),
                              ("rate", rates_kernel.library)))
        return (f"built {built}, {wall:.2f} s together; the loop library's "
                f"CUDA runtime {rt}, driver {drv}; {logs}")

    def check_kernel(self, label, cfg, inp):
        """Kernel vs twin on one set of captured network inputs (the
        kernel reads dt from a 0-d float64 tensor on the card, as every
        solve passes it); raises unless masks and counters are identical
        and the worst relative error is within KERNEL_RTOL.  Returns
        (message, kernel arguments, worst relative error)."""
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
        if not (exact and rel <= KERNEL_RTOL):
            raise AssertionError(msg + f" (bound {KERNEL_RTOL:.0e})")
        return msg, args, rel

    def kernel_vs_twin(self):
        """The flagship network inputs, f64 and f32, at the widths the
        solves launch the kernel with: every cell (the monolithic path),
        the compacted path's warm tile and its batch (the first cells of
        the same inputs).  Then, at the later subcycle, the addressing the
        kernel must get right: a width that is not a whole number of
        tiles, operands at an odd element offset (all of them, and every
        other one), and the packed carry of the compacted solve.  Device
        times (cuda_median_ms) of the bare kernel launch and of the twin
        beside the launch's bound, with its grid.
        The kernel line reports the batch-width f64 launch at the later
        subcycle, the shape of most of the main path's launches; phase 5
        times it under torch.profiler as well."""
        import torch

        from grackle_tpu_torch.api import _compact_batch
        from grackle_tpu_torch.ops import network as plain
        from grackle_tpu_torch.ops.network_kernel import prepare_launch
        from grackle_tpu_torch.ops.solver import warm_tile_width

        batch = _compact_batch(N_FLAGSHIP)
        widths = (N_FLAGSHIP, min(warm_tile_width(batch), N_FLAGSHIP), batch)
        parts = [f"times are device ms, CUDA events around the bare call "
                 f"after a {FLUSH_BYTES >> 20} MB L2 flush, median of "
                 f"{TIMING_REPS} (phase 5 holds one against torch.profiler)"]
        for precision in (64, 32):
            cd = flagship_chem(precision, "cuda")
            cfg = cd.context.config
            fields = flagship_fields(cd, N_FLAGSHIP)
            for step, inp in capture_network_inputs(
                    cd, fields, DT_FLAGSHIP, CAPTURE_AT):
                for n in widths:
                    msg, args, _ = self.check_kernel(
                        f"f{precision} subcycle {step} {n} cells", cfg,
                        head_inputs(inp, n))
                    launch, _ = prepare_launch(*args)
                    ms_k = cuda_median_ms(launch)
                    ms_t = cuda_median_ms(
                        lambda: plain.network_update(*args))
                    size = inp["f"]["density"].element_size()
                    bytes_ms = launch.bytes / HBM_BYTES_PER_S * 1e3
                    ops_ms = (OPS_PER_CELL[size] * n
                              / PEAK_OPS_PER_S[size] * 1e3)
                    bound = max(bytes_ms, ops_ms)
                    parts.append(
                        f"{msg}; kernel {ms_k:.4f} ms ({bound / ms_k:.0%} "
                        f"of bound), twin {ms_t:.4f} ms, {launch.bytes} B, "
                        f"bound {bound:.4f} ms, {launch.grid} CTAs "
                        f"({launch.ctas_per_sm} per SM)")
                    if (precision, step, n) == (64, CAPTURE_AT[1], batch):
                        self.kernel.update(
                            ms=ms_k, plain_ms=ms_t, bound_ms=bound,
                            bound_by="bytes" if bytes_ms >= ops_ms
                            else "operations")
                if step != CAPTURE_AT[1]:
                    continue
                for label, views in (
                        (f"{batch + 1} cells, a partial last tile",
                         head_inputs(inp, batch + 1)),
                        (f"{batch} cells, every operand at an odd offset",
                         offset_inputs(inp, batch)),
                        (f"{batch} cells, every other operand at an odd "
                         f"offset", offset_inputs(inp, batch, every=2)),
                        (f"{batch} cells, the compacted solve's packed "
                         f"carry", packed_inputs(inp, batch))):
                    parts.append(self.check_kernel(
                        f"f{precision} subcycle {step} {label}", cfg,
                        views)[0])
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
            for precision in (64, 32):
                cd = answer_chem("cuda", precision=precision, **kw)
                state = answer_state(cd, n=N_CONFIGS)
                worst = []
                for step, inp in capture_network_inputs(
                        cd, state, 1.0e-4, (0, 6)):
                    _, _, rel = self.check_kernel(
                        f"{name} f{precision} subcycle {step}",
                        cd.context.config, inp)
                    worst.append(f"{rel:.3e}")
                parts.append(f"{name} f{precision} max rel "
                             f"{'/'.join(worst)}")
        return "; ".join(parts)

    def cloudy_kernels(self):
        """The Cloudy kernels (csrc/cloudy_interp.cu) against their twins
        on the card, bit for bit, f64 and f32: the fixed point (imetal 0
        and 1, the table's mmw and a zigzag one on which cells reach
        TI_MAX) and the cooling (every combination of icmbTfloor,
        iClHeat and iZscale) on rank 1, 2 and 3 tables, rank 3 at each of
        cloudy_redshifts, at CLOUDY_WIDTHS cells past both edges of the
        grid.  Then a call of each whose input requires grad: one
        launch, the kernel's values, the twin's gradient bit for bit.
        Then the launches of each subcycle body of a tabulated
        (chemistry 0, metal cooling, UVB) and of the flagship solve,
        eager and capturing, with no interpolate_3dz on the card; and
        tabulated stateful calls replayed at the CLOUDY_A_VALUES, each
        bit-identical to the uncached body at that a_value, with 3
        Cloudy launches run a subcycle (replays counted on the card)."""
        import itertools

        import torch

        from grackle_tpu_torch.api import call_scalars
        from grackle_tpu_torch.ops import (cloudy_cool, cloudy_kernel,
                                           tabulated_temp)
        from grackle_tpu_torch.ops.common import block_scalars

        parts, failed = [], []
        checks = differing = 0
        worst = 0.0
        for precision in (64, 32):
            cd = answer_chem("cuda", primordial_chemistry=0, metal_cooling=1,
                             UVbackground=1, precision=precision)
            cfg = cd.context.config
            us, _, _ = block_scalars(call_scalars(cd.context, "cuda"))
            tables = cloudy_tables(cd)
            cells = cloudy_cells(tables[3][0], max(CLOUDY_WIDTHS), us,
                                 cfg.Gamma)
            stuck = []
            for rank, (prim, met) in tables.items():
                zs = (cloudy_redshifts(prim) if rank == 3
                      else [("", us.zr)])
                for zname, zr in zs:
                    comp2 = 2.73 * (1.0 + zr)
                    for n in CLOUDY_WIDTHS:
                        c = {k: v[:n] for k, v in cells.items()}
                        label = f"f{precision} rank {rank} {zname} {n}"
                        runs = []
                        for table, imetal in itertools.product(
                                (prim, zigzag_mmw(prim)), (False, True)):
                            runs.append((
                                f"{label} fixed point imetal {int(imetal)}"
                                f"{' zigzag' if table is not prim else ''}",
                                cloudy_kernel.fixed_point_cuda,
                                tabulated_temp.tabulated_temperature,
                                (table, c["d"], c["metal"], c["e"],
                                 c["rhoH"], us.dom, zr,
                                 cfg.TemperatureStart, cfg.Gamma, us.utem,
                                 imetal)))
                        for flags in itertools.product((0, 1), repeat=3):
                            runs.append((
                                f"{label} cooling flags {flags}",
                                cloudy_kernel.cooling_cuda,
                                cloudy_cool.cloudy_cooling,
                                (met, c["logtem"], c["rhoH"],
                                 c["metallicity"], us.dom, zr, comp2,
                                 *flags)))
                        for what, kern, twin, args in runs:
                            got = kern(*args)
                            want = twin(*args)
                            got = got if isinstance(got, tuple) else (got,)
                            want = (want if isinstance(want, tuple)
                                    else (want,))
                            bad, diff = cloudy_bit_differences(got, want)
                            checks += 1
                            differing += bad
                            worst = max(worst, diff)
                            if bad:
                                failed.append(f"{what}: {bad} differ, max "
                                              f"abs {diff:.3e}")
                        if n == max(CLOUDY_WIDTHS):
                            stuck.append(cells_at_ti_max(
                                cloudy_kernel.fixed_point_cuda,
                                (zigzag_mmw(prim), c["d"], c["metal"],
                                 c["e"], c["rhoH"], us.dom, zr,
                                 cfg.TemperatureStart, cfg.Gamma, us.utem,
                                 True), c["metal"]))
            if min(stuck) == 0:
                raise AssertionError(f"f{precision}: a zigzag case had no "
                                     f"cell at TI_MAX ({stuck})")
            parts.append(f"f{precision}: {min(stuck)} to {max(stuck)} of "
                         f"the {int((cells['metal'] > 0).sum())} of "
                         f"{max(CLOUDY_WIDTHS)} cells with metal at TI_MAX "
                         f"on the zigzag table")
        self.cloudy["max_abs_err"] = worst
        if failed:
            raise AssertionError(f"{len(failed)} of {checks} checks differ "
                                 f"from the twin: " + "; ".join(failed[:8]))
        parts.insert(0, f"{checks} kernel-vs-twin checks bit-identical")

        # a call whose input requires grad launches the kernel too, and
        # its backward gives the twin's gradient
        n = 4096
        prim, met = tables[3]
        for name, route, twin, args, wrt in (
                ("fixed point", cloudy_kernel.tabulated_temperature,
                 tabulated_temp.tabulated_temperature,
                 (prim, cells["d"][:n], cells["metal"][:n],
                  cells["e"][:n], cells["rhoH"][:n], us.dom, us.zr,
                  cfg.TemperatureStart, cfg.Gamma, us.utem, True), 3),
                ("cooling", cloudy_kernel.cloudy_cooling,
                 cloudy_cool.cloudy_cooling,
                 (met, cells["logtem"][:n], cells["rhoH"][:n],
                  cells["metallicity"][:n], us.dom, us.zr,
                  2.73 * (1.0 + us.zr), 1, 1, 1), 1)):
            runs = []
            for fn in (route, twin):
                x = args[wrt].clone().requires_grad_(True)
                before = cloudy_kernel.library.issued()
                out = fn(*args[:wrt], x, *args[wrt + 1:])
                out = out if isinstance(out, tuple) else (out,)
                launched = cloudy_kernel.library.issued() - before
                sum(o.sum() for o in out).backward()
                runs.append((launched, tuple(o.detach() for o in out),
                             x.grad))
            (launched, values, grad), (_, _, twin_grad) = runs
            with torch.no_grad():
                kernel = route(*args)
            bad = cloudy_bit_differences(
                values, kernel if isinstance(kernel, tuple) else (kernel,))[0]
            off = cloudy_bit_differences((grad,), (twin_grad,))[0]
            finite = bool(torch.isfinite(grad).all())
            if launched != 1 or bad or off or not finite:
                raise AssertionError(
                    f"a {name} call that requires grad: {launched} "
                    f"launches, {bad} values off the kernel's, gradient "
                    f"finite {finite}, {off} elements off the twin's")
        parts.append("a fixed-point and a cooling call whose input "
                     "requires grad: one launch each, the kernel's values, "
                     "a finite gradient bit-identical to the twin's")

        # launches of each subcycle body, eager and capturing
        for name, want in (("tabulated", 3), ("flagship", 1)):
            if name == "tabulated":
                cd = answer_chem("cuda", primordial_chemistry=0,
                                 metal_cooling=1, UVbackground=1)
                fields = tabulated_state(cd, N_CLOUDY_STATE)
            else:
                cd = flagship_chem(64, "cuda")
                fields = flagship_fields(cd, N_CLOUDY_STATE)
            per_body, on_card = cloudy_launches_per_body(
                cd, fields, 1.0e-4, calls=2)
            kinds = dict(cd.context.graphs.calls)
            if set(per_body) != {want} or on_card:
                raise AssertionError(
                    f"{name}: Cloudy launches a subcycle body "
                    f"{sorted(set(per_body))} (want {want}), "
                    f"interpolate_3dz on the card {on_card} times")
            parts.append(f"{name}: {want} Cloudy launches in each of "
                         f"{len(per_body)} subcycle bodies ({kinds}), no "
                         f"interpolate_3dz on the card")

        # tabulated stateful calls at changing a_values
        # (3 Cloudy launches a subcycle, counted on the card in a replay)
        cd = answer_chem("cuda", primordial_chemistry=0, metal_cooling=1,
                         UVbackground=1)
        fields = device_fields(tabulated_state(cd, N_CLOUDY_STATE))
        graphs = cd.context.graphs
        kinds = []
        for a_value in CLOUDY_A_VALUES:
            cd.a_value = a_value
            zero_launches()
            kind, got, _ = stateful_call(graphs, cd.solve_chemistry,
                                         dict(fields), 1.0e-4)
            ran = launches_run()[CLOUDY]
            if ran != 3 * int(got[1]["subcycles"]):
                raise AssertionError(f"a_value {a_value}, {dict(kind)}: "
                                     f"{ran} Cloudy launches ran for "
                                     f"{got[1]['subcycles']} subcycles")
            with uncached():
                want = cd.solve_chemistry(dict(fields), 1.0e-4)
            differ = tree_differences(got, want)
            if differ:
                raise AssertionError(f"a_value {a_value}: {differ} differ "
                                     f"from the uncached body")
            kinds.append("/".join(sorted(kind)))
        parts.append(f"tabulated calls at a_value {CLOUDY_A_VALUES}: "
                     f"{', '.join(kinds)}, each bit-identical to the "
                     f"uncached body and 3 Cloudy launches run a subcycle")
        return "; ".join(parts)

    def dust_kernel_vs_twin(self):
        """The dust temperature kernel (csrc/dust_temp.cu) against its twin
        on the card, bit for bit, f64 and f32: on the dust inputs of the
        first subcycle (a cold start from zeros) and of a later one (warm)
        of DUST_CELL's first pool state, at DUST_WIDTHS cells; then the
        same inputs without a warm start (as the derived field passes
        them).  Then a call whose
        input requires grad: one launch, the kernel's values, the twin's
        gradient bit for bit.  Then the flagship's stateful calls at
        4,096 cells: one dust launch in each subcycle body, eager and
        capturing, the captured body's dust nodes
        (tracing.dust_nodes_per_subcycle) at most 3, and replays at the
        DUST_A_VALUES bit-identical to the uncached body, with one dust
        launch run a subcycle (replays counted on the card).  The kernel's
        median device time (f64, later subcycle) beside its bound, and at
        the largest width the twin's, captured into a graph and
        replayed.  Its launches are left out of the kernel line's
        count, which is the main-path runs'."""
        import torch

        from grackle_tpu_torch import tracing
        from grackle_tpu_torch.ops import device_loop, dust_kernel, dust_temp

        parts, failed = [], []
        checks = 0
        worst = 0.0
        for precision in (64, 32):
            cd, state = cell_chem(DUST_CELL, precision, DUST_SEED)
            captured = capture_dust_inputs(cd, state, DT_FLAGSHIP)
            for step, args, init in captured:
                newton, bisect = dust_steps(args, init)
                parts.append(f"f{precision} subcycle {step}: the twin's "
                             f"sweeps run {newton} Newton and {bisect} "
                             f"bisection steps")
                for n in DUST_WIDTHS:
                    head = [a[:n] if isinstance(a, torch.Tensor)
                            and a.dim() else a for a in args]
                    runs = [("warm", init[:n])]
                    if n == max(DUST_WIDTHS):
                        runs.append(("cold", None))
                    for what, start in runs:
                        got = dust_kernel.dust_temperature_cuda(
                            *head, tdust_init=start)
                        want = dust_temp.calc_tdust_1d(*head,
                                                       tdust_init=start)
                        bad, diff = cloudy_bit_differences((got,), (want,))
                        checks += 1
                        worst = max(worst, diff)
                        if bad:
                            failed.append(f"f{precision} subcycle {step} "
                                          f"{n} {what}: {bad} differ, max "
                                          f"abs {diff:.3e}")
            if precision == 64:
                step, args, init = captured[-1]
                for n in (81_920, max(DUST_WIDTHS)):
                    head = [a[:n] if isinstance(a, torch.Tensor)
                            and a.dim() else a for a in args]
                    launch, _ = dust_kernel.prepare_launch(
                        *head, tdust_init=init[:n])
                    ms = cuda_median_ms(launch)
                    bound = launch.bytes / HBM_BYTES_PER_S * 1e3
                    parts.append(f"bare launch at {n} cells (subcycle "
                                 f"{step}) {ms:.4f} ms, bound {bound:.5f} "
                                 f"ms")
                    if n == max(DUST_WIDTHS):
                        # the twin as a subcycle body replays it
                        graph, _, _ = capture_graph(
                            lambda: dust_temp.calc_tdust_1d(
                                *head, tdust_init=init[:n]))
                        plain_ms = cuda_median_ms(graph.replay)
                        del graph
                        device_loop.release_pools()
                        parts.append(f"the twin captured, replayed at {n} "
                                     f"cells {plain_ms:.4f} ms")
                        self.dust.update(ms=ms, plain_ms=plain_ms,
                                         bound_ms=bound, bound_by="bytes")
                grad_args = (args, init)
            del cd, state, captured
            torch.cuda.empty_cache()
        self.dust["max_abs_err"] = worst
        if failed:
            raise AssertionError(f"{len(failed)} of {checks} checks differ "
                                 f"from the twin: " + "; ".join(failed[:8]))
        parts.insert(0, f"{checks} kernel-vs-twin checks bit-identical")

        # a call whose input requires grad launches the kernel too, and
        # its backward gives the twin's gradient
        args, init = grad_args
        n = 4096
        head = [a[:n] if isinstance(a, torch.Tensor) and a.dim() else a
                for a in args]
        runs = []
        for fn in (dust_kernel.dust_temperature, dust_temp.calc_tdust_1d):
            x = head[0].clone().requires_grad_(True)
            before = dust_kernel.library.issued()
            out = fn(x, *head[1:], tdust_init=init[:n])
            launched = dust_kernel.library.issued() - before
            out.sum().backward()
            runs.append((launched, out.detach(), x.grad))
        (launched, values, grad), (_, _, twin_grad) = runs
        with torch.no_grad():
            kernel = dust_kernel.dust_temperature(*head, tdust_init=init[:n])
        bad = cloudy_bit_differences((values,), (kernel,))[0]
        off = cloudy_bit_differences((grad,), (twin_grad,))[0]
        finite = bool(torch.isfinite(grad).all())
        if launched != 1 or bad or off or not finite:
            raise AssertionError(
                f"a dust call that requires grad: {launched} launches, "
                f"{bad} values off the kernel's, gradient finite {finite}, "
                f"{off} elements off the twin's")
        parts.append("a call whose input requires grad: one launch, the "
                     "kernel's values, a finite gradient bit-identical to "
                     "the twin's")

        # the flagship's stateful calls: launches a subcycle body (eager
        # and capturing), the captured body's dust nodes, and replays at
        # changing a_values (the CMB temperature is read on the card)
        from grackle_tpu_torch.ops import solver

        cd = flagship_chem(64, "cuda")
        fields = device_fields(flagship_fields(cd, N_CLOUDY_STATE))
        graphs = cd.context.graphs
        dust_kernel.library.count_replays(CARD_DEVICE)
        tracing.dust_nodes = None
        kinds, nodes = [], None
        subcycle = solver.subcycle
        for a_value in DUST_A_VALUES:
            cd.a_value = a_value
            per_body = []

            def counted(*a, **kw):
                before = dust_kernel.library.issued()
                out = subcycle(*a, **kw)
                per_body.append(dust_kernel.library.issued() - before)
                return out

            dust_kernel.library.zero()
            solver.subcycle = counted
            try:
                kind, got, _ = stateful_call(graphs, cd.solve_chemistry,
                                             dict(fields), 1.0e-4)
            finally:
                solver.subcycle = subcycle
            subcycles = int(got[1]["subcycles"])
            ran = dust_kernel.library.executed()
            if (per_body and set(per_body) != {1}) or ran != subcycles:
                raise AssertionError(
                    f"a_value {a_value}, {dict(kind)}: dust launches a "
                    f"subcycle body {sorted(set(per_body))}, {ran} run "
                    f"for {subcycles} subcycles")
            if "capture" in kind:
                nodes = tracing.dust_nodes_per_subcycle()
            with uncached():
                want = cd.solve_chemistry(dict(fields), 1.0e-4)
            differ = tree_differences(got, want)
            if differ:
                raise AssertionError(f"a_value {a_value}: {differ} differ "
                                     f"from the uncached body")
            kinds.append("/".join(sorted(kind)))
        if nodes is None or not 1 <= nodes <= 3:
            raise AssertionError(f"dust nodes in the captured subcycle "
                                 f"body: {nodes} (want 1 to 3)")
        parts.append(f"flagship calls at a_value {DUST_A_VALUES}: "
                     f"{', '.join(kinds)}, one dust launch a subcycle body "
                     f"and a subcycle run, {nodes} dust node(s) in the "
                     f"captured body, each bit-identical to the uncached "
                     f"body")
        return "; ".join(parts)

    def rate_kernel_vs_twin(self):
        """The rate lookup kernel (csrc/rate_lookup.cu) against its twin
        (ops/rates_kernel.twin: lookup_cool_rates, then the H2-equilibrium
        limit) on the card, bit for bit, f64 and f32: on the lookups of
        the first subcycle and of a later one of a 12-species state with
        dust, metal cooling and the UVB at N_RATE_CELLS cells
        (rate_state), moved by rate_cases to where the rarer branches run,
        under every combination of RATE_FLAGS.  Then, at the main path's
        RATE_WIDTHS, the lookups at RATE_CELL_AT of the first pool states
        of the RATE_CELLS, under their own flags.  Then a call whose input
        requires grad: one launch, the kernel's values, the twin's
        gradient bit for bit.  Then the stateful calls of the benchmark
        cell SHIELD_CELL's configuration on the first 4,096 cells of its
        pool: one rate launch in each subcycle body, eager and capturing,
        the captured body's rate nodes (tracing.rates_nodes_per_subcycle)
        2 (the launch and the node that counts its replays, armed here;
        1 in the benchmark, which counts none), and replays at the
        RATE_A_VALUES, whose photo rates differ,
        bit-identical to the uncached body, with one rate launch run a
        subcycle (replays counted on the card).  The kernel's median
        device time (f64, DUST_CELL's later subcycle) at 81,920 cells and
        at the largest width, beside its bound, and the twin's, captured
        into a graph and replayed; the kernel line reads the largest
        width's.  Its launches are left out of the kernel line's count,
        which is the main-path runs'."""
        import torch

        from grackle_tpu_torch import tracing
        from grackle_tpu_torch.api import call_scalars
        from grackle_tpu_torch.ops import device_loop, rates_kernel, solver
        from grackle_tpu_torch.ops.common import block_scalars

        parts, failed = [], []
        checks, worst = 0, 0.0

        def compare(where, case):
            nonlocal checks, worst
            got = rate_rows(case[0], rates_kernel.rate_lookup_cuda(*case))
            want = rate_rows(case[0], rates_kernel.twin(*case))
            bad, diff = cloudy_bit_differences(got, want)
            checks += 1
            worst = max(worst, diff)
            if bad:
                failed.append(f"{where}: {bad} differ, max abs {diff:.3e}")

        # every flag combination, at N_RATE_CELLS cells
        for precision in (64, 32):
            cd = rate_chem(precision)
            captured = capture_rate_inputs(
                cd, rate_state(cd, N_RATE_CELLS), DT_FLAGSHIP)
            for step, args in captured:
                cases = rate_cases(args)
                for flags, case in cases:
                    compare(f"f{precision} subcycle {step} {flags}", case)
            if precision == 64:
                grad_args = captured[-1][1]
            del cd, captured
            torch.cuda.empty_cache()
        swept = checks

        # the main path's widths: the benchmark cells' pool states under
        # their own flags
        for precision in (64, 32):
            for cell, seed in RATE_CELLS:
                cd, state = cell_chem(cell, precision, seed)
                captured = capture_rate_inputs(cd, state, DT_FLAGSHIP,
                                               RATE_CELL_AT)
                for step, args in captured:
                    width = args[5].tgas.shape[0]
                    if width < max(RATE_WIDTHS):
                        raise AssertionError(f"{cell}: a pool state of "
                                             f"{width} cells")
                    for n in RATE_WIDTHS:
                        compare(f"{cell} f{precision} subcycle {step} {n} "
                                f"cells", head_rate_args(args, n))
                if precision == 64 and cell == DUST_CELL:
                    step, args = captured[-1]
                    for n in RATE_WIDTHS[1:]:
                        case = head_rate_args(args, n)
                        launch, _ = rates_kernel.prepare_launch(
                            case[0], case[1], *rates_kernel.operands(
                                case[0], *case[2:8]))
                        ms = cuda_median_ms(launch)
                        bound = launch.bytes / HBM_BYTES_PER_S * 1e3
                        rates_kernel.twin(*case)
                        graph, _, stats = capture_graph(
                            lambda: rates_kernel.twin(*case))
                        plain_ms = cuda_median_ms(graph.replay)
                        del graph
                        device_loop.release_pools()
                        parts.append(f"{cell} subcycle {step}, {n} cells: "
                                     f"bare launch {ms:.4f} ms, bound "
                                     f"{bound:.5f} ms; the twin captured "
                                     f"({stats['nodes']} nodes), replayed "
                                     f"{plain_ms:.4f} ms")
                        if n == max(RATE_WIDTHS):
                            self.rates.update(ms=ms, plain_ms=plain_ms,
                                              bound_ms=bound,
                                              bound_by="bytes")
                del cd, state, captured
                torch.cuda.empty_cache()
        self.rates["max_abs_err"] = worst
        if failed:
            raise AssertionError(f"{len(failed)} of {checks} checks differ "
                                 f"from the twin: " + "; ".join(failed[:8]))
        parts.insert(0, f"{checks} kernel-vs-twin checks bit-identical "
                        f"({swept} at {N_RATE_CELLS} cells: {len(cases)} "
                        f"flag combinations, {len(RATE_AT)} subcycles, f64 "
                        f"and f32; {checks - swept} at {RATE_WIDTHS} cells "
                        f"of {len(RATE_CELLS)} bench cells' states, "
                        f"{len(RATE_CELL_AT)} subcycles, f64 and f32)")

        # a call whose input requires grad launches the kernel too, and
        # its backward gives the twin's gradient
        cfg, tables, pr, us, f, cool, *rest = grad_args
        runs = []
        for fn in (rates_kernel.rate_lookup, rates_kernel.twin):
            x = cool.tgas.clone().requires_grad_(True)
            cool_x = type(cool)(**dict(vars(cool), tgas=x))
            before = rates_kernel.library.issued()
            out = fn(cfg, tables, pr, us, f, cool_x, *rest)
            launched = rates_kernel.library.issued() - before
            rows = rate_rows(cfg, out)[:-1]
            sum(r.sum() for r in rows).backward()
            runs.append((launched, [r.detach() for r in rows], x.grad))
        (launched, values, grad), (_, _, twin_grad) = runs
        with torch.no_grad():
            kernel = rate_rows(cfg, rates_kernel.rate_lookup(
                cfg, tables, pr, us, f, cool, *rest))[:-1]
        bad = cloudy_bit_differences(values, kernel)[0]
        off = cloudy_bit_differences((grad,), (twin_grad,))[0]
        if launched != 1 or bad or off:
            raise AssertionError(
                f"a rate lookup that requires grad: {launched} launches, "
                f"{bad} values off the kernel's, {off} gradient elements "
                f"off the twin's")
        parts.append("a call whose input requires grad: one launch, the "
                     "kernel's values, the twin's gradient bit for bit")

        # the shielded cell's stateful calls: launches a subcycle body
        # (eager and capturing), the captured body's rate nodes, and
        # replays at changing a_values (the photo rates are read on the
        # card)
        cd, state = cell_chem(SHIELD_CELL, 64, SHIELD_SEED)
        fields = device_fields({k: v[:N_CLOUDY_STATE]
                                for k, v in state.items()})
        graphs = cd.context.graphs
        rates_kernel.library.count_replays(CARD_DEVICE)
        tracing.rates_nodes = None
        kinds, nodes, k24 = [], None, set()
        subcycle = solver.subcycle
        for a_value in RATE_A_VALUES:
            cd.a_value = a_value
            per_body = []

            def counted(*a, **kw):
                before = rates_kernel.library.issued()
                out = subcycle(*a, **kw)
                per_body.append(rates_kernel.library.issued() - before)
                return out

            rates_kernel.library.zero()
            solver.subcycle = counted
            try:
                kind, got, _ = stateful_call(graphs, cd.solve_chemistry,
                                             dict(fields), 1.0e-4)
            finally:
                solver.subcycle = subcycle
            subcycles = int(got[1]["subcycles"])
            ran = rates_kernel.library.executed()
            if (per_body and set(per_body) != {1}) or ran != subcycles:
                raise AssertionError(
                    f"a_value {a_value}, {dict(kind)}: rate launches a "
                    f"subcycle body {sorted(set(per_body))}, {ran} run "
                    f"for {subcycles} subcycles")
            if "capture" in kind:
                nodes = tracing.rates_nodes_per_subcycle()
            with uncached():
                want = cd.solve_chemistry(dict(fields), 1.0e-4)
            differ = tree_differences(got, want)
            if differ:
                raise AssertionError(f"a_value {a_value}: {differ} differ "
                                     f"from the uncached body")
            k24.add(float(block_scalars(call_scalars(cd.context,
                                                     "cuda"))[1].k24))
            kinds.append("/".join(sorted(kind)))
        # the launch and, the replay count being armed, its counting node
        if nodes != 2 or len(k24) != len(set(RATE_A_VALUES)):
            raise AssertionError(f"rate nodes in the captured subcycle "
                                 f"body: {nodes} (want 2); {len(k24)} "
                                 f"photo rates k24 at a_value "
                                 f"{RATE_A_VALUES}")
        parts.append(f"{SHIELD_CELL} calls at a_value {RATE_A_VALUES} "
                     f"(k24 {', '.join(f'{k:.4g}' for k in sorted(k24))}): "
                     f"{', '.join(kinds)}, one rate launch a subcycle body "
                     f"and a subcycle run, {nodes} rate nodes in the "
                     f"captured body (the launch and its replay count), "
                     f"each bit-identical to the uncached body")
        return "; ".join(parts)

    def answers(self):
        """The stored answers; then the functional_jit example and the
        old-style rank-4 cooling time, each against the port's CPU run
        (FUNCTIONAL_JIT_SUBCYCLES says why not against the stored
        example answer)."""
        import torch

        parts = []
        for name, workload in ANSWERS.items():
            errors = answer_errors(name, workload("cuda"))
            worst = max(errors.values())
            parts.append(f"{name} {'/'.join(errors)} max rel {worst:.3e}")
            if worst > ANSWER_RTOL:
                raise AssertionError("; ".join(parts))

        t0 = time.time()
        card = functional_jit_answer("cuda")
        wall = time.time() - t0
        cpu = functional_jit_answer("cpu")
        worst = max(max_rel(card[k], cpu[k]) for k in cpu)
        parts.append(f"functional_jit (one step, {FUNCTIONAL_JIT_SUBCYCLES}"
                     f" subcycles, {wall:.2f} s) vs CPU max rel "
                     f"{worst:.3e}")
        if worst > ANSWER_RTOL or not all(np.all(np.isfinite(v))
                                          for v in card.values()):
            raise AssertionError("; ".join(parts))

        worst = 0.0
        chems = [old_style_chem(device, 4) for device in ("cuda", "cpu")]
        for zfrac in (1e-6, 0.04):
            state = old_style_state(chems[1], zfrac)
            card, cpu = (cd.calculate_cooling_time(state) for cd in chems)
            if not bool(torch.isfinite(card).all()):
                raise AssertionError("old-style cooling_time not finite")
            worst = max(worst, max_rel(card, cpu))
        parts.append(f"old-style rank-4 cooling_time vs CPU max rel "
                     f"{worst:.3e}")
        if worst > ANSWER_RTOL:
            raise AssertionError("; ".join(parts))
        return "; ".join(parts)

    def flagship(self, precision):
        """The flagship at the default solver_compaction (the compacted
        path) through the stateful API: three calls of one context on
        the same state, the eager first call, the second (captured into
        a CUDA graph and replayed) and a replay, which the phase times;
        each bit-identical to the first; outer trips, and kernel
        launches (the host's and the replay's, which must equal the
        subcycles run over every warm tile and trip).  The f64 run is the
        main path whose launches the kernel line reports."""
        import torch

        from grackle_tpu_torch.api import solve_path

        cd = flagship_chem(precision, "cuda")
        if solve_path(cd.config, N_FLAGSHIP) != "compact":
            raise AssertionError("the flagship does not take the "
                                 "compacted path")
        fields = flagship_fields(cd, N_FLAGSHIP)
        walls, first = [], None
        for kind in CALL_KINDS:
            torch.cuda.reset_peak_memory_stats()
            zero_launches()
            kinds, (new_f, diag), wall = stateful_call(
                cd.context.graphs, cd.solve_chemistry, fields, DT_FLAGSHIP)
            ran = launches_run()
            launches = ran[NETWORK]
            if kinds != {kind: 1}:
                raise AssertionError(f"f{precision}: call {len(walls) + 1} "
                                     f"was {dict(kinds)}, not {kind}")
            if launches != diag["subcycles"] or launches == 0:
                raise AssertionError(
                    f"f{precision} {kind}: {launches} kernel launches for "
                    f"{diag['subcycles']} subcycles")
            check_dust_launches(f"f{precision} {kind}", cd.config,
                                ran[DUST], diag["subcycles"])
            check_rates_launches(f"f{precision} {kind}", cd.config,
                                 ran[RATES], diag["subcycles"])
            if first is None:
                first = (new_f, diag)
            elif tree_differences((new_f, diag), first):
                raise AssertionError(
                    f"f{precision} {kind} differs from the eager call in "
                    f"{tree_differences((new_f, diag), first)}")
            walls.append(wall)
        del first
        peak = torch.cuda.max_memory_allocated() / 2**30
        subcycles = diag["subcycles"]
        n_it = int(diag["n_iterations"])
        conv = float(diag["converged"].float().mean())
        for key, val in new_f.items():
            if val.shape != (N_FLAGSHIP,) or not bool(
                    torch.isfinite(val).all()):
                raise AssertionError(f"f{precision} {key}: bad output")
        if diag["trips"] == 0:
            raise AssertionError(f"f{precision}: no outer trip ran")
        eager_s, capture_s, wall = walls
        if precision == 64:
            self.path_launches["compacted"] = ran
            self.compact64 = (new_f, diag, wall)
            self.compact64_eager = eager_s
            self.flagship64 = cd
        else:
            self.compact32 = (new_f, diag, wall)
            self.compact32_eager = eager_s
        msg = (f"f{precision} compacted, {N_FLAGSHIP} cells dt "
               f"{DT_FLAGSHIP}, timed call: a replay, {wall:.3f} s, "
               f"{N_FLAGSHIP / wall:.0f} cells/s (the context's eager first "
               f"call {eager_s:.3f} s, its capturing second call "
               f"{capture_s:.3f} s; all three bit-identical), n_iterations "
               f"{n_it}, outer trips {diag['trips']}, subcycles run "
               f"{subcycles}, converged {conv:.6f}, peak {peak:.2f} GiB, "
               f"kernel launches {launches} (replayed)")
        if precision == 32 and getattr(self, "compact64", None) is not None:
            e64 = self.compact64[0]["energy"]
            rel = (new_f["energy"].double() - e64).abs() / e64.abs()
            msg += (f"; energy vs f64: median rel {float(rel.median()):.2e}"
                    f" max {float(rel.max()):.2e}")
        return msg

    def loop_kernel(self):
        """The loop-control kernel (csrc/graph_loop.cu) against its plain
        predicate on masks of LOOP_WIDTHS (one at an odd byte offset) and
        the (step, advance, cap) triples of LOOP_STEPS; a toy WHILE over a
        counter runs exactly the expected iterations for several masks,
        caps and blocks; its time a launch inside a WHILE node (the node
        re-run LOOP_TIMED times, the body the kernel alone) beside the
        plain predicate's eager time and the bound.  Returns the
        message; sets the loop kernel's line."""
        import torch

        from grackle_tpu_torch.ops import device_loop, graph_loop

        device_loop.device_launches = None
        rng = np.random.default_rng(5)
        checked, worst = 0, 0
        for n in LOOP_WIDTHS:
            for density in (0.0, 1.0 / n, 0.5, 1.0):
                raw = torch.from_numpy(rng.random(n + 1) < density).cuda()
                for mask in (raw[:n], raw[1:]):
                    for step0, advance, cap in LOOP_STEPS:
                        step = torch.full((), step0, dtype=torch.int64,
                                          device="cuda")
                        value = torch.zeros((), dtype=torch.int32,
                                            device="cuda")
                        want_step, want = graph_loop.plain_predicate(
                            mask, step.clone(), advance, cap)
                        graph_loop.cond(mask, step, advance, cap,
                                        value_out=value)
                        err = max(abs(int(value) - int(want)),
                                  abs(int(step) - int(want_step)))
                        worst = max(worst, err)
                        checked += 1
        if worst:
            raise AssertionError(f"loop kernel vs plain predicate: worst "
                                 f"difference {worst} over {checked} cases")

        toys = []
        # (lanes set, cap, block, iterations): no trip, a cap that is and
        # one that is not a multiple of the block, no cap (the counter
        # limit of 5 read once every 3 steps)
        for lanes, cap, block, want in ((0, 10, 4, 0), (1, 10, 4, 10),
                                        (4099, 13, 8, 13), (4099, 16, 8, 16),
                                        (1, 1, 1, 1), (7, None, 3, 6)):
            mask = torch.zeros(4099, dtype=torch.bool, device="cuda")
            mask[4099 - lanes:] = True
            count0 = torch.zeros((), dtype=torch.int64, device="cuda")
            limit = 5 if cap is None else None

            def cond(c, limit=limit):
                return c[1] & (c[0] < limit) if limit else c[1]

            def body(c, _):
                return c[0] + 1, c[1]

            (eager, _), steps = device_loop.device_while(
                cond, body, (count0, mask), cap, block)
            graph, ((count, _), gsteps), _ = capture_graph(
                lambda: device_loop.device_while(cond, body, (count0, mask),
                                                 cap, block), reps=2)
            toys.append(f"{lanes} lanes cap {cap} block {block}: "
                        f"{int(count)} iterations")
            if not int(count) == int(eager) == steps == int(gsteps) == want:
                raise AssertionError(f"toy WHILE: {toys[-1]}, eager "
                                     f"{int(eager)}, want {want}")
            del graph

        # the kernel's time a launch: a WHILE node whose body is the
        # kernel alone, on the flagship-wide mask, LOOP_TIMED iterations a
        # replay
        mask = torch.ones(N_FLAGSHIP, dtype=torch.bool, device="cuda")
        counter = torch.zeros((), dtype=torch.int64, device="cuda")

        def timed_loop():
            device = torch.device("cuda", torch.cuda.current_device())
            counter.zero_()
            handle = graph_loop.handle(device)
            graph_loop.cond(mask, counter, 0, LOOP_TIMED, handle)
            body = torch.cuda.Stream()
            graph_loop.begin(device, body, handle)
            with torch.cuda.stream(body):
                graph_loop.cond(mask, counter, 1, LOOP_TIMED, handle)
            graph_loop.end(body)
            return counter

        graph, _, stats = capture_graph(timed_loop)
        del graph
        if int(counter) != LOOP_TIMED:
            raise AssertionError(f"timed WHILE ran {int(counter)} "
                                 f"iterations, not {LOOP_TIMED}")
        ms = stats["replay"] * 1e3 / LOOP_TIMED
        step = torch.zeros((), dtype=torch.int64, device="cuda")
        plain_ms = cuda_median_ms(
            lambda: graph_loop.plain_predicate(mask, step, 1, LOOP_TIMED))
        bound = (N_FLAGSHIP + 16) / HBM_BYTES_PER_S * 1e3
        self.loop["max_abs_err"] = float(worst)
        self.loop.update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by="bytes")
        return (f"{checked} masks and counters against the plain predicate "
                f"(mask.any() & (step < cap)): identical; toy WHILE "
                f"iterations: {'; '.join(toys)}; {ms * 1e3:.2f} us a launch "
                f"inside a WHILE node on {N_FLAGSHIP} lanes (replay of "
                f"{LOOP_TIMED} iterations / {LOOP_TIMED}), plain predicate "
                f"{plain_ms * 1e3:.2f} us (CUDA events, L2 flushed), bound "
                f"{bound * 1e3:.3f} us (bytes)")

    def captured(self):
        """Phase 4m: the solve as one device program.  The loop kernel
        against its plain predicate (loop_kernel); then
        functional.make_solve_fn and the caller's own operations captured
        into a torch.cuda.CUDAGraph under set_sync_debug_mode("error")
        and replayed, every replay bit-identical to the eager solve: the
        f64 flagship on the compacted path (after one eager warm-up of
        the closure with the 0-d dt), the same graph with dt = DT_SECOND
        copied into its dt, STEPS_GRAPH steps and an energy floor in one
        graph, the f32 flagship (the nested dust Newton loop), the
        monolithic f64 flagship, 4c's chemistry-0 tabulated state (the
        fixed point), and one cooling_cell step of one cell; the
        STEPS_GRAPH-step graph and a one-step graph of another state
        replayed at the same time on two streams; the cooling-time and
        dust-temperature closures on the f64 flagship state.  The eager
        references are phases 4, 4b and 4c; phase 4's runs of the same
        configurations are the f32, monolithic and tabulated warm-ups.
        Each run prints its own line; the last one counts the loop-body
        pools left once every graph is deleted, which must be none."""
        import torch

        import grackle_tpu_torch.functional as gfn
        from grackle_tpu_torch import chemistry_data, setup_fluid_container
        from grackle_tpu_torch.data.synthetic import synthetic_cloudy_groups
        from grackle_tpu_torch.ops import device_loop, graph_loop, kernel_lib
        from grackle_tpu_torch.utilities.physical_constants import (
            cm_per_mpc, mass_hydrogen_cgs, sec_per_Myr)

        for attr, phase in (("compact64", "4 f64"), ("compact32", "4 f32"),
                            ("mono64", "4b"), ("tabulated64", "4c f64")):
            if getattr(self, attr, None) is None:
                raise AssertionError(f"phase {phase} did not complete")
        # graphs of earlier phases' contexts (phase 4's) hold their pools
        pools_before = set(device_loop._pools)
        parts = [self.loop_kernel()]
        print(f"[4m loop kernel] {parts[0]}", flush=True)

        launches = torch.zeros((), dtype=torch.int64, device="cuda")
        replay_subcycles = 0

        def run(label, call, ref_f, ref_d, reps=REPLAYS, eager_s=None):
            """Capture call(), replay it reps times and hold the outputs
            to the eager solve's; print the run's line."""
            nonlocal replay_subcycles
            graph, (out_f, out_d), stats = capture_graph(call, reps)
            differ = bit_differences(out_f, out_d, ref_f, ref_d)
            if not torch.equal(out_d["converged"], ref_d["converged"]):
                differ.append("converged")
            subs = int(out_d["subcycles"])
            if subs != int(ref_d["subcycles"]):
                differ.append(f"subcycles {subs} (eager "
                              f"{int(ref_d['subcycles'])})")
            replay_subcycles += subs * reps
            msg = (f"{label}: {graph_stats(stats)}; eager "
                   + (f"{eager_s:.4f} s" if eager_s is not None
                      else "not timed")
                   + f"; device subcycle counter {subs}, trips "
                   f"{int(out_d['trips'])}; "
                   + ("bit-identical to the eager solve" if not differ
                      else f"DIFFERS from the eager solve in {differ}"))
            print(f"[4m {label}] {msg}", flush=True)
            if differ:
                raise AssertionError(msg)
            parts.append(msg)
            return graph, out_f, out_d

        def run_field(label, call, ref, eager_s):
            """run() for a derived-field closure: one [N] tensor."""
            graph, out, stats = capture_graph(call)
            same = same_bits(out, ref)
            msg = (f"{label}: {graph_stats(stats)}; eager {eager_s:.4f} s; "
                   + ("bit-identical to the eager call" if same
                      else "DIFFERS from the eager call"))
            print(f"[4m {label}] {msg}", flush=True)
            if not same:
                raise AssertionError(msg)
            parts.append(msg)

        device_loop.device_launches = launches
        zero_launches()
        graph_loop.cond.launches = 0
        try:
            # the f64 flagship on the compacted path, then a second dt
            comp_f, comp_d, comp_wall = self.compact64
            cd = self.flagship64
            solve = gfn.make_solve_fn(cd)
            host_fields = flagship_fields(cd, N_FLAGSHIP)
            fields = device_fields(host_fields)
            dt = torch.tensor(DT_FLAGSHIP, dtype=torch.float64,
                              device="cuda")
            torch.cuda.synchronize()
            t0 = time.time()
            warm_f, warm_d = solve(fields, dt)
            torch.cuda.synchronize()
            warm_s = time.time() - t0
            if bit_differences(warm_f, warm_d, comp_f, comp_d):
                raise AssertionError("the closure's eager solve with a 0-d "
                                     "dt differs from phase 4's")
            del warm_f, warm_d
            graph, out_f, out_d = run(
                f"f64 compacted {N_FLAGSHIP} cells dt {DT_FLAGSHIP}",
                lambda: solve(fields, dt), comp_f, comp_d,
                eager_s=warm_s)
            dt.fill_(DT_SECOND)
            torch.cuda.synchronize()
            t0 = time.time()
            graph.replay()
            torch.cuda.synchronize()
            second_s = time.time() - t0
            t0 = time.time()
            with uncached():
                ref_f, ref_d = cd.solve_chemistry(host_fields, DT_SECOND)
            torch.cuda.synchronize()
            eager_s = time.time() - t0
            differ = bit_differences(out_f, out_d, ref_f, ref_d)
            if int(out_d["subcycles"]) != ref_d["subcycles"]:
                differ.append("subcycles")
            replay_subcycles += int(out_d["subcycles"])
            msg = (f"same graph, dt {DT_SECOND} copied into its dt: replay "
                   f"{second_s:.4f} s, eager {eager_s:.4f} s, "
                   f"{int(out_d['subcycles'])} subcycles; "
                   + ("bit-identical to the eager solve" if not differ
                      else f"DIFFERS in {differ}"))
            print(f"[4m second dt] {msg}", flush=True)
            if differ:
                raise AssertionError(msg)
            parts.append(msg)
            dt.fill_(DT_FLAGSHIP)
            del graph, out_f, out_d, ref_f, ref_d

            # the derived-field closures on the same state (the dust
            # temperature's Newton and bisection loops)
            for name in ("cooling_time", "dust_temperature"):
                fn = getattr(gfn, f"make_{name}_fn")(cd)
                torch.cuda.synchronize()
                t0 = time.time()
                ref = fn(fields)
                torch.cuda.synchronize()
                run_field(f"make_{name}_fn {N_FLAGSHIP} cells",
                          lambda: fn(fields), ref, time.time() - t0)
            del fn, ref, fields
            torch.cuda.empty_cache()

            # several steps and the caller's energy floor in one graph
            cd3 = flagship_chem(64, "cuda")
            solve3 = gfn.make_solve_fn(cd3)
            fields3 = device_fields(flagship_fields(cd3, N_STEPS_GRAPH))
            dt3 = torch.tensor(DT_FLAGSHIP, dtype=torch.float64,
                               device="cuda")

            def steps():
                f, total = fields3, 0
                for _ in range(STEPS_GRAPH):
                    new, diag = solve3(f, dt3)
                    floor = ENERGY_FLOOR * f["energy"]
                    f = dict(new, energy=torch.maximum(new["energy"],
                                                       floor))
                    total = total + diag["subcycles"]
                # the last step's diagnostics, every step's subcycles
                return f, dict(diag, subcycles=total)

            torch.cuda.synchronize()
            t0 = time.time()
            ref_f, ref_d = steps()
            torch.cuda.synchronize()
            eager_s = time.time() - t0
            graph, out_f, out_d = run(
                f"{STEPS_GRAPH} steps and an energy floor, "
                f"{N_STEPS_GRAPH} cells", steps, ref_f, ref_d,
                eager_s=eager_s)

            # a graph of one step of another state, then both graphs
            # replayed at the same time on two streams: each graph's loop
            # bodies have a pool of their own
            fields3b = device_fields(flagship_fields(cd3, N_STEPS_GRAPH,
                                                     seed=12))
            torch.cuda.synchronize()
            t0 = time.time()
            ref_fb, ref_db = solve3(fields3b, dt3)
            torch.cuda.synchronize()
            graph_b, out_fb, out_db = run(
                f"one step of another state, {N_STEPS_GRAPH} cells",
                lambda: solve3(fields3b, dt3), ref_fb, ref_db,
                eager_s=time.time() - t0)
            pairs = ((graph, out_f, out_d, ref_f, ref_d),
                     (graph_b, out_fb, out_db, ref_fb, ref_db))
            msg = concurrent_replays(pairs, (fields3, fields3b, dt3))
            replay_subcycles += int(out_d["subcycles"]) \
                + int(out_db["subcycles"])
            print(f"[4m two streams] {msg}", flush=True)
            parts.append(msg)
            del graph, graph_b, pairs, out_f, out_d, out_fb, out_db
            del ref_f, ref_d, ref_fb, ref_db, fields3, fields3b

            # the f32 flagship (the nested dust Newton loop), the
            # monolithic f64 flagship, the subcycled tabulated state
            cd32 = flagship_chem(32, "cuda")
            f32_f, f32_d, _ = self.compact32
            fields = device_fields(flagship_fields(cd32, N_FLAGSHIP))
            solve32 = gfn.make_solve_fn(cd32)
            graph, _, _ = run(f"f32 compacted {N_FLAGSHIP} cells",
                              lambda: solve32(fields, dt), f32_f, f32_d,
                              eager_s=self.compact32_eager)
            del graph, fields
            torch.cuda.empty_cache()

            mono_f, mono_d = self.mono64
            cdm = flagship_chem(64, "cuda", solver_compaction=0)
            fields = device_fields(flagship_fields(cdm, N_FLAGSHIP))
            solvem = gfn.make_solve_fn(cdm)
            graph, _, _ = run(f"f64 monolithic {N_FLAGSHIP} cells",
                              lambda: solvem(fields, dt), mono_f, mono_d,
                              eager_s=getattr(self, "mono64_wall", None))
            del graph, fields
            torch.cuda.empty_cache()

            tab_fields, tab_f, tab_d, tab_wall = self.tabulated64
            cdt = answer_chem("cuda", primordial_chemistry=0,
                              metal_cooling=1, exact_cooling=0)
            fields = device_fields(tab_fields)
            solvet = gfn.make_solve_fn(cdt)
            dt_tab = torch.tensor(DT_EXACT, dtype=torch.float64,
                                  device="cuda")
            graph, _, _ = run(f"chemistry 0 tabulated {N_FLAGSHIP} cells "
                              f"dt {DT_EXACT}",
                              lambda: solvet(fields, dt_tab), tab_f, tab_d,
                              eager_s=tab_wall)
            del graph, fields
            torch.cuda.empty_cache()

            # one cooling_cell step of one cell
            cc = chemistry_data()
            cc.use_grackle = 1
            cc.with_radiative_cooling = 1
            cc.primordial_chemistry = 0
            cc.metal_cooling = 1
            cc.UVbackground = 1
            cc.comoving_coordinates = 0
            cc.a_units = 1.0
            cc.a_value = 1.0
            cc.density_units = mass_hydrogen_cgs
            cc.length_units = cm_per_mpc
            cc.time_units = sec_per_Myr
            fc = setup_fluid_container(
                cc, density=0.1 * mass_hydrogen_cgs,
                temperature=np.array([1.0e6]), converge=False,
                verbose=False, device="cuda",
                cloudy_data=synthetic_cloudy_groups())
            fields = device_fields(fc._solver_fields())
            # the example's first step: 1% of the cooling time
            dt_cell = torch.tensor(
                0.01 * abs(float(cc.calculate_cooling_time(fields)[0])),
                dtype=torch.float64, device="cuda")
            solvec = gfn.make_solve_fn(cc)
            times = []
            for _ in range(REPLAYS):
                torch.cuda.synchronize()
                t0 = time.time()
                ref_f, ref_d = solvec(fields, dt_cell)
                torch.cuda.synchronize()
                times.append(time.time() - t0)
            graph, _, _ = run("one cooling_cell step, 1 cell",
                              lambda: solvec(fields, dt_cell), ref_f, ref_d,
                              reps=CELL_REPLAYS,
                              eager_s=float(np.median(times)))
            del graph
        finally:
            device_loop.device_launches = None
        torch.cuda.synchronize()
        parts.append(released_pools(pools_before))
        print(f"[4m pools] {parts[-1]}", flush=True)
        loop_launches = int(launches)
        ran = kernel_lib.replayed()
        replayed = ran[NETWORK]
        if (not replay_subcycles or not loop_launches
                or replayed != replay_subcycles):
            raise AssertionError(f"the replays ran {replay_subcycles} "
                                 f"subcycles, {replayed} network kernel "
                                 f"launches and {loop_launches} loop "
                                 f"kernel launches")
        for what in (DUST, RATES):
            if not 0 < ran[what] <= replay_subcycles:
                raise AssertionError(f"the replays ran {ran[what]} {what} "
                                     f"launches in {replay_subcycles} "
                                     f"subcycles")
        self.path_launches["captured_replays"] = ran
        self.loop["launches"] = loop_launches
        parts.append(f"replays: {replayed} network kernel launches and "
                     f"{loop_launches} loop kernel launches (both counted "
                     f"on the device; the device subcycle counters "
                     f"{replay_subcycles})")
        return "; ".join(parts)

    def stateful_replays(self):
        """Phase 4n: the stateful API replayed (graph_cache.py).  Each
        entry makes calls of one context: the eager first call, the
        second (captured into a CUDA graph and replayed), and replays
        with new inputs and a new dt, then the first inputs again.  Each
        call must be bit-identical to the uncached body on the same
        inputs (api.solve_prepared or ops/derived, the cache bypassed:
        fields, cell_iterations, converged, subcycles), launch the
        network kernel once a subcycle, and leave the tensors the
        previous call returned as they were; the cache never holds more
        than its bound; a call at a changed a_value replays the graph it
        has, bit-identical to the uncached body at that a_value.  The
        entries: the f64 flagship on the compacted
        path and exact tabulated cooling at N_FLAGSHIP cells; phase 4e's
        old-style rank-5 chemistry 1; a chemistry-2 UVB state with H2
        self-shielding 1 through solve_chemistry_grid on phase 3's
        ghost-zoned grid; the five calculate_* on the flagship state;
        CELL_STEPS cooling_cell steps of one cell, then one more width
        than the bound; N_SHARDS shards of the flagship.  Each line gives
        per kind of call the wall seconds (replays: median), and per
        capture the graph's nodes (its own and its WHILE bodies') and
        pools, beside the card's name and power limit.  Between them: a
        cosmological host (the flagship and the UVB grid at several
        a_values, each call a replay), the scalar block's copy timed, and
        the held-memory check (held_memory).  Last, no loop-body pool of
        these graphs is left once their contexts are deleted."""
        import torch

        from grackle_tpu_torch import graph_cache
        from grackle_tpu_torch.api import _compact_batch, solve_path
        from grackle_tpu_torch.ops import device_loop
        from grackle_tpu_torch.parallel.sharding import (
            make_cell_mesh, solve_chemistry_sharded)

        pools_before = set(device_loop._pools)
        captures = []

        def gib(b):
            return "not measured" if b is None else f"{b / 2**30:.3f} GiB"

        parts, total = [], collections.Counter()

        def report(label, walls, first_capture, extra=""):
            kinds = []
            for kind in CALL_KINDS:
                if walls[kind]:
                    kinds.append(f"{kind} {float(np.median(walls[kind])):.4f}"
                                 f" s" + (f" (median of {len(walls[kind])})"
                                          if len(walls[kind]) > 1 else ""))
            caps = captures[first_capture:]
            c = caps[0]
            graphs_line = (
                f"its graph: capture {c['capture']:.3f} s, end and "
                f"instantiate {c['instantiate']:.3f} s, {c['nodes']} nodes, "
                f"graph pool {gib(c['pool'])}, loop-body pool "
                f"{gib(c['body_pool'])}")
            if len(caps) > 1:
                pools = [x[k] for x in caps for k in ("pool", "body_pool")]
                graphs_line += (
                    f"; {len(caps)} graphs captured in all, their pools "
                    + gib(None if None in pools else sum(pools))
                    + " together")
            msg = (f"{label}: " + ", ".join(kinds) + f"; {graphs_line}"
                   + extra + f" ({self.card})")
            print(f"[4n {label}] {msg}", flush=True)
            parts.append(msg)

        def solve_launches(got):
            subs = got[1]["subcycles"]
            return sum(subs) if isinstance(subs, list) else subs

        def check_call(cfg, label, graphs, kind, call, args, ref, same,
                       prev, solve=True):
            """One stateful call under ``cfg``, checked; returns
            (result, wall)."""
            zero_launches()
            kinds, got, wall = stateful_call(graphs, call, *args)
            ran = launches_run()
            launches, dust = ran[NETWORK], ran[DUST]
            where = f"{label}, {kind} call"
            if set(kinds) != {kind}:
                raise AssertionError(f"{where}: the cache made {dict(kinds)}")
            if prev is not None and tree_differences(*prev):
                raise AssertionError(f"{where} overwrote the previous "
                                     f"call's result in "
                                     f"{tree_differences(*prev)}")
            if graph_cache.held(CARD_DEVICE) > graph_cache.MAX_GRAPHS:
                raise AssertionError(f"{where}: {graph_cache.held(CARD_DEVICE)} "
                                     f"graphs on the card, bound "
                                     f"{graph_cache.MAX_GRAPHS}")
            differ = same(got, ref)
            if differ:
                raise AssertionError(f"{where} differs from the uncached "
                                     f"body in {differ}")
            if solve and launches != solve_launches(got):
                raise AssertionError(f"{where}: {launches} launches for "
                                     f"{solve_launches(got)} subcycles")
            # a solve with dust runs one dust launch a subcycle; a solve
            # at chemistry 1 to 3 one rate-lookup launch a subcycle, and
            # any other call none
            if solve and dust not in (0, launches):
                raise AssertionError(f"{where}: {dust} dust launches for "
                                     f"{launches} subcycles")
            check_rates_launches(where, cfg, ran[RATES],
                                 launches if solve else 0)
            total.update(ran)
            return got, wall

        def at_a_value(cd, a_value, fn):
            """``fn()`` with ``cd``'s a_value set to ``a_value`` (its
            units refreshed, as a cosmological host refreshes them), then
            restored."""
            old = cd.a_value
            cd.a_value = a_value
            cd.refresh_units()
            try:
                return fn()
            finally:
                cd.a_value = old
                cd.refresh_units()

        def changed_a_value(label, cd, graphs, call, args, prev, same, solve):
            """A call at a_value A_VALUE_CHANGED (a solve at dt
            DT_CHANGED_A): a replay under the key the context has,
            bit-identical to the uncached body at that a_value, one
            launch a subcycle counted on the card.  Returns the
            message."""
            keys = graphs.keys()
            args = args[:-1] + (DT_CHANGED_A,) if solve else args

            def check():
                with uncached():
                    ref = call(*args)
                return check_call(cd.config,
                                  f"{label}, a_value {A_VALUE_CHANGED}",
                                  graphs, "replay", call, args, ref, same,
                                  prev, solve)

            got, wall = at_a_value(cd, A_VALUE_CHANGED, check)
            if graphs.keys() != keys:
                raise AssertionError(f"{label}: a changed a_value changed "
                                     f"the keys {len(keys)} -> "
                                     f"{len(graphs.keys())}")
            return (f"a_value {A_VALUE_CHANGED}"
                    + (f", dt {DT_CHANGED_A}" if solve else "")
                    + f": a replay under the same key, {wall:.4f} s"
                    + (f", {solve_launches(got)} launches" if solve else "")
                    + ", bit-identical to the uncached body")

        def run_entry(label, cd, graphs, call, inputs, refs=None,
                      same=tree_differences, solve=True):
            """The calls (eager "a", capture "a", replay "b", replay "a")
            of ``call(*inputs[tag])``, each against the uncached call (or
            ``refs[tag]``); then the "a" call at a changed a_value, a
            replay (changed_a_value)."""
            refs = {} if refs is None else refs
            walls = collections.defaultdict(list)
            first_capture = len(captures)
            prev = None
            for kind, tag in (("eager", "a"), ("capture", "a"),
                              ("replay", "b"), ("replay", "a")):
                if tag not in refs:
                    with uncached():
                        refs[tag] = call(*inputs[tag])
                got, wall = check_call(cd.config, label, graphs, kind,
                                       call, inputs[tag], refs[tag], same,
                                       prev, solve)
                walls[kind].append(wall)
                prev = (got, tree_clone(got))
            changed = changed_a_value(label, cd, graphs, call, inputs["a"],
                                      prev, same, solve)
            report(label, walls, first_capture,
                   f"; {changed}; {len(graphs)} graphs of the context, "
                   f"{graph_cache.held(CARD_DEVICE)} on the card (bound "
                   f"{graph_cache.MAX_GRAPHS}); every call bit-identical "
                   f"to the uncached body, no earlier result overwritten")
            return refs

        def cosmological(label, cd, graphs, call, fields, dt, a_values,
                         check=False):
            """A cosmological host: one call at each of ``a_values``, the
            units refreshed before it, under the key the context holds:
            every call a replay, no key added, its outputs finite, one
            launch a subcycle counted on the card; where ``check``, each
            bit-identical to the uncached body at its a_value.  Returns
            the message, each call's kind and wall, and the outputs in
            which it differs from the previous call's (the a_value
            reached the graph)."""
            keys = graphs.keys()
            calls, last = [], None
            for a_value in a_values:
                def one():
                    if not check:
                        zero_launches()
                        kinds, got, wall = stateful_call(graphs, call,
                                                         fields, dt)
                        if set(kinds) != {"replay"}:
                            raise AssertionError(
                                f"{label}, a_value {a_value}: the cache "
                                f"made {dict(kinds)}")
                        ran = launches_run()
                        if ran[NETWORK] != solve_launches(got):
                            raise AssertionError(
                                f"{label}, a_value {a_value}: "
                                f"{ran[NETWORK]} launches for "
                                f"{solve_launches(got)} subcycles")
                        check_dust_launches(f"{label}, a_value {a_value}",
                                            cd.config, ran[DUST],
                                            solve_launches(got))
                        check_rates_launches(f"{label}, a_value {a_value}",
                                             cd.config, ran[RATES],
                                             solve_launches(got))
                        total.update(ran)
                        for key, val in got[0].items():
                            if not bool(torch.isfinite(val).all()):
                                raise AssertionError(
                                    f"{label}, a_value {a_value}: {key} "
                                    f"not finite")
                        return got, wall
                    with uncached():
                        ref = call(fields, dt)
                    return check_call(cd.config,
                                      f"{label}, a_value {a_value}",
                                      graphs, "replay", call, (fields, dt),
                                      ref, tree_differences, None)

                got, wall = at_a_value(cd, a_value, one)
                moved = ("" if last is None else
                         ", moved from the previous call in "
                         + str(len(tree_differences(got[0], last)))
                         + " of " + str(len(got[0])) + " fields")
                last = tree_clone(got[0])
                calls.append(f"a_value {a_value:.6g}: replay {wall:.4f} s, "
                             f"{solve_launches(got)} subcycles{moved}")
            if graphs.keys() != keys:
                raise AssertionError(f"{label}: the a_values changed the "
                                     f"keys {len(keys)} -> "
                                     f"{len(graphs.keys())}")
            msg = (f"cosmological {label}, dt {dt}: " + "; ".join(calls)
                   + ("; each bit-identical to the uncached body"
                      if check else "") + f" ({self.card})")
            print(f"[4n cosmological] {msg}", flush=True)
            parts.append(msg)

        def copy_in(label, ctx):
            """The host work and copy of a call's scalar block
            (api.call_scalars: unit scalars, photo rates, one copy from
            pinned memory), host wall to the block's arrival, median of
            COPY_IN_CALLS."""
            from grackle_tpu_torch.api import call_scalars

            walls = []
            for _ in range(COPY_IN_CALLS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call_scalars(ctx, CARD_DEVICE)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            msg = (f"scalar block, {label}: {np.median(walls) * 1e6:.1f} us "
                   f"a call (median of {COPY_IN_CALLS}, host wall to the "
                   f"copy's end; min {min(walls) * 1e6:.1f} us)")
            print(f"[4n copy-in] {msg} ({self.card})", flush=True)
            parts.append(msg)

        def flagship_pair(cd, seed, dt):
            return (flagship_fields(cd, N_FLAGSHIP, seed=seed), dt)

        launches_dev = torch.zeros((), dtype=torch.int64, device="cuda")
        device_loop.device_launches = launches_dev
        real_capture = graph_cache._capture
        graph_cache._capture = lambda body, inputs: capture_measured(
            body, inputs, captures)
        try:
            # the f64 flagship on the compacted path, and the five
            # derived fields on its state
            cd = flagship_chem(64, "cuda")
            if solve_path(cd.config, N_FLAGSHIP) != "compact":
                raise AssertionError("the flagship is not compacted")
            graphs = cd.context.graphs
            inputs = {"a": flagship_pair(cd, 11, DT_FLAGSHIP),
                      "b": flagship_pair(cd, 12, DT_REPLAY)}
            flag_refs = run_entry(
                f"f64 flagship, compacted, {N_FLAGSHIP} cells, dt "
                f"{DT_FLAGSHIP} then {DT_REPLAY}", cd, graphs,
                cd.solve_chemistry, inputs)
            cosmological(f"f64 flagship, {N_FLAGSHIP} cells", cd, graphs,
                         cd.solve_chemistry, inputs["b"][0], DT_REPLAY,
                         COSMO_A_VALUES)
            copy_in("constant photo rates", cd.context)
            for name in GRID_DERIVED:
                run_entry(f"calculate_{name}, {N_FLAGSHIP} cells", cd,
                          graphs, getattr(cd, f"calculate_{name}"),
                          {tag: (pair[0],) for tag, pair in inputs.items()},
                          solve=False)
            del cd, graphs

            # exact tabulated cooling
            cd = answer_chem("cuda", primordial_chemistry=0,
                             metal_cooling=1, exact_cooling=1)
            run_entry(f"exact cooling, {N_FLAGSHIP} cells, dt {DT_EXACT} "
                      f"then {2 * DT_EXACT}", cd, cd.context.graphs,
                      cd.solve_chemistry,
                      {"a": (tabulated_state(cd, N_FLAGSHIP), DT_EXACT),
                       "b": (tabulated_state(cd, N_FLAGSHIP, seed=10),
                             2 * DT_EXACT)})
            del cd
            torch.cuda.empty_cache()

            # phase 4e's old-style rank-5 chemistry 1
            cd = old_style_chem("cuda", 5)
            run_entry(f"old-style rank 5, chemistry 1, {N_FLAGSHIP} cells, "
                      f"dt {DT_FLAGSHIP} then {DT_REPLAY}", cd,
                      cd.context.graphs, cd.solve_chemistry,
                      {"a": (answer_state(cd, n=N_FLAGSHIP), DT_FLAGSHIP),
                       "b": (answer_state(cd, n=N_FLAGSHIP, seed=5),
                             DT_REPLAY)})
            del cd

            # chemistry 2, the UVB and H2 self-shielding 1 on phase 3's
            # ghost-zoned grid
            cd = answer_chem("cuda", primordial_chemistry=2,
                             UVbackground=1, H2_self_shielding=1)
            grid = {tag: (grid_fields(cd, seed=seed)[0], dt)
                    for tag, seed, dt in (("a", 11, GRID_DT),
                                          ("b", 12, 2 * GRID_DT))}
            def grid_call(f, dt):
                return cd.solve_chemistry_grid(
                    f, dt, grid_start=GRID_START, grid_end=GRID_END,
                    grid_dx=GRID_DX)

            run_entry(f"solve_chemistry_grid, chemistry 2, UVB, H2 "
                      f"self-shielding 1, {GRID_SHAPE} grid, dt {GRID_DT} "
                      f"then {2 * GRID_DT}", cd, cd.context.graphs,
                      grid_call, grid)
            cosmological(f"UVB grid {GRID_SHAPE}, across the UVB switch-on",
                         cd, cd.context.graphs, grid_call, grid["a"][0],
                         GRID_DT, UVB_A_VALUES, check=True)
            copy_in("UVB rates at the call's redshift", cd.context)
            del cd

            self.held_memory(check_call, captures, parts)

            self.cell_replays(check_call, report, captures)

            # the flagship on N_SHARDS shards of the card, each under its
            # own key, against the flagship's uncached whole solves
            cd = flagship_chem(64, "cuda")
            mesh = make_cell_mesh(["cuda:0"] * N_SHARDS)
            width = N_FLAGSHIP // N_SHARDS
            if solve_path(cd.config, width) != "compact":
                raise AssertionError(f"a {width}-cell shard is not "
                                     f"compacted ({_compact_batch(width)})")

            def cells(res):
                return (res[0], res[1]["cell_iterations"],
                        res[1]["converged"])

            run_entry(f"{N_SHARDS} shards of {width} cells, against the "
                      f"whole flagship's uncached solves", cd,
                      cd.context.graphs,
                      lambda f, dt: solve_chemistry_sharded(
                          cd.context, f, dt, mesh),
                      inputs, refs=flag_refs,
                      same=lambda got, ref: tree_differences(cells(got),
                                                             cells(ref)))
            del cd, flag_refs, inputs
        finally:
            graph_cache._capture = real_capture
            device_loop.device_launches = None
        torch.cuda.synchronize()
        parts.append(released_pools(pools_before))
        print(f"[4n pools] {parts[-1]}", flush=True)
        self.path_launches["stateful_replays"] = dict(total)
        loop = int(launches_dev)
        self.loop["launches"] = (self.loop["launches"] or 0) + loop
        parts.append(f"stateful calls: {total[NETWORK]} network kernel "
                     f"launches (host and replayed), {loop} loop kernel "
                     f"launches in the replays (counted on the device)")
        return "; ".join(parts)

    def cell_replays(self, check_call, report, captures):
        """Phase 4n's one-cell entry: CELL_STEPS steps of the cooling_cell
        example's cell (its state, dt = 1% of its first cooling time),
        each step's result fed back in, each against the uncached body;
        then the cell at widths 2 to the bound + 1, two calls each (eager,
        capture), so that the least recently used graphs go; a changed
        a_value is a new key."""
        import torch

        from grackle_tpu_torch import (chemistry_data, graph_cache,
                                       setup_fluid_container)
        from grackle_tpu_torch.data.synthetic import synthetic_cloudy_groups
        from grackle_tpu_torch.utilities.physical_constants import (
            cm_per_mpc, mass_hydrogen_cgs, sec_per_Myr)

        cc = chemistry_data()
        cc.use_grackle = 1
        cc.with_radiative_cooling = 1
        cc.primordial_chemistry = 0
        cc.metal_cooling = 1
        cc.UVbackground = 1
        cc.comoving_coordinates = 0
        cc.a_units = 1.0
        cc.a_value = 1.0
        cc.density_units = mass_hydrogen_cgs
        cc.length_units = cm_per_mpc
        cc.time_units = sec_per_Myr
        fc = setup_fluid_container(
            cc, density=0.1 * mass_hydrogen_cgs,
            temperature=np.array([1.0e6]), metal_mass_fraction=0.02041,
            converge=False, verbose=False, device="cuda",
            cloudy_data=synthetic_cloudy_groups())
        graphs = cc.context.graphs
        fields = device_fields(fc._solver_fields())
        dt = 0.01 * abs(float(cc.calculate_cooling_time(fields)[0]))
        walls = collections.defaultdict(list)
        first_capture = len(captures)
        prev = None
        for step in range(CELL_STEPS):
            kind = CALL_KINDS[min(step, 2)]
            with uncached():
                ref = cc.solve_chemistry(fields, dt)
            got, wall = check_call(cc.config, f"cooling_cell step {step}",
                                   graphs, kind, cc.solve_chemistry,
                                   (fields, dt), ref, tree_differences,
                                   prev)
            walls[kind].append(wall)
            # the fields passed in are the last step's results
            prev = (got, tree_clone(got))
            fields = got[0]
        if [len(walls[k]) for k in CALL_KINDS] != [1, 1, CELL_STEPS - 2]:
            raise AssertionError(f"cooling_cell: calls {dict(walls)}")
        label = f"{CELL_STEPS} cooling_cell steps, 1 cell, dt {dt:.6g}"
        # the next step at a changed a_value: a replay of the same graph
        cc.a_value = A_VALUE_CHANGED
        with uncached():
            ref = cc.solve_chemistry(fields, dt)
        _, a_wall = check_call(cc.config,
                               f"cooling_cell, a_value {A_VALUE_CHANGED}",
                               graphs, "replay", cc.solve_chemistry,
                               (fields, dt), ref, tree_differences, prev)
        cc.a_value = 1.0
        # as many new widths as the bound: every capture past the bound
        # drops the least recently used graph, the one-cell step's first
        widths = range(2, graph_cache.MAX_GRAPHS + 2)
        for width in widths:
            cell = {k: v.expand(width).contiguous()
                    for k, v in fields.items()}
            with uncached():
                ref = cc.solve_chemistry(cell, dt)
            for kind in ("eager", "capture"):
                check_call(cc.config, f"cooling_cell width {width}",
                           graphs, kind, cc.solve_chemistry, (cell, dt),
                           ref, tree_differences, None)
        if len(graphs) != graph_cache.MAX_GRAPHS:
            raise AssertionError(f"cooling_cell: {len(graphs)} graphs after "
                                 f"{len(widths)} widths, bound "
                                 f"{graph_cache.MAX_GRAPHS}")
        cycle = self.width_cycle(cc, fields, dt, check_call)
        report(label, walls, first_capture,
               f"; a_value {A_VALUE_CHANGED}: a replay of the same graph, "
               f"{a_wall:.4f} s; widths 2 to {widths[-1]}, eager then "
               f"captured: {len(graphs)} graphs kept (bound "
               f"{graph_cache.MAX_GRAPHS}), the least recently used "
               f"dropped; {cycle}; every call bit-identical to the "
               f"uncached body, no earlier result overwritten")
        del cc, fc, graphs

    def held_memory(self, check_call, captures, parts):
        """Phase 4n's memory check (graph_cache.py): a new key, the f64
        flagship's cooling time at N_FLAGSHIP cells, called eagerly once;
        then a host holds all of the card but what the key's eager body
        needs and less than its capture would (halfway between its
        recorded eager peak and CAPTURE_PEAKS times it, with its inputs),
        and the key's second call stays eager; once the host lets go, the
        next call captures and the one after replays.  Every call
        bit-identical to the uncached body, none raises for memory.
        Reports the peak, the room left, and the capture's pools beside
        the peak.  Last, a host captures the same call into its own
        graph (the cache stays out of it), whose replays must give the
        uncached body's bits."""
        import torch

        from grackle_tpu_torch import graph_cache

        cd = flagship_chem(64, "cuda")
        graphs = cd.context.graphs
        fields = device_fields(flagship_fields(cd, N_FLAGSHIP, seed=13))
        call = cd.calculate_cooling_time
        with uncached():
            ref = call(fields)
        check_call(cd.config, "held memory, first call", graphs, "eager",
                   call, (fields,), ref, tree_differences, None,
                   solve=False)
        [(_, peak)] = graphs._seen.values()
        inputs = sum(v.numel() * v.element_size() for v in fields.values())
        need = graph_cache.CAPTURE_PEAKS * peak + inputs
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        device = torch.device(CARD_DEVICE)
        room = (peak + need) // 2
        held = torch.empty(int(graph_cache._free_bytes(device) - room),
                           dtype=torch.uint8, device=device)
        left = graph_cache._free_bytes(device)
        kinds = []
        try:
            _, wall = check_call(cd.config, "held memory, second call",
                                 graphs, "eager", call, (fields,), ref,
                                 tree_differences, None, solve=False)
            kinds.append(f"eager {wall:.4f} s")
        finally:
            del held
        first_capture = len(captures)
        for kind in ("capture", "replay"):
            _, wall = check_call(cd.config, f"held memory, {kind} call",
                                 graphs, kind, call, (fields,), ref,
                                 tree_differences, None, solve=False)
            kinds.append(f"{kind} {wall:.4f} s")
        c = captures[first_capture]
        pools = (None if None in (c["pool"], c["body_pool"])
                 else c["pool"] + c["body_pool"])
        # a host capturing the stateful call into its own graph: the call
        # runs its body eagerly under the capture, its scalars filled in
        # and fixed in that graph (ops/common.scalar_block)
        _, out, stats = capture_graph(lambda: call(fields))
        if tree_differences(out, ref):
            raise AssertionError("held memory: the call captured into the "
                                 "host's own graph differs from the "
                                 "uncached body")
        msg = (f"held memory, calculate_cooling_time at {N_FLAGSHIP} "
               f"cells: eager peak {peak / 2**30:.3f} GiB, inputs "
               f"{inputs / 2**30:.3f} GiB, a capture needs "
               f"{need / 2**30:.3f} GiB; a host held all but "
               f"{left / 2**30:.3f} GiB: the second call stayed eager, "
               f"then the memory let go: " + ", ".join(kinds)
               + f"; the capture's pools "
               + ("not measured" if pools is None else
                  f"{pools / 2**30:.3f} GiB ({pools / max(peak, 1):.2f} "
                  f"times the peak)")
               + f"; the same call captured into the host's own graph, "
               f"replayed {REPLAYS} times in {stats['replay']:.4f} s "
               f"(median), bit-identical; every call bit-identical to the "
               f"uncached body ({self.card})")
        print(f"[4n held memory] {msg}", flush=True)
        parts.append(msg)

    def cooling_cell_full(self):
        """The cooling_cell example on the card over its whole stored
        trajectory (the --cooling-cell-full run): every array against
        tests/answers/examples/cooling_cell.npz at ANSWER_RTOL.  Returns
        the summary the last line prints."""
        import torch

        from grackle_tpu_torch import api
        from grackle_tpu_torch.data.synthetic import synthetic_cloudy_groups
        from grackle_tpu_torch.examples import cooling_cell

        calls = collections.Counter()
        solve = api.ChemistryData.solve_chemistry

        def counted(cd, *args, **kw):
            before = cd.context.graphs.calls.copy()
            out = solve(cd, *args, **kw)
            calls.update(cd.context.graphs.calls - before)
            return out

        zero_launches()
        api.ChemistryData.solve_chemistry = counted
        t0 = time.time()
        try:
            out = cooling_cell.run(device="cuda",
                                   cloudy_data=synthetic_cloudy_groups(),
                                   verbose=False)
            torch.cuda.synchronize()
        finally:
            api.ChemistryData.solve_chemistry = solve
        wall = time.time() - t0
        errors = answer_errors("examples/cooling_cell", out)
        steps = len(out["time"])
        summary = {"steps": steps, "wall_s": wall,
                   "s_per_step": wall / max(steps, 1),
                   "calls": dict(calls), "launches": launches_run(),
                   "max_rel": errors, "rtol": ANSWER_RTOL,
                   "ok": max(errors.values()) <= ANSWER_RTOL,
                   "card": self.card}
        print(f"[cooling_cell full] {steps} steps in {wall:.1f} s "
              f"({wall / max(steps, 1):.4f} s a step; calls {dict(calls)}), "
              f"max rel {errors} (rtol {ANSWER_RTOL}) ({self.card})",
              flush=True)
        return summary

    def width_cycle(self, cc, fields, dt, check_call):
        """A host cycling through more widths than the card's bound on
        graphs: the cooling_cell state at each of CYCLE_WIDTHS, one step
        each, for CYCLE_ROUNDS rounds, every call against the uncached
        body (whose wall is the parent's, which cached nothing).  The
        first round runs eagerly; from the second, the first
        MAX_GRAPHS widths capture and then replay, and the rest stay
        eager, since capturing them would drop a graph used since their
        last call (graph_cache.py).  Returns the message: per round the
        kinds of call and the mean wall per call, cached and uncached."""
        import torch

        from grackle_tpu_torch import graph_cache

        bound = graph_cache.MAX_GRAPHS
        fit = len(CYCLE_WIDTHS[:bound])
        rounds = []
        for r in range(CYCLE_ROUNDS):
            expect = (["eager"] * len(CYCLE_WIDTHS) if r == 0 else
                      [("capture" if r == 1 else "replay")] * fit
                      + ["eager"] * (len(CYCLE_WIDTHS) - fit))
            cached, plain = [], []
            for width, kind in zip(CYCLE_WIDTHS, expect):
                cell = {k: v.expand(width).contiguous()
                        for k, v in fields.items()}
                torch.cuda.synchronize()
                t0 = time.time()
                with uncached():
                    ref = cc.solve_chemistry(cell, dt)
                torch.cuda.synchronize()
                plain.append(time.time() - t0)
                _, wall = check_call(cc.config,
                                     f"width cycle round {r}, {width} "
                                     f"cells", cc.context.graphs, kind,
                                     cc.solve_chemistry, (cell, dt), ref,
                                     tree_differences, None)
                cached.append(wall)
            rounds.append(f"round {r + 1}: "
                          + ", ".join(f"{expect.count(k)} {k}"
                                      for k in CALL_KINDS if k in expect)
                          + f", {np.mean(cached):.4f} s a call (uncached "
                          f"{np.mean(plain):.4f} s)")
        msg = (f"a host cycling through {len(CYCLE_WIDTHS)} widths "
               f"({CYCLE_WIDTHS[0]} to {CYCLE_WIDTHS[-1]} cells), bound "
               f"{bound}: " + "; ".join(rounds))
        print(f"[4n width cycle] {msg} ({self.card})", flush=True)
        return msg

    def profiled_kernel(self):
        """The kernel line's launch (f64 flagship inputs at subcycle
        CAPTURE_AT[1], cut to the compacted batch) timed with CUDA events
        and by torch.profiler's duration of the kernel."""
        from grackle_tpu_torch.api import _compact_batch
        from grackle_tpu_torch.ops.network_kernel import prepare_launch

        batch = _compact_batch(N_FLAGSHIP)
        cd = flagship_chem(64, "cuda")
        [(step, inp)] = capture_network_inputs(
            cd, flagship_fields(cd, N_FLAGSHIP), DT_FLAGSHIP,
            CAPTURE_AT[1:])
        view = head_inputs(inp, batch)
        launch, _ = prepare_launch(
            cd.context.config, view["us"], view["dt"], view["f"],
            view["rs"], view["cool_v"], view["carry_v"], view["h2_limit"])
        ms = cuda_median_ms(launch)
        prof_ms = profiler_kernel_ms(launch, "network_update_kernel")
        return (f"f64 subcycle {step}, {batch} cells: CUDA events {ms:.4f} "
                f"ms, torch.profiler kernel duration "
                + (f"{prof_ms:.4f} ms" if prof_ms is not None
                   else "not measured (no kernel recorded)"))

    def monolithic(self):
        """One monolithic f64 flagship solve (solver_compaction = 0, no
        warm-up), the uncached body (no graph): its fields and per-cell
        subcycle counts must equal phase 4's replayed compacted f64 solve
        bit for bit."""
        import torch

        if getattr(self, "compact64", None) is None:
            raise AssertionError("phase 4 f64 did not complete")
        comp_f, comp_d, comp_wall = self.compact64
        cd = flagship_chem(64, "cuda", solver_compaction=0)
        fields = flagship_fields(cd, N_FLAGSHIP)
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.time()
        with uncached():
            new_f, diag = cd.solve_chemistry(fields, DT_FLAGSHIP)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = launches_run()[NETWORK]
        if diag["trips"] != 0 or launches != diag["subcycles"]:
            raise AssertionError(f"monolithic: {diag['trips']} trips, "
                                 f"{launches} launches for "
                                 f"{diag['subcycles']} subcycles")
        differ = bit_differences(new_f, diag, comp_f, comp_d)
        if differ:
            raise AssertionError(f"monolithic vs compacted differ in "
                                 f"{differ}")
        self.mono64 = (new_f, diag)
        self.mono64_wall = wall
        return (f"f64 monolithic, eager (uncached), {wall:.3f} s "
                f"({N_FLAGSHIP / wall:.0f} cells/s, {launches} launches) "
                f"against phase 4's compacted replay {comp_wall:.3f} s "
                f"({comp_d['subcycles']} launches, "
                f"{comp_d['trips']} trips): {len(new_f)} fields and "
                f"cell_iterations bit-identical")

    def exact(self, precision):
        """Exact-integration tabulated cooling (exact_cooling = 1, metal
        cooling) on N_FLAGSHIP cells at DT_EXACT through the stateful
        API: three calls of one context (eager, capturing, replayed; the
        replay timed, each bit-identical to the first), cells/s, the
        eager call's peak CUDA memory and the graph's pool, with no
        kernel launch; the
        subcycled tabulated solve of the same state beside it (median
        within EXACT_VS_SUBCYCLED, its furthest cells against the refined
        solve); the first N_CPU_CHECK cells against the port's CPU run
        within EXACT_CPU_RTOL."""
        import torch

        from grackle_tpu_torch.api import solve_path

        def chem(device, exact):
            return answer_chem(device, precision=precision,
                               primordial_chemistry=0, metal_cooling=1,
                               exact_cooling=exact)

        cd = chem("cuda", 1)
        if solve_path(cd.config, N_FLAGSHIP) != "exact":
            raise AssertionError("exact_cooling = 1 does not take 'exact'")
        fields = tabulated_state(cd, N_FLAGSHIP)
        graphs = cd.context.graphs
        walls, first = [], None
        for kind in CALL_KINDS:
            torch.cuda.reset_peak_memory_stats()
            zero_launches()
            kinds, (new_f, diag), wall = stateful_call(
                graphs, cd.solve_chemistry, fields, DT_EXACT)
            if kind == "eager":
                peak = torch.cuda.max_memory_allocated() / 2**30
                first = (new_f, diag)
            differ = tree_differences((new_f, diag), first)
            if kinds != {kind: 1} or differ:
                raise AssertionError(f"f{precision} exact: call "
                                     f"{len(walls) + 1} was {dict(kinds)}, "
                                     f"not {kind}, differs in {differ}")
            walls.append(wall)
        del first
        graph_pool = pool_bytes(graphs.entry(graphs.keys()[0]).graph.pool())
        eager_s, capture_s, wall = walls
        energy = new_f["energy"]
        if (launches_run()[NETWORK] or diag["subcycles"]
                or energy.shape != (N_FLAGSHIP,)
                or not bool(torch.isfinite(energy).all())):
            raise AssertionError(f"f{precision} exact: bad output or a "
                                 f"kernel launch")
        del cd, graphs
        torch.cuda.empty_cache()

        sub = chem("cuda", 0)
        torch.cuda.synchronize()
        t0 = time.time()
        with uncached():
            sub_f, sub_d = sub.solve_chemistry(fields, DT_EXACT)
        torch.cuda.synchronize()
        sub_wall = time.time() - t0
        if precision == 64:
            self.tabulated64 = (fields, sub_f, sub_d, sub_wall)
        if not bool(sub_d["converged"].all()):
            raise AssertionError("subcycled: a cell hit max_iterations")
        rel = ((energy - sub_f["energy"]).abs()
               / sub_f["energy"].abs()).double()
        median = float(rel.median())
        over = int((rel >= EXACT_VS_SUBCYCLED["max"]).sum())
        if getattr(self, "exact_tail", None) is None:
            # the f64 run's furthest cells, and their refined energy, serve
            # the f32 run too: the refined solve is the slow part
            tail = torch.topk(rel, EXACT_TAIL).indices.cpu()
            self.exact_tail = tail, refined_tabulated_energy(
                {k: v[tail.numpy()] for k, v in fields.items()}, DT_EXACT)
        tail, ref = self.exact_tail
        tail_exact = max_rel(energy[tail].double(), ref)
        tail_sub = max_rel(sub_f["energy"][tail].double(), ref)
        bound = EXACT_CPU_RTOL[energy.element_size()]
        if precision == 64:
            self.exact64 = energy
            vs64 = 0.0
        elif getattr(self, "exact64", None) is None:
            raise AssertionError("phase 4c f64 did not complete")
        else:
            vs64 = max_rel(energy.double(), self.exact64)

        head = {k: v[:N_CPU_CHECK] for k, v in fields.items()}
        cpu = chem("cpu", 1).solve_chemistry(head, DT_EXACT)[0]["energy"]
        cpu_err = max_rel(energy[:N_CPU_CHECK], cpu)
        gib = ("not measured" if graph_pool is None
               else f"{graph_pool / 2**30:.2f} GiB")
        msg = (f"f{precision} exact, {N_FLAGSHIP} cells dt {DT_EXACT}, "
               f"timed call: a replay, {wall:.4f} s, {N_FLAGSHIP / wall:.0f} "
               f"cells/s (eager first call {eager_s:.4f} s, peak "
               f"{peak:.2f} GiB; capturing second call {capture_s:.3f} s; "
               f"graph pool {gib}; all three bit-identical), 0 kernel "
               f"launches; subcycled, eager (uncached), {sub_wall:.3f}"
               f" s ({sub_d['subcycles']} subcycles, {sub_d['trips']} "
               f"trips); exact vs subcycled rel median {median:.2e} "
               f"(bound {EXACT_VS_SUBCYCLED['median']:.0e}), max "
               f"{float(rel.max()):.2e}, {over} cells over "
               f"{EXACT_VS_SUBCYCLED['max']:.0e}; its "
               f"{EXACT_TAIL} furthest cells vs {EXACT_REFINE_STEPS} "
               f"substeps: exact {tail_exact:.2e} (bound "
               f"{EXACT_VS_SUBCYCLED['max']:.0e}), subcycled "
               f"{tail_sub:.2e}; first {N_CPU_CHECK} cells vs CPU max rel "
               f"{cpu_err:.2e}" + (f", every cell vs the f64 step max rel "
                                   f"{vs64:.2e}" if precision == 32 else "")
               + f" (bound {bound:.0e})")
        if (median >= EXACT_VS_SUBCYCLED["median"]
                or tail_exact >= EXACT_VS_SUBCYCLED["max"]
                or cpu_err > bound or vs64 > bound):
            raise AssertionError(msg)
        self.path_launches["exact"] = {NETWORK: 0}
        return msg

    def functional_flagship(self):
        """functional.make_solve_fn on the f64 flagship: its fields and
        per-cell subcycle counts must equal phase 4's compacted f64 solve
        bit for bit, with one kernel launch a subcycle."""
        import torch

        import grackle_tpu_torch.functional as gfn

        if getattr(self, "compact64", None) is None:
            raise AssertionError("phase 4 f64 did not complete")
        comp_f, comp_d, comp_wall = self.compact64
        cd = flagship_chem(64, "cuda")
        solve = gfn.make_solve_fn(cd)
        fields = flagship_fields(cd, N_FLAGSHIP)
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.time()
        new_f, diag = solve(fields, DT_FLAGSHIP)
        torch.cuda.synchronize()
        wall = time.time() - t0
        ran = launches_run()
        launches = ran[NETWORK]
        if launches != diag["subcycles"] or launches == 0:
            raise AssertionError(f"functional: {launches} launches for "
                                 f"{diag['subcycles']} subcycles")
        differ = bit_differences(new_f, diag, comp_f, comp_d)
        if differ:
            raise AssertionError(f"make_solve_fn vs compacted differ in "
                                 f"{differ}")
        check_dust_launches("functional", cd.config, ran[DUST],
                            diag["subcycles"])
        check_rates_launches("functional", cd.config, ran[RATES],
                             diag["subcycles"])
        self.path_launches["functional"] = ran
        return (f"f64 make_solve_fn {wall:.3f} s ({N_FLAGSHIP / wall:.0f} "
                f"cells/s, no warm-up; {launches} launches, "
                f"{diag['trips']} trips) against phase 4's stateful "
                f"compacted calls (eager {self.compact64_eager:.3f} s, "
                f"replay {comp_wall:.3f} s): {len(new_f)} fields and "
                f"cell_iterations bit-identical")

    def old_style(self):
        """Old-style rank-5 Cloudy metal cooling with primordial_chemistry
        = 1 on N_FLAGSHIP cells of the answer-workload state, f64, at
        DT_FLAGSHIP (the default compacted path, one call): wall seconds,
        kernel launches (must equal the subcycles) and converged share;
        the first N_CPU_CHECK cells against the port's CPU solve at rtol
        ANSWER_RTOL."""
        import torch

        cd = old_style_chem("cuda", 5)
        if cd.context.cloudy_data_new or cd.context.cloudy_metal.grid_rank \
                != 5:
            raise AssertionError("the rank-5 old-style table was not read")
        fields = answer_state(cd, n=N_FLAGSHIP)
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.time()
        new_f, diag = cd.solve_chemistry(fields, DT_FLAGSHIP)
        torch.cuda.synchronize()
        wall = time.time() - t0
        ran = launches_run()
        launches = ran[NETWORK]
        for key, val in new_f.items():
            if val.shape != (N_FLAGSHIP,) or not bool(
                    torch.isfinite(val).all()):
                raise AssertionError(f"old-style {key}: bad output")
        if launches != diag["subcycles"] or launches == 0:
            raise AssertionError(f"old-style: {launches} launches for "
                                 f"{diag['subcycles']} subcycles")
        head = {k: v[:N_CPU_CHECK] for k, v in fields.items()}
        cpu_f, _ = old_style_chem("cpu", 5).solve_chemistry(head,
                                                             DT_FLAGSHIP)
        worst = max(max_rel(new_f[k][:N_CPU_CHECK], cpu_f[k])
                    for k in cpu_f)
        conv = float(diag["converged"].float().mean())
        msg = (f"f64 old-style rank 5, chemistry 1, {N_FLAGSHIP} cells dt "
               f"{DT_FLAGSHIP}: {wall:.3f} s ({N_FLAGSHIP / wall:.0f} "
               f"cells/s, one call), {launches} launches, {diag['trips']} "
               f"trips, converged {conv:.6f}; first {N_CPU_CHECK} cells vs "
               f"CPU max rel {worst:.2e}")
        if worst > ANSWER_RTOL:
            raise AssertionError(msg)
        check_dust_launches("old-style", cd.config, ran[DUST],
                            diag["subcycles"])
        check_rates_launches("old-style", cd.config, ran[RATES],
                             diag["subcycles"])
        self.path_launches["old_style"] = ran
        self.old5 = (new_f, diag)
        return msg

    def serialization(self):
        """to_dict of phase 4's f64 flagship ChemistryData through JSON,
        then from_dict on the card with the in-memory tables given again:
        the restored context's solve of the flagship state must equal
        phase 4's bit for bit, fields and per-cell subcycle counts, with
        as many kernel launches."""
        import torch

        from grackle_tpu_torch import serialization
        from grackle_tpu_torch.data.synthetic import synthetic_cloudy_groups

        if getattr(self, "flagship64", None) is None:
            raise AssertionError("phase 4 f64 did not complete")
        comp_f, comp_d, comp_wall = self.compact64
        state = serialization.to_dict(self.flagship64)
        cd = serialization.from_dict(json.loads(json.dumps(state)),
                                     device="cuda",
                                     cloudy_data=synthetic_cloudy_groups())
        if serialization.to_dict(cd) != state:
            raise AssertionError("the restored parameters differ")
        fields = flagship_fields(cd, N_FLAGSHIP)
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.time()
        new_f, diag = cd.solve_chemistry(fields, DT_FLAGSHIP)
        torch.cuda.synchronize()
        wall = time.time() - t0
        ran = launches_run()
        launches = ran[NETWORK]
        differ = bit_differences(new_f, diag, comp_f, comp_d)
        if differ or launches != comp_d["subcycles"]:
            raise AssertionError(f"restored vs phase 4: {launches} launches "
                                 f"(phase 4 {comp_d['subcycles']}), differ "
                                 f"in {differ}")
        check_dust_launches("restored", cd.config, ran[DUST],
                            diag["subcycles"])
        check_rates_launches("restored", cd.config, ran[RATES],
                             diag["subcycles"])
        self.path_launches["serialization"] = ran
        return (f"f64 flagship restored from {len(json.dumps(state))} bytes "
                f"of JSON: {wall:.3f} s ({N_FLAGSHIP / wall:.0f} cells/s, "
                f"no warm-up; phase 4 {comp_wall:.3f} s), {launches} "
                f"launches, {len(new_f)} fields and cell_iterations "
                f"bit-identical to phase 4")

    def sharded(self):
        """The f64 flagship through parallel.solve_chemistry_sharded on
        N_SHARDS shards of one card, each on its own compacted path: its
        fields and per-cell subcycle counts must equal phase 4b's
        monolithic solve bit for bit, its launches the shards' subcycles.
        Then a one-rank NCCL group (initialize_distributed) with one
        all_reduce on the card, in a process of its own."""
        import torch

        from grackle_tpu_torch.api import solve_path
        from grackle_tpu_torch.parallel.sharding import (
            make_cell_mesh, solve_chemistry_sharded)

        if getattr(self, "mono64", None) is None:
            raise AssertionError("phase 4b did not complete")
        mono_f, mono_d = self.mono64
        cd = self.flagship64
        mesh = make_cell_mesh(["cuda:0"] * N_SHARDS)
        width = N_FLAGSHIP // N_SHARDS
        if solve_path(cd.config, width) != "compact":
            raise AssertionError(f"a {width}-cell shard does not take the "
                                 f"compacted path")
        fields = flagship_fields(cd, N_FLAGSHIP)
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.time()
        new_f, diag = solve_chemistry_sharded(cd.context, fields,
                                              DT_FLAGSHIP, mesh)
        torch.cuda.synchronize()
        wall = time.time() - t0
        ran = launches_run()
        launches = ran[NETWORK]
        differ = bit_differences(new_f, diag, mono_f, mono_d)
        if (differ or launches != sum(diag["subcycles"])
                or not all(diag["trips"])):
            raise AssertionError(
                f"sharded: {launches} launches for subcycles "
                f"{diag['subcycles']}, trips {diag['trips']}, differ from "
                f"phase 4b in {differ}")
        check_dust_launches("sharded", cd.config, ran[DUST],
                            sum(diag["subcycles"]))
        check_rates_launches("sharded", cd.config, ran[RATES],
                             sum(diag["subcycles"]))
        self.path_launches["sharded"] = ran
        msg = (f"f64 flagship on {N_SHARDS} shards of {width} cells "
               f"({mesh[0]}): {wall:.3f} s ({N_FLAGSHIP / wall:.0f} cells/s,"
               f" no warm-up), per-shard n_iterations "
               f"{diag['n_iterations'].tolist()}, subcycles "
               f"{diag['subcycles']}, trips {diag['trips']}, {launches} "
               f"launches; {len(new_f)} fields and cell_iterations "
               f"bit-identical to phase 4b")
        t0 = time.time()
        res = subprocess.run([sys.executable, "-c", NCCL_CHILD, REPO],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0 or "NCCL_OK" not in res.stdout:
            raise AssertionError(msg + f"; NCCL group failed: "
                                 f"{res.stdout[-1000:]} {res.stderr[-2000:]}")
        return (msg + f"; {res.stdout.strip().splitlines()[-1]} "
                f"({time.time() - t0:.1f} s with its process)")

    def examples(self):
        """The Python examples on the card (grackle_tpu_torch/examples):
        cooling_rate with chemistry 0-3 and both freefall cases in full,
        cooling_cell over its first COOLING_CELL_STEPS steps, against
        tests/answers/examples at rtol ANSWER_RTOL; wall seconds, seconds
        a step (a solve_chemistry call: the first of each width eager, the
        second captured, the rest replays, as each step's line counts
        them) and kernel launches of each, the replays' included."""
        import torch

        from grackle_tpu_torch import api
        from grackle_tpu_torch.data.synthetic import synthetic_cloudy_groups
        from grackle_tpu_torch.examples import (cooling_cell, cooling_rate,
                                                freefall)
        from grackle_tpu_torch.utilities.physical_constants import (
            sec_per_Myr)

        tables = synthetic_cloudy_groups()
        stored = np.load(os.path.join(REPO, "tests", "answers", "examples",
                                      "cooling_cell.npz"))
        cell_time = (COOLING_CELL_STEPS - 0.5) * stored["time"][1] \
            / sec_per_Myr
        runs = [(f"cooling_rate_chem{chem}", None,
                 lambda chem=chem: cooling_rate.run(
                     chem, device="cuda", cloudy_data=tables, verbose=False))
                for chem in range(4)]
        runs += [(f"freefall_metal{metal}", None,
                  lambda metal=metal: freefall.run(
                      metal, device="cuda",
                      cloudy_data=tables if metal else None, verbose=False))
                 for metal in (0, 1)]
        runs.append(("cooling_cell", COOLING_CELL_STEPS,
                     lambda: cooling_cell.run(cell_time, device="cuda",
                                              cloudy_data=tables,
                                              verbose=False)))

        # each example's steps are its solve_chemistry calls, and the
        # graph cache says what kind of call each was
        calls = [0]
        kinds = collections.Counter()
        solve = api.ChemistryData.solve_chemistry

        def counted(cd, *args, **kw):
            calls[0] += 1
            before = cd.context.graphs.calls.copy()
            out = solve(cd, *args, **kw)
            kinds.update(cd.context.graphs.calls - before)
            return out

        parts, failed, total = [], [], collections.Counter()
        api.ChemistryData.solve_chemistry = counted
        try:
            for tag, steps, run in runs:
                calls[0] = 0
                kinds.clear()
                zero_launches()
                t0 = time.time()
                # the equilibrium loop writes its progress to stderr
                with contextlib.redirect_stderr(io.StringIO()):
                    out = run()
                torch.cuda.synchronize()
                wall = time.time() - t0
                ran = launches_run()
                launches = ran[NETWORK]
                total.update(ran)
                worst = max(answer_errors(f"examples/{tag}", out,
                                          steps).values())
                span = "in full" if steps is None else \
                    f"first {steps} of {len(stored['time'])} steps"
                parts.append(
                    f"{tag} ({span}) {wall:.2f} s, {calls[0]} steps ("
                    + ", ".join(f"{kinds[k]} {k}" for k in CALL_KINDS)
                    + f"), {wall / max(calls[0], 1):.4f} s a step, "
                    f"{launches} launches, max rel {worst:.2e}")
                # cooling_rate with chemistry 0 runs no solve
                if worst > ANSWER_RTOL or (calls[0] and not launches):
                    failed.append(tag)
        finally:
            api.ChemistryData.solve_chemistry = solve
        if failed:
            raise AssertionError(f"{failed} off their answers: "
                                 + "; ".join(parts))
        self.path_launches["examples"] = dict(total)
        return "; ".join(parts)

    def c_abi(self):
        """The port's C library (cshim_build: g++ against this
        interpreter's libpython) and the unedited examples/c_example.c and
        c_legacy_api_example.c linked against it, each run with
        GRACKLE_TPU_TORCH_DEVICE=cuda and =cpu: the success marker, the
        values the card run prints equal to the CPU run's, and the kernel
        launches of the card run."""
        import shutil
        import sysconfig
        import tempfile

        from grackle_tpu_torch import cshim_build

        var = sysconfig.get_config_var
        include = os.path.join(sysconfig.get_paths()["include"], "Python.h")
        embed = (f"{sys.executable}: Py_ENABLE_SHARED "
                 f"{var('Py_ENABLE_SHARED')}, {var('LDLIBRARY')} in "
                 f"{var('LIBDIR')}, {include} "
                 f"{'present' if os.path.exists(include) else 'MISSING'}")
        if not var("Py_ENABLE_SHARED") or not os.path.exists(include):
            raise AssertionError(f"cannot embed this interpreter: {embed}")
        t0 = time.time()
        lib = cshim_build.build()
        parts = [embed, f"built {os.path.relpath(lib, REPO)} in "
                 f"{time.time() - t0:.2f} s"]
        lib_dir = os.path.dirname(lib)
        work = tempfile.mkdtemp(prefix="chip_smoke_c_")
        total = 0
        try:
            for src, marker, extra in C_EXAMPLES:
                exe = os.path.join(work, os.path.splitext(src)[0])
                subprocess.run(
                    ["gcc", *extra, "-I" + cshim_build.INCLUDE_DIR,
                     os.path.join(REPO, "examples", src), "-L" + lib_dir,
                     "-lgrackle_tpu", "-Wl,-rpath," + lib_dir, "-o", exe],
                    capture_output=True, text=True, timeout=120,
                    check=True)
                printed = {}
                for device in ("cuda", "cpu"):
                    res, wall, launches = run_host(exe, device, work)
                    if res.returncode != 0 or marker not in res.stdout:
                        raise AssertionError(
                            f"{src} on {device}: rc {res.returncode} "
                            f"{res.stdout[-1000:]} {res.stderr[-2000:]}")
                    printed[device] = [line for line in
                                       res.stdout.splitlines()
                                       if "[0] = " in line]
                    parts.append(f"{src} {device} {wall:.2f} s, {launches} "
                                 f"launches")
                    if device == "cuda":
                        if not launches:
                            raise AssertionError(f"{src} on the card "
                                                 f"launched no kernel")
                        total += launches
                if not printed["cuda"] or printed["cuda"] != printed["cpu"]:
                    raise AssertionError(f"{src}: card printed "
                                         f"{printed['cuda']}, CPU "
                                         f"{printed['cpu']}")
                parts.append(f"{src}: {marker}, card = CPU: "
                             + ", ".join(printed["cuda"]))
        finally:
            shutil.rmtree(work, ignore_errors=True)
        self.path_launches["c_examples"] = {NETWORK: total}
        return "; ".join(parts)

    def data_files(self):
        """The committed HDF5 fixtures through data/h5read.py, each read
        whole (timed) and held to what it was written from; the
        monolithic f64 flagship initialized from synthetic_gz.h5 against
        phase 4b bit for bit; cooling_rate (chemistry 1) with
        GRACKLE_DATA_FILE naming the fixture, against its stored
        answer."""
        import torch

        from grackle_tpu_torch.data.synthetic import (
            synthetic_cloudy_groups, synthetic_old_style_groups)
        from grackle_tpu_torch.examples import common, cooling_rate

        parts = []
        path = os.path.join(H5_FIXTURES, "synthetic_gz.h5")
        checks = [
            ("synthetic_gz.h5",
             lambda p: file_vs_groups(p, synthetic_cloudy_groups())),
            ("old_style_rank4_gz.h5",
             lambda p: file_vs_groups(p, synthetic_old_style_groups(4))),
            ("latest_small.h5", latest_vs_content),
        ]
        for name, check in checks:
            fixture = os.path.join(H5_FIXTURES, name)
            t0 = time.time()
            n_read = read_whole(fixture)
            read_ms = (time.time() - t0) * 1e3
            compared = check(fixture)
            parts.append(f"{name} ({os.path.getsize(fixture)} B): "
                         f"{n_read} values read whole in {read_ms:.1f} ms, "
                         f"{compared} bit-identical to what it was "
                         f"written from")

        msg, self.path_launches["flagship_from_file"] = \
            self.flagship_from_file(path)
        parts.append(msg)

        before = os.environ.get("GRACKLE_DATA_FILE")
        os.environ["GRACKLE_DATA_FILE"] = path
        try:
            if common.get_data_file() != path:
                raise AssertionError("GRACKLE_DATA_FILE not taken")
            zero_launches()
            t0 = time.time()
            with contextlib.redirect_stderr(io.StringIO()):
                out = cooling_rate.run(1, device="cuda", verbose=False)
            torch.cuda.synchronize()
            wall = time.time() - t0
        finally:
            if before is None:
                del os.environ["GRACKLE_DATA_FILE"]
            else:
                os.environ["GRACKLE_DATA_FILE"] = before
        ran = launches_run()
        launches = ran[NETWORK]
        worst = max(answer_errors("examples/cooling_rate_chem1",
                                  out).values())
        parts.append(f"cooling_rate chemistry 1 from GRACKLE_DATA_FILE="
                     f"synthetic_gz.h5: {wall:.2f} s, {launches} launches,"
                     f" max rel {worst:.2e} against its stored answer")
        if worst > ANSWER_RTOL or not launches:
            raise AssertionError("; ".join(parts))
        self.path_launches["example_from_file"] = ran
        return "; ".join(parts)

    @staticmethod
    def solve_as(cd, fields, ref, what):
        """``cd``'s solve of ``fields`` at DT_FLAGSHIP on the card, with
        its kernel launches counted from 0: its fields and per-cell
        subcycle counts must equal ``ref`` ((fields, diagnostics) of an
        earlier phase) bit for bit, one launch a subcycle.  Returns (wall
        seconds, launches_run(), the count of fields)."""
        import torch

        torch.cuda.synchronize()
        zero_launches()
        t0 = time.time()
        new_f, diag = cd.solve_chemistry(fields, DT_FLAGSHIP)
        torch.cuda.synchronize()
        wall = time.time() - t0
        ran = launches_run()
        launches = ran[NETWORK]
        differ = bit_differences(new_f, diag, *ref)
        if differ or launches != diag["subcycles"] or launches == 0:
            raise AssertionError(f"{what}: {launches} launches for "
                                 f"{diag['subcycles']} subcycles, differs "
                                 f"in {differ}")
        check_dust_launches(what, cd.config, ran[DUST], diag["subcycles"])
        check_rates_launches(what, cd.config, ran[RATES], diag["subcycles"])
        return wall, ran, len(new_f)

    def flagship_from_file(self, path):
        """The monolithic f64 flagship initialized from the data file
        ``path``, against phase 4b (``solve_as``).  Returns (message,
        launches_run())."""
        if getattr(self, "mono64", None) is None:
            raise AssertionError("phase 4b did not complete")
        name = os.path.basename(path)
        t0 = time.time()
        cd = flagship_chem(64, "cuda", solver_compaction=0,
                           grackle_data_file=path)
        init = time.time() - t0
        wall, ran, n_fields = self.solve_as(
            cd, flagship_fields(cd, N_FLAGSHIP), self.mono64,
            f"flagship from {name} against phase 4b")
        return (f"f64 monolithic flagship from {name}: initialize "
                f"{init:.3f} s, solve {wall:.3f} s, {ran[NETWORK]} "
                f"launches, {n_fields} fields and cell_iterations "
                f"bit-identical to phase 4b", ran)

    def hosts(self):
        """The f64 and float libraries, then each host program of HOSTS
        compiled against its library and run with
        GRACKLE_TPU_TORCH_DEVICE=cuda and =cpu, each as its own process
        that counts its kernel launches in a file: the success marker,
        the same standard output on the card as on the CPU, and a launch
        on the card in every host that solves; the Fortran example where
        gfortran is on PATH."""
        import shutil
        import tempfile

        from grackle_tpu_torch import cshim_build
        from grackle_tpu_torch.data.synthetic import make_synthetic_data_file

        t0 = time.time()
        libs = [cshim_build.build(), cshim_build.build(4)]
        parts = [f"built {', '.join(os.path.relpath(p, REPO) for p in libs)}"
                 f" in {time.time() - t0:.2f} s"]
        work = tempfile.mkdtemp(prefix="chip_smoke_hosts_")
        total = 0
        data_file = make_synthetic_data_file(
            os.path.join(work, "synthetic_cloudy.h5"))

        def run(exe, marker, args=()):
            out, launches = {}, {}
            for device in ("cuda", "cpu"):
                res, wall, launches[device] = run_host(exe, device, work,
                                                       args)
                name = os.path.basename(exe)
                if res.returncode != 0 or marker not in res.stdout:
                    raise AssertionError(
                        f"{name} on {device}: rc {res.returncode} "
                        f"{res.stdout[-1000:]} {res.stderr[-2000:]}")
                out[device] = res.stdout
                parts.append(f"{name} {device} {wall:.2f} s, "
                             f"{launches[device]} launches")
            if out["cuda"] != out["cpu"]:
                raise AssertionError(f"{exe}: card printed {out['cuda']!r},"
                                     f" CPU {out['cpu']!r}")
            return out["cuda"], launches["cuda"]

        def compile_host(cmd):
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=180)
            if res.returncode != 0:
                raise AssertionError(" ".join(cmd) + "\n"
                                     + res.stderr[-2000:])

        try:
            for src, marker, flags, float_bytes, args in HOSTS:
                lib_dir = os.path.dirname(
                    cshim_build.library_path(float_bytes))
                exe = os.path.join(work, os.path.splitext(src)[0])
                compile_host(["g++" if src.endswith(".cpp") else "gcc",
                              *flags, "-I" + cshim_build.INCLUDE_DIR,
                              os.path.join(REPO, "examples", src),
                              "-L" + lib_dir, "-lgrackle_tpu",
                              "-Wl,-rpath," + lib_dir, "-o", exe])
                stdout, launches = run(
                    exe, marker, [a.format(data_file=data_file)
                                  for a in args])
                if src != "dynamic_api_example.c" and not launches:
                    raise AssertionError(f"{src} on the card launched no "
                                         f"kernel")
                total += launches
                printed = [line for line in stdout.splitlines()
                           if "=" in line]
                parts.append(f"{src}: {marker}, card = CPU"
                             + (f": {', '.join(printed)}" if printed
                                else ""))
            if shutil.which("gfortran"):
                exe = os.path.join(work, "fortran_example")
                compile_host(["gfortran", cshim_build.FORTRAN_MODULE,
                              os.path.join(REPO, "examples",
                                           "fortran_example.f90"),
                              "-J", work, "-L" + os.path.dirname(libs[0]),
                              "-lgrackle_tpu",
                              "-Wl,-rpath," + os.path.dirname(libs[0]),
                              "-o", exe])
                _, launches = run(exe, "FORTRAN_EXAMPLE_SUCCESS")
                total += launches
                parts.append("fortran_example.f90: FORTRAN_EXAMPLE_SUCCESS,"
                             " card = CPU")
            else:
                parts.append("gfortran is not on PATH: fortran_example.f90 "
                             "was not run")
        finally:
            shutil.rmtree(work, ignore_errors=True)
        self.path_launches["hosts"] = {NETWORK: total}
        return "; ".join(parts)


    def data_written(self):
        """The port's writers (data/synthetic.make_synthetic_data_file,
        make_synthetic_old_style_file of rank 4 and 5) into a temporary
        directory, each write timed; each file read back by data/h5read.py
        bit for bit against the tables in memory; the monolithic f64
        flagship initialized from the written new-style file against
        phase 4b bit for bit; phase 4e's old-style rank-5 chemistry-1
        solve from the written rank-5 file against phase 4e's solve from
        memory, bit for bit."""
        import shutil
        import tempfile

        from grackle_tpu_torch.data.synthetic import (
            make_synthetic_data_file, make_synthetic_old_style_file,
            synthetic_cloudy_groups, synthetic_old_style_groups)

        if getattr(self, "old5", None) is None:
            raise AssertionError("phase 4e did not complete")
        parts = []
        work = tempfile.mkdtemp(prefix="chip_smoke_written_")
        try:
            writes = [
                ("synthetic.h5", make_synthetic_data_file,
                 synthetic_cloudy_groups),
                ("old_style_rank4.h5",
                 lambda p: make_synthetic_old_style_file(p, 4),
                 lambda: synthetic_old_style_groups(4)),
                ("old_style_rank5.h5",
                 lambda p: make_synthetic_old_style_file(p, 5),
                 lambda: synthetic_old_style_groups(5)),
            ]
            paths = {}
            for name, write, groups in writes:
                path = paths[name] = os.path.join(work, name)
                t0 = time.time()
                write(path)
                secs = time.time() - t0
                compared = file_vs_groups(path, groups())
                parts.append(f"{name} written in {secs:.3f} s, "
                             f"{os.path.getsize(path)} B, {compared} "
                             f"values read back bit-identical")

            msg, self.path_launches["flagship_from_written_file"] = \
                self.flagship_from_file(paths["synthetic.h5"])
            parts.append(msg)

            cd = old_style_chem("cuda", 5, paths["old_style_rank5.h5"])
            wall, ran, n_fields = self.solve_as(
                cd, answer_state(cd, n=N_FLAGSHIP), self.old5,
                "old-style rank 5 from the written file against phase 4e")
            self.path_launches["old_style_from_written_file"] = ran
            parts.append(f"f64 old-style rank 5, chemistry 1 from "
                         f"old_style_rank5.h5, {N_FLAGSHIP} cells: "
                         f"{wall:.3f} s, {ran[NETWORK]} launches, {n_fields} "
                         f"fields and cell_iterations bit-identical to "
                         f"phase 4e (from memory)")
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return "; ".join(parts)


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
    # ``--only 0,1,4,4m`` runs the phases whose labels start with those
    # names (a development aid; the smoke test is the run of all of them)
    only = None
    if "--only" in sys.argv[1:]:
        only = set(sys.argv[sys.argv.index("--only") + 1].split(","))
        run_phase = smoke.phase
        smoke.phase = lambda label, fn: (
            run_phase(label, fn) if label.split()[0] in only else None)
    t0 = time.time()
    smoke.phase("0 device", smoke.device)
    smoke.phase("1 build", smoke.build)
    if "--cooling-cell-full" in sys.argv[1:]:
        summary = None
        if smoke.ok:
            try:
                summary = smoke.cooling_cell_full()
            except Exception:
                traceback.print_exc()
        print(f"[total] {time.time() - t0:.1f} s", flush=True)
        print(json.dumps({"cooling_cell_full": summary}), flush=True)
        return 0 if summary is not None and summary["ok"] else 1
    smoke.phase("2 kernel vs twin", smoke.kernel_vs_twin)
    smoke.phase("2b kernel vs twin, every configuration",
                smoke.kernel_configs)
    smoke.phase("2c Cloudy kernels vs twins", smoke.cloudy_kernels)
    smoke.phase("2d dust kernel vs twin", smoke.dust_kernel_vs_twin)
    smoke.phase("2e rate kernel vs twin", smoke.rate_kernel_vs_twin)
    smoke.phase("3 stored answers", smoke.answers)
    smoke.phase("4 flagship f64", lambda: smoke.flagship(64))
    smoke.phase("4 flagship f32", lambda: smoke.flagship(32))
    smoke.phase("4b monolithic f64 vs compacted", smoke.monolithic)
    smoke.phase("4c exact cooling f64", lambda: smoke.exact(64))
    smoke.phase("4c exact cooling f32", lambda: smoke.exact(32))
    smoke.phase("4d functional make_solve_fn f64",
                smoke.functional_flagship)
    smoke.phase("4e old-style rank 5, chemistry 1", smoke.old_style)
    smoke.phase("4f serialization round trip f64", smoke.serialization)
    smoke.phase("4g shards and ranks", smoke.sharded)
    smoke.phase("4h examples", smoke.examples)
    smoke.phase("4i C ABI", smoke.c_abi)
    smoke.phase("4j data files", smoke.data_files)
    smoke.phase("4k host programs", smoke.hosts)
    smoke.phase("4l data files written", smoke.data_written)
    smoke.phase("4m captured CUDA graphs", smoke.captured)
    smoke.phase("4n stateful API replayed", smoke.stateful_replays)
    smoke.phase("5 torch.profiler cross-check", smoke.profiled_kernel)
    print(f"[total] {time.time() - t0:.1f} s", flush=True)
    for line, what in ((smoke.kernel, NETWORK), (smoke.cloudy, CLOUDY),
                       (smoke.dust, DUST), (smoke.rates, RATES)):
        line["launches"] = sum(ran.get(what, 0)
                               for ran in smoke.path_launches.values())
    print(f"[launches] {smoke.path_launches}", flush=True)
    print(json.dumps({"kernels": [smoke.kernel, smoke.loop, smoke.cloudy,
                                  smoke.dust, smoke.rates]}),
          flush=True)
    if not smoke.ok or only is not None:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
