"""grackle_tpu_torch.parallel: per-shard solves and torch.distributed
groups, on the CPU.

The counterparts of tests/test_sharding.py:65-155 with four CPU shards
(``make_cell_mesh(["cpu"] * 4)``; a shard's cost on the CPU is its
subcycles' host work, whatever its width), at that file's tolerances:
equal to the single solve at rtol 1e-12 (chemistry 1 and 3, and an
uneven 37 cells), per-shard compaction bit-identical to the monolithic
solve, and exact cooling.  The sharded chemistry-3 solve on eight CPU
shards matches the JAX package's ``solve_chemistry_sharded`` on its
8-device CPU mesh at rtol 1e-9, shard for shard.  The
counterparts of tests/test_distributed.py: ``initialize_distributed()``
is a no-op in one process, and two processes in a gloo group reduce
across ranks and each solve their own cells.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from grackle_tpu.parallel import sharding as jsharding
from grackle_tpu_torch import api
from grackle_tpu_torch.parallel.distributed import (
    global_cell_mesh,
    initialize_distributed,
)
from grackle_tpu_torch.parallel.sharding import (
    make_cell_mesh,
    pad_to_multiple,
    shard_fields,
    solve_chemistry_sharded,
)
from tests import test_sharding as jtests

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = ["cpu"] * 4
DT = 1.0e-3
FIELDS = ["HI", "HII", "de", "energy"]


def make_chem(chem=1, **kw):
    """tests/test_sharding.make_chem on the port, on the CPU."""
    cd = api.ChemistryData()
    cd.use_grackle = 1
    cd.with_radiative_cooling = 1
    cd.primordial_chemistry = chem
    for k, v in kw.items():
        setattr(cd, k, v)
    chip_smoke._units(cd)
    assert cd.initialize(device="cpu") == 1
    return cd


def make_fields(cd, n):
    """tests/test_sharding.make_fields (seed 17; it reads only ``cd``'s
    parameters and units), as numpy arrays."""
    return {k: np.array(v)
            for k, v in jtests.make_fields(cd, n)._solver_fields().items()}


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_make_cell_mesh_and_padding():
    """The mesh defaults to every CUDA device and raises without one; the
    padding repeats cell 0, the shielding length included."""
    assert make_cell_mesh(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            make_cell_mesh()
    x = torch.arange(5.0)
    padded, n = pad_to_multiple({"a": x, "b": 2 * x}, 4)
    assert n == 5
    assert torch.equal(padded["a"], torch.tensor([0., 1, 2, 3, 4, 0, 0, 0]))
    assert torch.equal(padded["b"], 2 * padded["a"])


def test_shard_fields(monkeypatch):
    """shard_fields cuts every field into len(mesh) equal contiguous
    pieces, piece i on mesh[i], which concatenate to the input; a cell
    count that is not a multiple of the mesh raises, as jax.device_put
    with a NamedSharding does.  solve_chemistry_sharded hands each
    shard's solve exactly those pieces of its padded fields, the
    shielding length cut with them (chemistry 2, H2 self-shielding 1,
    37 cells), and the result equals the unsharded solve."""
    x = torch.arange(12.0, dtype=torch.float64)
    pieces = shard_fields({"a": x, "b": -x}, make_cell_mesh(MESH))
    assert len(pieces) == 4
    for key, val in (("a", x), ("b", -x)):
        assert [p[key].shape for p in pieces] == [(3,)] * 4
        assert all(p[key].device == torch.device("cpu") for p in pieces)
        assert torch.equal(torch.cat([p[key] for p in pieces]), val)
    with pytest.raises(ValueError, match="10 cells"):
        shard_fields({"a": torch.arange(10.0)}, MESH)

    cd = make_chem(2, H2_self_shielding=1)
    fields = make_fields(cd, 37)
    l_h2 = np.linspace(1.0e18, 1.0e20, 37)  # cm
    seen = []
    solve = api.solve_prepared

    def record(ctx, us, pr, f, dt, imetal, l_local):
        seen.append((dict(f), l_local))
        return solve(ctx, us, pr, f, dt, imetal, l_local)

    monkeypatch.setattr(api, "solve_prepared", record)
    shard_f, _ = solve_chemistry_sharded(cd.context, fields, DT, MESH,
                                         l_h2shield_field=l_h2)
    monkeypatch.setattr(api, "solve_prepared", solve)
    prepped, _ = api._prep_fields(cd.context, fields)
    padded, _ = pad_to_multiple(
        dict(prepped, l=api.shield_length_tensor(cd.context, l_h2)), 4)
    assert len(seen) == 4
    for (f_local, l_local), piece in zip(seen, shard_fields(padded, MESH)):
        assert sorted(f_local) == sorted(k for k in piece if k != "l")
        for key, val in f_local.items():
            assert torch.equal(val, piece[key]), key
        assert torch.equal(l_local, piece["l"])
    ref_f, _ = cd.solve_chemistry(fields, DT, l_h2shield=l_h2)
    for name in FIELDS + ["H2I"]:
        np.testing.assert_allclose(_np(shard_f[name]), _np(ref_f[name]),
                                   rtol=1e-12, err_msg=name)


@pytest.mark.parametrize("chem", [1, 3])
def test_sharded_equals_single(chem):
    """Eight shards, each subcycling on its own, against one solve."""
    cd = make_chem(chem)
    fields = make_fields(cd, 48)
    ref_f, _ = cd.solve_chemistry(fields, DT)
    shard_f, diag = solve_chemistry_sharded(cd.context, fields, DT,
                                            make_cell_mesh(MESH))
    assert diag["n_iterations"].shape == (4,)
    assert len(diag["subcycles"]) == 4
    assert bool(diag["converged"].all())
    for name in FIELDS:
        np.testing.assert_allclose(_np(shard_f[name]), _np(ref_f[name]),
                                   rtol=1e-12, err_msg=name)


def test_sharded_uneven_n():
    """37 cells on 4 shards: padded with copies of cell 0, sliced off."""
    cd = make_chem(1)
    fields = make_fields(cd, 37)
    ref_f, _ = cd.solve_chemistry(fields, DT)
    shard_f, diag = solve_chemistry_sharded(cd.context, fields, DT, MESH)
    assert shard_f["HI"].shape == (37,)
    assert diag["converged"].shape == diag["cell_iterations"].shape == (37,)
    np.testing.assert_allclose(_np(shard_f["HI"]), _np(ref_f["HI"]),
                               rtol=1e-12)


def test_sharded_compaction_equals_single(monkeypatch):
    """Per-shard converged-cell compaction (64 cells a shard with the
    smallest bucket at 16) bit-identical to the monolithic solve, fields
    and per-cell subcycle counts."""
    monkeypatch.setattr(api, "_COMPACT_MIN_BUCKET", 16)
    cd = make_chem(1, solver_compaction=8)
    assert api.solve_path(cd.config, 256 // 4) == "compact"
    fields = make_fields(cd, 256)
    cd0 = make_chem(1, solver_compaction=0)
    ref_f, ref_d = cd0.solve_chemistry(fields, DT)
    assert ref_d["trips"] == 0

    shard_f, diag = solve_chemistry_sharded(cd.context, fields, DT, MESH)
    assert bool(diag["converged"].all())
    assert all(trips > 0 for trips in diag["trips"])
    for name in FIELDS:
        assert torch.equal(shard_f[name], ref_f[name]), name
    assert torch.equal(diag["cell_iterations"], ref_d["cell_iterations"])


def test_sharded_exact_cooling():
    """exact_cooling = 1 shards pointwise: the sharded energies match the
    unsharded exact path."""
    cd = chip_smoke.answer_chem("cpu", primordial_chemistry=0,
                                metal_cooling=1, exact_cooling=1)
    fields = chip_smoke.tabulated_state(cd, 96)
    ref_f, _ = cd.solve_chemistry(dict(fields), 0.5)
    shard_f, diag = solve_chemistry_sharded(cd.context, fields, 0.5, MESH)
    assert bool(diag["converged"].all())
    assert diag["subcycles"] == [0] * 4
    np.testing.assert_allclose(_np(shard_f["energy"]), _np(ref_f["energy"]),
                               rtol=1e-12)


def test_sharded_matches_jax():
    """The port's eight CPU shards against the JAX package's
    solve_chemistry_sharded on its 8-device CPU mesh, chemistry 3, 16
    cells at dt 1e-4: the fields and each shard's subcycle count."""
    jcd = jtests.make_chem(3)
    fields = make_fields(jcd, 16)
    want, jdiag = jsharding.solve_chemistry_sharded(
        jcd.context, fields, 1.0e-4, jsharding.make_cell_mesh())
    cd = make_chem(3)
    got, diag = solve_chemistry_sharded(cd.context, fields, 1.0e-4,
                                        ["cpu"] * 8)
    assert sorted(got) == sorted(want)
    for name in got:
        np.testing.assert_allclose(_np(got[name]), np.asarray(want[name]),
                                   rtol=1e-9, atol=0, err_msg=name)
    np.testing.assert_array_equal(_np(diag["n_iterations"]),
                                  np.asarray(jdiag["n_iterations"]))


def test_single_process_noop():
    """No init_method and a world of one: a no-op returning (1, 0)."""
    assert initialize_distributed() == (1, 0)
    assert initialize_distributed(world_size=1) == (1, 0)
    with pytest.raises(ValueError, match="init_method"):
        initialize_distributed(world_size=2)


_CHILD = r"""
import sys
rank, port = int(sys.argv[1]), sys.argv[2]
sys.path.insert(0, %(repo)r)
import numpy as np
import torch
import torch.distributed as dist
from grackle_tpu_torch.parallel.distributed import (
    global_cell_mesh, initialize_distributed)
size, me = initialize_distributed(f"tcp://localhost:{port}", 2, rank,
                                  device="cpu")
assert (size, me) == (2, rank), (size, me)
assert dist.get_backend() == "gloo"
# tolerates the group it is already in
assert initialize_distributed(f"tcp://localhost:{port}", 2, rank,
                              device="cpu") == (2, rank)
mesh = global_cell_mesh()
assert mesh == [torch.device("cpu")], mesh
# a real cross-process collective: each rank holds 4 cells of rank + 1
local = torch.full((4,), float(rank + 1))
total = local.sum()
dist.all_reduce(total)
assert float(total) == 12.0, float(total)

# the reference's per-rank model: each process solves ITS OWN cells with
# the plain single-process API (grackle.h:56-60 local_* contract)
from grackle_tpu_torch.api import ChemistryData
from grackle_tpu_torch.fluid_container import FluidContainer
from grackle_tpu_torch.utilities.physical_constants import mass_hydrogen_cgs
cd = ChemistryData()
cd.use_grackle = 1
cd.with_radiative_cooling = 1
cd.primordial_chemistry = 1
cd.density_units = mass_hydrogen_cgs
cd.length_units = 3.0857e21
cd.time_units = 3.1556952e13
assert cd.initialize(device=mesh[0]) == 1
fc = FluidContainer(cd, 4)
fc["density"][:] = 1.0 + rank
fc["HI"][:] = 0.76 * fc["density"]
fc["HII"][:] = 1e-20
fc["HeI"][:] = 0.24 * fc["density"]
fc["HeII"][:] = 1e-20
fc["HeIII"][:] = 1e-20
fc["de"][:] = 1e-20
fc["energy"][:] = 1.0e-2
new_f, diag = cd.solve_chemistry(fc._solver_fields(), 1.0e-4)
assert bool(diag["converged"].all())
dist.destroy_process_group()
print(f"RANK_OK {rank}")
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_group(tmp_path):
    """Two processes in one gloo group: an all_reduce across ranks, and
    each rank solves its own 4 cells to convergence."""
    port = _free_port()
    script = str(tmp_path / "child.py")
    with open(script, "w") as fh:
        fh.write(_CHILD % {"repo": REPO})
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, script, str(rank), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=str(tmp_path),
        )
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=60)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (rank, out[-2000:])
        assert f"RANK_OK {rank}" in out, (rank, out[-2000:])
