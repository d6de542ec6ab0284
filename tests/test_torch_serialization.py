"""grackle_tpu_torch.serialization and api_compat against grackle_tpu's.

The port's round trip is tests/test_serialization.py's, with the restored
context's solve bit-identical; a JSON that either package saved loads in
the other (both use the ``PARAMETER_REGISTRY`` names and the same unit
keys), and the port's solve of a JSON the JAX package saved matches the
JAX solve at rtol 1e-9.  A context built from in-memory tables is
restored by passing the tables again.  The port runs on CPU tensors.
"""

import numpy as np
import pytest
import torch

import grackle_tpu.api_compat as japi_compat
from grackle_tpu import serialization as jser
from grackle_tpu.api import ChemistryData as JChemistryData
from grackle_tpu.fluid_container import FluidContainer as JFluidContainer
from grackle_tpu_torch import api_compat, serialization
from grackle_tpu_torch.api import ChemistryData
from grackle_tpu_torch.data.synthetic import synthetic_cloudy_groups
from grackle_tpu_torch.fluid_container import FluidContainer
from grackle_tpu_torch.utilities.physical_constants import mass_hydrogen_cgs
from tests.answer_workloads import _data_file

torch.set_num_threads(1)

UNITS = dict(density_units=mass_hydrogen_cgs, length_units=3.0857e21,
             time_units=3.1556952e13)


def _params(cd, **kw):
    for k, v in dict(UNITS, use_grackle=1, **kw).items():
        setattr(cd, k, v)
    return cd


def _run(cd, container=FluidContainer, metal=0.0):
    """tests/test_serialization.py's 8-cell solve; the new HI and
    energy (the H2 network's fields where the chemistry has them)."""
    fc = container(cd, 8)
    fc["density"][:] = 1.0
    fc["HI"][:] = 0.38
    fc["HII"][:] = 0.38
    fc["HeI"][:] = 0.24
    fc["HeII"][:] = 1e-20
    fc["HeIII"][:] = 1e-20
    fc["de"][:] = 0.38
    if "H2I" in fc:
        fc["HM"][:] = 1e-20
        fc["H2I"][:] = 1e-6
        fc["H2II"][:] = 1e-20
    fc["metal"][:] = metal
    fc["energy"][:] = 1.0e-4
    fc.solve_chemistry(1e-4)
    return np.array(fc["HI"]), np.array(fc["energy"])


def test_round_trip(tmp_path):
    """tests/test_serialization.py on the port: the saved parameters and
    units come back, and the restored context solves bit-identically."""
    cd = _params(ChemistryData(), primordial_chemistry=2, three_body_rate=4,
                 CaseBRecombination=1, Gamma=1.4)
    cd.initialize(device="cpu")

    path = str(tmp_path / "params.json")
    assert serialization.save(cd, path) == path
    cd2 = serialization.load(path, device="cpu")

    assert cd2.primordial_chemistry == 2
    assert cd2.three_body_rate == 4
    assert cd2.CaseBRecombination == 1
    assert cd2.Gamma == 1.4
    assert cd2.density_units == cd.density_units
    assert serialization.to_dict(cd2) == serialization.to_dict(cd)
    for got, want in zip(_run(cd2), _run(cd)):
        np.testing.assert_array_equal(got, want)


def test_load_defaults_to_cuda_and_can_skip_initialize(tmp_path):
    """load builds on the card unless asked for the CPU (raising on a
    machine without one); initialize=False builds no context."""
    cd = _params(ChemistryData(), primordial_chemistry=1)
    path = serialization.save(cd, str(tmp_path / "p.json"))
    assert serialization.load(path, initialize=False).context is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            serialization.load(path)


def test_in_memory_tables_are_given_again(tmp_path):
    """A context built from cloudy_data saves no file name: load needs the
    tables again, and then solves bit-identically."""
    tables = synthetic_cloudy_groups()
    cd = _params(ChemistryData(), primordial_chemistry=2, metal_cooling=1)
    cd.initialize(device="cpu", cloudy_data=tables)
    path = serialization.save(cd, str(tmp_path / "metal.json"))
    assert serialization.to_dict(cd)["parameters"]["grackle_data_file"] \
        == ""
    with pytest.raises(ValueError, match="grackle_data_file"):
        serialization.load(path, device="cpu")
    cd2 = serialization.load(path, device="cpu", cloudy_data=tables)
    for got, want in zip(_run(cd2, metal=1e-3), _run(cd, metal=1e-3)):
        np.testing.assert_array_equal(got, want)


def test_jax_saved_json_loads_in_port(tmp_path):
    """A JSON the JAX package saved (metal cooling from its data file)
    loads in the port, and the two solves agree at rtol 1e-9."""
    jcd = _params(JChemistryData(), primordial_chemistry=1, metal_cooling=1,
                  CaseBRecombination=1, grackle_data_file=_data_file())
    jcd.initialize()
    path = jser.save(jcd, str(tmp_path / "jax.json"))

    cd = serialization.load(path, device="cpu")
    assert serialization.to_dict(cd) == jser.to_dict(jcd)
    got = _run(cd, metal=1e-3)
    want = _run(jcd, JFluidContainer, metal=1e-3)
    for g, w, name in zip(got, want, ["HI", "energy"]):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=0, err_msg=name)


def test_port_saved_json_loads_in_jax(tmp_path):
    """A JSON the port saved loads in the JAX package with the same
    parameters and units."""
    cd = _params(ChemistryData(), primordial_chemistry=3, Gamma=1.4,
                 comoving_coordinates=1, a_value=0.5, a_units=0.25)
    path = serialization.save(cd, str(tmp_path / "port.json"))
    jcd = jser.load(path, initialize=False)
    assert jser.to_dict(jcd) == serialization.to_dict(cd)


def test_api_compat_exports():
    """The deprecated module exports grackle_tpu/api_compat.py's names,
    each the port's object."""
    def names(mod):
        return sorted(n for n in vars(mod) if not n.startswith("_"))

    assert names(api_compat) == names(japi_compat)
    assert api_compat.chemistry_data is ChemistryData
    assert api_compat.FluidContainer is FluidContainer
    for name in names(api_compat):
        assert getattr(api_compat, name).__module__.startswith(
            "grackle_tpu_torch"), name
