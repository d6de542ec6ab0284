"""grackle_tpu_torch.yt_fields under tests/test_yt_fields.py's fake yt.

yt is not installed here, so the nine cases of tests/test_yt_fields.py
run on the port with that file's ``fake_yt`` fixture and stand-in
dataset, chunk and unit classes: parameter translation, field
registration, the electron-mass scaling, the derived fields against the
port's FluidContainer, the field-detector pass and the metal-density sum.
Then the registered field's values against the JAX package's on the same
chunk at rtol 1e-9, and the in-memory tables and the device passed
through.  The port runs on the CPU (``device="cpu"``).
"""

import numpy as np
import pytest
import torch

import grackle_tpu_torch
from grackle_tpu import yt_fields as jyt_fields
from grackle_tpu_torch import yt_fields
from grackle_tpu_torch.data.synthetic import synthetic_cloudy_groups
from grackle_tpu_torch.fluid_container import FluidContainer
from tests.answer_workloads import _data_file
from tests.test_yt_fields import (  # noqa: F401  (fake_yt is a fixture)
    DENSITY_CGS,
    LENGTH_CGS,
    TIME_CGS,
    VELOCITY_CGS,
    FakeDataChunk,
    FakeFieldDetector,
    FakeFieldInfo,
    FakeYTArray,
    _fill_chunk,
    _make_ds,
    fake_yt,
)

torch.set_num_threads(1)

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def data_file():
    return _data_file()


def test_require_yt_raises_without_yt():
    try:
        import yt  # noqa: F401
        pytest.skip("real yt installed; the ImportError path is moot")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="yt is required"):
        yt_fields._require_yt()


def test_prepare_grackle_data_translates_parameters(fake_yt, data_file):
    ds = _make_ds(data_file, chem=2)
    yt_fields.prepare_grackle_data(ds, **CPU)

    cd = ds.grackle_data
    assert isinstance(cd, grackle_tpu_torch.ChemistryData)
    assert cd.use_grackle == 1
    assert cd.primordial_chemistry == 2          # from MultiSpecies
    assert cd.metal_cooling == 1                 # from MetalCooling
    assert cd.cmb_temperature_floor == 1         # from CMBTemperatureFloor
    assert cd.grackle_data_file == data_file
    assert cd.comoving_coordinates == 0
    np.testing.assert_allclose(cd.density_units, DENSITY_CGS, rtol=1e-12)
    np.testing.assert_allclose(cd.length_units, LENGTH_CGS, rtol=1e-12)
    np.testing.assert_allclose(cd.time_units, TIME_CGS, rtol=1e-12)
    # initialize() ran: the context exists, on the device asked for
    assert cd.context is not None
    assert cd.context.device == torch.device("cpu")


def test_prepare_grackle_data_parameter_overrides(fake_yt, data_file):
    ds = _make_ds(data_file, chem=1)
    yt_fields.prepare_grackle_data(
        ds, parameters={"primordial_chemistry": 3}, **CPU)
    assert ds.grackle_data.primordial_chemistry == 3


def test_add_grackle_fields_registers_all(fake_yt, data_file):
    ds = _make_ds(data_file)
    yt_fields.add_grackle_fields(ds, **CPU)

    assert ("gas", "total_metal_density") in ds.derived_fields
    for fname in ("cooling_time", "dust_temperature", "gamma",
                  "mean_molecular_weight", "pressure", "temperature"):
        key = ("gas", f"grackle_{fname}")
        assert key in ds.derived_fields, key
        func, units = ds.derived_fields[key]
        assert callable(func)


def test_grackle_field_matches_direct_fluid_container(fake_yt, data_file):
    """grackle_temperature / grackle_pressure equal the port's direct
    FluidContainer calculation on the same state, with the cgs unit
    factor applied and the chunk shape restored."""
    shape = (4, 3, 2)
    ds = _make_ds(data_file)
    yt_fields.add_grackle_fields(ds, **CPU)
    data = _fill_chunk(FakeDataChunk(ds, shape), shape)

    n = int(np.prod(shape))
    fc = FluidContainer(ds.grackle_data, n)
    for gfield in ("density", "HI", "HII", "HeI", "HeII", "HeIII",
                   "metal", "energy"):
        yname, units = yt_fields._FIELD_MAP[gfield]
        fc[gfield][:] = np.asarray(data[yname]).ravel()
    fc["de"][:] = (np.asarray(data[("gas", "El_density")]).ravel()
                   * yt_fields._MP_OVER_ME)

    fc.calculate_temperature()
    func, _ = ds.derived_fields[("gas", "grackle_temperature")]
    out = func(FakeFieldInfo(("gas", "grackle_temperature")), data)
    assert out.shape == shape
    np.testing.assert_allclose(
        np.asarray(out).ravel(), np.asarray(fc["temperature"]),
        rtol=1e-12)

    fc.calculate_pressure()
    func, _ = ds.derived_fields[("gas", "grackle_pressure")]
    out = func(FakeFieldInfo(("gas", "grackle_pressure")), data)
    np.testing.assert_allclose(
        np.asarray(out).ravel(),
        np.asarray(fc["pressure"]) * DENSITY_CGS * VELOCITY_CGS ** 2,
        rtol=1e-12)


def test_grackle_field_electron_scaling_executes(fake_yt, data_file):
    shape = (8,)
    ds = _make_ds(data_file)
    yt_fields.prepare_grackle_data(ds, **CPU)
    data = _fill_chunk(FakeDataChunk(ds, shape), shape)
    fc = yt_fields._data_to_fc(data)
    assert isinstance(fc, FluidContainer)
    np.testing.assert_allclose(
        np.asarray(fc["de"]),
        np.asarray(data[("gas", "El_density")]) * yt_fields._MP_OVER_ME,
        rtol=1e-12)


def test_grackle_field_detector_skips_computation(fake_yt, data_file):
    shape = (2, 2, 2)
    ds = _make_ds(data_file)
    yt_fields.add_grackle_fields(ds, **CPU)
    data = _fill_chunk(FakeFieldDetector(ds, shape), shape)
    func, _ = ds.derived_fields[("gas", "grackle_temperature")]
    out = func(FakeFieldInfo(("gas", "grackle_temperature")), data)
    # detection pass: the untouched FluidContainer temperature (zeros)
    assert out.shape == shape
    np.testing.assert_array_equal(np.asarray(out), np.zeros(shape))


def test_total_metal_density_sums_enzo_fields(fake_yt, data_file):
    shape = (5,)
    ds = _make_ds(data_file)
    ds.field_list = [("enzo", "Metal_Density"), ("enzo", "SN_Colour")]
    data = FakeDataChunk(ds, shape)
    data[("enzo", "Metal_Density")] = FakeYTArray(
        np.full(shape, 2.0), "code_mass / code_length**3")
    data[("enzo", "SN_Colour")] = FakeYTArray(
        np.full(shape, 3.0), "code_mass / code_length**3")
    out = yt_fields._total_metal_density(None, data)
    np.testing.assert_allclose(np.asarray(out), 5.0)


def test_grackle_field_requires_initialization(fake_yt, data_file):
    ds = _make_ds(data_file)
    data = _fill_chunk(FakeDataChunk(ds, (4,)), (4,))
    with pytest.raises(RuntimeError, match="not been initialized"):
        yt_fields._grackle_field(
            FakeFieldInfo(("gas", "grackle_temperature")), data)


@pytest.mark.parametrize("name", ["temperature", "cooling_time",
                                  "mean_molecular_weight"])
def test_grackle_field_matches_jax(fake_yt, data_file, name):
    """The port's registered field against the JAX package's on the same
    chunk and dataset parameters, at rtol 1e-9."""
    shape = (3, 2, 2)
    values = []
    for module, kw in ((yt_fields, CPU), (jyt_fields, {})):
        ds = _make_ds(data_file)
        module.add_grackle_fields(ds, **kw)
        data = _fill_chunk(FakeDataChunk(ds, shape), shape)
        func, _ = ds.derived_fields[("gas", f"grackle_{name}")]
        values.append(np.asarray(
            func(FakeFieldInfo(("gas", f"grackle_{name}")), data)))
    assert values[0].shape == shape
    np.testing.assert_allclose(values[0], values[1], rtol=1e-9, atol=0)


def test_lazy_export_device_and_tables(fake_yt):
    """grackle_tpu_torch.add_grackle_fields is the lazy yt_fields one; it
    builds on the card unless asked for the CPU, and takes in-memory
    tables in place of the dataset's data file."""
    ds = _make_ds("")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            grackle_tpu_torch.add_grackle_fields(ds)
    ds = _make_ds("")
    grackle_tpu_torch.add_grackle_fields(
        ds, device="cpu", cloudy_data=synthetic_cloudy_groups())
    assert ds.grackle_data.context.cloudy_metal.grid_rank == 3
    data = _fill_chunk(FakeDataChunk(ds, (4,)), (4,))
    func, _ = ds.derived_fields[("gas", "grackle_cooling_time")]
    out = func(FakeFieldInfo(("gas", "grackle_cooling_time")), data)
    assert np.all(np.isfinite(np.asarray(out)))
