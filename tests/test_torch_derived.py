"""grackle_tpu_torch's derived fields, tabulated temperature and UVB
rates against grackle_tpu, on identical tables.

The JAX package initializes each configuration from its synthetic data
file; its context is carried over to the port as numpy arrays
(convert.context_from_numpy).  The same seeded numpy state then goes
through the JAX function, run eagerly, and its port, both on the CPU in
f64.  The tolerance is rtol 1e-12: log, exp and pow come from two libms
(PyTorch's and XLA's), an ulp or two apart, and the fixed points of the
tabulated temperature and of the dust temperature carry that along.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grackle_tpu import api as japi
from grackle_tpu.api import ChemistryData as JChemistryData
from grackle_tpu.data import uvb as juvb
from grackle_tpu.ops import common as jcommon
from grackle_tpu.ops import derived as jderived
from grackle_tpu.ops import lookup as jlookup
from grackle_tpu.ops import tabulated_temp as jtab
from grackle_tpu_torch import api as papi
from grackle_tpu_torch.data import uvb as puvb
from grackle_tpu_torch.ops import derived as pderived
from grackle_tpu_torch.ops import tabulated_temp as ptab
from grackle_tpu_torch.ops.common import block_scalars
from tests.answer_workloads import _data_file
from tests.test_torch_network import UNIT_ATTRS, jax_context_as_port, state

torch.set_num_threads(1)

RTOL = 1e-12

#: one configuration per branch of the derived fields: 12 species with
#: dust, metals and the UVB in comoving units at z = 1; tabulated mode;
#: the 6-species network
CONFIGS = {
    "dust_uvb_comoving": dict(primordial_chemistry=3, metal_cooling=1,
                              dust_chemistry=1, UVbackground=1,
                              comoving_coordinates=1, a_value=0.5),
    "tabulated": dict(primordial_chemistry=0, metal_cooling=1,
                      UVbackground=1),
    "6species": dict(primordial_chemistry=1),
}


def _jax_chem(**kw):
    jcd = JChemistryData()
    jcd.use_grackle = 1
    jcd.with_radiative_cooling = 1
    jcd.precision = 64
    jcd.use_fused_lookup = 0
    jcd.grackle_data_file = _data_file()
    for k, v in dict(UNIT_ATTRS, **kw).items():
        setattr(jcd, k, v)
    # the f32 splits of the fused TPU lookup are unused on the gather path
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlookup, "pair_split", lambda mat: None)
        assert jcd.initialize() == 1
    return jcd


@functools.lru_cache(maxsize=None)
def _both(name):
    """(JAX ChemistryData, port context, 32-cell numpy state) for one
    configuration, built once per test process."""
    jcd = _jax_chem(**CONFIGS[name])
    f = state(jcd, n=32)
    if jcd.primordial_chemistry == 0:
        f["metal"] = 0.01 * f["density"]
    return jcd, jax_context_as_port(jcd), f


def _args(jcd, pctx, f):
    jctx = jcd.context
    jus = jcommon.make_unit_scalars(jctx.config, jctx.tables, jctx.units)
    pus, _, _ = block_scalars(papi.call_scalars(pctx, "cpu"))
    jf = {k: jnp.asarray(v) for k, v in f.items()}
    pf = {k: torch.from_numpy(np.asarray(v)) for k, v in f.items()}
    return jctx, jus, jf, pus, pf, "metal" in f


def _close(got, want, name):
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == np.float64 and got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, err_msg=name)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_derived_fields_match(name):
    """Pressure, temperature, gamma, dust temperature and cooling time."""
    jcd, pctx, f = _both(name)
    jctx, jus, jf, pus, pf, imetal = _args(jcd, pctx, f)
    jcfg, pcfg = jctx.config, pctx.config
    _close(pderived.calculate_pressure(pcfg, pus, pf, imetal),
           jderived.calculate_pressure(jcfg, jus, jf, imetal), "pressure")
    _close(pderived.calculate_temperature(pcfg, pctx.cloudy_primordial, pus,
                                          pf, imetal),
           jderived.calculate_temperature(jcfg, jctx.cloudy_primordial, jus,
                                          jf, imetal), "temperature")
    _close(pderived.calculate_gamma(pcfg, pctx.cloudy_primordial, pus, pf,
                                    imetal),
           jderived.calculate_gamma(jcfg, jctx.cloudy_primordial, jus, jf,
                                    imetal), "gamma")
    _, ppr, punits = block_scalars(papi.call_scalars(pctx, "cpu"))
    _close(pderived.calculate_dust_temperature(
               pcfg, pctx.tables, pctx.cloudy_primordial, pus, pf,
               punits, imetal),
           jderived.calculate_dust_temperature(
               jcfg, jctx.tables, jctx.cloudy_primordial, jus, jf,
               jctx.units, imetal), "dust_temperature")
    comoving = bool(jctx.units.comoving_coordinates)
    jpr = japi._photo_rates(jcfg, jctx.tables, jctx.uvb, jctx.units)
    _close(pderived.calculate_cooling_time(
               pcfg, pctx.tables, pctx.cloudy_primordial, pctx.cloudy_metal,
               ppr, pus, pf, imetal, pctx.cloudy_data_new, comoving),
           jderived.calculate_cooling_time(
               jcfg, jctx.tables, jctx.cloudy_primordial, jctx.cloudy_metal,
               jpr, jus, jf, imetal, jctx.cloudy_data_new, comoving),
           "cooling_time")


def test_tabulated_temperature_matches():
    """The T <-> mu fixed point against the Cloudy MMW table, with and
    without the metal correction; the blocked early exit gives the
    answer of a check after every step."""
    jcd, pctx, f = _both("tabulated")
    jctx, jus, jf, pus, pf, _ = _args(jcd, pctx, f)
    fh = jctx.config.HydrogenFractionByMass
    for imetal in (True, False):
        metal = f["metal"] if imetal else np.zeros_like(f["density"])
        rhoH = fh * (f["density"] - metal) if imetal else fh * f["density"]

        def run(mod, table, us, arr):
            return mod.tabulated_temperature(
                table, arr(f["density"]), arr(metal), arr(f["energy"]),
                arr(rhoH), us.dom, us.zr, jctx.config.TemperatureStart,
                jctx.config.Gamma, us.utem, imetal)

        got = run(ptab, pctx.cloudy_primordial, pus, torch.from_numpy)
        want = run(jtab, jctx.cloudy_primordial, jus, jnp.asarray)
        _close(got[0], want[0], "tgas")
        _close(got[1], want[1], "mmw")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ptab, "BLOCK", 1)
            every = run(ptab, pctx.cloudy_primordial, pus, torch.from_numpy)
        assert all(torch.equal(a, b) for a, b in zip(every, got))


@functools.lru_cache(maxsize=None)
def _uvb_contexts():
    """(JAX context, port context) of the UVB-rate configuration, built
    once per test process."""
    jcd = _jax_chem(primordial_chemistry=2, UVbackground=1,
                    self_shielding_method=2, Compton_xray_heating=1,
                    LWbackground_sawtooth_suppression=1,
                    UVbackground_redshift_on=9.0,
                    UVbackground_redshift_fullon=8.0,
                    UVbackground_redshift_drop=0.5,
                    UVbackground_redshift_off=0.0)
    return jcd.context, jax_context_as_port(jcd)


@pytest.mark.parametrize("redshift", [0.0, 0.3, 1.5, 8.7, 19.0])
def test_update_uvb_rates_matches(redshift):
    """The photo rates in the ramp-off (z < 0.5) and ramp-on (8 < z < 9)
    ranges, on the plateau and past redshift_on (every rate zero), with
    self-shielding cross sections, the sawtooth LW suppression and
    Compton X-ray heating."""
    jctx, pctx = _uvb_contexts()
    units = dataclasses.replace(jctx.units, comoving_coordinates=1,
                                a_value=1.0 / (1.0 + redshift))
    want = juvb.update_uvb_rates(jctx.config, jctx.uvb, units)
    got = puvb.update_uvb_rates(pctx.config, pctx.uvb, units)
    assert (float(want.k24) != 0) == (redshift <= 9.0)
    for field in dataclasses.fields(got):
        g, w = getattr(got, field.name), float(getattr(want, field.name))
        assert isinstance(g, float), field.name
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=0,
                                   err_msg=field.name)


def test_uvb_table_from_memory_matches_file():
    """load_uvb_table reads the same rates from the in-memory synthetic
    groups as from the data file, and the same as the JAX loader."""
    from grackle_tpu_torch.data.synthetic import synthetic_cloudy_groups

    cfg = papi.resolve_config(papi.ChemistryConfig(
        primordial_chemistry=3, UVbackground=1, self_shielding_method=3))
    jcfg = japi.resolve_config(japi.ChemistryConfig(
        primordial_chemistry=3, UVbackground=1, self_shielding_method=3))
    want = juvb.load_uvb_table(_data_file(), jcfg)
    for source in (_data_file(), synthetic_cloudy_groups()):
        got = puvb.load_uvb_table(source, cfg)
        assert got.info == want.info
        for field in dataclasses.fields(got):
            if field.name == "info":
                continue
            np.testing.assert_array_equal(
                getattr(got, field.name),
                np.asarray(getattr(want, field.name)), err_msg=field.name)
    assert puvb.uvb_redshift_bounds(cfg, got) == \
        juvb.uvb_redshift_bounds(jcfg, want)
