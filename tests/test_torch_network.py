"""grackle_tpu_torch's network region and the layers that feed it, against
grackle_tpu: the plain twin ``ops/network.network_update`` (which the CUDA
kernel is held to on the card), ``lookup_cool_rates``, ``cool1d_multi``
and ``calc_tdust_1d``, plus the operand slots each configuration's
kernel launch reads.

Inputs are made with numpy from a seed.  The network inputs are captured
from a few port subcycles of that state, turned back into numpy, and fed
to both packages; the JAX functions run eagerly.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from grackle_tpu import config as jconfig
from grackle_tpu.api import ChemistryData as JChemistryData
from grackle_tpu.ops import chemistry_step as jcs
from grackle_tpu.ops import common as jcommon
from grackle_tpu.ops import cooling as jcooling
from grackle_tpu.ops import dust_temp as jdust
from grackle_tpu.ops import lookup as jlookup
from grackle_tpu.ops import network as jnetwork
from grackle_tpu_torch.config import default_config
from grackle_tpu_torch.convert import context_from_numpy
from grackle_tpu_torch.ops import chemistry_step as pcs
from grackle_tpu_torch.ops import cooling as pcooling
from grackle_tpu_torch.ops import dust_kernel
from grackle_tpu_torch.ops import dust_temp as pdust
from grackle_tpu_torch.ops import network as pnetwork
from grackle_tpu_torch.ops import network_kernel
from grackle_tpu_torch.ops.common import (block_scalars, make_unit_scalars,
                                          photo_rates_from_tables,
                                          scalar_block)
from grackle_tpu_torch.rates.tables import ARRAY_FIELDS, SCALAR_FIELDS
from grackle_tpu_torch.utilities.physical_constants import mass_hydrogen_cgs

torch.set_num_threads(1)

UNIT_ATTRS = dict(density_units=mass_hydrogen_cgs, length_units=3.0857e21,
                  time_units=3.1556952e13)
#: network-region configurations: every primordial_chemistry (0 is
#: tabulated mode), with and without dust, the uncoupled (Jacobi)
#: deuterium update, compensated_sums and radiative transfer
CASES = chip_smoke.NETWORK_CASES
#: the answer workloads' state recipe: numpy fields from a seed
state = chip_smoke.answer_state


def port_chem(precision=64, **kw):
    """A port ChemistryData on the CPU with the answer workloads' units;
    metal cooling reads the in-memory synthetic Cloudy tables."""
    return chip_smoke.answer_chem("cpu", precision=precision, **kw)


def jax_context_as_port(jcd, device="cpu", dtype=torch.float64):
    """The JAX package's initialized context carried over as numpy
    arrays (convert.context_from_numpy): both packages then solve on
    identical tables."""
    ctx = jcd.context
    tables = {name: np.asarray(getattr(ctx.tables, name))
              for name in ARRAY_FIELDS + SCALAR_FIELDS}

    def cloudy(t):
        out = {"grid_rank": t.grid_rank, "grid_dimension": t.grid_dimension}
        for name in ["par1", "par2", "par3", "par4", "par5", "cooling",
                     "heating", "mmw"]:
            val = getattr(t, name)
            if val is not None:
                out[name] = np.asarray(val)
        return out

    uvb = None
    if ctx.uvb is not None:
        uvb = {f.name: (getattr(ctx.uvb, f.name) if f.name == "info"
                        or getattr(ctx.uvb, f.name) is None
                        else np.asarray(getattr(ctx.uvb, f.name)))
               for f in dataclasses.fields(ctx.uvb)}
    params = {name: getattr(ctx.config, name)
              for name in jconfig.PARAMETER_REGISTRY}
    return context_from_numpy(params, ctx.units, tables,
                              cloudy(ctx.cloudy_primordial),
                              cloudy(ctx.cloudy_metal), device=device,
                              dtype=dtype,
                              cloudy_data_new=ctx.cloudy_data_new, uvb=uvb)


def jax_config(cfg):
    return jconfig.ChemistryConfig(**{
        name: getattr(cfg, name) for name in jconfig.PARAMETER_REGISTRY})


def capture(cd, fields, dt, at):
    """The network region's inputs at each subcycle index in ``at``,
    from the port's own solve of ``fields``."""
    return [inp for _, inp in chip_smoke.capture_network_inputs(
        cd, fields, dt, at)]


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    return x


def network_args(cfg, inp, to_array):
    """(cfg, us, dt, f, rs, cool_v, carry_v, h2_limit) for one package,
    from captured inputs; ``to_array`` makes that package's arrays."""
    host = {k: _to_numpy(v) for k, v in inp.items()
            if k in ("f", "cool_v", "carry_v", "h2_limit")}
    rs = inp["rs"]

    def arr(d):
        return {k: (v if isinstance(v, float) else to_array(v.numpy()))
                for k, v in d.items()}

    rate_state = None
    if rs is not None:  # None in tabulated mode
        rate_state = (pcs.RateState if to_array is torch.from_numpy
                      else jcs.RateState)(
            k=arr(rs.k), k13dd=None,
            h2dust=None if rs.h2dust is None
            else to_array(rs.h2dust.numpy()),
            shields=arr(rs.shields), ti=None)
    # the unit scalars as each package's body reads them: 0-d arrays
    us = types.SimpleNamespace(dom=to_array(inp["us"].dom.numpy()),
                               chunit=to_array(inp["us"].chunit.numpy()))
    h2 = host["h2_limit"]
    return (cfg, us, inp["dt"],
            {k: to_array(v) for k, v in host["f"].items()}, rate_state,
            {k: to_array(v) for k, v in host["cool_v"].items()},
            {k: to_array(v) for k, v in host["carry_v"].items()},
            None if h2 is None else to_array(h2))


def flat(out):
    res = dict(out["fields"])
    res.update({k: v for k, v in out.items() if k != "fields"})
    return {k: np.asarray(v) for k, v in res.items()}


@pytest.mark.parametrize("precision", [64, 32])
@pytest.mark.parametrize("case", list(CASES))
def test_network_twin_matches_jax(case, precision):
    """ops/network.network_update (the kernel's plain twin) against the
    JAX network_update at subcycles 0 and 6 of a 64-cell solve.  The
    region is arithmetic only (no libm calls), written as the same IEEE
    operations in the same order in both packages, so every output is
    bit-identical in f64 and in f32."""
    cd = port_chem(precision, **CASES[case])
    cfg = cd.context.config
    dtype = np.float64 if precision == 64 else np.float32
    for inp in capture(cd, state(cd), 1.0e-4, (0, 6)):
        got = flat(pnetwork.network_update(
            *network_args(cfg, inp, torch.from_numpy)))
        want = flat(jnetwork.network_update(
            *network_args(jax_config(cfg), inp, jnp.asarray)))
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            g = got[name]
            assert g.dtype == w.dtype, name
            if w.dtype not in (np.bool_, np.int32):
                assert g.dtype == dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.fixture(scope="module")
def dust_contexts():
    """The flagship configuration (12 species, dust, metal cooling, CMB
    floor) in both packages on identical tables, with a 64-cell state."""
    from tests.answer_workloads import _data_file

    jcd = JChemistryData()
    jcd.use_grackle = 1
    jcd.with_radiative_cooling = 1
    jcd.precision = 64
    jcd.use_fused_lookup = 0
    for k, v in dict(UNIT_ATTRS, primordial_chemistry=3, metal_cooling=1,
                     dust_chemistry=1, grackle_data_file=_data_file(),
                     ).items():
        setattr(jcd, k, v)
    # the f32 splits of the fused TPU lookup are slow to build and unused
    # on the gather path (use_fused_lookup = 0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlookup, "pair_split", lambda mat: None)
        assert jcd.initialize() == 1
    pctx = jax_context_as_port(jcd)
    return jcd, pctx, state(jcd)


def _both_units(jcd, pctx):
    jctx = jcd.context
    jus = jcommon.make_unit_scalars(jctx.config, jctx.tables, jctx.units)
    jpr = jcommon.photo_rates_from_tables(jctx.tables)
    pus, ppr, _ = block_scalars(scalar_block(
        pctx.config, "cpu",
        make_unit_scalars(pctx.config, pctx.tables, pctx.units),
        photo_rates_from_tables(pctx.tables), pctx.units))
    return jus, jpr, pus, ppr


def _cool_both(jcd, pctx, fields, tgasold, first_iter, tdust_prev):
    jctx = jcd.context
    jus, jpr, pus, ppr = _both_units(jcd, pctx)
    jf = {k: jnp.asarray(v) for k, v in fields.items()}
    pf = {k: torch.from_numpy(np.asarray(v)) for k, v in fields.items()}
    want = jcooling.cool1d_multi(
        jctx.config, jctx.tables, jctx.cloudy_primordial, jctx.cloudy_metal,
        jpr, jus, jf, jnp.asarray(tgasold), jnp.asarray(first_iter), True,
        jctx.cloudy_data_new, tdust_prev=jnp.asarray(tdust_prev))
    got = pcooling.cool1d_multi(
        pctx.config, pctx.tables, pctx.cloudy_primordial, pctx.cloudy_metal,
        ppr, pus, pf, torch.from_numpy(tgasold),
        torch.from_numpy(first_iter), True, pctx.cloudy_data_new,
        tdust_prev=torch.from_numpy(tdust_prev))
    return got, want


#: f64 parity of the lookups, cooling and dust solve: the same operations
#: on the same tables; log, exp and pow come from two libms (PyTorch's
#: vectorised ones and XLA's), which differ by an ulp or two, and the
#: Newton and bisection steps of the dust solve carry that along.
F64_RTOL = 1e-12


def test_cool1d_multi_matches(dust_contexts):
    """cool1d_multi at the first subcycle and, warm-started from it, at
    the next one."""
    jcd, pctx, fields = dust_contexts
    n = fields["density"].shape[0]
    tgasold = np.zeros(n)
    first = np.ones(n, dtype=bool)
    tdust = np.zeros(n)
    for _ in range(2):
        got, want = _cool_both(jcd, pctx, fields, tgasold, first, tdust)
        for name in ["edot", "tgas", "tgasold", "mmw", "p2d", "tdust",
                     "rhoH", "mynh", "myde", "metallicity", "dust2gas"]:
            np.testing.assert_allclose(
                getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                rtol=F64_RTOL, atol=0, err_msg=name)
        tgasold = got.tgas.numpy()
        first = np.zeros(n, dtype=bool)
        tdust = got.tdust.numpy()


def test_lookup_cool_rates_matches(dust_contexts):
    jcd, pctx, fields = dust_contexts
    n = fields["density"].shape[0]
    cool, _ = _cool_both(jcd, pctx, fields, np.zeros(n),
                         np.ones(n, dtype=bool), np.zeros(n))
    args = {name: getattr(cool, name).numpy()
            for name in ["tgas", "mmw", "tdust", "dust2gas"]}
    jus, jpr, pus, ppr = _both_units(jcd, pctx)
    jctx = jcd.context
    want = jcs.lookup_cool_rates(
        jctx.config, jctx.tables, jpr, jus,
        {k: jnp.asarray(v) for k, v in fields.items()},
        *[jnp.asarray(args[k]) for k in ["tgas", "mmw", "tdust",
                                         "dust2gas"]])
    got = pcs.lookup_cool_rates(
        pctx.config, pctx.tables, ppr, pus,
        {k: torch.from_numpy(v) for k, v in fields.items()},
        *[torch.from_numpy(args[k]) for k in ["tgas", "mmw", "tdust",
                                              "dust2gas"]])
    assert sorted(got.k) == sorted(want.k)
    for name in want.k:
        np.testing.assert_allclose(got.k[name].numpy(),
                                   np.asarray(want.k[name]), rtol=F64_RTOL,
                                   atol=0, err_msg=name)
    np.testing.assert_allclose(got.h2dust.numpy(), np.asarray(want.h2dust),
                               rtol=F64_RTOL, atol=0)
    np.testing.assert_allclose(got.k13dd.numpy(), np.asarray(want.k13dd),
                               rtol=F64_RTOL, atol=0)
    for name, w in want.shields.items():
        g = got.shields[name]
        g = g if isinstance(g, float) else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), rtol=F64_RTOL, atol=0,
                                   err_msg=name)


def test_calc_tdust_1d_matches(dust_contexts, monkeypatch):
    """calc_tdust_1d on the arguments cool1d_multi hands the dust
    temperature's router (ops/dust_kernel.dust_temperature), cold and
    warm-started; the blocked early exit must give the JAX loops'
    answer, and the answer of a check after every step."""
    jcd, pctx, fields = dust_contexts
    seen = []
    real = dust_kernel.dust_temperature

    def record(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(dust_kernel, "dust_temperature", record)
    n = fields["density"].shape[0]
    cool, _ = _cool_both(jcd, pctx, fields, np.zeros(n),
                         np.ones(n, dtype=bool), np.zeros(n))
    assert len(seen) == 1
    args, kw = seen[0]
    warm = cool.tdust
    for tdust_init in (None, warm, 0.5 * warm):
        def conv(x, to):
            return to(x.numpy()) if isinstance(x, torch.Tensor) else x

        jargs = [conv(a, jnp.asarray) for a in args]
        if jargs[5] is None:
            # the port's itmask None: every cell
            jargs[5] = jnp.ones(n, dtype=bool)
        want = jdust.calc_tdust_1d(
            *jargs,
            tdust_init=None if tdust_init is None
            else jnp.asarray(tdust_init.numpy()))
        got = pdust.calc_tdust_1d(*args, tdust_init=tdust_init)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=F64_RTOL, atol=0)
        # one host check per BLOCK masked steps is exact: the same as a
        # check after every step
        monkeypatch.setattr(pdust, "BLOCK", 1)
        assert torch.equal(
            pdust.calc_tdust_1d(*args, tdust_init=tdust_init), got)
        monkeypatch.undo()


@pytest.mark.parametrize("precision", [64, 32])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_input_slots(case, precision):
    """The operand slots a configuration's launch reads, the only ones
    passed to the kernel, and their bytes a cell."""
    nk = network_kernel
    cfg = default_config(**CASES[case])
    isp = cfg.primordial_chemistry
    dtype = torch.float64 if precision == 64 else torch.float32
    slots = nk.input_slots(cfg)
    names = [nk.IN_SLOTS[j] for j in slots]
    assert slots == sorted(set(slots))
    rt = 0 if not cfg.use_radiative_transfer or isp == 0 else (
        1 if cfg.radiative_transfer_hydrogen_only else 3)
    anydust = cfg.h2_on_dust > 0 or cfg.dust_chemistry > 0
    comp = cfg.compensated_sums == 1
    assert sum(x in nk.SPECIES_SLOTS for x in names) == (0, 6, 9, 12)[isp]
    assert sum(x in nk.RT_SLOTS for x in names) == rt
    assert ("k1" in names, "k7" in names, "k50" in names) == (
        isp > 0, isp > 1, isp > 2)
    assert ("h2dust" in names) == (anydust and isp > 1)
    assert ("h2_limit" in names) == (isp > 1)
    assert ("energy_lo" in names, "ttot_lo" in names) == (comp, comp)
    k = (0, 8, 25, 32)[isp] + (0, 3, 7, 7)[isp]
    assert len(slots) == (2 + (0, 6, 9, 12)[isp] + rt + k
                          + (anydust and isp > 1) + 6 + 9 + 2 * comp
                          + (isp > 1))
    flags = {nk.slot_dtype(j, dtype) for j in slots} - {dtype}
    assert flags == {torch.bool, torch.int32}
    cell_bytes = sum(nk.slot_dtype(j, dtype).itemsize for j in slots)
    if case == "chem3_dust_metal":  # the flagship: 67 floats and 3 flags
        assert (len(slots), cell_bytes) == (70, (542, 274)[precision == 32])
