"""Shared per-call scalar containers and dtype constants for the solver
(port of grackle_tpu/ops/common.py).

A call's unit scalars and photo rates are computed on the host in f64
(:func:`make_unit_scalars`, ``data/uvb.update_uvb_rates``), as the
reference computes them in C per call.  The bodies read them as 0-d
tensors: :func:`scalar_block` writes a call's values into one small 1-D
tensor in the solver dtype on the fields' device (one host-to-device
copy), and :func:`block_scalars` gives its elements back as the fields of
``UnitScalars``, ``PhotoRates`` and ``BodyUnits``, 0-d views of the
block.  The JAX package traces the same values as arrays in the solver
dtype (grackle_tpu/ops/common.py:46-164), so its jitted cores compile
once whatever the ``a_value``; here a CUDA graph that captured a body
reads the block's static copy and replays with whatever a later call
copied into it (graph_cache.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..constants import GravConst, kboltz, mh, pi_val


def solver_dtype(cfg):
    """Field/solver dtype from the precision parameter (analogue of the
    gr_float compile-time choice, grackle_types.h:24-34)."""
    return torch.float64 if cfg.precision == 64 else torch.float32


def as_dt(dt, like):
    """``dt`` as the solvers take it: a 0-d float64 tensor on ``like``'s
    device.  A host float is filled in on the device (no copy, so a
    CUDA-graph capture may record it, its value fixed); a tensor must be
    0-d and real, on that device, and a graph that captured the solve
    replays with whatever it then holds.  Every entry point of the
    solvers converts here, so below them ``dt`` has one form."""
    if not isinstance(dt, torch.Tensor):
        return torch.full((), float(dt), dtype=torch.float64,
                          device=like.device)
    if dt.shape != () or dt.device != like.device or dt.is_complex():
        raise ValueError(f"dt: want a float or a 0-d real tensor on "
                         f"{like.device}, got {dt.dtype} {tuple(dt.shape)} "
                         f"on {dt.device}")
    return dt.to(torch.float64)


def dtype_tiny8(dtype):
    """The reference's tiny8 = 1e-40 double floor
    (grackle_fortran_types.def); 1e-37 for float32 (the smallest normal
    is ~1.18e-38)."""
    if dtype == torch.float64:
        return 1.0e-40
    return 1.0e-37


def dtype_huge8(dtype):
    """huge8 = 1e40 (grackle_fortran_types.def); 1e37 for float32 where
    1e40 would overflow to inf."""
    if dtype == torch.float64:
        return 1.0e40
    return 1.0e37


def dtype_tolerance(dtype):
    """Subcycle completion tolerance (solve_rate_cool_g.F:255-263):
    1e-10 for the double build, 1e-5 for the float build."""
    if dtype == torch.float64:
        return 1.0e-10
    return 1.0e-5


_US_FIELDS = [
    "dom", "coolunit", "tbase1", "xbase1", "dbase1", "uvel", "utem",
    "chunit", "dx_cgs", "c_ljeans", "aye", "zr", "comp1", "comp2",
]


@dataclasses.dataclass(frozen=True)
class UnitScalars:
    """Per-call unit conversions (solve_rate_cool_g.F:331-343 and
    cool1d_multi_g.F:185-198): host floats from
    :func:`make_unit_scalars`, 0-d tensors in a body
    (:func:`block_scalars`)."""

    dom: Any
    coolunit: Any
    tbase1: Any
    xbase1: Any
    dbase1: Any
    uvel: Any
    utem: Any
    chunit: Any
    dx_cgs: Any
    c_ljeans: Any
    aye: Any
    zr: Any
    comp1: Any
    comp2: Any


def make_unit_scalars(cfg, tables, units, grid_dx=0.0) -> UnitScalars:
    """Compute the solver's unit scalars from a CodeUnits instance.

    Mirrors solve_rate_cool_g.F:331-343; comp1/comp2 as in
    cool1d_multi_g.F:197-198.
    """
    aye = units.a_value
    utim = units.time_units
    uxyz = units.co_length_units
    uaye = units.a_units
    urho = units.co_density_units
    dom = urho * aye**3 / mh
    tbase1 = utim
    xbase1 = uxyz / (aye * uaye)
    dbase1 = urho * (aye * uaye) ** 3
    coolunit = (uaye**5 * xbase1**2 * mh**2) / (tbase1**3 * dbase1)
    uvel = (uxyz / aye) / utim
    # 1 eV per H2 formed (solve_rate_cool_g.F:337)
    chunit = 1.60218e-12 / (2.0 * uvel * uvel * mh)
    dx_cgs = grid_dx * xbase1
    c_ljeans = math.sqrt(
        (cfg.Gamma * pi_val * kboltz) / (GravConst * mh * dbase1)
    )
    utem = units.temperature_units
    zr = 1.0 / (aye * uaye) - 1.0
    comp1 = tables.comp * (1.0 + zr) ** 4
    comp2 = 2.73 * (1.0 + zr)
    return UnitScalars(
        dom=float(dom), coolunit=float(coolunit), tbase1=float(tbase1),
        xbase1=float(xbase1), dbase1=float(dbase1), uvel=float(uvel),
        utem=float(utem), chunit=float(chunit), dx_cgs=float(dx_cgs),
        c_ljeans=float(c_ljeans), aye=float(aye), zr=float(zr),
        comp1=float(comp1), comp2=float(comp2),
    )


_PR_FIELDS = [
    "k24", "k25", "k26", "k27", "k28", "k29", "k30", "k31",
    "piHI", "piHeI", "piHeII", "crsHI", "crsHeI", "crsHeII",
    "comp_xray", "temp_xray",
]

#: Per-call photo-ionization/heating scalars (analogue of
#: photo_rate_storage, grackle: src/clib/grackle_chemistry_data.h:410-438):
#: host floats per call, 0-d tensors in a body.
PhotoRates = dataclasses.make_dataclass(
    "PhotoRates", [(name, Any) for name in _PR_FIELDS], frozen=True,
)

#: The ``CodeUnits`` values a body reads besides the unit scalars: the
#: dust temperature's density unit (calc_tdust_3d_g.F:143-145).
BodyUnits = dataclasses.make_dataclass(
    "BodyUnits", [("co_density_units", Any)], frozen=True,
)

#: a call's scalar block, element by element
BLOCK_FIELDS = _US_FIELDS + _PR_FIELDS + ["co_density_units"]


def photo_rates_from_tables(tables) -> "PhotoRates":
    """Copy the constant photo rates (solve_chemistry.c:120-137)."""
    return PhotoRates(**{f: float(getattr(tables, f)) for f in _PR_FIELDS})


def scalar_block(cfg, device, us, pr, units) -> torch.Tensor:
    """A call's host scalars (``UnitScalars`` and ``PhotoRates`` of host
    floats, the ``CodeUnits``) as one 1-D tensor of BLOCK_FIELDS on
    ``device``, each value rounded once from f64 to the solver dtype, as
    the JAX package rounds each with ``jnp.asarray(x, dtype)``.  On the
    card the values go over in one copy from pinned memory, which leaves
    the host free to queue work.  While the current stream captures (a
    host recording the call into its own graph) they are filled in
    instead, their values fixed in that graph, as :func:`as_dt` fills a
    float ``dt``: a recorded copy would read a host buffer at every
    replay."""
    values = ([getattr(us, name) for name in _US_FIELDS]
              + [getattr(pr, name) for name in _PR_FIELDS]
              + [units.co_density_units])
    dtype = solver_dtype(cfg)
    device = torch.device(device)
    host = torch.tensor(values, dtype=torch.float64).to(dtype)
    if device.type != "cuda":
        return host.to(device)
    if torch.cuda.is_current_stream_capturing():
        return torch.stack([torch.full((), v, dtype=dtype, device=device)
                            for v in host.tolist()])
    return host.pin_memory().to(device, non_blocking=True)


def block_scalars(block):
    """The elements of a scalar block (:func:`scalar_block`) as
    ``(UnitScalars, PhotoRates, BodyUnits)`` of 0-d views: a body reads
    them from the block's memory, so a graph that captured it replays
    with whatever values the block then holds."""
    if block.shape != (len(BLOCK_FIELDS),):
        raise ValueError(f"scalar block: want shape ({len(BLOCK_FIELDS)},), "
                         f"got {tuple(block.shape)}")
    vals = dict(zip(BLOCK_FIELDS, block.unbind(0)))
    return (UnitScalars(**{k: vals[k] for k in _US_FIELDS}),
            PhotoRates(**{k: vals[k] for k in _PR_FIELDS}),
            BodyUnits(co_density_units=vals["co_density_units"]))


def div_host(x, c: float):
    """``x / c`` for a host float ``c``, as one IEEE division on every
    device.  PyTorch's CUDA division by a Python scalar multiplies by the
    scalar's rounded reciprocal instead, up to an ulp off the quotient;
    dividing by a 0-d tensor keeps the plain network region's arithmetic
    the same on CPU and CUDA, and the same as the kernel's."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def ipow(x, n: int):
    """``x ** n`` for a Python int ``n`` by binary exponentiation, the
    sequence of products JAX's ``integer_pow`` emits (x**4 is
    (x*x)*(x*x), a negative n takes the reciprocal last), so both
    packages round alike."""
    if n == 0:
        return torch.ones_like(x)
    recip = n < 0
    y = -n if recip else n
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return 1.0 / acc if recip else acc
