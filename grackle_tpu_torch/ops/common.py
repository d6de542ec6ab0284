"""Shared host-scalar containers and dtype constants for the solver
(port of grackle_tpu/ops/common.py).

Unit scalars and photo rates are host Python floats: every op that meets
one with a tensor rounds it to the tensor's dtype, so an f32 solve stays
f32 and an f64 solve stays f64.
"""

from __future__ import annotations

import dataclasses
import math

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


@dataclasses.dataclass(frozen=True)
class UnitScalars:
    """Per-call unit conversions (solve_rate_cool_g.F:331-343 and
    cool1d_multi_g.F:185-198), as host floats."""

    dom: float
    coolunit: float
    tbase1: float
    xbase1: float
    dbase1: float
    uvel: float
    utem: float
    chunit: float
    dx_cgs: float
    c_ljeans: float
    aye: float
    zr: float
    comp1: float
    comp2: float


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
#: photo_rate_storage, grackle: src/clib/grackle_chemistry_data.h:410-438),
#: as host floats.
PhotoRates = dataclasses.make_dataclass(
    "PhotoRates", [(name, float) for name in _PR_FIELDS], frozen=True,
)


def photo_rates_from_tables(tables) -> "PhotoRates":
    """Copy the constant photo rates (solve_chemistry.c:120-137)."""
    return PhotoRates(**{f: float(getattr(tables, f)) for f in _PR_FIELDS})


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
