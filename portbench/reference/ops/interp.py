"""Vectorized multilinear table interpolation (port of
grackle_tpu/ops/interp.py, gather path).

Batched rebuild of the reference's uniform-grid interpolators
(grackle: src/clib/interpolators_g.F:4-566): one gather + lerp chain over
the whole cell axis per call.

Conventions match the reference exactly:
* data is C-order with parameter 1 slowest (interpolators_g.F:83,150).
* interpolation index is ``min(dim-1, max(1, int((x-x0)/dx)+1))`` in 1-based
  indexing (interpolators_g.F:29-30), i.e. values outside the grid are
  *linearly extrapolated* from the edge cell.
* the redshift axis of 3-D Cloudy tables is non-uniform and interpolated in
  log(1+z) with a 2-D fallback past the final redshift
  (interpolators_g.F:186-269,279-338).
"""

from __future__ import annotations

import torch


def _uniform_index(x, par, dim):
    """1-based reference index -> 0-based: clip(floor((x-x0)/dx), 0, dim-2).

    (interpolators_g.F:29-30)
    """
    dpar = (par[dim - 1] - par[0]) / (dim - 1)
    idx = torch.floor((x - par[0]) / dpar).to(torch.int64)
    return torch.clamp(idx, 0, dim - 2)


def _lerp(x, x0, x1, f0, f1):
    slope = (f1 - f0) / (x1 - x0)
    return (x - x0) * slope + f0


def interpolate_1d(x, par1, data):
    """(interpolators_g.F:4-40); x batched, data shape (D1,)."""
    d1 = data.shape[0]
    i1 = _uniform_index(x, par1, d1)
    return _lerp(x, par1[i1], par1[i1 + 1], data[i1], data[i1 + 1])


def interpolate_2d(x1, x2, par1, par2, data):
    """(interpolators_g.F:45-101); data shape (D1, D2)."""
    d1, d2 = data.shape
    i1 = _uniform_index(x1, par1, d1)
    i2 = _uniform_index(x2, par2, d2)
    v_lo = _lerp(x2, par2[i2], par2[i2 + 1], data[i1, i2], data[i1, i2 + 1])
    v_hi = _lerp(x2, par2[i2], par2[i2 + 1],
                 data[i1 + 1, i2], data[i1 + 1, i2 + 1])
    return _lerp(x1, par1[i1], par1[i1 + 1], v_lo, v_hi)


def interpolate_3d(x1, x2, x3, par1, par2, par3, data):
    """(interpolators_g.F:106-178); data shape (D1, D2, D3)."""
    d1, d2, d3 = data.shape
    i1 = _uniform_index(x1, par1, d1)
    i2 = _uniform_index(x2, par2, d2)
    i3 = _uniform_index(x3, par3, d3)

    def v3(q, w):
        return _lerp(x3, par3[i3], par3[i3 + 1],
                     data[i1 + q, i2 + w, i3], data[i1 + q, i2 + w, i3 + 1])

    def v2(q):
        return _lerp(x2, par2[i2], par2[i2 + 1], v3(q, 0), v3(q, 1))

    return _lerp(x1, par1[i1], par1[i1 + 1], v2(0), v2(1))


def index_pick(data, dim, index):
    """``data`` at one position ``index`` (a one-element tensor) of axis
    ``dim``, that axis dropped.  Indexing with a 0-d tensor would read it
    on the host, which a CUDA graph cannot capture."""
    return data.index_select(dim, index).squeeze(dim)


def redshift_index(zr, par2, d2):
    """Bisection index + past-the-end flag for the redshift axis of 3-D
    Cloudy tables (grackle: cool1d_cloudy_g.F:128-153).

    ``zr`` is the call's 0-d redshift, in par2's dtype and on its device.
    Returns (zi0, end_int) as 0-d tensors on par2's device: zi0 is the
    0-based lower bracket, clipped to [0, d2-3]; end_int is True when zr is
    at/past the second-to-last redshift, in which case interpolation
    collapses to 2-D at the final table slice.
    """
    z = zr.reshape(1).to(par2.dtype)
    zi0 = torch.clamp(
        torch.searchsorted(par2, z, right=True)[0] - 1, 0, d2 - 3
    )
    end_int = z[0] >= par2[d2 - 2]
    # reference pins zindex = D2 (1-based) in the end_int case; the 2-D
    # fallback then reads slice (zindex-1) = D2-1 (0-based last slice).
    zi0 = torch.where(end_int, torch.full_like(zi0, d2 - 1), zi0)
    return zi0, end_int


def interpolate_3dz(x1, zr, x3, par1, par2, par3, data, zi0, end_int):
    """Non-uniform middle (redshift) axis in log(1+z), with 2-D fallback
    past the last redshift (interpolators_g.F:186-269,279-338).

    zi0/end_int come from :func:`redshift_index` (computed once per call,
    shared by all cells).
    """
    d1, d2, d3 = data.shape
    i1 = _uniform_index(x1, par1, d1)
    i3 = _uniform_index(x3, par3, d3)

    # --- full 3-D path (clamped so the end_int case stays in bounds) ---
    # the redshift index as a one-element index tensor: a 0-d one would
    # be read on the host (see index_pick)
    zi = torch.clamp(zi0, 0, d2 - 2).reshape(1)

    def v3(q, w):
        return _lerp(x3, par3[i3], par3[i3 + 1],
                     data[i1 + q, zi + w, i3], data[i1 + q, zi + w, i3 + 1])

    zlog = torch.log((1.0 + par2[zi + 1]) / (1.0 + par2[zi]))
    zfrac = torch.log((1.0 + zr) / (1.0 + par2[zi]))

    def v2(q):
        slope = (v3(q, 1) - v3(q, 0)) / zlog
        return zfrac * slope + v3(q, 0)

    full = _lerp(x1, par1[i1], par1[i1 + 1], v2(0), v2(1))

    # --- 2-D fallback at the last redshift slice ---
    zlast = torch.clamp(zi0, 0, d2 - 1).reshape(1)

    def f3(q):
        return _lerp(x3, par3[i3], par3[i3 + 1],
                     data[i1 + q, zlast, i3], data[i1 + q, zlast, i3 + 1])

    flat = _lerp(x1, par1[i1], par1[i1 + 1], f3(0), f3(1))

    return torch.where(end_int, flat, full)


# ---------------------------------------------------------------------------
# Row forms for the exact-integration path (ops/exact_cool.py): contract
# every non-temperature axis once, then interpolate along temperature.  The
# JAX package builds these from two-hot matmuls and an f32 split fetch, a
# TPU's way around gathers; here each is a gather plus a lerp, in both
# dtypes, with the same unclamped fractions (linear extrapolation past the
# grid edges, interpolators_g.F:29-37).
# ---------------------------------------------------------------------------


def _uniform_frac(x, par, dim):
    """Clamped bracket index + unclamped linear fraction (extrapolating
    beyond the grid edges like interpolators_g.F:29-37).  Grid values are
    reconstructed arithmetically (par[0] + i*dpar), as the reference's
    own index math assumes uniform spacing (interpolators_g.F:29-30)."""
    dpar = (par[dim - 1] - par[0]) / (dim - 1)
    i = torch.clamp(
        torch.floor((x - par[0]) / dpar).to(torch.int64), 0, dim - 2
    )
    x0 = par[0] + i.to(x.dtype) * dpar
    frac = (x - x0) / dpar
    return i, frac


def collapse_redshift(data, par2, zr, zi0, end_int):
    """The (D1, D2, D3) cube's redshift axis collapsed at the 0-d zr
    with the log(1+z) rule (interpolators_g.F:252-257), honoring the
    past-the-end 2-D fallback.  Returns (D1, D3)."""
    d2 = data.shape[1]
    zi = torch.clamp(zi0, 0, d2 - 2).reshape(1)
    p_lo, p_hi = par2[zi], par2[zi + 1]
    wz = torch.log((1.0 + zr) / (1.0 + p_lo)) / torch.log(
        (1.0 + p_hi) / (1.0 + p_lo))
    full = (index_pick(data, 1, zi) * (1.0 - wz)
            + index_pick(data, 1, zi + 1) * wz)
    return torch.where(end_int, data[:, d2 - 1], full)


def temperature_rows(cloudy, data, log_n_h, zr, zi0, end_int):
    """Contract every non-temperature axis of a rank 1-3 Cloudy table,
    returning per-cell temperature rows of shape (N, D_T)."""
    rank = cloudy.grid_rank
    if rank == 1:
        return data[None, :].expand(log_n_h.shape[0], data.shape[0])
    if rank == 3:
        data = collapse_redshift(data, cloudy.par2, zr, zi0, end_int)
    i1, f1 = _uniform_frac(log_n_h, cloudy.par1, data.shape[0])
    lo = data[i1]
    return lo + (data[i1 + 1] - lo) * f1[:, None]


def rows_at_temperature(rows, par_t, x_t):
    """Row-wise temperature interpolation of (N, D_T) rows at per-cell
    temperatures x_t."""
    i_t, f_t = _uniform_frac(x_t, par_t, rows.shape[1])
    lo = rows.gather(1, i_t[:, None])[:, 0]
    hi = rows.gather(1, i_t[:, None] + 1)[:, 0]
    return lo * (1.0 - f_t) + hi * f_t


def rows_at_scalar_temperature(rows, par_t, x):
    """Row interpolation at one temperature, a 0-d tensor (e.g. log10 of
    T_CMB): the two bracketing columns, weighted."""
    i, frac = _uniform_frac(x, par_t, rows.shape[1])
    i = i.reshape(1)
    return (index_pick(rows, 1, i) * (1.0 - frac)
            + index_pick(rows, 1, i + 1) * frac)


def _bisect_index(x, par, dim):
    """Bracket index of a non-uniform axis by bisection
    (INDEX_4_BISECTION, interpolators_g.F:478-496), clamped to
    [0, dim-2]."""
    return torch.clamp(
        torch.searchsorted(par, x.contiguous(), right=True) - 1, 0, dim - 2)


def interpolate_4d(x1, x2, x3, x4, par1, par2, par3, par4, data):
    """(interpolators_g.F:343-431); axis 4 indexed by bisection.  Used by
    old-style Cloudy tables."""
    d1, d2, d3, d4 = data.shape
    i1 = _uniform_index(x1, par1, d1)
    i2 = _uniform_index(x2, par2, d2)
    i3 = _uniform_index(x3, par3, d3)
    i4 = _bisect_index(x4, par4, d4)

    def v4(q, w, e):
        return _lerp(x4, par4[i4], par4[i4 + 1],
                     data[i1 + q, i2 + w, i3 + e, i4],
                     data[i1 + q, i2 + w, i3 + e, i4 + 1])

    def v3(q, w):
        return _lerp(x3, par3[i3], par3[i3 + 1], v4(q, w, 0), v4(q, w, 1))

    def v2(q):
        return _lerp(x2, par2[i2], par2[i2 + 1], v3(q, 0), v3(q, 1))

    return _lerp(x1, par1[i1], par1[i1 + 1], v2(0), v2(1))


def interpolate_5d(x1, x2, x3, x4, x5, par1, par2, par3, par4, par5, data):
    """(interpolators_g.F:436-566); axis 4 by bisection as in the
    reference."""
    d1, d2, d3, d4, d5 = data.shape
    i1 = _uniform_index(x1, par1, d1)
    i2 = _uniform_index(x2, par2, d2)
    i3 = _uniform_index(x3, par3, d3)
    i4 = _bisect_index(x4, par4, d4)
    i5 = _uniform_index(x5, par5, d5)

    def v5(q, w, e, r):
        return _lerp(x5, par5[i5], par5[i5 + 1],
                     data[i1 + q, i2 + w, i3 + e, i4 + r, i5],
                     data[i1 + q, i2 + w, i3 + e, i4 + r, i5 + 1])

    def v4(q, w, e):
        return _lerp(x4, par4[i4], par4[i4 + 1],
                     v5(q, w, e, 0), v5(q, w, e, 1))

    def v3(q, w):
        return _lerp(x3, par3[i3], par3[i3 + 1], v4(q, w, 0), v4(q, w, 1))

    def v2(q):
        return _lerp(x2, par2[i2], par2[i2 + 1], v3(q, 0), v3(q, 1))

    return _lerp(x1, par1[i1], par1[i1 + 1], v2(0), v2(1))
