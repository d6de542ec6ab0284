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


def redshift_index(zr: float, par2, d2):
    """Bisection index + past-the-end flag for the redshift axis of 3-D
    Cloudy tables (grackle: cool1d_cloudy_g.F:128-153).

    Returns (zi0, end_int) as 0-d tensors on par2's device: zi0 is the
    0-based lower bracket, clipped to [0, d2-3]; end_int is True when zr is
    at/past the second-to-last redshift, in which case interpolation
    collapses to 2-D at the final table slice.
    """
    z = torch.tensor([zr], dtype=par2.dtype, device=par2.device)
    zi0 = torch.clamp(
        torch.searchsorted(par2, z, right=True)[0] - 1, 0, d2 - 3
    )
    end_int = z[0] >= par2[d2 - 2]
    # reference pins zindex = D2 (1-based) in the end_int case; the 2-D
    # fallback then reads slice (zindex-1) = D2-1 (0-based last slice).
    zi0 = torch.where(end_int, torch.full_like(zi0, d2 - 1), zi0)
    return zi0, end_int


def interpolate_3dz(x1, zr: float, x3, par1, par2, par3, data, zi0,
                    end_int):
    """Non-uniform middle (redshift) axis in log(1+z), with 2-D fallback
    past the last redshift (interpolators_g.F:186-269,279-338).

    zi0/end_int come from :func:`redshift_index` (computed once per call,
    shared by all cells).
    """
    d1, d2, d3 = data.shape
    i1 = _uniform_index(x1, par1, d1)
    i3 = _uniform_index(x3, par3, d3)

    # --- full 3-D path (clamped so the end_int case stays in bounds) ---
    zi = torch.clamp(zi0, 0, d2 - 2)

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
    zlast = torch.clamp(zi0, 0, d2 - 1)

    def f3(q):
        return _lerp(x3, par3[i3], par3[i3 + 1],
                     data[i1 + q, zlast, i3], data[i1 + q, zlast, i3 + 1])

    flat = _lerp(x1, par1[i1], par1[i1 + 1], f3(0), f3(1))

    return torch.where(end_int, flat, full)
