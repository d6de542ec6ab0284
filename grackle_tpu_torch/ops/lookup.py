"""Log-temperature table lookup (port of grackle_tpu/ops/lookup.py,
gather path).

The reference performs a per-cell linear lookup in log(T) for every rate
table (grackle: src/clib/solve_rate_cool_g.F:1206-1323 and
src/clib/cool1d_multi_g.F:348-410).  The index/fraction pair is computed
once per cell and every table evaluation is a gather + lerp.  The JAX
package's two-hot/one-hot matmul lookups exist because a TPU cannot gather
inside a device loop; a GPU can, so only the gather form is ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class TableIndex:
    """Per-cell interpolation state: 0-based bin index (int64), fraction
    within the bin, and the bracketing log-temperatures (float64 whatever
    the solver dtype; solve_rate_cool_g.F:1217-1221)."""

    idx: Any
    tdef: Any
    t1: Any
    t2: Any
    logtem: Any


def table_index(logtem, n_bins: int, t_start: float, t_end: float):
    """Compute clamped index + interpolation fraction for a log-spaced
    temperature table (solve_rate_cool_g.F:1202-1221)."""
    dtype = logtem.dtype
    logtem0 = math.log(t_start)
    logtem9 = math.log(t_end)
    dlogtem = (logtem9 - logtem0) / (n_bins - 1)
    logtem = torch.clamp(logtem, logtem0, logtem9)
    # reference: min(nratec-1, max(1, int(...)+1)) in 1-based indexing
    idx = torch.clamp(
        ((logtem - logtem0) / dlogtem).to(torch.int64), 0, n_bins - 2
    )
    # bin edges stay float64, as JAX's weakly typed float64 values do:
    # they round to the solver dtype only where they meet a solver-dtype
    # tensor, so the bin width t2 - t1 rounds once, after the subtraction
    idx64 = idx.to(torch.float64)
    t1 = logtem0 + idx64 * dlogtem
    t2 = logtem0 + (idx64 + 1.0) * dlogtem
    tdef = (logtem - t1.to(dtype)) / (t2 - t1).to(dtype)
    return TableIndex(idx=idx, tdef=tdef, t1=t1, t2=t2, logtem=logtem)


def lookup(table, ti: TableIndex):
    """Linear interpolation of a 1-D table at the cell indices."""
    lo = table[ti.idx]
    return lo + (table[ti.idx + 1] - lo) * ti.tdef


def lookup_many(tables, ti: TableIndex):
    """Lookup a sequence of same-shaped tables at shared indices, as one
    gather from the stacked (n_tables, n_bins) matrix."""
    stacked = torch.stack(list(tables), dim=0)
    lo = stacked[:, ti.idx]
    hi = stacked[:, ti.idx + 1]
    out = lo + (hi - lo) * ti.tdef[None, :]
    return tuple(out[i] for i in range(len(tables)))


class TableLookup:
    """Per-iteration table access at one TableIndex: ``lk[name]`` is the
    gather + lerp of ``tables.<name>``."""

    def __init__(self, tables, ti: TableIndex):
        self._tables = tables
        self._ti = ti

    def __getitem__(self, name: str):
        return lookup(getattr(self._tables, name), self._ti)

    def k13dd_matrix(self):
        """(N, 14) density-dependent k13 coefficients."""
        lo = self._tables.k13dd[self._ti.idx, :]
        hi = self._tables.k13dd[self._ti.idx + 1, :]
        return lo + (hi - lo) * self._ti.tdef[:, None]


def h2dust_lookup(h2dust_table, ti: TableIndex, d_ti: TableIndex):
    """Bilinear (T_gas, T_dust) interpolation of the 2-D h2dust table
    (solve_rate_cool_g.F:1327-1378)."""
    t00 = h2dust_table[ti.idx, d_ti.idx]
    t10 = h2dust_table[ti.idx + 1, d_ti.idx]
    t01 = h2dust_table[ti.idx, d_ti.idx + 1]
    t11 = h2dust_table[ti.idx + 1, d_ti.idx + 1]
    dusti1 = t00 + (t10 - t00) * ti.tdef
    dusti2 = t01 + (t11 - t01) * ti.tdef
    return dusti1 + (dusti2 - dusti1) * d_ti.tdef
