"""The bytes the network region needs a cell a subcycle, frozen.

The region (grackle_tpu_torch/csrc/network_update.cu, one launch a
subcycle) reads each of its operands once and writes each of its results
once for every cell it advances.  The operand list is that of the port's
``ops/network_kernel.input_slots`` at commit 4d9fd799c427, counted here
from the configuration's parameters, so that the count stays what the
cells need whatever implements the region:

- fields: density, energy and the species of the chemistry level
  (0, 6, 9 or 12), plus the radiative-transfer rates where used;
- rate coefficients: 0, 8, 25 or 32 of the k1-k58 group by level;
  shielded photo rates: 0, 3, 7 or 7; the H2-on-dust rate where dust
  and level > 1;
- the cooling values: edot, tgas, p2d, rhoH, tgasold, tdust;
- the loop carry: ttot, tgasold, tdust, dedot_prev, HIdot_prev,
  dtit_prev (floats), itmask and capped (one byte), cell_it (int32),
  and energy_lo, ttot_lo with compensated sums;
- the H2 equilibrium limit where level > 1.

Written: energy and the species, and the carry again.  The few scalars
a launch reads (dt, dom, chunit, k27) are left out: they are not per
cell.
"""

from __future__ import annotations

_SPECIES = (0, 6, 9, 12)
_RATES = (0, 8, 25, 32)
_SHIELDS = (0, 3, 7, 7)
_COOL = 6
_CARRY_FLOATS = 6
_CARRY_FLAG_BYTES = 1 + 1 + 4
_COMPENSATED = 2


def bytes_per_cell(parameters: dict) -> int:
    """Bytes one cell's network update reads and writes, for a
    configuration given by its grackle parameters."""
    level = int(parameters.get("primordial_chemistry", 0))
    size = 4 if int(parameters.get("precision", 64)) == 32 else 8
    dust = (int(parameters.get("h2_on_dust", 0)) > 0
            or int(parameters.get("dust_chemistry", 0)) > 0)
    compensated = int(parameters.get("compensated_sums", 0)) == 1
    rt = (int(parameters.get("use_radiative_transfer", 0)) == 1
          and level > 0)
    rt_fields = (1 if int(parameters.get(
        "radiative_transfer_hydrogen_only", 0)) else 3) if rt else 0
    fields = 2 + _SPECIES[level] + rt_fields
    carry = _CARRY_FLOATS + (_COMPENSATED if compensated else 0)
    floats_in = (fields + _RATES[level] + _SHIELDS[level]
                 + (1 if dust and level > 1 else 0) + _COOL + carry
                 + (1 if level > 1 else 0))
    floats_out = 1 + _SPECIES[level] + carry
    return (floats_in + floats_out) * size + 2 * _CARRY_FLAG_BYTES
