"""The network region's frozen byte count against a hand count, and
against the operand list of the port's launch."""

import pytest

from portbench.harness import spec
from portbench.yardstick.netbytes import bytes_per_cell


def test_hand_count_chemistry_3_with_dust():
    # in: density, energy, 12 species; 32 rates; 7 shielded rates;
    # h2dust; 6 cooling values; 6 float carries; the H2 limit: 67 f64,
    # and itmask, capped (1 B) and cell_it (4 B).  Out: energy and 12
    # species, 6 float carries: 19 f64, and the same 6 B of flags.
    assert bytes_per_cell(spec.cell("chem3_dust.grid1m").config[
        "parameters"]) == (67 + 19) * 8 + 2 * 6 == 700


def test_hand_count_tabulated():
    # in: density, energy, 6 cooling values, 6 float carries: 14 f64 and
    # 6 B of flags; out: energy and 6 float carries, 7 f64, 6 B
    assert bytes_per_cell(spec.cell("tabulated_uvb.grid1m").config[
        "parameters"]) == (14 + 7) * 8 + 2 * 6 == 180


@pytest.mark.parametrize("name", ["chem3_dust.grid1m",
                                  "tabulated_uvb.grid1m"])
def test_matches_the_ports_operand_list(name):
    import torch

    from grackle_tpu_torch.config import ChemistryConfig, resolve_config
    from grackle_tpu_torch.ops import network_kernel as nk

    params = spec.cell(name).config["parameters"]
    cfg = resolve_config(ChemistryConfig(**params))
    slots = nk.input_slots(cfg)
    read = sum(torch.empty(0, dtype=nk.slot_dtype(j, torch.float64))
               .element_size() for j in slots)
    species = nk.SPECIES_SLOTS[:(0, 6, 9, 12)[cfg.primordial_chemistry]]
    carry = [n for n in nk.CARRY_SLOTS if cfg.compensated_sums == 1
             or n not in nk.COMPENSATED_SLOTS]
    written = 8 * (1 + len(species)) + sum(
        torch.empty(0, dtype=nk.FLAG_DTYPES.get(n, torch.float64))
        .element_size() for n in carry)
    assert bytes_per_cell(params) == read + written
