"""grackle_tpu_torch/tracing.py on the CPU: the ``call_scalars`` span's
record stays bounded and its median ignores a few outliers, a stateful
call adds one entry to it, and the shielding counter counts nothing off
a capture."""

import numpy as np
import torch

from grackle_tpu_torch import tracing
from grackle_tpu_torch.api import ChemistryData

torch.set_num_threads(1)


def test_span_record_is_bounded():
    span = tracing.Span(size=4)
    for j in range(10):
        span.add(float(j))
    assert list(span.record) == [6.0, 7.0, 8.0, 9.0]
    assert tracing.Span().record.maxlen == tracing.RECORD_CALLS


def test_median_ignores_two_outliers():
    span = tracing.Span()
    assert span.median() is None
    # a key's eager and capturing calls take far longer than its replays
    for seconds in [2.5, 0.9] + [1e-4] * 8:
        span.add(seconds)
    assert span.median() == 1e-4


def _chemistry():
    cd = ChemistryData()
    cd.use_grackle = 1
    cd.with_radiative_cooling = 1
    cd.primordial_chemistry = 1
    cd.comoving_coordinates = 0
    cd.density_units = 1.67262171e-24
    cd.length_units = 3.0857e21
    cd.time_units = 3.1556952e13
    cd.a_units = 1.0
    cd.a_value = 1.0
    cd.initialize(device="cpu")
    return cd


def _fields(n=8):
    d = np.logspace(-1, 2, n)
    fields = {"density": d, "HI": 0.76 * d, "HII": 1e-4 * d,
              "HeI": 0.24 * d, "HeII": np.full(n, 1e-20),
              "HeIII": np.full(n, 1e-20), "energy": np.full(n, 1e3)}
    fields["de"] = fields["HII"].copy()
    return fields


def test_a_stateful_call_adds_one_record():
    cd = _chemistry()
    fields = _fields()
    before = len(tracing.call_scalars.record)
    cd.solve_chemistry(dict(fields), 1e-4)
    assert len(tracing.call_scalars.record) == before + 1
    assert 0.0 < tracing.call_scalars.record[-1] < 10.0


def test_shield_block_counts_nothing_off_a_capture(monkeypatch):
    monkeypatch.setattr(tracing, "shield_nodes", {})
    with tracing.shield_block("rahmati", torch.zeros(4)):
        torch.zeros(4) + 1.0
    assert tracing.shield_nodes == {}
    assert tracing.shield_nodes_per_subcycle() is None
    monkeypatch.setattr(tracing, "shield_nodes",
                        {"rahmati": 40, "h2": 20, "photo_heating": 12})
    assert tracing.shield_nodes_per_subcycle() == 72


def test_dust_block_counts_nothing_off_a_capture(monkeypatch):
    monkeypatch.setattr(tracing, "dust_nodes", None)
    with tracing.dust_block(torch.zeros(4)):
        torch.zeros(4) + 1.0
    assert tracing.dust_nodes is None
    assert tracing.dust_nodes_per_subcycle() is None
    monkeypatch.setattr(tracing, "dust_nodes", 1)
    assert tracing.dust_nodes_per_subcycle() == 1


def test_rates_block_counts_nothing_off_a_capture(monkeypatch):
    monkeypatch.setattr(tracing, "rates_nodes", None)
    with tracing.rates_block(torch.zeros(4)):
        torch.zeros(4) + 1.0
    assert tracing.rates_nodes is None
    assert tracing.rates_nodes_per_subcycle() is None
    monkeypatch.setattr(tracing, "rates_nodes", 1)
    assert tracing.rates_nodes_per_subcycle() == 1
