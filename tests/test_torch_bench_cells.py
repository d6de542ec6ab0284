"""The benchmark's cells ``chem2_uvb_shield.grid1m_z3`` and
``chem3_dust.grid1m_long_dt`` rehearsed on the CPU through the harness
(portbench/harness/run_cell.run) at 256 cells a call and a 1 s window:
each comes out correct against the plain reference, and the per-layer
readers of the port's own span and counter (``scalars_ms_per_call``,
``shield_nodes_per_subcycle``) read nothing off the card and do not
raise."""

import time

import pytest
import torch

from portbench.harness import run_cell, spec

torch.set_num_threads(1)

NEW_READERS = ["scalars_ms_per_call", "shield_nodes_per_subcycle"]


@pytest.mark.parametrize("name", ["chem2_uvb_shield.grid1m_z3",
                                  "chem3_dust.grid1m_long_dt"])
def test_rehearsal(name):
    cell = spec.cell(name)
    traffic = {"cells": 256, "pool": 1,
               "check": dict(cell.traffic["check"], rows=4096)}
    result, note = run_cell.run(cell, 2**31 + 5, 1.0, True,
                                time.perf_counter(), device="cpu",
                                traffic_overrides=traffic)
    assert result["correct"], (result["checks"], note)
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert result["device"]["platform"] == "cpu"
    for metric in NEW_READERS:
        assert metric not in result["metrics"]
    readers = {m.name: m.reader for m in spec.cell(
        "chem2_uvb_shield.grid1m_z3").per_layer}
    record = run_cell.Run(cell=cell, on_card=False, setup_s=0.0,
                          window_s=1.0, calls=[], graph_calls={},
                          reserved_max_bytes=0)
    for metric in NEW_READERS:
        assert readers[metric].read(record) is None
