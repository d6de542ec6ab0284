"""The rate lookup's per-layer metric, ``rates_nodes_per_subcycle``:
listed for the four cells with a species network and no other; None off
the card and on a port without the counter; and, on the card, a traced
run of ``chem3_dust.blocks4k`` reads one node (marked ``card``)."""

import json
import os
import subprocess
import sys
import types

import pytest

from portbench.harness import spec

NAME = "rates_nodes_per_subcycle"
RUN = os.path.join(spec.HERE, "run.py")


def _reader():
    return spec.load_module(os.path.join(spec.HERE, "metrics", NAME + ".py"),
                            "portbench_metric_" + NAME)


def test_listed_for_the_network_cells():
    bench = spec.benchmark()
    entry = [m for m in bench["per_layer"] if m["name"] == NAME][0]
    configs = {c["name"]: c["file"] for c in bench["configs"]}
    network = []
    for work in bench["workloads"]:
        with open(os.path.join(spec.ROOT, configs[work["config"]])) as fh:
            params = json.load(fh)["parameters"]
        if params.get("primordial_chemistry", 0) > 0:
            network.append(work["name"])
    assert len(network) == 4 and sorted(entry["workloads"]) == sorted(network)
    assert entry["source"] == "program_counter"
    assert entry["moves"] == "cells_per_s"
    for work in bench["workloads"]:
        names = [m.name for m in spec.cell(work["name"]).per_layer]
        assert (NAME in names) == (work["name"] in network)


def test_none_off_the_card_and_without_the_counter(monkeypatch):
    from grackle_tpu_torch import tracing

    read = _reader().read
    assert read(types.SimpleNamespace(on_card=False)) is None
    on_card = types.SimpleNamespace(on_card=True)
    monkeypatch.setattr(tracing, "rates_nodes", None)
    assert read(on_card) is None
    monkeypatch.setattr(tracing, "rates_nodes", 1)
    assert read(on_card) == 1
    # a port from before the counter
    monkeypatch.delattr(tracing, "rates_nodes_per_subcycle")
    assert read(on_card) is None


@pytest.mark.card
def test_traced_run_reads_the_rate_nodes(card):
    out = subprocess.run(
        [sys.executable, RUN, "--workload", "chem3_dust.blocks4k",
         "--seed", str(2**31 + 31), "--seconds", "2", "--trace", "1"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0
    assert result["metrics"][NAME]["value"] == 1
