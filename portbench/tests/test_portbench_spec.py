"""BENCHMARK.json resolves, by name, to the benchmark's own files, and
keeps to the shape the benchmark's contract gives it."""

import json
import os
import re

import pytest

from portbench.harness import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(name):
    cell = spec.cell(name)
    assert cell.config["parameters"]["precision"] in (32, 64)
    assert callable(cell.recipe.states)
    assert cell.traffic["cells"] >= 1 and cell.traffic["pool"] >= 1
    reported = [m.name for m in cell.end_to_end]
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for metric in cell.end_to_end + cell.per_layer:
        assert callable(metric.reader.read)
    for metric in BENCH["per_layer"]:
        if "workloads" not in metric or name in metric["workloads"]:
            assert metric["moves"] in reported


def test_names_units_and_bounds():
    names = [w["name"] for w in BENCH["workloads"]] + \
        [c["name"] for c in BENCH["configs"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], m["layer"])
    assert all("\n" not in layer and len(layer) <= 200 for layer in layers)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_config_is_used_and_files_stand_alone():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        with open(os.path.join(spec.ROOT, c["file"])) as fh:
            config = json.load(fh)
        assert config["reduced"] == c["reduced"]
        assert config["source"] == c["source"]
        assert set(config["checks"]) == {"max_rel_err"}


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no_such.cell")
