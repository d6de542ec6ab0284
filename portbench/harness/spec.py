"""A cell of BENCHMARK.json resolved to its files, by name.

A cell names a configuration and a traffic mix; each metric is a reader.
Each is a file of its own under portbench/:

- ``configs/<config>.json`` (the configuration entry's ``file``);
- ``traffic/<traffic>.json``, whose ``recipe`` names
  ``recipes/<recipe>.py``;
- ``metrics/<metric>.py`` for every metric the cell reports.

So a later change adds a cell, a configuration or a metric by adding
files and entries, and edits none of these.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

#: the root of the checkout: BENCHMARK.json and portbench/ are in it
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "portbench")


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    reader: object  # the module: read(run) -> float or None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    recipe: object  # the module: states(traffic, parameters, units, rng)
    end_to_end: list
    per_layer: list


def load_module(path: str, name: str):
    """The Python file ``path`` loaded as a module named ``name``."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"portbench: no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json(path):
    if not os.path.isfile(path):
        raise FileNotFoundError(f"portbench: no file {path}")
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _metrics(entries, cell, root):
    return [Metric(m["name"], m["unit"], m["better"],
                   load_module(os.path.join(root, "portbench", "metrics",
                                            m["name"] + ".py"),
                               "portbench_metric_" + m["name"]))
            for m in entries if _reports(m, cell)]


def cell(name: str, root: str = ROOT, bench: dict = None) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its files loaded."""
    bench = bench or benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"portbench: no workload {name!r} in BENCHMARK.json")
    work = found[0]
    config = [c for c in bench["configs"] if c["name"] == work["config"]][0]
    traffic = _json(os.path.join(root, "portbench", "traffic",
                                 work["traffic"] + ".json"))
    recipe = load_module(
        os.path.join(root, "portbench", "recipes",
                     traffic["recipe"] + ".py"),
        "portbench_recipe_" + traffic["recipe"])
    return Cell(
        name=name, chips=int(work["chips"]), config_name=config["name"],
        config=_json(os.path.join(root, config["file"])),
        traffic_name=work["traffic"], traffic=traffic, recipe=recipe,
        end_to_end=_metrics(bench["end_to_end"], name, root),
        per_layer=_metrics(bench["per_layer"], name, root))
