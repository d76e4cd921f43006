"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: the ``file`` of its entry in ``configs``;
- a traffic mix: ``benchmark/traffic/<traffic>.json``, whose ``driver`` names
  ``benchmark/drivers/<driver>.py``;
- a cell's correctness limits: ``benchmark/limits/<cell>.json``;
- a per-layer metric's reader: ``benchmark/metrics/<metric>.py``, whose
  ``read(view)`` returns the value, or None where it finds nothing to read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from dataclasses import dataclass

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class CellSpec:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_spec(manifest: dict, name: str, root: str = ROOT) -> CellSpec:
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {', '.join(cells)})")
    cell = cells[name]
    config = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    return CellSpec(
        name=name, chips=int(cell["chips"]), config_name=config["name"],
        config=_json(os.path.join(root, config["file"])), traffic_name=cell["traffic"],
        traffic=_json(os.path.join(root, "benchmark", "traffic", f"{cell['traffic']}.json")),
        limits=_json(os.path.join(root, "benchmark", "limits", f"{name}.json")),
        end_to_end=[m for m in manifest["end_to_end"] if applies(m, name)],
        per_layer=[m for m in manifest["per_layer"] if applies(m, name)])


def driver(name: str):
    if not re.match(r"^[A-Za-z_][A-Za-z0-9_]*$", name):
        raise ValueError(f"bad driver name {name!r}")
    return importlib.import_module(f"benchmark.drivers.{name}")


def metric_reader(name: str, root: str = ROOT):
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("benchmark.metrics." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
