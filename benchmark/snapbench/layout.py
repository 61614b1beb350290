"""Where the benchmark's files are, and how a cell's name resolves to
them. Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own, found by its name:

  BENCHMARK.json                      the cells and metrics (repo root)
  benchmark/configs/<config>.json     a genome deployment
  benchmark/traffic/<traffic>.json    a traffic mix
  benchmark/limits/<cell>.json        the cell's limits for `correct`
  benchmark/metrics/<metric>.py       a per-layer metric's reader
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
CACHE_DIR = os.path.join(BENCH_DIR, ".cache")


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its files; raises
    KeyError for a cell the file does not list."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    bdir = os.path.join(root, "benchmark")
    return Cell(
        name=name,
        config=_load_json(os.path.join(bdir, "configs", w["config"] + ".json")),
        traffic=_load_json(os.path.join(bdir, "traffic", w["traffic"] + ".json")),
        limits=_load_json(os.path.join(bdir, "limits", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def metric_reader(name: str, root: str = ROOT):
    """The `read(record)` function of benchmark/metrics/<name>.py."""
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("snapbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
