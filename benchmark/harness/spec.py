"""What a run needs to know, found by name from ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  Each has a file of its own under the benchmark's folder (the first
of ``paths``):

- ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives): the
  deployment, its sizes, its gate, and the plain reference that judges it;
- ``traffic/<traffic>.json``: the mix's parameters; its ``request_s``,
  the seconds one request is planned to take, fixes how many requests a
  window of ``--seconds`` sends (``run.requests_for``); its ``kind`` names
  the request type, ``kinds/<kind>.py``, which builds the system, draws
  and runs the requests from the mix's parameters and the seed, and
  judges the answers (a ``System`` class and a ``judge`` function);
- ``checks/<workload>.json``: the limit of each number the comparison
  reports for the cell;
- ``metrics/<metric>.py``: one reader per metric, end to end and per layer.

So a later change adds a cell, a mix or a metric as new files and new
entries, and edits none that are there.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@dataclass
class Cell:
    name: str
    chips: int
    bench: str            # the benchmark's folder
    config_name: str
    config: dict
    traffic: dict
    checks: dict
    end_to_end: list = field(default_factory=list)   # metric entries
    per_layer: list = field(default_factory=list)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT, extra=()) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``, or of the workload
    entries ``extra``, with its files."""
    spec = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in [*spec["workloads"], *extra]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[name]
    cfg_entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    bench = os.path.join(root, spec["paths"][0])
    return Cell(
        name=name, chips=int(w["chips"]), bench=bench,
        config_name=w["config"],
        config=_load_json(os.path.join(root, cfg_entry["file"])),
        traffic=_load_json(os.path.join(bench, "traffic", w["traffic"] + ".json")),
        checks=_load_json(os.path.join(bench, "checks", name + ".json")),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)])


def load_module(path: str, name: str):
    """A module by its file path (metric readers have dots in their names,
    so they are not importable by name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(cell: Cell, metric: str):
    """The ``read(record) -> float | None`` of ``metrics/<metric>.py``."""
    return load_module(os.path.join(cell.bench, "metrics", metric + ".py"),
                       "bench_metric_" + metric.replace(".", "_")).read


def kind(cell: Cell):
    """The request kind of the cell's mix: ``kinds/<kind>.py``."""
    name = cell.traffic["kind"]
    return load_module(os.path.join(cell.bench, "kinds", name + ".py"),
                       "bench_kind_" + name)


def reference(cell: Cell):
    """The configuration's plain reference module (its ``reference``
    path, relative to the benchmark's folder)."""
    return load_module(os.path.join(cell.bench, cell.config["reference"]),
                       "bench_reference_" + cell.config_name)
