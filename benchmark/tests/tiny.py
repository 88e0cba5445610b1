"""Cells cut to a size the CPU solves in seconds, for the CPU tests, and
the cells of ``shelved.json`` (proved once, not in ``BENCHMARK.json``)."""

import json
import os

from harness.spec import load_cell

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(BENCH, "shelved.json")) as f:
    SHELVED = json.load(f)["workloads"]


def any_cell(name: str):
    """The cell ``name`` of ``BENCHMARK.json`` or of ``shelved.json``."""
    return load_cell(name, extra=SHELVED)


def tiny(cell, **over):
    """Cut a cell to a size the CPU solves in seconds (float64 there):
    ts=8, two lanes, short budgets; no cost gate (the golden is ts=100)."""
    c = cell.config
    c["ts"] = over.pop("ts", 8)
    if "batch" in c:
        c["batch"].update(dict(lanes=2, group=2, drain=2, dive_iters=10,
                               group_cap=100, budget=100), **over)
        c["gate"]["cost_gap"] = None
    if "mission_layer" in c:
        c["mission_layer"].update(dict(ensemble=2, slice=16, leg_max_iter=96,
                                       feas_tol=1e-3, tol=1e-2), **over)
    if cell.traffic.get("airframes"):
        cell.traffic["airframes"] = cell.traffic["airframes"][:1]
    return cell
