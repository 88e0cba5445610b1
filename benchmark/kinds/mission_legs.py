"""Request kind ``mission_legs``: one operator flying legs back to back
through the mission layer.

Set-up flies a cold leg to ``cold_goal`` (it captures the leg program and
fills the warm cache that every following leg starts from).  Each request
is one leg to a goal at bearing ``bearing_deg +- bearing_jitter_deg`` and
range ``range_m * (1 +- range_jitter)``, from a cycle of ``cycle`` goals
spread evenly over that square and entered at a goal drawn from
``default_rng(seed)`` (:func:`cycle_legs`), stitched to the previous leg's
last node and warm-started by the mission layer.

A configuration whose ``wind`` has a ``grid`` flies the mission layer
through a TOLWGRID file that the system owns and the mission layer
re-reads before every leg.  The kind writes the field there, in plain
numpy (:func:`write_grid`), from the reference's ``demo_field`` with the
grid's ``args``: before the cold leg, and with the optional mix key
``field_feed: {"arg": a, "radius_m": R}`` before every leg too, inside
the request (the upstream's storm database is queried inside its leg):
the leg to goal ``k`` of the cycle flies field ``k``, whose 2-vector
argument ``a`` (the configuration's, or ``demo_field``'s default) is
moved ``R (cos 2 pi k / cycle, sin 2 pi k / cycle)`` (:func:`field_args`),
so every seed's window flies the same pairs of goal and field.  A fed
request records ``field`` and ``field_args``; the
judge builds each leg's reference in that leg's field, with v alone live
as the TOLWGRID reader has it.
"""

from __future__ import annotations

import inspect
import math
import os
import time

import numpy as np

from harness.spec import load_module

NODE_STATE = ("Va", "gam", "chi", "phi", "CL", "dphi", "dCL", "T")


def _seed(seed: int) -> int:
    return int(seed) % (1 << 64)


def first_goal(seed: int, tr: dict) -> int:
    """The goal of the cycle that a seed's window flies first."""
    return int(np.random.default_rng(_seed(seed)).integers(tr["cycle"]))


def cycle_legs(seed: int, tr: dict):
    """The stream of ``(k, goal)``: goal ``k`` ``(xg, yg, zg, rg)`` of a
    cycle of ``cycle`` goals spread evenly over the jitter square (the
    two-dimensional additive recurrence of the plastic number, ``R2``),
    flown round and round from :func:`first_goal`."""
    g = 1.32471795724474602596
    n = tr["cycle"]
    goals = []
    for k in range(n):
        u, v = (0.5 + k / g) % 1.0, (0.5 + k / (g * g)) % 1.0
        ang = math.radians(tr["bearing_deg"]
                           + tr["bearing_jitter_deg"] * (2.0 * u - 1.0))
        r = tr["range_m"] * (1.0 + tr["range_jitter"] * (2.0 * v - 1.0))
        goals.append((r * math.cos(ang), r * math.sin(ang), 0.0, 0.0))
    k = first_goal(seed, tr)
    while True:
        yield k, goals[k]
        k = (k + 1) % n


def _storm(bench: str):
    return load_module(os.path.join(bench, "reference", "storm.py"),
                       "bench_reference_storm_feed")


def field_args(storm, grid: dict, feed: dict, j: int, n: int) -> dict:
    """Field ``j``'s ``demo_field`` arguments, of ``n`` round the circle:
    the grid's ``args`` with the 2-vector ``feed["arg"]`` moved
    ``radius_m (cos 2 pi j / n, sin 2 pi j / n)``."""
    args = dict(grid.get("args", {}))
    name = feed["arg"]
    base = args.get(name, inspect.signature(storm.demo_field).parameters[name].default)
    ang = 2.0 * math.pi * j / n
    r = feed["radius_m"]
    args[name] = [float(base[0]) + r * math.cos(ang), float(base[1]) + r * math.sin(ang)]
    return args


def write_grid(path: str, f: dict) -> None:
    """A field (``demo_field``'s dict) as a TOLWGRID file: magic, uint32
    version 1, nx, ny, nz, float64 origin and spacing, float32 u, v, w."""
    with open(path, "wb") as out:
        out.write(b"TOLWGRID")
        out.write(np.array([1, *f["u"].shape], dtype=np.uint32).tobytes())
        out.write(np.asarray(f["origin"], np.float64).tobytes())
        out.write(np.asarray(f["spacing"], np.float64).tobytes())
        for c in ("u", "v", "w"):
            out.write(np.ascontiguousarray(f[c], np.float32).tobytes())


class System:
    def __init__(self, cell, device):
        from harness.program import LegSystem

        self.cfg, self.tr = cell.config, cell.traffic
        self.sys = LegSystem(cell.config, device)
        self.grid = cell.config["wind"].get("grid")
        self.feed = self.tr.get("field_feed")
        if self.grid is not None:
            self.storm = _storm(cell.bench)
            if self.grid["builder"] != self.storm.DEMO_BUILDER:
                raise NotImplementedError(f"grid {self.grid}: the feed writes "
                                          f"the demo field alone")
        elif self.feed is not None:
            raise ValueError("field_feed needs a wind with a grid")
        self.prev = None          # the last leg's document
        self.goals = None

    def warm_up(self) -> dict:
        t0 = time.perf_counter()
        if self.grid is not None:
            self._write(self.grid.get("args", {}))
        self._leg(tuple(self.tr["cold_goal"]), None)
        return dict(cold_leg_s=time.perf_counter() - t0)

    def record(self) -> dict:
        return {}

    def _write(self, args: dict) -> None:
        write_grid(self.sys.grid_path, self.storm.demo_field(**args))

    def _leg(self, goal, stitch, field=None) -> dict:
        t0 = time.perf_counter()
        fed = {}
        if field is not None:
            fed = dict(field=field, field_args=field_args(
                self.storm, self.grid, self.feed, field, self.tr["cycle"]))
            self._write(fed["field_args"])
        before = self.sys.replays()
        doc = self.sys.leg(goal, stitch)
        ms = 1e3 * (time.perf_counter() - t0)
        after = self.sys.replays()
        replays = None if before is None or after is None else after - before
        tr = doc["trajectory"]
        self.prev = doc
        return dict(
            ms=ms, goal=list(goal), stitch=stitch,
            iterations=int(doc["iterations"]), converged=bool(doc["converged"]),
            used_warm=bool(doc.get("used_warm")), lanes=1,
            replays=replays,
            gated=int(bool(doc["converged"])), failed=int(not doc["converged"]),
            answers=dict(Z=np.array([tr[k] for k in ("x", "y", "z") + NODE_STATE]).T,
                         dt=float(doc["dt"]), F=float(doc["FinalCost"]),
                         converged=bool(doc["converged"])), **fed)

    def request(self, seed: int, k: int) -> dict:
        if self.goals is None:
            self.goals = cycle_legs(seed, self.tr)
        tr = self.prev["trajectory"]
        stitch = tuple(float(tr[key][-1]) for key in NODE_STATE)
        j, goal = next(self.goals)
        return self._leg(goal, stitch, None if self.feed is None else j)

    def slice_stages(self, steps: int) -> dict:
        """The traced slice: ``steps`` replays of each captured leg
        program (a whole leg is 48 or more; two whole legs under the
        profiler take minutes to reduce)."""
        return {f"leg{i}": ((lambda run=run: [run() for _ in range(steps)]), steps)
                for i, run in enumerate(self.sys.captured_runs())}


def leg_wind(cfg: dict, leg: dict):
    """The wind a leg flew: the configuration's; with a grid, the leg's
    field (its ``field_args``, else the grid's own) with v alone live, as
    the mission layer reads a TOLWGRID file."""
    wind = cfg.get("wind")
    if wind is None or "grid" not in wind:
        return wind
    grid = {**wind["grid"], "args": leg.get("field_args", wind["grid"].get("args", {}))}
    return {**wind, "grid": grid, "live": [0.0, 1.0, 0.0]}


def judge(cell, ref, legs, record, device="cpu") -> dict:
    """The comparison's numbers for a window of legs (``check``)."""
    cfg = cell.config
    ml, ts, wind = cfg["mission_layer"], cfg["ts"], cfg.get("wind")
    sc = ref.Scaling(ref.Problem(cfg["mission"], cfg["aircraft"], ts=ts, wind=wind))
    viol_ratio = cost_err = kkt = 0.0
    for leg in legs:
        a = leg["answers"]
        prob = ref.Problem(cfg["mission"], cfg["aircraft"], goal=leg["goal"],
                           stitch=leg["stitch"], ts=ts, wind=leg_wind(cfg, leg))
        J = ref.judge_physical(prob, sc, a["Z"], a["dt"])
        F = float(J["F"])
        cost_err = max(cost_err, abs(a["F"] - F) / max(abs(F), 1e-12))
        if a["converged"]:
            viol_ratio = max(viol_ratio, float(J["viol"]) / ml["feas_tol"])
            kkt = max(kkt, ref.certificate_physical(prob, sc, a["Z"], a["dt"], device))
    unanswered = sum(not leg["answers"]["converged"] for leg in legs)
    return dict(unanswered=unanswered / max(len(legs), 1),
                viol_ratio=viol_ratio, cost_err=cost_err,
                kkt_ratio=kkt / cfg["gate"]["kkt_tol"])
