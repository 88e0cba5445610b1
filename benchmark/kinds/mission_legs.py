"""Request kind ``mission_legs``: one operator flying legs back to back
through the mission layer.

Set-up flies a cold leg to ``cold_goal`` (it captures the leg program and
fills the warm cache that every following leg starts from).  Each request
is one leg to a goal at bearing ``bearing_deg +- bearing_jitter_deg`` and
range ``range_m * (1 +- range_jitter)``, from a cycle of ``cycle`` goals
spread evenly over that square and entered at a goal drawn from
``default_rng(seed)`` (:func:`leg_goals`), stitched to the previous leg's
last node and warm-started by the mission layer.
"""

from __future__ import annotations

import math
import time

import numpy as np

NODE_STATE = ("Va", "gam", "chi", "phi", "CL", "dphi", "dCL", "T")


def _seed(seed: int) -> int:
    return int(seed) % (1 << 64)


def leg_goals(seed: int, tr: dict):
    """The stream of leg goals ``(xg, yg, zg, rg)`` of a mission mix.

    A cycle of ``cycle`` goals spread evenly over the jitter square (the
    two-dimensional additive recurrence of the plastic number, ``R2``),
    flown round and round from a starting goal drawn from
    ``default_rng(seed)``: every seed's window flies the same goals, in the
    same turns from one to the next, from another start."""
    g = 1.32471795724474602596
    n = tr["cycle"]
    goals = []
    for k in range(n):
        u, v = (0.5 + k / g) % 1.0, (0.5 + k / (g * g)) % 1.0
        ang = math.radians(tr["bearing_deg"]
                           + tr["bearing_jitter_deg"] * (2.0 * u - 1.0))
        r = tr["range_m"] * (1.0 + tr["range_jitter"] * (2.0 * v - 1.0))
        goals.append((r * math.cos(ang), r * math.sin(ang), 0.0, 0.0))
    k = int(np.random.default_rng(_seed(seed)).integers(n))
    while True:
        yield goals[k % n]
        k += 1


class System:
    def __init__(self, cell, device):
        from harness.program import LegSystem

        self.cfg, self.tr = cell.config, cell.traffic
        self.sys = LegSystem(cell.config, device)
        self.prev = None          # the last leg's document
        self.goals = None

    def warm_up(self) -> dict:
        t0 = time.perf_counter()
        self._leg(tuple(self.tr["cold_goal"]), None)
        return dict(cold_leg_s=time.perf_counter() - t0)

    def record(self) -> dict:
        return {}

    def _leg(self, goal, stitch) -> dict:
        t0 = time.perf_counter()
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
                         converged=bool(doc["converged"])))

    def request(self, seed: int, k: int) -> dict:
        if self.goals is None:
            self.goals = leg_goals(seed, self.tr)
        tr = self.prev["trajectory"]
        stitch = tuple(float(tr[key][-1]) for key in NODE_STATE)
        return self._leg(next(self.goals), stitch)

    def slice_stages(self, steps: int) -> dict:
        """The traced slice: ``steps`` replays of each captured leg
        program (a whole leg is 48 or more; two whole legs under the
        profiler take minutes to reduce)."""
        return {f"leg{i}": ((lambda run=run: [run() for _ in range(steps)]), steps)
                for i, run in enumerate(self.sys.captured_runs())}


def judge(cell, ref, legs, record, device="cpu") -> dict:
    """The comparison's numbers for a window of legs (``check``)."""
    cfg = cell.config
    ml, ts, wind = cfg["mission_layer"], cfg["ts"], cfg.get("wind")
    sc = ref.Scaling(ref.Problem(cfg["mission"], cfg["aircraft"], ts=ts, wind=wind))
    viol_ratio = cost_err = kkt = 0.0
    for leg in legs:
        a = leg["answers"]
        prob = ref.Problem(cfg["mission"], cfg["aircraft"], goal=leg["goal"],
                           stitch=leg["stitch"], ts=ts, wind=wind)
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
