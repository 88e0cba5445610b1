"""Request kind ``grouped_batch``: one request is a whole batch of the
configuration's ``batch.lanes`` lanes through the grouped solver.

Mix parameters: ``noise_std`` (lane noise ``noise_std * N(0, 1)``, float64
draws cast to float32, from ``default_rng([seed, k])`` for batch ``k``),
``warm_iters`` (the warm-up's iterations of each program) and, optional,
``airframes``: the lanes split into equal airframe blocks, each group's
Instance refilled.

The gate is the configuration's (:func:`gate`): converged, the scaled
violation under ``feas``, and, on the lanes of the golden's airframe, the
cost gap to the golden under ``cost_gap``.
"""

from __future__ import annotations

import os
import time

import numpy as np

from harness import check


def _seed(seed: int) -> int:
    return int(seed) % (1 << 64)


def batch_noise(seed: int, k: int, lanes: int, n: int, std: float) -> np.ndarray:
    """Batch ``k``'s lane noise: ``std * N(0, 1)`` drawn in float64 from
    ``default_rng([seed, k])``, as float32."""
    x = np.random.default_rng([_seed(seed), k]).standard_normal((lanes, n))
    return (std * x).astype(np.float32)


def gate(cfg: dict, airframe, converged, viol, f, f_star) -> np.ndarray:
    """The configuration's gate per lane, from the claims (program's or
    worked out again): converged, violation under ``feas``, and the
    one-sided relative cost gap to the golden under ``cost_gap`` on the
    lanes of ``golden_airframe`` (``f_star``: the golden's cost on the
    same scale as ``f``; None where the gate has no cost side)."""
    g = cfg["gate"]
    ok = np.asarray(converged, bool) & (np.asarray(viol) < g["feas"])
    if f_star is not None:
        gap = (np.asarray(f, np.float64) - f_star) / max(abs(f_star), 1e-9)
        own = np.asarray(airframe) == g.get("golden_airframe", cfg["aircraft"])
        ok = ok & (~own | (gap < g["cost_gap"]))
    return ok


class System:
    def __init__(self, cell, device):
        from harness.program import BatchSystem

        cfg, tr = cell.config, cell.traffic
        self.cfg, self.tr = cfg, tr
        lanes = cfg["batch"]["lanes"]
        names = tr.get("airframes") or [cfg["aircraft"]]
        per = lanes // len(names)
        if per * len(names) != lanes or per % cfg["batch"]["group"]:
            raise ValueError("airframe blocks must fill whole groups")
        self.lane_airframe = [names[i // per] for i in range(lanes)]
        self.sys = BatchSystem(cfg, device, airframes=names)
        g = cfg["gate"]
        self.f_star = (self.sys.golden_f(os.path.join(cell.bench, g["golden"]))
                       if g.get("cost_gap") is not None else None)

    def warm_up(self) -> dict:
        return self.sys.warm_up(self.tr["warm_iters"])

    def record(self) -> dict:
        return dict(n=self.sys.can.n, f_star=self.f_star)

    def request(self, seed: int, k: int) -> dict:
        t0 = time.perf_counter()
        noise = batch_noise(seed, k, len(self.lane_airframe), self.sys.can.n,
                            self.tr["noise_std"])
        v0s = self.sys.seeds(self.lane_airframe, noise)
        captures = self.sys.captures()
        res = self.sys.run(self.lane_airframe, v0s)
        wall = time.perf_counter() - t0
        ok = gate(self.cfg, self.lane_airframe, res.converged, res.constr_viol,
                  res.f, self.f_star)
        groups = len(self.lane_airframe) // self.sys.group
        return dict(
            wall_s=wall, lanes=len(ok), gated=int(ok.sum()),
            failed=int((~ok).sum()), group_iters=int(res.group_iters),
            drain_iters=int(res.drain_iters), groups=groups,
            dive_steps=groups * self.sys.n1,
            captured=self.sys.captures() - captures,
            answers=dict(v=res.v, f=res.f, viol=res.constr_viol,
                         converged=res.converged, gated=ok,
                         airframe=list(self.lane_airframe)))

    def slice_stages(self, steps: int) -> dict:
        """The traced slice: ``steps`` steps of each stage program."""
        return {k: (run, steps) for k, run in self.sys.stage_runs(steps).items()}


def judge(cell, ref, requests, record, device="cpu") -> dict:
    """The comparison's numbers for a window of batches (``check``)."""
    cfg, gate_ = cell.config, cell.config["gate"]
    ts, feas = cfg["ts"], gate_["feas"]
    names = sorted({a for r in requests for a in r["answers"]["airframe"]})
    wind = cfg.get("wind")
    probs = {a: ref.Problem(cfg["mission"], a, ts=ts, wind=wind) for a in names}
    sc = ref.Scaling(ref.Problem(cfg["mission"], cfg["aircraft"], ts=ts, wind=wind))
    lanes = answered = 0
    viol_err = cost_err = kkt = 0.0
    f_star_prog = record.get("f_star")
    if f_star_prog is not None:
        own = gate_.get("golden_airframe", cfg["aircraft"])
        F_star = ref.golden_cost(ref.Problem(cfg["mission"], own, ts=ts, wind=wind),
                                 os.path.join(cell.bench, gate_["golden"]))
        f_star = sc.s_f * F_star
        cost_err = abs(f_star_prog - f_star) / max(abs(f_star), 1e-12)
    for r in requests:
        a = r["answers"]
        v = np.asarray(a["v"])
        lanes += len(v)
        gated = np.asarray(a["gated"])
        answered += int((gated & check.first_of_equal_rows(v)).sum())
        air = np.asarray(a["airframe"])
        for name, prob in probs.items():
            idx = np.flatnonzero((air == name) & np.isfinite(v).all(1))
            if not len(idx):
                continue
            J = ref.judge_scaled(prob, sc, v[idx])
            viol_err = max(viol_err, float(np.max(np.abs(
                np.asarray(a["viol"], np.float64)[idx] - J["viol"].numpy()))) / feas)
            f_ref = J["f"].numpy()
            cost_err = max(cost_err, float(np.max(
                np.abs(np.asarray(a["f"], np.float64)[idx] - f_ref)
                / np.maximum(np.abs(f_ref), 1e-12))))
            idx = idx[gated[idx]]
            if len(idx):
                kkt = max(kkt, float(np.max(ref.certificate(prob, sc, v[idx],
                                                            device))))
    return dict(unanswered=1.0 - answered / max(lanes, 1), viol_err=viol_err,
                cost_err=cost_err, kkt_ratio=kkt / gate_["kkt_tol"])
