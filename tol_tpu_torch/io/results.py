"""Result serialization, ``snopt_results.json``-compatible (port of
``tol_tpu/io/results.py``).

The document has the reference's schema: args / trajectory arrays /
aircraft / gains / limits / snopt sections plus ``FinalCost`` and ``dt``.
It takes tensors from any device (or arrays) and converts them on the
host.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np

import torch

from tol_tpu_torch.config import Goal, ProblemConfig


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def results_document(
    cfg: ProblemConfig,
    goal: Goal,
    Z,
    dt,
    final_cost,
    aircraft_name: str = "",
    east: float = 0.0,
    north: float = 0.0,
    up: float = 0.0,
) -> Dict[str, Any]:
    Z = _host(Z)
    dt = float(_host(dt))
    n_nodes = Z.shape[0]
    time = [i * dt for i in range(n_nodes)]

    def col(k):
        return [float(x) for x in Z[:, k]]

    ac, gn, lm, sn = cfg.aircraft, cfg.gains, cfg.limits, cfg.dims
    return {
        "args": {
            "east": east, "north": north, "up": up,
            "xg": float(goal.xg), "yg": float(goal.yg), "zg": float(goal.zg),
            "rd": float(goal.rg),
            "aircraft": aircraft_name, "problem": cfg.mission,
        },
        "problem": cfg.mission,
        "FinalCost": float(_host(final_cost)),
        "dt": dt,
        "trajectory": {
            "time": time,
            "x": col(0), "y": col(1), "z": col(2),
            "Va": col(3), "gam": col(4), "chi": col(5),
            "phi": col(6), "CL": col(7),
            "dphi": col(8), "dCL": col(9), "T": col(10),
        },
        "aircraft": {
            "name": aircraft_name, "mass": float(ac.mm), "b": float(ac.b),
            "S": float(ac.SS), "e": float(ac.ee), "AR": float(ac.AR),
            "Cd0": float(ac.Cd0), "CLmin": float(ac.CLmin),
            "CLmax": float(ac.CLmax), "phimax": float(ac.phimax),
            "Vamin": float(ac.Vamin), "Vamax": float(ac.Vamax),
            "gammamax": float(ac.gammamax), "dphimax": float(ac.phidotmax),
            "Tmin": float(ac.Tmin), "Tmax": float(ac.Tmax),
        },
        "gains": {
            "kT": float(gn.kT), "kp": float(gn.kp), "kv": float(gn.kv),
            "ka": float(gn.ka), "kdt": float(gn.kdt),
        },
        "limits": {
            "dtmin": float(lm.dtmin), "dtmax": float(lm.dtmax),
            "xmin": float(lm.xmin), "xmax": float(lm.xmax),
            "ymin": float(lm.ymin), "ymax": float(lm.ymax),
            "zmin": float(lm.zmin), "zmax": float(lm.zmax),
        },
        "snopt": {
            "ts": int(sn.ts), "numinp": int(sn.numinp),
            "numstates": int(sn.numstates), "numbounds": int(sn.numbounds),
            "opt_tol": float(sn.opt_tol), "feas_tol": float(sn.feas_tol),
        },
    }


def write_results_json(path: str, doc: Dict[str, Any]) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=3)


def read_results_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def write_results_txt(path: str, doc: Dict[str, Any]) -> None:
    """Tab-separated text variant: header comment lines, one column per
    state with ``%-4.7e`` formatting, then dt and FinalCost columns
    repeated per row; time accumulates by dt.  The header's ``tf_i`` is the
    actual final time and the mission line the real problem name."""
    tr = doc["trajectory"]
    dt = float(doc["dt"])
    names = ["x", "y", "z", "Va", "gamma", "chi", "phi", "CL",
             "dphi", "dCL", "T"]
    keys = ["x", "y", "z", "Va", "gam", "chi", "phi", "CL",
            "dphi", "dCL", "T"]
    n = len(tr["x"])
    tfinal = dt * (n - 1)
    with open(path, "w") as f:
        f.write("% SNOPT Output: Thesis Optimization \n")
        f.write(f"% Simulation: tf_i = {tfinal:4.2f} s, dt_i = {dt:4.2f} s \n")
        f.write("% time \t \t" + "".join(f"{c} \t \t" for c in names)
                + "dt \t \tFinal Cost \n")
        f.write(f"Problem{doc.get('problem', 'S10')} \n")
        t = 0.0
        for i in range(n):
            cells = [f"{t:-4.7e} \t"]
            cells += [f"{float(tr[k][i]):-4.7e} \t" for k in keys]
            cells += [f"{dt:-4.7e} \t", f"{float(doc['FinalCost']):-4.7e} \n"]
            f.write("".join(cells))
            t += dt
