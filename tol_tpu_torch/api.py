"""High-level convenience API (port of ``tol_tpu/api.py``).

``make_problem`` assembles a mission NLP from the shared ``assets/`` on the
CUDA device unless ``device`` names another one.
"""

from __future__ import annotations

import torch

from tol_tpu_torch.config import G7_BOXES, S10_BOXES, Goal, ProblemConfig
from tol_tpu_torch.io.params import (assets_root, load_aircraft, load_gains,
                                     load_limits, load_solver_dims)
from tol_tpu_torch.models.wind import WindConfig
from tol_tpu_torch.problems.base import CollocationNLP, build_nlp


def make_config(mission: str = "S10", aircraft: str = "tempest",
                ts: int | None = None, wind_model: int = 1,
                jacobian_mode: str = "exact", root_path: str | None = None,
                scale_dt_limits: bool = True) -> ProblemConfig:
    """ProblemConfig from the assets; a non-reference ``ts`` rescales the
    per-step dt box so the total time budget ``ts*[dtmin, dtmax]`` holds."""
    root = root_path or assets_root()
    dims = load_solver_dims(mission, root)
    limits = load_limits(mission, root)
    if ts is not None:
        if scale_dt_limits and ts != dims.ts:
            scale = dims.ts / ts
            limits = limits._replace(dtmin=limits.dtmin * scale,
                                     dtmax=limits.dtmax * scale)
        dims = dims._replace(ts=ts)
    return ProblemConfig(
        mission=mission,
        aircraft=load_aircraft(aircraft, root),
        gains=load_gains(mission, root),
        limits=limits,
        dims=dims,
        boxes=S10_BOXES if mission == "S10" else G7_BOXES,
        wind_model=wind_model,
        jacobian_mode=jacobian_mode,
    )


def default_goal(mission: str) -> Goal:
    if mission == "S10":
        return Goal(xg=-100.0, yg=0.0, zg=0.0, rg=100.0)
    return Goal(xg=0.0, yg=400.0, zg=0.0, rg=0.0)


def make_problem(mission: str = "S10", aircraft: str = "tempest",
                 ts: int | None = None, wind_model: int = 1,
                 goal: Goal | None = None, wind: WindConfig | None = None,
                 jacobian_mode: str = "exact", dtype=torch.float64,
                 device=None) -> CollocationNLP:
    """Mission NLP on ``device`` (default: CUDA; raises without a GPU)."""
    cfg = make_config(mission, aircraft, ts, wind_model, jacobian_mode)
    if goal is None:
        goal = default_goal(mission)
    if wind is None:
        wind = WindConfig(model=wind_model)
    return build_nlp(cfg, goal, wind, dtype=dtype, device=device)
