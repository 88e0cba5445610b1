"""Mission S10 — loiter on a goal circle (port of ``tol_tpu/problems/s10.py``).

Cost  F0 = 0.5 kT sum T_i^2 + 0.5 kp sum (r_i - R)^2 + kdt dt;
boundary: all 11 node variables periodic, with chi(tf) - chi(t0) = 2*pi.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tol_tpu_torch.config import ProblemConfig
from tol_tpu_torch.models.dynamics import IDX_CHI, IDX_T, NUM_VARS
from tol_tpu_torch.problems.seed import invert_flight_mechanics, s10_seed_path


def make(cfg: ProblemConfig, dtype, device):
    ts = cfg.dims.ts

    def node_cost(z, dt, inst):
        r = torch.sqrt((z[..., 0] - inst.goal.xg) ** 2
                       + (z[..., 1] - inst.goal.yg) ** 2)
        return (0.5 * inst.gains.kT * z[..., IDX_T] ** 2
                + 0.5 * inst.gains.kp * (r - inst.goal.rg) ** 2)

    def global_cost(z0, zT, dt, inst):
        return inst.gains.kdt * dt

    offset = torch.zeros(NUM_VARS, dtype=dtype, device=device)
    offset[IDX_CHI] = 2.0 * math.pi

    def boundary(z0, zT, dt, inst):
        return zT - z0 - offset

    is_ineq = np.zeros(NUM_VARS, dtype=bool)  # 11 equality rows

    def seed(inst):
        path = s10_seed_path(ts, dtype=dtype, aircraft=inst.aircraft,
                             device=device)
        return invert_flight_mechanics(path, inst.aircraft, periodic_rates=True)

    return node_cost, global_cost, boundary, is_ineq, seed
