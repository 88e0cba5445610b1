"""Mission S10 — loiter on a goal circle (port of ``tol_tpu/problems/s10.py``).

Cost  F0 = 0.5 kT sum T_i^2 + 0.5 kp sum (r_i - R)^2 + kdt dt;
boundary: all 11 node variables periodic, with chi(tf) - chi(t0) = 2*pi.
:func:`node_cost_hess` is the node cost's Hessian in closed form.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tol_tpu_torch.config import ProblemConfig
from tol_tpu_torch.models.dynamics import IDX_CHI, IDX_T, NUM_VARS
from tol_tpu_torch.problems.seed import invert_flight_mechanics, s10_seed_path


def node_cost_hess(z, dt, inst):
    """The Hessian (..., 11, 11) of the node cost in z (it has no dt
    term): the radius term's in x, y, and kT on T.  With (dx, dy) from the
    goal centre, the radius term's gradient is a (dx, dy) and the gradient
    of a is b (dx, dy)."""
    d = z[..., :2] - torch.stack([inst.goal.xg, inst.goal.yg])
    r2 = (d * d).sum(-1, keepdim=True)
    r = torch.sqrt(r2)
    kp, R = inst.gains.kp, inst.goal.rg
    a, b = kp * (r - R) / r, kp * R / (r * r2)
    H = z.new_zeros(*z.shape, NUM_VARS)
    eye = torch.eye(2, dtype=z.dtype, device=z.device)
    H[..., :2, :2] = (b[..., None] * d[..., :, None] * d[..., None, :]
                      + a[..., None] * eye)
    H[..., IDX_T, IDX_T] = inst.gains.kT
    return H


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
