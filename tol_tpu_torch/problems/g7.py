"""Mission G7 — periodic guidance gait toward the goal course (port of
``tol_tpu/problems/g7.py``).

Cost  F0 = 0.5 kT sum T_i^2 + kv ts dt / dist, dist the horizontal
displacement between the first and the last node.

Boundary, 12 rows (the displacement pair in the well-conditioned form the
JAX module derives):
    0 (eq):     -dx sin(chi_d) + dy cos(chi_d) = 0     perpendicular to course
    1 (<= 0):   -(dx cos(chi_d) + dy sin(chi_d))       along course >= 0
    2-10 (eq):  z .. T periodic
    11 (<= 0):  dist - dmax                            dmax: node 0 to the goal
with chi_d = atan2(yg, xg) the desired course from the leg origin.
"""

from __future__ import annotations

import numpy as np
import torch

from tol_tpu_torch.config import ProblemConfig
from tol_tpu_torch.models.dynamics import IDX_T, NUM_VARS
from tol_tpu_torch.problems.seed import g7_seed_path, invert_flight_mechanics


def _chi_d(inst):
    return torch.atan2(inst.goal.yg, inst.goal.xg)


def _dist(z0, zT):
    return torch.sqrt((zT[..., 0] - z0[..., 0]) ** 2
                      + (zT[..., 1] - z0[..., 1]) ** 2)


def make(cfg: ProblemConfig, dtype, device):
    ts = cfg.dims.ts

    def node_cost(z, dt, inst):
        return 0.5 * inst.gains.kT * z[..., IDX_T] ** 2

    def global_cost(z0, zT, dt, inst):
        return inst.gains.kv * ts * dt / _dist(z0, zT)

    def boundary(z0, zT, dt, inst):
        chi_d = _chi_d(inst)
        dx = zT[..., 0] - z0[..., 0]
        dy = zT[..., 1] - z0[..., 1]
        dmax = torch.sqrt((inst.goal.xg - z0[..., 0]) ** 2
                          + (inst.goal.yg - z0[..., 1]) ** 2)
        rows = [-dx * torch.sin(chi_d) + dy * torch.cos(chi_d),
                -(dx * torch.cos(chi_d) + dy * torch.sin(chi_d))]
        rows += [zT[..., k] - z0[..., k] for k in range(2, NUM_VARS)]
        rows.append(_dist(z0, zT) - dmax)
        return torch.stack(rows, dim=-1)

    is_ineq = np.zeros(NUM_VARS + 1, dtype=bool)
    is_ineq[1] = True    # along-course displacement >= 0
    is_ineq[-1] = True   # dist <= dmax

    def seed(inst):
        path = g7_seed_path(ts, _chi_d(inst), vamin=inst.aircraft.Vamin,
                            vamax=inst.aircraft.Vamax, dtype=dtype,
                            device=device)
        return invert_flight_mechanics(path, inst.aircraft,
                                       periodic_rates=False)

    return node_cost, global_cost, boundary, is_ineq, seed
