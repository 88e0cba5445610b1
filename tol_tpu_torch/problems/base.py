"""Declarative collocation-NLP specification (port of
``tol_tpu/problems/base.py``).

    minimize    sum_i node_cost(z_i, dt) + global_cost(z_0, z_T, dt)
    subject to  defect(z_i, z_{i+1}, dt) = 0        i = 0..T-1
                boundary(z_0, z_T, dt) = 0
                z_lo <= z_i <= z_up,  dt_lo <= dt <= dt_hi

Every function works on the last axis (nodes ``(..., 11)``, ``dt`` of the
leading shape), so one call covers a whole batch of lanes; the per-node
derivatives in the solver come from ``torch.func`` over the same functions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from tol_tpu_torch.config import (AircraftParams, Gains, Goal, Limits,
                                  MissionBoxes, ProblemConfig, StitchState)
from tol_tpu_torch.models.dynamics import NUM_STATES, state_derivatives
from tol_tpu_torch.models.wind import WindConfig, wind_with_gradient_ned
from tol_tpu_torch.problems import g7 as _g7
from tol_tpu_torch.problems import s10 as _s10


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Raises when no device is given and no CUDA device is present — the
    port never falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


class Instance(NamedTuple):
    """Per-scenario parameters, shared by every lane of a solve."""

    aircraft: AircraftParams   # 0-d tensors
    gains: Gains               # 0-d tensors
    goal: Goal                 # 0-d tensors
    wind: WindConfig
    z_lo: torch.Tensor         # (T+1, 11)
    z_up: torch.Tensor
    dt_lo: torch.Tensor        # 0-d
    dt_hi: torch.Tensor


def node_bounds(boxes: MissionBoxes, aircraft: AircraftParams, limits: Limits,
                ts: int, start_ned=(0.0, 0.0, 0.0), dtype=torch.float64,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Variable boxes per node (``problem::setLimits``): node 0 uses the
    wide mission boxes with position pinned to the leg origin; nodes >= 1
    the aircraft/limit boxes with free winding course."""
    ac, lm, bx = aircraft, limits, boxes
    fl = lambda x: float(x)
    xi, yi, zi = [fl(c) for c in start_ned]
    lo0 = np.array([xi, yi, zi, fl(bx.Va1), fl(bx.gamma1), fl(bx.chi1),
                    fl(bx.phi1), fl(bx.CL1), fl(bx.phidot1), fl(bx.CLdot1),
                    0.0])
    up0 = np.array([xi, yi, zi, fl(bx.Va2), fl(bx.gamma2), fl(bx.chi2),
                    fl(bx.phi2), fl(bx.CL2), fl(bx.phidot2), fl(bx.CLdot2),
                    1e20])
    lo = np.array([fl(lm.xmin), fl(lm.ymin), fl(lm.zmin), fl(ac.Vamin),
                   -fl(ac.gammamax), -1e20, -fl(ac.phimax), fl(ac.CLmin),
                   -fl(ac.phidotmax), -fl(ac.phidotmax), fl(ac.Tmin)])
    up = np.array([fl(lm.xmax), fl(lm.ymax), fl(lm.zmax), fl(ac.Vamax),
                   fl(ac.gammamax), 1e20, fl(ac.phimax), fl(ac.CLmax),
                   fl(ac.phidotmax), fl(ac.phidotmax), fl(ac.Tmax)])
    z_lo = np.concatenate([lo0[None, :], np.tile(lo[None, :], (ts, 1))])
    z_up = np.concatenate([up0[None, :], np.tile(up[None, :], (ts, 1))])
    return (torch.as_tensor(z_lo, dtype=dtype, device=device),
            torch.as_tensor(z_up, dtype=dtype, device=device))


# Stitching slacks around the previous leg's terminal state: Va +-2 m/s,
# gamma +-10 deg, chi +-pi, phi +-10 deg, CL +-0.2, rates at their airframe
# boxes, T +-5 N (see the JAX module for why chi is not pinned).
_STITCH_SLACK = np.array([2.0, np.deg2rad(10.0), np.pi, np.deg2rad(10.0), 0.2,
                          1e3, 1e3, 5.0])


def apply_stitch(z_lo: torch.Tensor, z_up: torch.Tensor,
                 stitch: StitchState) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replace the node-0 state bounds by slack boxes around the previous
    leg's terminal state, clipped into the node>=1 boxes."""
    zl = z_lo.detach().cpu().numpy().copy()
    zu = z_up.detach().cpu().numpy().copy()
    s = np.array([float(v) for v in stitch])
    zl[0, 3:] = np.clip(s - _STITCH_SLACK, zl[1, 3:], zu[1, 3:])
    zu[0, 3:] = np.clip(s + _STITCH_SLACK, zl[1, 3:], zu[1, 3:])
    return (torch.as_tensor(zl, dtype=z_lo.dtype, device=z_lo.device),
            torch.as_tensor(zu, dtype=z_up.dtype, device=z_up.device))


@dataclasses.dataclass(frozen=True)
class CollocationNLP:
    """One mission NLP family; callables take the Instance last."""

    mission: str
    T: int
    nb: int
    boundary_is_ineq: np.ndarray
    inst0: Instance
    seed_fn: Callable
    node_cost_fn: Callable
    global_cost_fn: Callable
    defect_fn: Callable
    boundary_fn: Callable

    def _inst(self, inst):
        return self.inst0 if inst is None else inst

    def seed(self, inst=None):
        return self.seed_fn(self._inst(inst))

    def node_cost(self, z, dt, inst=None):
        return self.node_cost_fn(z, dt, self._inst(inst))

    def global_cost(self, z0, zT, dt, inst=None):
        return self.global_cost_fn(z0, zT, dt, self._inst(inst))

    def defect(self, z_i, z_ip1, dt, inst=None):
        return self.defect_fn(z_i, z_ip1, dt, self._inst(inst))

    def boundary(self, z0, zT, dt, inst=None):
        return self.boundary_fn(z0, zT, dt, self._inst(inst))

    @property
    def z_lo(self):
        return self.inst0.z_lo

    @property
    def z_up(self):
        return self.inst0.z_up

    @property
    def dt_lo(self):
        return self.inst0.dt_lo

    @property
    def dt_hi(self):
        return self.inst0.dt_hi

    def total_cost(self, Z, dt, inst=None):
        """``Z`` (..., T+1, 11), ``dt`` (...) -> (...)."""
        inst = self._inst(inst)
        node = self.node_cost_fn(Z, dt[..., None], inst)
        return node.sum(-1) + self.global_cost_fn(Z[..., 0, :], Z[..., -1, :],
                                                  dt, inst)

    def all_defects(self, Z, dt, inst=None):
        """(..., T, 8) forward-Euler defect residuals."""
        inst = self._inst(inst)
        return self.defect_fn(Z[..., :-1, :], Z[..., 1:, :], dt[..., None], inst)

    def constraints(self, Z, dt, inst=None):
        """All rows stacked: (..., T*8 + nb)."""
        inst = self._inst(inst)
        d = self.all_defects(Z, dt, inst)
        d = d.reshape(*d.shape[:-2], -1)
        return torch.cat([d, self.boundary(Z[..., 0, :], Z[..., -1, :], dt, inst)],
                         dim=-1)


def make_instance(cfg: ProblemConfig, goal: Goal, wind: WindConfig,
                  start_ned=(0.0, 0.0, 0.0), dtype=torch.float64,
                  stitch: StitchState | None = None, device=None) -> Instance:
    device = resolve_device(device)
    z_lo, z_up = node_bounds(cfg.boxes, cfg.aircraft, cfg.limits, cfg.dims.ts,
                             start_ned, dtype, device)
    if stitch is not None:
        z_lo, z_up = apply_stitch(z_lo, z_up, stitch)
    to = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    return Instance(
        aircraft=AircraftParams(*[to(x) for x in cfg.aircraft]),
        gains=Gains(*[to(x) for x in cfg.gains]),
        goal=Goal(*[to(x) for x in goal]),
        wind=wind,
        z_lo=z_lo, z_up=z_up,
        dt_lo=to(cfg.limits.dtmin), dt_hi=to(cfg.limits.dtmax),
    )


def build_nlp(cfg: ProblemConfig, goal: Goal, wind: WindConfig,
              dtype=torch.float64, device=None) -> CollocationNLP:
    """Assemble the mission NLP (``cfg.mission`` "S10" or "G7")."""
    device = resolve_device(device)
    if cfg.mission == "S10":
        mod = _s10
    elif cfg.mission == "G7":
        mod = _g7
    else:
        raise ValueError(f'Problem "{cfg.mission}" not recognized.')

    freeze_wind = cfg.jacobian_mode == "reference"
    wind_model = int(wind.model)

    def defect(z_i, z_ip1, dt, inst):
        """Forward-Euler defect rows; ``dt`` has the nodes' leading shape.
        In "reference" Jacobian mode the wind sample is frozen w.r.t.
        position (residual values are unaffected)."""
        p = z_i[..., 0:3]
        if freeze_wind:
            p = p.detach()
        wcfg = dataclasses.replace(inst.wind, model=wind_model)
        w, gw = wind_with_gradient_ned(wcfg, p)
        zdot = state_derivatives(z_i, w, gw, inst.aircraft)
        return z_ip1[..., :NUM_STATES] - zdot * dt[..., None] - z_i[..., :NUM_STATES]

    node_cost, global_cost, boundary, is_ineq, seed = mod.make(cfg, dtype, device)
    inst0 = make_instance(cfg, goal, wind, dtype=dtype, device=device)
    nb = int(cfg.dims.numbounds)
    if is_ineq.shape != (nb,):
        raise ValueError(f"boundary rows {is_ineq.shape} != numbounds {nb}")

    return CollocationNLP(
        mission=cfg.mission, T=int(cfg.dims.ts), nb=nb,
        boundary_is_ineq=is_ineq, inst0=inst0, seed_fn=seed,
        node_cost_fn=node_cost, global_cost_fn=global_cost,
        defect_fn=defect, boundary_fn=boundary,
    )


def instance_from_numpy(fields: dict, device=None,
                        dtype=torch.float64) -> Instance:
    """The port's Instance from a JAX Instance's fields as plain numpy.

    ``fields`` maps the Instance field names to numpy data: ``aircraft``,
    ``gains`` and ``goal`` as NamedTuples (or dicts) of scalars, ``wind``
    as any object with the WindConfig attributes, bounds as arrays."""
    device = resolve_device(device)
    to = lambda x: torch.as_tensor(np.array(x), dtype=dtype, device=device)

    def rec(cls, x):
        d = x._asdict() if hasattr(x, "_asdict") else dict(x)
        return cls(**{k: to(d[k]) for k in cls._fields})

    w = fields["wind"]
    wind = WindConfig(**{f.name: (getattr(w, f.name) if f.name in
                                  ("model", "interp", "order", "grid")
                                  else float(np.asarray(getattr(w, f.name))))
                         for f in dataclasses.fields(WindConfig)})
    return Instance(
        aircraft=rec(AircraftParams, fields["aircraft"]),
        gains=rec(Gains, fields["gains"]),
        goal=rec(Goal, fields["goal"]),
        wind=wind,
        z_lo=to(fields["z_lo"]), z_up=to(fields["z_up"]),
        dt_lo=to(fields["dt_lo"]), dt_hi=to(fields["dt_hi"]),
    )
