"""Canonical NLP form for the solvers (port of ``tol_tpu/solver/canonical.py``).

    minimize   f(v, inst)
    subject to c(v, inst) = 0,       lb(inst) <= v <= ub(inst)

with ``v = [dt, Z.flat, s]`` (one slack per inequality boundary row).  ``f``
and ``c`` act on the last axis: ``v`` (..., n) -> (...) and (..., m), so one
call evaluates every lane of a batch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import grad, jacfwd, jvp

from tol_tpu_torch.models.dynamics import NUM_STATES, NUM_VARS
from tol_tpu_torch.problems.base import CollocationNLP, Instance


def jacfwd_lanes(f, x: torch.Tensor) -> torch.Tensor:
    """Jacobian of a lane-wise function by one forward-mode pass.

    ``f`` maps ``x`` (N, k) to (N, ...) with lane i depending on ``x[i]``
    only; returns (N, ..., k).  The k basis directions ride a leading
    replica axis of one ``jvp`` — what ``jacfwd`` does with ``vmap`` —
    which keeps every dual tensor at least 1-d (torch's forward mode
    promotes a 0-d float32 dual times a Python float to float64)."""
    k = x.shape[-1]
    X = x.unsqueeze(0).expand(k, *x.shape)
    eye = torch.eye(k, dtype=x.dtype, device=x.device)
    basis = eye.reshape(k, *([1] * (x.dim() - 1)), k).expand_as(X)
    _, dy = jvp(f, (X.contiguous(),), (basis.contiguous(),))
    return dy.movedim(0, -1)


class Scaling(NamedTuple):
    """Diagonal nondimensionalization: the solver works on ``u = v / d``
    with constraint rows divided by ``r`` and the objective times ``s_f``."""

    d_z: torch.Tensor    # (11,) per-kind variable scales
    d_dt: torch.Tensor   # scalar dt scale
    r_b: torch.Tensor    # (nb,) boundary row scales
    s_f: torch.Tensor = None  # type: ignore[assignment]


def scaling_from_numpy(fields: dict, device=None,
                       dtype=torch.float64) -> Scaling:
    """Scaling from a JAX Scaling's fields as numpy (``_asdict()``), so that
    both packages can canonicalize with the same scales."""
    return Scaling(**{
        k: (None if fields[k] is None
            else torch.as_tensor(np.array(fields[k]), dtype=dtype,
                                 device=device))
        for k in Scaling._fields})


def default_scaling(nlp: CollocationNLP, dtype=None) -> Scaling:
    """Physics-derived scales from the default instance.

    The boundary-row norms are taken at a seed perturbed by noise from a
    ``torch.Generator`` seeded 0.  The JAX package draws that noise from
    ``jax.random.PRNGKey(0)``, so the two agree only where the boundary
    Jacobian does not depend on the point — true for S10, whose rows are
    linear (ROADMAP queue C)."""
    inst = nlp.inst0
    dtype = dtype or inst.z_lo.dtype
    device = inst.z_lo.device
    tt = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    ac = inst.aircraft
    pos = torch.clamp(tt(inst.goal.rg), min=100.0)
    d_z = torch.stack([
        pos, pos, pos,
        tt(ac.Vamax) / 2.0,
        tt(ac.gammamax),
        tt(3.0),
        tt(ac.phimax),
        torch.clamp(tt(ac.CLmax).abs(), min=0.5),
        tt(ac.phidotmax),
        tt(ac.phidotmax),
        torch.clamp(tt(ac.Tmax) / 4.0, min=1.0),
    ])
    d_dt = 0.5 * (tt(inst.dt_lo) + tt(inst.dt_hi))
    Z0, dt0 = nlp.seed_fn(inst)
    gen = torch.Generator(device="cpu").manual_seed(0)
    noise = torch.randn(2 * NUM_VARS + 1, generator=gen,
                        dtype=torch.float64).to(dtype=dtype, device=device)
    z0p = Z0[0] + 0.1 * d_z * noise[:NUM_VARS]
    zTp = Z0[-1] + 0.1 * d_z * noise[NUM_VARS:2 * NUM_VARS]
    dtp = dt0 * (1.0 + 0.05 * noise[-1])
    G0, GT, Gdt = [g.to(dtype) for g in jacfwd(nlp.boundary_fn, argnums=(0, 1, 2))(
        z0p, zTp, dtp, inst)]
    row = torch.sqrt(((G0 * d_z[None, :]) ** 2).sum(-1)
                     + ((GT * d_z[None, :]) ** 2).sum(-1)
                     + (Gdt * d_dt) ** 2)
    r_b = torch.clamp(row, 1e-2, 1e6)
    gZ, gdt = grad(nlp.total_cost, argnums=(0, 1))(Z0, dt0, inst)
    g_inf = torch.maximum((gZ * d_z[None, :]).abs().max(), (gdt * d_dt).abs())
    s_f = 1.0 / torch.clamp(g_inf, 1.0, 1e12)
    return Scaling(d_z=d_z, d_dt=d_dt, r_b=r_b, s_f=s_f)


@dataclasses.dataclass(frozen=True)
class CanonicalNLP:
    nlp: CollocationNLP
    n: int                       # 1 + (T+1)*11 + n_slack
    m: int                       # 8*T + nb
    n_slack: int
    f: Callable[[torch.Tensor, Instance], torch.Tensor]
    c: Callable[[torch.Tensor, Instance], torch.Tensor]
    bounds: Callable[[Instance], tuple]
    scaling: Scaling | None = None
    nlp_phys: CollocationNLP | None = None

    def split(self, v: torch.Tensor):
        """v (..., n) -> (Z (..., T+1, 11), dt (...), s (..., n_slack))."""
        T = self.nlp.T
        Z = v[..., 1:1 + (T + 1) * NUM_VARS].reshape(*v.shape[:-1], T + 1,
                                                     NUM_VARS)
        return Z, v[..., 0], v[..., 1 + (T + 1) * NUM_VARS:]

    def join(self, Z, dt, s):
        return torch.cat([dt[..., None], Z.reshape(*Z.shape[:-2], -1), s], dim=-1)

    def initial_point(self, inst: Instance | None = None) -> torch.Tensor:
        """Seed trajectory + interior slack initialization."""
        inst = self.nlp._inst(inst)
        Z, dt = self.nlp.seed_fn(inst)
        if self.n_slack:
            b = self.nlp.boundary(Z[0], Z[-1], dt, inst)
            ineq = torch.as_tensor(np.flatnonzero(self.nlp.boundary_is_ineq),
                                   device=b.device)
            s = torch.clamp(-b[ineq], min=1e-2)
        else:
            s = torch.zeros((0,), dtype=Z.dtype, device=Z.device)
        return self.join(Z, dt, s)

    def v_scale(self) -> torch.Tensor:
        """Per-entry scale of the full decision vector (1s when unscaled)."""
        T = self.nlp.T
        z_lo = self.nlp.inst0.z_lo
        if self.scaling is None:
            n = 1 + (T + 1) * NUM_VARS + self.n_slack
            return torch.ones(n, dtype=z_lo.dtype, device=z_lo.device)
        sc = self.scaling
        ineq = torch.as_tensor(np.flatnonzero(self.nlp.boundary_is_ineq),
                               dtype=torch.long, device=z_lo.device)
        return torch.cat([sc.d_dt.reshape(1), sc.d_z.repeat(T + 1), sc.r_b[ineq]])

    def to_physical(self, v: torch.Tensor) -> torch.Tensor:
        return v * self.v_scale() if self.scaling is not None else v

    def from_physical(self, v: torch.Tensor) -> torch.Tensor:
        return v / self.v_scale() if self.scaling is not None else v


def _scale_nlp(nlp: CollocationNLP, sc: Scaling) -> CollocationNLP:
    """Scaled twin of ``nlp``: v = d * u, rows / r, objective * s_f."""
    d_z, d_dt = sc.d_z, sc.d_dt
    r_d = sc.d_z[:NUM_STATES]
    r_b = sc.r_b
    s_f = sc.s_f if sc.s_f is not None else 1.0

    raw_node, raw_glob = nlp.node_cost_fn, nlp.global_cost_fn
    raw_defect, raw_boundary, raw_seed = nlp.defect_fn, nlp.boundary_fn, nlp.seed_fn

    def node_cost(z, dt, inst):
        return s_f * raw_node(d_z * z, d_dt * dt, inst)

    def global_cost(z0, zT, dt, inst):
        return s_f * raw_glob(d_z * z0, d_z * zT, d_dt * dt, inst)

    def defect(z_i, z_ip1, dt, inst):
        return raw_defect(d_z * z_i, d_z * z_ip1, d_dt * dt, inst) / r_d

    def boundary(z0, zT, dt, inst):
        return raw_boundary(d_z * z0, d_z * zT, d_dt * dt, inst) / r_b

    def seed(inst):
        Z, dt = raw_seed(inst)
        return Z / d_z[None, :], dt / d_dt

    return dataclasses.replace(
        nlp, node_cost_fn=node_cost, global_cost_fn=global_cost,
        defect_fn=defect, boundary_fn=boundary, seed_fn=seed)


def canonicalize(nlp: CollocationNLP,
                 scaling: Scaling | str | None = None) -> CanonicalNLP:
    """Canonical form; ``scaling="auto"`` nondimensionalizes."""
    if isinstance(scaling, str):
        if scaling != "auto":
            raise ValueError(f"unknown scaling mode {scaling!r}")
        scaling = default_scaling(nlp)
    nlp_phys = nlp if scaling is not None else None
    if scaling is not None:
        nlp = _scale_nlp(nlp, scaling)

    T = nlp.T
    z_lo0 = nlp.inst0.z_lo
    dtype, device = z_lo0.dtype, z_lo0.device
    ineq_idx = np.flatnonzero(nlp.boundary_is_ineq)
    n_slack = len(ineq_idx)
    n = 1 + (T + 1) * NUM_VARS + n_slack
    m = NUM_STATES * T + nlp.nb

    slack_scatter_np = np.zeros((nlp.nb, n_slack))
    for j, r in enumerate(ineq_idx):
        slack_scatter_np[r, j] = 1.0

    def split(v):
        Z = v[..., 1:1 + (T + 1) * NUM_VARS].reshape(*v.shape[:-1], T + 1,
                                                     NUM_VARS)
        return Z, v[..., 0], v[..., 1 + (T + 1) * NUM_VARS:]

    def f(v, inst):
        Z, dt, _ = split(v)
        return nlp.total_cost(Z, dt, inst)

    def c(v, inst):
        Z, dt, s = split(v)
        d = nlp.all_defects(Z, dt, inst)
        d = d.reshape(*d.shape[:-2], -1)
        b = nlp.boundary(Z[..., 0, :], Z[..., -1, :], dt, inst)
        if n_slack:
            G = torch.as_tensor(slack_scatter_np, dtype=v.dtype, device=v.device)
            b = b + (s[..., None, :] * G).sum(-1)
        return torch.cat([d, b], dim=-1)

    zeros_s = torch.zeros(n_slack, dtype=dtype, device=device)
    big_s = torch.full((n_slack,), 1e20, dtype=dtype, device=device)
    if scaling is None:
        def bounds(inst):
            lb = torch.cat([inst.dt_lo.reshape(1), inst.z_lo.reshape(-1), zeros_s])
            ub = torch.cat([inst.dt_hi.reshape(1), inst.z_up.reshape(-1), big_s])
            return lb, ub, lb == ub
    else:
        sc = scaling

        def bounds(inst):
            # Infinite bounds stay infinite after scaling.
            z_lo = torch.where(inst.z_lo.abs() < 1e19,
                               inst.z_lo / sc.d_z[None, :], inst.z_lo)
            z_up = torch.where(inst.z_up.abs() < 1e19,
                               inst.z_up / sc.d_z[None, :], inst.z_up)
            lb = torch.cat([(inst.dt_lo / sc.d_dt).reshape(1), z_lo.reshape(-1),
                            zeros_s])
            ub = torch.cat([(inst.dt_hi / sc.d_dt).reshape(1), z_up.reshape(-1),
                            big_s])
            return lb, ub, lb == ub

    return CanonicalNLP(nlp=nlp, n=n, m=m, n_slack=n_slack, f=f, c=c,
                        bounds=bounds, scaling=scaling, nlp_phys=nlp_phys)
