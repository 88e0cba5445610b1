"""Canonical NLP form for the solvers (port of ``tol_tpu/solver/canonical.py``).

    minimize   f(v, inst)
    subject to c(v, inst) = 0,       lb(inst) <= v <= ub(inst)

with ``v = [dt, Z.flat, s]`` (one slack per inequality boundary row).  ``f``
and ``c`` act on the last axis: ``v`` (..., n) -> (...) and (..., m), so one
call evaluates every lane of a batch.  :func:`constraint_jacobian` applies
``dc/dv`` and its transpose from the collocation blocks, which
:func:`constraint_jac_blocks` takes by the kernel K9 (``ops/nodekern.py``)
where :func:`closed_form_blocks` holds, else by ``torch.func`` transforms.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import grad, jacfwd, jvp

from tol_tpu_torch.models.dynamics import NUM_STATES, NUM_VARS
from tol_tpu_torch.models.wind import affine_wind
from tol_tpu_torch.ops import nodekern
from tol_tpu_torch.problems.base import CollocationNLP, Instance
from tol_tpu_torch.utils.profiling import count


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


def unit_scaling(nlp: CollocationNLP, dtype=None) -> Scaling:
    """The identity Scaling (every scale 1) on the problem's device."""
    z_lo = nlp.inst0.z_lo
    dtype = dtype or z_lo.dtype
    ones = lambda *s: torch.ones(*s, dtype=dtype, device=z_lo.device)
    return Scaling(d_z=ones(NUM_VARS), d_dt=ones(()), r_b=ones(nlp.nb),
                   s_f=ones(()))


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
    dd = s_f * torch.outer(d_z, d_z)

    raw_node, raw_glob = nlp.node_cost_fn, nlp.global_cost_fn
    raw_node_hess = nlp.node_cost_hess_fn
    raw_defect, raw_boundary, raw_seed = nlp.defect_fn, nlp.boundary_fn, nlp.seed_fn

    def node_cost(z, dt, inst):
        return s_f * raw_node(d_z * z, d_dt * dt, inst)

    def node_cost_hess(z, dt, inst):
        return dd * raw_node_hess(d_z * z, d_dt * dt, inst)

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
        defect_fn=defect, boundary_fn=boundary, seed_fn=seed,
        node_cost_hess_fn=node_cost_hess)


def _slack_scatter(nlp: CollocationNLP) -> torch.Tensor:
    """(nb, n_slack): 1 where slack j enters inequality boundary row r."""
    z_lo0 = nlp.inst0.z_lo
    ineq_idx = np.flatnonzero(nlp.boundary_is_ineq)
    G = np.zeros((nlp.nb, len(ineq_idx)))
    G[ineq_idx, np.arange(len(ineq_idx))] = 1.0
    return torch.as_tensor(G, dtype=z_lo0.dtype, device=z_lo0.device)


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

    # on the device once: c() runs inside every step (and a captured one)
    slack_scatter = _slack_scatter(nlp)

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
            G = slack_scatter.to(dtype=v.dtype, device=v.device)
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


def closed_form_blocks(nlp: CollocationNLP) -> bool:
    """Whether the collocation node blocks of ``nlp`` go through the kernel
    K9 (``ops/nodekern.py``) and not the ``torch.func`` transforms: its
    Jacobians are exact and its wind affine in position
    (``affine_wind_model``) or the gridded field at order 2
    (``grid_wind``), and its tensors live on CUDA.  A solver decides once,
    when it is built."""
    return ((nlp.affine_wind_model is not None or nlp.grid_wind)
            and nlp.inst0.z_lo.device.type == "cuda")


def kernel_args(can: CanonicalNLP):
    """``args(inst) -> (par, field)``, what a K9 launch on ``can.nlp`` reads
    beside the nodes: the airframe and the variable scales (``can.scaling``,
    all 1 unscaled) on the device; the air, gravity and the affine wind
    (``models/wind.affine_wind``) on the host, or under the gridded field
    the Instance's grid on the device (``nodekern.grid_field``)."""
    sc = can.scaling if can.scaling is not None else unit_scaling(can.nlp)
    d_z, d_dt = sc.d_z, sc.d_dt
    model = can.nlp.affine_wind_model

    def wind(inst):
        if model is not None:
            return nodekern.field(*affine_wind(dataclasses.replace(
                inst.wind, model=model)))
        if int(inst.wind.order) != 2 or inst.wind.grid is None:
            raise ValueError("the problem was built for the gridded field "
                             "at order 2; the Instance's wind is not")
        return nodekern.grid_field(inst.wind)

    def args(inst):
        return nodekern.params(inst.aircraft, d_z, d_dt), wind(inst)
    return args


def defect_jac_transforms(nlp: CollocationNLP):
    """``defect_jac(z_i, z_ip1, dt, inst)``: (N, 11), (N, 11), (N,) ->
    dDefect/dz_i (N, 8, 11), dDefect/ddt (N, 8), by one forward-mode pass
    over a replica axis (:func:`jacfwd_lanes`)."""
    def defect_jac(z_i, z_ip1, dt, inst):
        J = jacfwd_lanes(lambda u: nlp.defect(u[..., :NUM_VARS], z_ip1,
                                              u[..., NUM_VARS], inst),
                         torch.cat([z_i, dt[:, None]], dim=1))
        return J[..., :NUM_VARS], J[..., NUM_VARS]
    return defect_jac


def constraint_jac_blocks(can: CanonicalNLP):
    """The collocation constraint Jacobian's blocks of ``can.nlp``, all
    lanes (and nodes) at once.  Returns (defect_jac, bnd_jac):

    ``defect_jac(Z, dt, inst)``: Z (B, T+1, 11), dt (B,) -> the defects'
    blocks dDefect_i/dz_i (B, T, 8, 11) and dDefect_i/ddt (B, T, 8), by K9
    where :func:`closed_form_blocks` holds, else by
    :func:`defect_jac_transforms`; the recorder's counter
    ``kkt.node_blocks.kernel`` or ``kkt.node_blocks.transforms`` adds the
    B * T nodes.

    ``bnd_jac(z0, zT, dt, inst)``: (B, 11), (B, 11), (B,) -> the boundary
    Jacobian blocks G0, GT, Gdt, by one forward-mode pass."""
    nlp = can.nlp
    T = nlp.T
    if closed_form_blocks(nlp):
        args = kernel_args(can)

        def defect_jac(Z, dt, inst):
            count("kkt.node_blocks.kernel", Z.shape[0] * T)
            return nodekern.defect_blocks(Z, dt, *args(inst))
    else:
        flat = defect_jac_transforms(nlp)

        def defect_jac(Z, dt, inst):
            B = Z.shape[0]
            count("kkt.node_blocks.transforms", B * T)
            A, d = flat(Z[:, :-1].reshape(-1, NUM_VARS),
                        Z[:, 1:].reshape(-1, NUM_VARS),
                        dt[:, None].expand(B, T).reshape(-1), inst)
            return A.reshape(B, T, NUM_STATES, NUM_VARS), d.reshape(
                B, T, NUM_STATES)

    def bnd_jac(z0, zT, dt, inst):
        J = jacfwd_lanes(lambda u: nlp.boundary(u[..., :NUM_VARS],
                                                u[..., NUM_VARS:2 * NUM_VARS],
                                                u[..., 2 * NUM_VARS], inst),
                         torch.cat([z0, zT, dt[:, None]], dim=1))
        return (J[..., :NUM_VARS], J[..., NUM_VARS:2 * NUM_VARS],
                J[..., 2 * NUM_VARS])
    return defect_jac, bnd_jac


def constraint_jacobian(can: CanonicalNLP):
    """``J = dc/dv`` of ``can`` from its collocation blocks: returns
    ``at(v, inst) -> (jv, jtv)``, the products ``J t`` (B, n) -> (B, m) and
    ``J^T y`` (B, m) -> (B, n) at the lanes ``v`` (B, n).

    Defect row block k is ``A_k dz_k + d_k ddt + dz_{k+1}[:8]`` (a defect
    is ``z_{k+1}[:8] - ...``, its rows scaled by the states' own scales,
    so its derivative in z_{k+1} is [I 0]); the boundary rows take
    ``G0 dz_0 + GT dz_T + Gdt ddt + Gs ds``, Gs the fixed slack scatter.
    The blocks are taken once per call of ``at``; each product is then a
    broadcast multiply and a sum over the block axis, so it stays in the
    lanes' precision (no matrix-multiply library, no TF32)."""
    nlp = can.nlp
    T, NS, NV = nlp.T, NUM_STATES, NUM_VARS
    nz = 1 + (T + 1) * NV
    defect_jac, bnd_jac = constraint_jac_blocks(can)
    Gs_dev = _slack_scatter(nlp)

    def at(v, inst):
        B = v.shape[0]
        Z, dt, _ = can.split(v)
        A, d = defect_jac(Z, dt, inst)
        G0, GT, Gdt = bnd_jac(Z[:, 0], Z[:, -1], dt, inst)
        Gs = Gs_dev.to(dtype=v.dtype, device=v.device)
        # the boundary rows against [dt, z_0, z_T, s]
        Gb = torch.cat([Gdt[..., None], G0, GT,
                        Gs.expand(B, *Gs.shape)], dim=2)

        def jv(t):
            tZ = t[:, 1:nz].reshape(B, T + 1, NV)
            tdt = t[:, :1]
            c_d = ((A * tZ[:, :-1, None, :]).sum(-1) + tZ[:, 1:, :NS]
                   + d * tdt[..., None])
            t_b = torch.cat([tdt, tZ[:, 0], tZ[:, T], t[:, nz:]], dim=1)
            c_b = (Gb * t_b[:, None, :]).sum(-1)
            return torch.cat([c_d.reshape(B, -1), c_b], dim=1)

        def jtv(y):
            y_d = y[:, :NS * T].reshape(B, T, NS)
            g_b = (Gb * y[:, NS * T:, None]).sum(1)     # [dt, z_0, z_T, s]
            gZ = torch.zeros(B, T + 1, NV, dtype=v.dtype, device=v.device)
            gZ[:, :-1] = (A * y_d[..., None]).sum(2)
            gZ[:, 1:, :NS] += y_d
            gZ[:, 0] += g_b[:, 1:1 + NV]
            gZ[:, T] += g_b[:, 1 + NV:1 + 2 * NV]
            g_dt = (d * y_d).sum((1, 2)) + g_b[:, 0]
            return torch.cat([g_dt[:, None], gZ.reshape(B, -1),
                              g_b[:, 1 + 2 * NV:]], dim=1)
        return jv, jtv
    return at
