"""Seed-trajectory generation (port of ``tol_tpu/problems/seed.py``).

An analytic path (position, velocity, acceleration at the ts+1 nodes) is
mapped to node decision variables by flight-mechanics inversion under zero
wind.  The zoom seed's derivatives come from ``torch.func``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.func import grad, jacfwd, vmap

from tol_tpu_torch.config import GRAVITY, RHO, AircraftParams


class SeedPath(NamedTuple):
    pos: torch.Tensor         # (N, 3) NED
    vel: torch.Tensor
    acc: torch.Tensor
    dt: torch.Tensor          # scalar time step
    chi_offset: torch.Tensor  # added to the raw course before unwrap


def _unwrap(p: torch.Tensor) -> torch.Tensor:
    """``numpy.unwrap`` along axis 0 with period 2*pi."""
    period = 2.0 * math.pi
    interval = period / 2
    dd = torch.diff(p)
    ddmod = torch.remainder(dd + interval, period) - interval
    ddmod = torch.where((ddmod == -interval) & (dd > 0),
                        torch.full_like(ddmod, interval), ddmod)
    ph_correct = torch.where(dd.abs() < interval, torch.zeros_like(dd),
                             ddmod - dd)
    return torch.cat([p[:1], p[1:] + torch.cumsum(ph_correct, 0)])


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``numpy.interp`` (clamped at both ends) for increasing ``xp``."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    f = fp[i - 1] + (delta / dx) * df
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def invert_flight_mechanics(path: SeedPath, ac: AircraftParams,
                            periodic_rates: bool):
    """Recover ``(Z (N, 11), dt)`` from an analytic path.  ``periodic_rates``
    back-fills node-0 dphi/dCL with the final node's values (S10)."""
    v = path.vel
    speed = torch.linalg.vector_norm(v, dim=1)
    Va = speed
    chi_raw = torch.atan2(v[:, 1], v[:, 0]) + path.chi_offset
    gam = torch.atan2(-v[:, 2], torch.linalg.vector_norm(v[:, :2], dim=1))
    chi = _unwrap(chi_raw)

    r1 = v / speed[:, None]
    gvec = torch.tensor([0.0, 0.0, GRAVITY], dtype=v.dtype, device=v.device)
    a_rel = path.acc - gvec
    along = torch.sum(r1 * a_rel, dim=1)
    an = a_rel - r1 * along[:, None]
    mag_an = torch.linalg.vector_norm(an, dim=1)
    r3 = -an / mag_an[:, None]
    r2_3 = r3[:, 0] * r1[:, 1] - r3[:, 1] * r1[:, 0]
    phi = torch.atan2(r2_3, r3[:, 2])

    L = ac.mm * mag_an
    CL = 2.0 * L / (RHO * Va * Va * ac.SS)
    D = 0.5 * RHO * Va * Va * ac.SS * (ac.Cd0 + CL * CL / (math.pi * ac.AR * ac.ee))
    T = ac.mm * along + D

    dphi = torch.diff(phi) / path.dt
    dCL = torch.diff(CL) / path.dt
    if periodic_rates:
        first_dphi, first_dCL = dphi[-1:], dCL[-1:]
    else:
        first_dphi = torch.zeros(1, dtype=v.dtype, device=v.device)
        first_dCL = torch.zeros(1, dtype=v.dtype, device=v.device)
    dphi = torch.cat([first_dphi, dphi])
    dCL = torch.cat([first_dCL, dCL])

    Z = torch.cat([path.pos, torch.stack([Va, gam, chi, phi, CL, dphi, dCL, T],
                                         dim=1)], dim=1)
    return Z, path.dt


def g7_seed_path(ts: int, chi_d, vamin=None, vamax=None, dtype=torch.float64,
                 device=None) -> SeedPath:
    """Straight-line seed rotated to the goal course ``chi_d``: 40 m flown
    at 4 m/s, or with the airframe's speed limits at a speed clamped into
    [1.1 vamin, 0.9 vamax] (positions rotated by chi_d, velocities
    unrotated with chi_d added to the course)."""
    tt = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    x_amp = 40.0
    speed = tt(4.0)
    if vamin is not None:
        speed = torch.maximum(speed, 1.1 * tt(vamin))
    if vamax is not None:
        speed = torch.minimum(speed, 0.9 * tt(vamax))
    chi_d = tt(chi_d)
    tfinal = x_amp / speed
    dt = tfinal / ts
    t = torch.arange(ts + 1, dtype=dtype, device=device) * dt
    xs = speed * t
    zero = torch.zeros_like(t)
    pos = torch.stack([xs * torch.cos(chi_d), xs * torch.sin(chi_d), zero],
                      dim=1)
    vel = torch.stack([speed * torch.ones_like(t), zero, zero], dim=1)
    return SeedPath(pos=pos, vel=vel, acc=torch.zeros_like(pos), dt=dt,
                    chi_offset=chi_d)


def s10_zoom_seed_path(ts: int, aircraft: AircraftParams,
                       dtype=torch.float64, phase: float = 0.5 * math.pi,
                       radius: float = 100.0, device=None) -> SeedPath:
    """Energy-exchange ("zoom") loiter seed: speed trades against altitude
    around the ring (see the JAX module for the derivation)."""
    tt = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    R = tt(radius)
    g = tt(GRAVITY)
    v_c = torch.sqrt(g * torch.tan(0.9 * tt(aircraft.phimax)) * R)
    v_c = torch.clamp(v_c, 1.1 * tt(aircraft.Vamin), 0.9 * tt(aircraft.Vamax))
    v_max = 0.9 * tt(aircraft.Vamax)
    dv = torch.clamp(v_max - v_c, min=0.0)

    def V(th):
        return v_c + dv * (1.0 + torch.cos(th)) / 2.0

    def z(th):
        return -(v_max ** 2 - V(th) ** 2) / (2.0 * g)

    def thetadot(th):
        dzdth = grad(z)(th)
        zdot0 = dzdth * V(th) / R
        v_h = torch.sqrt(torch.maximum(V(th) ** 2 - zdot0 ** 2,
                                       (0.5 * V(th)) ** 2))
        return v_h / R

    def pos(th):
        return torch.stack([R * torch.sin(th + phase) - R * math.sin(phase),
                            -R * torch.cos(th + phase) + R * math.cos(phase),
                            z(th)])

    fine = 32 * ts
    th_f = torch.linspace(0.0, 2.0 * math.pi, fine + 1, dtype=dtype,
                          device=device)
    inv_rate = 1.0 / vmap(thetadot)(th_f)
    seg = 0.5 * (inv_rate[1:] + inv_rate[:-1]) * (th_f[1] - th_f[0])
    t_f = torch.cat([torch.zeros(1, dtype=dtype, device=device),
                     torch.cumsum(seg, 0)])
    dt = t_f[-1] / ts
    t_nodes = torch.arange(ts + 1, dtype=dtype, device=device) * dt
    th_nodes = _interp(t_nodes, t_f, th_f)

    dpos = vmap(jacfwd(pos))(th_nodes).to(dtype)
    d2pos = vmap(jacfwd(jacfwd(pos)))(th_nodes).to(dtype)
    thd = vmap(thetadot)(th_nodes)
    dthd = vmap(grad(thetadot))(th_nodes)
    vel = dpos * thd[:, None]
    acc = (d2pos * thd[:, None] + dpos * dthd[:, None]) * thd[:, None]
    return SeedPath(pos=vmap(pos)(th_nodes), vel=vel, acc=acc, dt=dt,
                    chi_offset=tt(0.0))


def s10_seed_path(ts: int, dtype=torch.float64, phase: float = 0.5 * math.pi,
                  aircraft=None, radius: float = 100.0, device=None) -> SeedPath:
    """Circular loiter seed; with ``aircraft`` the circle speed is the
    coordinated-turn speed ``sqrt(g tan(0.9 phimax) R)`` clamped into
    [1.1 Vamin, 0.9 Vamax]."""
    tt = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    amp = radius
    if aircraft is not None:
        v_turn = torch.sqrt(GRAVITY * torch.tan(0.9 * tt(aircraft.phimax)) * amp)
        speed = torch.clamp(v_turn, 1.1 * tt(aircraft.Vamin),
                            0.9 * tt(aircraft.Vamax))
        tfinal = 2.0 * math.pi * amp / speed
    else:
        tfinal = tt(20.0)
    dt = tt(tfinal / ts)
    t = torch.arange(ts + 1, dtype=dtype, device=device) * dt
    w = 2.0 * math.pi / tfinal
    th = w * t + phase
    xs = amp * torch.sin(th) - amp
    ys = -amp * torch.cos(th)
    zero = torch.zeros_like(t)
    pos = torch.stack([xs, ys, zero], dim=1)
    vel = torch.stack([w * amp * torch.cos(th), w * amp * torch.sin(th), zero],
                      dim=1)
    acc = torch.stack([-w * w * amp * torch.sin(th), w * w * amp * torch.cos(th),
                       zero], dim=1)
    return SeedPath(pos=pos, vel=vel, acc=acc, dt=dt, chi_offset=tt(0.0))
