"""Plain float64 reference of the S10 and G7 collocation NLPs.

It recomputes, from the frozen ``.param`` files under ``data/`` and the
upstream formulas, everything the benchmark's comparison needs to judge a
solve: the node boxes (with a replan's stitch box), the forward-Euler
dynamics defects under wind model 1, the boundary rows, the cost, the
canonical scaling the gate is stated in, and the gate itself.  It is plain
PyTorch on the CPU in float64, imports nothing of the system under test,
and takes nothing the system made: it reads the system's answers (scaled
decision vectors, or a leg's physical trajectory) only to judge them.

Decision vector, as the upstream NLP orders it: ``v = [dt, Z.flat, s]``,
``Z`` (T+1, 11) nodes ``x y z Va gam chi phi CL dphi dCL T`` (NED), ``s``
one slack per inequality boundary row.  The scaled vector is ``v / d``
with ``d = [d_dt, d_z (per node), r_b (inequality rows)]``; scaled rows
are defects / ``d_z[:8]`` and (boundary + slack) / ``r_b``; the scaled
cost is ``s_f`` times the physical one.
"""

from __future__ import annotations

import math
import os
import re

import numpy as np
import torch

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
GRAVITY = 9.81
RHO = 1.2682
NV, NS = 11, 8            # node variables, dynamic states
BIG = 1e19                # a bound beyond this is no bound
F64 = torch.float64

# Node-0 boxes of each mission (upstream src/problem.cpp:80-134):
# Va, gamma, chi, phi, CL, dphi, dCL (lower, upper); T unbounded above.
_BOXES = {
    "S10": [(4.0, 50.0), (0.0, 0.0), (-1.7453292519943296e18,
                                      1.7453292519943296e18),
            (-math.pi / 2, math.pi / 2), (-0.5, 3.0),
            (-3.4906585039886591, 3.4906585039886591), (-200.0, 200.0)],
    "G7": [(4.0, 50.0), (0.0, 0.0), (-1e20 * math.pi / 180.0,
                                     1e20 * math.pi / 180.0),
           (-math.pi / 2, math.pi / 2), (-0.5, 3.0),
           (-3.4906585039886591, 3.4906585039886591), (-200.0, 200.0)],
}
# A replan's node-0 slack around the previous leg's last node: Va, gam,
# chi, phi, CL, dphi, dCL, T (upstream msl/mission.py's stitch).
STITCH_SLACK = np.array([2.0, math.radians(10.0), math.pi, math.radians(10.0),
                         0.2, 1e3, 1e3, 5.0])
DEFAULT_GOAL = {"S10": (-100.0, 0.0, 0.0, 100.0), "G7": (0.0, 400.0, 0.0, 0.0)}
WIND_VREF, WIND_HREF = 2.4, 10.0   # wind model 1: the boundary layer


def read_param(path: str) -> list:
    """Numeric lines of a ``.param`` file: the leading float of the text
    before the first ``/`` (as ``std::stod`` reads it)."""
    num = re.compile(r"^\s*([+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)")
    out = []
    with open(path) as f:
        for line in f:
            m = num.match(line.split("/", 1)[0])
            if m:
                out.append(float(m.group(1)))
    return out


def aircraft(name: str) -> dict:
    v = read_param(os.path.join(DATA, "aircraft", name + ".param"))
    if len(v) != 15:
        raise ValueError(f"{name}.param: {len(v)} values, expected 15")
    deg = math.pi / 180.0
    keys = ("mm", "b", "SS", "ee", "AR", "Cd0", "CLmin", "CLmax", "phimax",
            "Vamin", "Vamax", "gammamax", "phidotmax", "Tmin", "Tmax")
    ac = dict(zip(keys, v))
    for k in ("phimax", "gammamax", "phidotmax"):
        ac[k] *= deg
    return ac


def mission(name: str) -> dict:
    d = os.path.join(DATA, "problems", name)
    g = read_param(os.path.join(d, "gains.param"))
    lm = read_param(os.path.join(d, "limits.param"))
    sn = read_param(os.path.join(d, "snopt.param"))
    return dict(gains=dict(zip(("kT", "kp", "kv", "ka", "kdt"), g)),
                limits=dict(zip(("dtmin", "dtmax", "xmin", "xmax", "ymin",
                                 "ymax", "zmin", "zmax"), lm)),
                ts=int(sn[0]), nb=int(sn[3]))


class Problem:
    """One instance: mission, airframe, goal ``(xg, yg, zg, rg)`` and an
    optional stitch (the previous leg's last node, 8 values Va..T).  A
    ``ts`` other than the mission's own rescales the dt box so that the
    total time budget ``ts * [dtmin, dtmax]`` holds (the test sizes).
    ``wind``: a configuration's wind settings; this reference knows wind
    model 1 alone (default: the upstream's ``vref``, ``href``)."""

    def __init__(self, mission_name: str, airframe: str, goal=None,
                 stitch=None, ts=None, wind=None):
        wind = dict(wind or {"model": 1})
        if wind.pop("model") != 1 or set(wind) - {"vref", "href"}:
            raise NotImplementedError(f"wind {wind}: this reference knows model 1")
        self.vref = float(wind.get("vref", WIND_VREF))
        self.href = float(wind.get("href", WIND_HREF))
        md = mission(mission_name)
        self.mission = mission_name
        self.ac = aircraft(airframe)
        self.gains, self.limits, self.T, self.nb = (md["gains"], md["limits"],
                                                    md["ts"], md["nb"])
        if ts is not None and ts != self.T:
            k = self.T / ts
            self.limits = {**self.limits, "dtmin": self.limits["dtmin"] * k,
                           "dtmax": self.limits["dtmax"] * k}
            self.T = ts
        self.goal = tuple(float(x) for x in (goal or DEFAULT_GOAL[mission_name]))
        self.ineq = np.zeros(self.nb, dtype=bool)
        if mission_name == "G7":
            self.ineq[[1, -1]] = True
        self.n_slack = int(self.ineq.sum())
        self.stitch = None if stitch is None else np.asarray(stitch, float)

    def node_boxes(self):
        """(T+1, 11) lower and upper boxes: node 0 pinned at the origin with
        the mission's boxes (or the stitch box), nodes >= 1 the airframe's
        and the limits'."""
        ac, lm = self.ac, self.limits
        bx = _BOXES[self.mission]
        lo0 = [0.0, 0.0, 0.0] + [b[0] for b in bx] + [0.0]
        up0 = [0.0, 0.0, 0.0] + [b[1] for b in bx] + [1e20]
        lo = [lm["xmin"], lm["ymin"], lm["zmin"], ac["Vamin"],
              -ac["gammamax"], -1e20, -ac["phimax"], ac["CLmin"],
              -ac["phidotmax"], -ac["phidotmax"], ac["Tmin"]]
        up = [lm["xmax"], lm["ymax"], lm["zmax"], ac["Vamax"], ac["gammamax"],
              1e20, ac["phimax"], ac["CLmax"], ac["phidotmax"],
              ac["phidotmax"], ac["Tmax"]]
        zl = np.array([lo0] + [lo] * self.T)
        zu = np.array([up0] + [up] * self.T)
        if self.stitch is not None:
            zl[0, 3:] = np.clip(self.stitch - STITCH_SLACK, zl[1, 3:], zu[1, 3:])
            zu[0, 3:] = np.clip(self.stitch + STITCH_SLACK, zl[1, 3:], zu[1, 3:])
        return zl, zu

    def bounds(self):
        """Physical bounds of the whole decision vector (n,)."""
        zl, zu = self.node_boxes()
        lm = self.limits
        lo = np.concatenate([[lm["dtmin"]], zl.ravel(), np.zeros(self.n_slack)])
        up = np.concatenate([[lm["dtmax"]], zu.ravel(),
                             np.full(self.n_slack, 1e20)])
        return torch.as_tensor(lo, dtype=F64), torch.as_tensor(up, dtype=F64)

    # ---- the NLP's functions, on (..., T+1, 11) nodes and (...) dt ----

    def wind(self, p):
        """Wind model 1 in NED and its gradient dW_i/dp_j: a northward
        wind growing linearly with depth, ``Wx = vref * z / href``."""
        zero = torch.zeros_like(p[..., 2])
        w = torch.stack([self.vref * p[..., 2] / self.href, zero, zero], -1)
        gw = torch.zeros(3, 3, dtype=p.dtype, device=p.device)
        gw[0, 2] = self.vref / self.href
        return w, gw.expand(*p.shape, 3)

    def state_rates(self, z):
        """(..., 8) rates of x y z Va gam chi phi CL (the upstream 3-D
        point-mass model in wind)."""
        ac = self.ac
        Va, gam, chi, phi, CL = (z[..., k] for k in range(3, 8))
        dphi, dCL, T = z[..., 8], z[..., 9], z[..., 10]
        w, gw = self.wind(z[..., 0:3])
        cg, sg, cc, sc = torch.cos(gam), torch.sin(gam), torch.cos(chi), torch.sin(chi)
        e_a = torch.stack([cc * cg, sc * cg, -sg], -1)
        e_g = torch.stack([cc * sg, sc * sg, cg], -1)
        e_c = torch.stack([-sc, cc, torch.zeros_like(sc)], -1)
        vg = w + Va[..., None] * e_a
        wdot = (gw * vg[..., None, :]).sum(-1)
        q = 0.5 * RHO * ac["SS"] * Va * Va
        L = q * CL
        D = q * (ac["Cd0"] + CL * CL / (math.pi * ac["AR"] * ac["ee"]))
        Va_dot = T / ac["mm"] - GRAVITY * sg - D / ac["mm"] - (e_a * wdot).sum(-1)
        gam_dot = (L * torch.cos(phi) / ac["mm"] - GRAVITY * cg
                   + (e_g * wdot).sum(-1)) / Va
        chi_dot = (L * torch.sin(phi) / ac["mm"] - (e_c * wdot).sum(-1)) / (Va * cg)
        return torch.stack([vg[..., 0], vg[..., 1], vg[..., 2], Va_dot,
                            gam_dot, chi_dot, dphi, dCL], -1)

    def defects(self, Z, dt):
        """(..., T, 8) forward-Euler defects."""
        zi, zj = Z[..., :-1, :], Z[..., 1:, :]
        return zj[..., :NS] - self.state_rates(zi) * dt[..., None, None] - zi[..., :NS]

    def boundary(self, z0, zT, dt):
        """(..., nb) boundary rows (inequality rows are <= 0)."""
        xg, yg = self.goal[0], self.goal[1]
        if self.mission == "S10":
            off = torch.zeros(NV, dtype=z0.dtype, device=z0.device)
            off[5] = 2.0 * math.pi
            return zT - z0 - off
        chi_d = math.atan2(yg, xg)
        dx, dy = zT[..., 0] - z0[..., 0], zT[..., 1] - z0[..., 1]
        dist = torch.sqrt(dx * dx + dy * dy)
        dmax = torch.sqrt((xg - z0[..., 0]) ** 2 + (yg - z0[..., 1]) ** 2)
        rows = [-dx * math.sin(chi_d) + dy * math.cos(chi_d),
                -(dx * math.cos(chi_d) + dy * math.sin(chi_d))]
        rows += [zT[..., k] - z0[..., k] for k in range(2, NV)]
        rows.append(dist - dmax)
        return torch.stack(rows, -1)

    def cost(self, Z, dt):
        """(...) physical cost.  S10: 0.5 kT sum T^2 + 0.5 kp sum (r - R)^2
        + kdt dt; G7: 0.5 kT sum T^2 + kv ts dt / dist."""
        g = self.gains
        xg, yg, _, rg = self.goal
        F = 0.5 * g["kT"] * (Z[..., 10] ** 2).sum(-1)
        if self.mission == "S10":
            r = torch.sqrt((Z[..., 0] - xg) ** 2 + (Z[..., 1] - yg) ** 2)
            return F + 0.5 * g["kp"] * ((r - rg) ** 2).sum(-1) + g["kdt"] * dt
        dist = torch.sqrt((Z[..., -1, 0] - Z[..., 0, 0]) ** 2
                          + (Z[..., -1, 1] - Z[..., 0, 1]) ** 2)
        return F + g["kv"] * self.T * dt / dist

    # ---- the seed trajectory, which the scaling is taken at ----

    def seed(self):
        """(Z (T+1, 11), dt): the upstream analytic seed path (S10 a
        coordinated-turn circle of radius 100 m, G7 a 40 m straight line
        along the goal course) through flight-mechanics inversion."""
        ac, T = self.ac, self.T
        t_ = lambda x: torch.as_tensor(x, dtype=F64)
        if self.mission == "S10":
            R = 100.0
            v_turn = math.sqrt(GRAVITY * math.tan(0.9 * ac["phimax"]) * R)
            speed = min(max(v_turn, 1.1 * ac["Vamin"]), 0.9 * ac["Vamax"])
            tf = 2.0 * math.pi * R / speed
            dt = tf / T
            t = torch.arange(T + 1, dtype=F64) * dt
            w = 2.0 * math.pi / tf
            th = w * t + 0.5 * math.pi
            zero = torch.zeros_like(t)
            pos = torch.stack([R * torch.sin(th) - R, -R * torch.cos(th), zero], 1)
            vel = torch.stack([w * R * torch.cos(th), w * R * torch.sin(th), zero], 1)
            acc = torch.stack([-w * w * R * torch.sin(th),
                               w * w * R * torch.cos(th), zero], 1)
            chi_off, periodic = 0.0, True
        else:
            chi_d = math.atan2(self.goal[1], self.goal[0])
            speed = min(max(4.0, 1.1 * ac["Vamin"]), 0.9 * ac["Vamax"])
            dt = 40.0 / speed / T
            t = torch.arange(T + 1, dtype=F64) * dt
            xs = speed * t
            zero = torch.zeros_like(t)
            pos = torch.stack([xs * math.cos(chi_d), xs * math.sin(chi_d), zero], 1)
            vel = torch.stack([speed + zero, zero, zero], 1)
            acc = torch.zeros_like(pos)
            chi_off, periodic = chi_d, False
        Va = torch.linalg.vector_norm(vel, dim=1)
        chi = torch.as_tensor(np.unwrap((torch.atan2(vel[:, 1], vel[:, 0])
                                         + chi_off).numpy()))
        gam = torch.atan2(-vel[:, 2], torch.linalg.vector_norm(vel[:, :2], dim=1))
        r1 = vel / Va[:, None]
        a_rel = acc - t_([0.0, 0.0, GRAVITY])
        along = (r1 * a_rel).sum(1)
        an = a_rel - r1 * along[:, None]
        mag = torch.linalg.vector_norm(an, dim=1)
        r3 = -an / mag[:, None]
        phi = torch.atan2(r3[:, 0] * r1[:, 1] - r3[:, 1] * r1[:, 0], r3[:, 2])
        CL = 2.0 * ac["mm"] * mag / (RHO * Va * Va * ac["SS"])
        D = 0.5 * RHO * Va * Va * ac["SS"] * (ac["Cd0"] + CL * CL
                                              / (math.pi * ac["AR"] * ac["ee"]))
        Tr = ac["mm"] * along + D
        dphi, dCL = torch.diff(phi) / dt, torch.diff(CL) / dt
        first = (dphi[-1:], dCL[-1:]) if periodic else (t_([0.0]), t_([0.0]))
        dphi, dCL = torch.cat([first[0], dphi]), torch.cat([first[1], dCL])
        Z = torch.cat([pos, torch.stack([Va, gam, chi, phi, CL, dphi, dCL, Tr], 1)], 1)
        return Z, t_(dt)


class Scaling:
    """The canonical scaling, worked out from the default instance as the
    upstream canonicalization states it: per-kind variable scales, the dt
    scale, boundary-row norms of the scaled Jacobian at a seed perturbed by
    ``torch.Generator`` seed 0 noise, and the cost factor from the seed's
    scaled gradient."""

    def __init__(self, prob: Problem):
        ac = prob.ac
        pos = max(prob.goal[3], 100.0)
        self.d_z = torch.tensor([pos, pos, pos, ac["Vamax"] / 2.0,
                                 ac["gammamax"], 3.0, ac["phimax"],
                                 max(abs(ac["CLmax"]), 0.5), ac["phidotmax"],
                                 ac["phidotmax"], max(ac["Tmax"] / 4.0, 1.0)],
                                dtype=F64)
        self.d_dt = 0.5 * (prob.limits["dtmin"] + prob.limits["dtmax"])
        Z0, dt0 = prob.seed()
        noise = torch.randn(2 * NV + 1, generator=torch.Generator().manual_seed(0),
                            dtype=F64)
        z0p = Z0[0] + 0.1 * self.d_z * noise[:NV]
        zTp = Z0[-1] + 0.1 * self.d_z * noise[NV:2 * NV]
        dtp = dt0 * (1.0 + 0.05 * noise[-1])
        G0, GT, Gdt = torch.autograd.functional.jacobian(
            prob.boundary, (z0p, zTp, dtp))
        row = torch.sqrt(((G0 * self.d_z) ** 2).sum(-1)
                         + ((GT * self.d_z) ** 2).sum(-1)
                         + (Gdt.reshape(-1) * self.d_dt) ** 2)
        self.r_b = row.clamp(1e-2, 1e6)
        gZ, gdt = torch.autograd.functional.jacobian(prob.cost, (Z0, dt0))
        g_inf = max(float((gZ * self.d_z).abs().max()), abs(float(gdt)) * self.d_dt)
        self.s_f = 1.0 / min(max(g_inf, 1.0), 1e12)
        self.n_slack = prob.n_slack
        self.ineq = prob.ineq
        self.T = prob.T

    def v_scale(self) -> torch.Tensor:
        return torch.cat([torch.tensor([self.d_dt], dtype=F64),
                          self.d_z.repeat(self.T + 1), self.r_b[self.ineq]])


def split(v, T):
    Z = v[..., 1:1 + (T + 1) * NV].reshape(*v.shape[:-1], T + 1, NV)
    return Z, v[..., 0], v[..., 1 + (T + 1) * NV:]


def judge_scaled(prob: Problem, sc: Scaling, v_scaled) -> dict:
    """Judge scaled decision vectors (B, n) of ``prob``: the scaled
    violation (rows and bounds, inf-norm), the scaled and physical cost."""
    v = torch.as_tensor(np.asarray(v_scaled), dtype=F64) * sc.v_scale()
    Z, dt, s = split(v, prob.T)
    rows = _scaled_rows(prob, sc, Z, dt, s)
    lo, up = prob.bounds()
    F = prob.cost(Z, dt)
    return dict(viol=torch.maximum(rows, _bound_excess(v, lo, up, sc.v_scale())),
                row_viol=rows, F=F, f=sc.s_f * F)


def judge_physical(prob: Problem, sc: Scaling, Z, dt) -> dict:
    """Judge one physical trajectory ``Z`` (T+1, 11), ``dt`` with no slack
    (a mission leg's document): inequality rows count only above 0."""
    Z = torch.as_tensor(np.asarray(Z), dtype=F64)[None]
    dt = torch.as_tensor([float(dt)], dtype=F64)
    s = torch.clamp(-prob.boundary(Z[:, 0], Z[:, -1], dt)[:, prob.ineq], min=0.0)
    rows = _scaled_rows(prob, sc, Z, dt, s)
    v = torch.cat([dt[:, None], Z.reshape(1, -1), s], 1)
    lo, up = prob.bounds()
    F = prob.cost(Z, dt)
    return dict(viol=torch.maximum(rows, _bound_excess(v, lo, up, sc.v_scale()))[0],
                F=F[0], f=sc.s_f * F[0])


def _scaled_rows(prob, sc, Z, dt, s):
    d, b = _scaled_constraints(prob, sc, Z, dt, s)
    return torch.maximum(d.abs().flatten(-2).max(-1).values, b.abs().max(-1).values)


def _scaled_constraints(prob, sc, Z, dt, s):
    """Scaled defects (..., T, 8) and boundary rows (..., nb), each slack
    added to its inequality row."""
    dev = Z.device
    d = prob.defects(Z, dt) / sc.d_z[:NS].to(dev)
    E = torch.eye(prob.nb, dtype=F64, device=dev)[torch.as_tensor(prob.ineq, device=dev)]
    b = prob.boundary(Z[..., 0, :], Z[..., -1, :], dt) + s @ E
    return d, b / sc.r_b.to(dev)


def _bound_excess(v, lo, up, scale):
    below = torch.where(lo > -BIG, lo - v, torch.zeros_like(v))
    above = torch.where(up < BIG, v - up, torch.zeros_like(v))
    return (torch.clamp(torch.maximum(below, above), min=0.0) / scale).max(-1).values


def golden_cost(prob: Problem, name: str) -> float:
    """Physical cost of a frozen reference point ``data/<name>``."""
    g = torch.as_tensor(np.load(os.path.join(DATA, name)), dtype=F64)
    Z, dt, _ = split(g[None], prob.T)
    return float(prob.cost(Z, dt)[0])


# ---- the KKT certificate, worked out again at an answer ----

S_MAX = 100.0    # multiplier scaling threshold of the certificate (IPOPT's s_max)
FITS = 48        # most least-squares fits of the multipliers, each side from the last


def certificate(prob: Problem, sc: Scaling, v_scaled, device="cpu",
                block: int = 128) -> np.ndarray:
    """Each answer's KKT error as the certificate states it, with the
    reference's own multipliers: (B,) for scaled decision vectors (B, n).

    At the answer the reference takes the scaled cost gradient ``g`` and
    the scaled constraint Jacobian ``J`` in float64 (forward mode through
    its own rows).  A variable at scaled distance ``d`` from the bound
    that its residual ``r = g + J^T y`` pushes against may take a bound
    multiplier ``z >= 0``; the best one, ``z = |r| / (1 + d)``, leaves
    ``|r| d / (1 + d)`` as both its stationarity and complementarity.  So
    the row multipliers ``y`` are the least squares of ``r`` with each
    variable weighted by ``d / sqrt(1 + d^2)`` (1 with no bound on that
    side), the side taken from the fit before: the first fit unweighted,
    then fits until no side changes (at most ``FITS``).  The error is the
    largest of the stationarity ``|r - z| / s_d`` and the complementarity
    ``z * d / s_c`` (``s_d``, ``s_c``: the multipliers' mean magnitudes
    over ``S_MAX``, at least 1), fixed variables left out."""
    vs = torch.as_tensor(np.asarray(v_scaled), dtype=F64)
    out = [_certificate_block(prob, sc, vs[i:i + block].to(device))
           for i in range(0, len(vs), block)]
    return torch.cat(out).cpu().numpy() if out else np.zeros(0)


def certificate_physical(prob: Problem, sc: Scaling, Z, dt, device="cpu") -> float:
    """:func:`certificate` of one physical trajectory with no slack (a
    mission leg's document); each slack sits where its row is tightest."""
    Z = torch.as_tensor(np.asarray(Z), dtype=F64)[None]
    dt = torch.as_tensor([float(dt)], dtype=F64)
    s = torch.clamp(-prob.boundary(Z[:, 0], Z[:, -1], dt)[:, prob.ineq], min=0.0)
    v = torch.cat([dt[:, None], Z.reshape(1, -1), s], 1)
    return float(certificate(prob, sc, v / sc.v_scale(), device)[0])


def _jacobian(prob: Problem, sc: Scaling, vs):
    """Scaled cost gradient (B, n) and constraint Jacobian (B, m, n)."""
    from torch.func import grad, jacfwd, vmap

    dev, T, B, n = vs.device, prob.T, vs.shape[0], vs.shape[1]
    nb = prob.nb
    scale = sc.v_scale().to(dev)
    v = vs * scale
    Z, dt, _ = split(v, T)
    m = T * NS + nb
    J = torch.zeros(B, m, n, dtype=F64, device=dev)
    zi = Z[:, :-1].reshape(-1, NV)
    A = vmap(jacfwd(prob.state_rates))(zi).reshape(B, T, NS, NV)
    eye = torch.eye(NS, NV, dtype=F64, device=dev)
    rows = (torch.arange(T, device=dev)[:, None] * NS
            + torch.arange(NS, device=dev))[:, :, None]
    cols = (1 + torch.arange(T, device=dev)[:, None] * NV
            + torch.arange(NV, device=dev))[:, None, :]
    J[:, rows, cols] = -eye - dt[:, None, None, None] * A
    J[:, rows, cols + NV] = eye.expand(B, T, NS, NV)
    J[:, rows[..., 0], 0] = -prob.state_rates(Z[:, :-1])
    b0, bT, bdt = vmap(jacfwd(prob.boundary, argnums=(0, 1, 2)))(Z[:, 0], Z[:, -1], dt)
    brow = T * NS + torch.arange(nb, device=dev)
    J[:, brow, 1:1 + NV] = b0
    J[:, brow, 1 + T * NV:1 + (T + 1) * NV] = bT
    J[:, brow, 0] = bdt
    for j, r in enumerate(np.flatnonzero(prob.ineq)):
        J[:, T * NS + r, 1 + (T + 1) * NV + j] = 1.0
    row_scale = torch.cat([sc.d_z[:NS].repeat(T), sc.r_b]).to(dev)
    J = J * scale / row_scale[:, None]

    def cost(v1):
        Z1, dt1, _ = split(v1, T)
        return prob.cost(Z1, dt1)
    g = sc.s_f * vmap(grad(cost))(v) * scale
    return g, J


def _certificate_block(prob: Problem, sc: Scaling, vs) -> torch.Tensor:
    dev = vs.device
    g, J = _jacobian(prob, sc, vs)
    lo, up = (b.to(dev) for b in prob.bounds())
    scale = sc.v_scale().to(dev)
    fixed = lo == up
    has_lo, has_up = (lo > -BIG) & ~fixed, (up < BIG) & ~fixed
    d_lo = torch.where(has_lo, (vs - lo / scale).clamp(min=0.0), torch.inf)
    d_up = torch.where(has_up, (up / scale - vs).clamp(min=0.0), torch.inf)
    w, side = (~fixed).to(F64).expand_as(vs), None
    for _ in range(FITS):
        y = _least_squares(J, g, w)
        r = g + (J.transpose(1, 2) @ y[..., None])[..., 0]
        if side is not None and torch.equal(side, r > 0):
            break
        side = r > 0
        dist = torch.where(side, d_lo, d_up)        # the side r pushes against
        w = torch.where(fixed, 0.0, torch.where(
            torch.isfinite(dist), dist / torch.sqrt(1.0 + dist * dist), 1.0))
    z = torch.where(torch.isfinite(dist) & ~fixed, r.abs() / (1.0 + dist), 0.0)
    n_b = int(has_lo.sum() + has_up.sum())
    s_d = torch.clamp((y.abs().sum(-1) + z.sum(-1)) / max(J.shape[1] + n_b, 1),
                      min=S_MAX) / S_MAX
    s_c = torch.clamp(z.sum(-1) / max(n_b, 1), min=S_MAX) / S_MAX
    stat = torch.where(fixed, 0.0, r.abs() - z).amax(-1) / s_d
    comp = torch.where(z > 0, z * dist, 0.0).amax(-1) / s_c
    return torch.maximum(stat, comp)


def _least_squares(J, g, w):
    """Row multipliers minimising ``|w * (g + J^T y)|`` (normal
    equations, a trace-relative ridge of 1e-12)."""
    Jf = J * w[:, None, :]
    M = Jf @ Jf.transpose(1, 2)
    ridge = 1e-12 * M.diagonal(dim1=1, dim2=2).mean(-1).clamp(min=1.0)
    M = M + ridge[:, None, None] * torch.eye(M.shape[-1], dtype=F64, device=M.device)
    rhs = -(Jf @ (g * w)[..., None])
    return torch.cholesky_solve(rhs, torch.linalg.cholesky(M))[..., 0]
