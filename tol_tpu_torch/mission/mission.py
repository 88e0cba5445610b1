"""Receding-horizon mission orchestrator (port of
``tol_tpu/mission/mission.py``; the reasons for each rule are given there).

Leg goals are expressed relative to the current aircraft position; a
final-goal radius turns the last leg into an S10 loiter; the mission is
complete at more than ``completion_fraction`` of the start-to-goal
distance.  Leg solves run in-process on the device the configuration
names (default: CUDA; raises without a GPU), and can warm-start from the
previous leg's solution of the same mission type.

A leg is solved either as one lane (``leg_ensemble=0``, with a cold retry
when a warm start does not converge) or as a seed ensemble of
``leg_ensemble`` lanes (:func:`build_seeds`) advanced in
``leg_chunk``-iteration slices until the first slice that ends with a
converged lane (:func:`pick_winner` chooses among them).  The ensemble's
noise comes from a ``torch.Generator`` seeded with the integer that the
JAX package turns into its PRNG key: the same distribution, other draws.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import torch

from tol_tpu_torch.mission.autopilot import Autopilot, FakeAutopilot, haversine_enu
from tol_tpu_torch.mission.trajectory import Trajectory


@dataclasses.dataclass
class MissionConfig:
    datum_lat: float = 40.1451       # Ka-1 radar datum (msl/msl.py:45)
    datum_lon: float = -105.2408
    datum_alt: float = 1676.0
    aircraft: str = "tempest"
    ts: int = 100
    wind_model: int = 1
    default_loiter_radius: float = 100.0
    completion_fraction: float = 0.95
    max_legs: int = 20
    warm_start: bool = True
    leg_tol: float = 5e-3        # working KKT tolerance per leg solve
    leg_feas_tol: float = 1e-4   # scaled feasibility per leg solve
    leg_max_iter: int = 400
    # wind model 3: a TOLWGRID file, re-read before every leg when
    # wind_refresh (live storm updates)
    wind_grid_path: Optional[str] = None
    wind_refresh: bool = False
    # seed-ensemble legs: lanes, iterations per slice (0 = one lane)
    leg_ensemble: int = 0
    leg_chunk: int = 48
    leg_chain: str = "cr"
    # where the legs are solved: None is the CUDA device (raises without
    # a GPU); float32 is the card's solve type
    device: Optional[str] = None
    dtype: torch.dtype = torch.float32


def build_seeds(can, inst, base_v, base_y, n_warm: int, E: int,
                gen: torch.Generator):
    """The ensemble's (E, n) seeds and (E, m) multipliers: lanes below
    ``n_warm`` start at ``base_v``/``base_y``, the rest at the cold seed with
    zero multipliers; every lane but 0 and ``n_warm`` gets 0.01 N(0, 1)
    noise drawn from ``gen``; then clipped to the bounds and the fixed
    entries set."""
    lb, ub, fixed = can.bounds(inst)
    seed0 = can.initial_point(inst)
    dev, dtype = seed0.device, seed0.dtype
    dv = 0.01 * torch.randn(E, can.n, generator=gen, dtype=dtype).to(dev)
    dv[0] = 0.0
    if n_warm < E:
        dv[n_warm] = 0.0
    warm = (torch.arange(E, device=dev) < n_warm)[:, None]
    v0s = torch.where(warm, base_v[None], seed0[None]) + dv
    v0s = torch.minimum(torch.maximum(v0s, lb[None]), ub[None])
    v0s = torch.where(fixed[None], lb[None], v0s)
    y0s = torch.where(warm, base_y[None],
                      torch.zeros(1, can.m, dtype=dtype, device=dev))
    return v0s, y0s


def pick_winner(out) -> int:
    """The lane with the least f among the converged ones, else the lane
    with the least constraint violation."""
    if bool(out.converged.any()):
        fs = torch.where(out.converged, out.f, torch.inf)
        return int(torch.argmin(fs))
    return int(torch.argmin(out.constr_viol))


def default_leg_solver(cfg: MissionConfig) -> Callable:
    """The in-process leg solver: (mission type, NED goal, stitch, v0) ->
    results document.  Problems are built once per mission type; later
    legs re-solve with new instance parameters (goal, stitch bounds, wind
    grid)."""
    from tol_tpu_torch.api import make_config, make_problem
    from tol_tpu_torch.io.results import results_document
    from tol_tpu_torch.models.wind import WindConfig
    from tol_tpu_torch.problems.base import make_instance, resolve_device
    from tol_tpu_torch.solver.alm import (ALMOptions, ALMParams, ProgramCache,
                                          solve as alm_solve)
    from tol_tpu_torch.solver.canonical import canonicalize
    from tol_tpu_torch.solver.kkt_condensed import make_condensed_kkt

    device = resolve_device(cfg.device)
    dtype = cfg.dtype
    cache: dict = {}
    warm: dict = {}   # mission_type -> (v, y, goal) of the last converged leg
    wind_cache: dict = {}
    leg_counter = [0]  # ensemble legs so far: the noise differs per leg
    # the step programs of every slice and leg (one per mission type and
    # lane count): a leg re-solves with new instance tensors, refilled
    programs = ProgramCache()

    def solve(*args, **kw):
        return alm_solve(*args, _programs=programs, **kw)

    def _wind_config() -> WindConfig:
        """This leg's wind; with wind_refresh the TOLWGRID file is re-read."""
        if cfg.wind_model == 3 and cfg.wind_grid_path:
            if cfg.wind_refresh or "grid" not in wind_cache:
                from tol_tpu_torch.io import native

                wind_cache["grid"] = native.read_wind_grid(
                    cfg.wind_grid_path, dtype=dtype, device=device)
            return WindConfig(model=3, grid=wind_cache["grid"])
        return WindConfig(model=cfg.wind_model)

    def solve_leg(mission_type: str, goal_ned, stitch=None, v0=None):
        wind_cfg = _wind_config()
        if mission_type not in cache:
            nlp = make_problem(mission_type, aircraft=cfg.aircraft,
                               ts=cfg.ts, wind_model=cfg.wind_model,
                               wind=wind_cfg, dtype=dtype, device=device)
            can = canonicalize(nlp, scaling="auto")
            kkt = make_condensed_kkt(can, refine=1, chain=cfg.leg_chain)
            pcfg = make_config(mission_type, cfg.aircraft, ts=cfg.ts,
                               wind_model=cfg.wind_model)
            opts = ALMOptions(tol=cfg.leg_tol, feas_tol=cfg.leg_feas_tol,
                              max_iter=cfg.leg_max_iter, gamma_init=0.01,
                              gamma_min=5e-6, gamma_shrink=0.2,
                              gamma_eager=True, mu_init=6e-5, mu_shrink=0.1,
                              kappa_inner=2.0, prox=2.5e-3, dual_refine_k=4)
            pbase = ALMParams.from_options(opts, dtype, device)
            cache[mission_type] = (can, kkt, opts, pbase, pcfg)
        can, kkt, opts, pbase, pcfg = cache[mission_type]
        inst = make_instance(pcfg, goal_ned, wind_cfg, dtype=dtype,
                             stitch=stitch, device=device)
        y0 = torch.zeros(can.m, dtype=dtype, device=device)
        used_warm = False
        if v0 is None:
            # Warm-start only a replan: a leg within 30 degrees of the
            # course of the leg that left the warm state.
            if cfg.warm_start and mission_type in warm:
                v_w, y_w, goal_w = warm[mission_type]
                d_chi = abs(math.atan2(float(goal_ned.yg), float(goal_ned.xg))
                            - math.atan2(float(goal_w.yg), float(goal_w.xg)))
                d_chi = min(d_chi, 2.0 * math.pi - d_chi)
                if d_chi < math.pi / 6.0:
                    v0, y0 = v_w, y_w
                    used_warm = True
            if v0 is None and cfg.leg_ensemble <= 0:
                v0 = can.initial_point(inst)
        budget = lambda it: pbase._replace(
            max_iter=torch.tensor(it, dtype=torch.int32, device=device))
        cold_retry = False
        winner = None
        t0 = time.time()
        if cfg.leg_ensemble > 0:
            E = cfg.leg_ensemble
            n_warm = E // 2 if used_warm else 1
            base = (torch.as_tensor(v0, dtype=dtype, device=device)
                    if v0 is not None
                    else torch.zeros(can.n, dtype=dtype, device=device))
            leg_counter[0] += 1
            gen = torch.Generator().manual_seed(leg_counter[0] * 7919 + E)
            v0s, y0s = build_seeds(can, inst, base, y0, n_warm, E, gen)
            it = min(cfg.leg_chunk, cfg.leg_max_iter)
            out = solve(can, kkt, opts, inst=inst, v0=v0s, y0=y0s,
                        params=budget(it), keep_state=True)
            while not bool(out.converged.any()) and it < cfg.leg_max_iter:
                it = min(it + cfg.leg_chunk, cfg.leg_max_iter)
                out = solve(can, kkt, opts, inst=inst, params=budget(it),
                            state0=out.state, keep_state=True)
            winner = pick_winner(out)
        else:
            out = solve(can, kkt, opts, inst=inst, v0=v0[None], y0=y0[None])
            if used_warm and not bool(out.converged[0]):
                # Cold retry: a stale warm start must never lose a leg.
                cold_retry = True
                out = solve(can, kkt, opts, inst=inst,
                            v0=can.initial_point(inst)[None])
        lane = winner if winner is not None else 0
        v, y = out.v[lane], out.y[lane]
        converged = bool(out.converged[lane])
        solve_s = time.time() - t0
        Z, dt, _ = can.split(can.to_physical(v))
        f_phys = float(out.f[lane]) / float(can.scaling.s_f)
        doc = results_document(pcfg, goal_ned, Z, dt, f_phys,
                               aircraft_name=cfg.aircraft)
        doc["converged"] = converged
        doc["kkt_err"] = float(out.kkt_err[lane])
        doc["iterations"] = int(out.iterations[lane])
        doc["solve_s"] = solve_s
        doc["used_warm"] = used_warm
        doc["cold_retry"] = cold_retry
        if winner is not None:
            doc["ensemble"] = cfg.leg_ensemble
            doc["winner_lane"] = winner
        if converged:
            warm[mission_type] = (v, y, goal_ned)
        return doc

    solve_leg.programs = programs
    return solve_leg


class Mission:
    """Receding-horizon planner (``Mission.run``, msl/mission.py:269-311)."""

    def __init__(self, config: MissionConfig | None = None,
                 autopilot: Optional[Autopilot] = None,
                 leg_solver: Optional[Callable] = None):
        self.cfg = config or MissionConfig()
        self.ap = autopilot or FakeAutopilot()
        self.solve_leg = leg_solver or default_leg_solver(self.cfg)
        self.trajectory = Trajectory(self.cfg.datum_lat, self.cfg.datum_lon,
                                     self.cfg.datum_alt)
        self.connected = self.ap.connect()
        self.legs = []
        self.log: list[str] = []

    def locate(self):
        lat, lon, alt = self.ap.global_position()
        return haversine_enu(self.cfg.datum_lat, self.cfg.datum_lon,
                             self.cfg.datum_alt, lat, lon, alt)

    def run(self, goal_enu):
        """goal_enu = (east, north, up, radius) relative to the datum."""
        from tol_tpu_torch.config import Goal, StitchState

        g_e, g_n, g_u, g_r = goal_enu
        if len(self.trajectory):
            cur = self.trajectory.end_state()
            pos = (cur["east"], cur["north"], cur["up"])
        else:
            pos = self.locate()
        start = pos
        start_dist = math.hypot(g_e - pos[0], g_n - pos[1]) or 1.0
        t_begin = time.time()
        incomplete = True
        leg = 0
        while incomplete and leg < self.cfg.max_legs:
            leg += 1
            e, n, u = pos
            dist = math.hypot(g_e - e, g_n - n)
            if dist > max(g_r, 1e-9):
                # G7 leg toward the goal along the bearing.
                chi = math.atan2(g_n - n, g_e - e)
                rel_e, rel_n = dist * math.cos(chi), dist * math.sin(chi)
                mission_type = "G7"
                goal = Goal(xg=rel_n, yg=rel_e, zg=0.0, rg=0.0)
            else:
                # Terminal loiter.
                mission_type = "S10"
                r = g_r or self.cfg.default_loiter_radius
                goal = Goal(xg=-r, yg=0.0, zg=0.0, rg=r)
                incomplete = False

            # Stitch: the previous leg's terminal state bounds the next
            # leg's node 0.
            stitch = None
            if self.cfg.warm_start and len(self.trajectory):
                s = self.trajectory.end_state()
                stitch = StitchState(
                    Va=s["Va"], gam=s["gam"], chi=s["chi"], phi=s["phi"],
                    CL=s["CL"], dphi=s["dphi"], dCL=s["dCL"], T=s["T"])
            doc = self.solve_leg(mission_type, goal, stitch=stitch)
            self.legs.append(doc)
            t0 = self.trajectory.t[-1] if len(self.trajectory) else 0.0
            self.trajectory.append_leg(doc, t0, (e, n, u))
            cur = self.trajectory.end_state()
            pos = (cur["east"], cur["north"], cur["up"])
            self.log.append(
                f"leg {leg}: {mission_type} goal=({goal.xg:.1f},{goal.yg:.1f}"
                f",r={goal.rg:.0f}) -> pos=({pos[0]:.1f},{pos[1]:.1f})"
                f" converged={doc.get('converged')}")

            progressed = math.hypot(pos[0] - start[0], pos[1] - start[1])
            if progressed / start_dist > self.cfg.completion_fraction:
                if g_r == 0:
                    incomplete = False
                # else: the next leg is the loiter

        self.elapsed = time.time() - t_begin
        return self.trajectory

    def upload(self) -> int:
        n = self.ap.upload_mission(self.trajectory.waypoints())
        self.trajectory.mark_sent()
        return n
