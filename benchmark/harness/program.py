"""The system under test, ``tol_tpu_torch``, through its normal entry
points: ``api.make_problem`` and ``canonical.canonicalize``, then
``batch.make_grouped_solver`` (batch mixes) or
``mission.default_leg_solver`` (mission legs).  This is the only module of
the benchmark that imports the program; what it returns to the harness is
host data and the program's own counters.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from harness.spec import ROOT

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def prepare(root: str = ROOT) -> None:
    """The kernel libraries' build directory, fixed inside the checkout
    (only a cell's first run there builds them), and full float32
    products."""
    from tol_tpu_torch.utils.cache import enable_compile_cache

    enable_compile_cache(os.path.join(root, "build", "tol_tpu_torch"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _params(base: dict, over: dict, dtype, device):
    """ALMParams as 0-d tensors: ``base`` updated by ``over``."""
    from tol_tpu_torch.solver.alm import ALMParams

    p = {**base, **over}
    mi = int(p.pop("max_iter"))
    return ALMParams(**{k: torch.tensor(v, dtype=dtype, device=device)
                        for k, v in p.items()},
                     max_iter=torch.tensor(mi, dtype=torch.int32, device=device))


def wind_config(cfg: dict, dtype, device):
    """The configuration's ``wind`` as the program's WindConfig: every key
    but ``grid`` is a WindConfig field; ``grid``, where given, names a
    builder of the program (``module:function``, under ``tol_tpu_torch``)
    and its keyword arguments."""
    import importlib

    from tol_tpu_torch.models.wind import WindConfig

    w = dict(cfg["wind"])
    grid = w.pop("grid", None)
    if grid is not None:
        mod, fn = grid["builder"].split(":")
        if mod.split(".")[0] != "tol_tpu_torch":
            raise ValueError(f"grid builder outside the program: {mod}")
        grid = getattr(importlib.import_module(mod), fn)(
            **grid.get("args", {}), dtype=dtype, device=device)
    return WindConfig(**w, grid=grid)


def _opts(s: dict):
    from tol_tpu_torch.solver.alm import ALMOptions

    return ALMOptions(max_iter=2000, dual_refine_k=s["dual_refine_k"],
                      max_ls=s["max_ls"], factor_reuse=s["factor_reuse"])


class BatchSystem:
    """One configuration's grouped solver, built once: the dive, endgame
    and drain programs serve every batch, group, chunk and airframe."""

    def __init__(self, cfg: dict, device, airframes=None):
        from tol_tpu_torch.api import default_goal, make_config, make_problem
        from tol_tpu_torch.problems.base import make_instance
        from tol_tpu_torch.solver.batch import make_grouped_solver
        from tol_tpu_torch.solver.canonical import canonicalize
        from tol_tpu_torch.solver.kkt_condensed import make_condensed_kkt

        self.device = torch.device(device)
        self.dtype = DTYPES[cfg["dtype"]] if self.device.type == "cuda" \
            else torch.float64
        mission, ts = cfg["mission"], cfg["ts"]
        wind = wind_config(cfg, self.dtype, self.device)
        wm = wind.model
        nlp = make_problem(mission, aircraft=cfg["aircraft"], ts=ts,
                           wind_model=wm, wind=wind, dtype=self.dtype,
                           device=self.device)
        self.can = can = canonicalize(nlp, scaling="auto")
        sv, b = cfg["solver"], cfg["batch"]
        kkt = make_condensed_kkt(can, refine=sv["refine"], chain=sv["chain"])
        dv = sv["dive"]
        kkt_dive = make_condensed_kkt(can, refine=dv["refine"], chain=dv["chain"])
        self.dive_opts = _opts(dv)
        self.solve = make_grouped_solver(
            can, kkt, _opts(sv), group_size=b["group"], drain_size=b["drain"],
            dive_opts=self.dive_opts, dive_kkt=kkt_dive)
        pr, base, dev, dt = cfg["params"], cfg["params"]["base"], self.device, self.dtype
        self.p1 = _params(base, {**pr["dive"], "max_iter": b["budget"]}, dt, dev)
        self.p2 = _params(base, {**pr["endgame"], "max_iter": b["group_cap"]}, dt, dev)
        self.p2d = _params(base, {**pr["endgame"], "max_iter": b["budget"]}, dt, dev)
        self.group, self.n1, self.cap = b["group"], b["dive_iters"], b["group_cap"]
        self.inst0 = nlp.inst0
        self.insts = {cfg["aircraft"]: self.inst0}
        for name in airframes or ():
            if name not in self.insts:
                self.insts[name] = make_instance(
                    make_config(mission, name, ts=ts, wind_model=wm),
                    default_goal(mission), wind,
                    dtype=self.dtype, device=self.device)

    def seeds(self, airframe_of_lane: list, noise: np.ndarray) -> torch.Tensor:
        """Each lane's initial point plus its noise, clipped into its
        bounds, fixed entries at their bound (bench.py:217-222)."""
        can = self.can
        dv = torch.as_tensor(noise, device=self.device).to(self.dtype)
        out = torch.empty_like(dv)
        for name in dict.fromkeys(airframe_of_lane):
            inst = self.insts[name]
            idx = torch.as_tensor([i for i, a in enumerate(airframe_of_lane)
                                   if a == name], device=self.device)
            lb, ub, fixed = can.bounds(inst)
            v = torch.minimum(torch.maximum(can.initial_point(inst) + dv[idx], lb), ub)
            out[idx] = torch.where(fixed, lb, v)
        return out

    def run(self, airframe_of_lane: list, v0s: torch.Tensor):
        """One batch through the grouped solver (host results)."""
        G = self.group
        lane_insts = [self.insts[a] for a in airframe_of_lane]
        group_insts = lane_insts[::G]
        return self.solve(group_insts, lane_insts, v0s, self.p1, self.p2,
                          self.p2d, self.n1, -1.0)

    def captures(self) -> int:
        """Step programs captured so far (the program's own count)."""
        return self.solve.programs.captures

    def warm_up(self, iters: int) -> dict:
        """``iters`` dive, endgame and drain iterations of one group at the
        cold initial point: builds and loads the kernels and captures the
        three step programs.  Returns the capture seconds and count."""
        G = self.group
        v0s = self.can.initial_point(self.inst0)[None].expand(G, -1).contiguous()
        budget = lambda p, k: p._replace(max_iter=torch.tensor(
            k, dtype=torch.int32, device=self.device))
        self.solve([self.inst0], None, v0s, self.p1, budget(self.p2, 2 * iters),
                   budget(self.p2d, 3 * iters), iters, -1.0)
        sync(self.device)
        return dict(capture_s=self.solve.programs.capture_s,
                    captures=self.captures())

    def golden_f(self, path: str) -> float:
        """The program's own scaled cost of a physical reference point (the
        cost side of its gate, as bench.py evaluates it)."""
        ref = torch.as_tensor(np.load(path), dtype=self.dtype, device=self.device)
        return float(self.can.f(self.can.from_physical(ref), self.inst0))

    def stage_runs(self, steps: int) -> dict:
        """Callables running ``steps`` steps of each stage program on one
        group (for the profiled slice): dive, endgame, drain."""
        s, G, dev = self.solve, self.group, self.device
        v0s = self.can.initial_point(self.inst0)[None].expand(G, -1).contiguous()
        n_max = torch.tensor(steps, dtype=torch.int32, device=dev)
        xdf = torch.tensor(-1.0, dtype=self.dtype, device=dev)
        budget = lambda p, k: p._replace(max_iter=torch.tensor(
            k, dtype=torch.int32, device=dev))
        state = {}

        def dive():
            state["st"] = s.run_dive(self.inst0, v0s, self.p1,
                                     budget(self.p2, 2 * steps), n_max)

        def endgame():
            state["st"] = s.run_end(self.inst0, state["st"],
                                    budget(self.p2, 2 * steps)).state

        def drain():
            s.run_drain(self.inst0, state["st"], self.p1,
                        budget(self.p2d, 3 * steps), n_max, xdf)

        return {"dive": dive, "endgame": endgame, "drain": drain}


class LegSystem:
    """The mission layer's leg solver (seed ensemble in slices, warm
    cache, stitch)."""

    def __init__(self, cfg: dict, device):
        from tol_tpu_torch.mission.mission import MissionConfig, default_leg_solver

        self.device = torch.device(device)
        dtype = DTYPES[cfg["dtype"]] if self.device.type == "cuda" else torch.float64
        ml = cfg["mission_layer"]
        self.mission = cfg["mission"]
        wind = wind_config(cfg, dtype, self.device)
        if wind != type(wind)(model=wind.model):
            raise ValueError("the mission layer takes a wind model's defaults only")
        self.solve_leg = default_leg_solver(MissionConfig(
            aircraft=cfg["aircraft"], ts=cfg["ts"], wind_model=wind.model,
            leg_max_iter=ml["leg_max_iter"], leg_ensemble=ml["ensemble"],
            leg_chain=ml["chain"], leg_chunk=ml["slice"], leg_tol=ml["tol"],
            leg_feas_tol=ml["feas_tol"], device=str(self.device), dtype=dtype))

    def leg(self, goal, stitch=None) -> dict:
        """One leg to ``goal`` (xg, yg, zg, rg) from the origin, its node 0
        boxed around ``stitch`` (Va..T of the previous leg's last node)."""
        from tol_tpu_torch.config import Goal, StitchState

        doc = self.solve_leg(self.mission, Goal(*goal),
                             stitch=None if stitch is None else StitchState(*stitch))
        sync(self.device)
        return doc

    def captured_runs(self) -> list:
        """The ``run`` of each captured step program of the leg solver."""
        return [p.run for p in self.solve_leg.programs.programs.values()
                if p.graph is not None]

    def replays(self) -> float | None:
        """Step-program replays so far, from the program's own counters:
        the hand kernels' launches over one replay's (None before a
        capture, as on the CPU, or where two programs launch differently)."""
        per = {sum(p.launches.values())
               for p in self.solve_leg.programs.programs.values() if p.launches}
        if len(per) != 1:
            return None
        return sum(launch_counts().values()) / per.pop()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def launch_counts() -> dict:
    """The hand kernels' launch counters (captures replayed included)."""
    from tol_tpu_torch.ops import chainkern, crkern

    return {getattr(k, "kernel", k.__name__): int(k.launches)
            for k in crkern.KERNELS + chainkern.KERNELS}
