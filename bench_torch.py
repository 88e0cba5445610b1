"""Benchmark of the PyTorch/CUDA port (port of ``bench.py``): batched
S10-Tempest NLP solves per second on one card, plus bench.py's configs 2-5.

    python3 bench_torch.py                    # on the CUDA card
    BENCH_DEVICE=cpu BENCH_TS=8 ... python3 bench_torch.py

Prints bench.py's one JSON line, with the same keys, as the last line of
its output (each config's own dict also goes to stderr as it finishes).
Every ``BENCH_*`` variable of bench.py keeps its name and default, and
bench.py's gates are kept as they are: config 1 counts a lane that is
converged (KKT certificate), feasible (scaled violation < ``BENCH_FEAS``)
and within ``BENCH_COST_GAP`` of ``tests/golden_s10_ts100.npy``'s cost;
G7 counts converged lanes (its gap against the best-known point is
informational); storm gates against ``tests/golden_storm_ts100.npy``.

Configs (bench.py:48-61): 1. S10 / tempest, ts=100, 1024 lanes; 3. the
four-airframe sweep through config 1's solver; 2. G7 / skywalker, 256
lanes; 4. nine warm replans through the mission layer; 5. S10 on the demo
storm grid (wind model 3), 256 lanes.  Each solve runs through
``solver.batch.make_grouped_solver``: GB-lane groups (a dive, then the
endgame), then DB-lane drain chunks of the unconverged lanes.

Where this script differs from bench.py:

* Device.  It runs on the CUDA card in float32 and raises without one;
  ``BENCH_DEVICE=cpu`` (the tests' setting) runs it on the CPU in float64,
  where each kernel wrapper takes its plain twin.  ``platform`` says which;
  ``detail.card`` is ``nvidia-smi``'s name and power limit of the card.
* Seeds.  The lane noise is bench.py's own draw,
  ``0.01 * normal(PRNGKey(k))`` in float32, read from
  ``tests/bench_seeds/`` (written by ``tests/make_bench_seeds.py`` with
  the CPU JAX named in ``seeds.json``).  At fewer lanes the first rows are
  used; a shape the files do not hold (another ``BENCH_TS``, more lanes)
  takes numpy's ``default_rng(k)`` instead.  ``detail.seeds`` says which,
  per config.  ``seeds_for``'s clip and fix are applied here in torch.
* Warm-up.  bench.py runs each config twice, the first run to compile XLA
  programs.  The port's counterpart is its first use: it builds and loads
  the kernel libraries and captures the solver's step programs as CUDA
  graphs (``solver/alm.py``), which the timed run replays.  So each solver
  is warmed on its first group for a few iterations (``WARM_ITERS``),
  whose seconds are reported as ``compile_s`` / ``compile_breakdown_s``
  (the captures included), and the full run is timed once.
* ``detail.graphs``: per config, the programs captured so far by its
  solver, their capture seconds, and the card's peak memory
  (``max_memory_allocated``) over the config.
* Flops.  ``flops_per_iter`` is ``utils.flops.program_flops`` of one
  dive step of GB lanes (one substep of the dive body; one-body mode: of
  the phase-1 body).  It counts the aten operations that run, by XLA's
  cost-analysis convention; bench.py's figure is XLA's analysis of the
  compiled dive program's loop body, whose fusions duplicate producers, so
  the two are not the same count of the same step.  The hand-written
  kernels count none.  ``achieved`` and ``mfu_pct`` are formed from it as
  bench.py forms them, against ``peak_flops()`` (dense BF16), and left
  unrounded (bench.py's three decimals of a percent would read 0).
* ``cache_entries_*`` count the kernel libraries in the build directory
  (``utils/cache.py``), the port's only compiled artifacts.
* ``detail.launches``: the hand-written kernels' launches over the whole
  run (warm-ups and the flop count included).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SEEDS_DIR = os.path.join(HERE, "tests", "bench_seeds")
# bench.py's PRNGKey of each config's lane noise
SEED_KEYS = {"s10": 0, "g7": 1, "sweep": 2, "storm": 3}
AIRFRAMES = ["tempest", "tempest_eric", "tempest_wences", "tempest_will"]
NV = 11                # variables of a node
WARM_ITERS = 2         # dive / endgame / drain iterations of a warm-up run


def _device() -> torch.device:
    name = os.environ.get("BENCH_DEVICE")
    if name is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; set BENCH_DEVICE=cpu to "
                           "run on the CPU")
    from tol_tpu_torch.problems.base import resolve_device

    return resolve_device(name)


def settings() -> SimpleNamespace:
    """bench.py's ``BENCH_*`` variables with its defaults, the device and
    the solve type (float32 on the card, float64 on the CPU)."""
    e = os.environ.get
    device = _device()
    chain = e("BENCH_CHAIN", "crp")
    return SimpleNamespace(
        device=device,
        dtype=torch.float32 if device.type == "cuda" else torch.float64,
        ts=int(e("BENCH_TS", "100")),
        batch=int(e("BENCH_BATCH", "1024")),
        chain=chain,
        refine=int(e("BENCH_REFINE", "1")),
        dual_k=int(e("BENCH_DUALK", "4")),
        max_iter=int(e("BENCH_MAX_ITER", "250")),
        n1=int(e("BENCH_N1", "90")),
        tol=float(e("BENCH_TOL", "5e-3")),
        feas=float(e("BENCH_FEAS", "1e-4")),
        cost_gap=float(e("BENCH_COST_GAP", "1e-2")),
        reuse=int(e("BENCH_REUSE", "1")),
        group=int(e("BENCH_GROUP", "128")),
        drain=int(e("BENCH_DRAIN", "128")),
        cap1=int(e("BENCH_CAP1", "145")),
        two=e("BENCH_TWOBODY", "1") == "1",
        dive_ls=int(e("BENCH_DIVE_LS", "4")),
        dive_chain=e("BENCH_DIVE_CHAIN", chain),
        dive_refine=int(e("BENCH_DIVE_REFINE", "0")),
        sweep=e("BENCH_SWEEP", "1") == "1",
        g7=e("BENCH_G7", "1") == "1",
        g7_batch=int(e("BENCH_G7_BATCH", "256")),
        g7_iter=int(e("BENCH_G7_ITER", "600")),
        g7_cap=int(e("BENCH_G7_CAP", "360")),
        g7_n1=int(e("BENCH_G7_N1", "40")),
        replan=e("BENCH_REPLAN", "1") == "1",
        leg_ens=int(e("BENCH_LEG_ENS", "128")),
        leg_chunk=int(e("BENCH_LEG_CHUNK", "48")),
        storm=e("BENCH_STORM", "1") == "1",
        storm_batch=int(e("BENCH_STORM_BATCH", "256")),
        storm_cap=int(e("BENCH_STORM_CAP", "175")),
        storm_ls=int(e("BENCH_STORM_LS", "4")),
    )


def _params(dtype, device, **kw):
    """bench.py:_params: ALMParams as 0-d tensors on ``device``."""
    from tol_tpu_torch.solver.alm import ALMParams

    base = dict(tol=5e-3, feas_tol=1e-4, mu_init=1e-5, mu_min=1e-5,
                mu_shrink=0.1, theta_mu=1.2, gamma_init=0.01, gamma_min=1e-6,
                gamma_shrink=0.2, prox=3e-3, eta=1e-4, tau_min=0.99,
                kappa_inner=1.0, delta_decay=0.2, gamma_eager=1.0,
                max_iter=400)
    base.update(kw)
    if base["mu_min"] == 0.0:
        base["mu_min"] = min(base["tol"] / 10.0, base["mu_init"])
    mi = base.pop("max_iter")
    return ALMParams(**{k: torch.tensor(v, dtype=dtype, device=device)
                        for k, v in base.items()},
                     max_iter=torch.tensor(mi, dtype=torch.int32,
                                           device=device))


def _with_budget(p, max_iter):
    return p._replace(max_iter=torch.tensor(max_iter, dtype=torch.int32,
                                            device=p.max_iter.device))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_draw(name: str, lanes: int, n: int):
    """bench.py's noise of config ``name`` for ``lanes`` x ``n`` (float32
    numpy) and a note of where it came from."""
    k = SEED_KEYS[name]
    path = os.path.join(SEEDS_DIR, f"{name}.npy")
    if os.path.exists(path):
        d = np.load(path, mmap_mode="r")
        if d.shape[1] == n and lanes <= d.shape[0]:
            with open(os.path.join(SEEDS_DIR, "seeds.json")) as f:
                made = json.load(f)
            note = dict(source=f"bench.py's draw, PRNGKey({k})",
                        file=os.path.relpath(path, HERE),
                        jax_version=made["jax_version"],
                        jax_threefry_partitionable=made[
                            "jax_threefry_partitionable"],
                        rows=lanes, of=int(d.shape[0]))
            if lanes < d.shape[0]:
                note["reduced"] = f"first {lanes} of {d.shape[0]} rows"
            return np.array(d[:lanes]), note
    note = dict(source=f"numpy default_rng({k}): no committed draw of shape "
                       f"({lanes}, {n})")
    dv = 0.01 * np.random.default_rng(k).standard_normal((lanes, n))
    return dv.astype(np.float32), note


def seeds_for(can, lane_insts, dv):
    """bench.py:217-222 on the device: each lane's initial point plus its
    noise ``dv`` (numpy), clipped into its bounds, fixed entries at their
    bound.  ``lane_insts`` holds each lane's Instance."""
    dev = can.nlp.inst0.z_lo.device
    dv = torch.as_tensor(dv, device=dev).to(can.nlp.inst0.z_lo.dtype)
    out = torch.empty_like(dv)
    runs: dict = {}
    for i, inst in enumerate(lane_insts):
        runs.setdefault(id(inst), (inst, []))[1].append(i)
    for inst, lanes in runs.values():
        idx = torch.as_tensor(lanes, device=dev)
        v0 = can.initial_point(inst)
        lb, ub, fixed = can.bounds(inst)
        v = torch.minimum(torch.maximum(v0 + dv[idx], lb), ub)
        out[idx] = torch.where(fixed, lb, v)
    return out


def make_solver(s, can, opts):
    """The grouped solver of bench.py:193-215 and the body whose one step
    ``flops_per_iter`` counts: (kkt, opts) of the dive, or of the one body."""
    from tol_tpu_torch.solver.alm import ALMOptions
    from tol_tpu_torch.solver.batch import make_grouped_solver
    from tol_tpu_torch.solver.kkt_condensed import make_condensed_kkt

    kkt = make_condensed_kkt(can, refine=s.refine, chain=s.chain)
    if not s.two:
        return make_grouped_solver(can, kkt, opts, group_size=s.group,
                                   drain_size=s.drain), (kkt, opts)
    dive_opts = ALMOptions(max_iter=2000, dual_refine_k=0, max_ls=s.dive_ls,
                           factor_reuse=1)
    kkt_dive = make_condensed_kkt(can, refine=s.dive_refine,
                                  chain=s.dive_chain)
    return (make_grouped_solver(can, kkt, opts, group_size=s.group,
                                drain_size=s.drain, dive_opts=dive_opts,
                                dive_kkt=kkt_dive), (kkt_dive, dive_opts))


def warm_up(s, gsolve, inst, v0s, p1, p2, p2d) -> float:
    """Seconds of a short run of ``gsolve`` on one group's lanes ``v0s``:
    ``WARM_ITERS`` dive, endgame and drain iterations."""
    w = WARM_ITERS
    t0 = time.time()
    gsolve([inst], None, v0s, p1, _with_budget(p2, 2 * w),
           _with_budget(p2d, 3 * w), w, -1.0)
    _sync(s.device)
    return time.time() - t0


def timed(s, gsolve, *args):
    """(result, wall seconds) of one run of ``gsolve``."""
    _sync(s.device)
    t0 = time.time()
    res = gsolve(*args)
    _sync(s.device)
    return res, time.time() - t0


def _cost_ref(can, name, ts):
    """f of the reference point ``tests/<name>`` on ``can`` (scaled, in the
    solve's type, as bench.py evaluates it), or None off ts=100."""
    path = os.path.join(HERE, "tests", name)
    if ts != 100 or not os.path.exists(path):
        return None
    inst0 = can.nlp.inst0
    ref = torch.as_tensor(np.load(path), dtype=inst0.z_lo.dtype,
                          device=inst0.z_lo.device)
    return float(can.f(can.from_physical(ref), inst0))


def _gap(f, f_ref):
    """Relative cost gap in float64 on the host."""
    return (np.asarray(f, np.float64) - f_ref) / max(abs(f_ref), 1e-9)


def s10_problem(s) -> dict:
    """Config 1's canonical problem, solver and parameter sets
    (bench.py:161-215)."""
    from tol_tpu_torch.api import make_problem
    from tol_tpu_torch.solver.alm import ALMOptions
    from tol_tpu_torch.solver.canonical import canonicalize

    nlp = make_problem("S10", aircraft="tempest", ts=s.ts, wind_model=1,
                       dtype=s.dtype, device=s.device)
    can = canonicalize(nlp, scaling="auto")
    opts = ALMOptions(max_iter=2000, dual_refine_k=s.dual_k, max_ls=8,
                      factor_reuse=s.reuse)
    gsolve, body = make_solver(s, can, opts)
    end = dict(tol=s.tol, feas_tol=s.feas, mu_init=6e-5, kappa_inner=2.0,
               prox=2.5e-3)
    return dict(
        can=can, opts=opts, gsolve=gsolve, body=body,
        p2=_params(s.dtype, s.device, max_iter=s.cap1, **end),
        p2d=_params(s.dtype, s.device, max_iter=s.max_iter, **end),
        p1=_params(s.dtype, s.device, tol=1e-12, feas_tol=1e-12, prox=0.0,
                   gamma_eager=0.0, max_iter=s.max_iter))


def gate_s10(s, can, res):
    """bench.py's config-1 gate of a GroupedResult: (pass mask, feasible
    mask, relative cost gap or None off ts=100)."""
    f_star = _cost_ref(can, "golden_s10_ts100.npy", s.ts)
    cost_gap = _gap(res.f, f_star) if f_star is not None else None
    feas_ok = res.constr_viol < s.feas
    ok = res.converged & feas_ok
    if cost_gap is not None:
        # one-sided: a flat-manifold solve may land below the oracle cost
        ok = ok & (cost_gap < s.cost_gap)
    return ok, feas_ok, cost_gap


def run_s10(s, ctx, dv):
    """Config 1 on the noise ``dv``: warm-up, then the timed run.
    Returns (result, wall seconds, warm-up seconds, seeds)."""
    can, GB = ctx["can"], s.group
    inst0 = can.nlp.inst0
    v0s = seeds_for(can, [inst0] * s.batch, dv)
    args = (ctx["p1"], ctx["p2"], ctx["p2d"])
    warm_s = warm_up(s, ctx["gsolve"], inst0, v0s[:GB], *args)
    res, wall = timed(s, ctx["gsolve"], [inst0] * (s.batch // GB), None, v0s,
                      *args, s.n1, -1.0)
    return res, wall, warm_s, v0s


def dive_step_flops(s, ctx, v0s) -> float:
    """``program_flops`` of one step of the dive body over ``v0s``."""
    from tol_tpu_torch.solver.alm import Phase1, make_kernel
    from tol_tpu_torch.utils.flops import program_flops

    can, (kkt, opts), p1, p2 = ctx["can"], ctx["body"], ctx["p1"], ctx["p2"]
    kern = make_kernel(can, kkt, opts, can.nlp.inst0, v0s)
    if s.two:
        st = kern.init_state(p1, p1, False)
        return program_flops(lambda: kern.substep(st, None, p1, p1, None))
    ph = Phase1(params=p1, n_max=torch.tensor(s.n1, dtype=torch.int32,
                                              device=s.device),
                exit_df=torch.tensor(-1.0, dtype=s.dtype, device=s.device))
    st = kern.init_state(p1, p2, True)
    return program_flops(lambda: kern.substep(st, None, p1, p2, ph))


def ctrl_l2(can, v, ts):
    """bench.py:271-277: each lane's control RMS distance to the golden
    point's, per control scaled by max(its golden RMS, its unit)."""
    golden = np.load(os.path.join(HERE, "tests", "golden_s10_ts100.npy"))
    Zg = golden[1:1 + (ts + 1) * NV].reshape(ts + 1, NV)
    vt = torch.as_tensor(v, device=can.nlp.inst0.z_lo.device)
    v_phys = can.to_physical(vt).cpu().numpy()
    Z = v_phys[:, 1:1 + (ts + 1) * NV].reshape(v.shape[0], ts + 1, NV)
    unit = can.scaling.d_z.cpu().numpy()[6:11]
    rms = np.maximum(np.sqrt(np.mean(Zg[:, 6:11] ** 2, axis=0)), unit)
    return np.sqrt(np.mean(((Z[:, :, 6:11] - Zg[None, :, 6:11]) / rms) ** 2,
                           axis=(1, 2)))


def run_sweep(s, ctx, dv):
    """Config 3 (bench.py:290-331) through config 1's solver on the noise
    ``dv``: the four airframes in blocks of batch / 4 lanes, each lane with
    its airframe's Instance, the tempest canonicalization shared.  Returns
    (the report, the result)."""
    from tol_tpu_torch.api import default_goal, make_config
    from tol_tpu_torch.models.wind import WindConfig
    from tol_tpu_torch.problems.base import make_instance

    per = s.batch // 4
    singles = [make_instance(make_config("S10", name, ts=s.ts, wind_model=1),
                             default_goal("S10"), WindConfig(model=1),
                             dtype=s.dtype, device=s.device)
               for name in AIRFRAMES]
    insts = [singles[i // per] for i in range(s.batch)]
    # airframe blocks align with solve groups (per % GB == 0)
    g_insts = [singles[(g * s.group) // per]
               for g in range(s.batch // s.group)]
    v3 = seeds_for(ctx["can"], insts, dv)
    res, w3 = timed(s, ctx["gsolve"], g_insts, insts, v3, ctx["p1"],
                    ctx["p2"], ctx["p2d"], s.n1, -1.0)
    c3 = res.converged
    f3 = res.constr_viol < s.feas
    return {
        "airframes": AIRFRAMES, "batch": s.batch,
        "scaling": "shared (tempest inst0)",
        "converged": int(c3.sum()),
        "feasible": int(f3.sum()),
        "wall_s": round(w3, 3),
        "solves_per_s": round(float((c3 & f3).sum()) / w3, 1),
        "per_airframe_conv": {
            n: int(c3[i * per:(i + 1) * per].sum())
            for i, n in enumerate(AIRFRAMES)},
    }, res


def drain_mix(s, res) -> dict:
    """The sweep's drain (for the stderr log): its lanes by airframe and
    how many of its chunks took lanes of more than one airframe."""
    per = s.batch // 4
    drained = np.flatnonzero(res.iterations > s.cap1)
    chunks = [set(drained[k:k + s.drain] // per)
              for k in range(0, len(drained), s.drain)]
    return dict(group_iters=res.group_iters, drain_iters=res.drain_iters,
                drained_by_airframe={a: int((drained // per == i).sum())
                                     for i, a in enumerate(AIRFRAMES)},
                drain_chunks=len(chunks),
                chunks_mixing_airframes=sum(len(c) > 1 for c in chunks))


def run_g7(s, opts, seeds, compile_s, graphs):
    """Config 2 (bench.py:333-424): G7 / skywalker, gated on convergence;
    the gap against ``tests/g7_bestknown_ts100.npy`` is informational."""
    from tol_tpu_torch.api import make_problem
    from tol_tpu_torch.solver.canonical import canonicalize

    nlp = make_problem("G7", aircraft="skywalker", ts=s.ts, wind_model=1,
                       dtype=s.dtype, device=s.device)
    can = canonicalize(nlp, scaling="auto")
    gsolve, _ = make_solver(s, can, opts)
    end = dict(tol=s.tol, feas_tol=s.feas, gamma_min=5e-6, prox=2.5e-3,
               mu_init=6e-5, kappa_inner=2.0, gamma_shrink=0.12)
    p_g = _params(s.dtype, s.device, max_iter=s.g7_cap, **end)
    p_gd = _params(s.dtype, s.device, max_iter=s.g7_iter, **end)
    p1_g = _params(s.dtype, s.device, tol=1e-12, feas_tol=1e-12, prox=0.0,
                   gamma_eager=0.0, max_iter=600)
    inst0 = can.nlp.inst0
    dv, seeds["g7"] = bench_draw("g7", s.g7_batch, can.n)
    v0s = seeds_for(can, [inst0] * s.g7_batch, dv)
    compile_s["g7"] = round(warm_up(s, gsolve, inst0, v0s[:s.group], p1_g,
                                    p_g, p_gd), 1)
    og, wall = timed(s, gsolve, [inst0] * (s.g7_batch // s.group), None, v0s,
                     p1_g, p_g, p_gd, s.g7_n1, -1.0)
    graphs["g7_skywalker"] = _graph_stats(gsolve.programs, s.device)
    f_bk = _cost_ref(can, "g7_bestknown_ts100.npy", s.ts)
    gap = _gap(og.f, f_bk) if f_bk is not None else None
    return {
        "batch": s.g7_batch,
        "converged": int(og.converged.sum()),
        "median_kkt": float(np.nanmedian(og.kkt_err)),
        "median_viol": float(np.median(og.constr_viol)),
        "median_iters": int(np.median(og.iterations)),
        "median_f_scaled": float(np.median(og.f)),
        "iqr_f_scaled": [float(np.percentile(og.f, 25)),
                         float(np.percentile(og.f, 75))],
        "median_cost_gap_vs_bestknown_informational":
            (float(np.median(gap)) if gap is not None else None),
        "wall_s": round(wall, 3),
        "solves_per_s": round(float(og.converged.sum()) / wall, 2),
    }


def run_replan(s, legs: int = 9, graphs: dict | None = None):
    """Config 4 (bench.py:426-484): a cold G7 leg 400 m north through the
    mission layer's seed ensemble, then ``legs`` replans to goals drawn
    from ``default_rng(7)`` (bearing +-10 deg, range +-10%), each stitched
    to the previous leg's last node and warm-started."""
    from tol_tpu_torch.config import Goal, StitchState
    from tol_tpu_torch.mission.mission import MissionConfig, default_leg_solver

    ens = s.leg_ens
    mcfg = MissionConfig(aircraft="skywalker", ts=s.ts, wind_model=1,
                         leg_max_iter=600, leg_ensemble=ens,
                         leg_chain=(s.chain if ens % 128 == 0 and ens
                                    else "cr"),
                         leg_chunk=s.leg_chunk, device=str(s.device),
                         dtype=s.dtype)
    solve_leg = default_leg_solver(mcfg)
    t0 = time.time()
    doc = solve_leg("G7", Goal(xg=0.0, yg=400.0, zg=0.0, rg=0.0))
    cold_s = time.time() - t0
    cold_iters = doc["iterations"]
    times, warm_iters, conv_ok, leg_log = [], [], 0, []
    rng = np.random.default_rng(7)
    for _ in range(legs):
        ang = math.pi / 2 + math.radians(rng.uniform(-10, 10))
        rng_d = 400.0 * (1.0 + rng.uniform(-0.1, 0.1))
        tr = doc["trajectory"]
        st = StitchState(*[tr[k][-1] for k in ("Va", "gam", "chi", "phi",
                                               "CL", "dphi", "dCL", "T")])
        g = Goal(xg=rng_d * math.cos(ang), yg=rng_d * math.sin(ang),
                 zg=0.0, rg=0.0)
        t0 = time.time()
        doc = solve_leg("G7", g, stitch=st)
        times.append(time.time() - t0)
        warm_iters.append(doc["iterations"])
        conv_ok += int(bool(doc["converged"]))
        leg_log.append({"ms": round(times[-1] * 1000.0, 1),
                        "iters": doc["iterations"],
                        "warm": doc.get("used_warm"),
                        "cold_retry": doc.get("cold_retry")})
    if graphs is not None:
        graphs["replan"] = _graph_stats(solve_leg.programs, s.device)
    return {
        "p50_ms": round(float(np.median(times)) * 1000.0, 2),
        "p90_ms": round(float(np.percentile(times, 90)) * 1000.0, 2),
        "cold_first_leg_s": round(cold_s, 2),
        "cold_iters": cold_iters,
        "median_warm_iters": int(np.median(warm_iters)),
        "converged": conv_ok, "legs": legs,
        "per_leg": leg_log,
    }


def run_storm(s, ctx, seeds, compile_s, graphs):
    """Config 5 (bench.py:486-575): S10 / tempest on the demo storm grid
    (wind model 3, order 2), a ``BENCH_STORM_LS``-trial endgame and group
    cap ``BENCH_STORM_CAP``, gated against ``tests/golden_storm_ts100.npy``
    like config 1."""
    from tol_tpu_torch.api import make_problem
    from tol_tpu_torch.io.storm import make_demo_storm_grid
    from tol_tpu_torch.models.wind import WindConfig
    from tol_tpu_torch.solver.alm import ALMOptions
    from tol_tpu_torch.solver.canonical import canonicalize

    grid = make_demo_storm_grid(dtype=s.dtype, device=s.device)
    wcfg = WindConfig(model=3, east0=17400.0, north0=25800.0, up0=200.0,
                      grid=grid, order=2)
    nlp = make_problem("S10", aircraft="tempest", ts=s.ts, wind_model=3,
                       wind=wcfg, dtype=s.dtype, device=s.device)
    can = canonicalize(nlp, scaling="auto")
    opts = ALMOptions(max_iter=2000, dual_refine_k=s.dual_k,
                      max_ls=s.storm_ls, factor_reuse=s.reuse)
    gsolve, _ = make_solver(s, can, opts)
    p2s = _params(s.dtype, s.device, tol=s.tol, feas_tol=s.feas,
                  mu_init=6e-5, kappa_inner=2.0, prox=2.5e-3,
                  max_iter=s.storm_cap)
    p1, p2d = ctx["p1"], ctx["p2d"]
    inst0 = can.nlp.inst0
    dv, seeds["storm"] = bench_draw("storm", s.storm_batch, can.n)
    v0s = seeds_for(can, [inst0] * s.storm_batch, dv)
    compile_s["storm"] = round(warm_up(s, gsolve, inst0, v0s[:s.group], p1,
                                       p2s, p2d), 1)
    out, sw = timed(s, gsolve, [inst0] * (s.storm_batch // s.group), None,
                    v0s, p1, p2s, p2d, s.n1, -1.0)
    graphs["storm_grid"] = _graph_stats(gsolve.programs, s.device)
    cs = out.converged
    fs = out.constr_viol < s.feas
    n_ok = int((cs & fs).sum())
    f_star = _cost_ref(can, "golden_storm_ts100.npy", s.ts)
    gap = None
    if f_star is not None:
        gap = _gap(out.f, f_star)
        n_ok = int((cs & fs & (gap < s.cost_gap)).sum())
    return {
        "batch": s.storm_batch, "wind_model": 3,
        "field": "vortex+thermal+shear", "interp_order": 2,
        "converged": int(cs.sum()), "feasible": int(fs.sum()),
        "accurate_and_feasible": n_ok,
        "wall_s": round(sw, 3),
        "solves_per_s": round(n_ok / sw, 1) if sw > 0 else None,
        "median_cost_gap_vs_f64_storm_oracle":
            (float(np.median(gap)) if gap is not None else None),
    }


def _cache_entries() -> int:
    """Kernel libraries in the build directory (``utils/cache.py``)."""
    from tol_tpu_torch.ops import _build

    return sum(f.startswith("lib") and f.endswith(".so")
               for _, _, files in os.walk(_build.BUILD_ROOT) for f in files)


def _card(device):
    """nvidia-smi's name and power limit of the card, None on the CPU."""
    if device.type != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        return f"nvidia-smi failed: {out.stderr.strip()}"
    return out.stdout.strip().splitlines()[0]


def _launches():
    from tol_tpu_torch.ops import chainkern as ch
    from tol_tpu_torch.ops import crkern as ck
    from tol_tpu_torch.ops import nodekern as nk

    return {getattr(k, "kernel", k.__name__): k.launches
            for k in ck.KERNELS + ch.KERNELS + nk.KERNELS}


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _graph_stats(programs, device) -> dict:
    """A solver's captured programs: how many, their capture seconds (part
    of its warm-up's ``compile_s``) and the peak memory since
    :func:`_reset_peak`."""
    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else None)
    return dict(captures=programs.captures,
                capture_s=round(programs.capture_s, 3), peak_mem_gib=peak)


def _log(name, rec):
    print(json.dumps({"config": name, **rec}), file=sys.stderr, flush=True)


def main() -> dict:
    s = settings()
    from tol_tpu_torch.ops import chainkern as ch
    from tol_tpu_torch.ops import crkern as ck
    from tol_tpu_torch.ops import nodekern as nk
    from tol_tpu_torch.utils.cache import enable_compile_cache
    from tol_tpu_torch.utils.flops import peak_flops

    if s.device.type == "cuda":
        # full float32 matmuls, as the reference's "highest" precision
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    enable_compile_cache()
    cache_start = _cache_entries()
    ck.reset_launch_counts()
    ch.reset_launch_counts()
    nk.reset_launch_counts()
    compile_s, seeds, graphs = {}, {}, {}
    GB, DB = s.group, s.drain
    _reset_peak(s.device)

    # ================= config 1: S10-Tempest flagship =================
    ctx = s10_problem(s)
    can = ctx["can"]
    dv, seeds["s10"] = bench_draw("s10", s.batch, can.n)
    res1, elapsed, warm_s, v0s = run_s10(s, ctx, dv)
    compile_s["s10"] = round(warm_s, 1)
    conv, viol, iters, out_kkt = (res1.converged, res1.constr_viol,
                                  res1.iterations, res1.kkt_err)
    group_iters, drain_iters = res1.group_iters, res1.drain_iters
    graphs["s10"] = _graph_stats(ctx["gsolve"].programs, s.device)

    flops_per_iter = dive_step_flops(s, ctx, v0s[:GB])
    achieved = (flops_per_iter * (group_iters + (DB / GB) * drain_iters)
                / elapsed)
    peak = peak_flops(s.device)
    mfu_pct = (100.0 * achieved / peak) if (peak and achieved == achieved) \
        else None

    ok, feas_ok, cost_gap = gate_s10(s, can, res1)
    l2 = ctrl_l2(can, res1.v, s.ts) if cost_gap is not None else None
    n_ok = int(np.sum(ok))
    solves_per_s = n_ok / elapsed if elapsed > 0 else 0.0
    _log("s10", dict(accurate_and_feasible=n_ok, batch=s.batch,
                     wall_s=elapsed, group_iters=group_iters,
                     drain_iters=drain_iters))

    # ================= config 3: multi-airframe sweep =================
    sweep = None
    if s.sweep and s.batch % 4 == 0 and (s.batch // 4) % GB == 0:
        dv3, seeds["multi_airframe"] = bench_draw("sweep", s.batch, can.n)
        _reset_peak(s.device)
        sweep, res3 = run_sweep(s, ctx, dv3)
        # config 1's programs, refilled with each airframe's Instance
        graphs["multi_airframe"] = _graph_stats(ctx["gsolve"].programs,
                                                s.device)
        _log("multi_airframe", {**sweep, **drain_mix(s, res3)})

    # ================= config 2: G7-Skywalker =================
    g7 = None
    if s.g7:
        _reset_peak(s.device)
        g7 = run_g7(s, ctx["opts"], seeds, compile_s, graphs)
        _log("g7_skywalker", g7)

    # ====== config 4: warm replanning through the mission layer ======
    replan = None
    if s.replan:
        _reset_peak(s.device)
        replan = run_replan(s, graphs=graphs)
        _log("replan", replan)

    # ================= config 5: storm-grid S10 =================
    storm = None
    if s.storm:
        _reset_peak(s.device)
        storm = run_storm(s, ctx, seeds, compile_s, graphs)
        _log("storm_grid", storm)

    result = {
        "metric": "s10_tempest_solves_per_s_per_chip",
        "value": round(solves_per_s, 2),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_s / 1000.0, 4),
        "detail": {
            "batch": s.batch,
            "ts": s.ts,
            "chain": s.chain,
            "max_iter": s.max_iter,
            "group": GB, "drain": DB, "cap1": s.cap1,
            "converged": int(np.sum(conv)),
            "feasible": int(np.sum(feas_ok)),
            "accurate_and_feasible": n_ok,
            "median_viol": float(np.median(viol)),
            "median_kkt": float(np.nanmedian(out_kkt)),
            "median_cost_gap": (float(np.median(cost_gap))
                                if cost_gap is not None else None),
            "median_ctrl_l2": (float(np.median(l2))
                               if l2 is not None else None),
            "wall_s": round(elapsed, 3),
            "compile_s": round(sum(compile_s.values()), 1),
            "compile_breakdown_s": compile_s,
            "cache_entries_start": cache_start,
            "cache_entries_new": _cache_entries() - cache_start,
            "median_iters": int(np.median(iters)),
            "p90_iters": int(np.percentile(iters, 90)),
            # aten flops of one GB-lane dive step and the utilization over
            # the timed wall (denominator: dense BF16 peak of the card)
            "flops_per_iter": (None if flops_per_iter != flops_per_iter
                               else float(flops_per_iter)),
            # unrounded: the port's share is below bench.py's 3 decimals
            "achieved_gflops": (None if achieved != achieved
                                else achieved / 1e9),
            "mfu_pct": mfu_pct,
            "replan": replan,
            "g7_skywalker": g7,
            "multi_airframe": sweep,
            "storm_grid": storm,
            "platform": "gpu" if s.device.type == "cuda" else "cpu",
            "card": _card(s.device),
            "seeds": seeds,
            "launches": _launches(),
            "graphs": graphs,
        },
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
