"""bench_torch.py, the port of bench.py, against bench.py and the JAX
package (float64, CPU, S10 / wind model 1 at ts=8).

* Configs 1 and 3 through bench_torch's own functions against tol_tpu's
  ``make_grouped_solver`` driven with bench.py's constants
  (``bench._params``) on the same numpy noise: converged lanes, iterations,
  group and drain iterations exactly, f to a relative 1e-6 (18 Newton steps
  at most, each amplifying round-off by the dual recovery's 1/gamma).
* The script end to end in a subprocess on the CPU: its last line is
  bench.py's JSON with bench.py's keys (read from bench.py's source).
* bench.py's committed lane noise (``tests/bench_seeds``) regenerated with
  this JAX and compared bit for bit.
"""

import ast
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_torch
import make_bench_seeds
from tol_tpu import api as japi
from tol_tpu.models.wind import WindConfig as JWindConfig
from tol_tpu.problems.base import make_instance as jmake_instance
from tol_tpu.solver import alm as jalm
from tol_tpu.solver import canonicalize as jcanonicalize
from tol_tpu.solver.batch import make_grouped_solver as jgrouped
from tol_tpu.solver.kkt_condensed import make_condensed_kkt as jcondensed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TS, GB, DB, N1, CAP1, FULL = 8, 2, 2, 6, 12, 18
# what bench_torch's detail adds to bench.py's
DETAIL_EXTRA = ("card", "seeds", "launches", "graphs")
# the bench's variables for this file's runs: ts=8, 2-lane groups and
# drain chunks, a short dive, group cap and budget
SMALL = dict(BENCH_DEVICE="cpu", BENCH_TS=str(TS), BENCH_GROUP=str(GB),
             BENCH_DRAIN=str(DB), BENCH_N1=str(N1), BENCH_CAP1=str(CAP1),
             BENCH_MAX_ITER=str(FULL))


def _settings(monkeypatch, batch):
    for k, v in {**SMALL, "BENCH_BATCH": str(batch)}.items():
        monkeypatch.setenv(k, v)
    return bench_torch.settings()


@functools.lru_cache(maxsize=None)
def _jax_solver():
    """tol_tpu's config-1 solver as bench.py builds it (two-body, crp)."""
    jc = jcanonicalize(japi.make_problem("S10", "tempest", ts=TS,
                                         wind_model=1), scaling="auto")
    g = jgrouped(jc, jcondensed(jc, refine=1, chain="crp"),
                 jalm.ALMOptions(max_iter=2000, dual_refine_k=4, max_ls=8,
                                 factor_reuse=1),
                 group_size=GB, drain_size=DB,
                 dive_opts=jalm.ALMOptions(max_iter=2000, dual_refine_k=0,
                                           max_ls=4, factor_reuse=1),
                 dive_kkt=jcondensed(jc, refine=0, chain="crp"))
    end = dict(tol=5e-3, feas_tol=1e-4, mu_init=6e-5, kappa_inner=2.0,
               prox=2.5e-3)
    p = (bench._params(jnp.float64, tol=1e-12, feas_tol=1e-12, prox=0.0,
                       gamma_eager=0.0, max_iter=FULL),
         bench._params(jnp.float64, max_iter=CAP1, **end),
         bench._params(jnp.float64, max_iter=FULL, **end))
    return jc, g, p


def _jax_run(lane_insts, group_insts, dv):
    """bench.py's seeds_for and grouped solve on tol_tpu."""
    jc, g, p = _jax_solver()
    V = []
    for inst, d in zip(lane_insts, dv):
        lb, ub, fixed = [np.asarray(x) for x in jc.bounds(inst)]
        v0 = np.asarray(jc.initial_point(inst))
        V.append(np.where(fixed, lb, np.clip(v0 + d, lb, ub)))
    stacked = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *lane_insts)
    return g(group_insts, stacked, jnp.asarray(np.stack(V)), *p, N1, -1.0)


def _assert_same(rt, rj):
    assert rt.group_iters == rj.group_iters
    assert rt.drain_iters == rj.drain_iters
    np.testing.assert_array_equal(rt.converged, np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.iterations, np.asarray(rj.iterations))
    np.testing.assert_allclose(rt.f, np.asarray(rj.f, np.float64), rtol=1e-6)


def test_params_are_bench_params():
    """_params gives bench.py's values, the mu_min == 0 branch included."""
    for kw in ({}, dict(mu_min=0.0, tol=1e-3, mu_init=6e-5, max_iter=7),
               dict(mu_min=0.0, tol=1.0, mu_init=1e-5, gamma_eager=0.0)):
        pj = bench._params(jnp.float64, **kw)
        pt = bench_torch._params(torch.float64, "cpu", **kw)
        for k in pt._fields:
            a, b = getattr(pt, k), np.asarray(getattr(pj, k))
            assert a.dtype == (torch.int32 if k == "max_iter"
                               else torch.float64)
            assert a.item() == b.item(), k


def test_config1_matches_jax(monkeypatch):
    """Config 1: 4 lanes in 2 groups of 2, every lane drains."""
    s = _settings(monkeypatch, 4)
    ctx = bench_torch.s10_problem(s)
    dv = 0.01 * np.random.default_rng(0).standard_normal((4, ctx["can"].n))
    rt, wall, warm_s, v0s = bench_torch.run_s10(s, ctx, dv)
    assert rt.drain_iters > 0 and wall > 0 and warm_s > 0
    assert v0s.shape == (4, ctx["can"].n)
    jc = _jax_solver()[0]
    rj = _jax_run([jc.nlp.inst0] * 4, [jc.nlp.inst0] * 2, dv)
    _assert_same(rt, rj)
    # one dive step's flops, counted over the first group
    assert bench_torch.dive_step_flops(s, ctx, v0s[:GB]) > 0


def test_config3_sweep_matches_jax(monkeypatch):
    """Config 3: the four airframes, 2 lanes (one group) each; the drain
    chunks take the stragglers in index order, one airframe each."""
    s = _settings(monkeypatch, 8)
    ctx = bench_torch.s10_problem(s)
    dv = 0.01 * np.random.default_rng(2).standard_normal((8, ctx["can"].n))
    rep, rt = bench_torch.run_sweep(s, ctx, dv)
    singles = [jmake_instance(japi.make_config("S10", a, ts=TS, wind_model=1),
                              japi.default_goal("S10"), JWindConfig(model=1))
               for a in bench_torch.AIRFRAMES]
    rj = _jax_run([singles[i // 2] for i in range(8)], singles, dv)
    _assert_same(rt, rj)
    conv = np.asarray(rj.converged)
    assert rep["per_airframe_conv"] == {
        a: int(conv[2 * i:2 * i + 2].sum())
        for i, a in enumerate(bench_torch.AIRFRAMES)}
    assert rep["converged"] == int(conv.sum())
    assert rep["feasible"] == int((np.asarray(rj.constr_viol) < 1e-4).sum())
    # every lane drains (budget 18 > cap 12), two lanes a chunk: one
    # airframe each
    assert bench_torch.drain_mix(s, rt) == dict(
        group_iters=rj.group_iters, drain_iters=rj.drain_iters,
        drained_by_airframe={a: 2 for a in bench_torch.AIRFRAMES},
        drain_chunks=4, chunks_mixing_airframes=0)


def _bench_py_keys(name):
    """Keys of the dict literal bench.py assigns to ``name`` (nested dict
    literals as dicts of their keys)."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())

    def keys(d):
        return {k.value: (keys(v) if isinstance(v, ast.Dict) else None)
                for k, v in zip(d.keys, d.values)}

    found = [n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
             and isinstance(n.value, ast.Dict)
             and any(isinstance(t, ast.Name) and t.id == name
                     for t in n.targets)]
    assert len(found) == 1, name
    return keys(found[0])


def _same_keys(got, want, extra=()):
    """``got`` has ``want``'s keys (and ``extra``), nested dicts alike;
    ``detail`` may add the port's four keys."""
    assert set(got) == set(want) | set(extra), sorted(
        set(got) ^ (set(want) | set(extra)))
    for k, sub in want.items():
        if sub is not None:
            _same_keys(got[k], sub, DETAIL_EXTRA if k == "detail" else ())


def test_the_script_prints_bench_py_json_last():
    """python bench_torch.py on the CPU at ts=8: configs 1, 3, 2 and 5 at
    one lane a group and a few iterations (the replanning legs are too slow
    here; see the next test); the last line is bench.py's JSON."""
    env = {**os.environ, **SMALL, "BENCH_BATCH": "4", "BENCH_GROUP": "1",
           "BENCH_DRAIN": "1", "BENCH_N1": "2", "BENCH_CAP1": "4",
           "BENCH_MAX_ITER": "6", "BENCH_G7_BATCH": "1", "BENCH_G7_ITER": "6",
           "BENCH_G7_CAP": "4", "BENCH_G7_N1": "2", "BENCH_REPLAN": "0",
           "BENCH_STORM_BATCH": "1", "BENCH_STORM_CAP": "4",
           "PYTHONPATH": ROOT}
    out = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    want = _bench_py_keys("result")
    _same_keys(res, want)
    d = res["detail"]
    for name, key in (("sweep", "multi_airframe"), ("g7", "g7_skywalker"),
                      ("storm", "storm_grid")):
        _same_keys(d[key], _bench_py_keys(name))
    assert d["replan"] is None
    assert d["platform"] == "cpu" and d["card"] is None
    assert (d["batch"], d["ts"], d["group"], d["drain"]) == (4, TS, 1, 1)
    assert set(d["compile_breakdown_s"]) == {"s10", "g7", "storm"}
    # no committed draw has ts=8's 100 variables: the generator, said so
    assert set(d["seeds"]) == {"s10", "multi_airframe", "g7", "storm"}
    assert all(v["source"].startswith("numpy default_rng")
               for v in d["seeds"].values())
    assert d["flops_per_iter"] > 0 and d["mfu_pct"] is None
    assert all(np.isfinite(d[k]) for k in ("median_viol", "median_kkt"))
    assert sum(d["multi_airframe"]["per_airframe_conv"].values()) == \
        d["multi_airframe"]["converged"]
    # on the CPU every wrapper takes its twin: no launch; no graph either
    assert not any(d["launches"].values())
    assert set(d["graphs"]) == {"s10", "multi_airframe", "g7_skywalker",
                                "storm_grid"}
    assert all(g["captures"] == 0 and g["peak_mem_gib"] is None
               for g in d["graphs"].values())


def test_replan_loop_is_bench_py_loop(monkeypatch):
    """Config 4's loop around the leg solver: the cold leg to (0, 400), 9
    replans to bench.py's default_rng(7) goals, each stitched to the last
    node of the leg before, and bench.py's keys."""
    import math

    from tol_tpu_torch.mission import mission

    calls = []

    def fake_leg_solver(cfg):
        assert (cfg.aircraft, cfg.leg_max_iter, cfg.leg_ensemble,
                cfg.leg_chain, cfg.leg_chunk) == ("skywalker", 600, 128,
                                                  "crp", 48)

        def solve_leg(kind, goal, stitch=None):
            k = len(calls)
            calls.append((kind, goal, stitch))
            tr = {f: [0.0, float(10 * k + i)] for i, f in enumerate(
                ("Va", "gam", "chi", "phi", "CL", "dphi", "dCL", "T"))}
            return dict(trajectory=tr, iterations=100 + k, converged=k != 3,
                        used_warm=k > 0, cold_retry=False)
        return solve_leg

    monkeypatch.setattr(mission, "default_leg_solver", fake_leg_solver)
    s = _settings(monkeypatch, 4)
    rep = bench_torch.run_replan(s)
    _same_keys(rep, _bench_py_keys("replan"))
    assert (rep["legs"], rep["converged"], rep["cold_iters"]) == (9, 8, 100)
    assert len(calls) == 10 and calls[0][2] is None
    assert (calls[0][1].xg, calls[0][1].yg) == (0.0, 400.0)
    rng = np.random.default_rng(7)
    for k, (kind, goal, st) in enumerate(calls[1:]):
        ang = math.pi / 2 + math.radians(rng.uniform(-10, 10))
        d = 400.0 * (1.0 + rng.uniform(-0.1, 0.1))
        assert kind == "G7"
        assert (goal.xg, goal.yg) == (d * math.cos(ang), d * math.sin(ang))
        assert list(st) == [float(10 * k + i) for i in range(8)]
    assert [x["iters"] for x in rep["per_leg"]] == list(range(101, 110))


def test_bench_draw_takes_the_first_rows_or_says_otherwise():
    dv, note = bench_torch.bench_draw("g7", 3, 1114)
    full = np.load(os.path.join(ROOT, "tests", "bench_seeds", "g7.npy"))
    assert dv.dtype == np.float32 and np.array_equal(dv, full[:3])
    assert note["reduced"] == "first 3 of 256 rows" and note["of"] == 256
    dv, note = bench_torch.bench_draw("g7", 256, 1114)
    assert np.array_equal(dv, full) and "reduced" not in note
    for lanes, n in ((257, 1114), (3, 100)):
        dv, note = bench_torch.bench_draw("g7", lanes, n)
        assert dv.shape == (lanes, n)
        assert note["source"].startswith("numpy default_rng(1)")


@pytest.mark.parametrize("name", sorted(make_bench_seeds.DRAWS))
def test_committed_draws_are_bench_py_draws(name):
    """Each committed file is bit for bit the draw bench.py makes with this
    JAX on the CPU."""
    with open(os.path.join(ROOT, "tests", "bench_seeds", "seeds.json")) as f:
        made = json.load(f)
    if (bool(jax.config.jax_threefry_partitionable)
            != made["jax_threefry_partitionable"]):
        pytest.skip(f"this JAX ({jax.__version__}) defaults to another "
                    f"threefry than the one that wrote the draws "
                    f"({made['jax_version']})")
    want = np.load(os.path.join(ROOT, "tests", "bench_seeds", f"{name}.npy"))
    got = make_bench_seeds.draw(name)
    k, lanes, n, _ = make_bench_seeds.DRAWS[name]
    assert made["draws"][name]["key"] == k
    assert got.shape == want.shape == (lanes, n)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
