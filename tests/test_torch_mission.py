"""The port's mission layer, results IO and CLI against tol_tpu's on the
same inputs (float64, CPU).

The host-side pieces (haversine, trajectory stitching and exports, the
results document, the receding-horizon loop with a fake leg solver) must
give the reference's values exactly.  The real leg solves are compared by
iteration counts, flags and values within stated tolerances.

G7's default scaling differs between the packages in one row (the two
draw other perturbations; ROADMAP.md queue C), so the real G7 legs below
hand tol_tpu's scaling to the port's canonicalize, as
tests/test_torch_g7.py does: both packages then solve the same problem.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tol_tpu import __main__ as jmain
from tol_tpu.api import make_problem as jmake_problem
from tol_tpu.config import Goal as JGoal
from tol_tpu.config import StitchState as JStitch
from tol_tpu.io import results as jresults
from tol_tpu.mission import console as jconsole
from tol_tpu.mission import mission as jmission
from tol_tpu.mission import trajectory as jtrajectory
from tol_tpu.mission.autopilot import FakeAutopilot as JFake
from tol_tpu.mission.autopilot import haversine_enu as jhaversine
from tol_tpu.solver import alm as jalm
from tol_tpu.solver import canonicalize as jcanonicalize
from tol_tpu_torch import __main__ as tmain
from tol_tpu_torch.api import make_config as tmake_config
from tol_tpu_torch.config import Goal as TGoal
from tol_tpu_torch.config import StitchState as TStitch
from tol_tpu_torch.io import results as tresults
from tol_tpu_torch.mission import console as tconsole
from tol_tpu_torch.mission import mission as tmission
from tol_tpu_torch.mission import trajectory as ttrajectory
from tol_tpu_torch.mission.autopilot import FakeAutopilot as TFake
from tol_tpu_torch.mission.autopilot import haversine_enu as thaversine
from tol_tpu_torch.solver import alm as talm
from tol_tpu_torch.solver import canonical as tcanonical


def fake_leg_solver(mission_type, goal, stitch=None, v0=None, n=11, dt=0.5):
    """A straight-line (G7) or circular (S10) leg document with the
    snopt_results.json schema (as tests/test_mission.py builds it)."""
    if mission_type == "G7":
        xs = list(np.linspace(0.0, goal.xg, n))
        ys = list(np.linspace(0.0, goal.yg, n))
    else:
        th = np.linspace(0.5 * np.pi, 2.5 * np.pi, n)
        xs = list(goal.rg * np.sin(th) + goal.xg)
        ys = list(-goal.rg * np.cos(th) + goal.yg)
    zeros = [0.0] * n
    return {
        "dt": dt, "converged": True,
        "trajectory": {
            "time": [k * dt for k in range(n)], "x": xs, "y": ys, "z": zeros,
            "Va": [15.0] * n, "gam": zeros, "chi": zeros, "phi": zeros,
            "CL": [0.5] * n, "dphi": zeros, "dCL": zeros, "T": [5.0] * n,
        },
    }


def test_haversine_matches():
    rng = np.random.default_rng(0)
    for lat, lon, alt in rng.uniform([39.9, -105.6, 1500.0],
                                     [40.4, -104.9, 2500.0], (8, 3)):
        assert thaversine(40.1451, -105.2408, 1676.0, lat, lon, alt) == \
            jhaversine(40.1451, -105.2408, 1676.0, lat, lon, alt)


def test_trajectory_stitching_and_exports_match(tmp_path):
    trs = []
    for mod, Goal in ((jtrajectory, JGoal), (ttrajectory, TGoal)):
        tr = mod.Trajectory(40.0, -105.0, 1600.0)
        tr.append_leg(fake_leg_solver("G7", Goal(100.0, 50.0, 0.0, 0.0)), 0.0,
                      (10.0, 20.0, 70.0))
        tr.mark_sent()
        tr.append_leg(fake_leg_solver("S10", Goal(-60.0, 0.0, 0.0, 60.0)),
                      tr.t[-1], (tr.east[-1], tr.north[-1], tr.up[-1]))
        trs.append(tr)
    jt, tt = trs
    assert tt.to_json() == jt.to_json()
    assert tt.end_state() == jt.end_state()
    assert tt.waypoints(every=3) == jt.waypoints(every=3)
    for tr, name in ((jt, "j"), (tt, "t")):
        tr.write_to_kml(str(tmp_path / f"{name}.kml"))
        tr.write_to_json(str(tmp_path / f"{name}.json"))
    assert (tmp_path / "t.kml").read_text() == (tmp_path / "j.kml").read_text()
    back = ttrajectory.Trajectory()
    back.read_from_json(str(tmp_path / "j.json"))
    assert back.to_json() == jt.to_json()


def test_results_document_json_and_txt_match(tmp_path):
    rng = np.random.default_rng(1)
    Z = rng.normal(size=(9, 11))
    docs = []
    for mod, cfg, Goal, z in (
            (jresults, __import__("tol_tpu.api", fromlist=["x"]).make_config(
                "S10", "tempest", ts=8), JGoal, jnp.asarray(Z)),
            (tresults, tmake_config("S10", "tempest", ts=8), TGoal,
             torch.tensor(Z))):
        doc = mod.results_document(cfg, Goal(-100.0, 0.0, 0.0, 100.0), z,
                                   0.75, 3.25, aircraft_name="tempest",
                                   east=1.0, north=2.0, up=3.0)
        docs.append(doc)
    jd, td = docs
    assert td == jd
    assert json.dumps(td, sort_keys=True) == json.dumps(jd, sort_keys=True)
    jresults.write_results_txt(str(tmp_path / "j.txt"), jd)
    tresults.write_results_txt(str(tmp_path / "t.txt"), td)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    tresults.write_results_json(str(tmp_path / "t.json"), td)
    assert jresults.read_results_json(str(tmp_path / "t.json")) == jd
    from tol_tpu_torch.io import read_results_json, write_results_json
    assert write_results_json is tresults.write_results_json
    assert read_results_json(str(tmp_path / "t.json")) == td


@pytest.mark.parametrize("goal", [(400.0, 0.0, 70.0, 100.0),
                                  (300.0, 100.0, 0.0, 0.0),
                                  (200.0, 0.0, 0.0, 0.0)])
def test_mission_run_with_a_fake_leg_solver_matches(goal):
    """Legs, log, stitched trajectory and uploaded waypoints equal."""
    out = []
    for mod, Fake in ((jmission, JFake), (tmission, TFake)):
        calls = []

        def solver(mission_type, g, stitch=None, v0=None):
            calls.append((mission_type, tuple(g),
                          None if stitch is None else tuple(stitch)))
            return fake_leg_solver(mission_type, g)

        m = mod.Mission(mod.MissionConfig(max_legs=10), Fake(),
                        leg_solver=solver)
        traj = m.run(goal)
        n = m.upload()
        out.append((calls, m.log, traj.to_json(), n, m.ap.uploaded,
                    m.locate()))
    assert out[1] == out[0]
    assert len(out[0][0]) >= 1


def test_console_with_a_fake_leg_solver_matches(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    printed = []
    for mod, mmod, Fake in ((jconsole, jmission, JFake),
                            (tconsole, tmission, TFake)):
        lines = []
        m = mmod.Mission(mmod.MissionConfig(max_legs=6), Fake(),
                         leg_solver=fake_leg_solver)
        mod.Console(m, print_fn=lines.append, input_fn=lambda _: "5",
                    autostack=[2, 1, 2, 1]).run()
        printed.append(lines[1:])     # the banner names the package
    assert printed[1] == printed[0]
    assert any("waypoint count" in line for line in printed[0])


def _carry_jax_scaling(monkeypatch, ts):
    """The port's canonicalize takes tol_tpu's default scaling of the same
    problem (see the module docstring)."""
    real = tcanonical.default_scaling

    def jax_scaling(nlp, dtype=None):
        if nlp.mission != "G7":
            return real(nlp, dtype)
        jn = jmake_problem("G7", "skywalker", ts=ts, wind_model=1)
        sc = jcanonicalize(jn, scaling="auto").scaling
        return tcanonical.scaling_from_numpy(
            jax.tree_util.tree_map(np.asarray, sc)._asdict(), device="cpu")

    monkeypatch.setattr(tcanonical, "default_scaling", jax_scaling)


def _closure(solve_leg, name):
    return solve_leg.__closure__[
        solve_leg.__code__.co_freevars.index(name)].cell_contents


G7_TS = 8


def _leg_configs(**kw):
    common = dict(aircraft="skywalker", ts=G7_TS, wind_model=1, **kw)
    return (jmission.MissionConfig(**common),
            tmission.MissionConfig(device="cpu", dtype=torch.float64,
                                   **common))


def _same_leg(dt_, dj, tol):
    for key in ("converged", "iterations", "used_warm", "cold_retry"):
        assert dt_[key] == dj[key], key
    assert sorted(dt_) == sorted(dj)
    assert dt_["FinalCost"] == pytest.approx(dj["FinalCost"], rel=tol)
    for k, col in dj["trajectory"].items():
        np.testing.assert_allclose(dt_["trajectory"][k], col, rtol=0,
                                   atol=tol * max(1.0, np.abs(col).max()))


def test_single_lane_g7_leg_then_warm_replan_matches(monkeypatch):
    """One cold G7 leg at ts=8 on the single-lane path (chain "cr"), then
    a replan 10 degrees off its course, warm-started from it and stitched
    to its terminal state.  A scaled feasibility tolerance of 1e-2 keeps
    the legs at some 20 iterations each on the CPU (1e-4 takes 300).  Same
    iterations and flags; f and trajectory within 1e-8 relative (float64
    round-off over the Newton steps)."""
    _carry_jax_scaling(monkeypatch, G7_TS)
    jcfg, tcfg = _leg_configs(leg_max_iter=600, leg_feas_tol=1e-2)
    jsolve, tsolve = jmission.default_leg_solver(jcfg), \
        tmission.default_leg_solver(tcfg)
    dj = jsolve("G7", JGoal(0.0, 400.0, 0.0, 0.0))
    dt_ = tsolve("G7", TGoal(0.0, 400.0, 0.0, 0.0))
    assert dj["converged"] and not dj["used_warm"]
    _same_leg(dt_, dj, 1e-8)
    tr = dj["trajectory"]
    stitch = [tr[k][-1] for k in ("Va", "gam", "chi", "phi", "CL", "dphi",
                                  "dCL", "T")]
    ang = math.pi / 2 + math.radians(10.0)
    g = (380.0 * math.cos(ang), 380.0 * math.sin(ang), 0.0, 0.0)
    dj2 = jsolve("G7", JGoal(*g), stitch=JStitch(*stitch))
    dt2 = tsolve("G7", TGoal(*g), stitch=TStitch(*stitch))
    assert dj2["used_warm"]
    _same_leg(dt2, dj2, 1e-8)


def test_ensemble_leg_seeds_lanes_and_winner_match(monkeypatch):
    """The seed ensemble at E=4 and one slice (leg_chunk = leg_max_iter =
    24).  The noise differs (torch.Generator against jax.random), so the
    lanes without noise are compared: lane 0 (the base point) and lane
    n_warm (the cold seed), seeds to 1e-12 and their 24-step results (same
    iterations and flags, f to 1e-9 relative).  pick_winner agrees with the
    JAX package's on constructed results."""
    _carry_jax_scaling(monkeypatch, G7_TS)
    N, E = 24, 4
    jcfg, tcfg = _leg_configs(leg_max_iter=N, leg_chunk=N, leg_ensemble=E,
                              leg_chain="crp")
    jsolve, tsolve = jmission.default_leg_solver(jcfg), \
        tmission.default_leg_solver(tcfg)
    goal = (0.0, 400.0, 0.0, 0.0)
    dj = jsolve("G7", JGoal(*goal))
    dt_ = tsolve("G7", TGoal(*goal))
    for d in (dj, dt_):
        assert d["ensemble"] == E and not d["used_warm"]
        assert d["iterations"] <= N
    (_, jcan, _, run_ens, _, jseeds, jpick, pbase, pcfg) = \
        _closure(jsolve, "cache")["G7"]
    tcan, tkkt, topts, tpbase, _ = _closure(tsolve, "cache")["G7"]

    from tol_tpu.models.wind import WindConfig as JWind
    from tol_tpu.problems.base import make_instance as jinstance
    from tol_tpu_torch.models.wind import WindConfig as TWind
    from tol_tpu_torch.problems.base import make_instance as tinstance
    jinst = jinstance(pcfg, JGoal(*goal), JWind(model=1))
    tinst = tinstance(pcfg, TGoal(*goal), TWind(model=1), device="cpu")
    n_warm = 1
    v0j, y0j = jseeds(jinst, jnp.zeros(jcan.n), jnp.zeros(jcan.m),
                      jax.random.PRNGKey(7919 + E), jnp.asarray(n_warm))
    v0t, y0t = tmission.build_seeds(
        tcan, tinst, torch.zeros(tcan.n, dtype=torch.float64),
        torch.zeros(tcan.m, dtype=torch.float64), n_warm, E,
        torch.Generator().manual_seed(7919 + E))
    lanes = [0, n_warm]
    np.testing.assert_allclose(v0t[lanes].numpy(), np.asarray(v0j)[lanes],
                               rtol=0, atol=1e-12)
    assert not torch.equal(v0t[2], v0t[3])
    oj = run_ens(jinst, v0j, y0j, pbase._replace(max_iter=jnp.asarray(N, jnp.int32)))
    ot = talm.solve(tcan, tkkt, topts, inst=tinst, v0=v0t, y0=y0t,
                    params=tpbase._replace(max_iter=torch.tensor(N)),
                    keep_state=True)
    np.testing.assert_array_equal(ot.iterations[lanes].numpy(),
                                  np.asarray(oj.iterations)[lanes])
    np.testing.assert_array_equal(ot.converged[lanes].numpy(),
                                  np.asarray(oj.converged)[lanes])
    np.testing.assert_allclose(ot.f[lanes].numpy(), np.asarray(oj.f)[lanes],
                               rtol=1e-9)
    assert dt_["winner_lane"] == tmission.pick_winner(ot)

    for conv, f, viol in (([0, 1, 1, 0], [0.0, 3.0, 2.0, -1.0],
                           [1e-3, 1e-5, 1e-6, 0.0]),
                          ([0, 0, 0, 0], [1.0, 2.0, 3.0, 4.0],
                           [1e-2, 1e-5, 2e-5, 1e-5]),
                          ([1, 1, 0, 1], [2.0, 2.0, 1.0, 5.0],
                           [0.0, 0.0, 0.0, 0.0])):
        z = np.zeros((E, 3))
        rj = jalm.ALMResult(
            v=jnp.asarray(z), y=jnp.asarray(z), zl=jnp.asarray(z),
            zu=jnp.asarray(z), f=jnp.asarray(f),
            iterations=jnp.zeros(E, jnp.int32),
            converged=jnp.asarray(conv, bool), kkt_err=jnp.zeros(E),
            constr_viol=jnp.asarray(viol))
        rt = talm.ALMResult(
            v=None, y=None, zl=None, zu=None, f=torch.tensor(f),
            iterations=None, converged=torch.tensor(conv, dtype=torch.bool),
            kkt_err=None, constr_viol=torch.tensor(viol))
        assert tmission.pick_winner(rt) == int(jpick(rj)[0])


def test_wind_refresh_rereads_the_grid_before_each_leg(tmp_path, monkeypatch):
    """With wind_refresh the TOLWGRID file is read before every leg and the
    new field reaches the solve; without it, once (tests/test_mission.py's
    check, on the port)."""
    from tol_tpu_torch.io import native

    nx, ny, nz = 4, 4, 3
    path = str(tmp_path / "wind.TOLWGRID")

    def write(vval):
        native.write_wind_grid(path, (17000.0, 25500.0, 0.0), (150.0,) * 3,
                               np.zeros((nx, ny, nz)),
                               np.full((nx, ny, nz), vval),
                               np.zeros((nx, ny, nz)))

    calls = []
    real = native.read_wind_grid
    monkeypatch.setattr(native, "read_wind_grid",
                        lambda *a, **k: (calls.append(a[0]), real(*a, **k))[1])
    goal = TGoal(-100.0, 0.0, 0.0, 100.0)
    errs = []
    for refresh in (True, False):
        write(1.0)
        calls.clear()
        solver = tmission.default_leg_solver(tmission.MissionConfig(
            ts=8, wind_model=3, wind_grid_path=path, wind_refresh=refresh,
            leg_max_iter=3, leg_tol=1e-3, device="cpu", dtype=torch.float64))
        d1 = solver("S10", goal)
        write(5.0)
        d2 = solver("S10", goal)
        assert len(calls) == (2 if refresh else 1)
        errs.append((d1["kkt_err"], d2["kkt_err"]))
    # refreshed: the 5x stronger field changes the second leg's defect
    # rows, so its KKT error
    assert abs(errs[0][1] - errs[0][0]) > 1e-3 * errs[0][0]
    # not refreshed: both legs saw the first field
    assert errs[1][1] == errs[1][0] == errs[0][0]


def test_cli_document_matches(tmp_path, capsys):
    """The flagship loiter through both CLIs at ts=8 for 20 iterations (the
    port with --device cpu, float64 there): the same document keys and
    args, the same iterations and exit code, f and trajectory within 1e-9
    relative."""
    args = ["0", "0", "0", "0", "-100", "0", "100", "tempest", "S10",
            "--ts", "8", "--max-iter", "20"]
    rj = jmain.solve_cli(args + ["--out", str(tmp_path / "j.json")])
    rt = tmain.solve_cli(args + ["--out", str(tmp_path / "t.json"),
                                 "--device", "cpu"])
    assert rt == rj
    out = capsys.readouterr().out
    assert out.count("TOL STATUS: Solving now") == 2
    dj = json.loads((tmp_path / "j.json").read_text())
    dt_ = json.loads((tmp_path / "t.json").read_text())

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None
                for k, v in d.items()}

    assert keys(dt_) == keys(dj)
    for sec in ("args", "aircraft", "gains", "limits", "snopt"):
        assert dt_[sec] == dj[sec]
    assert dt_["iterations"] == dj["iterations"] == 20
    assert dt_["converged"] == dj["converged"]
    assert dt_["FinalCost"] == pytest.approx(dj["FinalCost"], rel=1e-9)
    for k, col in dj["trajectory"].items():
        np.testing.assert_allclose(dt_["trajectory"][k], col, rtol=0,
                                   atol=1e-9 * max(1.0, np.abs(col).max()))
