"""The mission layer on a gridded wind, fed a new field before every leg.

On the CPU: the mission cells that exist build the MissionConfig, the
records and the judge they built before the feed; a tiny fed mission
cell flies each leg on its own field; a wind key the mission layer has no
field for is refused by name; the feed's file is the reference's field
as the program reads it back; the reference's ``live`` mask.  On the
card: a refreshed field reaches the captured leg program."""

import itertools
import math

import numpy as np
import pytest
import torch

import run
from harness.program import LegSystem
from harness.spec import kind, load_cell, reference
from tiny import tiny

MISSION = kind(load_cell("g7_replan"))
FEED = {"arg": "vortex_center", "radius_m": 100.0}
CYCLE = 24
PARENT_KEYS = {"ms", "goal", "stitch", "iterations", "converged", "used_warm",
               "lanes", "replays", "gated", "failed", "answers"}


def _storm():
    return MISSION._storm(load_cell("g7_replan").bench)


def _grid_wind(order=1):
    return {"model": 3, "order": order,
            "grid": {"builder": _storm().DEMO_BUILDER, "args": {}}}


def _fed_cell():
    """g7_replan cut to the CPU's size and flown through the demo storm at
    order 1, the only order the mission layer takes, fed every leg (48
    iterations a leg: enough to tell two fields apart)."""
    cell = tiny(load_cell("g7_replan"), leg_max_iter=48)
    cell.config["wind"] = _grid_wind()
    cell.config["reference"] = "reference/storm.py"
    cell.traffic["field_feed"] = dict(FEED)
    assert cell.traffic["cycle"] == CYCLE
    return cell


def _mission_configs(monkeypatch):
    """The MissionConfigs that LegSystem hands the program, solving none."""
    from tol_tpu_torch.mission import mission

    made = []

    def capture(cfg):
        made.append(cfg)
        return lambda *a, **k: None
    monkeypatch.setattr(mission, "default_leg_solver", capture)
    return made


def _parent_judge(cell, ref, legs, record, device="cpu") -> dict:
    """``mission_legs.judge`` as it was before the field feed."""
    cfg = cell.config
    ml, ts, wind = cfg["mission_layer"], cfg["ts"], cfg.get("wind")
    sc = ref.Scaling(ref.Problem(cfg["mission"], cfg["aircraft"], ts=ts, wind=wind))
    viol_ratio = cost_err = kkt = 0.0
    for leg in legs:
        a = leg["answers"]
        prob = ref.Problem(cfg["mission"], cfg["aircraft"], goal=leg["goal"],
                           stitch=leg["stitch"], ts=ts, wind=wind)
        J = ref.judge_physical(prob, sc, a["Z"], a["dt"])
        F = float(J["F"])
        cost_err = max(cost_err, abs(a["F"] - F) / max(abs(F), 1e-12))
        if a["converged"]:
            viol_ratio = max(viol_ratio, float(J["viol"]) / ml["feas_tol"])
            kkt = max(kkt, ref.certificate_physical(prob, sc, a["Z"], a["dt"], device))
    unanswered = sum(not leg["answers"]["converged"] for leg in legs)
    return dict(unanswered=unanswered / max(len(legs), 1),
                viol_ratio=viol_ratio, cost_err=cost_err,
                kkt_ratio=kkt / cfg["gate"]["kkt_tol"])


def test_g7_leg_system_builds_the_mission_config_it_built(monkeypatch):
    from tol_tpu_torch.mission.mission import MissionConfig

    made = _mission_configs(monkeypatch)
    system = LegSystem(load_cell("g7_replan").config, "cpu")
    assert system.grid_path is None
    assert made == [MissionConfig(
        aircraft="skywalker", ts=100, wind_model=1, leg_max_iter=600,
        leg_ensemble=128, leg_chain="crp", leg_chunk=48, leg_tol=5e-3,
        leg_feas_tol=1e-4, device="cpu", dtype=torch.float64)]


def test_g7_replan_window_records_and_judge_are_the_parents():
    cell = tiny(load_cell("g7_replan"))
    result, rec = run.run_cell(cell, 2 ** 31 + 23, 0.0, False, "cpu")
    assert result["correct"] is True
    assert [set(r) for r in rec["requests"]] == [PARENT_KEYS]
    numbers = {**result["readings"],
               **{k: c["value"] for k, c in result["check"].items()}}
    assert numbers == _parent_judge(cell, reference(cell), rec["requests"], rec)


def test_a_grid_wind_is_fed_through_a_refreshed_file(monkeypatch):
    import os

    made = _mission_configs(monkeypatch)
    cfg = _fed_cell().config
    system = LegSystem(cfg, "cpu")
    path = system.grid_path
    assert os.path.exists(path)
    assert (made[0].wind_model, made[0].wind_grid_path, made[0].wind_refresh) \
        == (3, path, True)
    del system
    assert not os.path.exists(path)


@pytest.mark.parametrize("key,value", [("order", 2), ("east0", 17000.0),
                                       ("interp", "separable")])
def test_a_wind_key_the_mission_layer_lacks_is_refused_by_name(key, value):
    cfg = _fed_cell().config
    cfg["wind"][key] = value
    with pytest.raises(ValueError, match=f"wind_{key}"):
        LegSystem(cfg, "cpu")


def test_the_feed_moves_its_argument_round_a_circle():
    storm, grid = _storm(), _grid_wind()["grid"]
    base = np.array([17400.0, 25700.0])
    for j in range(CYCLE):
        a = MISSION.field_args(storm, grid, FEED, j, CYCLE)
        d = np.array(a["vortex_center"]) - base
        assert math.hypot(*d) == pytest.approx(100.0)
        assert math.atan2(d[1], d[0]) % (2 * math.pi) == \
            pytest.approx(2 * math.pi * j / CYCLE, abs=1e-12)
        assert set(a) == {"vortex_center"}


def test_the_feeds_file_reads_back_as_the_reference_field(tmp_path):
    from tol_tpu_torch.io import native

    storm = _storm()
    args = MISSION.field_args(storm, _grid_wind()["grid"], FEED, 5, CYCLE)
    f = storm.demo_field(**args)
    path = str(tmp_path / "field.TOLWGRID")
    MISSION.write_grid(path, f)
    g = native.read_wind_grid(path, dtype=torch.float64, device="cpu")
    for c in ("u", "v", "w"):
        assert getattr(g, c).dtype == torch.float32
        assert np.array_equal(getattr(g, c).numpy(), f[c]), c
    assert np.array_equal(g.origin.numpy(), f["origin"])
    assert np.array_equal(g.spacing.numpy(), f["spacing"])
    assert g.live.tolist() == [0.0, 1.0, 0.0]


def test_storm_wind_live_mask():
    storm = _storm()
    wind = {**_grid_wind(order=2), **storm.DATUM}
    p = torch.tensor(np.random.default_rng(4).uniform(
        [-300, -300, -150], [300, 600, 50], (64, 3)), dtype=torch.float64)
    W, G = storm.StormWind(wind).ned(p)
    W1, G1 = storm.StormWind({**wind, "live": [1, 1, 1]}).ned(p)
    assert torch.equal(W, W1) and torch.equal(G, G1)
    assert W.abs().min(0).values.gt(0).all()
    # ENU v is NED north: only component 0 of the NED wind stays live
    q = p.clone().requires_grad_(True)
    Wv, Gv = storm.StormWind({**wind, "live": [0, 1, 0]}).ned(q)
    assert torch.equal(Wv[:, 0], W[:, 0]) and torch.equal(Gv[:, 0], G[:, 0])
    assert not Wv[:, 1:].any() and not Gv[:, 1:].any()
    (grad,) = torch.autograd.grad(Wv[:, 1:].sum(), q, allow_unused=True)
    assert grad is None or not grad.any()


def _fly(cell, seed, monkeypatch=None, legs=2):
    """``legs`` requests of a fed window; with ``monkeypatch`` every leg
    flies field 0's arguments, whatever its field."""
    kind_, gen, _ = run.set_up(cell, "cpu")
    if monkeypatch is not None:
        args = kind_.field_args
        monkeypatch.setattr(kind_, "field_args",
                            lambda storm, grid, feed, j, n: args(storm, grid, feed, 0, n))
    return kind_, [gen.request(seed, k) for k in range(legs)]


def test_a_fed_mission_flies_each_leg_on_its_field(monkeypatch):
    tr = load_cell("g7_replan").traffic
    seed = next(s for s in itertools.count(2 ** 31)
                if MISSION.first_goal(s, tr) == 0)
    kind_, fed = _fly(_fed_cell(), seed)
    with monkeypatch.context() as m:
        _, same = _fly(_fed_cell(), seed, m)
    assert [r["field"] for r in fed] == [0, 1]
    assert fed[0]["field_args"] == same[0]["field_args"] == same[1]["field_args"]
    assert fed[1]["field_args"] != fed[0]["field_args"]
    a0, b0 = fed[0]["answers"], same[0]["answers"]
    assert np.array_equal(a0["Z"], b0["Z"]) and a0["dt"] == b0["dt"]
    a1, b1 = fed[1]["answers"], same[1]["answers"]
    assert not np.array_equal(a1["Z"], b1["Z"])
    # the judge builds each leg's reference in that leg's field, v alone live
    cell = _fed_cell()
    ref = reference(cell)
    winds = []

    class Problem(ref.Problem):
        def __init__(self, *a, wind=None, **k):
            winds.append(wind)
            super().__init__(*a, wind=wind, **k)
    monkeypatch.setattr(ref, "Problem", Problem)
    numbers = kind_.judge(cell, ref, fed, {})
    assert [w["grid"]["args"] for w in winds[1:]] == [r["field_args"] for r in fed]
    assert all(w["live"] == [0.0, 1.0, 0.0] for w in winds[1:])
    assert set(numbers) == {"unanswered", "viol_ratio", "cost_err", "kkt_ratio"}
    assert all(math.isfinite(v) for v in numbers.values()), numbers


@pytest.mark.cuda
def test_a_refreshed_field_reaches_the_captured_leg_program(card, tmp_path):
    """After a refresh the captured leg program answers for the new field
    bit for bit as a fresh ProgramCache does, and not as for the old one
    (the refill of the Instance's grid into the program's static buffers
    is what the feed rests on)."""
    from tol_tpu_torch.config import Goal
    from tol_tpu_torch.mission.mission import MissionConfig, default_leg_solver

    cfg = load_cell("g7_replan").config
    ml, storm, grid = cfg["mission_layer"], _storm(), _grid_wind()["grid"]
    path = str(tmp_path / "field.TOLWGRID")
    mcfg = MissionConfig(
        aircraft=cfg["aircraft"], ts=cfg["ts"], wind_model=3,
        wind_grid_path=path, wind_refresh=True, warm_start=False,
        leg_ensemble=0, leg_chain=ml["chain"], leg_max_iter=ml["leg_max_iter"],
        leg_tol=ml["tol"], leg_feas_tol=ml["feas_tol"], device=card,
        dtype=torch.float32)
    goal = Goal(0.0, 400.0, 0.0, 0.0)

    def fly(solve_leg, j):
        MISSION.write_grid(path, storm.demo_field(
            **MISSION.field_args(storm, grid, FEED, j, CYCLE)))
        doc = solve_leg("G7", goal)
        tr = doc["trajectory"]
        return (np.array([tr[k] for k in sorted(tr)]), doc["dt"],
                doc["FinalCost"], doc["iterations"], doc["converged"])

    solve_leg = default_leg_solver(mcfg)
    first = fly(solve_leg, 0)
    captured = solve_leg.programs.captures
    refreshed = fly(solve_leg, 1)
    assert captured >= 1 and solve_leg.programs.captures == captured
    fresh = fly(default_leg_solver(mcfg), 1)
    assert np.array_equal(refreshed[0], fresh[0]) and refreshed[1:] == fresh[1:]
    assert not np.array_equal(refreshed[0], first[0])
