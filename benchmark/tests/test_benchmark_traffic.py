"""Each request kind's draws for a given seed, and the gate."""

import itertools
import json
import math
import os
import time

import numpy as np
import pytest

import run
from harness.spec import kind, load_cell
from tiny import SHELVED, any_cell

batch_noise = kind(load_cell("s10_batch")).batch_noise
MISSION = kind(load_cell("g7_replan"))


def leg_goals(seed, tr):
    """The goals of :func:`cycle_legs`' stream of ``(k, goal)``."""
    return (goal for _, goal in MISSION.cycle_legs(seed, tr))

BIG = 2 ** 31 + 12345


def test_batch_noise_is_the_seeds_and_the_batchs():
    a = batch_noise(BIG, 3, 8, 1112, 0.01)
    assert a.dtype == np.float32 and a.shape == (8, 1112)
    assert np.array_equal(a, batch_noise(BIG, 3, 8, 1112, 0.01))
    assert not np.array_equal(a, batch_noise(BIG, 4, 8, 1112, 0.01))
    assert not np.array_equal(a, batch_noise(BIG + 1, 3, 8, 1112, 0.01))
    assert abs(float(batch_noise(7, 0, 256, 1112, 0.01).std()) - 0.01) < 2e-4


def test_batch_noise_first_row_pinned():
    # numpy's stream for [seed, k]: the generator's contract with later runs
    x = np.random.default_rng([5, 0]).standard_normal((2, 3))
    assert np.array_equal(batch_noise(5, 0, 2, 3, 1.0), x.astype(np.float32))


def test_leg_goals_repeat_and_stay_in_the_mix():
    tr = load_cell("g7_replan").traffic
    n = tr["cycle"]
    a = list(itertools.islice(leg_goals(BIG, tr), 3 * n))
    assert a == list(itertools.islice(leg_goals(BIG, tr), 3 * n))
    # the index of each goal runs round the cycle from the seed's first
    k0 = MISSION.first_goal(BIG, tr)
    ks = [k for k, _ in itertools.islice(MISSION.cycle_legs(BIG, tr), 3 * n)]
    assert ks == [(k0 + i) % n for i in range(3 * n)]
    assert a[:n] == a[n:2 * n] and len(set(a[:n])) == n
    for xg, yg, zg, rg in a:
        bearing = math.degrees(math.atan2(yg, xg))
        assert abs(bearing - 90.0) <= 10.0 + 1e-9
        assert 360.0 - 1e-9 <= math.hypot(xg, yg) <= 440.0 + 1e-9
        assert zg == 0.0 and rg == 0.0
    # every seed flies the same cycle from another start; the cycle covers
    # the jitter square evenly: each quarter holds 4-8 of the 24 goals
    starts = set()
    for s in range(1, 40):
        b = list(itertools.islice(leg_goals(s, tr), n))
        assert sorted(b) == sorted(a[:n])
        starts.add(b[0])
    assert len(starts) > n // 2
    quad = [(math.degrees(math.atan2(y, x)) > 90.0, math.hypot(x, y) > 400.0)
            for x, y, _, _ in a[:n]]
    counts = [quad.count(q) for q in set(quad)]
    assert len(counts) == 4 and min(counts) >= 4 and max(counts) <= 8


def test_sweep_mix_fills_whole_groups():
    cell = any_cell("s10_sweep")
    lanes = cell.config["batch"]["lanes"]
    per = lanes // len(cell.traffic["airframes"])
    assert per * len(cell.traffic["airframes"]) == lanes
    assert per % cell.config["batch"]["group"] == 0
    assert cell.config["gate"]["golden_airframe"] == cell.traffic["airframes"][0]


def test_cost_gate_holds_on_the_goldens_airframe_alone():
    cell = any_cell("s10_sweep")
    gate = kind(cell).gate
    air = ["tempest", "tempest_eric", "tempest", "tempest_will"]
    conv = np.array([True, True, True, False])
    viol = np.array([1e-5, 1e-5, 2e-4, 1e-5])
    f_star = 1.0
    f = np.array([1.02, 1.5, 1.0, 1.0])      # a 2% gap, a 50% gap off tempest
    assert gate(cell.config, air, conv, viol, f, f_star).tolist() == \
        [False, True, False, False]
    assert gate(cell.config, air, conv, viol, f, None).tolist() == \
        [True, True, False, False]


@pytest.mark.parametrize("workload", ["s10_batch", "g7_replan", "storm_batch", "g7_batch"]
                         + [w["name"] for w in SHELVED])
def test_a_window_is_a_fixed_count_of_requests(workload):
    spec = json.load(open(os.path.join(os.path.dirname(run.BENCH), "BENCHMARK.json")))
    cell = any_cell(workload)
    per = cell.traffic["request_s"]
    assert run.requests_for(cell, 0.0) == 1
    n = run.requests_for(cell, spec["run_seconds"])
    assert n == round(spec["run_seconds"] / per) and n >= 1
    assert abs(n * per - spec["run_seconds"]) <= per / 2
    if "cycle" in cell.traffic:
        # every seed's window flies the whole cycle twice, from another start
        assert n == 2 * cell.traffic["cycle"]


class _Slow:
    def __init__(self):
        self.k = []

    def request(self, seed, k):
        time.sleep(0.01 * (k + 1))
        self.k.append(k)
        return dict(seed=seed, k=k)


def test_the_window_does_not_follow_the_clock():
    gen = _Slow()
    requests, took = run.window(gen, BIG, 3)
    assert [r["k"] for r in requests] == gen.k == [0, 1, 2]
    assert took >= 0.06
