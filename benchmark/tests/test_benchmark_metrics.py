"""The metric arithmetic on recorded runs, and the roofline counts."""

import math
import os

import pytest

from harness.spec import load_cell, load_module, reader

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RF = load_module(os.path.join(BENCH, "reference", "roofline.py"), "rf_test")


def batch_record(trace=True):
    cell = load_cell("s10_batch")
    reqs = [dict(wall_s=14.0, lanes=1024, gated=1016, failed=8,
                 group_iters=1160, drain_iters=100, groups=8, dive_steps=720),
            dict(wall_s=16.0, lanes=1024, gated=1020, failed=4,
                 group_iters=1200, drain_iters=140, groups=8, dive_steps=720)]
    sess = None
    if trace:
        mk = lambda busy, hand, n: dict(steps=8, busy_s=busy, hand_s=hand,
                                        launches=dict(K1=n[0], K2=n[1], K3=n[2]),
                                        wall_s=busy * 1.2, ops={}, gaps={})
        sess = dict(dive=mk(8 * 8e-3, 8 * 4e-4, (8, 8, 16)),
                    endgame=mk(8 * 14e-3, 8 * 5e-4, (8, 16, 24)),
                    drain=mk(8 * 14e-3, 8 * 5e-4, (8, 16, 24)))
    return cell, dict(kind="grouped_batch", config=cell.config, ts=100, n=1112,
                      setup_s=21.5, window_s=30.5, requests=reqs, trace=sess)


def leg_record(trace=True):
    cell = load_cell("g7_replan")
    ms = [900.0, 1000.0, 1100.0, 2500.0, 950.0, 1200.0, 980.0, 1010.0,
          1020.0, 1700.0, 990.0]
    its = [60, 70, 50, 120, 48, 97, 55, 66, 71, 100, 49]
    reqs = [dict(ms=m, iterations=i, converged=True, lanes=1, gated=1, failed=0,
                 replays=48 * math.ceil(i / 48) + 1)
            for m, i in zip(ms, its)]
    sess = dict(leg0=dict(steps=8, busy_s=8 * 13e-3, hand_s=0.0, wall_s=0.2,
                          launches={}, ops={}, gaps={})) if trace else None
    return cell, dict(kind="mission_legs", config=cell.config, ts=100, n=None,
                      setup_s=30.0, window_s=sum(ms) / 1e3 + 0.1,
                      requests=reqs, trace=sess)


def test_end_to_end_batch():
    cell, rec = batch_record()
    assert reader(cell, "gated_solves_per_s")(rec) == pytest.approx(2036 / 30.5)
    assert reader(cell, "setup_s")(rec) == 21.5
    assert reader(cell, "replan_leg_ms_mean")(rec) is None


def test_end_to_end_legs():
    cell, rec = leg_record()
    ms = [r["ms"] for r in rec["requests"]]
    assert reader(cell, "replan_leg_ms_mean")(rec) == pytest.approx(
        1e3 * rec["window_s"] / len(ms))
    assert reader(cell, "gated_solves_per_s")(rec) is None


def test_per_layer_batch():
    cell, rec = batch_record()
    steps = 1160 + 100 + 1200 + 140
    assert reader(cell, "solver_loop.step_ms.batch")(rec) == pytest.approx(
        1e3 * 30.5 / steps)
    assert reader(cell, "batch_driver.drain_step_share.batch")(rec) == \
        pytest.approx(100.0 * 240 / steps)
    mix = dict(dive=1440, endgame=2360 - 1440, drain=240)
    per = dict(dive=(8e-3, 4e-4), endgame=(14e-3, 5e-4), drain=(14e-3, 5e-4))
    busy = sum(mix[k] * per[k][0] for k in mix) / steps
    hand = sum(mix[k] * per[k][1] for k in mix) / steps
    assert reader(cell, "kkt.aten_device_ms_per_step.batch")(rec) == \
        pytest.approx(1e3 * (busy - hand))
    assert reader(cell, "card.idle_share.batch")(rec) == pytest.approx(
        100.0 * (1.0 - busy / (30.5 / steps)))
    b = lambda n: RF.launches_bound_s(*n, 128, 128, 12)
    bound = (mix["dive"] * b((8, 8, 16)) + (mix["endgame"] + mix["drain"])
             * b((8, 16, 24))) / 8 / steps
    roof = reader(cell, "kernels.crp_roofline.batch")(rec)
    assert roof == pytest.approx(100.0 * bound / hand)
    assert 0.0 < roof < 100.0


def test_per_layer_legs():
    cell, rec = leg_record()
    reqs = rec["requests"]
    assert reader(cell, "mission.winner_iters.replan")(rec) == pytest.approx(
        sum(r["iterations"] for r in reqs) / len(reqs))
    reps = sum(r["replays"] for r in reqs) / len(reqs)
    leg_s = rec["window_s"] / len(reqs)
    assert reader(cell, "card.idle_share.replan")(rec) == pytest.approx(
        100.0 * (1.0 - 13e-3 * reps / leg_s))


def test_trace_metrics_absent_without_a_slice():
    cell, rec = batch_record(trace=False)
    for m in ("kkt.aten_device_ms_per_step.batch", "kernels.crp_roofline.batch",
              "card.idle_share.batch"):
        assert reader(cell, m)(rec) is None
    cell, rec = leg_record(trace=False)
    assert reader(cell, "card.idle_share.replan")(rec) is None
    cell, rec = leg_record()
    rec["requests"][3]["replays"] = None        # no count of the program's
    assert reader(cell, "card.idle_share.replan")(rec) is None


def test_roofline_counts_match_the_kernel_table():
    # PERF.md's kernel table (B = 128, 7 levels): K1 at the S10 border of
    # 12 columns, K2 and K3 at one column; all bound by bytes
    ms = lambda c: 1e3 * RF.bound_s(c)
    assert ms(RF.k1(128, 128, 12)) == pytest.approx(0.01643, rel=2e-3)
    assert ms(RF.k2(128, 128, 1)) == pytest.approx(0.007495, rel=2e-3)
    assert ms(RF.k3(128, 128, 1)) == pytest.approx(0.007476, rel=2e-3)
    for k in (RF.k1, RF.k2, RF.k3):
        nbytes, flops = k(128, 128, 12)
        assert nbytes / RF.HBM_BYTES_PER_S > flops / RF.FP32_FLOP_PER_S


def test_trace_reduction_of_recorded_events():
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    from harness.trace import breakdown, reduce_events
    from reference.roofline import SYMBOLS

    ev = lambda s, e, name, dev=DeviceType.CUDA, th=1: NS(
        time_range=NS(start=s, end=e), device_type=dev, name=name, thread=th)
    events = [
        ev(0, 100, "run", DeviceType.CPU), ev(10, 20, "cudaGraphLaunch", DeviceType.CPU),
        ev(40, 90, "aten::item", DeviceType.CPU), ev(0, 5, "other", DeviceType.CPU, 2),
        ev(12, 30, "void at::native::elementwise_kernel<128>(x)"),
        ev(25, 35, "void factor_fwd_pass_kernel<12>(float*)"),   # overlaps
        ev(50, 52, "fwd_pass_kernel"), ev(60, 64, "bwd_pass_kernel"),
        ev(64, 66, "bwd_pass_kernel")]
    r = reduce_events(events, SYMBOLS)
    assert r["busy_s"] == pytest.approx((35 - 12 + 2 + 6) * 1e-6)
    assert r["hand_s"] == pytest.approx((10 + 2 + 4 + 2) * 1e-6)
    assert r["launches"] == {"K1": 1, "K2": 1, "K3": 2}
    # gaps 35-50 and 52-60 both lie inside aten::item (mid 42.5, 56)
    assert r["gaps"] == {"aten::item": pytest.approx(23e-6)}
    assert r["ops"]["elementwise_kernel<128>(x)"] == pytest.approx(18e-6)
    b = breakdown({"dive": r, "endgame": r})
    assert b["idle_gaps"] == [["aten::item", pytest.approx(46e-6)]]
    assert b["device_ops"][0][0] == "elementwise_kernel<128>(x)"
