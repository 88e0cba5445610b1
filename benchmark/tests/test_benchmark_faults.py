"""The comparison catches a broken timed path: each fault is planted in the
program underneath a whole run (the harness's look for a card skipped, the
CPU at a tiny size), and ``correct`` comes out false.  The sound run at the
same size is ``test_benchmark_harness.test_result_line_on_the_cpu``.

Faults: a step that returns its state unchanged (only the iteration
count moves); half of the batch left out (the other half's answers copied
in); an answer altered where it is produced; for the mission mix, a leg
answered with the previous leg's document.  One chip, so no exchange
between chips exists to leave out."""

import pytest
import torch

import run
from harness.spec import load_cell
from tiny import tiny


def _unchanged_step(monkeypatch):
    from tol_tpu_torch.solver import alm

    monkeypatch.setattr(alm, "_newton_step",
                        lambda kern, opts, st, *a: st._replace(it=st.it + 1))


def _half_batch(monkeypatch):
    from tol_tpu_torch.solver import batch

    real = batch.make_grouped_solver

    def make(*a, **k):
        solve = real(*a, **k)

        def half(group_insts, insts, v0s, *rest):
            h = v0s.shape[0] // 2
            return solve(group_insts, insts, torch.cat([v0s[:h], v0s[:h]]), *rest)
        half.programs = solve.programs
        return half
    monkeypatch.setattr(batch, "make_grouped_solver", make)


def _altered_answer(monkeypatch):
    from tol_tpu_torch.solver import batch

    real = batch.make_grouped_solver

    def make(*a, **k):
        solve = real(*a, **k)

        def altered(*args):
            res = solve(*args)
            res.v[0, 1 + 11 * 5 + 3] += 0.01        # lane 0, node 5's Va
            return res
        altered.programs = solve.programs
        return altered
    monkeypatch.setattr(batch, "make_grouped_solver", make)


@pytest.mark.parametrize("fault,number", [(_unchanged_step, "unanswered"),
                                          (_half_batch, "unanswered"),
                                          (_altered_answer, "viol_err")])
def test_batch_fault_is_not_correct(monkeypatch, fault, number):
    fault(monkeypatch)
    result, _ = run.run_cell(tiny(load_cell("s10_batch")), 2 ** 31 + 7, 0.0,
                             False, "cpu")
    assert result["correct"] is False
    c = result["check"][number]
    assert c["value"] > c["limit"]


def _unchanged_leg_step(monkeypatch):
    _unchanged_step(monkeypatch)


def _altered_leg(monkeypatch):
    from tol_tpu_torch.io import results

    real = results.results_document

    def altered(*a, **k):
        doc = real(*a, **k)
        doc["trajectory"]["x"][5] += 1.0             # node 5 moved 1 m north
        return doc
    monkeypatch.setattr(results, "results_document", altered)


def _stale_leg(monkeypatch):
    from tol_tpu_torch.mission import mission

    real = mission.default_leg_solver

    def make(cfg):
        solve_leg = real(cfg)
        first = []

        def stale(*a, **k):
            doc = solve_leg(*a, **k)
            first.append(doc)
            return first[0]
        stale.programs = solve_leg.programs
        return stale
    monkeypatch.setattr(mission, "default_leg_solver", make)


@pytest.mark.parametrize("fault,number", [(_unchanged_leg_step, "unanswered"),
                                          (_altered_leg, "viol_ratio"),
                                          (_stale_leg, None)])
def test_leg_fault_is_not_correct(monkeypatch, fault, number):
    fault(monkeypatch)
    result, _ = run.run_cell(tiny(load_cell("g7_replan")), 2 ** 31 + 9, 0.0,
                             False, "cpu")
    assert result["correct"] is False
    over = [k for k, c in result["check"].items() if c["value"] > c["limit"]]
    assert over and (number is None or number in over)


def test_control_is_not_correct_on_the_cpu():
    from control import honest, judge, rounded
    from harness import check
    from harness.spec import reference

    cell = tiny(load_cell("s10_batch"))
    result, rec = run.run_cell(cell, 2 ** 31 + 7, 0.0, False, "cpu")
    assert result["correct"] is True
    ref = reference(cell)
    low = rounded(rec["requests"])
    claimed = judge(cell, ref, rec, low)
    fair = judge(cell, ref, rec, honest(cell, ref, low))
    assert claimed["viol_err"] > cell.checks["viol_err"]["limit"]
    assert fair["unanswered"] > cell.checks["unanswered"]["limit"]
    assert not check.verdict(claimed, cell.checks)[0]
    assert not check.verdict(fair, cell.checks)[0]
