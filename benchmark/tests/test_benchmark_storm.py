"""The storm cell ``storm_batch``: it loads by name, a tiny window of it
reads ``correct`` true on the CPU, and its reference loads nothing of the
program."""

import os
import subprocess
import sys

import run
from harness.spec import load_cell, reference
from tiny import tiny

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_storm_batch_loads():
    cell = load_cell("storm_batch")
    assert cell.config_name == "s10_storm" and cell.chips == 1
    assert cell.config["wind"]["model"] == 3
    assert cell.traffic["kind"] == "grouped_batch"
    assert set(cell.checks) == {"unanswered", "viol_err", "cost_err", "kkt_ratio"}
    assert [m["name"] for m in cell.end_to_end] == ["gated_solves_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == [
        "solver_loop.step_ms.batch", "batch_driver.drain_step_share.batch",
        "kkt.aten_device_ms_per_step.batch", "kernels.crp_roofline.batch",
        "card.idle_share.batch"]
    ref = reference(cell)
    prob = ref.Problem("S10", "tempest", wind=cell.config["wind"])
    assert prob.storm.order == 2 and tuple(prob.storm.samples.shape) == (3, 8, 8, 6)


def test_tiny_storm_window_is_correct_on_the_cpu():
    result, rec = run.run_cell(tiny(load_cell("storm_batch")), 2 ** 33 + 18,
                               0.0, False, "cpu")
    assert result["correct"] is True and result["attempted"] == 2
    assert rec["requests"][0]["gated"] == 2
    assert set(result["metrics"]) == {"gated_solves_per_s", "setup_s"}
    for name, c in result["check"].items():
        assert c["value"] <= c["limit"], name


def test_storm_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import reference.storm; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))") % BENCH
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=BENCH).stdout
    assert not set(eval(out)) & {"tol_tpu_torch", "tol_tpu", "jax", "jaxlib",
                                 "flax"}
