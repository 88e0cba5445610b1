"""The harness end to end on the CPU at a tiny size: the result line, the
refusal without a card, the modules a run loads, and a cell added by new
files alone."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

import run
from harness.spec import kind, load_cell, reader
from tiny import tiny

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert run.main(["--workload", "s10_batch", "--seed", "1", "--seconds", "1"]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "CUDA" in err


def test_result_line_on_the_cpu():
    result, rec = run.run_cell(tiny(load_cell("s10_batch")), 2 ** 31 + 7, 0.0,
                               True, "cpu")
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == KEYS and list(line)[-1] == "check"
    assert line["correct"] is True and line["attempted"] == 2
    assert line["device"]["platform"] == "cpu"
    # the card-only numbers are absent: no slice, no busy time, no card
    assert "busy_s" not in line["device"] and "breakdown" not in line
    assert "card" not in line
    assert set(line["metrics"]) == {"solver_loop.step_ms.batch",
                                    "batch_driver.drain_step_share.batch"}
    for name, c in line["check"].items():
        assert c["value"] <= c["limit"], name
    assert rec["requests"][0]["gated"] == 2


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = f"""
import sys
sys.path[:0] = [{BENCH!r}, {os.path.join(BENCH, 'tests')!r}]
import run
from tiny import any_cell, tiny
cell = tiny(any_cell("g7_batch"), budget=4, group_cap=4, dive_iters=2)
run.run_cell(cell, 3, 0.0, False, "cpu")
print(run.loaded_forbidden(), "tol_tpu_torch" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-2] == "[] True"


def _digest(top):
    h = {}
    for d, _, files in os.walk(top):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                h[os.path.relpath(p, top)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return h


def test_a_cell_is_added_by_new_files_alone(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    before = _digest(tmp_path)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    # a new request kind, a mix of it, its cell, its check limits and a
    # per-layer metric
    (tmp_path / "benchmark/kinds/one_group.py").write_text(
        "from harness.spec import load_module\n"
        "import os\n"
        "base = load_module(os.path.join(os.path.dirname(__file__), "
        "'grouped_batch.py'), 'base_kind')\n"
        "judge = base.judge\n"
        "class System(base.System):\n"
        "    def request(self, seed, k):\n"
        "        return super().request(seed, k)\n")
    (tmp_path / "benchmark/traffic/half_noise.json").write_text(json.dumps(
        {"kind": "one_group", "noise_std": 0.005, "warm_iters": 2}))
    (tmp_path / "benchmark/checks/s10_half_noise.json").write_text(
        (tmp_path / "benchmark/checks/s10_batch.json").read_text())
    (tmp_path / "benchmark/metrics/batch_driver.groups.half.py").write_text(
        "def read(rec):\n    return sum(r['groups'] for r in rec['requests'])\n")
    spec["workloads"].append({"name": "s10_half_noise", "config": "s10_tempest",
                              "traffic": "half_noise", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "batch_driver.groups.half", "unit": "groups",
                              "better": "lower", "source": "program_counter",
                              "layer": "batch driver", "moves": "gated_solves_per_s",
                              "workloads": ["s10_half_noise"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = load_cell("s10_half_noise", root=str(tmp_path))
    assert cell.traffic["noise_std"] == 0.005
    assert kind(cell).System.__mro__[1].__name__ == "System"
    assert cell.config["name"] == "s10_tempest"
    assert [m["name"] for m in cell.per_layer][-1] == "batch_driver.groups.half"
    assert reader(cell, "batch_driver.groups.half")(
        {"requests": [{"groups": 8}, {"groups": 8}]}) == 16
    after = _digest(tmp_path)
    changed = {k for k in before if before[k] != after.get(k)}
    assert changed == {"BENCHMARK.json"}
