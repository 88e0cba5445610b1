"""The program's spans (``tol_tpu_torch/utils/profiling.py``).

Port only, float64 on the CPU, S10 at ts=8: the recorder off and on, the
spans the solve path opens (their nesting, parents and request ids, and
each region of a Newton step once per substep), the replays and checks
it records by program, the attribution of replay gaps and of device
operations on synthetic records, and, on the card, that a capture made
with the recorder on gives the graph and the bits of one made with it off.

This file imports neither JAX nor the JAX package; on a GPU machine:

    python -m pytest tests/test_torch_tracing.py -m cuda --noconftest -o addopts="" -q
"""

import json
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from tol_tpu_torch.api import make_problem
from tol_tpu_torch.solver import alm
from tol_tpu_torch.solver.batch import make_grouped_solver
from tol_tpu_torch.solver.canonical import canonicalize
from tol_tpu_torch.solver.kkt_condensed import make_condensed_kkt
from tol_tpu_torch.utils import profiling
from tol_tpu_torch.utils.profiling import REGIONS, recording, span

TS = 8
DIVE = dict(max_iter=2000, dual_refine_k=0, max_ls=4)
END = dict(max_iter=2000, dual_refine_k=4, max_ls=8)


def _params(dtype=torch.float64, device="cpu", **kw):
    """bench.py's parameter set with overrides (the dive's by default)."""
    p = dict(tol=1e-12, feas_tol=1e-12, mu_init=1e-5, mu_min=1e-5,
             mu_shrink=0.1, theta_mu=1.2, gamma_init=0.01, gamma_min=1e-6,
             gamma_shrink=0.2, prox=0.0, eta=1e-4, tau_min=0.99,
             kappa_inner=1.0, delta_decay=0.2, gamma_eager=0.0, max_iter=400)
    p.update(kw)
    mi = p.pop("max_iter")
    return alm.ALMParams(**{k: torch.tensor(v, dtype=dtype, device=device)
                            for k, v in p.items()},
                         max_iter=torch.tensor(mi, dtype=torch.int32,
                                               device=device))


def _can(dtype=torch.float64, device="cpu"):
    nlp = make_problem("S10", "tempest", ts=TS, wind_model=1, dtype=dtype,
                       device=device)
    return canonicalize(nlp, scaling="auto")


def _seeds(can, n, seed=0):
    lb, ub, fixed = can.bounds(can.nlp.inst0)
    dv = torch.as_tensor(0.01 * np.random.default_rng(seed).standard_normal(
        (n, can.n)), dtype=lb.dtype, device=lb.device)
    v = torch.minimum(torch.maximum(can.initial_point() + dv, lb), ub)
    return torch.where(fixed, lb, v)


@pytest.fixture(scope="module")
def can():
    return _can()


# ---------------------------------------------------------------------------
# off and on
# ---------------------------------------------------------------------------


def test_off_span_is_the_shared_no_op_and_records_nothing(can, monkeypatch):
    """Off (the default): every span and replay is one shared no-op
    context, no ``record_function`` range opens, and a solve through the
    program records nothing."""
    assert profiling._recorder is None
    assert span("batch.solve") is profiling._OFF
    assert profiling.replay(2, True) is profiling._OFF

    def refused(name):
        raise AssertionError(f"record_function({name!r}) while off")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    cache = alm.ProgramCache()
    out = alm.solve(can, make_condensed_kkt(can, refine=0),
                    alm.ALMOptions(**DIVE), v0=_seeds(can, 2),
                    params=_params(max_iter=2), _loop="program",
                    _programs=cache)
    assert profiling._recorder is None
    assert len(cache.programs) == 1 and out.iterations.tolist() == [2, 2]


def test_spans_nest_with_parents_and_request_ids():
    """Spans record their parent and the request of the outermost
    ``batch.solve`` or ``mission.leg`` open; totals and counts go into
    ``stage_timer``'s table, and self time leaves out the children."""
    with recording() as rec:
        with span("outside"):
            pass
        for _ in range(2):
            with span("batch.solve"):
                with span("batch.group"):
                    with span("alm.check"):
                        pass
                    with span("alm.replay"):
                        pass
        with span("mission.leg"):
            with span("mission.leg"):       # nested: the outer's request
                pass
    names = [s[0] for s in rec.spans]
    assert names == ["outside", "batch.solve", "batch.group", "alm.check",
                     "alm.replay", "batch.solve", "batch.group", "alm.check",
                     "alm.replay", "mission.leg", "mission.leg"]
    parents = [s[1] for s in rec.spans]
    assert parents == [None, None, 1, 2, 2, None, 5, 6, 6, None, 9]
    assert [s[2] for s in rec.spans] == [None, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3]
    assert all(s[3] <= s[4] for s in rec.spans)
    assert rec.counts == {"outside": 1, "batch.solve": 2, "batch.group": 2,
                          "alm.check": 2, "alm.replay": 2, "mission.leg": 2}
    assert rec.report().splitlines()[0].startswith("alm.check: ")
    sm = rec.summary()
    assert sm["requests"] == 3
    g = sm["spans"]["batch.group"]
    kids = sum(sm["spans"][k]["total_s"] for k in ("alm.check", "alm.replay"))
    assert math.isclose(g["self_s"], g["total_s"] - kids, abs_tol=1e-9)
    # no replay was timed: the whole window is one gap
    assert sm["replay_s"] == 0
    assert math.isclose(sum(sm["gaps"].values()), sm["window_s"])


def test_recording_nests_and_trace_names_the_spans(tmp_path):
    """A recording inside another is fresh and gives the outer one back;
    ``trace`` switches the recorder on, so its Chrome trace carries the
    span names."""
    with recording() as outer:
        with span("a"):
            with recording() as inner:
                with span("b"):
                    pass
            assert profiling._recorder is outer
    assert profiling._recorder is None
    assert outer.counts == {"a": 1} and inner.counts == {"b": 1}
    with profiling.trace(str(tmp_path)) as prof:
        with span("batch.solve"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "batch.solve" for e in events)


# ---------------------------------------------------------------------------
# the solve path's spans
# ---------------------------------------------------------------------------


def test_replays_checks_and_region_spans_on_a_cpu_solve(can):
    """``_loop="program"`` on the CPU: the recorder counts a replay per
    step run, under the program's caller (here none: ``alm.solve``) and
    lane count, and an ``alm.check`` per host sync (one per
    ``_CHECK_EVERY`` steps, and the one that finds no lane left); each
    region of the Newton step opens once per substep; the recorder on
    gives the bits of the recorder off."""
    steps = 11
    v0 = _seeds(can, 2)
    results = {}
    for on in (False, True):
        kw = dict(v0=v0, params=_params(max_iter=steps), _loop="program",
                  keep_state=True)
        kkt = make_condensed_kkt(can, refine=0)
        if on:
            with recording() as rec:
                out = alm.solve(can, kkt, alm.ALMOptions(**DIVE), **kw)
        else:
            out = alm.solve(can, kkt, alm.ALMOptions(**DIVE), **kw)
        results[on] = out.state
    for k in alm.ALMState._fields:
        assert torch.equal(getattr(results[True], k), getattr(results[False], k))
    assert rec.replays == {"alm.solve[2]": steps}
    assert rec.counts["alm.replay"] == steps
    assert rec.counts["alm.check"] == math.ceil(steps / alm._CHECK_EVERY) + 1
    for r in REGIONS:
        assert rec.counts[r] == steps, r
    assert rec.counts["alm.init"] == rec.counts["alm.load"] == 1
    assert rec.counts["alm.finish"] == 1
    # every region span's parent is the replay that ran it
    replay = {i for i, s in enumerate(rec.spans) if s[0] == "alm.replay"}
    for s in rec.spans:
        if s[0] in REGIONS:
            assert s[1] in replay


@pytest.mark.parametrize("two_body", [True, False])
def test_grouped_solve_spans(can, two_body):
    """A grouped solve (two groups of two lanes, then a drain chunk): one
    request, the drain under ``batch.drain_chunk``, replays named by the
    span that ran them.  Two-body: dive and endgame under each
    ``batch.group``, a drain chunk of four.  Single-body with a drain
    chunk of two: group and drain share one program, and each caller's
    replays still carry its own name."""
    kkt = make_condensed_kkt(can, refine=1)
    stages = (dict(drain_size=4, dive_opts=alm.ALMOptions(**DIVE),
                   dive_kkt=make_condensed_kkt(can, refine=0))
              if two_body else dict(drain_size=2))
    solve = make_grouped_solver(can, kkt, alm.ALMOptions(**END), group_size=2,
                                _loop="program", **stages)
    end = dict(tol=5e-3, feas_tol=1e-4, mu_init=6e-5, kappa_inner=2.0,
               prox=2.5e-3, gamma_eager=1.0)
    n1, cap, full = 3, 5, 7
    inst = can.nlp.inst0
    with recording() as rec:
        res = solve([inst, inst], None, _seeds(can, 4, seed=1),
                    _params(max_iter=full), _params(max_iter=cap, **end),
                    _params(max_iter=full, **end), n1, -1.0)
    assert res.drain_iters > 0
    by = {}
    for i, s in enumerate(rec.spans):
        by.setdefault(s[0], []).append(i)
    assert len(by["batch.solve"]) == 1 and rec.summary()["requests"] == 1
    assert all(s[2] == 1 for s in rec.spans)
    assert len(by["batch.group"]) == 2
    chunks = by["batch.drain_chunk"]
    assert [rec.spans[i][1] for i in chunks] == by["batch.solve"] * len(chunks)
    assert len(by["batch.readback"]) == 1 + len(chunks)
    assert sum(rec.replays.values()) == rec.counts["alm.replay"]
    if two_body:
        for stage in ("batch.dive", "batch.phase_switch", "batch.endgame"):
            assert [rec.spans[i][1] for i in by[stage]] == by["batch.group"]
        assert rec.replays["batch.dive[2]"] == 2 * n1
        assert set(rec.replays) == {"batch.dive[2]", "batch.endgame[2]",
                                    "batch.drain_chunk[4]"}
    else:
        assert len(solve.programs.programs) == 1
        assert set(rec.replays) == {"batch.group[2]", "batch.drain_chunk[2]"}


# ---------------------------------------------------------------------------
# attribution on synthetic records
# ---------------------------------------------------------------------------


def test_gaps_go_to_the_innermost_span_open_through_them():
    """Replay intervals [10, 20], [25, 40] and [40, 50] in a window
    [0, 100]: the gaps [0, 10] (the window's start), [20, 25] and [50, 100]
    (its end) are divided among the innermost spans open through them."""
    rec = profiling.Recorder()
    rec.window = [0, 100]
    rec.spans = [["batch.solve", None, 1, 0, 90], ["alm.check", 0, 1, 3, 8],
                 ["alm.check", 0, 1, 21, 23], ["alm.finish", 0, 1, 60, 80]]
    rec.intervals = [("dive", 25, 40), ("dive", 10, 20), ("endgame", 40, 50)]
    sm = rec.summary()
    assert sm["replay_s"] == pytest.approx(35e-9)
    assert {k: v / 1e-9 for k, v in sm["gaps"].items()} == pytest.approx({
        "batch.solve": 5 + 3 + 20, "alm.check": 5 + 2, "alm.finish": 20,
        profiling.NO_SPAN: 10})
    split = profiling.split_gaps
    # a gap before every span, and spans that touch
    assert split([(5, 7, "a"), (7, 9, "b")], [(0, 8)]) == {
        profiling.NO_SPAN: 5, "a": 2, "b": 1}
    assert split([], [(1, 4)]) == {profiling.NO_SPAN: 3}
    assert profiling.innermost([(0, 4, "a"), (1, 2, "b")],
                               [(1.5, 1), (3, 2)]) == {"b": 1, "a": 2}


def _ev(name, device, start, end, id=0, linked=0):
    return SimpleNamespace(name=name, device_type=device, id=id,
                           linked_correlation_id=linked,
                           time_range=SimpleNamespace(start=start, end=end))


def test_device_operations_go_to_the_region_that_launched_them():
    """A kernel goes to the innermost region open at its launch: the
    runtime call with its correlation id, else its linked operator; one
    launched outside every region, or whose launch is missing, is
    ``unattributed`` (the latter also counted as ``unlinked``)."""
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [
        _ev("step.residuals", cpu, 0, 10), _ev("kkt.blocks", cpu, 10, 30),
        _ev("aten::mul", cpu, 1, 3, id=500),
        _ev("cudaLaunchKernel", cpu, 2, 3, id=7),
        _ev("cudaLaunchKernel", cpu, 12, 13, id=8),
        _ev("cudaLaunchKernel", cpu, 40, 41, id=9),
        _ev("k_a", gpu, 20, 22, id=7, linked=500),   # launched at 2
        _ev("k_b", gpu, 21, 26, id=8),               # launched at 12
        _ev("k_c", gpu, 42, 43, id=9),               # launched at 40
        _ev("k_d", gpu, 44, 45, id=99, linked=500),  # via its operator at 1
        _ev("k_e", gpu, 50, 53, id=98),              # no launch found
    ]
    out = profiling.attribute_kernels(events)
    assert out["step.residuals"] == dict(ms=pytest.approx(3e-3), kernels=2)
    assert out["kkt.blocks"] == dict(ms=pytest.approx(5e-3), kernels=1)
    assert out["unattributed"] == dict(ms=pytest.approx(4e-3), kernels=2)
    assert out["unlinked"] == 1
    assert out["kkt.chain"] == dict(ms=0.0, kernels=0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernel_names(progs) -> list:
    """The device operations of one replay of each of ``progs``, in one
    profiler session (after a session that warms the profiler up)."""
    for warm in (True, False):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for prog in progs:
                prog.run()
                torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return [e.name for e in sorted(ops, key=lambda e: e.time_range.start)]


@pytest.mark.cuda
def test_capture_with_the_recorder_on_gives_the_same_graph(cuda_device):
    """float32 S10 at ts=8, 4 lanes, the crp dive program: a capture with
    the recorder on and one with it off launch the same kernels in the
    same order and leave bit-equal states after 17 replays; the recorder
    times each replay it sees and places it on the host clock; and
    ``step_regions`` splits an eager step's device time by region."""
    can = _can(torch.float32, cuda_device)
    kkt = make_condensed_kkt(can, refine=0, chain="crp")
    opts = alm.ALMOptions(**DIVE)
    p = _params(torch.float32, cuda_device, max_iter=400)
    inst = can.nlp.inst0
    st = alm.make_kernel(can, kkt, opts, inst, _seeds(can, 4)).init_state(
        p, p, False)
    out = {}
    for on in (False, True):
        prog = alm._StepProgram(can, kkt, opts, inst, st, p, None)
        prog.load(inst, st, p, None)
        if on:
            with recording() as rec:
                for _ in range(18):   # warm-up, capture + replay, 16 replays
                    prog.run()
                prog.steps_left()
        else:
            for _ in range(18):
                prog.run()
        torch.cuda.synchronize()
        out[on] = prog
    off, on = out[False], out[True]
    for k in alm.ALMState._fields:
        assert torch.equal(getattr(on.st, k), getattr(off.st, k)), k
    assert on.launches == off.launches
    names = _kernel_names([off, on])
    n = len(names) // 2
    assert n > 100 and names[:n] == names[n:], (len(names), next(
        (i, a, b) for i, (a, b) in enumerate(zip(names, names[n:])) if a != b))
    assert rec.replays == {"alm.solve[4]": 18}
    assert len(rec.intervals) == 17        # the capture's run replays too
    assert all(s < e for _, s, e in rec.intervals)
    sm = rec.summary()
    assert 0 < sm["replay_s"] < sm["window_s"]
    # one eager step by region: every region launches, next to nothing
    # runs outside them, and every operation's launch is found
    (regions,) = profiling.step_regions({"dive": on.step}).values()
    total = sum(regions[r]["ms"] for r in (*REGIONS, "unattributed"))
    assert all(regions[r]["kernels"] > 0 for r in REGIONS), regions
    assert regions["unattributed"]["ms"] < 0.05 * total
    assert regions["unlinked"] == 0
