"""The program's spans (``tol_tpu_torch/utils/profiling.py``).

Port only, float64 on the CPU, S10 at ts=8: the recorder off and on, the
spans the solve path opens (their nesting, parents and request ids, and
each region of a Newton step once per substep, the dual refinement's
only where it runs), the replays and checks it records by program, the
gridded wind's span and its counter of interpolated positions, the node
blocks' counters of the nodes each path takes, the
attribution of replay gaps and of device operations on synthetic records,
and, on the card, that a capture made with the recorder on gives the
graph and the bits of one made with it off, and that an endgame step's
regions, ``step.dual_refine`` among them, cover its device time.

This file imports neither JAX nor the JAX package; on a GPU machine:

    python -m pytest tests/test_torch_tracing.py -m cuda --noconftest -o addopts="" -q
"""

import json
import math
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from tol_tpu_torch.api import make_problem
from tol_tpu_torch.models.wind import WindConfig, wind_with_gradient_ned
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
    # the dive runs no dual refinement and wind model 1 reads no grid:
    # those regions never open
    for r in REGIONS:
        assert rec.counts.get(r, 0) == (
            0 if r in ("step.dual_refine", "wind.grid") else steps), r
    # each step's derivative blocks take the 2 lanes' TS+1 nodes, on the
    # CPU by the transforms
    assert rec.counters == {"kkt.node_blocks.transforms": steps * 2 * (TS + 1)}
    assert rec.counts["alm.init"] == rec.counts["alm.load"] == 1
    assert rec.counts["alm.finish"] == 1
    # every region span's parent is the replay that ran it
    replay = {i for i, s in enumerate(rec.spans) if s[0] == "alm.replay"}
    for s in rec.spans:
        if s[0] in REGIONS:
            assert s[1] in replay


def test_dual_refine_region_opens_once_per_endgame_step(can):
    """An endgame solve (``dual_refine_k`` = 4) opens ``step.dual_refine``
    once per step, inside that step's ``step.update``, beside every other
    region; the recorder on gives the bits of the recorder off."""
    steps = 5
    v0 = _seeds(can, 2, seed=2)
    kw = dict(v0=v0, params=_params(max_iter=steps, tol=5e-3, feas_tol=1e-4,
                                     mu_init=6e-5, prox=2.5e-3),
              _loop="program", keep_state=True)
    off = alm.solve(can, make_condensed_kkt(can, refine=1),
                    alm.ALMOptions(**END), **kw)
    with recording() as rec:
        on = alm.solve(can, make_condensed_kkt(can, refine=1),
                       alm.ALMOptions(**END), **kw)
    for k in alm.ALMState._fields:
        assert torch.equal(getattr(on.state, k), getattr(off.state, k)), k
    for r in REGIONS:
        assert rec.counts.get(r, 0) == (0 if r == "wind.grid" else steps), r
    for s in rec.spans:
        if s[0] == "step.dual_refine":
            assert rec.spans[s[1]][0] == "step.update"


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
    # the dual refinement runs once in every endgame and drain step, never
    # in a dive step
    assert rec.counts["step.dual_refine"] == (
        rec.counts["alm.replay"] - rec.replays.get("batch.dive[2]", 0))
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
# the gridded wind's span and counter
# ---------------------------------------------------------------------------


def _storm_wind(**kw):
    from tol_tpu_torch.io.storm import make_demo_storm_grid

    return WindConfig(model=3, grid=make_demo_storm_grid(device="cpu"),
                      order=2, east0=17400.0, north0=25800.0, up0=200.0, **kw)


@pytest.mark.parametrize("interp", ["separable", "gather"])
def test_wind_grid_span_counts_the_positions_it_interpolates(interp):
    """One model-3 wind with its gradient at 5 positions: a ``wind.grid``
    span for the value (5 positions) and one for the gradient's ``jvp``
    over the replica axis (3 x 5), so the counter reads 20; the recorder on
    gives the bits of the recorder off."""
    cfg = _storm_wind(interp=interp)
    P = torch.as_tensor(np.random.default_rng(4).uniform(
        [-300, -300, -300], [500, 500, 100], (5, 3)))
    off = wind_with_gradient_ned(cfg, P)
    with recording() as rec:
        on = wind_with_gradient_ned(cfg, P)
    assert all(torch.equal(a, b) for a, b in zip(on, off))
    assert rec.counts == {"wind.grid": 2}
    assert rec.counters == {"wind.grid.queries": 5 + 3 * 5}
    assert rec.summary()["counters"] == {"wind.grid.queries": 20}


@pytest.mark.parametrize("model", [0, 1, 2, 4, 5])
def test_no_wind_grid_span_off_the_grid(model):
    """The analytic wind models interpolate no grid: no ``wind.grid`` span
    opens and nothing is counted."""
    P = torch.zeros(4, 3, dtype=torch.float64)
    with recording() as rec:
        wind_with_gradient_ned(WindConfig(model=model), P)
    assert rec.counts == {} and rec.counters == {}


def test_wind_grid_is_the_shared_no_op_while_off(monkeypatch):
    """Off: the grid's span is the shared no-op, no ``record_function``
    range opens in a storm wind evaluation, and ``count`` adds to
    nothing."""
    assert profiling._recorder is None
    assert span("wind.grid") is profiling._OFF

    def refused(name):
        raise AssertionError(f"record_function({name!r}) while off")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    profiling.count("wind.grid.queries", 7)
    w, g = wind_with_gradient_ned(_storm_wind(), torch.zeros(3, 3,
                                                             dtype=torch.float64))
    assert w.shape == (3, 3) and g.shape == (3, 3, 3)
    assert profiling._recorder is None


def test_wind_grid_opens_inside_the_regions_of_an_eager_storm_step():
    """S10 on the demo storm grid at ts=8, one eager step of a dive
    program (``_loop="program"`` on the CPU) with the recorder on: the
    grid's span opens inside the regions that evaluate the wind (the
    residuals, the derivative blocks, the line search, the update) and in
    the solve's set-up and finish, never elsewhere; its counter counts the
    positions; the recorder on gives the bits of the recorder off."""
    nlp = make_problem("S10", "tempest", ts=TS, wind_model=3,
                       wind=_storm_wind(interp="separable"),
                       dtype=torch.float64, device="cpu")
    can = canonicalize(nlp, scaling="auto")
    kw = dict(v0=_seeds(can, 2), params=_params(max_iter=1),
              _loop="program", keep_state=True)
    opts = alm.ALMOptions(**DIVE)
    off = alm.solve(can, make_condensed_kkt(can, refine=0), opts, **kw)
    with recording() as rec:
        on = alm.solve(can, make_condensed_kkt(can, refine=0), opts, **kw)
    for k in alm.ALMState._fields:
        assert torch.equal(getattr(on.state, k), getattr(off.state, k)), k
    parents = Counter(rec.spans[s[1]][0] for s in rec.spans
                      if s[0] == "wind.grid")
    assert set(parents) == {"alm.init", "step.residuals", "kkt.blocks",
                            "step.armijo", "step.update", "alm.finish"}
    assert sum(parents.values()) == rec.counts["wind.grid"]
    # each evaluation interpolates at least the 2 lanes' 8 nodes
    assert rec.counters["wind.grid.queries"] >= 2 * TS * rec.counts["wind.grid"]


def _endgame(can, steps, device="cpu", loop="program"):
    """``steps`` endgame steps (refine=1, ``dual_refine_k`` = 4) of 2 lanes
    of ``can`` -> the final state."""
    p = _params(can.nlp.inst0.z_lo.dtype, device, max_iter=steps, tol=5e-3,
                feas_tol=1e-4, mu_init=6e-5, prox=2.5e-3)
    return alm.solve(can, make_condensed_kkt(can, refine=1),
                     alm.ALMOptions(**END), v0=_seeds(can, 2, seed=2),
                     params=p, _loop=loop, keep_state=True).state


@pytest.mark.parametrize("model", [1, 3])
def test_node_block_counters_count_each_steps_nodes(model):
    """S10 at ts=8 on the CPU, 3 endgame steps of 2 lanes: each step's
    ``kkt_prepare`` adds its B (T+1) nodes and its dual refinement B T to
    ``kkt.node_blocks.transforms``, wind model 1 as model 3 (the CPU never
    takes the kernel); the recorder on gives the bits of the recorder
    off."""
    wind = _storm_wind(interp="separable") if model == 3 else None
    can = canonicalize(make_problem("S10", "tempest", ts=TS, wind_model=model,
                                    wind=wind, device="cpu"), scaling="auto")
    steps = 3
    off = _endgame(can, steps)
    with recording() as rec:
        on = _endgame(can, steps)
    for k in alm.ALMState._fields:
        assert torch.equal(getattr(on, k), getattr(off, k)), k
    assert {k: n for k, n in rec.counters.items()
            if k.startswith("kkt.node_blocks")} == {
        "kkt.node_blocks.transforms": steps * 2 * ((TS + 1) + TS)}


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


def test_nested_region_takes_its_kernels_from_the_outer_one():
    """``step.dual_refine`` opens inside ``step.update``: a kernel launched
    inside it goes to it alone, the outer region keeps the rest, and the
    regions with ``unattributed`` still sum to every operation's device
    time."""
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [
        _ev("step.update", cpu, 0, 30), _ev("step.dual_refine", cpu, 10, 20),
        _ev("cudaLaunchKernel", cpu, 2, 3, id=1),
        _ev("cudaLaunchKernel", cpu, 12, 13, id=2),
        _ev("cudaLaunchKernel", cpu, 15, 16, id=3),
        _ev("cudaLaunchKernel", cpu, 25, 26, id=4),
        _ev("cudaLaunchKernel", cpu, 35, 36, id=5),
        _ev("k_1", gpu, 40, 41, id=1), _ev("k_2", gpu, 41, 44, id=2),
        _ev("k_3", gpu, 44, 48, id=3), _ev("k_4", gpu, 48, 50, id=4),
        _ev("k_5", gpu, 50, 55, id=5),
    ]
    out = profiling.attribute_kernels(events)
    assert out["step.update"] == dict(ms=pytest.approx(3e-3), kernels=2)
    assert out["step.dual_refine"] == dict(ms=pytest.approx(7e-3), kernels=2)
    assert out["unattributed"] == dict(ms=pytest.approx(5e-3), kernels=1)
    total = sum(out[r]["ms"] for r in (*REGIONS, "unattributed"))
    assert total == pytest.approx(15e-3)


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
    # one eager step by region: every region launches but the dual
    # refinement, which the dive does not run, and the grid, which wind
    # model 1 does not read; next to nothing runs outside them, and every
    # operation's launch is found
    (regions,) = profiling.step_regions({"dive": on.step}).values()
    total = sum(regions[r]["ms"] for r in (*REGIONS, "unattributed"))
    assert all((regions[r]["kernels"] > 0)
               == (r not in ("step.dual_refine", "wind.grid"))
               for r in REGIONS), regions
    assert regions["unattributed"]["ms"] < 0.05 * total
    assert regions["unlinked"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("model", [1, 3, "3-order1"])
def test_node_block_counters_name_the_path_on_the_card(cuda_device, model):
    """float32 S10 at ts=8 on the card, 3 eager endgame steps of 2 lanes:
    wind model 1, and model 3 on the demo storm grid at order 2, take the
    kernel K9 for every node block (B (T+1) nodes a ``kkt_prepare``, B T a
    dual refinement) and model 3 at order 1 the transforms; the recorder on
    gives the bits of the recorder off."""
    from tol_tpu_torch.io.storm import make_demo_storm_grid

    wind = None
    if model != 1:
        grid = make_demo_storm_grid(dtype=torch.float32, device=cuda_device)
        wind = WindConfig(model=3, grid=grid,
                          order=1 if model == "3-order1" else 2,
                          interp="separable", east0=17400.0,
                          north0=25800.0, up0=200.0)
    can = canonicalize(make_problem("S10", "tempest", ts=TS,
                                    wind_model=1 if model == 1 else 3,
                                    wind=wind, dtype=torch.float32,
                                    device=cuda_device), scaling="auto")
    steps = 3
    off = _endgame(can, steps, cuda_device, "eager")
    with recording() as rec:
        on = _endgame(can, steps, cuda_device, "eager")
    for k in alm.ALMState._fields:
        assert torch.equal(getattr(on, k), getattr(off, k)), k
    path = "transforms" if model == "3-order1" else "kernel"
    assert {k: n for k, n in rec.counters.items()
            if k.startswith("kkt.node_blocks")} == {
        f"kkt.node_blocks.{path}": steps * 2 * ((TS + 1) + TS)}


@pytest.mark.cuda
def test_endgame_step_by_region_covers_its_device_time(cuda_device):
    """float32 S10 at ts=8, 4 lanes, the crp endgame program (refine=1,
    ``dual_refine_k`` = 4), one eager step after its warm-up: every region
    launches, ``step.dual_refine`` too, and the regions with
    ``unattributed`` sum to the step's device busy time (the union of its
    operations' intervals), each operation counted once."""
    can = _can(torch.float32, cuda_device)
    kkt = make_condensed_kkt(can, refine=1, chain="crp")
    opts = alm.ALMOptions(**END)
    p = _params(torch.float32, cuda_device, max_iter=400, tol=5e-3,
                feas_tol=1e-4, mu_init=6e-5, prox=2.5e-3)
    inst = can.nlp.inst0
    st = alm.make_kernel(can, kkt, opts, inst, _seeds(can, 4)).init_state(
        p, p, False)
    prog = alm._StepProgram(can, kkt, opts, inst, st, p, None)
    prog.load(inst, st, p, None)
    prog.run()                      # the warm-up step builds the kernels
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with recording():
            prog.step()
            torch.cuda.synchronize()
    events = prof.events()
    regions = profiling.attribute_kernels(events)
    assert all((regions[r]["kernels"] > 0) == (r != "wind.grid")
               for r in REGIONS), regions
    assert regions["unlinked"] == 0
    ops = [(e.time_range.start, e.time_range.end) for e in events
           if e.device_type == DeviceType.CUDA and e.name not in REGIONS
           and not getattr(e, "is_user_annotation", False)]
    busy, _ = profiling._union_and_gaps(ops, min(s for s, _ in ops),
                                        max(e for _, e in ops))
    total = sum(regions[r]["ms"] for r in (*REGIONS, "unattributed"))
    assert total == pytest.approx(busy * 1e-3, rel=0.02)
