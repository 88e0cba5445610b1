"""The solver loop's captured program on the CPU (port only, float64).

On the card each step program (``alm._StepProgram``: one masked step that
writes its result back into static buffers) is captured once as a CUDA
graph and replayed; here the same unit runs eagerly.  These tests hold:

* the unit's step makes no host-syncing or host-data call (what a capture
  refuses), for every program the solves run: the crp dive, the endgame
  with dual CG and chord substeps, a ``Phase1`` drain step, G7 with its
  slacks, the storm (wind model 3) and the sequential-chain dive, the
  structured and dense KKT, the condensed KKT's plain chains (scan, cr,
  spike), wind models 2, 4 and 5, and the storm's onehot and gather
  lowerings;
* the unit, looped as ``alm.solve`` loops it, gives the eager loop's bits,
  for every program, ``opts.trace``'s records included, and so does the
  grouped solver with its static Instance and parameter buffers refilled
  between groups of two airframes;
* the launch bookkeeping of a capture and its replays.

The card's side (capture, replay, the same bits on the H100) is
``chip_smoke.py``'s ``graph`` and ``paths`` phases.
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from tol_tpu_torch import api as tapi
from tol_tpu_torch.api import make_problem
from tol_tpu_torch.io.storm import make_demo_storm_grid
from tol_tpu_torch.models.wind import WindConfig
from tol_tpu_torch.ops import chainkern, crkern, nodekern
from tol_tpu_torch.problems.base import make_instance
from tol_tpu_torch.solver import alm
from tol_tpu_torch.solver.batch import make_grouped_solver
from tol_tpu_torch.solver.canonical import canonicalize
from tol_tpu_torch.solver.kkt_condensed import make_condensed_kkt
from tol_tpu_torch.solver.kkt_dense import make_dense_kkt
from tol_tpu_torch.solver.kkt_structured import make_structured_kkt

TS = 8
LANES = 2
DTYPE = torch.float64
END = dict(max_iter=2000, dual_refine_k=4, max_ls=8)
DIVE = dict(max_iter=2000, dual_refine_k=0, max_ls=4)
STORM_DATUM = dict(east0=17400.0, north0=25800.0, up0=200.0)


# ---------------------------------------------------------------------------
# a mode that fails on host-syncing and host-data calls
# ---------------------------------------------------------------------------


class HostCall(AssertionError):
    """A call that waits for the device or copies host data to it."""


_SYNCING = {torch.Tensor.item, torch.Tensor.__bool__, torch.Tensor.tolist,
            torch.Tensor.nonzero, torch.nonzero, torch.Tensor.__int__,
            torch.Tensor.__float__}
_FACTORIES = {torch.tensor, torch.as_tensor}


class _NoHostFunctions(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _SYNCING:
            raise HostCall(f"host-syncing call {func.__name__}")
        if func in _FACTORIES and args and not isinstance(args[0],
                                                          torch.Tensor):
            raise HostCall(f"{func.__name__} of host data "
                           f"({type(args[0]).__name__})")
        return func(*args, **(kwargs or {}))


_SYNCING_ATEN = {"_local_scalar_dense", "nonzero", "is_nonzero",
                 "masked_select",
                 # linalg's error checks read the device's info on the host
                 "_linalg_check_errors", "_linalg_eigh"}


class _NoHostOps(TorchDispatchMode):
    """The aten side: scalar reads, ``nonzero`` and boolean-mask indexing
    (which runs ``nonzero`` below the Python layer)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in _SYNCING_ATEN:
            raise HostCall(f"host-syncing op aten.{name}")
        if name == "index" and any(
                isinstance(i, torch.Tensor) and i.dtype in (torch.bool,
                                                            torch.uint8)
                for i in (args[1] if len(args) > 1 else ()) if i is not None):
            raise HostCall("boolean-mask indexing")
        return func(*args, **(kwargs or {}))


class no_host_calls:
    """Both modes at once."""

    def __enter__(self):
        self._modes = [_NoHostFunctions(), _NoHostOps()]
        for m in self._modes:
            m.__enter__()

    def __exit__(self, *exc):
        for m in reversed(self._modes):
            m.__exit__(*exc)


_PATTERNS = {
    # alm.py's old _errors_at: a Python float to the lanes' device
    "errors_at_mu": lambda x: torch.as_tensor(0.0, dtype=x.dtype,
                                              device=x.device).reshape(-1, 1),
    # canonical.c's and kkt_condensed.prepare's old numpy scatter matrix
    "numpy_matrix": lambda x: torch.as_tensor(np.eye(2), dtype=x.dtype,
                                              device=x.device),
    "tensor_of_list": lambda x: torch.tensor([1.0, 2.0], device=x.device),
    "item": lambda x: x.sum().item(),
    "bool": lambda x: bool((x > 0).any()),
    "int": lambda x: int(x.argmax()),
    "tolist": lambda x: x.tolist(),
    "nonzero": lambda x: torch.nonzero(x > 0),
    "mask_index": lambda x: x[x > 0],
    "where_one_arg": lambda x: torch.where(x > 0),
    # kkt_dense's old solve: solve_ex, then aten._linalg_check_errors
    "linalg_solve": lambda x: torch.linalg.solve(
        torch.eye(4, dtype=x.dtype) + torch.outer(x, x), x),
    # kkt_structured's old convexification
    "linalg_eigh": lambda x: torch.linalg.eigh(torch.outer(x, x)),
}


@pytest.mark.parametrize("pattern", sorted(_PATTERNS))
def test_mode_catches_host_calls(pattern):
    """The mode is not vacuous: each pattern a capture would refuse raises
    under it (and runs outside it)."""
    x = torch.arange(4, dtype=DTYPE) - 1.0
    _PATTERNS[pattern](x)
    with pytest.raises(HostCall):
        with no_host_calls():
            _PATTERNS[pattern](x)


def test_mode_lets_device_work_through():
    x = torch.arange(4, dtype=DTYPE)
    with no_host_calls():
        y = torch.where(x > 1, x, 0.0).amax(-1) + torch.full((), 0.5,
                                                             dtype=DTYPE)
        z = torch.as_tensor(x, dtype=DTYPE)          # a tensor: no copy
    assert float(y) == 3.5 and z is x


# ---------------------------------------------------------------------------
# the problems of the programs
# ---------------------------------------------------------------------------


def _params(**kw):
    """bench.py's parameter set (float64, CPU) with overrides."""
    base = dict(tol=5e-3, feas_tol=1e-4, mu_init=1e-5, mu_min=1e-5,
                mu_shrink=0.1, theta_mu=1.2, gamma_init=0.01, gamma_min=1e-6,
                gamma_shrink=0.2, prox=3e-3, eta=1e-4, tau_min=0.99,
                kappa_inner=1.0, delta_decay=0.2, gamma_eager=1.0,
                max_iter=400)
    base.update(kw)
    mi = base.pop("max_iter")
    return alm.ALMParams(**{k: torch.tensor(v, dtype=DTYPE)
                            for k, v in base.items()},
                         max_iter=torch.tensor(mi, dtype=torch.int32))


def _dive_params(max_iter):
    return _params(tol=1e-12, feas_tol=1e-12, prox=0.0, gamma_eager=0.0,
                   max_iter=max_iter)


def _end_params(max_iter):
    return _params(mu_init=6e-5, kappa_inner=2.0, prox=2.5e-3,
                   max_iter=max_iter)


_CANS = {}


def _can(kind):
    """``kind``: "s10", "g7", "storm" (wind model 3, interp "auto"),
    "storm_onehot", "storm_gather", or "wind<k>" (S10 under model k)."""
    if kind not in _CANS:
        if kind == "g7":
            nlp = make_problem("G7", "skywalker", ts=TS, wind_model=1,
                               device="cpu")
        elif kind.startswith("storm"):
            interp = kind.partition("_")[2] or "auto"
            wind = WindConfig(model=3, order=2, interp=interp, **STORM_DATUM,
                              grid=make_demo_storm_grid(device="cpu"))
            nlp = make_problem("S10", "tempest", ts=TS, wind_model=3,
                               wind=wind, device="cpu")
        elif kind.startswith("wind"):
            nlp = make_problem("S10", "tempest", ts=TS,
                               wind_model=int(kind[4:]), device="cpu")
        else:
            nlp = make_problem("S10", "tempest", ts=TS, wind_model=1,
                               device="cpu")
        _CANS[kind] = canonicalize(nlp, scaling="auto")
    return _CANS[kind]


def _seeds(can, n, seed=0, inst=None):
    """bench.py's seeds: 0.01 N(0, 1) around the initial point, clipped into
    the bounds, fixed variables at their bound."""
    lb, ub, fixed = can.bounds(can.nlp._inst(inst))
    v0 = can.initial_point(inst)
    dv = torch.as_tensor(0.01 * np.random.default_rng(seed).standard_normal(
        (n, can.n)), dtype=lb.dtype, device=lb.device)
    return torch.where(fixed, lb, torch.minimum(torch.maximum(v0 + dv, lb),
                                                ub))


# name: (problem, options, KKT refine, chain, endgame?, drain?); the chain
# "structured" or "dense" names that KKT in place of the condensed one
PROGRAMS = {
    "dive": ("s10", DIVE, 0, "crp", False, False),
    "seqdive": ("s10", DIVE, 0, "pallas", False, False),
    "endgame": ("s10", dict(END, factor_reuse=2), 1, "crp", True, False),
    "drain": ("s10", END, 1, "crp", False, True),
    "g7": ("g7", END, 1, "crp", True, False),
    "storm": ("storm", dict(END, max_ls=4), 1, "crp", True, False),
    "structured": ("s10", END, 0, "structured", True, False),
    "dense": ("s10", END, 0, "dense", True, False),
    "scan": ("s10", END, 1, "scan", True, False),
    "cr": ("s10", END, 1, "cr", True, False),
    "spike": ("s10", END, 1, "spike", True, False),
    "wind2": ("wind2", END, 1, "crp", True, False),
    "wind4": ("wind4", END, 1, "crp", True, False),
    "wind5": ("wind5", END, 1, "crp", True, False),
    "storm_onehot": ("storm_onehot", dict(END, max_ls=4), 1, "crp", True,
                     False),
    "storm_gather": ("storm_gather", dict(END, max_ls=4), 1, "crp", True,
                     False),
}
NEW_PROGRAMS = ["structured", "dense", "scan", "cr", "spike", "wind2",
                "wind4", "wind5", "storm_onehot", "storm_gather"]


def _kkt(can, refine, chain):
    if chain == "structured":
        return make_structured_kkt(can)
    if chain == "dense":
        return make_dense_kkt(can)
    return make_condensed_kkt(can, refine=refine, chain=chain)


def _program(name):
    kind, opts, refine, chain, endgame, drain = PROGRAMS[name]
    can = _can(kind)
    opts = alm.ALMOptions(**opts)
    kkt = _kkt(can, refine, chain)
    v0 = _seeds(can, LANES)
    inst = can.nlp.inst0
    p1, p2 = _dive_params(400), _end_params(400)
    phase1 = (alm.Phase1(params=p1, n_max=torch.tensor(3, dtype=torch.int32),
                         exit_df=torch.tensor(-1.0, dtype=DTYPE))
              if drain else None)
    p_start = p2 if endgame else p1
    kern = alm.make_kernel(can, kkt, opts, inst, v0)
    st = kern.init_state(p1 if drain else p_start, p_start, drain)
    params = p2 if (endgame or drain) else p1
    prog = alm._StepProgram(can, kkt, opts, inst, st, params, phase1)
    prog.load(inst, st, params, phase1)
    return prog


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_step_makes_no_host_call(name):
    """After one warm-up step (as on the card, where it precedes the
    capture), a step of the program makes no host-syncing or host-data
    call: the step a CUDA graph captures."""
    prog = _program(name)
    prog.step()                              # the warm-up
    before = alm.ALMState(*[x.clone() for x in prog.st])
    with no_host_calls():
        prog.run()
    assert torch.equal(prog.st.it, before.it + prog.opts.factor_reuse)
    assert torch.isfinite(prog.st.v).all()
    assert any(not torch.equal(getattr(prog.st, k), getattr(before, k))
               for k in ("v", "zl", "delta_w", "kkt_err"))


# ---------------------------------------------------------------------------
# the program's bits against the eager loop
# ---------------------------------------------------------------------------


def _assert_same_bits(a, b, what):
    for k in type(a)._fields:
        x, y = getattr(a, k), getattr(b, k)
        if x is None or isinstance(x, alm.ALMState) or k == "trace":
            continue                  # the trace: compared by its caller
        assert torch.equal(x, y), (what, k)


def test_program_loop_matches_eager_loop_and_caches_one_program():
    """``solve`` through the program (its unit run eagerly on the CPU) gives
    the eager loop's bits, with lanes at different counters; two solves of
    the same structure share one program."""
    can = _can("s10")
    kkt = make_condensed_kkt(can, refine=0, chain="crp")
    opts = alm.ALMOptions(**DIVE)
    p = _dive_params(10)
    st0 = alm.solve(can, kkt, opts, v0=_seeds(can, 3), params=p._replace(
        max_iter=torch.tensor(3, dtype=torch.int32)), keep_state=True).state
    st0 = st0._replace(it=st0.it + torch.tensor([4, 2, 0], dtype=torch.int32))
    cache = alm.ProgramCache()
    eager = alm.solve(can, kkt, opts, params=p, state0=st0, keep_state=True,
                      _loop="eager")
    for _ in range(2):
        prog = alm.solve(can, kkt, opts, params=p, state0=st0,
                         keep_state=True, _loop="program", _programs=cache)
        _assert_same_bits(prog, eager, "result")
        _assert_same_bits(prog.state, eager.state, "state")
    assert len(cache.programs) == 1 and cache.captures == 0
    assert eager.iterations.tolist() == [10, 10, 10]


def test_program_cache_keys_and_bound(monkeypatch):
    """Another lane count is another program; the cache keeps at most
    ``_PROGRAMS_KEPT``, the least recently used dropped."""
    can = _can("s10")
    kkt = make_condensed_kkt(can, refine=0, chain="crp")
    opts = alm.ALMOptions(**DIVE)
    monkeypatch.setattr(alm, "_PROGRAMS_KEPT", 2)
    cache = alm.ProgramCache()
    p = _dive_params(1)
    for n in (1, 2, 3, 2):
        alm.solve(can, kkt, opts, v0=_seeds(can, n), params=p,
                  _loop="program", _programs=cache)
    lanes = [prog.st.v.shape[0] for prog in cache.programs.values()]
    assert lanes == [3, 2]
    with pytest.raises(ValueError, match="unknown loop"):
        alm.solve(can, kkt, opts, v0=_seeds(can, 1), params=p, _loop="graph")


@pytest.mark.parametrize("name", NEW_PROGRAMS)
def test_new_program_loop_matches_eager_loop(name):
    """Each program of the paths added after the condensed crp ones,
    looped as ``solve`` loops it (its unit run eagerly on the CPU), gives
    the eager loop's bits in every result and state field, from a state
    one step on with lanes at different counters."""
    prog = _program(name)
    prog.step()
    st0 = alm.ALMState(*[x.clone() for x in prog.st])
    st0 = st0._replace(it=st0.it + torch.tensor([2, 0], dtype=torch.int32))
    kind, opts, refine, chain, _, _ = PROGRAMS[name]
    can = _can(kind)
    kkt = _kkt(can, refine, chain)
    p = prog.p2._replace(max_iter=torch.tensor(6, dtype=torch.int32))
    runs = [alm.solve(can, kkt, alm.ALMOptions(**opts), params=p, state0=st0,
                      keep_state=True, _loop=loop) for loop in ("eager",
                                                                "program")]
    _assert_same_bits(runs[1], runs[0], "result")
    _assert_same_bits(runs[1].state, runs[0].state, "state")
    assert runs[0].state.it.tolist() == [6, 6]
    assert torch.isfinite(runs[0].v).all()


@pytest.mark.parametrize("trace_len", [12, 5])
def test_trace_program_matches_eager_trace(trace_len):
    """``opts.trace`` through the program: each step writes its six records
    at a device index, a finished lane repeats its last record, and the
    columns after the last step repeat the final state's.  A ``state0``
    resume with lanes at iterations 7, 5 and 3 of a budget of 10 (so they
    finish after 3, 5 and 7 steps of this call): the trace and every
    result field equal the eager loop's bits, over more steps than the
    trace holds (5) and fewer (12)."""
    can = _can("s10")
    kkt = make_condensed_kkt(can, refine=0, chain="crp")
    p = _dive_params(10)
    st0 = alm.solve(can, kkt, alm.ALMOptions(**DIVE), v0=_seeds(can, 3),
                    params=p._replace(max_iter=torch.tensor(3,
                                                            dtype=torch.int32)),
                    keep_state=True).state
    st0 = st0._replace(it=st0.it + torch.tensor([4, 2, 0], dtype=torch.int32))
    opts = alm.ALMOptions(**dict(DIVE, max_iter=trace_len, trace=True))
    cache = alm.ProgramCache()
    eager = alm.solve(can, kkt, opts, params=p, state0=st0, keep_state=True,
                      _loop="eager")
    for _ in range(2):                  # the second refills the program
        prog = alm.solve(can, kkt, opts, params=p, state0=st0,
                         keep_state=True, _loop="program", _programs=cache)
        _assert_same_bits(prog, eager, "result")
        _assert_same_bits(prog.state, eager.state, "state")
        assert len(prog.trace) == 6
        for k, (a, b) in enumerate(zip(prog.trace, eager.trace)):
            assert a.shape == (3, trace_len)
            assert torch.equal(a, b), k
    assert len(cache.programs) == 1
    steps = min(trace_len, 10)
    assert eager.iterations.tolist() == [min(7 + steps, 10),
                                         min(5 + steps, 10),
                                         min(3 + steps, 10)]
    kkt_err = eager.trace[0]
    # lane 0 finishes after 3 steps: its later columns repeat column 2
    assert torch.equal(kkt_err[0, 2:], kkt_err[0, 2].expand(trace_len - 2))
    assert not torch.equal(kkt_err[2, :steps - 1], kkt_err[2, 1:steps])


def test_verbose_keeps_the_eager_loop(capsys):
    """``opts.verbose`` prints from every step, which a graph cannot: it
    runs the eager loop whatever ``_loop`` asks for, and is the only
    option that does."""
    can = _can("s10")
    kkt = make_condensed_kkt(can, refine=0, chain="crp")
    cache = alm.ProgramCache()
    out = alm.solve(can, kkt, alm.ALMOptions(**dict(DIVE, verbose=True)),
                    v0=_seeds(can, 2), params=_dive_params(3),
                    _loop="program", _programs=cache)
    assert not cache.programs
    assert out.iterations.tolist() == [3, 3]
    assert capsys.readouterr().out.count("it=") == 3
    alm.solve(can, kkt, alm.ALMOptions(**dict(DIVE, trace=True, max_iter=3)),
              v0=_seeds(can, 2), params=_dive_params(3), _loop="program",
              _programs=cache)
    assert len(cache.programs) == 1


AIRFRAMES = ["tempest", "tempest_wences"]


def _airframe_lanes(can, GB):
    insts = [make_instance(tapi.make_config("S10", a, ts=TS, wind_model=1),
                           tapi.default_goal("S10"), WindConfig(model=1),
                           device="cpu") for a in AIRFRAMES]
    V = torch.cat([_seeds(can, GB, seed=2 + g, inst=inst)
                   for g, inst in enumerate(insts)])
    return insts, V


def _grouped(can, loop, DB):
    return make_grouped_solver(
        can, make_condensed_kkt(can, refine=1, chain="crp"),
        alm.ALMOptions(**END), group_size=2, drain_size=DB,
        dive_opts=alm.ALMOptions(**DIVE),
        dive_kkt=make_condensed_kkt(can, refine=0, chain="crp"), _loop=loop)


def test_grouped_programs_match_eager_across_airframes():
    """The grouped solver's dive -> switch -> endgame -> drain, one group of
    each airframe: the programs' Instance and parameter buffers are
    refilled between the groups, and every field of every stage keeps the
    eager loop's bits.  The dive, endgame and drain programs are one each
    for both groups."""
    can = _can("s10")
    GB, n1, cap1, full = 2, 6, 12, 18
    insts, V = _airframe_lanes(can, GB)
    p1, p2, p2d = _dive_params(full), _end_params(cap1), _end_params(full)
    n_max = torch.tensor(n1, dtype=torch.int32)
    xdf = torch.tensor(-1.0, dtype=DTYPE)
    stages = {}
    for loop in ("eager", "program"):
        g = _grouped(can, loop, DB=GB)
        out = []
        for k, inst in enumerate(insts):
            v0s = V[k * GB:(k + 1) * GB]
            st = g.run_dive(inst, v0s, p1, p2, n_max)
            end = g.run_end(inst, st, p2)
            drain = g.run_drain(inst, end.state, p1, p2d, n_max, xdf)
            out.append((st, end.state, drain.state))
        stages[loop] = out
        if loop == "program":
            assert len(g.programs.programs) == 3
            dive_prog = next(iter(g.programs.programs.values()))
            # the last group's airframe is in the static Instance buffers
            assert torch.equal(dive_prog.inst.aircraft.mm,
                               insts[-1].aircraft.mm)
    assert not torch.equal(insts[0].aircraft.mm, insts[1].aircraft.mm)
    for k in range(len(insts)):
        for s, (a, b) in enumerate(zip(stages["program"][k],
                                       stages["eager"][k])):
            _assert_same_bits(a, b, f"group {k}, stage {s}")
    assert stages["eager"][0][2].it.max() > cap1     # lanes really drained


def test_grouped_solve_through_programs_matches_eager():
    """The whole grouped solve (two groups of two airframes, a drain chunk
    of both airframes' stragglers) gives the eager run's results."""
    can = _can("s10")
    GB, n1, cap1, full = 2, 6, 12, 18
    insts, V = _airframe_lanes(can, GB)
    args = (insts, None, V, _dive_params(full), _end_params(cap1),
            _end_params(full), n1, -1.0)
    r_e = _grouped(can, "eager", DB=4)(*args)
    r_p = _grouped(can, "program", DB=4)(*args)
    for k in r_e._fields:
        np.testing.assert_array_equal(getattr(r_p, k), getattr(r_e, k),
                                      err_msg=k)
    assert r_e.drain_iters > 0


# ---------------------------------------------------------------------------
# launch bookkeeping
# ---------------------------------------------------------------------------


def test_capture_launches_are_recorded_and_added_per_replay():
    """A capture's counted launches (none of which ran) are taken back and
    recorded; each replay adds them once."""
    k1, k3 = crkern.crp_factor_fwd_pass, crkern.crp_bwd_pass
    k6 = chainkern.KERNELS[0]
    start = alm._launch_counts()
    before = alm._launch_counts()
    k1.launches += 1                     # what a captured step counts
    k3.launches += 2
    k6.launches += 1
    delta = alm._recorded_launches(before)
    assert alm._launch_counts() == start
    assert delta == {k1: 1, k3: 2, k6: 1}
    for _ in range(3):
        alm._add_launches(delta)
    now = alm._launch_counts()
    assert now[k1] - start[k1] == 3 and now[k3] - start[k3] == 6
    assert now[k6] - start[k6] == 3
    assert all(now[k] == start[k] for k in start if k not in delta)
    for k, n in start.items():
        k.launches = n


# ---------------------------------------------------------------------------
# on the card: capture and replay
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_programs_match_eager_on_card(cuda_device):
    """float32 S10 at ts=8, 4 lanes, crp dive and endgame: the replayed
    graphs give the eager loop's bits and launches, the first use captures
    each program once, and a second solve replays without capturing."""
    nlp = make_problem("S10", "tempest", ts=TS, wind_model=1,
                       dtype=torch.float32, device=cuda_device)
    can = canonicalize(nlp, scaling="auto")
    v0 = _seeds(can, 4)
    to = lambda p: alm.ALMParams(*[x.to(cuda_device) if x.dtype == torch.int32
                                   else x.to(cuda_device, torch.float32)
                                   for x in p])
    p1, p2 = to(_dive_params(12)), to(_end_params(24))
    runs = {}
    for loop in ("eager", "program"):
        crkern.reset_launch_counts()
        nodekern.reset_launch_counts()
        cache = alm.ProgramCache()
        kw = dict(keep_state=True, _loop=loop, _programs=cache)
        kkt_d = make_condensed_kkt(can, refine=0, chain="crp")
        kkt_e = make_condensed_kkt(can, refine=1, chain="crp")
        dive = alm.solve(can, kkt_d, alm.ALMOptions(**DIVE), v0=v0, params=p1,
                         **kw)
        st = alm.phase_switch_state(can, dive.state, p2)
        end = alm.solve(can, kkt_e, alm.ALMOptions(**END), params=p2,
                        state0=st, **kw)
        captures = cache.captures
        again = alm.solve(can, kkt_e, alm.ALMOptions(**END), params=p2,
                          state0=st, **kw)
        runs[loop] = (dive.state, end.state, again.state,
                      alm._launch_counts(), captures, cache.captures)
    (*eager, launches_e, _, _), (*graph, launches_g, c1, c2) = (
        runs["eager"], runs["program"])
    for a, b in zip(eager, graph):
        for k in alm.ALMState._fields:
            assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert launches_g == launches_e
    assert launches_g[crkern.crp_factor_fwd_pass] > 0
    assert c1 == 2 and c2 == 2
