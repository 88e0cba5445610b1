"""The port's utilities (``tol_tpu_torch/utils``) against tol_tpu's:
checkpoints that cross between the packages bit for bit and warm-start a
solve, the stage timer and trace hook, the flop count by XLA's
convention, the peak table and the kernels' build directory (float64,
CPU)."""

import functools
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jvp, vjp

from tol_tpu.utils import checkpoint as jck
from tol_tpu.utils import flops as jflops
from tol_tpu.utils import profiling as jprof
from tol_tpu_torch.utils import checkpoint as tck
from tol_tpu_torch.utils import flops as tflops
from tol_tpu_torch.utils import profiling as tprof

# bench-like numerics of tests/test_parallel.py, with a tighter tolerance so
# the saved point is an optimum to within the comparison below
_OPTS = dict(tol=1e-7, feas_tol=1e-6, max_iter=400, gamma_init=0.01,
             mu_init=1e-5, mu_shrink=0.1, dual_refine_k=4)


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(50), rng.standard_normal((4, 7)).astype(
        np.float32), {"gamma": 0.01, "lanes": rng.integers(0, 9, 5)})


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_checkpoints_cross_between_the_packages_bit_for_bit(tmp_path, writer,
                                                            reader):
    v, y, meta = _arrays(3)
    save = {"jax": jck.save_solution, "torch": tck.save_solution}[writer]
    load = {"jax": jck.load_solution, "torch": tck.load_solution}[reader]
    if writer == "torch":     # the port takes tensors as well as arrays
        v, y = torch.as_tensor(v), torch.as_tensor(y)
    p = str(tmp_path / "sol.npz")
    save(p, v, y, meta=meta)
    v2, y2, meta2 = load(p)
    for want, got in [(v, v2), (y, y2), (meta["lanes"], meta2["lanes"])]:
        want = np.asarray(want)
        assert type(got) is np.ndarray and got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()
    assert float(meta2["gamma"]) == 0.01
    save(p, v)
    assert load(p)[1] is None


@functools.lru_cache(maxsize=None)
def _jax_solution(path):
    """S10 / tempest at ts=8 solved by the JAX package with its dense KKT
    in float64, saved by its save_solution."""
    from tol_tpu.api import make_problem
    from tol_tpu.solver import canonicalize
    from tol_tpu.solver.alm import ALMOptions, solve
    from tol_tpu.solver.kkt_dense import make_dense_kkt

    jc = canonicalize(make_problem("S10", "tempest", ts=8, wind_model=1))
    res = solve(jc, make_dense_kkt(jc), ALMOptions(**_OPTS))
    assert bool(res.converged)
    jck.save_solution(path, res.v, res.y, meta={"iterations": res.iterations})
    return path


def test_a_jax_checkpoint_warm_starts_the_port(tmp_path):
    """A solution JAX saves loads into the port and warm-starts its solve
    (from the saved primal and duals, with a small bound push so the
    active bounds stay active): the port converges in fewer iterations
    than from cold, at JAX's v within the per-step tolerance of
    tests/test_torch_solver.py."""
    from tol_tpu_torch.api import make_problem
    from tol_tpu_torch.solver.alm import ALMOptions, solve
    from tol_tpu_torch.solver.canonical import canonicalize
    from tol_tpu_torch.solver.kkt_dense import make_dense_kkt

    v, y, meta = tck.load_solution(_jax_solution(str(tmp_path / "j.npz")))
    tc = canonicalize(make_problem("S10", "tempest", ts=8, wind_model=1,
                                   device="cpu"))
    kkt = make_dense_kkt(tc)
    warm = solve(tc, kkt, ALMOptions(**_OPTS, bound_push=1e-5),
                 v0=torch.as_tensor(v)[None], y0=torch.as_tensor(y)[None])
    assert bool(warm.converged[0])
    k = int(warm.iterations[0])
    assert k < int(meta["iterations"])
    # from cold, the same budget does not reach convergence
    cold = solve(tc, kkt, ALMOptions(**{**_OPTS, "max_iter": k}))
    assert not bool(cold.converged[0])
    np.testing.assert_allclose(warm.v[0].numpy(), v, rtol=0,
                               atol=1e-8 * max(1.0, np.abs(v).max()))


def test_stage_timer_counts_and_report_match_jax(monkeypatch):
    """The same sequence of stages on a fake clock gives the same counts,
    totals and report lines in both packages; block_on waits for CPU
    tensors (a no-op) and JAX arrays alike."""
    ticks = iter(np.arange(0.0, 100.0, 0.25))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
    stages = ["solve", "stitch", "solve", "io", "solve"]
    reports = []
    for mod, block in [(jprof, jnp.ones(3)), (tprof, torch.ones(3))]:
        t = mod.stage_timer()
        for s in stages:
            with t(s, block_on=block if s == "solve" else None):
                pass
        reports.append((t.counts, t.totals, t.report()))
    assert reports[0] == reports[1]
    assert reports[1][2].splitlines() == [
        "io: 0.250s over 1 calls", "solve: 0.750s over 3 calls",
        "stitch: 0.250s over 1 calls"]


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with tprof.trace(None) as prof:
        assert prof is None
    with tprof.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof.trace_path.startswith(str(tmp_path / "tr"))
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)


_A = np.random.default_rng(0).standard_normal((8, 16))
_W = np.random.default_rng(1).standard_normal((16, 4))
_B1 = np.random.default_rng(2).standard_normal((3, 8, 16))
_B2 = np.random.default_rng(3).standard_normal((3, 16, 4))
# name -> (the JAX function, the port's, their inputs)
_FLOP_CASES = {
    "matmul": (lambda a, w: a @ w, lambda a, w: a @ w, (_A, _W)),
    "bmm": (lambda a, b: a @ b, torch.bmm, (_B1, _B2)),
    "sum_of_a_times_a_plus_1": (lambda a: jnp.sum(a * a + 1),
                                lambda a: (a * a + 1).sum(), (_A,)),
    "jvp_of_a_matmul": (
        lambda a, t: jax.jvp(lambda q: q @ jnp.asarray(_W), (a,), (t,)),
        lambda a, t: jvp(lambda q: q @ torch.as_tensor(_W), (a,), (t,)),
        (_A, _A)),
}


@pytest.mark.parametrize("case", sorted(_FLOP_CASES))
def test_program_flops_equals_jax(case):
    """The count of XLA's cost analysis, exactly: 1024 for the matmul,
    3072 for the bmm, 383 for sum(a*a + 1), 2048 for the jvp of the matmul
    (the tangent's product with the constant's zero tangent is not
    counted)."""
    fj, ft, args = _FLOP_CASES[case]
    want = jflops.program_flops(jax.jit(fj), *map(jnp.asarray, args))
    got = tflops.program_flops(ft, *map(torch.as_tensor, args))
    assert want > 0 and got == want


def test_program_flops_sees_through_vjp_and_skips_transcendentals():
    """Under vjp the counter sees both products (forward and the
    cotangent's; jitted JAX drops the unused forward one); exp counts no
    flop."""
    a, w = torch.as_tensor(_A), torch.as_tensor(_W)
    got = tflops.program_flops(lambda: vjp(lambda q: q @ w, a)[1](
        torch.ones(8, 4, dtype=a.dtype)))
    assert got == 2 * 1024
    assert tflops.program_flops(torch.exp, a) == 0.0


def _fill_by_slice(b, a):
    b[:, 2:10] = a


def _fill_by_index_put(b, a):
    b[torch.arange(8), 3] = a[:, 0]


def _fill_by_add_through_a_slice(b, a):
    b[:, :8].add_(a)


@pytest.mark.parametrize("fill", [_fill_by_slice, _fill_by_index_put,
                                  _fill_by_add_through_a_slice],
                         ids=lambda f: f.__name__[len("_fill_by_"):])
def test_program_flops_counts_a_zeros_buffer_filled_in_place(fill):
    """A buffer made by torch.zeros and written in place (as the condensed
    KKT builds its blocks) is no longer known zero: its product with an
    (16×4) matrix counts the full 2·m·n·k = 1024, and the write itself
    counts none."""
    a = torch.as_tensor(_A[:, :8])
    w = torch.as_tensor(_W)

    def fn():
        b = torch.zeros(8, 16, dtype=a.dtype)
        fill(b, a)
        return b @ w

    assert tflops.program_flops(fn) == 2 * 8 * 16 * 4
    assert tflops.program_flops(
        lambda: torch.zeros(8, 16, dtype=a.dtype) @ w) == 0.0


def _jax_flops_before_fusion(jitted, *args):
    """XLA's count of the module as lowered, before its optimization
    passes (fusion duplicates a producer into each of its consumers, and
    the compiled module's count includes every copy)."""
    ca = jitted.lower(*args).cost_analysis()
    return float((ca[0] if isinstance(ca, (list, tuple)) else ca)["flops"])


def test_program_flops_of_the_unrolled_cholesky_equals_jax_before_fusion():
    """smallalg.chol_unrolled on two 11×11 blocks: the port's count is
    XLA's count of the lowered module exactly (the same operations), and
    at most the compiled module's, which counts duplicated producers."""
    from tol_tpu.ops import smallalg as jsa
    from tol_tpu_torch.ops import smallalg as tsa

    a = np.random.default_rng(4).standard_normal((2, 11, 11))
    a = a @ a.transpose(0, 2, 1) + 33.0 * np.eye(11)
    fj = jax.jit(jax.vmap(jsa.chol_unrolled))
    got = tflops.program_flops(tsa.chol_unrolled, torch.as_tensor(a))
    before = _jax_flops_before_fusion(fj, jnp.asarray(a))
    after = jflops.program_flops(fj, jnp.asarray(a))
    print(f"\nchol_unrolled, 2 × 11×11: port {got:.0f}, JAX lowered "
          f"{before:.0f}, JAX compiled {after:.0f}")
    assert got == before > 0 and after >= before


def test_program_flops_of_a_kkt_step_beside_jax():
    """One batched S10 / tempest KKT step at ts=8 (the graft entry's step
    body, chain cr, 2 lanes) in both packages.  Their counts differ (the
    port's torch.func derivatives run other operations than JAX's, and
    XLA's compiled count includes fusion's duplicates), so the numbers are
    printed for PERF.md, not compared."""
    import __graft_entry__ as jge
    import graft_entry_torch as tge
    from tests.test_torch_entry import _jax_step, _lanes

    _, jc, jkkt = jge._flagship(8, jnp.float64)
    V = _lanes(jc, 2)
    jstep = jax.jit(jax.vmap(_jax_step(jc, jkkt)))
    fj = jflops.program_flops(jstep, jnp.asarray(V))
    fb = _jax_flops_before_fusion(jstep, jnp.asarray(V))
    _, tc, tkkt = tge._flagship(8, torch.float64, torch.device("cpu"))
    ft = tflops.program_flops(tge.make_step(tc, tkkt), torch.as_tensor(V))
    print(f"\nKKT step flops, S10 ts=8, 2 lanes: port {ft:.0f}, "
          f"JAX {fj:.0f} (lowered {fb:.0f}), port/JAX {ft / fj:.4f} "
          f"(lowered {ft / fb:.4f})")
    assert ft > 0 and fj > 0 and fb > 0


def test_peak_flops_table(monkeypatch):
    assert tflops.peak_flops("cpu") is None
    if not torch.cuda.is_available():
        assert tflops.peak_flops() is None
    names = iter(["NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe",
                  "NVIDIA H100 NVL", "NVIDIA A100-SXM4-80GB"])
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: next(names))
    assert [tflops.peak_flops("cuda") for _ in range(4)] == [
        989.5e12, 756.5e12, 835.5e12, None]


def test_enable_compile_cache_moves_the_build_directory(tmp_path,
                                                        monkeypatch):
    """The kernels build under the directory given; nothing calls nvcc
    (the sources are left out, so there is nothing to compile)."""
    from tol_tpu_torch.ops import _build
    from tol_tpu_torch.utils.cache import enable_compile_cache

    default = _build.BUILD_ROOT
    monkeypatch.setattr(_build, "BUILD_ROOT", default)

    def no_nvcc():
        raise AssertionError("nvcc called")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_sources", lambda: [
        f for f in os.listdir(_build._CSRC) if f.endswith(".cuh")])
    enable_compile_cache(str(tmp_path / "kc"))
    assert _build.BUILD_ROOT == str(tmp_path / "kc")
    assert _build.build() == {}
    assert os.listdir(tmp_path / "kc") == [_build._source_hash()]
    enable_compile_cache()
    assert _build.BUILD_ROOT == default
