"""The port's storm path against tol_tpu's on the same inputs (float64,
CPU): wind model 3 (orders 1 and 2; the separable, onehot and gather
lowerings), its three pinned quirks, io/storm.py, io/native.py,
canonical.unit_scaling, and the S10 storm NLP on the demo grid.

Tolerances: the interpolation is the same arithmetic on both sides up to
the order of a few sums, so values and gradients agree to TOL = 1e-12
relative to their magnitude; Hessians and KKT solves to the round-off
their assembly amplifies (stated at each test).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tol_tpu.api import make_problem as jmake_problem
from tol_tpu.io import native as jnative
from tol_tpu.io import storm as jstorm
from tol_tpu.models import wind as jwind
from tol_tpu.solver import alm as jalm
from tol_tpu.solver import canonicalize as jcanonicalize
from tol_tpu.solver.canonical import unit_scaling as junit
from tol_tpu.solver.kkt_condensed import make_condensed_kkt as jcondensed
from tol_tpu_torch.api import make_problem as tmake_problem
from tol_tpu_torch.io import native as tnative
from tol_tpu_torch.io import storm as tstorm
from tol_tpu_torch.io.params import assets_root
from tol_tpu_torch.models import wind as twind
from tol_tpu_torch.solver import alm as talm
from tol_tpu_torch.solver.canonical import canonicalize as tcanonicalize
from tol_tpu_torch.solver.canonical import unit_scaling as tunit
from tol_tpu_torch.solver.kkt_condensed import derivative_blocks
from tol_tpu_torch.solver.kkt_condensed import make_condensed_kkt as tcondensed

TOL = 1e-12
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VREF, HREF, UP0 = 2.4, 10.0, 200.0
DATUM = dict(east0=17400.0, north0=25800.0, up0=UP0)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _grids(**kw):
    return jstorm.make_demo_storm_grid(**kw), tstorm.make_demo_storm_grid(
        device="cpu", **kw)


def _positions(n=48, seed=0):
    """Aircraft-local NED points, a quarter of them outside the demo grid
    (which spans about -400..650 m north/east and -200..550 m up of the
    datum), so that the clamped edge stencils are exercised."""
    rng = np.random.default_rng(seed)
    inside = rng.uniform([-350, -350, -450], [600, 600, 150], (3 * n // 4, 3))
    outside = rng.uniform([-900, -900, -900], [1200, 1200, 400], (n // 4, 3))
    return np.concatenate([inside, outside])


def _wind_pair(jgrid, tgrid, P, **cfg):
    jc = jwind.WindConfig(model=3, grid=jgrid, **DATUM, **cfg)
    tc = twind.WindConfig(model=3, grid=tgrid, **DATUM, **cfg)
    wj, gj = jax.jit(jax.vmap(lambda p: jwind.wind_with_gradient_ned(jc, p)))(
        jnp.asarray(P))
    wt, gt = twind.wind_with_gradient_ned(tc, torch.tensor(P))
    return (wj, gj), (wt, gt), jc, tc


@pytest.mark.parametrize("interp", ["separable", "onehot", "gather"])
@pytest.mark.parametrize("order", [1, 2])
def test_model3_wind_and_gradient_match(order, interp):
    jg, tg = _grids()
    P = _positions()
    (wj, gj), (wt, gt), jc, tc = _wind_pair(jg, tg, P, order=order,
                                            interp=interp)
    _close(wt, wj)
    _close(gt, gj)
    _close(twind.wind_ned(tc, torch.tensor(P)),
           jax.jit(jax.vmap(lambda p: jwind.wind_ned(jc, p)))(jnp.asarray(P)))
    assert np.abs(_np(gt)).max() > 1e-3       # a live, nonuniform field
    # the three lowerings compute the same field
    ref = twind.WindConfig(model=3, grid=tg, order=order, interp="gather",
                           **DATUM)
    _close(wt, twind.wind_ned(ref, torch.tensor(P)))


def test_model3_hessian_under_nested_transforms_matches():
    """The solver takes Hessians of the defect rows by forward mode over
    reverse mode over the wind gradient's forward mode: three nested
    transforms through the rounding and the integer stencil index.  Held
    against jax.hessian (tolerance 1e-11: the third derivative sums)."""
    from torch.func import grad

    from tol_tpu_torch.solver.canonical import jacfwd_lanes
    jg, tg = _grids()
    P = _positions(24, seed=1)
    jc = jwind.WindConfig(model=3, grid=jg, order=2, **DATUM)
    tc = twind.WindConfig(model=3, grid=tg, order=2, **DATUM)
    Hj = jax.jit(jax.vmap(jax.hessian(
        lambda p: jnp.sum(jwind.wind_with_gradient_ned(jc, p)[1] ** 2))))(
        jnp.asarray(P))
    Ht = jacfwd_lanes(grad(lambda p: (twind.wind_with_gradient_ned(
        tc, p)[1] ** 2).sum()), torch.tensor(P))
    _close(Ht, Hj, 1e-11)


def _boundary_layer_grid(nx=6, ny=6, nz=5, spacing=150.0):
    """Grid whose v component samples v = -Vref * z_local / href."""
    origin = (17000.0, 25500.0, 0.0)
    zs = origin[2] + spacing * np.arange(nz)
    v = np.broadcast_to(-VREF * (zs - UP0) / HREF, (nx, ny, nz))
    return (np.zeros((nx, ny, nz)), v, np.zeros((nx, ny, nz)), origin,
            (spacing, spacing, spacing))


@pytest.mark.parametrize("order", [1, 2])
def test_model3_boundary_layer_grid_reproduces_model1(order):
    """Both orders have linear precision: a grid that samples the linear
    model-1 field reproduces model 1 (tests/test_storm.py:76), gradient
    included."""
    u, v, w, origin, spacing = _boundary_layer_grid()
    grid = tstorm.grid_from_arrays(u, v, w, origin, spacing, device="cpu")
    cfg3 = twind.WindConfig(model=3, grid=grid, order=order, **DATUM)
    cfg1 = twind.WindConfig(model=1, vref=VREF, href=HREF, up0=UP0)
    P = torch.tensor([[0.0, 0.0, -40.0], [100.0, -200.0, -120.0],
                      [-50.0, 80.0, -5.0]], dtype=torch.float64)
    w3, g3 = twind.wind_with_gradient_ned(cfg3, P)
    w1, g1 = twind.wind_with_gradient_ned(cfg1, P)
    _close(w3, w1, 1e-9)
    _close(g3, g1, 1e-9)


@pytest.mark.parametrize("cells,lowering", [((64, 32, 32), "separable"),
                                            ((64, 32, 33), "gather")])
def test_quirk_auto_cutoff_is_65536_cells(cells, lowering, monkeypatch):
    """ADVICE.md (wind.py:348): "auto" takes the separable lowering up to
    65536 cells and the gather lowering above, in both packages."""
    rng = np.random.default_rng(3)
    u, v, w = (rng.normal(size=cells) for _ in range(3))
    origin, spacing = (17000.0, 25500.0, 0.0), (20.0, 20.0, 20.0)
    called = []
    for mod in (jwind, twind):
        for name in ("separable", "onehot", "gather"):
            fn = getattr(mod, f"_grid_interp_{name}")
            monkeypatch.setattr(
                mod, f"_grid_interp_{name}",
                lambda *a, _f=fn, _n=name, _m=mod: (called.append(
                    (_m.__name__.split(".")[0], _n)), _f(*a))[1])
    jg = jstorm.grid_from_arrays(u, v, w, origin, spacing, live=(1, 1, 1))
    tg = tstorm.grid_from_arrays(u, v, w, origin, spacing, live=(1, 1, 1),
                                 device="cpu")
    P = _positions(4)
    wj = jwind.wind_ned(jwind.WindConfig(model=3, grid=jg, **DATUM),
                        jnp.asarray(P[0]))
    wt = twind.wind_ned(twind.WindConfig(model=3, grid=tg, **DATUM),
                        torch.tensor(P[:1]))
    assert called == [("tol_tpu", lowering), ("tol_tpu_torch", lowering)]
    _close(wt[0], wj)


@pytest.mark.parametrize("interp", ["separable", "onehot", "gather"])
def test_quirk_field_is_evaluated_in_query_precision(interp):
    """ADVICE.md (wind.py:273): the separable (and onehot) lowering casts
    the field to the query dtype; the gather lowering promotes.  A float64
    field queried in float32 gives float32 from separable and onehot, equal
    to the same field rounded to float32 beforehand, and float64 from
    gather, as in the JAX package (float32 values: tolerance 1e-6)."""
    rng = np.random.default_rng(4)
    shape = (6, 6, 5)
    F = [rng.normal(size=shape) for _ in range(3)]
    org, sp = [17000.0, 25500.0, 0.0], [150.0] * 3

    def tgrid(fdt):
        t = lambda a, dt=torch.float32: torch.tensor(np.asarray(a), dtype=dt)
        return twind.WindGrid(t(org), t(sp), *[t(f, fdt) for f in F],
                              t([1.0, 1.0, 1.0]))

    jg = jwind.WindGrid(*[jnp.asarray(np.asarray(a, np.float32))
                          for a in (org, sp)], *[jnp.asarray(f) for f in F],
                        jnp.ones(3, jnp.float32))
    P = _positions(16).astype(np.float32)
    tc = lambda g: twind.WindConfig(model=3, grid=g, interp=interp, order=2,
                                    **DATUM)
    wt = twind.wind_ned(tc(tgrid(torch.float64)), torch.tensor(P))
    jc = jwind.WindConfig(model=3, grid=jg, interp=interp, order=2, **DATUM)
    wj = jax.vmap(lambda p: jwind.wind_ned(jc, p))(jnp.asarray(P))
    want = np.float64 if interp == "gather" else np.float32
    assert np.asarray(wj).dtype == want
    assert _np(wt).dtype == want
    _close(wt, wj, 1e-6)
    rounded = twind.wind_ned(tc(tgrid(torch.float32)), torch.tensor(P))
    if interp == "gather":
        assert not torch.equal(wt.float(), rounded)
    else:
        assert torch.equal(wt, rounded)


def test_quirk_short_axis_drops_weight_in_separable_and_wraps_in_gather():
    """ADVICE.md (wind.py:261): with order 2 on an axis of 2 nodes the
    stencil base is -1.  The separable lowering then drops that row's weight
    (a field of ones no longer interpolates to 1), the gather lowering
    wraps the index to the end of the flat field (a field of ones still
    gives 1); both packages alike."""
    shape = (5, 5, 2)
    ones = np.ones(shape)
    ramp = np.arange(np.prod(shape), dtype=np.float64).reshape(shape)
    P = _positions(12)
    for field, check in ((ones, "dropped"), (ramp, "wrapped")):
        jg = jstorm.grid_from_arrays(field, field, field,
                                     (17000.0, 25500.0, 0.0), (150.0,) * 3,
                                     live=(1, 1, 1))
        tg = tstorm.grid_from_arrays(field, field, field,
                                     (17000.0, 25500.0, 0.0), (150.0,) * 3,
                                     live=(1, 1, 1), device="cpu")
        out = {}
        for interp in ("separable", "gather"):
            jc = jwind.WindConfig(model=3, grid=jg, order=2, interp=interp,
                                  **DATUM)
            tc = twind.WindConfig(model=3, grid=tg, order=2, interp=interp,
                                  **DATUM)
            wj = jax.vmap(lambda p: jwind.wind_ned(jc, p))(jnp.asarray(P))
            out[interp] = twind.wind_ned(tc, torch.tensor(P))
            _close(out[interp], wj)
        if check == "dropped":
            _close(np.abs(_np(out["gather"])), np.ones((len(P), 3)))
            assert (np.abs(np.abs(_np(out["separable"])) - 1.0) > 1e-3).all()
        else:
            assert not np.allclose(_np(out["separable"]), _np(out["gather"]))


def test_grid_from_arrays_sentinels_and_dtypes():
    rng = np.random.default_rng(5)
    u, v, w = (rng.normal(size=(4, 5, 3)) for _ in range(3))
    v[0, 0, 0] = tstorm.SENTINEL
    v[1, 2, 1] = tstorm.SENTINEL - 7.0
    u[2, 2, 2] = np.nan
    assert tstorm.SENTINEL == jstorm.SENTINEL
    jg = jstorm.grid_from_arrays(u, v, w, (1.0, 2.0, 3.0), (10.0, 20.0, 30.0))
    for dtype in (torch.float64, torch.float32):
        tg = tstorm.grid_from_arrays(u, v, w, (1.0, 2.0, 3.0),
                                     (10.0, 20.0, 30.0), dtype=dtype,
                                     device="cpu")
        for name in twind.WindGrid._fields:
            np.testing.assert_array_equal(
                _np(getattr(tg, name)),
                np.asarray(getattr(jg, name)).astype(
                    _np(getattr(tg, name)).dtype))
        assert tg.u.dtype == torch.float32 and tg.origin.dtype == dtype
    assert float(tg.v[0, 0, 0]) == 0.0 and float(tg.v[1, 2, 1]) == 0.0
    assert float(tg.u[2, 2, 2]) == 0.0
    with pytest.raises(ValueError, match="not 3-D"):
        tstorm.grid_from_arrays(u[0], v[0], w[0], (0, 0, 0), (1, 1, 1),
                                device="cpu")


def _write_netcdf(path, u, v, w, origin, spacing):
    from scipy.io import netcdf_file

    nx, ny, nz = u.shape
    with netcdf_file(path, "w") as nc:
        for name, n, o, s in (("x", nx, origin[0], spacing[0]),
                              ("y", ny, origin[1], spacing[1]),
                              ("z", nz, origin[2], spacing[2])):
            nc.createDimension(name, n)
            var = nc.createVariable(name, "d", (name,))
            var[:] = o + s * np.arange(n)
        for name, data in (("u", u), ("v", v), ("w", w)):
            var = nc.createVariable(name, "d", ("x", "y", "z"))
            var[:] = data


def test_netcdf_import_roundtrip(tmp_path):
    u, v, w, origin, spacing = _boundary_layer_grid()
    v = np.array(v)
    v[0, 0, 0] = tstorm.SENTINEL
    nc_path = str(tmp_path / "storm.nc")
    _write_netcdf(nc_path, u, v, w, origin, spacing)
    tg = tstorm.import_netcdf_storm(nc_path, out_path=str(tmp_path / "t.bin"),
                                    device="cpu")
    jg = jstorm.import_netcdf_storm(nc_path, out_path=str(tmp_path / "j.bin"))
    assert float(tg.v[0, 0, 0]) == 0.0
    for name in twind.WindGrid._fields:
        _close(getattr(tg, name), getattr(jg, name), 0.0)
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    back = tnative.read_wind_grid(str(tmp_path / "t.bin"), device="cpu")
    for name in ("origin", "spacing", "u", "v", "w"):
        _close(getattr(back, name), getattr(tg, name), 0.0)


@pytest.fixture(params=["library", "python"])
def native_lib(request, monkeypatch):
    """Both packages with the native library, or both on their
    pure-Python paths."""
    if request.param == "python":
        for mod in (jnative, tnative):
            monkeypatch.setattr(mod, "_LIB", None)
            monkeypatch.setattr(mod, "_LIB_TRIED", True)
    else:
        assert tnative.load_library() is not None
        assert jnative.load_library() is not None
    return request.param


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_tolwgrid_across_packages(tmp_path, native_lib, writer):
    rng = np.random.default_rng(6)
    u, v, w = (rng.normal(size=(4, 5, 3)).astype(np.float32)
               for _ in range(3))
    path = str(tmp_path / "grid.tolw")
    write = (jnative if writer == "jax" else tnative).write_wind_grid
    write(path, [100.0, 200.0, 0.5], [150.0, 140.0, 130.0], u, v, w)
    raw = open(path, "rb").read()
    assert raw[:8] == b"TOLWGRID" and len(raw) == 72 + 3 * 4 * u.size
    jg = jnative.read_wind_grid(path)
    tg = tnative.read_wind_grid(path, device="cpu")
    for name in twind.WindGrid._fields:
        _close(getattr(tg, name), getattr(jg, name), 0.0)
    _close(tg.v, v, 0.0)
    assert tg.origin.dtype == torch.float64
    assert tnative.read_wind_grid(path, dtype=torch.float32,
                                  device="cpu").spacing.dtype == torch.float32


def test_param_reader_and_telemetry_logger(tmp_path, native_lib):
    for rel in ["aircraft/tempest.param", "problems/S10/gains.param",
                "problems/G7/snopt.param"]:
        path = os.path.join(assets_root(), rel)
        assert tnative.read_params_native(path) == \
            jnative.read_params_native(path)
    if native_lib == "library":
        p = tmp_path / "quirky.param"
        p.write_text("//header\n6.1228\\n // mass\n-0.45   / min CL\n"
                     "notanumber\n1e20\n")
        np.testing.assert_allclose(tnative.read_params_native(str(p)),
                                   [6.1228, -0.45, 1e20])
    recs = [(1, [1.0, 2.0, 3.0]), (7, np.arange(10.0)), (2, [])]
    for mod, name in ((tnative, "t.bin"), (jnative, "j.bin")):
        lg = mod.TelemetryLogger(str(tmp_path / name))
        for tag, vals in recs:
            lg.append(tag, vals)
        lg.close()
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    got = tnative.read_telemetry(str(tmp_path / "j.bin"))
    want = jnative.read_telemetry(str(tmp_path / "t.bin"))
    assert [t for t, _ in got] == [t for t, _ in want] == [1, 7, 2]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_unit_scaling_matches():
    jn = jmake_problem("S10", "tempest", ts=8, wind_model=1)
    tn = tmake_problem("S10", "tempest", ts=8, wind_model=1, device="cpu")
    sj, st = junit(jn), tunit(tn)
    for name in st._fields:
        _close(getattr(st, name), getattr(sj, name), 0.0)
    assert tunit(tn, torch.float32).d_z.dtype == torch.float32
    # unit scaling leaves the canonical form the unscaled one
    tc = tcanonicalize(tn, scaling=st)
    v = tc.initial_point()[None]
    _close(tc.f(v, tc.nlp.inst0), tcanonicalize(tn).f(v, tc.nlp.inst0))


STORM_TS = 8


@functools.lru_cache(maxsize=None)
def storm_pair(ts=STORM_TS):
    """The S10 / tempest storm NLP of bench.py config 5 on the demo grid
    (order 2, interp "auto"), canonical with the default scaling, in both
    packages."""
    jg, tg = _grids()
    jn = jmake_problem("S10", "tempest", ts=ts, wind_model=3,
                       wind=jwind.WindConfig(model=3, grid=jg, order=2,
                                             **DATUM))
    tn = tmake_problem("S10", "tempest", ts=ts, wind_model=3,
                       wind=twind.WindConfig(model=3, grid=tg, order=2,
                                             **DATUM), device="cpu")
    return jcanonicalize(jn, scaling="auto"), tcanonicalize(tn, scaling="auto")


def storm_seeds(jc, n, seed=3):
    lb, ub, fixed = [np.asarray(x) for x in jc.bounds(jc.nlp.inst0)]
    v0 = np.asarray(jc.initial_point())
    dv = 0.01 * np.random.default_rng(seed).standard_normal((n, jc.n))
    return np.where(fixed, lb, np.clip(v0 + dv, lb, ub))


def test_storm_nlp_f_c_and_derivative_blocks_match():
    """The storm NLP at ts=12: scaling, f and c at three seeded points, and
    the blocks of the condensed KKT that the wind reaches (node Hessians of
    the node Lagrangian, defect Jacobians, at two lanes' nodes) against the
    JAX package's jax.hessian / jax.jacfwd of the same functions, as its
    kkt_condensed.make_condensed_kkt takes them.  Tolerance TOL for f, c
    and the Jacobians; 1e-10 for the Hessians (a third derivative of the
    spline field)."""
    jc, tc = storm_pair(12)
    for name in ("d_z", "d_dt", "r_b", "s_f"):
        _close(getattr(tc.scaling, name), getattr(jc.scaling, name))
    V = storm_seeds(jc, 3)
    inst_j, inst_t = jc.nlp.inst0, tc.nlp.inst0
    _close(tc.f(torch.tensor(V), inst_t),
           jax.jit(jax.vmap(lambda v: jc.f(v, inst_j)))(jnp.asarray(V)))
    _close(tc.c(torch.tensor(V), inst_t),
           jax.jit(jax.vmap(lambda v: jc.c(v, inst_j)))(jnp.asarray(V)))

    jn, tn = jc.nlp, tc.nlp
    NV, T = 11, 12
    rng = np.random.default_rng(7)
    lanes = [jc.split(jnp.asarray(v))[:2] for v in V[:2]]
    Zn = np.stack([np.asarray(Z) for Z, _ in lanes])
    dtn = np.array([float(dt) for _, dt in lanes])
    U = np.concatenate([Zn, np.repeat(dtn[:, None, None], T + 1, 1)], 2)
    # the solver's node blocks: multipliers on the T defects, none on node T
    Y = rng.normal(scale=0.3, size=(2, T + 1, 8))
    Y[:, T] = 0.0

    def node_lag(u, y):
        return (jn.node_cost(u[:NV], u[NV], inst_j)
                + y @ jn.defect(u[:NV], jnp.zeros(NV), u[NV], inst_j))

    Hj = jax.jit(jax.vmap(jax.hessian(node_lag)))(
        jnp.asarray(U.reshape(-1, NV + 1)), jnp.asarray(Y.reshape(-1, 8)))
    node_blocks, _, defect_jac, _ = derivative_blocks(tc)
    Ht, At, dtt = node_blocks(torch.tensor(Zn), torch.tensor(dtn),
                              torch.tensor(Y[:, :T]), inst_t)
    _close(Ht.reshape(-1, NV + 1, NV + 1), Hj, 1e-10)
    Aj, dj = jax.jit(jax.vmap(jax.jacfwd(jn.defect, argnums=(0, 2)),
                              in_axes=(0, 0, 0, None)))(
        jnp.asarray(Zn[:, :-1].reshape(-1, NV)),
        jnp.asarray(Zn[:, 1:].reshape(-1, NV)),
        jnp.asarray(np.repeat(dtn, T)), inst_j)
    for got in ((At, dtt), defect_jac(torch.tensor(Zn), torch.tensor(dtn),
                                      inst_t)):
        _close(got[0].reshape(-1, 8, NV), Aj)
        _close(got[1].reshape(-1, 8), dj)


def storm_params():
    """bench.py's storm endgame numerics (config 5) in float64."""
    base = dict(tol=5e-3, feas_tol=1e-4, mu_init=6e-5, mu_min=1e-5,
                mu_shrink=0.1, theta_mu=1.2, gamma_init=0.01, gamma_min=1e-6,
                gamma_shrink=0.2, prox=2.5e-3, eta=1e-4, tau_min=0.99,
                kappa_inner=2.0, delta_decay=0.2, gamma_eager=1.0,
                max_iter=250)
    mi = base.pop("max_iter")
    pj = jalm.ALMParams(**{k: jnp.asarray(v, jnp.float64)
                           for k, v in base.items()},
                        max_iter=jnp.asarray(mi, jnp.int32))
    pt = talm.alm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, pj)._asdict(), device="cpu")
    return pj, pt


def test_two_lane_storm_solve_matches():
    """Two lanes of the storm NLP at ts=8 with bench.py's storm endgame
    (4 Armijo trials, dual CG k=4, refine=1, chain crp) to convergence:
    the same iteration count on each lane and the same converged flags;
    f within 1e-9 relative (float64 round-off carried through every
    Newton step)."""
    jc, tc = storm_pair()
    V = storm_seeds(jc, 2)
    pj, pt = storm_params()
    kw = dict(max_iter=2000, dual_refine_k=4, max_ls=4)
    kj = jcondensed(jc, refine=1, chain="crp")
    rj = jax.jit(jax.vmap(lambda v: jalm.solve(
        jc, kj, jalm.ALMOptions(**kw), v0=v, params=pj)))(jnp.asarray(V))
    kt = tcondensed(tc, refine=1, chain="crp")
    rt = talm.solve(tc, kt, talm.ALMOptions(**kw), v0=torch.tensor(V),
                    params=pt)
    assert np.asarray(rj.converged).all()
    np.testing.assert_array_equal(_np(rt.converged), np.asarray(rj.converged))
    np.testing.assert_array_equal(_np(rt.iterations),
                                  np.asarray(rj.iterations))
    np.testing.assert_allclose(_np(rt.f), np.asarray(rj.f), rtol=1e-9)


def test_golden_storm_point_is_feasible_in_the_port():
    """tests/golden_storm_ts100.npy on the port's storm NLP at ts=100 (the
    demo grid, order 2): feasible to near float64 precision, below the
    seed's cost, and f equal to the JAX package's at the same point."""
    vp = np.load(os.path.join(ROOT, "tests", "golden_storm_ts100.npy"))
    tg = tstorm.make_demo_storm_grid(device="cpu")
    tn = tmake_problem("S10", "tempest", ts=100, wind_model=3,
                       wind=twind.WindConfig(model=3, grid=tg, order=2,
                                             **DATUM), device="cpu")
    tc = tcanonicalize(tn, scaling="auto")
    v = tc.from_physical(torch.tensor(vp))
    viol = float(tc.c(v, tn.inst0).abs().max())
    assert viol < 1e-7, viol
    f = float(tc.f(v, tn.inst0))
    assert f < float(tc.f(tc.initial_point(), tn.inst0))
    jg = jstorm.make_demo_storm_grid()
    jn = jmake_problem("S10", "tempest", ts=100, wind_model=3,
                       wind=jwind.WindConfig(model=3, grid=jg, order=2,
                                             **DATUM))
    jc = jcanonicalize(jn, scaling="auto")
    fj = float(jc.f(jc.from_physical(jnp.asarray(vp)), jn.inst0))
    assert abs(f - fj) <= TOL * abs(fj)
