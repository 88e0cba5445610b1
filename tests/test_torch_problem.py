"""tol_tpu_torch's problem layers against tol_tpu's on the same inputs
(float64): .param readers, dynamics, wind models 0/1/2/4/5, the S10 seed
and NLP residuals, and the canonical (scaled) form.  G7 has its own file,
tests/test_torch_g7.py.

Both packages evaluate the same formulas; where the arithmetic order is the
same the results agree bitwise, elsewhere to a few ulps (TOL, relative to
the values' magnitude).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tol_tpu import api as japi
from tol_tpu.io import params as jparams
from tol_tpu.models import dynamics as jdyn
from tol_tpu.models import wind as jwind
from tol_tpu.problems import seed as jseed
from tol_tpu.solver import canonicalize as jcanonicalize
from tol_tpu_torch import api as tapi
from tol_tpu_torch.io import params as tparams
from tol_tpu_torch.models import dynamics as tdyn
from tol_tpu_torch.models import wind as twind
from tol_tpu_torch.problems import seed as tseed
from tol_tpu_torch.problems.base import instance_from_numpy
from tol_tpu_torch.solver.canonical import canonicalize as tcanonicalize

TOL = 1e-12
GOLDEN = "tests/golden_s10_ts100.npy"


def _f64(x):
    return torch.tensor(np.asarray(x, dtype=np.float64))


def _close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("name", ["skywalker", "tempest", "tempest_eric",
                                  "tempest_wences", "tempest_will"])
def test_aircraft_params_identical(name):
    root = tparams.assets_root()
    assert root == jparams.assets_root()
    assert tparams.load_aircraft(name, root)._asdict() == \
        jparams.load_aircraft(name, root)._asdict()


@pytest.mark.parametrize("mission", ["S10", "G7"])
def test_mission_params_identical(mission):
    root = tparams.assets_root()
    for fn in ("load_gains", "load_limits", "load_solver_dims"):
        assert getattr(tparams, fn)(mission, root)._asdict() == \
            getattr(jparams, fn)(mission, root)._asdict()
    cfg_t = tapi.make_config(mission, ts=20)
    cfg_j = japi.make_config(mission, ts=20)
    assert cfg_t.limits._asdict() == cfg_j.limits._asdict()
    assert cfg_t.dims._asdict() == cfg_j.dims._asdict()
    assert cfg_t.boxes._asdict() == pytest.approx(cfg_j.boxes._asdict())
    assert tapi.default_goal(mission)._asdict() == \
        japi.default_goal(mission)._asdict()


def test_param_line_parsing_quirks(tmp_path):
    p = tmp_path / "x.param"
    p.write_text("1.5 // comment\nabc\n  -2e3junk\n/ 7\n.25\\n\n")
    assert tparams.read_param_file(str(p)) == jparams.read_param_file(str(p)) \
        == [1.5, -2000.0, 0.25]


def test_state_derivatives_match():
    rng = np.random.default_rng(0)
    ac = jparams.load_aircraft("tempest", jparams.assets_root())
    z = rng.normal(size=(7, 11))
    z[:, 3] = 15.0 + rng.uniform(size=7)           # airspeed away from 0
    w = rng.normal(size=(7, 3))
    gw = rng.normal(size=(7, 3, 3))
    want = jax.vmap(jdyn.state_derivatives, in_axes=(0, 0, 0, None))(
        jnp.asarray(z), jnp.asarray(w), jnp.asarray(gw), ac)
    _close(tdyn.state_derivatives(torch.tensor(z), torch.tensor(w),
                                  torch.tensor(gw), ac), want)
    assert (tdyn.NUM_VARS, tdyn.NUM_STATES, tdyn.IDX_T) == \
        (jdyn.NUM_VARS, jdyn.NUM_STATES, jdyn.IDX_T)


@pytest.mark.parametrize("model", [0, 1, 2, 4, 5])
def test_wind_and_gradient_match(model):
    rng = np.random.default_rng(1)
    p = rng.normal(scale=50.0, size=(6, 3))
    # thermals and the vortex centred near the query points (field ENU =
    # local NED + datum), so the Gaussians and 1/r terms are not flat
    kw = dict(model=model, vref=3.1, href=7.0, xth=17410.0, yth=25790.0,
              vcore=2.5, rlift=45.0, xth2=17380.0, yth2=25830.0, vcore2=-1.5,
              rlift2=60.0)
    cfg_j = jwind.WindConfig(**kw)
    cfg_t = twind.WindConfig(**kw)
    wj, gj = jax.vmap(lambda q: jwind.wind_with_gradient_ned(cfg_j, q))(
        jnp.asarray(p))
    wt, gt = twind.wind_with_gradient_ned(cfg_t, torch.tensor(p))
    _close(wt, wj)
    _close(gt, gj)
    w1, g1 = twind.wind_with_gradient_ned(cfg_t, torch.tensor(p[0]))
    _close(w1, wj[0])
    _close(g1, gj[0])


@pytest.mark.parametrize("model", [2, 3, 4, 5])
def test_unported_wind_models_raise(model):
    """Only the gridded storm field (model 3) is still unported; the others
    evaluate, and the vortex is still at its core."""
    cfg = twind.WindConfig(model=model, xth=17400.0, yth=25800.0)
    if model == 3:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            twind.wind_ned(cfg, torch.zeros(3))
        return
    w, g = twind.wind_with_gradient_ned(cfg, torch.zeros(2, 3,
                                                         dtype=torch.float64))
    assert w.shape == (2, 3) and g.shape == (2, 3, 3)
    assert torch.isfinite(w).all()
    want = {2: [0.0, 0.0, -3.0], 4: None, 5: [0.0, 0.0, 0.0]}[model]
    if want is not None:
        assert w[0].tolist() == want
    with pytest.raises(ValueError, match="unknown wind model"):
        twind.wind_ned(twind.WindConfig(model=6), torch.zeros(3))


def test_seed_paths_and_inversion_match():
    ac = jparams.load_aircraft("tempest", jparams.assets_root())
    act = tparams.load_aircraft("tempest", tparams.assets_root())
    for jpath, tpath in [
            (jseed.s10_seed_path(24, aircraft=ac), tseed.s10_seed_path(24, aircraft=act)),
            (jseed.s10_seed_path(24), tseed.s10_seed_path(24)),
            (jseed.s10_zoom_seed_path(24, ac), tseed.s10_zoom_seed_path(24, act))]:
        for a, b in zip(tpath, jpath):
            _close(a, b)
        for periodic in (True, False):
            Zt, dtt = tseed.invert_flight_mechanics(tpath, act, periodic)
            Zj, dtj = jseed.invert_flight_mechanics(jpath, ac, periodic)
            _close(Zt, Zj)
            _close(dtt, dtj)


def test_unwrap_and_interp_match_numpy():
    rng = np.random.default_rng(2)
    p = np.cumsum(rng.normal(scale=2.5, size=50))
    _close(tseed._unwrap(torch.tensor(p)), np.unwrap(p))
    xp = np.sort(rng.uniform(size=30))
    x = rng.uniform(-0.2, 1.2, size=40)
    fp = rng.normal(size=30)
    _close(tseed._interp(torch.tensor(x), torch.tensor(xp), torch.tensor(fp)),
           np.interp(x, xp, fp))


@pytest.fixture(scope="module", params=[12, 100])
def s10(request):
    ts = request.param
    return (ts, japi.make_problem("S10", "tempest", ts=ts, wind_model=1),
            tapi.make_problem("S10", "tempest", ts=ts, wind_model=1,
                              device="cpu"))


def _points(ts, jn, tn):
    """The seed and, at ts=100, the golden optimum."""
    Zj, dtj = jn.seed()
    Zt, dtt = tn.seed()
    _close(Zt, Zj)
    _close(dtt, dtj)
    pts = [(np.asarray(Zj), float(dtj))]
    if ts == 100:
        g = np.load(GOLDEN)
        pts.append((g[1:].reshape(ts + 1, 11), float(g[0])))
    return pts


def test_s10_residuals_and_cost_match(s10):
    ts, jn, tn = s10
    for Z, dt in _points(ts, jn, tn):
        Zj, Zt = jnp.asarray(Z), _f64(Z)
        dj, dtt = jnp.asarray(dt), _f64(dt)
        _close(tn.all_defects(Zt, dtt), jn.all_defects(Zj, dj))
        _close(tn.boundary(Zt[0], Zt[-1], dtt), jn.boundary(Zj[0], Zj[-1], dj))
        _close(tn.constraints(Zt, dtt), jn.constraints(Zj, dj))
        _close(tn.total_cost(Zt, dtt), jn.total_cost(Zj, dj))
    _close(tn.z_lo, jn.z_lo)
    _close(tn.z_up, jn.z_up)
    # batched evaluation = per-lane evaluation
    Z, dt = _points(ts, jn, tn)[0]
    Zb = _f64(np.stack([Z, Z + 0.01]))
    dtb = _f64([dt, dt * 1.01])
    for i in range(2):
        _close(tn.constraints(Zb, dtb)[i], tn.constraints(Zb[i], dtb[i]))


def test_instance_from_numpy_round_trip(s10):
    ts, jn, tn = s10
    fields = jax.tree_util.tree_map(np.asarray, jn.inst0)._asdict()
    inst = instance_from_numpy(fields, device="cpu")
    Z, dt = _points(ts, jn, tn)[-1]
    _close(tn.constraints(_f64(Z), _f64(dt), inst),
           jn.constraints(jnp.asarray(Z), jnp.asarray(dt)))
    assert inst.wind.model == 1


def test_canonical_form_matches(s10):
    ts, jn, tn = s10
    jc = jcanonicalize(jn, scaling="auto")
    tc = tcanonicalize(tn, scaling="auto")
    assert (tc.n, tc.m, tc.n_slack) == (jc.n, jc.m, jc.n_slack)
    for a, b in zip(tc.scaling, jc.scaling):
        _close(a, b)
    for a, b in zip(tc.bounds(tc.nlp.inst0), jc.bounds(jc.nlp.inst0)):
        _close(a, b)
    v0j = jc.initial_point()
    _close(tc.initial_point(), v0j)
    rng = np.random.default_rng(3)
    V = np.asarray(v0j)[None] + 0.01 * rng.normal(size=(3, jc.n))
    fj = jax.vmap(lambda v: jc.f(v, jc.nlp.inst0))(jnp.asarray(V))
    cj = jax.vmap(lambda v: jc.c(v, jc.nlp.inst0))(jnp.asarray(V))
    _close(tc.f(torch.tensor(V), tc.nlp.inst0), fj)
    _close(tc.c(torch.tensor(V), tc.nlp.inst0), cj)
    Zj, dtj, sj = jc.split(jnp.asarray(V[0]))
    Zt, dtt, st = tc.split(torch.tensor(V))
    _close(Zt[0], Zj)
    _close(dtt[0], dtj)
    _close(tc.join(Zt, dtt, st), V)
    _close(tc.to_physical(torch.tensor(V))[1], jc.to_physical(jnp.asarray(V[1])))
    _close(tc.from_physical(torch.tensor(V))[2],
           jc.from_physical(jnp.asarray(V[2])))


def test_unscaled_canonical_form_matches():
    jc = jcanonicalize(japi.make_problem("S10", "tempest", ts=8))
    tc = tcanonicalize(tapi.make_problem("S10", "tempest", ts=8, device="cpu"))
    v = jc.initial_point()
    _close(tc.f(torch.tensor(np.asarray(v)), tc.nlp.inst0), jc.f(v, jc.nlp.inst0))
    _close(tc.c(torch.tensor(np.asarray(v)), tc.nlp.inst0), jc.c(v, jc.nlp.inst0))
    _close(tc.v_scale(), jc.v_scale())


def test_g7_raises_until_its_slice():
    """G7's slice has come: it builds (tests/test_torch_g7.py holds it
    against tol_tpu); a mission neither package has is refused."""
    nlp = tapi.make_problem("G7", "skywalker", ts=8, device="cpu")
    assert (nlp.mission, nlp.nb, int(nlp.boundary_is_ineq.sum())) == ("G7", 12, 2)
    with pytest.raises(FileNotFoundError):
        tapi.make_problem("S11", "tempest", ts=8, device="cpu")


def test_wind_config_fields_match():
    names = lambda cls: [f.name for f in dataclasses.fields(cls)]
    assert names(twind.WindConfig) == names(jwind.WindConfig)
    assert twind.WindConfig().vref == jwind.WindConfig().vref
    assert math.isclose(tparams._DEG, jparams._DEG)
