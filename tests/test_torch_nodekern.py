"""The closed-form collocation node blocks (``ops/nodekern.py``, kernel K9).

The kernel's per-node arithmetic (``csrc/nodekern_block.cuh``, the same
``nk::node_at`` the CUDA kernel runs for each node, under the affine wind
and under the gridded storm field) is built for the host with g++ and held,
in float64 and in float32, to the ``torch.func`` transforms that take the
same blocks on the CPU (``solver/kkt_condensed.py`` ``derivative_blocks``,
``solver/canonical.py`` ``constraint_jac_blocks``); the grid's stencil at
positions that stress it (ties, nodes, every face outside, a masked
component); the missions' closed-form node-cost Hessians to ``torch.func``;
and the solver's choice between kernel and transforms to what the problem
shows.
Port only: this file imports neither JAX nor the JAX package.  The card's
test of both entry points is in ``tests/test_torch_cuda.py``.
"""

import ctypes
import dataclasses
import os
import shutil
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.func import hessian

from tol_tpu_torch.api import make_problem
from tol_tpu_torch.io.storm import make_demo_storm_grid
from tol_tpu_torch.models.wind import WindConfig, affine_wind
from tol_tpu_torch.ops import nodekern
from tol_tpu_torch.problems import g7, s10
from tol_tpu_torch.solver.canonical import (canonicalize, closed_form_blocks,
                                            constraint_jac_blocks,
                                            unit_scaling)
from tol_tpu_torch.solver.kkt_condensed import derivative_blocks

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tol_tpu_torch", "csrc")
TS = 8
# Float64: the closed form and the transforms round differently, a few ulps
# of each block's largest entry.  Float32 kernel against the float64
# transforms at the same float32 point: float32's rounding of a few
# thousand operations, well inside 1e-5 of the largest entry.
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}

_SHIM = r"""
#include "nodekern_block.cuh"

// every node of B lanes through nk::node_at, its rows scattered as the
// kernel's copy-out leaves them
template <typename T, typename Fld>
static void run(const T* Z, long ldz, const T* dt, long lddt, const T* Y,
                long ldy, const T* par, const Fld& F, long B, int npl,
                int Tn, int hess, T* Hn, T* A, T* d) {
  T out[nk::out_floats(true)];
  for (long g = 0; g < B * npl; ++g) {
    const T* o = out;
    if (hess) {
      nk::node_at<T, true>(g, Z, ldz, dt, lddt, Y, ldy, npl, Tn, par, F, out);
      for (int e = 0; e < nk::H_FLOATS; ++e) Hn[g * nk::H_FLOATS + e] = o[e];
      o += nk::H_FLOATS;
    } else {
      nk::node_at<T, false>(g, Z, ldz, dt, lddt, Y, ldy, npl, Tn, par, F,
                            out);
    }
    for (int e = 0; e < nk::A_FLOATS; ++e) A[g * nk::A_FLOATS + e] = o[e];
    o += nk::A_FLOATS;
    for (int e = 0; e < nk::D_FLOATS; ++e) d[g * nk::D_FLOATS + e] = o[e];
  }
}

extern "C" {
void h_blocks(const double* Z, long ldz, const double* dt, long lddt,
              const double* Y, long ldy, const double* par,
              const double* field, long B, int npl, int Tn, int hess,
              double* Hn, double* A, double* d) {
  run(Z, ldz, dt, lddt, Y, ldy, par, nk::make_field<double>(field), B, npl,
      Tn, hess, Hn, A, d);
}
void f_blocks(const float* Z, long ldz, const float* dt, long lddt,
              const float* Y, long ldy, const float* par, const double* field,
              long B, int npl, int Tn, int hess, float* Hn, float* A,
              float* d) {
  run(Z, ldz, dt, lddt, Y, ldy, par, nk::make_field<float>(field), B, npl,
      Tn, hess, Hn, A, d);
}
void h_grid(const double* Z, long ldz, const double* dt, long lddt,
            const double* Y, long ldy, const double* par, const double* c,
            const float* u, const float* v, const float* w,
            const double* origin, const double* spacing, const float* live,
            int nx, int ny, int nz, long B, int npl, int Tn, int hess,
            double* Hn, double* A, double* d) {
  run(Z, ldz, dt, lddt, Y, ldy, par,
      nk::make_grid<double>(c, u, v, w, origin, spacing, live, nx, ny, nz), B,
      npl, Tn, hess, Hn, A, d);
}
void f_grid(const float* Z, long ldz, const float* dt, long lddt,
            const float* Y, long ldy, const float* par, const double* c,
            const float* u, const float* v, const float* w,
            const float* origin, const float* spacing, const float* live,
            int nx, int ny, int nz, long B, int npl, int Tn, int hess,
            float* Hn, float* A, float* d) {
  run(Z, ldz, dt, lddt, Y, ldy, par,
      nk::make_grid<float>(c, u, v, w, origin, spacing, live, nx, ny, nz), B,
      npl, Tn, hess, Hn, A, d);
}
}
"""


@pytest.fixture(scope="module")
def host_nodekern(tmp_path_factory):
    """``nk::node_at`` over every node, built with g++ (float64 ``h_``,
    float32 ``f_``; ``_blocks`` the affine wind, ``_grid`` the grid)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    d = tmp_path_factory.mktemp("nodekern_host")
    src = d / "shim.cpp"
    src.write_text(_SHIM)
    lib = d / "libnodekern_host.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    "-std=c++17", "-I", CSRC, "-o", str(lib), str(src)],
                   check=True)
    so = ctypes.CDLL(str(lib))
    P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    for fn in (so.h_blocks, so.f_blocks):
        fn.argtypes = [P, L] * 3 + [P, P, L, I, I, I, P, P, P]
    for fn in (so.h_grid, so.f_grid):
        fn.argtypes = [P, L] * 3 + [P] * 8 + [I] * 3 + [L, I, I, I, P, P, P]
    return so


def _host_blocks(so, Z, dt, y, par, fld, hess):
    """The host build over Z (B, T+1, 11) as the kernel's wrappers take it:
    with ``hess`` every node's (Hn, A, d) (nodekern.node_blocks), else A, d
    of nodes 0..T-1 (nodekern.defect_blocks); ``fld`` from nodekern.field
    or nodekern.grid_field."""
    B, T = Z.shape[0], Z.shape[1] - 1
    npl = T + 1 if hess else T
    new = lambda *s: torch.zeros(B, npl, *s, dtype=Z.dtype)
    Hn, A, d = new(12, 12), new(8, 11), new(8)
    f64 = Z.dtype == torch.float64
    Y = y if hess else Z
    if isinstance(fld, nodekern.GridField):
        fn = so.h_grid if f64 else so.f_grid
        keep = [fld.origin.to(Z.dtype), fld.spacing.to(Z.dtype)]
        wind = (fld.consts, fld.u.data_ptr(), fld.v.data_ptr(),
                fld.w.data_ptr(), keep[0].data_ptr(), keep[1].data_ptr(),
                fld.live.data_ptr(), *fld.u.shape)
    else:
        fn = so.h_blocks if f64 else so.f_blocks
        wind = (fld,)
    fn(Z.data_ptr(), Z.stride(0), dt.data_ptr(), dt.stride(0), Y.data_ptr(),
       Y.stride(0), par.data_ptr(), *wind, B, npl, T, int(hess),
       Hn.data_ptr(), A.data_ptr(), d.data_ptr())
    return (Hn, A, d) if hess else (A, d)


def _storm(order=2, grid=True, live=None, dtype=torch.float64):
    """Wind model 3 on the demo storm grid (origin and spacing in ``dtype``;
    all three components live, or ``live``), the storm cell's local
    origin."""
    g = make_demo_storm_grid(dtype=dtype, device="cpu") if grid else None
    if live is not None:
        g = g._replace(live=torch.tensor(live, dtype=torch.float32))
    return WindConfig(model=3, grid=g, order=order, east0=17400.0,
                      north0=25800.0, up0=200.0)


def _wind(model):
    """The problem's wind config and the kernel's wind for model 0, 1 (the
    affine field) or 3 (the demo storm grid at order 2)."""
    cfg = _storm() if model == 3 else WindConfig(model=model)
    fld = (nodekern.grid_field(cfg) if model == 3 else nodekern.field(
        *affine_wind(cfg)))
    return cfg, fld


# physical amplitude of the noise on each node variable: x, y, z (m), Va,
# gamma, chi, phi, CL, the rates, T
_AMP = torch.tensor([60.0, 60.0, 30.0, 3.0, 0.15, 0.4, 0.3, 0.2, 0.3, 0.3,
                     2.0], dtype=torch.float64)


def _points(can, B, seed):
    """B points near the seed trajectory, moved off it in every node
    variable and in dt, inside the bounds; (B, T, 8) defect multipliers."""
    rng = np.random.default_rng(seed)
    T = can.nlp.T
    v = can.to_physical(can.initial_point())[None].repeat(B, 1)
    noise = torch.as_tensor(rng.standard_normal(v.shape))
    nz = 1 + (T + 1) * 11
    v[:, 1:nz] += (noise[:, 1:nz].reshape(B, T + 1, 11) * _AMP).reshape(B, -1)
    v[:, 0] *= 1.0 + 0.05 * noise[:, 0]
    v = can.from_physical(v)
    lb, ub, fixed = can.bounds(can.nlp.inst0)
    v = torch.where(fixed, lb, torch.minimum(torch.maximum(v, lb), ub))
    y = torch.as_tensor(0.5 * rng.standard_normal((B, T, 8)))
    return v, y


def _rel(got, want):
    return ((got.double() - want).abs().max() / want.abs().max()).item()


def _compare(so, can, v, y, fld, dtype):
    """The host-built routine's blocks at the points ``v`` (B, n), ``y``
    (B, T, 8), rounded to ``dtype``, against the float64 transforms there
    -> {block: relative max-norm error}: Hn (with the node cost's
    closed-form Hessian added, as the solver adds it), A and d of
    node_blocks, A and d of defect_blocks, each against its block's largest
    entry; under the grid also the rows of Hn and the columns of A in p,
    against their own largest entry."""
    nlp, inst = can.nlp, can.nlp.inst0
    T = nlp.T
    v, y = v.to(dtype).double(), y.to(dtype).double()   # the point in dtype
    Z, dt, _ = can.split(v)
    nlp.all_defects(Z, dt, inst)     # the wind's index tables, untransformed
    node_blocks, _, defect_jac, _ = derivative_blocks(can)
    want = node_blocks(Z, dt, y, inst) + defect_jac(Z, dt, inst)

    sc = can.scaling if can.scaling is not None else unit_scaling(nlp)
    par = nodekern.params(inst.aircraft, sc.d_z, sc.d_dt).to(dtype)
    Zc, dtc = can.split(v.to(dtype))[:2]
    Hn, A, d = _host_blocks(so, Zc, dtc, y.to(dtype), par, fld, True)
    Hn[..., :11, :11] += nlp.node_cost_hess(Z, dt[:, None], inst).to(dtype)
    got = (Hn, A[:, :T], d[:, :T]) + _host_blocks(so, Zc, dtc, None, par, fld,
                                                  False)
    names = ("Hn", "A", "d", "A (jac)", "d (jac)")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
    err = {name: _rel(g, w) for name, g, w in zip(names, got, want)}
    if isinstance(fld, nodekern.GridField):
        err["Hn (p rows)"] = _rel(got[0][..., :3, :], want[0][..., :3, :])
        err["A (p columns)"] = _rel(got[1][..., :3], want[1][..., :3])
    return err


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("scaling", ["auto", None])
@pytest.mark.parametrize("wind", [0, 1, 3])
@pytest.mark.parametrize("mission,aircraft", [("S10", "tempest"),
                                              ("G7", "skywalker")])
def test_node_blocks_match_the_transforms(host_nodekern, mission, aircraft,
                                          wind, scaling, dtype):
    """Both entry points of the host-built kernel routine at 3 lanes x
    (TS+1) nodes against the float64 transforms at the same points, under
    the affine winds and under the demo storm grid at order 2: every block
    to TOL of its largest entry."""
    cfg, fld = _wind(wind)
    can = canonicalize(make_problem(mission, aircraft, ts=TS, wind_model=wind,
                                    wind=cfg, device="cpu"), scaling)
    v, y = _points(can, 3, seed=wind + 2 * (scaling is None))
    for name, err in _compare(host_nodekern, can, v, y, fld, dtype).items():
        assert err < TOL[dtype], (name, err)


def _storm_positions(kind):
    """(P, 3) NED positions (the storm cell's local origin) of one kind
    against the demo grid (origin (17000, 25500, 0) ENU, 150 m spacing,
    8 x 8 x 6 nodes): ``inside`` cells; ``ties``, every axis on a half-cell
    tie, where round goes half to even; ``nodes``, every axis on a grid
    node; ``outside``, one off each of the six faces, the others inside."""
    rng = np.random.default_rng(17)
    n = np.array([8, 8, 6])
    if kind == "inside":
        rel = rng.uniform(0.0, n - 1, size=(6, 3))
    elif kind == "ties":
        rel = np.array([[0.5, 0.5, 0.5], [1.5, 2.5, 3.5], [2.5, 3.5, 1.5],
                        [3.5, 4.5, 2.5], [5.5, 6.5, 4.5], [6.5, 1.5, 0.5]])
    elif kind == "nodes":
        rel = np.array([[0, 0, 0], [1, 2, 3], [3, 4, 2], [5, 6, 4], [7, 7, 5],
                        [2, 1, 1]], dtype=np.float64)
    else:
        rel = rng.uniform(0.5, n - 1.5, size=(6, 3))
        for face in range(6):
            axis = face // 2
            rel[face, axis] = -1.3 if face % 2 == 0 else n[axis] + 0.4
    enu = np.array([17000.0, 25500.0, 0.0]) + 150.0 * rel
    return torch.as_tensor(np.stack([enu[:, 1] - 25800.0, enu[:, 0] - 17400.0,
                                     200.0 - enu[:, 2]], axis=1))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["inside", "ties", "nodes", "outside",
                                  "masked"])
def test_grid_blocks_hold_across_the_stencil(host_nodekern, kind, dtype):
    """The grid specialisation against the float64 transforms where the
    stencil is stressed: positions inside cells, on half-cell ties (the
    spline's second derivatives jump there, so both must round the same
    way), on grid nodes, outside the grid off every face (the clamped
    stencil extrapolates), and inside with the v component masked off by
    ``live``: every block, and the rows and columns in p, to TOL.  S10,
    unscaled, so the positions reach the stencil exactly."""
    cfg = _storm(live=(1.0, 0.0, 1.0) if kind == "masked" else None)
    can = canonicalize(make_problem("S10", "tempest", ts=TS, wind_model=3,
                                    wind=cfg, device="cpu"), None)
    v, y = _points(can, 2, seed=23)
    Z = v[:, 1:1 + (TS + 1) * 11].view(2, TS + 1, 11)
    pos = _storm_positions("inside" if kind == "masked" else kind)
    Z[:, 1:, :3] = pos[torch.arange(2 * TS) % len(pos)].reshape(2, TS, 3)
    for name, err in _compare(host_nodekern, can, v, y,
                              nodekern.grid_field(cfg), dtype).items():
        assert err < TOL[dtype], (name, err)


@pytest.mark.parametrize("mod,mission,aircraft", [(s10, "S10", "tempest"),
                                                  (g7, "G7", "skywalker")])
def test_node_cost_hessians_match_torch_func(mod, mission, aircraft):
    """The missions' closed-form Hessian of the node cost against torch.func
    at 3 x (TS+1) moved nodes; the scaled twin's against torch.func of its
    own node cost."""
    can = canonicalize(make_problem(mission, aircraft, ts=TS, device="cpu"),
                       "auto")
    v, _ = _points(can, 3, seed=5)
    Z, dt, _ = can.split(can.to_physical(v))
    raw, inst = can.nlp_phys, can.nlp_phys.inst0
    z, t = Z.reshape(-1, 11), dt[:, None].expand(3, TS + 1).reshape(-1)
    cost = lambda zz, tt: raw.node_cost(zz, tt, inst)
    want_h = torch.stack([hessian(cost)(zz, tt) for zz, tt in zip(z, t)])
    assert _rel(mod.node_cost_hess(z, t, inst), want_h) < 1e-14
    assert _rel(raw.node_cost_hess(z, t), want_h) < 1e-14
    zs = z / can.scaling.d_z
    scost = lambda zz, tt: can.nlp.node_cost(zz, tt, can.nlp.inst0)
    want_s = torch.stack([hessian(scost)(zz, tt) for zz, tt in zip(zs, t)])
    assert _rel(can.nlp.node_cost_hess(zs, t), want_s) < 1e-13


def _on_card(nlp):
    """``nlp`` as closed_form_blocks sees one whose tensors live on CUDA."""
    fake = SimpleNamespace(device=torch.device("cuda"))
    return dataclasses.replace(nlp, inst0=nlp.inst0._replace(z_lo=fake))


# wind -> its config: models 0-5 as WindConfig(model) gives them, model 3
# on the demo storm grid at order 2; "3-order1" the same grid trilinear,
# "3-gridless" model 3 without a grid
_WINDS = {"3": lambda dt: _storm(dtype=dt),
          "3-order1": lambda dt: _storm(order=1, dtype=dt),
          "3-gridless": lambda dt: _storm(grid=False)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("wind,mode,card,kernel", [
    (0, "exact", True, True), (1, "exact", True, True),
    (2, "exact", True, False), (3, "exact", True, True),
    (4, "exact", True, False), (5, "exact", True, False),
    (0, "reference", True, False), (1, "reference", True, False),
    (0, "exact", False, False), (1, "exact", False, False),
    ("3-order1", "exact", True, False), (3, "reference", True, False),
    ("3-gridless", "exact", True, False), (3, "exact", False, False)])
def test_the_kernel_path_is_chosen_from_the_problem(wind, mode, card, kernel,
                                                    dtype):
    """Wind models 0 and 1, and model 3 on a grid at order 2, with exact
    Jacobians on CUDA tensors take K9, in float32 and float64 alike; models
    2, 4, 5, model 3 at order 1 or without a grid, the frozen-wind
    "reference" mode and CPU tensors take the transforms, raw and scaled
    alike; on the CPU the blocks run (and the transforms give them), but
    without a grid model 3 raises there as it always did."""
    model = 3 if str(wind).startswith("3") else wind
    cfg = _WINDS.get(str(wind), lambda dt: WindConfig(model=wind))(dtype)
    nlp = make_problem("S10", "tempest", ts=TS, wind_model=model, wind=cfg,
                       jacobian_mode=mode, dtype=dtype, device="cpu")
    for n in (nlp, canonicalize(nlp, "auto").nlp):
        assert closed_form_blocks(_on_card(n) if card else n) == kernel
        assert not closed_form_blocks(n)
    assert (nlp.affine_wind_model is not None) == (
        wind in (0, 1) and mode == "exact")
    assert nlp.grid_wind == (wind == 3 and mode == "exact")
    can = canonicalize(nlp, "auto")
    v, y = _points(can, 2, seed=9)
    Z, dt, _ = can.split(v)
    Z, y = Z.to(dtype), y.to(dtype)
    if wind == "3-gridless":
        with pytest.raises(ValueError, match="requires a WindGrid"):
            derivative_blocks(can)[0](Z, dt, y, can.nlp.inst0)
        return
    can.nlp.all_defects(Z, dt)     # the wind's index tables, untransformed
    Hn, A, d = derivative_blocks(can)[0](Z, dt, y, can.nlp.inst0)
    A2, d2 = constraint_jac_blocks(can)[0](Z, dt, can.nlp.inst0)
    assert Hn.shape == (2, TS + 1, 12, 12) and torch.equal(A, A2)
    assert torch.equal(d, d2)


def test_affine_wind_is_the_model_at_two_points():
    """W0 + G p from affine_wind gives the wind models' own value and
    gradient at a moved point; a non-affine model is refused."""
    from tol_tpu_torch.models.wind import wind_with_gradient_ned

    p = torch.tensor([[37.0, -12.0, -45.0]], dtype=torch.float64)
    for model in (0, 1):
        cfg = WindConfig(model=model)
        W0, G = affine_wind(cfg)
        w, g = wind_with_gradient_ned(cfg, p)
        assert np.allclose(W0 + G @ p[0].numpy(), w[0].numpy(), atol=1e-12)
        assert np.array_equal(G, g[0].numpy())
    with pytest.raises(ValueError):
        affine_wind(WindConfig(model=2))


@pytest.mark.parametrize("seed", [0, 1])
def test_node_blocks_hold_for_any_affine_field(host_nodekern, seed):
    """Wind models 0 and 1 leave G G = 0, so the rows of df/dp through the
    wind rate and the Hessian's p-s block stay zero there: here a random
    affine field W0 + G p, random scales and multipliers, against
    torch.func of the scaled defect written from
    models/dynamics.state_derivatives, in float64."""
    from tol_tpu_torch.models.dynamics import state_derivatives

    rng = np.random.default_rng(seed)
    inst = make_problem("S10", "tempest", ts=TS, device="cpu").inst0
    W0, G = rng.normal(size=3), 0.3 * rng.normal(size=(3, 3))
    d_z = torch.as_tensor(rng.uniform(0.5, 3.0, 11))
    d_dt = torch.as_tensor(rng.uniform(0.5, 2.0))
    Wt, Gt = torch.as_tensor(W0), torch.as_tensor(G)
    B = 2
    Z = torch.as_tensor(np.stack([
        np.concatenate([rng.normal(scale=20.0, size=3),
                        [14.0 + rng.normal()], rng.normal(scale=0.2, size=4),
                        rng.normal(scale=0.2, size=2), [3.0 + rng.normal()]])
        for _ in range(B * (TS + 1))]).reshape(B, TS + 1, 11)) / d_z
    dt = torch.as_tensor(rng.uniform(0.05, 0.2, B))
    y = torch.as_tensor(rng.normal(size=(B, TS, 8)))

    def defect(u):
        Zp, DT = d_z * u[:11], d_dt * u[11]
        f = state_derivatives(Zp, Wt + Gt @ Zp[:3], Gt, inst.aircraft)
        return (-Zp[:8] - f * DT) / d_z[:8]

    par = nodekern.params(inst.aircraft, d_z, d_dt)
    Hn, A, d = _host_blocks(host_nodekern, Z, dt, y, par,
                            nodekern.field(W0, G), True)
    for b in range(B):
        for i in range(TS + 1):
            u = torch.cat([Z[b, i], dt[b:b + 1]])
            yi = y[b, min(i, TS - 1)]
            J = torch.func.jacrev(defect)(u)
            if i < TS:
                H = hessian(lambda uu: (yi * defect(uu)).sum())(u)
                assert _rel(Hn[b, i], H) < 1e-12
            else:       # node T: no multipliers, no Hessian
                assert not Hn[b, i].any()
            assert _rel(A[b, i], J[:, :11]) < 1e-12
            assert _rel(d[b, i], J[:, 11]) < 1e-12
    assert Hn[..., :3, 3:8].abs().max() > 0     # the p-s block is there
