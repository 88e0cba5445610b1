"""The closed-form collocation node blocks (``ops/nodekern.py``, kernel K9).

The kernel's per-node arithmetic (``csrc/nodekern_block.cuh``, the same
``nk::node_at`` the CUDA kernel runs for each node) is built for the host
with g++ and held, in float64 and in float32, to the ``torch.func``
transforms that take the same blocks on the CPU (``solver/kkt_condensed.py``
``derivative_blocks``, ``solver/canonical.py`` ``constraint_jac_blocks``);
the missions' closed-form node-cost Hessians to ``torch.func``; and the
solver's choice between kernel and transforms to what the problem shows.
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
template <typename T>
static void run(const T* Z, long ldz, const T* dt, long lddt, const T* Y,
                long ldy, const T* par, const double* field, long B, int npl,
                int Tn, int hess, T* Hn, T* A, T* d) {
  const nk::Field<T> F = nk::make_field<T>(field);
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
  run<double>(Z, ldz, dt, lddt, Y, ldy, par, field, B, npl, Tn, hess, Hn, A,
              d);
}
void f_blocks(const float* Z, long ldz, const float* dt, long lddt,
              const float* Y, long ldy, const float* par, const double* field,
              long B, int npl, int Tn, int hess, float* Hn, float* A,
              float* d) {
  run<float>(Z, ldz, dt, lddt, Y, ldy, par, field, B, npl, Tn, hess, Hn, A,
             d);
}
}
"""


@pytest.fixture(scope="module")
def host_nodekern(tmp_path_factory):
    """``nk::node_at`` over every node, built with g++ (float64 ``h_``,
    float32 ``f_``)."""
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
    return so


def _host_blocks(so, Z, dt, y, par, fld, hess):
    """The host build over Z (B, T+1, 11) as the kernel's wrappers take it:
    with ``hess`` every node's (Hn, A, d) (nodekern.node_blocks), else A, d
    of nodes 0..T-1 (nodekern.defect_blocks)."""
    B, T = Z.shape[0], Z.shape[1] - 1
    npl = T + 1 if hess else T
    new = lambda *s: torch.zeros(B, npl, *s, dtype=Z.dtype)
    Hn, A, d = new(12, 12), new(8, 11), new(8)
    fn = so.h_blocks if Z.dtype == torch.float64 else so.f_blocks
    Y = y if hess else Z
    fn(Z.data_ptr(), Z.stride(0), dt.data_ptr(), dt.stride(0), Y.data_ptr(),
       Y.stride(0), par.data_ptr(), fld, B, npl, T, int(hess), Hn.data_ptr(),
       A.data_ptr(), d.data_ptr())
    return (Hn, A, d) if hess else (A, d)


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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("scaling", ["auto", None])
@pytest.mark.parametrize("wind", [0, 1])
@pytest.mark.parametrize("mission,aircraft", [("S10", "tempest"),
                                              ("G7", "skywalker")])
def test_node_blocks_match_the_transforms(host_nodekern, mission, aircraft,
                                          wind, scaling, dtype):
    """Both entry points of the host-built kernel routine at 3 lanes x
    (TS+1) nodes against the float64 transforms at the same points: Hn
    (with the node cost's closed-form Hessian added, as the solver adds
    it), A and d of node_blocks, A and d of defect_blocks; each to TOL of
    its block's largest entry."""
    can = canonicalize(make_problem(mission, aircraft, ts=TS, wind_model=wind,
                                    device="cpu"), scaling)
    nlp, inst = can.nlp, can.nlp.inst0
    v, y = _points(can, 3, seed=wind + 2 * (scaling is None))
    v, y = v.to(dtype).double(), y.to(dtype).double()   # the point in dtype
    Z, dt, _ = can.split(v)
    node_blocks, _, defect_jac, _ = derivative_blocks(can)
    want = node_blocks(Z, dt, y, inst) + defect_jac(Z, dt, inst)

    sc = can.scaling if scaling else unit_scaling(nlp)
    par = nodekern.params(inst.aircraft, sc.d_z, sc.d_dt).to(dtype)
    fld = nodekern.field(*affine_wind(dataclasses.replace(inst.wind,
                                                          model=wind)))
    Zc, dtc = can.split(v.to(dtype))[:2]
    Hn, A, d = _host_blocks(host_nodekern, Zc, dtc, y.to(dtype), par, fld, True)
    Hn[..., :11, :11] += nlp.node_cost_hess(Z, dt[:, None], inst).to(dtype)
    got = (Hn, A[:, :TS], d[:, :TS]) + _host_blocks(host_nodekern, Zc, dtc,
                                                    None, par, fld, False)
    for name, g, w in zip(("Hn", "A", "d", "A (jac)", "d (jac)"), got, want):
        assert g.shape == w.shape, name
        assert _rel(g, w) < TOL[dtype], (name, _rel(g, w))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("wind,mode,card,kernel", [
    (0, "exact", True, True), (1, "exact", True, True),
    (2, "exact", True, False), (3, "exact", True, False),
    (4, "exact", True, False), (5, "exact", True, False),
    (0, "reference", True, False), (1, "reference", True, False),
    (0, "exact", False, False), (1, "exact", False, False)])
def test_the_kernel_path_is_chosen_from_the_problem(wind, mode, card, kernel,
                                                    dtype):
    """Wind models 0 and 1 with exact Jacobians on CUDA tensors take K9, in
    float32 and float64 alike; models 2-5, the frozen-wind "reference" mode
    and CPU tensors take the transforms, raw and scaled alike; on the CPU
    the blocks run (and the transforms give them)."""
    cfg = WindConfig(model=wind)
    nlp = make_problem("S10", "tempest", ts=TS, wind_model=wind, wind=cfg,
                       jacobian_mode=mode, dtype=dtype, device="cpu")
    for n in (nlp, canonicalize(nlp, "auto").nlp):
        assert closed_form_blocks(_on_card(n) if card else n) == kernel
        assert not closed_form_blocks(n)
    assert (nlp.affine_wind_model is not None) == (
        wind in (0, 1) and mode == "exact")
    if wind != 3:   # model 3 needs a grid to evaluate
        can = canonicalize(nlp, "auto")
        v, y = _points(can, 2, seed=9)
        Z, dt, _ = can.split(v)
        Z, y = Z.to(dtype), y.to(dtype)
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
