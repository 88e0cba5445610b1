"""The CUDA kernels K1-K8 on the card, against their plain PyTorch twins.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed.  Without a CUDA device every test skips.  On a
GPU machine without JAX, skip the repository's conftest (it imports JAX)
and the xdist options of pytest.ini:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -o addopts="" -q
"""

import numpy as np
import pytest
import torch

from tol_tpu_torch.ops import chainkern as ch
from tol_tpu_torch.ops import crkern as ck

# float32 kernel against the float32 twin: the same arithmetic in the same
# order up to nvcc's FMA contraction, so relative max-norm error ~1e-6.
TOL_REL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _chains(rng, B, N, b, m):
    """B diagonally dominant SPD block-tridiagonal chains + rhs, float32."""
    A = rng.normal(size=(B, N, b, b))
    M = A @ np.swapaxes(A, -1, -2) + b * np.eye(b)
    O = 0.3 * rng.normal(size=(B, N, b, b))
    O[:, -1] = 0.0
    F = rng.normal(size=(B, N, b, m))
    return [torch.as_tensor(x, dtype=torch.float32) for x in (M, O, F)]


def _rel(got, want):
    return ((got.cpu() - want).abs().max() / want.abs().max()).item()


@pytest.mark.cuda
def test_cuda_kernels_match_twins_on_card(cuda_device):
    """The flagship shapes: B=128 chains of T=100 11x11 blocks (7 CR
    levels), 12 border columns in the factor pass, one rhs column in the
    solve pass.  Every kernel is launched."""
    rng = np.random.default_rng(8)
    M, O, F = _chains(rng, 128, 100, 11, 12)
    ck.reset_launch_counts()
    lv, ri, X = ck.crp_factor_solve(*[t.to(cuda_device) for t in (M, O, F)])
    lv0, ri0, X0 = ck.crp_factor_solve(M, O, F)
    assert _rel(X, X0) < TOL_REL
    f = torch.as_tensor(rng.normal(size=(128, 128, 11, 1)), dtype=torch.float32)
    assert _rel(ck.crp_solve(lv, ri, f.to(cuda_device)),
                ck.crp_solve(lv0, ri0, f)) < TOL_REL
    lvf, rif = ck.crp_factor(M.to(cuda_device), O.to(cuda_device))
    assert _rel(ck.crp_solve(lvf, rif, f.to(cuda_device)),
                ck.crp_solve(lv0, ri0, f)) < TOL_REL
    assert all(k.launches > 0 for k in ck.KERNELS)


@pytest.mark.cuda
def test_cuda_indefinite_pivot_is_nan_in_that_lane_only(cuda_device):
    rng = np.random.default_rng(9)
    M, O, F = _chains(rng, 3, 12, 11, 2)
    M[1, 5] = -torch.eye(11)
    lv, ri, X = ck.crp_factor_solve(*[t.to(cuda_device) for t in (M, O, F)])
    x2 = ck.crp_solve(lv, ri, ck.crp_pad_rhs(F[..., :1].to(cuda_device), 16))
    for out in (X, x2):
        assert torch.isnan(out).flatten(1).any(1).tolist() == [False, True, False]


@pytest.mark.cuda
def test_cuda_wrappers_refuse_float64(cuda_device):
    z = torch.zeros(11, 11, 4, device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        ck.crp_root(z, torch.zeros(11, 1, 4, device=cuda_device,
                                   dtype=torch.float64), True)


@pytest.mark.cuda
@pytest.mark.parametrize("nC,B", [(12, 128), (14, 128), (14, 37)])
def test_cuda_chain_kernels_match_twins_on_card(cuda_device, nC, B):
    """K6-K8 at the solve's shapes (T=100, border widths 12 and 14), and at
    a lane count that fills no warp evenly; lane 1 has an indefinite pivot
    at block 2 and must come out NaN from there on, alone."""
    rng = np.random.default_rng(10)
    T = 100
    M, O, R = _chains(rng, B, T, 11, nC)
    M[1, 2] = -torch.eye(11)
    r = torch.as_tensor(rng.normal(size=(B, T, 11)), dtype=torch.float32)
    coef = torch.as_tensor(rng.normal(size=(B, nC + 1)), dtype=torch.float32)
    ch.reset_launch_counts()
    dev = lambda *xs: [x.to(cuda_device) for x in xs]

    def run(M, O, R, r, coef):
        Dinv, t2, tRw, S = ch.chain_eliminate(M, O, R)
        tr, sb = ch.chain_rhs_forward(Dinv, O, tRw, r)
        x = ch.chain_back_sub(torch.cat([tRw, tr[..., None]], dim=3), t2, coef)
        return Dinv, t2, tRw, S, tr, sb, x

    got = run(*dev(M, O, R, r, coef))
    want = run(M, O, R, r, coef)
    torch.cuda.synchronize()
    assert [k.launches for k in ch.KERNELS] == [1, 1, 1]
    for g, w in zip(got, want):
        g = g.cpu()
        nan = torch.isnan(w)
        assert torch.equal(torch.isnan(g), nan)
        assert nan.flatten(1).any(1).tolist() == [i == 1 for i in range(B)]
        ok = ~nan
        assert ((g[ok] - w[ok]).abs().max() / w[ok].abs().max()).item() < TOL_REL
    assert not torch.isnan(got[0][1, :2]).any()      # blocks before the pivot


@pytest.mark.cuda
def test_cuda_chain_wrappers_refuse_float64(cuda_device):
    z = lambda *s: torch.zeros(*s, device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        ch.chain_eliminate(z(2, 4, 11, 11), z(2, 4, 11, 11), z(2, 4, 11, 12))
    with pytest.raises(TypeError, match="float32"):
        ch.chain_back_sub(z(2, 4, 11, 13), z(2, 4, 11, 11), z(2, 13))
