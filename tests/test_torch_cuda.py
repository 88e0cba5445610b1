"""The CUDA kernels K1-K3, K5-K8 on the card, against their plain PyTorch
twins.

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
    solve pass.  Every kernel is launched (K5 by crp_factor)."""
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
    blk = torch.zeros(4, 2, 11, 11, device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        ck.crp_factor_pass(blk, blk)
    with pytest.raises(TypeError, match="float32"):
        ck.crp_fwd_pass([(z, z, z)], z[:, :, :2],
                        torch.zeros(2, 2, 11, 1, device=cuda_device,
                                    dtype=torch.float64))


@pytest.mark.cuda
def test_cuda_fwd_pass_refuses_a_non_contiguous_rhs(cuda_device):
    z = lambda *s: torch.zeros(*s, device=cuda_device)
    f = z(2, 2, 11, 3)[..., :1]
    before = ck.crp_fwd_pass.launches
    with pytest.raises(ValueError, match="contiguous"):
        ck.crp_fwd_pass([(z(11, 11, 2),) * 3], z(11, 11, 2), f)
    assert ck.crp_fwd_pass.launches == before


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


def _flagship_chains(rng, m):
    """B=128 chains of T=100 blocks padded to 128 (7 CR levels), on the CPU."""
    M, O, F = _chains(rng, 128, 100, 11, m)
    M, O, n_pad = ck._pad_chain(M, O)
    return M, O, ck.crp_pad_rhs(F, n_pad)


def _flat(levels, stack, *rest):
    return [t for lv in levels for t in lv] + list(stack) + list(rest)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [12, 14])
def test_cuda_factor_pass_matches_twin(cuda_device, m):
    """K1, one launch for all 7 levels, against factor_fwd_pass_plain."""
    M, O, F = _flagship_chains(np.random.default_rng(13), m)
    want = _flat(*ck.factor_fwd_pass_plain(ck._to_slab(M), ck._to_slab(O),
                                           ck._to_slab(F), 128))
    got = _flat(*ck.crp_factor_fwd_pass(*[t.to(cuda_device) for t in (M, O, F)]))
    assert len(got) == len(want) == 4 * 7 + 2
    assert max(_rel(g, w) for g, w in zip(got, want)) < TOL_REL


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 12, 14])
def test_cuda_bwd_pass_matches_twin(cuda_device, m):
    """K3, one launch for all 7 levels, on a factor made by the twin."""
    rng = np.random.default_rng(14)
    M, O, F = _flagship_chains(rng, 12)
    levels, _, _, _ = ck.factor_fwd_pass_plain(ck._to_slab(M), ck._to_slab(O),
                                               ck._to_slab(F), 128)
    stack = [torch.as_tensor(rng.normal(size=(11, m, lv[0].shape[2])),
                             dtype=torch.float32) for lv in levels]
    x = torch.as_tensor(rng.normal(size=(11, m, 128)), dtype=torch.float32)
    want = ck._from_slab(ck.bwd_pass_plain(levels, stack, x, 128), 128)
    dev = lambda ts: [t.to(cuda_device) for t in ts]
    got = ck.crp_bwd_pass([tuple(dev(lv)) for lv in levels], dev(stack),
                          x.to(cuda_device))
    assert got.shape == (128, 128, 11, m)
    assert _rel(got, want) < TOL_REL


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 12])
def test_cuda_fwd_pass_matches_twin(cuda_device, m):
    """K2, one launch for all 7 levels and the root step, on a factor made
    by the twin; lane 1's factor is NaN from level 1 on and must come out
    NaN alone, from level 2's saved rhs on."""
    rng = np.random.default_rng(20)
    M, O, F = _flagship_chains(rng, 12)
    levels, _, root_inv, _ = ck.factor_fwd_pass_plain(
        ck._to_slab(M), ck._to_slab(O), ck._to_slab(F), 128)
    f = torch.as_tensor(rng.normal(size=(128, 128, 11, m)), dtype=torch.float32)
    want = _flat([], *ck.fwd_pass_plain(levels, root_inv, ck._to_slab(f), 128))
    dev = lambda ts: [t.to(cuda_device) for t in ts]
    got = _flat([], *ck.crp_fwd_pass([tuple(dev(lv)) for lv in levels],
                                     root_inv.to(cuda_device),
                                     f.to(cuda_device)))
    assert len(got) == len(want) == 7 + 1
    assert max(_rel(g, w) for g, w in zip(got, want)) < TOL_REL
    for Minv, _, _ in levels[1:]:
        Minv.view(11, 11, -1, 128)[:, :, :, 1] = float("nan")
    root_inv[:, :, 1] = float("nan")
    got = _flat([], *ck.crp_fwd_pass([tuple(dev(lv)) for lv in levels],
                                     root_inv.to(cuda_device),
                                     f.to(cuda_device)))
    lane1 = [i == 1 for i in range(128)]
    assert torch.isnan(got[0]).reshape(-1, 128).any(0).tolist() == [False] * 128
    for t in got[2:]:
        assert torch.isnan(t).reshape(-1, 128).any(0).tolist() == lane1


@pytest.mark.cuda
def test_cuda_passes_keep_an_indefinite_pivot_in_its_lane(cuda_device):
    M, O, F = _flagship_chains(np.random.default_rng(15), 12)
    M[1, 5] = -torch.eye(11)
    levels, stack, root_inv, x = ck.crp_factor_fwd_pass(
        *[t.to(cuda_device) for t in (M, O, F)])
    X = ck.crp_bwd_pass(levels, stack, x)
    x2 = ck.crp_solve(levels, root_inv, F[..., :1].contiguous().to(cuda_device))
    lane1 = [i == 1 for i in range(128)]
    for t in _flat(levels, stack):
        assert torch.isnan(t).reshape(-1, 128).any(0).tolist() in (
            lane1, [False] * 128)
    for t in (root_inv, x):
        assert torch.isnan(t).reshape(-1, 128).any(0).tolist() == lane1
    for t in (X, x2):
        assert torch.isnan(t).flatten(1).any(1).tolist() == lane1


@pytest.mark.cuda
def test_cuda_solves_launch_each_pass_kernel_once(cuda_device):
    """crp_factor_solve: one K1, one K3; crp_solve: one K2, one K3;
    crp_factor: one K5."""
    M, O, F = _flagship_chains(np.random.default_rng(16), 12)
    ck.reset_launch_counts()
    levels, root, _ = ck.crp_factor_solve(
        *[t.to(cuda_device) for t in (M[:, :100], O[:, :100], F[:, :100])])
    counts = lambda: {k.__name__: k.launches for k in ck.KERNELS}
    assert counts() == dict(crp_factor_fwd_pass=1, crp_fwd_pass=0,
                            crp_bwd_pass=1, crp_factor_pass=0)
    ck.crp_solve(levels, root, F[..., :1].to(cuda_device))
    assert counts() == dict(crp_factor_fwd_pass=1, crp_fwd_pass=1,
                            crp_bwd_pass=2, crp_factor_pass=0)
    ck.crp_factor(*[t.to(cuda_device) for t in (M[:, :100], O[:, :100])])
    assert counts() == dict(crp_factor_fwd_pass=1, crp_fwd_pass=1,
                            crp_bwd_pass=2, crp_factor_pass=1)


def _nan_lanes(t, B):
    """Lanes (the trailing axis) that hold a NaN."""
    return torch.isnan(t).reshape(-1, B).any(0).tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("G,threads", [(1, 64), (2, 128), (4, 256), (8, 256)])
@pytest.mark.parametrize("B", [1, 37, 128])
def test_cuda_chain_passes_hold_for_any_lane_group(cuda_device, G, threads, B):
    """K6 and K8 at every lane group size G, with partial groups (B = 37
    fills no group of 2, 4 or 8 evenly; B = 1 leaves one lane); lane B - 1
    (of two or more) is indefinite at block 2 and must come out NaN alone,
    from that block on and in S.  K8 at border widths 13 and 15."""
    rng = np.random.default_rng(21)
    T = 100
    for nC in (12, 14):
        M, O, R = (ch._lanes_last(t) for t in _chains(rng, B, T, 11, nC))
        if B > 1:
            M[2, :, :, B - 1] = -torch.eye(11)
        want = ch.factor_eliminate_plain(M, O, R)
        got = ch._factor_eliminate_batched(
            *[t.to(cuda_device) for t in (M, O, R)], group=G, threads=threads)
        lanes = [B > 1 and b == B - 1 for b in range(B)]
        for g, w in zip(got, want):
            g = g.cpu()
            assert torch.equal(torch.isnan(g), torch.isnan(w))
            assert _nan_lanes(g, B) == lanes
            ok = ~torch.isnan(w)
            assert ((g[ok] - w[ok]).abs().max() / w[ok].abs().max()).item() < TOL_REL
        assert not torch.isnan(got[0][:2]).any()
        _, t2, tRw, _ = want
        tR = torch.cat([tRw, torch.as_tensor(rng.normal(size=(T, 11, 1, B)),
                                             dtype=torch.float32)], dim=2)
        coef = torch.as_tensor(rng.normal(size=(nC + 1, 1, B)), dtype=torch.float32)
        want = ch.back_substitute_plain(tR.contiguous(), t2, coef)
        got = ch._back_substitute_batched(
            *[t.contiguous().to(cuda_device) for t in (tR, t2, coef)],
            group=min(G, 4), threads=threads).cpu()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert _nan_lanes(got, B) == lanes
        ok = ~torch.isnan(want)
        assert ((got[ok] - want[ok]).abs().max() / want[ok].abs().max()).item() < TOL_REL


@pytest.mark.cuda
def test_cuda_chain_passes_give_the_same_bits_at_every_lane_group(cuda_device):
    """Each output entry has one expression whatever the launch shape, so
    K6 and K8 give the same bits at every lane group size and thread count."""
    rng = np.random.default_rng(22)
    M, O, R = (ch._lanes_last(t).to(cuda_device)
               for t in _chains(rng, 128, 100, 11, 14))
    ref = ch._factor_eliminate_batched(M, O, R)
    coef = torch.as_tensor(rng.normal(size=(15, 1, 128)), dtype=torch.float32,
                           device=cuda_device)
    tR = torch.cat([ref[2], ref[2][:, :, :1]], dim=2).contiguous()
    xref = ch._back_substitute_batched(tR, ref[1], coef)
    for G, threads in [(1, 64), (1, 256), (2, 128), (4, 256), (8, 256)]:
        got = ch._factor_eliminate_batched(M, O, R, group=G, threads=threads)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
        if G <= 4:
            x = ch._back_substitute_batched(tR, ref[1], coef, group=G,
                                            threads=threads)
            assert torch.equal(x, xref)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 37, 128])
def test_cuda_rhs_forward_gives_the_same_bits_at_every_lane_group(cuda_device,
                                                                 B):
    """K7 at every lane group size G and thread count, with partial groups
    (B = 37 fills no group of 2, 4 or 8 evenly; B = 1 leaves one lane), at
    border widths 12 and 14: the same bits at every shape, the twin's values
    within TOL_REL, and lane B - 1 (of two or more), NaN from block 2 on in
    its factor, NaN alone."""
    rng = np.random.default_rng(23)
    T = 100
    for nB in (12, 14):
        M, O, R = (ch._lanes_last(t) for t in _chains(rng, B, T, 11, nB))
        Dinv, _, tRw, _ = ch.factor_eliminate_plain(M, O, R)
        if B > 1:
            Dinv[2:, :, :, B - 1] = float("nan")
        r = torch.as_tensor(rng.normal(size=(T, 11, 1, B)), dtype=torch.float32)
        want = ch.rhs_forward_plain(Dinv, O, tRw, r)
        args = [t.to(cuda_device) for t in (Dinv, O, tRw, r)]
        ref = ch._rhs_forward_batched(*args)
        lanes = [B > 1 and b == B - 1 for b in range(B)]
        for g, w in zip(ref, want):
            g = g.cpu()
            assert torch.equal(torch.isnan(g), torch.isnan(w))
            assert _nan_lanes(g, B) == lanes
            ok = ~torch.isnan(w)
            assert ((g[ok] - w[ok]).abs().max() / w[ok].abs().max()).item() < TOL_REL
        for G, threads in [(1, 64), (1, 512), (2, 128), (4, 128), (4, 256),
                           (8, 512)]:
            got = ch._rhs_forward_batched(*args, group=G, threads=threads)
            assert all(torch.equal(g.view(torch.int32), r_.view(torch.int32))
                       for g, r_ in zip(got, ref))


@pytest.mark.cuda
def test_cuda_chain_kernels_refuse_a_bad_launch_shape(cuda_device):
    z = lambda *s: torch.zeros(*s, device=cuda_device)
    M = z(4, 11, 11, 8) + torch.eye(11, device=cuda_device)[None, :, :, None]
    before = ch._factor_eliminate_batched.launches
    with pytest.raises(RuntimeError, match="invalid argument"):
        ch._factor_eliminate_batched(M, z(4, 11, 11, 8), z(4, 11, 12, 8),
                                     group=3, threads=256)
    with pytest.raises(RuntimeError, match="invalid argument"):
        ch._factor_eliminate_batched(M, z(4, 11, 11, 8), z(4, 11, 12, 8),
                                     group=8, threads=96)
    with pytest.raises(RuntimeError, match="invalid argument"):
        ch._back_substitute_batched(z(4, 11, 13, 8), z(4, 11, 11, 8),
                                    z(13, 1, 8), group=8, threads=96)
    with pytest.raises(RuntimeError, match="invalid argument"):
        ch._rhs_forward_batched(M, z(4, 11, 11, 8), z(4, 11, 12, 8),
                                z(4, 11, 1, 8), group=4, threads=64)
    assert ch._factor_eliminate_batched.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("mission,aircraft", [("S10", "tempest"),
                                              ("G7", "skywalker")])
def test_cuda_node_blocks_match_the_transforms(cuda_device, mission, aircraft):
    """K9 at the flagship's width (128 lanes of ts=100, wind model 1,
    scaled) against the float64 transforms at the same points on the card:
    Hn, A, d of one node_blocks launch and A, d of one defect_blocks launch,
    in float32 to 1e-5 of each block's largest entry (float32 rounding of a
    few thousand operations), in float64 to 1e-12; mixed dtypes and CPU
    operands are refused."""
    import dataclasses

    from tol_tpu_torch.api import make_problem
    from tol_tpu_torch.ops import nodekern
    from tol_tpu_torch.solver.canonical import (Scaling, canonicalize,
                                                closed_form_blocks,
                                                kernel_args)
    from tol_tpu_torch.solver.kkt_condensed import derivative_blocks

    nlp = lambda dt: make_problem(mission, aircraft, ts=100, wind_model=1,
                                  dtype=dt, device=cuda_device)
    c32 = canonicalize(nlp(torch.float32), "auto")
    c64 = canonicalize(nlp(torch.float64),
                       Scaling(*[t.double() for t in c32.scaling]))
    assert closed_form_blocks(c32.nlp) and closed_form_blocks(c64.nlp)
    transforms = dataclasses.replace(c64, nlp=dataclasses.replace(
        c64.nlp, affine_wind_model=None))
    assert not closed_form_blocks(transforms.nlp)

    rng = np.random.default_rng(11)
    B, T = 128, 100
    lb, ub, fixed = c32.bounds(c32.nlp.inst0)
    v = c32.initial_point()[None] + torch.as_tensor(
        0.1 * rng.standard_normal((B, c32.n)), dtype=torch.float32,
        device=cuda_device)
    v = torch.where(fixed, lb, torch.minimum(torch.maximum(v, lb), ub))
    y = torch.as_tensor(rng.standard_normal((B, T, 8)), dtype=torch.float32,
                        device=cuda_device)
    Zw, dtw, _ = c64.split(v.double())
    nb, _, dj, _ = derivative_blocks(transforms)
    want = nb(Zw, dtw, y.double(), transforms.nlp.inst0) + dj(
        Zw, dtw, transforms.nlp.inst0)
    for can, tol in ((c32, 1e-5), (c64, 1e-12)):
        Z, dt, _ = can.split(v.to(can.nlp.inst0.z_lo.dtype))
        n0, j0 = nodekern.node_blocks.launches, nodekern.defect_blocks.launches
        nb, _, dj, _ = derivative_blocks(can)
        got = nb(Z, dt, y.to(Z.dtype), can.nlp.inst0) + dj(Z, dt,
                                                           can.nlp.inst0)
        torch.cuda.synchronize()
        assert (nodekern.node_blocks.launches,
                nodekern.defect_blocks.launches) == (n0 + 1, j0 + 1)
        for name, g, w in zip(("Hn", "A", "d", "A (jac)", "d (jac)"), got,
                              want):
            assert g.dtype == Z.dtype and g.shape == w.shape, name
            rel = ((g.double() - w).abs().max() / w.abs().max()).item()
            assert rel < tol, (name, Z.dtype, rel)
    Z, dt, _ = c32.split(v)
    par, fld = kernel_args(c32)(c32.nlp.inst0)
    with pytest.raises(TypeError):
        nodekern.defect_blocks(Z.double(), dt.double(), par, fld)
    with pytest.raises(ValueError):
        nodekern.defect_blocks(Z.cpu(), dt.cpu(), par.cpu(), fld)


def _storm_wind(dtype, device, **grid_args):
    """Wind model 3 on the demo storm grid at order 2 (origin and spacing
    in ``dtype``), the storm cell's local origin."""
    from tol_tpu_torch.io.storm import make_demo_storm_grid
    from tol_tpu_torch.models.wind import WindConfig

    return WindConfig(model=3, order=2, east0=17400.0, north0=25800.0,
                      up0=200.0, grid=make_demo_storm_grid(
                          dtype=dtype, device=device, **grid_args))


@pytest.mark.cuda
def test_cuda_grid_node_blocks_match_the_transforms(cuda_device):
    """K9's grid specialisation at the storm cell's width (S10 / tempest on
    the demo storm grid at order 2, scaled, 128 lanes of ts=100) against
    the float64 transforms at the same points on the card: Hn, A, d of one
    node_blocks launch and A, d of one defect_blocks launch, float32 and
    float64, each within 1e-4 of its block's largest entry (float32's
    rounding of the stencil sums and jets; float64 to 1e-12).  Then both
    launches captured in one CUDA graph: the grid refilled in place (other
    samples, the origin moved), the replay's blocks follow the new field,
    as the transforms give them there."""
    import dataclasses

    from tol_tpu_torch.api import make_problem
    from tol_tpu_torch.io.storm import make_demo_storm_grid
    from tol_tpu_torch.ops import nodekern
    from tol_tpu_torch.solver.canonical import (Scaling, canonicalize,
                                                closed_form_blocks)
    from tol_tpu_torch.solver.kkt_condensed import derivative_blocks

    nlp = lambda dt: make_problem("S10", "tempest", ts=100, wind_model=3,
                                  wind=_storm_wind(dt, cuda_device), dtype=dt,
                                  device=cuda_device)
    c32 = canonicalize(nlp(torch.float32), "auto")
    c64 = canonicalize(nlp(torch.float64),
                       Scaling(*[t.double() for t in c32.scaling]))
    assert closed_form_blocks(c32.nlp) and closed_form_blocks(c64.nlp)
    transforms = dataclasses.replace(c64, nlp=dataclasses.replace(
        c64.nlp, grid_wind=False))
    assert not closed_form_blocks(transforms.nlp)

    rng = np.random.default_rng(12)
    B, T = 128, 100
    lb, ub, fixed = c32.bounds(c32.nlp.inst0)
    v = c32.initial_point()[None] + torch.as_tensor(
        0.1 * rng.standard_normal((B, c32.n)), dtype=torch.float32,
        device=cuda_device)
    v = torch.where(fixed, lb, torch.minimum(torch.maximum(v, lb), ub))
    y = torch.as_tensor(rng.standard_normal((B, T, 8)), dtype=torch.float32,
                        device=cuda_device)
    Zw, dtw, _ = c64.split(v.double())
    inst_t = transforms.nlp.inst0
    transforms.nlp.all_defects(Zw, dtw, inst_t)   # index tables, untransformed
    nb_t, _, dj_t, _ = derivative_blocks(transforms)

    def want():
        return nb_t(Zw, dtw, y.double(), inst_t) + dj_t(Zw, dtw, inst_t)

    def rel(got, ref):
        return [((g.double() - w).abs().max() / w.abs().max()).item()
                for g, w in zip(got, ref)]

    ref = want()
    for can, tol in ((c32, 1e-4), (c64, 1e-12)):
        Z, dt, _ = can.split(v.to(can.nlp.inst0.z_lo.dtype))
        n0, j0 = nodekern.node_blocks.launches, nodekern.defect_blocks.launches
        nb, _, dj, _ = derivative_blocks(can)
        got = nb(Z, dt, y.to(Z.dtype), can.nlp.inst0) + dj(Z, dt,
                                                           can.nlp.inst0)
        torch.cuda.synchronize()
        assert (nodekern.node_blocks.launches,
                nodekern.defect_blocks.launches) == (n0 + 1, j0 + 1)
        assert all(g.dtype == Z.dtype and g.shape == w.shape
                   for g, w in zip(got, ref))
        assert max(rel(got, ref)) < tol, (Z.dtype, rel(got, ref))

    # captured: both launches in one graph, then the grid refilled in place
    Z, dt, _ = c32.split(v)
    Z = Z.contiguous()
    inst = c32.nlp.inst0
    nb, _, dj, _ = derivative_blocks(c32)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        nb(Z, dt, y, inst)
        dj(Z, dt, inst)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = nb(Z, dt, y, inst) + dj(Z, dt, inst)
    graph.replay()
    torch.cuda.synchronize()
    before = [t.clone() for t in out]
    assert max(rel(before, ref)) < 1e-4
    moved = dict(origin=(17040.0, 25470.0, 10.0), vortex_v=4.0,
                 thermal_w=-1.5)
    for grid, dtype in ((inst.wind.grid, torch.float32),
                        (inst_t.wind.grid, torch.float64)):
        new = make_demo_storm_grid(dtype=dtype, device=cuda_device, **moved)
        for old, fresh in zip(grid, new):
            old.copy_(fresh)
    graph.replay()
    torch.cuda.synchronize()
    ref = want()
    assert max(rel(out, ref)) < 1e-4, rel(out, ref)
    assert max(rel(before, ref)) > 1e-2     # the field did move


@pytest.mark.cuda
@pytest.mark.parametrize("chain", ["cr", "structured"])
def test_cuda_float64_solve_takes_the_kernel(cuda_device, chain):
    """float64 S10 at ts=8, wind model 1, scaled, 2 lanes on the card: up
    to 40 steps of the endgame (refine=1, dual_refine_k=4) through the
    condensed KKT on chain cr, or through the structured KKT, launch K9's
    double entry points every step (node_blocks, and defect_blocks in the
    refinement) and end where the same steps by the transforms end: the
    same steps and flags, v and the duals to 1e-7 of their largest entry
    (the blocks agree to a few ulps; 40 Newton steps and the refinement's
    CG carry that to about 4e-9 in the duals)."""
    import dataclasses

    from tol_tpu_torch.api import make_problem
    from tol_tpu_torch.ops import nodekern
    from tol_tpu_torch.solver import alm
    from tol_tpu_torch.solver.canonical import canonicalize
    from tol_tpu_torch.solver.kkt_condensed import make_condensed_kkt
    from tol_tpu_torch.solver.kkt_structured import make_structured_kkt

    can = canonicalize(make_problem("S10", "tempest", ts=8, wind_model=1,
                                    dtype=torch.float64, device=cuda_device),
                       "auto")
    transforms = dataclasses.replace(can, nlp=dataclasses.replace(
        can.nlp, affine_wind_model=None))
    lb, ub, fixed = can.bounds(can.nlp.inst0)
    v0 = can.initial_point()[None] + torch.as_tensor(
        0.01 * np.random.default_rng(3).standard_normal((2, can.n)),
        dtype=torch.float64, device=cuda_device)
    v0 = torch.where(fixed, lb, torch.minimum(torch.maximum(v0, lb), ub))
    steps = 40
    opts = alm.ALMOptions(max_iter=steps, dual_refine_k=4, max_ls=8,
                          tol=1e-12, mu_init=6e-5, prox=2.5e-3)

    def run(c):
        kkt = (make_structured_kkt(c) if chain == "structured"
               else make_condensed_kkt(c, refine=1, chain="cr"))
        return alm.solve(c, kkt, opts, v0=v0, _loop="eager",
                         keep_state=True).state

    n0, j0 = nodekern.node_blocks.launches, nodekern.defect_blocks.launches
    got = run(can)
    ran = int(got.it.max())
    assert ran > 0
    assert nodekern.node_blocks.launches - n0 >= ran
    assert nodekern.defect_blocks.launches - j0 >= ran
    n0, j0 = nodekern.node_blocks.launches, nodekern.defect_blocks.launches
    want = run(transforms)
    assert (nodekern.node_blocks.launches,
            nodekern.defect_blocks.launches) == (n0, j0)
    assert torch.equal(got.it, want.it)
    assert torch.equal(got.converged, want.converged)
    for k in ("v", "yhat", "y_ls"):
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == torch.float64
        rel = (g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
        assert rel < 1e-7, (k, rel)
