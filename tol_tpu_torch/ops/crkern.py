"""Cyclic reduction over a batch-last slab layout, with hand-written CUDA
level kernels (port of ``tol_tpu/ops/crkern.py``).

The chain ``O_{i-1}^T x_{i-1} + M_i x_i + O_i x_{i+1} = f_i`` (11x11 SPD
blocks) is reduced level by level in the even/odd order of
``tol_tpu/ops/blocktri.py``.  That order is a numerical property, not a
speed choice: sequential orders lose the flat-valley components of the
Newton direction to the float32 noise floor and fail the S10 cost gate.

Each level's blocks sit in a slab ``(a, b, p*B)`` whose entry
``(i, j, k*B + n)`` is block k of lane n, so a level is one launch over
all its (block, lane) columns and neighbouring lanes are neighbouring
addresses.  Five kernels do the level math (``csrc/crkern.cu``):

    K5 crp_factor_level       factor one level (no rhs)
    K1 crp_factor_fwd_level   factor one level + eliminate known rhs
    K2 crp_fwd_level          eliminate a new rhs against a stored level
    K3 crp_bwd_level          back-substitute one level
    K4 crp_root               invert/apply the root block

Each wrapper below launches its kernel for a CUDA tensor and uses its plain
PyTorch twin (same elimination order, same unrolled-Cholesky pivots) for a
CPU tensor; nothing else selects between them.  Each counts its launches in
``<wrapper>.launches``.  The even/odd split, the one-block shifts and the
interleave between levels are plain torch.

Public API (batch-first): :func:`crp_factor`, :func:`crp_factor_solve`,
:func:`crp_solve`, :func:`crp_pad_rhs`.  Non-SPD pivots surface as NaN in
that lane only.
"""

from __future__ import annotations

import torch

from tol_tpu_torch.ops import _build

# ---------------------------------------------------------------------------
# slab plumbing: (B, p, a, b) lane-major <-> (a, b, p*B) block-major slab
# ---------------------------------------------------------------------------


def _to_slab(x):
    Bb, p, a, b = x.shape
    return x.permute(2, 3, 1, 0).reshape(a, b, p * Bb).contiguous()


def _from_slab(x, Bb):
    a, b, pB = x.shape
    return x.reshape(a, b, pB // Bb, Bb).permute(3, 2, 0, 1)


def _split_oe(x, Bb):
    """slab (a, b, p*B) -> (even, odd) slabs (a, b, p/2*B)."""
    a, b, pB = x.shape
    x4 = x.reshape(a, b, pB // Bb // 2, 2, Bb)
    return (x4[:, :, :, 0].reshape(a, b, -1).contiguous(),
            x4[:, :, :, 1].reshape(a, b, -1).contiguous())


def _shift_fwd(x, Bb):
    """out[k] = x[k-1] along the block axis (zero fill)."""
    a, b, pB = x.shape
    pad = torch.zeros(a, b, Bb, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[:, :, :pB - Bb]], dim=2)


def _shift_bwd(x, Bb):
    """out[k] = x[k+1] (zero fill at the end)."""
    a, b, pB = x.shape
    pad = torch.zeros(a, b, Bb, dtype=x.dtype, device=x.device)
    return torch.cat([x[:, :, Bb:], pad], dim=2)


def _interleave(xe, xo, Bb):
    a, b, hB = xe.shape
    h = hB // Bb
    out = torch.stack([xe.reshape(a, b, h, Bb), xo.reshape(a, b, h, Bb)], dim=3)
    return out.reshape(a, b, 2 * h * Bb)


# ---------------------------------------------------------------------------
# plain twins of the kernels (slab algebra, Pallas arithmetic order)
# ---------------------------------------------------------------------------


def _chol_slab(A):
    """Cholesky columns of the SPD slab (n, n, L): cols[j][i] = L_ij."""
    n = A.shape[0]
    cols = []
    for j in range(n):
        s = A[:, j]
        for k in range(j):
            s = s - cols[k][j] * cols[k]
        # the quotient, not s * (1 / sqrt): see csrc/crkern_block.cuh
        cols.append(s / torch.sqrt(s[j]))
    return cols


def _spd_inverse_slab(A):
    """Explicit inverse of the SPD slab (n, n, L): solve L Y = I, then
    L^T X = Y, for all n unit columns at once."""
    n = A.shape[0]
    Lc = _chol_slab(A)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)[:, :, None]  # (i, c, 1)
    y = []
    for i in range(n):
        num = eye[i] + torch.zeros_like(Lc[i][i])
        if i > 0:
            s = Lc[0][i] * y[0]
            for k in range(1, i):
                s = s + Lc[k][i] * y[k]
            num = eye[i] - s
        y.append(num / Lc[i][i])
    x = [None] * n
    for i in range(n - 1, -1, -1):
        num = y[i]
        if i < n - 1:
            s = Lc[i][i + 1] * x[i + 1]
            for k in range(i + 2, n):
                s = s + Lc[i][k] * x[k]
            num = y[i] - s
        x[i] = num / Lc[i][i]
    return torch.stack(x, dim=0)            # (row i, column c, L)


def _mm(A, B):
    """(n, k, L) @ (k, m, L) -> (n, m, L), summed in k order."""
    out = A[:, 0:1] * B[0:1]
    for j in range(1, A.shape[1]):
        out = out + A[:, j:j + 1] * B[j:j + 1]
    return out


def _mm_tn(A, B):
    """(k, n, L)^T @ (k, m, L) -> (n, m, L)."""
    out = A[0][:, None] * B[0:1]
    for j in range(1, A.shape[0]):
        out = out + A[j][:, None] * B[j:j + 1]
    return out


def _mm_nt(A, B):
    """(n, k, L) @ (m, k, L)^T -> (n, m, L)."""
    out = A[:, 0:1] * B[:, 0][None]
    for j in range(1, A.shape[1]):
        out = out + A[:, j:j + 1] * B[:, j][None]
    return out


def factor_level_plain(Mo, Me, OL, OR):
    """Twin of K5: one level's factor -> (Minv, Mhalf, Onext, S)."""
    Minv = _spd_inverse_slab(Mo)
    MinvOR = _mm(Minv, OR)
    Mhalf = Me - _mm(OL, _mm_nt(Minv, OL))
    return Minv, Mhalf, -_mm(OL, MinvOR), _mm_tn(OR, MinvOR)


def factor_fwd_level_plain(Mo, Me, OL, OR, Fo, Fe):
    """Twin of K1: one level's factor fused with the rhs elimination."""
    Minv, Mhalf, Onext, S = factor_level_plain(Mo, Me, OL, OR)
    g = _mm(Minv, Fo)
    return Minv, Mhalf, Onext, S, Fe - _mm(OL, g), _mm_tn(OR, g)


def fwd_level_plain(Minv, OL, OR, fo, fe):
    """Twin of K2: fe2 = fe - OL Minv fo, br = OR^T Minv fo."""
    g = _mm(Minv, fo)
    return fe - _mm(OL, g), _mm_tn(OR, g)


def bwd_level_plain(Minv, OL, OR, fo, xe, xs):
    """Twin of K3: xo = Minv (fo - OL^T xe - OR xs)."""
    return _mm(Minv, fo - _mm_tn(OL, xe) - _mm(OR, xs))


def root_plain(A, F, invert):
    """Twin of K4: (A^-1, A^-1 F) when inverting, else (A, A F)."""
    R = _spd_inverse_slab(A) if invert else A
    return R, _mm(R, F)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_NB = 11  # the kernels are built for the 11x11 node blocks


def _check(name, blocks, rhs):
    """Validate the slabs handed to a kernel; returns (L, m)."""
    L = blocks[0].shape[2]
    m = rhs[0].shape[1] if rhs else 0
    for t in blocks + rhs:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: all operands must be CUDA tensors")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 only, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.dim() != 3 or t.shape[2] != L or t.shape[0] != _NB:
            raise ValueError(f"{name}: bad slab shape {tuple(t.shape)}")
    for t in blocks:
        if t.shape[1] != _NB:
            raise ValueError(f"{name}: block slabs must be ({_NB}, {_NB}, L)")
    for t in rhs:
        if t.shape[1] != m:
            raise ValueError(f"{name}: rhs slabs disagree on width")
    return L, m


def _ptr(t):
    return t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def crp_factor_fwd_level(Mo, Me, OL, OR, Fo, Fe):
    """K1 (replaces crkern.py:_factor_fwd_kernel).  Slabs (11, 11, L) and
    rhs (11, m, L) -> (Minv, Mhalf, Onext, S, Fe2, brF)."""
    if Mo.device.type == "cpu":
        return factor_fwd_level_plain(Mo, Me, OL, OR, Fo, Fe)
    L, m = _check("crp_factor_fwd_level", [Mo, Me, OL, OR], [Fo, Fe])
    outs = [torch.empty_like(Mo) for _ in range(4)] + \
        [torch.empty_like(Fo) for _ in range(2)]
    lib = _build.load_library()
    code = lib.crp_factor_fwd_level(*map(_ptr, (Mo, Me, OL, OR, Fo, Fe)),
                                    *map(_ptr, outs), L, m, _stream(Mo))
    crp_factor_fwd_level.launches += 1
    _build.check(lib, code, "crp_factor_fwd_level")
    return tuple(outs)


def crp_factor_level(Mo, Me, OL, OR):
    """K5 (replaces crkern.py:_factor_kernel).  Slabs (11, 11, L) ->
    (Minv, Mhalf, Onext, S)."""
    if Mo.device.type == "cpu":
        return factor_level_plain(Mo, Me, OL, OR)
    L, _ = _check("crp_factor_level", [Mo, Me, OL, OR], [])
    outs = [torch.empty_like(Mo) for _ in range(4)]
    lib = _build.load_library()
    code = lib.crp_factor_level(*map(_ptr, (Mo, Me, OL, OR)), *map(_ptr, outs),
                                L, _stream(Mo))
    crp_factor_level.launches += 1
    _build.check(lib, code, "crp_factor_level")
    return tuple(outs)


def crp_fwd_level(Minv, OL, OR, fo, fe):
    """K2 (replaces crkern.py:_fwd_kernel) -> (fe2, br)."""
    if Minv.device.type == "cpu":
        return fwd_level_plain(Minv, OL, OR, fo, fe)
    L, m = _check("crp_fwd_level", [Minv, OL, OR], [fo, fe])
    fe2, br = torch.empty_like(fo), torch.empty_like(fo)
    lib = _build.load_library()
    code = lib.crp_fwd_level(*map(_ptr, (Minv, OL, OR, fo, fe, fe2, br)), L, m,
                             _stream(Minv))
    crp_fwd_level.launches += 1
    _build.check(lib, code, "crp_fwd_level")
    return fe2, br


def crp_bwd_level(Minv, OL, OR, fo, xe, xs):
    """K3 (replaces crkern.py:_bwd_kernel) -> xo."""
    if Minv.device.type == "cpu":
        return bwd_level_plain(Minv, OL, OR, fo, xe, xs)
    L, m = _check("crp_bwd_level", [Minv, OL, OR], [fo, xe, xs])
    xo = torch.empty_like(fo)
    lib = _build.load_library()
    code = lib.crp_bwd_level(*map(_ptr, (Minv, OL, OR, fo, xe, xs, xo)), L, m,
                             _stream(Minv))
    crp_bwd_level.launches += 1
    _build.check(lib, code, "crp_bwd_level")
    return xo


def crp_root(A, F, invert):
    """K4 (replaces crkern.py:_root_kernel and _root_solve_kernel).
    ``invert``: A is the root block -> (A^-1, A^-1 F); else A is the stored
    inverse -> (A, A F)."""
    if A.device.type == "cpu":
        return root_plain(A, F, invert)
    L, m = _check("crp_root", [A], [F])
    X = torch.empty_like(F)
    Rinv = torch.empty_like(A) if invert else A
    lib = _build.load_library()
    code = lib.crp_root(_ptr(A), _ptr(F), _ptr(Rinv) if invert else None,
                        _ptr(X), L, m, int(bool(invert)), _stream(A))
    crp_root.launches += 1
    _build.check(lib, code, "crp_root")
    return Rinv, X


KERNELS = (crp_factor_fwd_level, crp_fwd_level, crp_bwd_level, crp_root,
           crp_factor_level)
for _k in KERNELS:
    _k.launches = 0


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


# ---------------------------------------------------------------------------
# level drivers (slab space)
# ---------------------------------------------------------------------------


def _factor_slab(M, O, Bb):
    """Factor only.  Returns (levels, root_inv) in slab space."""
    levels = []
    p = M.shape[2] // Bb
    while p > 1:
        Me, Mo = _split_oe(M, Bb)
        OL, OR = _split_oe(O, Bb)
        Minv, Mhalf, Onext, S = crp_factor_level(Mo, Me, OL, OR)
        M = (Mhalf - _shift_fwd(S, Bb)).contiguous()
        O = Onext
        levels.append((Minv, OL, OR))
        p //= 2
    root_inv, _ = crp_root(M, M.new_empty(M.shape[0], 0, Bb), invert=True)
    return levels, root_inv


def _factor_fwd_slab(M, O, F, Bb):
    """Fused factor + elimination of F, root, then the backward sweep.
    Returns (levels, root_inv, X) in slab space."""
    levels, stack = [], []
    p = M.shape[2] // Bb
    while p > 1:
        Me, Mo = _split_oe(M, Bb)
        OL, OR = _split_oe(O, Bb)
        Fe, Fo = _split_oe(F, Bb)
        Minv, Mhalf, Onext, S, Fe2, brF = crp_factor_fwd_level(
            Mo, Me, OL, OR, Fo, Fe)
        M = (Mhalf - _shift_fwd(S, Bb)).contiguous()
        O = Onext
        F = (Fe2 - _shift_fwd(brF, Bb)).contiguous()
        levels.append((Minv, OL, OR))
        stack.append(Fo)
        p //= 2
    root_inv, x = crp_root(M, F, invert=True)
    return levels, root_inv, _backward(levels, stack, x, Bb)


def _backward(levels, stack, x, Bb):
    for (Minv, OL, OR), fo in zip(reversed(levels), reversed(stack)):
        xs = _shift_bwd(x, Bb).contiguous()
        xo = crp_bwd_level(Minv, OL, OR, fo, x, xs)
        x = _interleave(x, xo, Bb)
    return x


def _solve_slab(levels, root_inv, f, Bb):
    stack = []
    for (Minv, OL, OR) in levels:
        fe, fo = _split_oe(f, Bb)
        fe2, br = crp_fwd_level(Minv, OL, OR, fo, fe)
        f = (fe2 - _shift_fwd(br, Bb)).contiguous()
        stack.append(fo)
    _, x = crp_root(root_inv, f, invert=False)
    return _backward(levels, stack, x, Bb)


# ---------------------------------------------------------------------------
# public batch-first API
# ---------------------------------------------------------------------------


def _pow2(n):
    p = 1
    while p < n:
        p *= 2
    return p


def crp_pad_rhs(f, n_pad):
    """Zero-pad the block axis (1) of ``f`` (B, n, b, m) to ``n_pad``."""
    if f.shape[1] == n_pad:
        return f
    pad = torch.zeros(f.shape[0], n_pad - f.shape[1], *f.shape[2:],
                      dtype=f.dtype, device=f.device)
    return torch.cat([f, pad], dim=1)


def _pad_chain(M, O):
    """Pad the chains to a power-of-two length with identity blocks and cut
    the last coupling; returns (M, O, n_pad)."""
    Bb, n, b = M.shape[0], M.shape[1], M.shape[2]
    p = _pow2(n)
    if p != n:
        eye = torch.eye(b, dtype=M.dtype, device=M.device).expand(
            Bb, p - n, b, b)
        M = torch.cat([M, eye], dim=1)
        O = torch.cat([O, torch.zeros(Bb, p - n, b, b, dtype=M.dtype,
                                      device=M.device)], dim=1)
    O = O.clone()
    O[:, p - 1] = 0.0
    return M, O, p


def crp_factor(M, O):
    """Factor B chains: ``M``, ``O`` (B, n, b, b) with ``O[:, i]`` coupling
    x_i to x_{i+1}.  Returns ``(levels, root_inv)``, the factor in slab
    layout, opaque to callers, for :func:`crp_solve`."""
    M, O, _ = _pad_chain(M, O)
    levels, root_inv = _factor_slab(_to_slab(M), _to_slab(O), M.shape[0])
    return tuple(levels), root_inv


def crp_factor_solve(M, O, F):
    """Fused factor + multi-rhs solve of B chains.

    ``M``, ``O`` as :func:`crp_factor`; ``F``: (B, n, b, m) rhs columns
    known before the factor.  Returns ``(levels, root_inv, X)``: ``X``
    (B, n_pad, b, m) solves each chain (callers slice ``[:, :n]``), and
    ``(levels, root_inv)`` is the factor :func:`crp_factor` returns."""
    M, O, p = _pad_chain(M, O)
    levels, root_inv, x = _factor_fwd_slab(_to_slab(M), _to_slab(O),
                                           _to_slab(crp_pad_rhs(F, p)),
                                           M.shape[0])
    return tuple(levels), root_inv, _from_slab(x, M.shape[0])


def crp_solve(levels, root_inv, f):
    """Solve with a :func:`crp_factor` / :func:`crp_factor_solve` factor.
    ``f`` (B, n_pad, b, m) zero-padded by :func:`crp_pad_rhs`; returns
    (B, n_pad, b, m)."""
    Bb = f.shape[0]
    return _from_slab(_solve_slab(list(levels), root_inv, _to_slab(f), Bb), Bb)
