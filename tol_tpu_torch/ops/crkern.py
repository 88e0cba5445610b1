"""Cyclic reduction over a batch-last slab layout, with hand-written CUDA
level kernels (port of ``tol_tpu/ops/crkern.py``).

The chain ``O_{i-1}^T x_{i-1} + M_i x_i + O_i x_{i+1} = f_i`` (11x11 SPD
blocks) is reduced level by level in the even/odd order of
``tol_tpu/ops/blocktri.py``.  That order is a numerical property, not a
speed choice: sequential orders lose the flat-valley components of the
Newton direction to the float32 noise floor and fail the S10 cost gate.

Each level's blocks sit in a slab ``(a, b, p*B)`` whose entry
``(i, j, k*B + n)`` is block k of lane n, so neighbouring lanes are
neighbouring addresses.  Four kernels do the level math
(``csrc/crkern.cu``):

    K1 crp_factor_fwd_pass    factor + eliminate known rhs, all levels,
                              then invert and apply the root block
    K2 crp_fwd_pass           eliminate a new rhs against a stored factor,
                              all levels, then apply the root inverse
    K3 crp_bwd_pass           back-substitute, all levels
    K5 crp_factor_pass        factor alone (K1 with no rhs), all levels,
                              then invert the root block

Each runs a whole pass in one launch, so a factor + solve is two launches
(K1, K3), a solve with a stored factor two (K2, K3) and a factor alone one
(K5).  Each wrapper below launches its kernel for a CUDA tensor and uses
its plain PyTorch twin (same elimination order, same unrolled-Cholesky
pivots) for a CPU tensor; nothing else selects between them.  Each counts
its launches in ``<wrapper>.launches``.

Public API (batch-first): :func:`crp_factor`, :func:`crp_factor_solve`,
:func:`crp_solve`, :func:`crp_pad_rhs`.  Non-SPD pivots surface as NaN in
that lane only.
"""

from __future__ import annotations

import ctypes

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
    """One level of K5: the level's factor -> (Minv, Mhalf, Onext, S)."""
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
    """One level of K2: fe2 = fe - OL Minv fo, br = OR^T Minv fo."""
    g = _mm(Minv, fo)
    return fe - _mm(OL, g), _mm_tn(OR, g)


def bwd_level_plain(Minv, OL, OR, fo, xe, xs):
    """Twin of K3: xo = Minv (fo - OL^T xe - OR xs)."""
    return _mm(Minv, fo - _mm_tn(OL, xe) - _mm(OR, xs))


def factor_fwd_pass_plain(M, O, F, Bb):
    """Twin of K1: every level of the fused factor + rhs elimination over
    the slabs M, O (11, 11, n_pad*B), F (11, m, n_pad*B) -> (levels, stack,
    root_inv, x): per level (Minv, OL, OR) and Fo, then the root block's
    inverse (11, 11, B) and solution root_inv F_root (11, m, B)."""
    levels, stack = [], []
    p = M.shape[2] // Bb
    while p > 1:
        Me, Mo = _split_oe(M, Bb)
        OL, OR = _split_oe(O, Bb)
        Fe, Fo = _split_oe(F, Bb)
        Minv, Mhalf, Onext, S, Fe2, brF = factor_fwd_level_plain(
            Mo, Me, OL, OR, Fo, Fe)
        M = (Mhalf - _shift_fwd(S, Bb)).contiguous()
        O = Onext
        F = (Fe2 - _shift_fwd(brF, Bb)).contiguous()
        levels.append((Minv, OL, OR))
        stack.append(Fo)
        p //= 2
    root_inv = root_plain(M)
    return levels, stack, root_inv, _mm(root_inv, F)


def factor_pass_plain(M, O, Bb):
    """Twin of K5: every level's factor over the slabs M, O
    (11, 11, n_pad*B), no rhs -> (levels, root_inv): per level (Minv, OL,
    OR), then the root block's inverse (11, 11, B)."""
    levels = []
    p = M.shape[2] // Bb
    while p > 1:
        Me, Mo = _split_oe(M, Bb)
        OL, OR = _split_oe(O, Bb)
        Minv, Mhalf, Onext, S = factor_level_plain(Mo, Me, OL, OR)
        M = (Mhalf - _shift_fwd(S, Bb)).contiguous()
        O = Onext
        levels.append((Minv, OL, OR))
        p //= 2
    return levels, root_plain(M)


def fwd_pass_plain(levels, root_inv, f, Bb):
    """Twin of K2: eliminate the rhs slab f (11, m, n_pad*B) level by level
    against a stored factor -> (stack, x): per level the blocks fo the solve
    saves, then the root solution root_inv f_root (11, m, B)."""
    stack = []
    for (Minv, OL, OR) in levels:
        fe, fo = _split_oe(f, Bb)
        fe2, br = fwd_level_plain(Minv, OL, OR, fo, fe)
        f = (fe2 - _shift_fwd(br, Bb)).contiguous()
        stack.append(fo)
    return stack, _mm(root_inv, f)


def bwd_pass_plain(levels, stack, x, Bb):
    """Twin of K3: back-substitute every level from the root solution x
    (11, m, B) -> the slab (11, m, n_pad*B)."""
    for (Minv, OL, OR), fo in zip(reversed(levels), reversed(stack)):
        xo = bwd_level_plain(Minv, OL, OR, fo, x, _shift_bwd(x, Bb))
        x = _interleave(x, xo, Bb)
    return x


def root_plain(A):
    """The root step of K1 and K5: the inverse of the SPD root blocks A
    (11, 11, B)."""
    return _spd_inverse_slab(A)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_NB = 11  # the kernels are built for the 11x11 node blocks
_MAX_LEVELS = 16  # crk::kMaxLevels


def _check_device(name, ts):
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: all operands must be CUDA tensors")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 only, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _ptr(t):
    return t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _levels_of(n_pad):
    """CR levels of an n_pad-block chain (n_pad a power of two)."""
    n_levels = n_pad.bit_length() - 1
    if n_pad < 1 or 1 << n_levels != n_pad or n_levels > _MAX_LEVELS:
        raise ValueError(f"chain length {n_pad} is not a power of two "
                         f"<= 2**{_MAX_LEVELS}")
    return n_levels


def _ptr_array(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _check_shapes(name, pairs):
    """Validate (tensor, expected shape) pairs handed to a pass kernel."""
    _check_device(name, [t for t, _ in pairs])
    for t, shape in pairs:
        if t.shape != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")


def crp_factor_fwd_pass(M, O, F):
    """K1 (replaces crkern.py:_factor_fwd_kernel at every level, then
    _root_kernel).  Batch-first M, O (B, n_pad, 11, 11) and rhs F
    (B, n_pad, 11, m), n_pad a power of two -> (levels, stack, root_inv, x)
    as :func:`factor_fwd_pass_plain`."""
    Bb = M.shape[0]
    if M.device.type == "cpu":
        return factor_fwd_pass_plain(_to_slab(M), _to_slab(O), _to_slab(F), Bb)
    name = "crp_factor_fwd_pass"
    n_pad, m = M.shape[1], F.shape[-1]
    blk, rhs = (Bb, n_pad, _NB, _NB), (Bb, n_pad, _NB, m)
    _check_shapes(name, [(M, blk), (O, blk), (F, rhs)])
    n_levels = _levels_of(n_pad)
    new = lambda w, h: torch.empty(_NB, w, h * Bb, dtype=M.dtype, device=M.device)
    hs = [n_pad >> (l + 1) for l in range(n_levels)]
    levels = [(new(_NB, h), new(_NB, h), new(_NB, h)) for h in hs]
    stack = [new(m, h) for h in hs]
    root_inv, x = new(_NB, 1), new(m, 1)
    lib = _build.load_library()
    code = lib.crp_factor_fwd_pass(
        _ptr(M), _ptr(O), _ptr(F), *(_ptr_array([lv[i] for lv in levels])
                                     for i in range(3)),
        _ptr_array(stack), _ptr(root_inv), _ptr(x), Bb, n_pad, m, _stream(M))
    crp_factor_fwd_pass.launches += 1
    _build.check(lib, code, name)
    return levels, stack, root_inv, x


def crp_factor_pass(M, O):
    """K5 (replaces crkern.py:_factor_kernel at every level, then
    _root_kernel).  Batch-first M, O (B, n_pad, 11, 11), n_pad a power of
    two -> (levels, root_inv) as :func:`factor_pass_plain`."""
    Bb = M.shape[0]
    if M.device.type == "cpu":
        return factor_pass_plain(_to_slab(M), _to_slab(O), Bb)
    name = "crp_factor_pass"
    n_pad = M.shape[1]
    blk = (Bb, n_pad, _NB, _NB)
    _check_shapes(name, [(M, blk), (O, blk)])
    n_levels = _levels_of(n_pad)
    new = lambda h: torch.empty(_NB, _NB, h * Bb, dtype=M.dtype, device=M.device)
    levels = [(new(h), new(h), new(h))
              for h in (n_pad >> (l + 1) for l in range(n_levels))]
    root_inv = new(1)
    lib = _build.load_library()
    code = lib.crp_factor_pass(
        _ptr(M), _ptr(O), *(_ptr_array([lv[i] for lv in levels])
                            for i in range(3)),
        _ptr(root_inv), Bb, n_pad, _stream(M))
    crp_factor_pass.launches += 1
    _build.check(lib, code, name)
    return levels, root_inv


def _factor_pairs(levels, Bb, n_pad):
    """(slab, expected shape) pairs of a factor's per-level slabs."""
    pairs = []
    for l, lv in enumerate(levels):
        L = (n_pad >> (l + 1)) * Bb
        pairs += [(t, (_NB, _NB, L)) for t in lv]
    return pairs


def crp_fwd_pass(levels, root_inv, f):
    """K2 (replaces crkern.py:_fwd_kernel at every level, then
    _root_solve_kernel).  ``levels``, ``root_inv``: a factor as
    :func:`crp_factor` returns it; ``f`` (B, n_pad, 11, m) batch-first ->
    (stack, x) as :func:`fwd_pass_plain`: per level the slab fo the
    back-substitution reads, and the root solution (11, m, B)."""
    Bb = f.shape[0]
    if f.device.type == "cpu":
        return fwd_pass_plain(levels, root_inv, _to_slab(f), Bb)
    name = "crp_fwd_pass"
    n_pad, m = f.shape[1], f.shape[-1]
    if _levels_of(n_pad) != len(levels):
        raise ValueError(f"{name}: {len(levels)} levels for {n_pad} blocks")
    _check_shapes(name, [(f, (Bb, n_pad, _NB, m)), (root_inv, (_NB, _NB, Bb))]
                  + _factor_pairs(levels, Bb, n_pad))
    stack = [torch.empty(_NB, m, (n_pad >> (l + 1)) * Bb, dtype=f.dtype,
                         device=f.device) for l in range(len(levels))]
    x = torch.empty(_NB, m, Bb, dtype=f.dtype, device=f.device)
    lib = _build.load_library()
    code = lib.crp_fwd_pass(
        *(_ptr_array([lv[i] for lv in levels]) for i in range(3)),
        _ptr(root_inv), _ptr(f), _ptr_array(stack), _ptr(x), Bb, n_pad, m,
        _stream(f))
    crp_fwd_pass.launches += 1
    _build.check(lib, code, name)
    return stack, x


def crp_bwd_pass(levels, stack, x):
    """K3 (replaces crkern.py:_bwd_kernel at every level).  ``levels``,
    ``stack``: a factor's per-level (Minv, OL, OR) slabs and the rhs blocks
    fo saved on the way down; ``x`` (11, m, B) the root solution -> X
    (B, n_pad, 11, m)."""
    Bb = x.shape[2]
    if x.device.type == "cpu":
        return _from_slab(bwd_pass_plain(levels, stack, x, Bb), Bb)
    name = "crp_bwd_pass"
    m, n_pad = x.shape[1], 1 << len(levels)
    _levels_of(n_pad)
    if len(stack) != len(levels):
        raise ValueError(f"{name}: {len(levels)} levels, {len(stack)} rhs")
    _check_shapes(name, [(x, (_NB, m, Bb))] + _factor_pairs(levels, Bb, n_pad)
                  + [(fo, (_NB, m, (n_pad >> (l + 1)) * Bb))
                     for l, fo in enumerate(stack)])
    X = torch.empty(Bb, n_pad, _NB, m, dtype=x.dtype, device=x.device)
    lib = _build.load_library()
    code = lib.crp_bwd_pass(
        *(_ptr_array([lv[i] for lv in levels]) for i in range(3)),
        _ptr_array(stack), _ptr(x), _ptr(X), Bb, n_pad, m, _stream(x))
    crp_bwd_pass.launches += 1
    _build.check(lib, code, name)
    return X


KERNELS = (crp_factor_fwd_pass, crp_fwd_pass, crp_bwd_pass, crp_factor_pass)
for _k in KERNELS:
    _k.launches = 0


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


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
    """Factor B chains (K5): ``M``, ``O`` (B, n, b, b) with ``O[:, i]``
    coupling x_i to x_{i+1}.  Returns ``(levels, root_inv)``, the factor in
    slab layout, opaque to callers, for :func:`crp_solve`."""
    M, O, _ = _pad_chain(M, O)
    levels, root_inv = crp_factor_pass(M.contiguous(), O.contiguous())
    return tuple(levels), root_inv


def crp_factor_solve(M, O, F):
    """Fused factor + multi-rhs solve of B chains: K1, then K3.

    ``M``, ``O`` as :func:`crp_factor`; ``F``: (B, n, b, m) rhs columns
    known before the factor.  Returns ``(levels, root_inv, X)``: ``X``
    (B, n_pad, b, m) solves each chain (callers slice ``[:, :n]``), and
    ``(levels, root_inv)`` is the factor :func:`crp_factor` returns."""
    M, O, p = _pad_chain(M, O)
    levels, stack, root_inv, x = crp_factor_fwd_pass(
        M.contiguous(), O.contiguous(), crp_pad_rhs(F, p).contiguous())
    return tuple(levels), root_inv, crp_bwd_pass(levels, stack, x)


def crp_solve(levels, root_inv, f):
    """Solve with a :func:`crp_factor` / :func:`crp_factor_solve` factor: K2,
    then K3.  ``f`` (B, n_pad, b, m) zero-padded by :func:`crp_pad_rhs`;
    returns (B, n_pad, b, m)."""
    stack, x = crp_fwd_pass(levels, root_inv, f.contiguous())
    return crp_bwd_pass(levels, stack, x)
