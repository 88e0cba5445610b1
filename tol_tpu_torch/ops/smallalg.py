"""Batched small-matrix linear algebra (port of ``tol_tpu/ops/smallalg.py``).

The last two axes are the matrix; any leading axes are batch.  The
recurrences are unrolled over the tiny static matrix dimension, so a
non-SPD pivot gives NaN in that matrix only (the solvers read NaN as their
inertia signal) instead of raising as ``torch.linalg.cholesky`` would.
"""

from __future__ import annotations

import torch


def bmm(A, B):
    """``A @ B`` unrolled over the contraction axis: (..., n, k), (..., k, m)."""
    k = A.shape[-1]
    out = A[..., :, 0, None] * B[..., 0, None, :]
    for j in range(1, k):
        out = out + A[..., :, j, None] * B[..., j, None, :]
    return out


def bmm_tn(A, B):
    """``A^T @ B`` unrolled: (..., k, n), (..., k, m)."""
    k = A.shape[-2]
    out = A[..., 0, :, None] * B[..., 0, None, :]
    for j in range(1, k):
        out = out + A[..., j, :, None] * B[..., j, None, :]
    return out


def bmv(A, x):
    """``A @ x``: (..., n, k), (..., k)."""
    k = A.shape[-1]
    out = A[..., :, 0] * x[..., 0, None]
    for j in range(1, k):
        out = out + A[..., :, j] * x[..., j, None]
    return out


def bmv_t(A, x):
    """``A^T @ x``: (..., k, n), (..., k)."""
    k = A.shape[-2]
    out = A[..., 0, :] * x[..., 0, None]
    for j in range(1, k):
        out = out + A[..., j, :] * x[..., j, None]
    return out


def chol_unrolled(A):
    """Lower Cholesky factor of SPD ``A`` (..., n, n); NaN on non-PD input."""
    n = A.shape[-1]
    upper = torch.arange(n, device=A.device)
    cols = []
    for j in range(n):
        s = A[..., :, j]
        for k in range(j):
            s = s - cols[k][..., j:j + 1] * cols[k]
        d = torch.sqrt(s[..., j])
        col = s / d[..., None]
        col = torch.where(upper >= j, col, torch.zeros_like(col))
        cols.append(col)
    return torch.stack(cols, dim=-1)


def chol_outer(A):
    """Lower Cholesky factor of SPD ``A`` (..., n, n), column by column with
    a rank-one update of the rest: n steps of a few whole-matrix operations
    where :func:`chol_unrolled` takes O(n^2) (the same products, subtracted
    in the same order); NaN on a non-PD pivot, which the updates spread."""
    n = A.shape[-1]
    cols = []
    for j in range(n):
        col = A[..., :, j] / torch.sqrt(A[..., j, j])[..., None]
        cols.append(col)
        if j + 1 < n:
            A = A - col[..., :, None] * col[..., None, :]
    return torch.tril(torch.stack(cols, dim=-1))


def cho_solve_outer(L, X):
    """``(L L^T)^-1 X`` for lower ``L`` (..., n, n), ``X`` (..., n, m): the
    forward solve by L's columns, the back solve by its rows."""
    n = L.shape[-1]
    ys = []
    for j in range(n):
        y = X[..., j, :] / L[..., j, j, None]
        ys.append(y)
        if j + 1 < n:
            X = X - L[..., :, j, None] * y[..., None, :]
    Y = torch.stack(ys, dim=-2)
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        x = Y[..., i, :] / L[..., i, i, None]
        xs[i] = x
        if i:
            Y = Y - L[..., i, :, None] * x[..., None, :]
    return torch.stack(xs, dim=-2)


def tri_solve_unrolled(L, B, lower=True, trans=False):
    """Solve ``L X = B`` (``L^T X = B`` with ``trans``) for triangular L:
    (..., n, n), (..., n, m)."""
    n = L.shape[-1]
    rows = [None] * n
    order = range(n) if (lower ^ trans) else range(n - 1, -1, -1)
    for i in order:
        s = B[..., i, :]
        if lower and not trans:
            for k in range(i):
                s = s - L[..., i, k:k + 1] * rows[k]
        elif lower and trans:
            for k in range(i + 1, n):
                s = s - L[..., k, i:i + 1] * rows[k]
        elif not lower and not trans:
            for k in range(i + 1, n):
                s = s - L[..., i, k:k + 1] * rows[k]
        else:
            for k in range(i):
                s = s - L[..., k, i:i + 1] * rows[k]
        rows[i] = s / L[..., i, i][..., None]
    return torch.stack(rows, dim=-2)


def spd_solve(A, B):
    """Solve SPD ``A X = B`` via the unrolled Cholesky."""
    L = chol_unrolled(A)
    Y = tri_solve_unrolled(L, B, lower=True)
    return tri_solve_unrolled(L, Y, lower=True, trans=True)


def spd_inverse(A):
    """Explicit inverse of SPD ``A`` via the unrolled Cholesky."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    return spd_solve(A, eye)


def solve_unchecked(A, B):
    """``A X = B`` per batch entry by LU with partial pivoting and no error
    check: a singular or non-finite ``A`` gives nan/inf in its entry, as
    ``jnp.linalg.solve`` does, and nothing reads the device's ``info`` back.
    On CUDA the LU runs through cuSOLVER / cuBLAS, which a CUDA graph
    captures; PyTorch's default for a batch of matrices wider than 16 is
    MAGMA, which a capture refuses."""
    if A.device.type != "cuda":
        return torch.linalg.solve_ex(A, B)[0]
    backends = torch.backends.cuda
    prev = backends.preferred_linalg_library()
    backends.preferred_linalg_library("cusolver")
    try:
        return torch.linalg.solve_ex(A, B)[0]
    finally:
        backends.preferred_linalg_library(prev)

