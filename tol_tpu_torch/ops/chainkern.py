"""The fused sequential chain of the condensed KKT system, with hand-written
CUDA kernels (port of ``tol_tpu/ops/chainkern.py``).

The condensed system is a block-tridiagonal chain (T blocks of 11x11) plus
a border of nB columns.  Three kernels (``csrc/chainkern.cu``) walk the
chain block by block, in the batch-last layout ``(T, a, b, B)`` of the JAX
package so that neighbouring lanes are neighbouring addresses:

    K6 chain_factor        forward block elimination of [W | r] with carries
                           dcorr, rcorr, s_acc; emits Dinv, t2, tR and
                           S = sum R~^T D~^-1 R~
    K7 chain_rhs_forward   forward pass of one new rhs column against the
                           stored Dinv (O(n^2) per block)
    K8 chain_back_sub      x_i = tR_i coef - t2_i x_{i+1}, last block first

The elimination order is sequential, unlike the cyclic reduction of
``ops/crkern.py``: in float32 it loses more of the flat-valley components
of the Newton direction, which is why the flagship solve keeps ``crp``.

Each ``_*_batched`` wrapper below launches its kernel for a CUDA tensor and
uses its plain PyTorch twin (same order of operations) for a CPU tensor;
nothing else selects between them.  Each counts its launches in
``<wrapper>.launches`` and names its kernel in ``<wrapper>.kernel``.

Public API (batch-first, any B): :func:`chain_eliminate`,
:func:`chain_rhs_forward`, :func:`chain_back_sub`.  A non-SPD pivot
surfaces as NaN in that lane only, from that block on, and in S.
"""

from __future__ import annotations

import torch

from tol_tpu_torch.ops import _build
from tol_tpu_torch.ops.crkern import _mm, _mm_tn, _spd_inverse_slab

_NB = 11  # the kernels are built for the 11x11 node blocks

# ---------------------------------------------------------------------------
# plain twins of the kernels (slab algebra over the trailing lane axis,
# Pallas arithmetic order)
# ---------------------------------------------------------------------------


def factor_eliminate_plain(M, O, R):
    """Twin of K6.  ``M``, ``O`` (T, n, n, B), ``R`` (T, n, nC, B) ->
    (Dinv, t2, tR, S) with S (nC, nC, B)."""
    T, n, nC, B = R.shape
    z = lambda a, b: torch.zeros(a, b, B, dtype=M.dtype, device=M.device)
    dcorr, rcorr, s_acc = z(n, n), z(n, nC), z(nC, nC)
    Dinvs, t2s, tRs = [], [], []
    for i in range(T):
        Dt = M[i] - dcorr
        Rt = R[i] - rcorr
        Dinv = _spd_inverse_slab(Dt)
        tR = _mm(Dinv, Rt)
        t2 = _mm(Dinv, O[i])
        s_acc = s_acc + _mm_tn(Rt, tR)
        dcorr = _mm_tn(O[i], t2)
        rcorr = _mm_tn(O[i], tR)
        Dinvs.append(Dinv)
        t2s.append(t2)
        tRs.append(tR)
    return torch.stack(Dinvs), torch.stack(t2s), torch.stack(tRs), s_acc


def rhs_forward_plain(Dinv, O, tRw, r):
    """Twin of K7.  ``Dinv``, ``O`` (T, n, n, B), ``tRw`` (T, n, nB, B),
    ``r`` (T, n, 1, B) -> (tr (T, n, 1, B), sb (nB, 1, B))."""
    T, n, nB, B = tRw.shape
    rcorr = torch.zeros(n, 1, B, dtype=r.dtype, device=r.device)
    sb = torch.zeros(nB, 1, B, dtype=r.dtype, device=r.device)
    trs = []
    for i in range(T):
        rt = r[i] - rcorr
        tr = _mm(Dinv[i], rt)
        sb = sb + _mm_tn(tRw[i], rt)
        rcorr = _mm_tn(O[i], tr)
        trs.append(tr)
    return torch.stack(trs), sb


def back_substitute_plain(tR, t2, coef):
    """Twin of K8.  ``tR`` (T, n, nC, B), ``t2`` (T, n, n, B), ``coef``
    (nC, 1, B) -> x (T, n, B)."""
    T, n, _, B = tR.shape
    x = torch.zeros(n, 1, B, dtype=tR.dtype, device=tR.device)
    xs = [None] * T
    for i in range(T - 1, -1, -1):
        x = _mm(tR[i], coef) - _mm(t2[i], x)
        xs[i] = x[:, 0]
    return torch.stack(xs)


# ---------------------------------------------------------------------------
# kernel wrappers (batch-last slabs)
# ---------------------------------------------------------------------------


def _check(name, shapes):
    """Validate the operands handed to a kernel: ``shapes`` pairs each
    tensor with the shape it must have."""
    for t, shape in shapes:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: all operands must be CUDA tensors")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 only, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{name}: bad operand shape {tuple(t.shape)}, want {tuple(shape)}")


def _launch(name, wrapper, ins, outs, *dims):
    lib = _build.load_library("chainkern")
    code = getattr(lib, name)(
        *[t.data_ptr() for t in ins + outs], *dims,
        torch.cuda.current_stream(ins[0].device).cuda_stream)
    wrapper.launches += 1
    _build.check(lib, code, name)


def _factor_eliminate_batched(M, O, R):
    """K6 (replaces chainkern.py:_factor_kernel): see
    :func:`factor_eliminate_plain` for shapes."""
    if M.device.type == "cpu":
        return factor_eliminate_plain(M, O, R)
    T, B, nC = M.shape[0], M.shape[3], R.shape[2]
    _check("chain_factor", [(M, (T, _NB, _NB, B)), (O, (T, _NB, _NB, B)),
                            (R, (T, _NB, nC, B))])
    outs = [torch.empty_like(M), torch.empty_like(M), torch.empty_like(R),
            torch.empty(nC, nC, B, dtype=M.dtype, device=M.device)]
    _launch("chain_factor", _factor_eliminate_batched, [M, O, R], outs, T, nC, B)
    return tuple(outs)


def _rhs_forward_batched(Dinv, O, tRw, r):
    """K7 (replaces chainkern.py:_rhs_forward_kernel): see
    :func:`rhs_forward_plain` for shapes."""
    if Dinv.device.type == "cpu":
        return rhs_forward_plain(Dinv, O, tRw, r)
    T, B, nB = Dinv.shape[0], Dinv.shape[3], tRw.shape[2]
    _check("chain_rhs_forward", [(Dinv, (T, _NB, _NB, B)), (O, (T, _NB, _NB, B)),
                                 (tRw, (T, _NB, nB, B)), (r, (T, _NB, 1, B))])
    outs = [torch.empty_like(r),
            torch.empty(nB, 1, B, dtype=r.dtype, device=r.device)]
    _launch("chain_rhs_forward", _rhs_forward_batched, [Dinv, O, tRw, r], outs,
            T, nB, B)
    return tuple(outs)


def _back_substitute_batched(tR, t2, coef):
    """K8 (replaces chainkern.py:_bwd_kernel): see
    :func:`back_substitute_plain` for shapes."""
    if tR.device.type == "cpu":
        return back_substitute_plain(tR, t2, coef)
    T, _, nC, B = tR.shape
    _check("chain_back_sub", [(tR, (T, _NB, nC, B)), (t2, (T, _NB, _NB, B)),
                              (coef, (nC, 1, B))])
    x = torch.empty(T, _NB, B, dtype=tR.dtype, device=tR.device)
    _launch("chain_back_sub", _back_substitute_batched, [tR, t2, coef], [x],
            T, nC, B)
    return x


_factor_eliminate_batched.kernel = "chain_factor"
_rhs_forward_batched.kernel = "chain_rhs_forward"
_back_substitute_batched.kernel = "chain_back_sub"
KERNELS = (_factor_eliminate_batched, _rhs_forward_batched,
           _back_substitute_batched)
for _k in KERNELS:
    _k.launches = 0


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


# ---------------------------------------------------------------------------
# public batch-first API
# ---------------------------------------------------------------------------


def _lanes_last(x):
    """(B, T, a, b) -> (T, a, b, B), contiguous."""
    return x.permute(1, 2, 3, 0).contiguous()


def _lanes_first(x):
    """(T, a, b, B) -> (B, T, a, b)."""
    return x.permute(3, 0, 1, 2)


def chain_eliminate(M, O, R):
    """Forward elimination of B bordered chains.

    ``M``, ``O``: (B, T, n, n) with ``O[:, i]`` coupling x_i to x_{i+1};
    ``R`` = [W | r]: (B, T, n, nC) border columns (and rhs).  Returns
    ``(Dinv, t2, tR, S)``: (B, T, n, n), (B, T, n, n), (B, T, n, nC) and
    ``S`` (B, nC, nC) = sum_i R~_i^T D~_i^-1 R~_i."""
    Dinv, t2, tR, S = _factor_eliminate_batched(
        _lanes_last(M), _lanes_last(O), _lanes_last(R))
    return (_lanes_first(Dinv), _lanes_first(t2), _lanes_first(tR),
            S.permute(2, 0, 1))


def chain_rhs_forward(Dinv, O, tRw, r):
    """Forward-eliminate one rhs column with the stored factors: ``Dinv``,
    ``O`` (B, T, n, n), ``tRw`` (B, T, n, nB), ``r`` (B, T, n).  Returns
    ``(tr (B, T, n), sb (B, nB))`` with sb = sum_i W~_i^T D_i^-1 r~_i."""
    tr, sb = _rhs_forward_batched(_lanes_last(Dinv), _lanes_last(O),
                                  _lanes_last(tRw), _lanes_last(r[..., None]))
    return tr[:, :, 0].permute(2, 0, 1), sb[:, 0].permute(1, 0)


def chain_back_sub(tR, t2, coef):
    """Back-substitution ``x_i = tR_i coef - t2_i x_{i+1}``: ``tR``
    (B, T, n, nC), ``t2`` (B, T, n, n), ``coef`` (B, nC) -> x (B, T, n)."""
    x = _back_substitute_batched(_lanes_last(tR), _lanes_last(t2),
                                 coef.permute(1, 0)[:, None, :].contiguous())
    return x.permute(2, 0, 1)
