"""The least bytes and operations of the hand kernels K1-K3, and the card's
published peaks: the yardstick of ``kernels.crp_roofline.batch``.

Counts are functions of a launch's shape: ``lanes`` chains of ``n_pad``
11x11 blocks (a power of two; cyclic reduction runs log2(n_pad) levels)
and ``m`` right-hand-side columns.  Each input byte is read once and each
output byte written once, in float32, whatever a kernel reads again.

- K1 ``crp_factor_fwd_pass``: the factor pass over every level with the
  ``m`` border columns eliminated in the same pass, then the root's
  inverse and solution.
- K2 ``crp_fwd_pass``: the forward elimination of ``m`` new columns
  against a factor, then the root solution.
- K3 ``crp_bwd_pass``: the back-substitution of ``m`` columns.

In a factor + solve (K1 then K3) both run at the border width; every other
K2 and K3 launch of the condensed KKT solves one column (m = 1).
"""

from __future__ import annotations

NB = 11                    # node block size
FL = 4                     # bytes per float32
HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet: HBM3 bandwidth
FP32_FLOP_PER_S = 67e12    # and float32 peak outside the tensor cores

# the profiler's names of the kernels' __global__ functions
SYMBOLS = {"K1": "factor_fwd_pass_kernel", "K2": "fwd_pass_kernel",
           "K3": "bwd_pass_kernel"}


def _levels(n_pad: int) -> list:
    out, h = [], n_pad // 2
    while h >= 1:
        out.append(h)
        h //= 2
    return out


def k1(lanes: int, n_pad: int, m: int) -> tuple:
    """(bytes, flops) of one K1 launch."""
    n3, n2, tri = NB ** 3, NB ** 2, NB * (NB + 1) // 2
    lv = _levels(n_pad)
    cols, blocks = sum(lv) * lanes, sum(lv)
    factor = 2 * n3 // 6 + 2 * n3 + 10 * n3
    root = 2 * n3 // 6 + 2 * n3
    nbytes = lanes * FL * (n_pad // 2 * (tri + n2) + n_pad * (n2 + NB * m)
                           + blocks * (3 * n2 + NB * m) + n2 + NB * m)
    flops = cols * (factor + 6 * n2 * m) + lanes * (root + 2 * n2 * m)
    return nbytes, flops


def k2(lanes: int, n_pad: int, m: int) -> tuple:
    n2 = NB ** 2
    lv = _levels(n_pad)
    cols, blocks = sum(lv) * lanes, sum(lv)
    nbytes = lanes * FL * (blocks * 3 * n2 + n2 + n_pad * NB * m
                           + blocks * NB * m + NB * m)
    return nbytes, cols * 6 * n2 * m + lanes * 2 * n2 * m


def k3(lanes: int, n_pad: int, m: int) -> tuple:
    n2 = NB ** 2
    lv = _levels(n_pad)
    cols, blocks = sum(lv) * lanes, sum(lv)
    nbytes = lanes * FL * (blocks * (3 * n2 + NB * m) + NB * m + n_pad * NB * m)
    return nbytes, cols * 6 * n2 * m


def bound_s(count: tuple) -> float:
    """Least seconds of a launch: bytes over bandwidth or operations over
    the float32 peak, whichever is larger."""
    nbytes, flops = count
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)


def launches_bound_s(n1: int, n2: int, n3: int, lanes: int, n_pad: int,
                     border: int) -> float:
    """Least seconds of ``n1`` K1, ``n2`` K2 and ``n3`` K3 launches of one
    condensed KKT: each K1 and one K3 per K1 at the border width, the rest
    at one column."""
    return (n1 * (bound_s(k1(lanes, n_pad, border))
                  + bound_s(k3(lanes, n_pad, border)))
            + n2 * bound_s(k2(lanes, n_pad, 1))
            + max(n3 - n1, 0) * bound_s(k3(lanes, n_pad, 1)))
