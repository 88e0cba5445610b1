"""How many tensor operations one KKT solve runs, per backend and chain.

    python3 -m tol_tpu_torch.tools.kkt_ops [--ts 100] [--lanes 2]

On the card each operation of a step is a node of its captured graph, so
the count foretells a replay's kernel nodes and, at about a microsecond
or two a node, its time.  Counts the aten operations (views and other
metadata operations excepted) of one ``kkt_solve`` of S10 / tempest in
float32 from the initial point, on the CPU: the structured KKT, and the
condensed KKT with refine=1 on every chain.  The crp and pallas chains
run their CPU twins here, which the card replaces by three launches, so
only the other counts carry over.  ``dual_refine``: one least-squares dual
refinement of the endgame (``dual_refine_k`` = 4, the Jacobian's blocks and
the CG over them) at the same point.

The node blocks run by the ``torch.func`` transforms here; on the card,
under wind models 0 and 1 and the storm's grid at order 2, one launch of
the kernel K9 takes their place
(``ops/nodekern.py``).  ``node_blocks`` counts the transforms' operations
inside every KKT count above (``kkt_prepare``'s node Hessians and defect
Jacobians), ``defect_jac`` those inside ``dual_refine``; beside each launch
the card runs ``kernel_params`` operations, and beside the one in
``kkt_prepare`` also ``node_cost_hess`` and one sum.  Prints one JSON
line.
"""

from __future__ import annotations

import argparse
import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# operations that only make another view of a tensor: no kernel
_METADATA = {"view", "_unsafe_view", "t", "transpose", "expand", "slice",
             "select", "unsqueeze", "squeeze", "as_strided", "alias",
             "diagonal", "permute", "detach", "_reshape_alias", "reshape",
             "lift_fresh"}


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ not in _METADATA:
            self.n += 1
        return func(*args, **(kwargs or {}))


def refine_point(can, lanes: int, k: int = 4):
    """A solver kernel with ``dual_refine_k = k`` at the initial point of
    ``lanes`` lanes, and the arguments of its ``dual_refine`` there."""
    from tol_tpu_torch.solver import alm

    opts = alm.ALMOptions(dual_refine_k=k)
    inst = can.nlp.inst0
    v0 = can.initial_point()[None].repeat(lanes, 1)
    kern = alm.make_kernel(can, None, opts, inst, v0)
    p = alm.ALMParams.from_options(opts, v0.dtype, v0.device)
    st = kern.init_state(p, p, False)
    lb, ub, fixed = can.bounds(inst)
    dl = torch.where((lb > -alm._BIG) & ~fixed, st.v - lb, 1.0)
    du = torch.where((ub < alm._BIG) & ~fixed, ub - st.v, 1.0)
    return kern, (st.v, st.yhat, st.zl, st.zu, dl, du)


def count_ops(fn, *args) -> int:
    """The aten operations (views excepted) one call of ``fn`` runs."""
    mode = _Count()
    with mode:
        fn(*args)
    return mode.n


def count(ts: int = 100, lanes: int = 2) -> dict:
    from tol_tpu_torch.api import make_problem
    from tol_tpu_torch.solver.canonical import canonicalize
    from tol_tpu_torch.solver.kkt_condensed import CHAINS, make_condensed_kkt
    from tol_tpu_torch.solver.kkt_structured import make_structured_kkt

    dt = torch.float32
    can = canonicalize(make_problem("S10", "tempest", ts=ts, wind_model=1,
                                    dtype=dt, device="cpu"))
    gen = torch.Generator().manual_seed(0)
    v = can.initial_point()[None].repeat(lanes, 1)
    args = (v, torch.zeros(lanes, can.m, dtype=dt),
            torch.ones(lanes, can.n, dtype=dt), torch.ones(lanes, dtype=dt),
            torch.full((lanes,), 0.01, dtype=dt),
            torch.randn(lanes, can.n, generator=gen, dtype=dt),
            torch.zeros(lanes, can.m, dtype=dt))
    kkts = {"structured": make_structured_kkt(can)}
    kkts.update({f"condensed_{c}": make_condensed_kkt(can, refine=1, chain=c)
                 for c in CHAINS})
    out = {name: count_ops(kkt, *args) for name, kkt in kkts.items()}
    kern, rargs = refine_point(can, lanes)
    out["dual_refine"] = count_ops(kern.dual_refine, *rargs)
    out.update(node_block_ops(can, v))
    return out


def node_block_ops(can, v) -> dict:
    """The aten operations of the node blocks at the lanes ``v`` by the
    transforms, and of what the card's kernel path runs beside its launch:
    the node cost's closed-form Hessian and the kernel's parameters."""
    from tol_tpu_torch.solver.canonical import constraint_jac_blocks, kernel_args
    from tol_tpu_torch.solver.kkt_condensed import derivative_blocks

    nlp, inst = can.nlp, can.nlp.inst0
    Z, dt, _ = can.split(v)
    y = torch.zeros(v.shape[0], nlp.T, 8, dtype=v.dtype)
    args = kernel_args(can)
    args(inst)          # the affine wind's constants: once per configuration
    return dict(
        node_blocks=count_ops(derivative_blocks(can)[0], Z, dt, y, inst),
        defect_jac=count_ops(constraint_jac_blocks(can)[0], Z, dt, inst),
        node_cost_hess=count_ops(nlp.node_cost_hess, Z, dt[:, None], inst),
        kernel_params=count_ops(args, inst))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ts", type=int, default=100)
    ap.add_argument("--lanes", type=int, default=2)
    a = ap.parse_args()
    print(json.dumps(dict(ts=a.ts, lanes=a.lanes, dtype="float32",
                          aten_ops=count(a.ts, a.lanes))))


if __name__ == "__main__":
    main()
