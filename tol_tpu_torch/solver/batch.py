"""Grouped batch solving with straggler drain (port of
``tol_tpu/solver/batch.py``).

A large scenario batch runs as independent ``group_size``-lane groups, each
to a runtime iteration cap; the unconverged stragglers are then gathered
into ``drain_size``-lane chunks that resume exactly (ALMState handoff) and
finish the full per-lane budget.  With ``dive_opts`` each group runs the
two-body program: a fixed-length exploration dive (``dive_opts`` /
``dive_kkt``), :func:`phase_switch_state`, then the endgame.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from tol_tpu_torch.solver.alm import (ALMOptions, ALMParams, ALMState, Phase1,
                                      phase_switch_state, solve as alm_solve)
from tol_tpu_torch.solver.canonical import CanonicalNLP


class GroupedResult(NamedTuple):
    """Merged per-lane results (host numpy) + executed-iteration tally."""

    converged: np.ndarray
    constr_viol: np.ndarray
    f: np.ndarray
    iterations: np.ndarray
    kkt_err: np.ndarray
    v: np.ndarray
    group_iters: int       # sum over groups of the max executed iteration
    drain_iters: int       # sum over drain chunks of extra iterations


_FIELDS = ("converged", "constr_viol", "f", "iterations", "kkt_err", "v")


def make_grouped_solver(can: CanonicalNLP, kkt_solve: Callable,
                        opts: ALMOptions, group_size: int = 256,
                        drain_size: int = 128,
                        dive_opts: ALMOptions | None = None,
                        dive_kkt: Callable | None = None) -> Callable:
    """Build the grouped solver.  Returns

        solve(group_insts, insts, v0s, p1, p2, p2_drain, n1, exit_df)
            -> GroupedResult

    ``group_insts``: one Instance per ``group_size`` slice of ``v0s``
    (N, n); ``insts``: the per-lane Instances (a sequence of N, or None for
    ``group_insts[i // group_size]``).  The unconverged lanes drain in
    chunks of ``drain_size`` in index order, whatever their Instances.  ``p1``/``p2`` are the dive/endgame params
    (``p2.max_iter`` = the group cap), ``p2_drain`` the drain params
    (``max_iter`` = the full per-lane budget).  In the two-body program the
    dive runs exactly ``n1`` iterations and ``exit_df`` is ignored.
    """
    GB, DB = group_size, drain_size
    two_body = dive_opts is not None
    kkt_dive = dive_kkt if dive_kkt is not None else kkt_solve

    def run_dive(inst, v0s, p1, p2, n_max):
        p1d = p1._replace(max_iter=n_max)
        out = alm_solve(can, kkt_dive, dive_opts, inst=inst, v0=v0s,
                        params=p1d, keep_state=True)
        return phase_switch_state(can, out.state, p2, inst)

    def run_end(inst, st, p2):
        return alm_solve(can, kkt_solve, opts, inst=inst, params=p2,
                         state0=st, keep_state=True)

    def run_group(inst, v0s, p1, p2, n_max, exit_df):
        if two_body:
            return run_end(inst, run_dive(inst, v0s, p1, p2, n_max), p2)
        ph = Phase1(params=p1, n_max=n_max, exit_df=exit_df, patience=3)
        return alm_solve(can, kkt_solve, opts, inst=inst, v0=v0s, params=p2,
                         phase1=ph, keep_state=True)

    def run_drain(inst, st, p1, p2, n_max, exit_df):
        ph = Phase1(params=p1, n_max=n_max, exit_df=exit_df, patience=3)
        return alm_solve(can, kkt_solve, opts, inst=inst, params=p2,
                         phase1=ph, state0=st)

    def solve(group_insts: Sequence, insts, v0s, p1: ALMParams,
              p2: ALMParams, p2_drain: ALMParams, n1, exit_df) -> GroupedResult:
        n = v0s.shape[0]
        if n != len(group_insts) * GB:
            raise ValueError(f"{n} lanes != {len(group_insts)} groups x {GB}")
        if insts is None:
            insts = [group_insts[i // GB] for i in range(n)]
        dev = v0s.device
        n_max = torch.tensor(n1, dtype=torch.int32, device=dev)
        xdf = torch.tensor(exit_df, dtype=v0s.dtype, device=dev)
        outs = [run_group(gi, v0s[g * GB:(g + 1) * GB], p1, p2, n_max, xdf)
                for g, gi in enumerate(group_insts)]
        conv, viol, fs, its, kks, vs = [
            torch.cat([getattr(o, k) for o in outs]).cpu().numpy()
            for k in _FIELDS]
        fs = fs.astype(np.float64)
        group_iters = sum(int(np.max(its[g * GB:(g + 1) * GB]))
                          for g in range(len(outs)))
        cap1 = int(p2.max_iter)
        drain_iters = 0
        idx = np.flatnonzero(~conv)
        if len(idx):
            states = ALMState(*[torch.cat(xs) for xs in
                                zip(*[o.state for o in outs])])
            # Chunks of DB unconverged lanes in index order, as the
            # reference takes them.  A chunk runs one padded drain per
            # Instance object among its lanes: a lane's result does not
            # depend on the lanes beside it (converged lanes are frozen by
            # mask, the exit check is per lane).
            for k0 in range(0, len(idx), DB):
                sel = idx[k0:k0 + DB]
                runs: dict = {}
                for i in sel:
                    runs.setdefault(id(insts[i]), (insts[i], []))[1].append(i)
                for inst, lanes in runs.values():
                    # Pad to DB lanes with the run's first lane (read back:
                    # its own lanes only).
                    pad = np.asarray(lanes + [lanes[0]] * (DB - len(lanes)))
                    pad_t = torch.as_tensor(pad, device=dev)
                    sti = ALMState(*[x[pad_t] for x in states])
                    od = run_drain(inst, sti, p1, p2_drain, n_max, xdf)
                    m = len(lanes)
                    own = pad[:m]
                    d = [getattr(od, k)[:m].cpu().numpy() for k in _FIELDS]
                    (conv[own], viol[own], fs[own], its[own], kks[own],
                     vs[own]) = d
                drain_iters += max(0, int(its[sel].max()) - cap1)
        return GroupedResult(conv, viol, fs, its, kks, vs, group_iters,
                             drain_iters)

    solve.run_group = run_group
    return solve
