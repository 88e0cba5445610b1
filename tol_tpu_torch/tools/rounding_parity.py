"""Do two checkouts' chain kernels compute the same bits?

    python3 -m tol_tpu_torch.tools.rounding_parity OTHER_TREE [--seed 0]

``OTHER_TREE`` is another checkout of this repository, for example an
earlier commit unpacked with ``git archive <commit> | tar -x -C build/other``
(``build/`` is ignored by git).  Each tree's ``crp_factor_solve`` (here K1,
then K3) and ``crp_solve`` (here K2, then K3; in a tree whose K2 runs one
launch per level, those and a K4 launch in either solve) run on the same
seeded chains at the S10 solve's shapes: 128 lanes of 100 blocks padded to
128 (7 CR levels), 12 border columns and one solve column, and each
tree's ``crp_factor`` (here K5, one launch; in a tree that factors level
by level, K5 per level and K4) on the same chains: every level's Minv, OL,
OR and the root inverse.  Then each tree's sequential-chain kernels run on
seeded chains of the same length: K6 (``chain_factor``: Dinv, t2, tR, S)
and K7 (``chain_rhs_forward``: tr, sb) at S10's and G7's border widths 12
and 14, K7 on the factor of the plain twin of K6, and K8
(``chain_back_sub``: x) at 13 and 15, on operands of their own.  Each tree runs twice, in a process of its own: built with nvcc's
default, which may fuse a product and a sum into one FMA, and built with
``-fmad=false``, which rounds every product and every sum.  For each pair
of runs the script prints, per output, how many entries differ in their
bits and by how much.

Where both trees' kernels evaluate the same expressions in the same order,
their ``-fmad=false`` builds agree bit for bit, and any difference between
their default builds comes from where nvcc chose to fuse.  Needs a CUDA
device and nvcc; prints the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
B, T, NB, M_BORDER = 128, 100, 11, 12


def _inputs(seed):
    """B diagonally dominant SPD block-tridiagonal chains of T blocks
    (last coupling cut), their border columns F and one solve column f."""
    rng = np.random.default_rng(seed)
    A = 0.3 * rng.normal(size=(B, T, NB, NB))
    M = A @ np.swapaxes(A, -1, -2) + 4.0 * np.eye(NB)
    O = 0.1 * rng.normal(size=(B, T, NB, NB))
    O[:, -1] = 0.0
    F = rng.normal(size=(B, T, NB, M_BORDER))
    f = rng.normal(size=(B, T, NB, 1))
    return [np.ascontiguousarray(a, dtype=np.float32) for a in (M, O, F, f)]


def _chain_inputs(seed, nC):
    """K6's operands, batch-last: B SPD chains of T blocks with nC border
    columns; K8's: tR (nC + 1 columns), a contracting t2 and coef."""
    rng = np.random.default_rng(seed + nC)
    A = 0.3 * rng.normal(size=(B, T, NB, NB))
    M = A @ np.swapaxes(A, -1, -2) + 4.0 * np.eye(NB)
    O = 0.1 * rng.normal(size=(B, T, NB, NB))
    O[:, -1] = 0.0
    R = rng.normal(size=(B, T, NB, nC))
    tR = rng.normal(size=(T, NB, nC + 1, B))
    t2 = 0.1 * rng.normal(size=(T, NB, NB, B))
    coef = rng.normal(size=(nC + 1, 1, B))
    last = lambda x: np.moveaxis(x, 0, -1)
    return [np.ascontiguousarray(a, dtype=np.float32)
            for a in (last(M), last(O), last(R), tR, t2, coef)]


def _worker(tree, fmad, seed, save):
    """Solve in ``tree``'s port and save the factor and both solutions, and
    the chain kernels' outputs."""
    sys.path.insert(0, tree)
    import torch

    from tol_tpu_torch.ops import _build
    from tol_tpu_torch.ops import chainkern as ch
    from tol_tpu_torch.ops import crkern as ck
    if not os.path.abspath(ck.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {ck.__file__}, not the port of {tree}")
    if not fmad:
        _build.NVCC_FLAGS = (*_build.NVCC_FLAGS, "-fmad=false")
    M, O, F, f = (torch.as_tensor(a, device="cuda") for a in _inputs(seed))
    levels, root_inv, X = ck.crp_factor_solve(M, O, F)
    n_pad = X.shape[1]
    x = ck.crp_solve(levels, root_inv, ck.crp_pad_rhs(f, n_pad))
    torch.cuda.synchronize()
    out = {f"minv_level_{l}": lv[0] for l, lv in enumerate(levels)}
    out.update(root_inv=root_inv, X=X, x=x)
    levels, root_inv = ck.crp_factor(M, O)
    for l, lv in enumerate(levels):
        for name, t in zip(("minv", "ol", "or"), lv):
            out[f"crp_factor_{name}_level_{l}"] = t
    out["crp_factor_root_inv"] = root_inv
    for nC in (12, 14):
        M, O, R, tR, t2, coef = (torch.as_tensor(a, device="cuda")
                                 for a in _chain_inputs(seed, nC))
        for name, t in zip(("Dinv", "t2", "tR", "S"),
                           ch._factor_eliminate_batched(M, O, R)):
            out[f"chain_{name}_{nC}"] = t
        Dinv, _, tRw, _ = ch.factor_eliminate_plain(M, O, R)
        r = torch.as_tensor(np.random.default_rng(seed + 2 * nC).normal(
            size=(T, NB, 1, B)).astype(np.float32), device="cuda")
        for name, t in zip(("tr", "sb"),
                           ch._rhs_forward_batched(Dinv, O, tRw, r)):
            out[f"chain_{name}_{nC}"] = t
        out[f"chain_x_{nC + 1}"] = ch._back_substitute_batched(tR, t2, coef)
    torch.cuda.synchronize()
    np.savez(save, **{k: v.cpu().numpy() for k, v in out.items()})


def _differ(name, a, b):
    """Entries whose bits differ, the largest difference (absolute and over
    the max-norm of ``b``) and, for the solutions (B, n_pad, 11, m), the
    chain blocks that hold a differing entry."""
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {a.shape} and {b.shape}")
    differ = a.view(np.uint32) != b.view(np.uint32)
    diff = np.abs(a.astype(np.float64) - b)
    out = dict(entries=int(a.size), bits_differ=int(differ.sum()),
               max_abs=float(diff.max()),
               max_rel=float(diff.max() / max(np.abs(b).max(), 1e-30)))
    if name in ("X", "x"):
        out["blocks_differ"] = np.flatnonzero(
            differ.any(axis=(0, 2, 3))).tolist()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?", help="the other checkout's root")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "rounding_parity"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--fmad", choices=("on", "off"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        _worker(os.path.abspath(args.worker), args.fmad == "on", args.seed,
                os.path.join(args.out, f"{args.fmad}.npz"))
        return 0
    if not args.other:
        ap.error("name the other checkout")
    import torch
    if not torch.cuda.is_available():
        print("rounding_parity: no CUDA device", file=sys.stderr)
        return 2
    runs = {}
    for tree_name, tree in (("this", ROOT), ("other", os.path.abspath(args.other))):
        for fmad in ("on", "off"):
            out = os.path.join(args.out, tree_name)
            os.makedirs(out, exist_ok=True)
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker", tree, "--fmad", fmad, "--seed",
                            str(args.seed), "--out", out], check=True)
            with np.load(os.path.join(out, f"{fmad}.npz")) as z:
                runs[f"{tree_name}_fmad_{fmad}"] = dict(z)
    for a, b in (("this_fmad_off", "other_fmad_off"),
                 ("this_fmad_on", "other_fmad_on"),
                 ("this_fmad_on", "this_fmad_off"),
                 ("other_fmad_on", "other_fmad_off")):
        if runs[a].keys() != runs[b].keys():
            raise ValueError(f"{a} and {b} return different outputs")
        print(json.dumps(dict(
            runs=[a, b], seed=args.seed,
            outputs={k: _differ(k, runs[a][k], runs[b][k])
                     for k in runs[a]})),
            flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
