"""Multi-process execution over ``torch.distributed`` (port of
``tol_tpu/parallel/multihost.py``).

Each process is one rank and drives one device: NCCL joins the ranks on
CUDA cards, gloo on the CPU (the smoke clusters of the tests).  Nothing in
the solver changes between one rank and many; these helpers cover process
bring-up and the rank-local <-> global conversion at the mission boundary
(loading instances per rank, gathering Monte-Carlo statistics).  Tensors
stay plain local tensors: the collectives here move them, and the mesh
(:mod:`tol_tpu_torch.parallel.mesh`) carries the topology.

NCCL with more than one rank is unverified: the one-card machine it was
tested on runs a world of one, and the multi-rank paths are tested over
gloo on the CPU.
"""

from __future__ import annotations

import socket
import time
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves, tree_map


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   cpu_collectives: str | None = None) -> None:
    """Join this process into a ``torch.distributed`` world of
    ``num_processes`` ranks as rank ``process_id``; ``coordinator`` is the
    ``host:port`` of rank 0's store.

    ``cpu_collectives="gloo"`` joins over gloo on the CPU; without it the
    backend is NCCL, and the rank first makes its own card the current
    device (the hand-written kernels launch on the current device's
    stream).  Raises without a CUDA device unless asked for the CPU."""
    if cpu_collectives is not None:
        if cpu_collectives != "gloo":
            raise ValueError(f"unknown CPU collectives {cpu_collectives!r}")
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass "
                               "cpu_collectives='gloo' to run on the CPU")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
        backend = "nccl"
    dist.init_process_group(backend, init_method="tcp://" + coordinator,
                            world_size=num_processes, rank=process_id)


def free_port() -> int:
    """A TCP port free on 127.0.0.1 now (for a local world's store)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(fn, nprocs: int, args: tuple, timeout: float) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned processes on this host
    (each one rank of a local world); raise if one fails, and kill every
    one still running on a failure or after ``timeout`` seconds: a
    surviving rank blocks in its collectives, holding the store's port."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def _comm_device(group=None) -> torch.device:
    """Where a collective of ``group`` takes its tensors."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_gather_cat(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes), concatenated along axis 0 in rank
    order (a 0-d ``x`` counts as shape (1,)), on the collective's device."""
    t = x.detach().to(_comm_device(group))
    dtype = t.dtype
    if dtype == torch.bool:       # gloo has no bool collectives
        t = t.to(torch.uint8)
    t = t.reshape(1) if t.dim() == 0 else t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts).to(dtype)


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def infer_local_batch(tree) -> int | None:
    """The per-rank batch of ``tree`` by the JAX package's rank-weighted
    vote over leading dimensions (each leaf votes for its leading dimension
    with weight = its rank), or None when no leaf has an axis.

    Raises ``ValueError`` when the leading dimensions are mixed and the
    winner has no majority of the votes."""
    shapes = [_shape(x) for x in tree_leaves(tree) if x is not None]
    counts = Counter()
    for s in shapes:
        if len(s) >= 1:
            counts[s[0]] += len(s)   # rank-weighted vote
    if not counts:
        return None
    top = counts.most_common()
    local_batch = max(d for d, c in top if c == top[0][1])
    if len(counts) > 1:
        # Mixed leading dims: the weighted vote can still be wrong for
        # exotic trees, so require an unambiguous majority before trusting it.
        others = sum(c for d, c in counts.items() if d != local_batch)
        if counts[local_batch] <= others:
            raise ValueError(
                "local_batch_to_global: cannot infer the per-process "
                f"batch dim (rank-weighted leading-dim votes: "
                f"{dict(counts)}); pass local_batch= explicitly")
    return local_batch


def local_batch_to_global(mesh, tree, local_batch: int | None = None):
    """Assemble the ranks' batch shards into the global batch on every rank.

    A leaf whose leading dimension is ``local_batch`` (inferred by
    :func:`infer_local_batch` when None) is gathered over the mesh's "dp"
    ranks and concatenated along axis 0 in rank order.  Every other leaf
    must be equal on all ranks (``ValueError`` otherwise) and is returned
    as it is."""
    group = mesh.get_group("dp")
    if local_batch is None:
        local_batch = infer_local_batch(tree)

    def put(x):
        if x is None:
            return None
        t = torch.as_tensor(x)
        if local_batch is not None and t.dim() >= 1 \
                and t.shape[0] == local_batch:
            return _all_gather_cat(t, group).to(t.device)
        parts = _all_gather_cat(t, group).reshape(-1, *t.shape)
        if not all(torch.equal(p, parts[0]) for p in parts[1:]):
            raise ValueError("local_batch_to_global: a replicated leaf of "
                             f"shape {tuple(t.shape)} differs between ranks")
        return x

    return tree_map(put, tree)


def global_stats_to_host(tree):
    """Every rank's leaves gathered onto every rank as host numpy arrays,
    concatenated along axis 0 in rank order: the global batch axis of
    rank-local results (a 0-d leaf gives one entry per rank)."""
    return tree_map(lambda x: None if x is None else
                    _all_gather_cat(torch.as_tensor(x)).cpu().numpy(), tree)


def global_psum(mesh, x, axis: str = "dp"):
    """Sum of every element of every rank's ``x`` over the mesh axis
    ``axis``: one all-reduce of the local sums.  Returns the same numpy
    scalar on every rank."""
    group = mesh.get_group(axis)
    tot = torch.as_tensor(x).sum().reshape(1).to(_comm_device(group))
    dist.all_reduce(tot, op=dist.ReduceOp.SUM, group=group)
    return tot.cpu().numpy()[0]
