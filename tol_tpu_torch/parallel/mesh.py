"""Sharded execution over device meshes (port of
``tol_tpu/parallel/mesh.py``).

The primary axis is scenario data parallelism ("dp"): independent NLP
instances batch along the leading axis, and each rank solves its slice of
the batch on its own device; a secondary axis ("sp") is reserved for
time-axis sharding of very long horizons, as in the JAX package.  The mesh
is a ``torch.distributed.device_mesh.DeviceMesh`` over one rank per device.
The solver sees plain local tensors, never ``DTensor``s: most of the
operations under its ``torch.func`` transforms have no sharding rule, and
the lanes of a batch never talk to each other inside a solve.

Multi-process: join the world with
:func:`tol_tpu_torch.parallel.multihost.init_multihost` before
``make_mesh``; without a world, ``make_mesh`` makes a world of one, so one
device needs no launcher.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from tol_tpu_torch.parallel.multihost import free_port


def _world_of_one(device_type: str) -> None:
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass devices='cpu' to run on the CPU")
        torch.cuda.set_device(torch.cuda.current_device())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)


def make_mesh(n_dp: int | None = None, n_sp: int = 1,
              devices: str | None = None):
    """DeviceMesh with ("dp", "sp") axes over the world's first
    ``n_dp * n_sp`` ranks; defaults to all ranks on "dp".

    ``devices`` is the device type (``"cuda"``, ``"cpu"``): one rank per
    device of that type, where the JAX package takes a list of devices.
    Without it the type follows the world's backend (NCCL: cuda, gloo:
    cpu), and with no world yet it is cuda: a world of one is made (NCCL
    on the card, gloo on the CPU, on a free localhost port), which raises
    without a CUDA device unless asked for the CPU."""
    from torch.distributed.device_mesh import DeviceMesh

    device_type = devices
    if not dist.is_initialized():
        _world_of_one(device_type or "cuda")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if n_dp is None:
        n_dp = dist.get_world_size() // n_sp
    ranks = np.arange(n_dp * n_sp).reshape(n_dp, n_sp)
    return DeviceMesh(device_type, torch.as_tensor(ranks),
                      mesh_dim_names=("dp", "sp"))


def shard_instances(mesh, tree):
    """This rank's slice of every tensor leaf whose leading dimension the
    "dp" size divides (rank r of "dp" takes the r-th of its equal parts);
    every other leaf is replicated, as it is.  With one "dp" rank every
    tensor comes back as it is: no copy, no other dtype or layout."""
    n = mesh.size(mesh.mesh_dim_names.index("dp"))
    r = mesh.get_local_rank("dp")

    def put(x):
        if n == 1 or not isinstance(x, torch.Tensor) or x.dim() == 0 \
                or x.shape[0] % n:
            return x
        k = x.shape[0] // n
        return x[r * k:(r + 1) * k]

    return tree_map(put, tree)


def sharded_batch_solve(mesh, solve_batch, insts, v0s=None):
    """Solve this rank's slice of a batch.

    The port's solver is batch-first, so ``solve_batch(insts, v0s) ->
    result`` solves a whole (B, ...) batch at once, where the JAX package
    vmaps ``solve_one(inst, v0)``.  ``insts`` is a stacked per-lane tree
    with the batch leading (or None; an Instance shared by every lane
    belongs in ``solve_batch``'s closure), ``v0s`` (B, n) or None.  Both are
    cut by :func:`shard_instances`, and the rank's result is returned:
    :func:`tol_tpu_torch.parallel.multihost.global_stats_to_host` gathers
    the global batch.
    """
    if insts is not None:
        insts = shard_instances(mesh, insts)
    if v0s is not None:
        v0s = shard_instances(mesh, v0s)
    return solve_batch(insts, v0s)
