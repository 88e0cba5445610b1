"""The port's parallel layer (``tol_tpu_torch/parallel``) on
``torch.distributed`` against tol_tpu's (float64, CPU).

Two ranks of a local gloo world, spawned by the port's ``spawn_ranks``,
run ``_worker``: the counterpart of ``tests/_mh_worker.py`` (the global
sum of each lane's max|c|, against the JAX package's over the same seeds)
and a sharded batch solve of 16 lanes, held against the port's unsharded
solve of the 16 lanes in this process.  The rank-weighted
vote that infers the per-rank batch is held against the JAX function's
choice in this process.
"""

import functools
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

NPROC = 2
PER_RANK = 4          # max|c| seeds per rank
SOLVE_LANES = 16      # lanes of the sharded solve, 8 a rank
# tests/test_parallel.py's numerics
SOLVE_OPTS = dict(tol=1e-5, feas_tol=1e-6, max_iter=400, gamma_init=0.01,
                  mu_init=1e-5, mu_shrink=0.1, dual_refine_k=4)


def _mh_seeds(v0, rank):
    """tests/_mh_worker.py's lanes: 1e-3 N(0, 1) around the initial point,
    decorrelated by rank (numpy noise for both packages)."""
    rng = np.random.default_rng(100 + rank)
    return v0[None] + 0.001 * rng.standard_normal((PER_RANK, v0.shape[0]))


def _solve_seeds(lb, ub, fixed, v0):
    dv = 0.01 * np.random.default_rng(0).standard_normal((SOLVE_LANES,
                                                          v0.shape[0]))
    return np.where(fixed, lb, np.clip(v0 + dv, lb, ub))


def _problem():
    from tol_tpu_torch.api import make_problem
    from tol_tpu_torch.solver.canonical import canonicalize

    return canonicalize(make_problem("S10", "tempest", ts=8, wind_model=1,
                                     device="cpu"), scaling="auto")


def _seed_lanes(can):
    lb, ub, fixed = [x.numpy() for x in can.bounds(can.nlp.inst0)]
    return torch.as_tensor(_solve_seeds(lb, ub, fixed,
                                        can.initial_point().numpy()))


def _solve_batch(can):
    """solve_batch(insts, v0s) of the sharded solve: chain cr, the
    instance shared by every lane."""
    from tol_tpu_torch.solver.alm import ALMOptions, solve
    from tol_tpu_torch.solver.kkt_condensed import make_condensed_kkt

    kkt = make_condensed_kkt(can, refine=1, chain="cr")
    opts = ALMOptions(**SOLVE_OPTS)
    return lambda _, v: solve(can, kkt, opts, v0=v)


def _worker(rank, port, out_dir):
    """One rank: join the world, then the _mh_worker checks and the
    sharded solve; write what the test compares as JSON."""
    from tol_tpu_torch.parallel import (global_psum, global_stats_to_host,
                                        init_multihost, local_batch_to_global,
                                        make_mesh, shard_instances,
                                        sharded_batch_solve)

    torch.set_num_threads(2)
    init_multihost(f"127.0.0.1:{port}", NPROC, rank, cpu_collectives="gloo")
    mesh = make_mesh()               # every rank on "dp", over gloo
    out = dict(rank=rank, mesh=[mesh.size(0), mesh.size(1)],
               device_type=mesh.device_type)

    can = _problem()
    inst = can.nlp.inst0
    v0 = can.initial_point().numpy()
    local = torch.as_tensor(_mh_seeds(v0, rank))
    shared = torch.arange(3.0)
    glob = local_batch_to_global(mesh, {"v": local, "p": shared})
    out["global_v_shape"] = list(glob["v"].shape)
    out["global_v_local_rows"] = bool(torch.equal(
        glob["v"][rank * PER_RANK:(rank + 1) * PER_RANK], local))
    out["shared_as_is"] = glob["p"] is shared
    try:
        local_batch_to_global(mesh, {"v": local, "p": shared + rank})
        out["differing_replicated_leaf_raises"] = False
    except ValueError:
        out["differing_replicated_leaf_raises"] = True

    viols = can.c(local, inst).abs().amax(-1)
    total = global_psum(mesh, viols)
    host = global_stats_to_host(viols)
    out.update(total_hex=float(total).hex(), host_shape=list(host.shape),
               host_sum=float(host.sum()), viols=viols.tolist())

    V = _seed_lanes(can)
    part = shard_instances(mesh, {"v": V, "p": shared})
    k = SOLVE_LANES // NPROC
    out["shard_is_slice"] = bool(torch.equal(part["v"],
                                             V[rank * k:(rank + 1) * k]))
    res = sharded_batch_solve(mesh, _solve_batch(can), None, V)
    out["converged"] = global_stats_to_host(res.converged).tolist()
    out["v"] = res.v.tolist()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks once for the module through ``spawn_ranks``, which
    kills both on a failure or at the timeout (a surviving rank blocks in
    gloo, holding the port), and the port's unsharded solve of the 16
    lanes here meanwhile.  Returns (each rank's record, the unsharded
    result)."""
    from tol_tpu_torch.parallel.multihost import free_port, spawn_ranks

    tmp = str(tmp_path_factory.mktemp("ranks"))
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(spawn_ranks, _worker, NPROC,
                              (free_port(), tmp), 240)
        can = _problem()
        alone = _solve_batch(can)(None, _seed_lanes(can))
        spawned.result()
    res = []
    for r in range(NPROC):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            res.append(json.load(f))
    return res, alone


@functools.lru_cache(maxsize=None)
def _jax_viols():
    """The JAX package's max|c| of the same 8 lanes (rank 0's, then rank
    1's), as tests/_mh_worker.py computes them."""
    import jax
    import jax.numpy as jnp

    from tol_tpu.api import make_problem
    from tol_tpu.solver import canonicalize

    can = canonicalize(make_problem("S10", aircraft="tempest", ts=8,
                                    wind_model=1), scaling="auto")
    v0 = np.asarray(can.initial_point())
    V = np.concatenate([_mh_seeds(v0, r) for r in range(NPROC)])
    c_fn = jax.jit(jax.vmap(lambda v: jnp.max(jnp.abs(
        can.c(v, can.nlp.inst0)))))
    return np.asarray(c_fn(jnp.asarray(V)))


def test_global_psum_matches_jax_on_two_ranks(ranks):
    """The counterpart of tests/_mh_worker.py: both ranks see a 2-rank
    "dp" mesh over gloo, agree on the global sum bit for bit, and the sum
    equals the JAX package's over the same 8 seeds; the gathered lanes
    sum to it too."""
    ranks, _ = ranks
    assert [r["mesh"] for r in ranks] == [[NPROC, 1]] * NPROC
    assert all(r["device_type"] == "cpu" for r in ranks)
    assert ranks[0]["total_hex"] == ranks[1]["total_hex"]
    total = float.fromhex(ranks[0]["total_hex"])
    want = _jax_viols()
    np.testing.assert_allclose(
        np.concatenate([r["viols"] for r in ranks]), want, rtol=1e-12)
    assert abs(total - want.sum()) <= 1e-12 * abs(want.sum())
    for r in ranks:
        assert r["host_shape"] == [NPROC * PER_RANK]
        assert abs(r["host_sum"] - total) <= 1e-12 * abs(total)


def test_local_batch_to_global_on_two_ranks(ranks):
    """The batched leaf is gathered in rank order, the replicated one comes
    back as it is, and a replicated leaf that differs between ranks
    raises."""
    ranks, _ = ranks
    for r in ranks:
        assert r["global_v_shape"] == [NPROC * PER_RANK, 100]
        assert r["global_v_local_rows"] and r["shared_as_is"]
        assert r["differing_replicated_leaf_raises"]


def test_sharded_batch_solve_matches_the_unsharded_solve(ranks):
    """16 S10 lanes (chain cr) sharded over 2 ranks: every lane converges,
    and each rank's lanes equal the port's unsharded solve of them."""
    ranks, alone = ranks
    assert bool(alone.converged.all())
    k = SOLVE_LANES // NPROC
    for r in ranks:
        assert r["shard_is_slice"]
        assert r["converged"] == [True] * SOLVE_LANES
        want = alone.v[r["rank"] * k:(r["rank"] + 1) * k].numpy()
        np.testing.assert_allclose(np.asarray(r["v"]), want, rtol=0,
                                   atol=1e-10 * np.abs(want).max())


# Trees of the vote: (leaf shapes, the local batch chosen); the last is
# ambiguous (a tie at 2 votes each) and raises in both packages.
_TREES = [
    ({"v": (16, 5), "p": (7,)}, 16),
    ({"a": (8, 3, 2), "b": (16,), "c": (16,)}, 8),
    ([(8, 4), (8,), ()], 8),
    ({"x": (16, 2), "y": (8, 2), "z": (8,)}, 8),
    ({"x": (16, 2), "y": (8, 2)}, None),
]


@pytest.mark.parametrize("k", range(len(_TREES)))
def test_local_batch_vote_matches_jax(k):
    """The rank-weighted vote picks the JAX function's batch (read from
    which leaves it shards over "dp" on the 8-device CPU mesh), and both
    raise on the ambiguous tree."""
    import jax
    from jax.sharding import PartitionSpec as P

    from tol_tpu.parallel import make_mesh as jmake_mesh
    from tol_tpu.parallel.multihost import local_batch_to_global as jl2g
    from tol_tpu_torch.parallel.multihost import infer_local_batch

    shapes, want = _TREES[k]
    rng = np.random.default_rng(k)
    tree = jax.tree_util.tree_map(lambda s: rng.standard_normal(s), shapes,
                                  is_leaf=lambda s: isinstance(s, tuple))
    if want is None:
        with pytest.raises(ValueError, match="cannot infer"):
            jl2g(jmake_mesh(), tree)
        with pytest.raises(ValueError, match="cannot infer"):
            infer_local_batch(tree)
        return
    got = infer_local_batch(tree)
    assert got == want
    placed = jl2g(jmake_mesh(), tree)
    jax_batched = [x.sharding.spec == P("dp")
                   for x in jax.tree_util.tree_leaves(placed)]
    port_batched = [np.ndim(x) >= 1 and np.shape(x)[0] == got
                    for x in jax.tree_util.tree_leaves(tree)]
    assert port_batched == jax_batched


@pytest.fixture
def world_of_one():
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def test_mesh_of_one_hands_tensors_back_as_they_are(world_of_one):
    """Without a world, make_mesh(devices="cpu") makes a gloo world of one;
    shard_instances then returns every leaf as it is (the bits of a
    one-rank solve are those of the plain solve), and the reductions are
    local ones."""
    from tol_tpu_torch.parallel import (global_psum, global_stats_to_host,
                                        make_mesh, shard_instances)

    mesh = make_mesh(devices="cpu")
    assert mesh.mesh_dim_names == ("dp", "sp") and mesh.shape == (1, 1)
    x = torch.randn(6, 3, dtype=torch.float64, generator=torch.Generator()
                    .manual_seed(0)).t()          # not contiguous
    tree = shard_instances(mesh, {"x": x, "s": 2.0, "n": None})
    assert tree["x"] is x and tree["s"] == 2.0 and tree["n"] is None
    assert global_psum(mesh, x) == x.sum().item()
    assert np.array_equal(global_stats_to_host(x), x.numpy())

