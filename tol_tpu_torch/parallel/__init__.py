"""Port of ``tol_tpu.parallel``."""

from tol_tpu_torch.parallel.mesh import (
    make_mesh,
    shard_instances,
    sharded_batch_solve,
)
from tol_tpu_torch.parallel.multihost import (
    global_psum,
    global_stats_to_host,
    init_multihost,
    local_batch_to_global,
)

__all__ = ["make_mesh", "shard_instances", "sharded_batch_solve",
           "init_multihost", "local_batch_to_global",
           "global_stats_to_host", "global_psum"]
