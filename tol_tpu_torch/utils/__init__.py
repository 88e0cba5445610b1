"""Port of ``tol_tpu.utils``."""

from tol_tpu_torch.utils.checkpoint import load_solution, save_solution
from tol_tpu_torch.utils.profiling import stage_timer, trace

__all__ = ["save_solution", "load_solution", "trace", "stage_timer"]
