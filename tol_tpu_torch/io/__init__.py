"""Port of ``tol_tpu.io``."""

from tol_tpu_torch.io.params import (
    load_aircraft,
    load_gains,
    load_limits,
    load_solver_dims,
    read_param_file,
)
from tol_tpu_torch.io.results import read_results_json, write_results_json

__all__ = [
    "read_param_file",
    "load_aircraft",
    "load_gains",
    "load_limits",
    "load_solver_dims",
    "write_results_json",
    "read_results_json",
]
