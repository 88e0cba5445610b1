"""Port of ``tol_tpu.problems``."""
