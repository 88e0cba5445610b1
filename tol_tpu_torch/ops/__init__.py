"""Port of ``tol_tpu.ops``."""
