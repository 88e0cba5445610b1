"""Port of ``tol_tpu.models``."""
