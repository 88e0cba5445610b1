"""Port of ``tol_tpu.io``."""
