"""Port of ``tol_tpu.solver``."""
