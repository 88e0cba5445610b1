"""tol_tpu_torch — the PyTorch/CUDA port of ``tol_tpu``.

Every module here pairs with the module of the same name and place under
``tol_tpu/`` and computes the same thing on torch tensors, batch-first
(lane axis B leading).  The cyclic-reduction level kernels that ``tol_tpu``
writes in Pallas for the TPU are hand-written CUDA C++ for Hopper here
(``tol_tpu_torch/csrc``), each with a plain PyTorch twin beside its wrapper
(``tol_tpu_torch/ops/crkern.py``).

The package imports torch and numpy (and scipy for the NetCDF storm
reader).  Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``--device cpu`` to the CLI, ``python -m
tol_tpu_torch``).
"""
