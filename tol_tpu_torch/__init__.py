"""tol_tpu_torch — the PyTorch/CUDA port of ``tol_tpu``.

Every module here pairs with the module of the same name and place under
``tol_tpu/`` and computes the same thing on torch tensors, batch-first
(lane axis B leading).  The cyclic-reduction level kernels that ``tol_tpu``
writes in Pallas for the TPU are hand-written CUDA C++ for Hopper here
(``tol_tpu_torch/csrc``), each with a plain PyTorch twin beside its wrapper
(``tol_tpu_torch/ops/crkern.py``).

Layout (each the port of the ``tol_tpu`` subpackage of the same name):
    tol_tpu_torch.config     typed config records (ref: include/parameters.h)
    tol_tpu_torch.io         .param / JSON / NetCDF readers-writers
    tol_tpu_torch.models     aircraft dynamics + wind models
    tol_tpu_torch.problems   mission NLP specs G7/S10
    tol_tpu_torch.solver     batched interior-point NLP solver
    tol_tpu_torch.ops        batched small-matrix linear algebra + the CUDA
                             kernels' wrappers (sources in ``csrc/``)
    tol_tpu_torch.parallel   torch.distributed meshes, scenario DP,
                             collectives (NCCL on cards, gloo on the CPU)
    tol_tpu_torch.mission    receding-horizon mission layer
    tol_tpu_torch.utils      checkpoints, profiling, flop counts, the
                             kernels' build directory
    tol_tpu_torch.viz        post-processing plots (matplotlib, imported
                             lazily)
    tol_tpu_torch.tools      on-card measurement tools of the kernels

The package imports torch and numpy (and scipy for the NetCDF storm
reader, matplotlib inside the plotting functions).  Entry points run on
the CUDA device unless the caller passes ``device="cpu"`` (``--device
cpu`` to the CLI, ``python -m tol_tpu_torch``).
"""
