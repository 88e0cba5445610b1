"""FLOP accounting / utilization reporting (port of
``tol_tpu/utils/flops.py``).

``program_flops`` runs one call of a function under a
``TorchDispatchMode`` and counts the flops of the aten operations it
runs by the convention of XLA's cost analysis, which the JAX package
reads: a matrix product (``mm``, ``bmm``, ``addmm``, ...) is 2·m·n·k, an
element-wise arithmetic operation (add, multiply, divide, compare, select,
min/max, abs, ...) is one flop per output element, a reduction is n − 1
per output (a mean adds its division), and transcendentals (exp, log,
sqrt, pow, tanh, ...) count none.  Data movement (views, copies, casts,
indexing, concatenation) counts none, and so do library factorizations
(Cholesky, triangular solves, inverses) and the hand-written CUDA kernels
of ``ops/``, which no aten operation covers: XLA's analysis counts none
for a custom call either.  The mode sits below ``torch.func``'s transforms,
so it sees the unwrapped operations that a ``jvp``, ``vjp`` or ``grad``
really runs.  Products with a tangent that forward mode materializes as
zeros, and sums with one, are not counted: XLA's simplifier removes them
before its analysis.  A tensor is known zero from its creation
(``zeros``, ...) until an operation writes into it or into a view of it
(``copy_``, ``index_put_``, ``add_`` through a slice, an ``out=``
argument): a buffer filled in place counts in full.

Unlike XLA's analysis of a while loop, which counts the body once, this
counts every operation the call runs, so a solver program is counted one
step at a time (pass the step function).  Where both packages run the
same operations, this count equals XLA's analysis of the module as
lowered; the JAX package reads the compiled module, whose fusions
recompute a producer in each consumer and count every copy, so its
figure can be higher.

``peak_flops`` maps the card's name to its published dense BF16 peak.  The
solver runs in true float32 (TF32 off), which the card's tensor cores do
not run at that rate at all, so the share of this peak is the
conventional utilization denominator, not a roofline.
"""

from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA data sheets, dense BF16 tensor-core peak per GPU (half the
# figure quoted with sparsity): H100 SXM5 1,979 TFLOPS, H100 PCIe 1,513,
# H100 NVL 1,671 with sparsity.  Keyed by torch.cuda.get_device_name.
_PEAKS = {
    "NVIDIA H100 80GB HBM3": 989.5e12,   # H100 SXM5
    "NVIDIA H100 PCIe": 756.5e12,
    "NVIDIA H100 NVL": 835.5e12,
}

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
           "vdot", "matmul", "_addmm_activation"}
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "sign", "sgn",
    "maximum", "minimum", "fmax", "fmin", "clamp", "clamp_min", "clamp_max",
    "where", "lt", "le", "gt", "ge", "eq", "ne", "logical_and", "logical_or",
    "logical_not", "logical_xor", "bitwise_and", "bitwise_or", "bitwise_not",
    "bitwise_xor", "reciprocal", "square", "floor", "ceil", "round", "trunc",
    "fmod", "remainder", "copysign", "isnan", "isinf", "isfinite",
    "nan_to_num", "heaviside", "masked_fill", "relu", "hardtanh"}
_TWO_PER_ELEMENT = {"addcmul", "addcdiv", "lerp"}
_REDUCTIONS = {"sum", "amax", "amin", "max", "min", "prod", "any", "all",
               "argmax", "argmin", "nansum", "logsumexp"}
# The creators of zeros; the operations whose output is zero where their
# first operand is (views, copies, negation); the products, zero where
# either factor is; the sums, which a zero term makes no work.
_ZERO_CREATORS = {"zeros", "zeros_like", "new_zeros", "_efficientzerotensor"}
_ZERO_VIEWS = {"expand", "alias", "view", "_unsafe_view", "reshape", "t",
                    "transpose", "permute", "squeeze", "unsqueeze", "slice",
                    "select", "clone", "contiguous", "_to_copy", "detach",
                    "lift_fresh", "expand_copy", "as_strided", "flatten",
                    "unflatten", "narrow", "movedim", "diagonal", "unfold",
                    "repeat", "_reshape_alias", "view_copy", "_conj",
                    "neg"}
_PRODUCTS = {"mul", "mm", "bmm", "mv", "dot", "vdot", "matmul"}
_SUMS = {"add", "sub", "rsub"}
_ZERO_MARK = "_program_flops_zero"   # attribute set on a known-zero tensor


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else 1


def _storage(x):
    """The address of ``x``'s storage, which its views share (None for a
    tensor without one)."""
    try:
        ptr = x.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        return None
    return ptr or None


def _matmul_flops(name, args, out) -> float:
    """2·m·n·k of the product (plus one per output element for the
    accumulate of the add- forms)."""
    if name in ("addmm", "_addmm_activation", "baddbmm", "addbmm", "addmv"):
        a, b = args[1], args[2]
        add = _numel(out)
    else:
        a, b = args[0], args[1]
        add = 0
    k = a.shape[-1]
    if name == "addbmm":
        return 2.0 * _numel(a) * b.shape[-1] + add
    return 2.0 * _numel(out) * k + add if out.dim() else 2.0 * k


class _FlopCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self._marked = {}       # id -> weakref of each tensor marked zero

    @staticmethod
    def _is_zero(x) -> bool:
        return getattr(x, _ZERO_MARK, False) or x._is_zerotensor()

    def _mark_zero(self, x):
        setattr(x, _ZERO_MARK, True)
        self._marked[id(x)] = weakref.ref(x)

    def _clear_written(self, func, args, kwargs):
        """Unmark every marked tensor whose storage ``func`` writes into
        (its in-place and ``out=`` arguments, by its schema)."""
        written = []
        for i, arg in enumerate(func._schema.arguments):
            if arg.alias_info is None or not arg.alias_info.is_write:
                continue
            val = args[i] if i < len(args) else kwargs.get(arg.name)
            vals = val if isinstance(val, (list, tuple)) else (val,)
            written += [_storage(v) for v in vals
                        if isinstance(v, torch.Tensor)]
        written = {w for w in written if w is not None}
        if not written:
            return
        for key, ref in list(self._marked.items()):
            x = ref()
            if x is None:
                del self._marked[key]
            elif _storage(x) in written:
                setattr(x, _ZERO_MARK, False)
                del self._marked[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__.rstrip("_")
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        zero_in = [self._is_zero(a) for a in tensors]
        self._clear_written(func, args, kwargs)
        first = out[0] if isinstance(out, (tuple, list)) and out else out
        if not isinstance(first, torch.Tensor):
            return out
        # forward mode's zero tangents: no work, and zeros downstream
        if (name in _ZERO_CREATORS
                or (name in _ZERO_VIEWS and any(zero_in[:1]))
                or (name in _PRODUCTS and any(zero_in[:2]))):
            self._mark_zero(first)
            return out
        if name in _SUMS and any(zero_in[:2]):
            return out
        if name in _MATMUL:
            self.flops += _matmul_flops(name, args, first)
        elif name in _ELEMENTWISE:
            self.flops += first.numel()
        elif name in _TWO_PER_ELEMENT:
            self.flops += 2 * first.numel()
        elif name in _REDUCTIONS and tensors:
            self.flops += max(0, tensors[0].numel() - first.numel())
        elif name == "mean" and tensors:
            self.flops += tensors[0].numel()
        elif name == "linalg_vector_norm" and tensors:
            n = tensors[0].numel()
            self.flops += 2 * n - first.numel()
        return out


def program_flops(fn, *args, **kwargs) -> float:
    """Flops of one call ``fn(*args, **kwargs)`` by XLA's cost-analysis
    convention (see the module docstring).  The call really runs."""
    counter = _FlopCounter()
    with counter:
        fn(*args, **kwargs)
    return float(counter.flops)


def peak_flops(device=None) -> float | None:
    """Published dense BF16 peak of the CUDA card ``device`` (default: the
    current one), or None on the CPU and for a card not in the table."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return _PEAKS.get(torch.cuda.get_device_name(device))
