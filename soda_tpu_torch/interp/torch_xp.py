"""A torch array namespace for the evaluator.

The evaluator (`interp/evaluator.py`, the port's copy of
`soda_tpu/interp/evaluator.py`) builds a stage's computation in whatever
array language `EvalContext.xp` names.  It calls numpy-style functions on
the namespace (`xp.asarray(v, dtype=)`, `xp.floor_divide`, `xp.arctan2`,
...) and `.astype(dtype)` on values, with dtypes that are either the
namespace's own attributes (`xp.int64`) or numpy dtypes
(`ScalarType.np_dtype`, at stage stores).  Torch tensors have no `astype`,
so values are `XTensor`s: a tensor subclass that adds it.

Integers use the oracle's 64-bit accumulator (`int_width=64`), the same
contract as the C++ golden runner's printer (`backend/cpp_gen.py::_Gen`), so
the plain path and the CUDA kernel agree bit for bit on integer programs.
For f32 atan/asin/acos/atan2/sinh/cosh/expm1 the evaluator routes every
non-numpy namespace through the composed formulas of `interp/mathfns.py`;
everything those call is here.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

from ..ir.dtypes import from_numpy_dtype


class XTensor(torch.Tensor):
    """torch.Tensor with numpy's `astype`; torch ops keep the subclass."""

    def astype(self, dtype) -> "XTensor":
        return self.to(from_numpy_dtype(dtype))


def plain(t: torch.Tensor) -> torch.Tensor:
    """Strip the subclass (for results handed back to callers)."""
    return t.as_subclass(torch.Tensor)


class TorchXP:
    """numpy-named functions over tensors on one device."""

    float16 = torch.float16
    float32 = torch.float32
    float64 = torch.float64
    int64 = torch.int64
    uint64 = torch.uint64

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)

    # -- construction -----------------------------------------------------

    def asarray(self, v, dtype=None) -> XTensor:
        dt = None if dtype is None else from_numpy_dtype(dtype)
        if isinstance(v, torch.Tensor):
            t = v
        elif isinstance(v, (np.ndarray, np.generic)):
            a = np.asarray(v)
            if a.ndim:
                a = np.ascontiguousarray(a)
            t = torch.from_numpy(a).to(self.device)
        else:
            # Python scalar: build it in the requested dtype directly (a
            # float64 literal must not round through the default float32)
            t = torch.tensor(v, dtype=dt, device=self.device)
        if dt is not None:
            t = t.to(dt)
        return t.as_subclass(XTensor)

    def _t(self, v) -> XTensor:
        """Operand as a tensor: numpy and Python scalars become 0-d tensors
        (torch treats 0-d tensors like scalars in type promotion)."""
        if isinstance(v, torch.Tensor):
            return v.as_subclass(XTensor)
        if isinstance(v, numbers.Number) and not isinstance(v, np.generic):
            if isinstance(v, bool):
                return self.asarray(v)
            dt = torch.int64 if isinstance(v, numbers.Integral) else torch.float32
            return self.asarray(v, dtype=dt)
        return self.asarray(v)

    # -- elementwise --------------------------------------------------------

    def where(self, c, a, b):
        return torch.where(self._t(c), self._t(a), self._t(b))

    def minimum(self, a, b):
        return torch.minimum(self._t(a), self._t(b))

    def maximum(self, a, b):
        return torch.maximum(self._t(a), self._t(b))

    def floor_divide(self, a, b):
        return torch.floor_divide(self._t(a), self._t(b))

    def left_shift(self, a, b):
        return torch.bitwise_left_shift(self._t(a), self._t(b))

    def right_shift(self, a, b):
        return torch.bitwise_right_shift(self._t(a), self._t(b))

    def bitwise_and(self, a, b):
        return torch.bitwise_and(self._t(a), self._t(b))

    def bitwise_or(self, a, b):
        return torch.bitwise_or(self._t(a), self._t(b))

    def bitwise_xor(self, a, b):
        return torch.bitwise_xor(self._t(a), self._t(b))

    def bitwise_not(self, a):
        return torch.bitwise_not(self._t(a))

    def fmod(self, a, b):
        return torch.fmod(self._t(a), self._t(b))

    def power(self, a, b):
        return torch.pow(self._t(a), self._t(b))

    def copysign(self, a, b):
        return torch.copysign(self._t(a), self._t(b))

    def arctan2(self, a, b):
        return torch.atan2(self._t(a), self._t(b))

    def hypot(self, a, b):
        return torch.hypot(self._t(a), self._t(b))

    def signbit(self, a):
        return torch.signbit(self._t(a))

    def isinf(self, a):
        return torch.isinf(self._t(a))


# one-argument functions under their numpy names
_UNARY = {
    "abs": torch.abs, "sqrt": torch.sqrt, "exp": torch.exp,
    "exp2": torch.exp2, "log": torch.log, "log2": torch.log2,
    "log10": torch.log10, "sin": torch.sin, "cos": torch.cos,
    "tan": torch.tan, "tanh": torch.tanh, "floor": torch.floor,
    "ceil": torch.ceil, "trunc": torch.trunc, "arctan": torch.atan,
    "arcsin": torch.asin, "arccos": torch.acos, "sinh": torch.sinh,
    "cosh": torch.cosh, "expm1": torch.expm1, "log1p": torch.log1p,
}


def _unary(fn):
    def f(self, a):
        return fn(self._t(a))
    return f


for _name, _fn in _UNARY.items():
    setattr(TorchXP, _name, _unary(_fn))
del _name, _fn
