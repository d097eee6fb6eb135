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
Full-width uint64 rides an unsigned carrier (`EvalContext.acc_of` asks
for `xp.uint64`): torch implements neither `+` nor `<`, `//` or `>>` for
`torch.uint64`, so the namespace's `uint64` is the token `UINT64` and its
values are `U64`s, the bits in an int64 tensor with C's unsigned meaning
for the operations that depend on the value (compares, `//`, `>>`, min,
max, conversion to float).
For f32 atan/asin/acos/atan2/sinh/cosh/expm1 the evaluator routes every
non-numpy namespace through the composed formulas of `interp/mathfns.py`;
everything those call is here.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

from ..ir.dtypes import bits, from_numpy_dtype


class _DtypeToken:
    """Sentinel dtype of the unsigned 64-bit carrier (compared by identity)."""

    def __repr__(self):
        return "uint64 carrier"


UINT64 = _DtypeToken()
_SIGN = -(1 << 63)       # the sign bit as an int64
_M64 = (1 << 64) - 1


class XTensor(torch.Tensor):
    """torch.Tensor with numpy's `astype`; torch ops keep the subclass."""

    def astype(self, dtype):
        if self.dtype == torch.uint64:
            return U64(bits(self)).astype(dtype)
        if dtype is UINT64:
            # narrower ints extend by their sign as numpy's astype does;
            # floats truncate through int64, as the evaluator's casts do
            return U64(self.to(torch.int64))
        dt = from_numpy_dtype(dtype)
        if dt == torch.uint64:   # uint64 storage: the int64 bits, viewed
            return self.to(torch.int64).view(torch.uint64)
        return self.to(dt)


def _wrap(v: int) -> int:
    """A Python int as the int64 of its low 64 bits."""
    v &= _M64
    return v - (1 << 64) if v >> 63 else v


def _bits_of(v):
    """The int64 bits of an operand of a U64 operation."""
    if isinstance(v, U64):
        return v.t
    if isinstance(v, torch.Tensor):
        return bits(v).to(torch.int64).as_subclass(XTensor)
    if isinstance(v, (bool, np.bool_)):
        return int(v)
    return _wrap(int(v))


def _lt_u(a, b):
    """a < b on unsigned bits: flip the sign bits, compare signed."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _shr_u(a, s):
    """Logical right shift of int64 bits `a` by `s` (numpy's uint64 `>>`:
    0 for amounts of 64 and above)."""
    sc = s.clamp(0, 63)
    out = (a >> sc) & ~((-1 << (63 - sc)) << 1)
    return torch.where((s < 0) | (s > 63), 0, out)


def _to_float_u(a, dtype: torch.dtype):
    """Unsigned int64 bits to a float rounded once, as numpy's uint64
    conversion: values at or above 2^63 convert at half their size with
    the dropped bit kept as a sticky bit, then double (exact)."""
    half = ((a >> 1) & ~_SIGN) | (a & 1)
    return torch.where(a < 0, half.to(dtype) * 2, a.to(dtype))


class U64:
    """A full-width unsigned 64-bit value: its bits in an int64 tensor `t`.
    `+ - * & | ^ <<` and negation are the same bits as in int64; compares,
    `>>`, `//` (`TorchXP.floor_divide`), min, max and conversion to float
    take C's unsigned meaning."""

    __slots__ = ("t",)
    __hash__ = None
    dtype = UINT64

    def __init__(self, t: torch.Tensor):
        self.t = t.as_subclass(XTensor)

    @property
    def shape(self):
        return self.t.shape

    def __getitem__(self, idx):
        return U64(self.t[idx])

    def astype(self, dtype):
        if dtype is UINT64:
            return self
        dt = from_numpy_dtype(dtype)
        if dt == torch.uint64:
            return self.t.view(torch.uint64)
        if dt.is_floating_point:
            if dt == torch.float16:
                # exact below 2^24 in f32, and inf in f16 from 65520 up
                return _to_float_u(self.t, torch.float32).to(dt)
            return _to_float_u(self.t, dt)
        return self.t != 0 if dt == torch.bool else self.t.to(dt)

    def _op(self, other, f):
        return U64(f(self.t, _bits_of(other)))

    def __add__(self, o):
        return self._op(o, lambda a, b: a + b)

    def __sub__(self, o):
        return self._op(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._op(o, lambda a, b: b - a)

    def __mul__(self, o):
        return self._op(o, lambda a, b: a * b)

    def __and__(self, o):
        return self._op(o, lambda a, b: a & b)

    def __or__(self, o):
        return self._op(o, lambda a, b: a | b)

    def __xor__(self, o):
        return self._op(o, lambda a, b: a ^ b)

    __radd__, __rmul__, __rand__, __ror__, __rxor__ = (
        __add__, __mul__, __and__, __or__, __xor__)

    def __neg__(self):
        return U64(-self.t)

    def __invert__(self):
        return U64(~self.t)

    def __lt__(self, o):
        return _lt_u(self.t, _bits_of(o))

    def __gt__(self, o):
        return _lt_u(_bits_of(o), self.t)

    def __le__(self, o):
        return ~_lt_u(_bits_of(o), self.t)

    def __ge__(self, o):
        return ~_lt_u(self.t, _bits_of(o))

    def __eq__(self, o):
        return self.t == _bits_of(o)

    def __ne__(self, o):
        return self.t != _bits_of(o)


def _udiv(a, b):
    """Unsigned a // b on int64 bits (numpy's uint64 floor_divide: 0 for a
    zero divisor).  A divisor of 2^63 or more divides at most once;
    otherwise halve a (logically) so that torch's signed division is
    exact, double the quotient, and correct it once: the remainder then
    lies below 2b."""
    zero, big = b == 0, b < 0
    safe = torch.where(zero | big, 1, b)
    q = (((a >> 1) & ~_SIGN) // safe) << 1
    q = q + (~_lt_u(a - q * safe, safe)).to(torch.int64)
    q = torch.where(big, (~_lt_u(a, b)).to(torch.int64), q)
    return torch.where(zero, 0, q)


def plain(t: torch.Tensor) -> torch.Tensor:
    """Strip the subclass (for results handed back to callers)."""
    return t.as_subclass(torch.Tensor)


class TorchXP:
    """numpy-named functions over tensors on one device."""

    float16 = torch.float16
    float32 = torch.float32
    float64 = torch.float64
    int64 = torch.int64
    uint64 = UINT64

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)

    # -- construction -----------------------------------------------------

    def asarray(self, v, dtype=None) -> XTensor:
        if isinstance(v, U64):
            return v if dtype is None else v.astype(dtype)
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

    def _u(self, v) -> XTensor:
        """The int64 bits of an operand of a U64 operation, as a tensor."""
        b = _bits_of(v)
        return b if isinstance(b, torch.Tensor) else self.asarray(b, dtype=torch.int64)

    # -- elementwise --------------------------------------------------------

    def where(self, c, a, b):
        if isinstance(a, U64) or isinstance(b, U64):
            return U64(torch.where(self._t(c), self._u(a), self._u(b)))
        return torch.where(self._t(c), self._t(a), self._t(b))

    def minimum(self, a, b):
        if isinstance(a, U64) or isinstance(b, U64):
            a, b = self._u(a), self._u(b)
            return U64(torch.where(_lt_u(b, a), b, a))
        return torch.minimum(self._t(a), self._t(b))

    def maximum(self, a, b):
        if isinstance(a, U64) or isinstance(b, U64):
            a, b = self._u(a), self._u(b)
            return U64(torch.where(_lt_u(a, b), b, a))
        return torch.maximum(self._t(a), self._t(b))

    def floor_divide(self, a, b):
        if isinstance(a, U64) or isinstance(b, U64):
            return U64(_udiv(self._u(a), self._u(b)))
        return torch.floor_divide(self._t(a), self._t(b))

    def left_shift(self, a, b):
        if isinstance(a, U64):
            s = self._u(b)
            return U64(torch.where((s < 0) | (s > 63), 0, a.t << s.clamp(0, 63)))
        return torch.bitwise_left_shift(self._t(a), self._t(b))

    def right_shift(self, a, b):
        if isinstance(a, U64):
            return U64(_shr_u(a.t, self._u(b)))
        return torch.bitwise_right_shift(self._t(a), self._t(b))

    def bitwise_and(self, a, b):
        if isinstance(a, U64) or isinstance(b, U64):
            return U64(self._u(a) & self._u(b))
        return torch.bitwise_and(self._t(a), self._t(b))

    def bitwise_or(self, a, b):
        if isinstance(a, U64) or isinstance(b, U64):
            return U64(self._u(a) | self._u(b))
        return torch.bitwise_or(self._t(a), self._t(b))

    def bitwise_xor(self, a, b):
        if isinstance(a, U64) or isinstance(b, U64):
            return U64(self._u(a) ^ self._u(b))
        return torch.bitwise_xor(self._t(a), self._t(b))

    def bitwise_not(self, a):
        if isinstance(a, U64):
            return ~a
        return torch.bitwise_not(self._t(a))

    def abs(self, a):
        if isinstance(a, U64):
            return a  # abs of unsigned is the identity
        return torch.abs(self._t(a))

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
    "sqrt": torch.sqrt, "exp": torch.exp,
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
