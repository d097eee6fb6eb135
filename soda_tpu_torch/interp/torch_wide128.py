"""Integers of 65 to 128 bits as quad-limb vectors over torch: the plain
path's counterpart of `Wide128XP(jnp)` on `soda_tpu`'s XLA path.

The same design as `interp/wide128.py` (the port's copy of the original,
over numpy): a value class `V` (rep "p" a plain tensor, "i"/"u" a 128-bit
limb vector, two's complement) and a numpy-like namespace `Wide128XP`
that the shared evaluator walks unchanged at `int_width=128`.  Every limb
operation is the original's, step for step: add and subtract by carry
chains, the schoolbook product, compares, bitwise operations, shifts by a
constant and by 8 conditional power-of-two steps, and the 128-step
restoring long division.

Limbs.  Torch has no uint32 or uint64 arithmetic, so the original's
uint32 limbs with uint64 partial products cannot run as they are.  Here a
limb is a 32-bit value held in an int64 tensor, in [0, 2^32): a sum of
two limbs and a carry fits (below 2^33); a product of two limbs may pass
2^63, but int64 multiplication keeps its 64 bits in two's complement, so
its low half is `p & M32` and its high half `(p >> 32) & M32`, and the
column sums of the product (at most four low halves, three high halves
and a carry, below 2^35) fit as well.  So the limbs equal the original's
value for value (`tests/test_torch_wide.py`).  8 x 16-bit limbs would
keep every product positive, at twice the limbs and twice the operations
of every step.

The long division is 128 steps of a few dozen tensor operations each:
on the card it is many small launches, the cost of this path (PERF.md).

At the boundary a value is a (..., 2) tensor of 64-bit words, low word
first (`from_pairs`, `to_pairs`): the golden runner's 16-byte layout.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ir.dtypes import bits, from_numpy_dtype
from .torch_xp import TorchXP, XTensor
from .wide128 import INT128, NL, UINT128  # the carriers' dtype tokens

M32 = 0xFFFFFFFF
_TOP = 0x80000000


class V:
    """A plain tensor (rep "p"), or a 128-bit limb vector (rep "i" or "u":
    NL int64 tensors of 32-bit limbs, little-endian, two's complement)."""

    __slots__ = ("rep", "l", "xp")
    __hash__ = None

    def __init__(self, rep: str, l, xp: TorchXP):
        self.rep = rep
        self.l = l
        self.xp = xp

    @staticmethod
    def plain(x, xp: TorchXP) -> "V":
        return V("p", x, xp)

    @staticmethod
    def from_int_scalar(v: int, rep: str, xp: TorchXP) -> "V":
        v &= (1 << 128) - 1
        return V(rep, tuple(xp.asarray((v >> (32 * k)) & M32, dtype=torch.int64)
                            for k in range(NL)), xp)

    @property
    def shape(self):
        return self.l.shape if self.rep == "p" else self.l[0].shape

    def map(self, f) -> "V":
        if self.rep == "p":
            return V("p", f(self.l), self.xp)
        return V(self.rep, tuple(f(x) for x in self.l), self.xp)

    def __getitem__(self, sl):
        return self.map(lambda x: x[sl])

    @property
    def dtype(self):
        return {"i": INT128, "u": UINT128}.get(self.rep) or self.l.dtype

    def astype(self, dtype) -> "V":
        if dtype is INT128 or dtype is UINT128:
            rep = "i" if dtype is INT128 else "u"
            if self.rep in ("i", "u"):
                return V(rep, self.l, self.xp)
            return _plain_to_limbs(self, rep)
        if self.rep == "p":
            return V("p", self.l.astype(dtype), self.xp)
        if from_numpy_dtype(dtype).is_floating_point:
            return V("p", _limbs_to_float(self).astype(dtype), self.xp)
        # narrow to a native int dtype: low 64 bits, wrapped
        lo64 = self.l[0] | (self.l[1] << 32)
        return V("p", lo64.astype(dtype), self.xp)

    def _lift(self, other) -> tuple["V", "V"]:
        """Coerce `other` to this value's rep for a binary op."""
        xp = self.xp
        if not isinstance(other, V):
            if self.rep in ("i", "u") and isinstance(other, (int, np.integer)):
                return self, V.from_int_scalar(int(other), self.rep, xp)
            other = V.plain(xp.asarray(other), xp)
        if self.rep == other.rep:
            return self, other
        if self.rep == "p" and other.rep in ("i", "u"):
            return _plain_to_limbs(self, other.rep), other
        if other.rep == "p" and self.rep in ("i", "u"):
            return self, _plain_to_limbs(other, self.rep)
        return self, V(self.rep, other.l, xp)

    # ---- arithmetic (two's complement mod 2^128) -------------------------

    def __add__(self, other):
        a, b = self._lift(other)
        return V.plain(a.l + b.l, a.xp) if a.rep == "p" else _add(a, b)

    __radd__ = __add__

    def __sub__(self, other):
        a, b = self._lift(other)
        return V.plain(a.l - b.l, a.xp) if a.rep == "p" else _add(a, _neg(b))

    def __rsub__(self, other):
        a, b = self._lift(other)
        return b - a if a.rep != "p" else V.plain(b.l - a.l, a.xp)

    def __mul__(self, other):
        a, b = self._lift(other)
        return V.plain(a.l * b.l, a.xp) if a.rep == "p" else _mul(a, b)

    __rmul__ = __mul__

    def __neg__(self):
        return V.plain(-self.l, self.xp) if self.rep == "p" else _neg(self)

    def __invert__(self):
        if self.rep == "p":
            return V.plain(~self.l, self.xp)
        return V(self.rep, tuple(x ^ M32 for x in self.l), self.xp)

    def _bitwise(self, other, f):
        a, b = self._lift(other)
        if a.rep == "p":
            return V.plain(f(a.l, b.l), a.xp)
        return V(a.rep, tuple(f(x, y) for x, y in zip(a.l, b.l)), a.xp)

    def __and__(self, other):
        return self._bitwise(other, lambda x, y: x & y)

    def __or__(self, other):
        return self._bitwise(other, lambda x, y: x | y)

    def __xor__(self, other):
        return self._bitwise(other, lambda x, y: x ^ y)

    # ---- comparisons (plain bool tensors out, wrapped in a plain V) ------

    def _cmp(self, other, kind: str):
        a, b = self._lift(other)
        if a.rep == "p":
            return {"lt": a.l < b.l, "le": a.l <= b.l, "gt": a.l > b.l,
                    "ge": a.l >= b.l, "eq": a.l == b.l, "ne": a.l != b.l}[kind]
        if kind in ("eq", "ne"):
            r = a.l[0] == b.l[0]
            for x, y in zip(a.l[1:], b.l[1:]):
                r = r & (x == y)
            return r if kind == "eq" else ~r
        signed = a.rep == "i"
        if kind in ("lt", "ge"):
            lt = _less(a, b, signed)
            return lt if kind == "lt" else ~lt
        gt = _less(b, a, signed)
        return gt if kind == "gt" else ~gt

    def __lt__(self, other):
        return V.plain(self._cmp(other, "lt"), self.xp)

    def __le__(self, other):
        return V.plain(self._cmp(other, "le"), self.xp)

    def __gt__(self, other):
        return V.plain(self._cmp(other, "gt"), self.xp)

    def __ge__(self, other):
        return V.plain(self._cmp(other, "ge"), self.xp)

    def __eq__(self, other):  # noqa: D105
        return V.plain(self._cmp(other, "eq"), self.xp)

    def __ne__(self, other):  # noqa: D105
        return V.plain(self._cmp(other, "ne"), self.xp)


# ---- limb primitives ---------------------------------------------------------


def _add(a: V, b: V) -> V:
    out, carry = [], None
    for x, y in zip(a.l, b.l):
        s = x + y if carry is None else x + y + carry
        out.append(s & M32)
        carry = s >> 32
    return V(a.rep, tuple(out), a.xp)


def _neg(a: V) -> V:
    out, carry = [], 1
    for x in a.l:
        s = (x ^ M32) + carry
        out.append(s & M32)
        carry = s >> 32
    return V(a.rep, tuple(out), a.xp)


def _is_neg(a: V):
    return (a.l[NL - 1] >> 31) != 0


def _select(c, a: V, b: V) -> V:
    return V(a.rep, tuple(torch.where(c, x, y) for x, y in zip(a.l, b.l)), a.xp)


def _abs(a: V) -> V:
    return _select(_is_neg(a), _neg(a), a)


def _mul(a: V, b: V) -> V:
    """Schoolbook product mod 2^128: each limb product's low and high 32
    bits (exact in int64 bits), summed column by column."""
    cols = [None] * NL
    carry_cols = [None] * NL
    for i in range(NL):
        for j in range(NL - i):
            p = a.l[i] * b.l[j]
            k = i + j
            lo, hi = p & M32, (p >> 32) & M32
            cols[k] = lo if cols[k] is None else cols[k] + lo
            if k + 1 < NL:
                carry_cols[k + 1] = (hi if carry_cols[k + 1] is None
                                     else carry_cols[k + 1] + hi)
    out, carry = [], 0
    for k in range(NL):
        s = cols[k] + carry
        if carry_cols[k] is not None:
            s = s + carry_cols[k]
        out.append(s & M32)
        carry = s >> 32
    return V(a.rep, tuple(out), a.xp)


def _less(a: V, b: V, signed: bool):
    """a < b over limb vectors (signed: the top limbs' sign bits flipped)."""
    at, bt = a.l[NL - 1], b.l[NL - 1]
    if signed:
        at, bt = at ^ _TOP, bt ^ _TOP
    r, eq = at < bt, at == bt
    for k in range(NL - 2, -1, -1):
        r = r | (eq & (a.l[k] < b.l[k]))
        eq = eq & (a.l[k] == b.l[k])
    return r


def _shl_const(a: V, s: int) -> V:
    """Left shift by a Python-int amount in [0, 128]."""
    if s == 0:
        return a
    zero = torch.zeros_like(a.l[0])
    if s >= 128:
        return V(a.rep, (zero,) * NL, a.xp)
    word, bit = divmod(s, 32)
    out = []
    for k in range(NL):
        src = k - word
        v = a.l[src] if src >= 0 else zero
        if bit:
            lo = a.l[src - 1] if src - 1 >= 0 else zero
            v = ((v << bit) & M32) | (lo >> (32 - bit))
        out.append(v)
    return V(a.rep, tuple(out), a.xp)


def _shr_const(a: V, s: int) -> V:
    """Right shift by a Python-int amount in [0, 128]: logical for "u",
    arithmetic for "i"."""
    if s == 0:
        return a
    fill = (torch.where(_is_neg(a), M32, 0) if a.rep == "i"
            else torch.zeros_like(a.l[0]))
    if s >= 128:
        return V(a.rep, (fill,) * NL, a.xp)
    word, bit = divmod(s, 32)
    out = []
    for k in range(NL):
        src = k + word
        v = a.l[src] if src < NL else fill
        if bit:
            hi = a.l[src + 1] if src + 1 < NL else fill
            v = (v >> bit) | ((hi << (32 - bit)) & M32)
        out.append(v)
    return V(a.rep, tuple(out), a.xp)


def _shift_dyn(a: V, s, left: bool) -> V:
    """Shift by a per-element amount: 8 conditional power-of-two steps
    (1, 2, 4, ..., 128) of the amount's low 32 bits, as the original."""
    sv = s.l if isinstance(s, V) and s.rep == "p" else s
    if isinstance(sv, V):  # limb-vector amount: the low limb carries it
        sv = sv.l[0]
    if isinstance(sv, (int, np.integer)):
        return _shl_const(a, int(sv)) if left else _shr_const(a, int(sv))
    sv = a.xp.asarray(sv).to(torch.int64) & M32
    out = a
    for k in range(8):
        step = 1 << k
        shifted = _shl_const(out, step) if left else _shr_const(out, step)
        out = _select((sv & step) != 0, shifted, out)
    return out


def _divmod_unsigned(a: V, b: V) -> tuple[V, V]:
    """128-step restoring long division: the dividend shifts left a bit a
    step and its top bit feeds the remainder."""
    xp = a.xp
    zero = torch.zeros_like(a.l[0])
    q, r = V("u", (zero,) * NL, xp), V("u", (zero,) * NL, xp)
    acc, bu = V("u", a.l, xp), V("u", b.l, xp)
    neg_b = _neg(bu)
    for _ in range(128):
        bit = acc.l[NL - 1] >> 31
        acc = _shl_const(acc, 1)
        r = _shl_const(r, 1)
        r = V("u", (r.l[0] | bit,) + r.l[1:], xp)
        ge = ~_less(r, bu, signed=False)
        r = _select(ge, _add(r, neg_b), r)
        q = _shl_const(q, 1)
        q = V("u", (q.l[0] | ge.to(torch.int64),) + q.l[1:], xp)
    return q, r


def _floordiv(a: V, b: V) -> V:
    """FLOOR division (numpy's floor_divide; the evaluator's _c_div makes
    it truncate, as on the other integer paths)."""
    xp = a.xp
    if a.rep == "u":
        q, _ = _divmod_unsigned(a, b)
        return V("u", q.l, xp)
    q, r = _divmod_unsigned(_abs(a), _abs(b))
    neg = _is_neg(a) != _is_neg(b)
    nz = r._cmp(V.from_int_scalar(0, "u", xp), "ne")
    qs = _select(neg, _neg(V("i", q.l, xp)), V("i", q.l, xp))
    qfix = _add(qs, V.from_int_scalar(-1, "i", xp))
    return V("i", _select(neg & nz, qfix, qs).l, xp)


def _limbs_to_float(a: V):
    """Limb vector -> float64 (exact to f64 precision), summed limb by
    limb in the original's order."""
    m = a if a.rep == "u" else _abs(a)
    v = m.l[0].to(torch.float64) * 0.0
    for k in range(NL):
        v = v + m.l[k].to(torch.float64) * float(2 ** (32 * k))
    if a.rep == "u":
        return v.as_subclass(XTensor)
    return torch.where(_is_neg(a), -v, v).as_subclass(XTensor)


def _plain_to_limbs(a: V, rep: str) -> V:
    """Plain tensor -> limb vector (ints sign-extend through int64; floats
    truncate, exact to f64 precision: C's cast for in-range values)."""
    x = a.l
    if x.is_floating_point():
        t = torch.trunc(x.to(torch.float64))
        neg = t < 0
        ax = torch.where(neg, -t, t)
        limbs = []
        for k in range(NL):
            d = ax / float(2 ** (32 * k))
            limb = torch.floor(d - torch.floor(d / float(2 ** 32)) * float(2 ** 32))
            limbs.append(limb.to(torch.int64) & M32)
        v = V(rep, tuple(limbs), a.xp)
        return _select(neg, _neg(v), v)
    x64 = x.astype(np.int64)
    lo, hi = x64 & M32, (x64 >> 32) & M32
    sign = ((x64 >> 63) & 1) * M32
    return V(rep, (lo, hi, sign, sign), a.xp)


# ---- numpy-like namespace -----------------------------------------------------


class Wide128XP:
    """numpy-like namespace over V values, backed by `base` (a
    `TorchXP`): the surface of the original's Wide128XP that the shared
    evaluator walks at int_width=128."""

    int128 = INT128
    uint128 = UINT128
    int64 = torch.int64
    float64 = torch.float64
    float32 = torch.float32
    float16 = torch.float16

    def __init__(self, base: TorchXP):
        self.base = base

    def asarray(self, v, dtype=None) -> V:
        if isinstance(v, V):
            return v.astype(dtype) if dtype is not None else v
        if dtype is INT128 or dtype is UINT128:
            rep = "i" if dtype is INT128 else "u"
            if isinstance(v, (int, np.integer)):
                return V.from_int_scalar(int(v), rep, self.base)
            return V.plain(self.base.asarray(v), self.base).astype(dtype)
        return V.plain(self.base.asarray(v, dtype), self.base)

    def _plain(self, v):
        return v.l if isinstance(v, V) and v.rep == "p" else v

    def where(self, c, a, b) -> V:
        c = self.base.asarray(self._plain(c))
        if not isinstance(a, V):
            a = self.asarray(a)
        a, b = a._lift(b)
        if a.rep == "p":
            return V.plain(self.base.where(c, a.l, b.l), self.base)
        return _select(c, a, b)

    def minimum(self, a, b) -> V:
        if not isinstance(a, V):
            a = self.asarray(a)
        a, b = a._lift(b)
        if a.rep == "p":
            return V.plain(self.base.minimum(a.l, b.l), self.base)
        return self.where(a._cmp(b, "le"), a, b)

    def maximum(self, a, b) -> V:
        if not isinstance(a, V):
            a = self.asarray(a)
        a, b = a._lift(b)
        if a.rep == "p":
            return V.plain(self.base.maximum(a.l, b.l), self.base)
        return self.where(a._cmp(b, "ge"), a, b)

    def abs(self, a) -> V:
        if a.rep == "p":
            return V.plain(self.base.abs(a.l), self.base)
        return a if a.rep == "u" else _abs(a)

    def floor_divide(self, a, b) -> V:
        if not isinstance(a, V):
            a = self.asarray(a)
        a, b = a._lift(b)
        if a.rep == "p":
            return V.plain(self.base.floor_divide(a.l, b.l), self.base)
        return _floordiv(a, b)

    def left_shift(self, a, s) -> V:
        if a.rep == "p":
            return V.plain(self.base.left_shift(a.l, self._plain(s)), self.base)
        return _shift_dyn(a, s, left=True)

    def right_shift(self, a, s) -> V:
        if a.rep == "p":
            return V.plain(self.base.right_shift(a.l, self._plain(s)), self.base)
        return _shift_dyn(a, s, left=False)

    def bitwise_and(self, a, b) -> V:
        return (a if isinstance(a, V) else self.asarray(a)) & b

    def bitwise_or(self, a, b) -> V:
        return (a if isinstance(a, V) else self.asarray(a)) | b

    def bitwise_xor(self, a, b) -> V:
        return (a if isinstance(a, V) else self.asarray(a)) ^ b

    def bitwise_not(self, a) -> V:
        return ~a

    def trunc(self, a) -> V:
        if isinstance(a, V) and a.rep == "p":
            return V.plain(self.base.trunc(a.l), self.base)
        return a  # limb ints are integral

    def __getattr__(self, name):
        fn = getattr(self.base, name)

        def wrapped(a, *args):
            if isinstance(a, V):
                a = (a if a.rep == "p" else a.astype(torch.float64)).l
            return V.plain(fn(a, *(self._plain(x) for x in args)), self.base)

        return wrapped


# ---- the boundary: (..., 2) words <-> limbs ---------------------------------


def from_pairs(t: torch.Tensor, rep: str, xp: TorchXP) -> V:
    """(..., 2) tensor of 64-bit words (low word first) -> limb vector."""
    lo, hi = bits(t[..., 0]), bits(t[..., 1])
    return V(rep, tuple(w.as_subclass(XTensor) for w in (
        lo & M32, (lo >> 32) & M32, hi & M32, (hi >> 32) & M32)), xp)


def to_pairs(v: V) -> torch.Tensor:
    """Limb vector -> (..., 2) uint64 tensor of its words, low word first."""
    lo = v.l[0] | (v.l[1] << 32)
    hi = v.l[2] | (v.l[3] << 32)
    return torch.stack([lo, hi], dim=-1).as_subclass(torch.Tensor).view(torch.uint64)
