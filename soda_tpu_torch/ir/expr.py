"""The port's copy of `soda_tpu/ir/expr.py`, unchanged: the port imports nothing
of `soda_tpu`.  Class and field names are the original's, so the two IRs print
the same reprs.

Typed expression IR for soda_tpu.

Plays the role of the reference's haoda.ir expression node classes plus
src/soda/visitor.py (ref collectors) and src/soda/mutator.py (offset shift /
rename / substitute) — reconstructed per SURVEY.md §2.1 (empty reference
mount; no file:line cites possible).

Nodes are immutable dataclasses; visitors/mutators are pure functions, which
keeps the IR trivially safe to share across planner passes and matches the
functional style of the JAX backend.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Mapping, Sequence

from .types import ScalarType


class Expr:
    """Base class for expression nodes."""

    def children(self) -> Sequence["Expr"]:
        return ()


@dataclasses.dataclass(frozen=True)
class Const(Expr):
    value: float | int
    type: ScalarType | None = None  # None = untyped literal (context-typed)

    def __str__(self) -> str:
        return repr(self.value)


@dataclasses.dataclass(frozen=True)
class Ref(Expr):
    """Reference to tensor `name` at a RELATIVE N-D offset."""

    name: str
    offsets: tuple[int, ...]

    def __str__(self) -> str:
        return f"{self.name}({', '.join(map(str, self.offsets))})"


@dataclasses.dataclass(frozen=True)
class ParamRef(Expr):
    """Reference to parameter `name` at constant indices name[i][j]."""

    name: str
    indices: tuple[int, ...]

    def __str__(self) -> str:
        return self.name + "".join(f"[{i}]" for i in self.indices)


@dataclasses.dataclass(frozen=True)
class Var(Expr):
    """A bare identifier (scalar param reference)."""

    name: str

    def __str__(self) -> str:
        return self.name


@dataclasses.dataclass(frozen=True)
class BinOp(Expr):
    op: str  # + - * / % << >> & | ^ && || == != < > <= >=
    lhs: Expr
    rhs: Expr

    def children(self):
        return (self.lhs, self.rhs)

    def __str__(self) -> str:
        return f"({self.lhs} {self.op} {self.rhs})"


@dataclasses.dataclass(frozen=True)
class UnOp(Expr):
    op: str  # - + ! ~
    operand: Expr

    def children(self):
        return (self.operand,)

    def __str__(self) -> str:
        return f"({self.op}{self.operand})"


@dataclasses.dataclass(frozen=True)
class Call(Expr):
    """Math function call: min, max, abs, sqrt, exp, ... (see MATH_FNS)."""

    fn: str
    args: tuple[Expr, ...]

    def children(self):
        return self.args

    def __str__(self) -> str:
        return f"{self.fn}({', '.join(map(str, self.args))})"


@dataclasses.dataclass(frozen=True)
class Cast(Expr):
    type: ScalarType
    operand: Expr

    def children(self):
        return (self.operand,)

    def __str__(self) -> str:
        return f"{self.type}({self.operand})"


@dataclasses.dataclass(frozen=True)
class Select(Expr):
    """C ternary cond ? true : false."""

    cond: Expr
    on_true: Expr
    on_false: Expr

    def children(self):
        return (self.cond, self.on_true, self.on_false)

    def __str__(self) -> str:
        return f"({self.cond} ? {self.on_true} : {self.on_false})"


# Functions the DSL may call (superset of the reference's math surface).
MATH_FNS = {
    "min", "max", "abs", "sqrt", "rsqrt", "exp", "exp2", "log", "log2",
    "sin", "cos", "tan", "tanh", "pow", "floor", "ceil", "round", "fabs",
    "fmin", "fmax",
    # round-3 continuation: the rest of the C-math surface the reference's
    # printer passes straight through to libm (SURVEY.md §2.4)
    "atan", "atan2", "asin", "acos", "sinh", "cosh", "log10", "expm1",
    "log1p", "trunc", "copysign", "hypot",
}


# ---- visitors (reference: src/soda/visitor.py) -----------------------------

def walk(e: Expr) -> Iterator[Expr]:
    """Pre-order traversal."""
    yield e
    for c in e.children():
        yield from walk(c)


def get_load_set(e: Expr) -> list[Ref]:
    """All distinct tensor refs (the stage's 'taps'), in first-seen order."""
    seen: dict[Ref, None] = {}
    for n in walk(e):
        if isinstance(n, Ref):
            seen.setdefault(n, None)
    return list(seen)


def get_load_names(e: Expr) -> list[str]:
    seen: dict[str, None] = {}
    for r in get_load_set(e):
        seen.setdefault(r.name, None)
    return list(seen)


# ---- mutators (reference: src/soda/mutator.py) ------------------------------

def mutate(e: Expr, fn: Callable[[Expr], Expr | None]) -> Expr:
    """Bottom-up rewrite: fn(node) may return a replacement or None."""
    if isinstance(e, BinOp):
        e2: Expr = BinOp(e.op, mutate(e.lhs, fn), mutate(e.rhs, fn))
    elif isinstance(e, UnOp):
        e2 = UnOp(e.op, mutate(e.operand, fn))
    elif isinstance(e, Call):
        e2 = Call(e.fn, tuple(mutate(a, fn) for a in e.args))
    elif isinstance(e, Cast):
        e2 = Cast(e.type, mutate(e.operand, fn))
    elif isinstance(e, Select):
        e2 = Select(mutate(e.cond, fn), mutate(e.on_true, fn), mutate(e.on_false, fn))
    else:
        e2 = e
    out = fn(e2)
    return e2 if out is None else out


def shift(e: Expr, delta: Sequence[int], names: set[str] | None = None) -> Expr:
    """Translate every tensor ref offset by `delta` (offset normalization /
    fusion inlining both use this — reference mutator `shift`)."""

    def f(n: Expr) -> Expr | None:
        if isinstance(n, Ref) and (names is None or n.name in names):
            return Ref(n.name, tuple(o + d for o, d in zip(n.offsets, delta)))
        return None

    return mutate(e, f)


def rename(e: Expr, mapping: Mapping[str, str]) -> Expr:
    def f(n: Expr) -> Expr | None:
        if isinstance(n, Ref) and n.name in mapping:
            return Ref(mapping[n.name], n.offsets)
        return None

    return mutate(e, f)


def substitute(e: Expr, name: str, make_body: Callable[[tuple[int, ...]], Expr]) -> Expr:
    """Replace every Ref(name, off) with make_body(off).

    This is the fusion/inlining primitive: a consumer's reference to a
    producer stage at offset `off` is replaced by the producer's expression
    shifted by `off` (SODA's stage-chaining math, SURVEY.md §3(b))."""

    def f(n: Expr) -> Expr | None:
        if isinstance(n, Ref) and n.name == name:
            return make_body(n.offsets)
        return None

    return mutate(e, f)
