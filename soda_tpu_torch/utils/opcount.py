"""Operations per cell from the IR: the compute half of the bound.

`expr_ops` is the port's copy of `soda_tpu/utils/opcount.py::expr_ops`
(held equal to it by `tests/test_torch_copies.py`): arithmetic, select,
compare and cast count 1, a k-ary min/max k-1, a transcendental
`TRANSCENDENTAL_WEIGHT`, over distinct subexpressions.  The TPU's VPU
rate and pair-carrier weights are not copied.

`typed_ops` weights each operation by the H100's rate for the type it
computes in, so that one number over the published 67 TFLOP/s of f32
outside the tensor cores (`H100_SXM_PEAK_TFLOPS`) is the operations'
time.  An H100 SM issues a clock 128 f32 lanes, 64 f64 lanes (34 TFLOP/s)
and 64 int32 lanes (NVIDIA's H100 data sheet and architecture paper);
the generated kernels carry every integer as int64 (`backend/cpp_gen.py`),
and an int64 add, compare or shift takes two int32 instructions.  So an
f32 (or `half`, computed in f32) operation weighs 1, an f64 one 2 and an
integer one 4 (`type_weight`).  That is a lower estimate for integers:
an int64 multiply takes three instructions and a division more.
"""

from __future__ import annotations

from ..ir import expr as ir
from ..ir.program import StencilProgram
from ..ir.types import ScalarType, promote

TRANSCENDENTAL_WEIGHT = 8.0
_TRANSCENDENTALS = {"sqrt", "rsqrt", "exp", "exp2", "log", "log2", "sin",
                    "cos", "tan", "tanh", "pow", "atan", "atan2", "asin",
                    "acos", "sinh", "cosh", "log10", "expm1", "log1p",
                    "hypot"}
_COMPARES = {"==", "!=", "<", ">", "<=", ">=", "&&", "||"}

# published f32 rate of one H100 SXM outside the tensor cores, at 700 W
H100_SXM_PEAK_TFLOPS = 67.0


def type_weight(t: ScalarType) -> float:
    """f32 lane-slots one operation computed in `t` takes on the H100."""
    if t.is_float:
        return 2.0 if t.width > 32 else 1.0
    return 4.0


def _node_ops(n: ir.Expr) -> float:
    if isinstance(n, ir.BinOp):
        return 1
    if isinstance(n, ir.UnOp):
        return 0 if n.op == "+" else 1
    if isinstance(n, ir.Select):
        return 1
    if isinstance(n, ir.Call):
        if n.fn in _TRANSCENDENTALS:
            return TRANSCENDENTAL_WEIGHT
        # k-ary reductions (min/max/...) cost k-1 ops
        return max(len(n.args) - 1, 1)
    if isinstance(n, ir.Cast):
        return 1
    return 0


def expr_ops(e: ir.Expr) -> float:
    """Weighted op count over DISTINCT subexpressions (IR nodes are frozen
    dataclasses, so structural equality dedups repeated subtrees)."""
    ops = 0.0
    seen: set = set()
    for n in ir.walk(e):
        if n in seen:
            continue
        seen.add(n)
        ops += _node_ops(n)
    return ops


def _op_type(program: StencilProgram, n: ir.Expr) -> ScalarType:
    """The type an operation computes in (a comparison: its operands')."""
    if isinstance(n, ir.BinOp) and n.op in _COMPARES:
        return promote(program.infer_type(n.lhs), program.infer_type(n.rhs))
    if isinstance(n, ir.Cast):
        src = program.infer_type(n.operand)
        return max((src, n.type), key=type_weight)
    return program.infer_type(n)


def typed_ops(program: StencilProgram, e: ir.Expr) -> float:
    """`expr_ops` with each operation weighted by `type_weight` of its type:
    f32-equivalent operations on the H100."""
    ops = 0.0
    seen: set = set()
    for n in ir.walk(e):
        if n in seen:
            continue
        seen.add(n)
        w = _node_ops(n)
        if w:
            ops += w * type_weight(_op_type(program, n))
    return ops


def has_transcendental(e: ir.Expr) -> bool:
    """True when `e` calls a transcendental (a libm call on the card)."""
    return any(isinstance(n, ir.Call) and n.fn in _TRANSCENDENTALS
               for n in ir.walk(e))


def ops_per_cell(program: StencilProgram) -> float:
    """f32-equivalent ops per cell (`typed_ops`) for ONE sweep of all stages."""
    return sum(typed_ops(program, t.expr) for t in program.tensors.values()
               if t.expr is not None)
