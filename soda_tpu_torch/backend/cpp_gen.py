"""The C++ golden runner's expression printer, copied for the port.

The port's copy of `soda_tpu/backend/cpp.py::_cpp_float` and `_Gen`: an
IR expression printed as C++ with the DSL's C semantics, operation for
operation (int64 accumulators, C division, masking at stores, f32
literals, per-operation rounding of `half`).  `backend/cuda_codegen.py`
subclasses `_Gen` for the device, and `backend/cpp.py` prints the golden
runner with it.  The port imports nothing of `soda_tpu`.
"""

from __future__ import annotations

import numpy as np

from ..ir import expr as ir
from ..ir.program import StencilProgram
from ..ir.types import ScalarType


def program_is_128(program: StencilProgram) -> bool:
    """True when any tensor or param is an integer wider than 64 bits
    (`soda_tpu/interp/wide128.py::program_is_128`)."""
    return (any(t.type.is_int and t.type.width > 64
                for t in program.tensors.values())
            or any(p.type.is_int and p.type.width > 64
                   for p in program.params.values()))


def _cpp_float(v: float, width: int) -> str:
    if width == 64:
        return repr(float(v))
    return f"{float(np.float32(v))!r}f"


class _Gen:
    """Expression -> C++ with DSL type tracking.

    Integers are carried as int64_t; floats as float/double.  Matches
    interp/evaluator.py semantics operation for operation."""

    def __init__(self, program: StencilProgram, idx_vars: list[str]):
        self.p = program
        self.idx = idx_vars
        # >64-bit programs carry ALL ints in gcc __int128 (matching the
        # evaluator's int_width=128 wide-accumulator semantics)
        self.acc128 = program_is_128(program)

    def ctype(self, t: ScalarType) -> str:
        if t.is_float:
            # _Float16 arithmetic rounds per-op exactly like numpy float16
            # (both compute via f32 and round back), keeping the oracle
            # chain bit-exact for `half` programs
            return {16: "_Float16", 64: "double"}.get(t.width, "float")
        if self.acc128:
            # full-width unsigned rides unsigned (matches acc_of at 128)
            return ("unsigned __int128"
                    if t.kind == "uint" and t.width >= 128 else "__int128")
        # full-width unsigned rides an unsigned carrier so value-dependent
        # ops (/ % < >>) see true values (matches evaluator.acc_of)
        return "uint64_t" if t.kind == "uint" and t.width >= 64 else "int64_t"

    def int_literal(self, v: int) -> str:
        if not self.acc128:
            return f"int64_t({v})"
        if -(2 ** 63) <= v < 2 ** 63:
            return f"(__int128)INT64_C({v})"
        u = v & ((1 << 128) - 1)
        hi, lo = u >> 64, u & ((1 << 64) - 1)
        return (f"((__int128)(((unsigned __int128){hi}ULL << 64) "
                f"| {lo}ULL))")

    def cast_to(self, code: str, src: ScalarType, dst: ScalarType) -> str:
        if dst.is_float:
            return f"({self.ctype(dst)})({code})"
        if src.is_float:
            if self.acc128:
                # double -> __int128 is defined for in-range values and
                # matches the oracle's f64-precision conversion
                code = f"(__int128)std::trunc({code})"
            else:
                # route through int64 then reinterpret: float->unsigned of
                # a negative value is UB in C++, while float->int64 +
                # two's-complement wrap is defined for |v| < 2^63 and
                # matches the oracle's conversion
                code = f"(int64_t)std::trunc({code})"
        mask_fn = "mask_int128" if self.acc128 else "mask_int"
        return (f"({self.ctype(dst)}){mask_fn}({code}, {dst.width}, "
                f"{str(dst.kind == 'int').lower()})")

    def tap(self, name: str, off: tuple[int, ...]) -> tuple[str, ScalarType]:
        t = self.p.tensors[name].type
        idx = [f"({v} + ({o}))" for v, o in zip(self.idx, off)]
        bounds = " && ".join(
            f"({i} >= 0 && {i} < (int64_t)d{d})" for d, i in enumerate(idx))
        at = f"{name}_a[" + self._lin(idx) + "]"
        zero = "0" if t.is_int else ("0.0" if t.width == 64 else "0.0f")
        val = f"(({bounds}) ? ({self.ctype(t)})({at}) : {zero})"
        return val, t

    def _lin(self, idx: list[str]) -> str:
        out = idx[0]
        for d in range(1, len(idx)):
            out = f"({out}) * (int64_t)d{d} + ({idx[d]})"
        return out

    def emit(self, e: ir.Expr) -> tuple[str, ScalarType]:
        from ..ir.types import promote

        F32 = ScalarType("float", 32)
        I32 = ScalarType("int", 32)
        if isinstance(e, ir.Const):
            if isinstance(e.value, float):
                t = e.type or F32
                return _cpp_float(e.value, t.width), t
            return self.int_literal(e.value), e.type or I32
        if isinstance(e, ir.Ref):
            return self.tap(e.name, e.offsets)
        if isinstance(e, ir.ParamRef):
            p = self.p.params[e.name]
            lin = 0
            for i, d in zip(e.indices, p.shape):
                lin = lin * d + i
            c = f"{e.name}_p[{lin}]"
            if p.type.is_int:
                c = f"({self.ctype(p.type)}){c}"
            return c, p.type
        if isinstance(e, ir.Var):
            p = self.p.params[e.name]
            c = f"{e.name}_p[0]"
            if p.type.is_int:
                c = f"({self.ctype(p.type)}){c}"
            return c, p.type
        if isinstance(e, ir.Cast):
            c, src = self.emit(e.operand)
            return self.cast_to(c, src, e.type), e.type
        if isinstance(e, ir.UnOp):
            c, t = self.emit(e.operand)
            if e.op == "!":
                acc = "__int128" if self.acc128 else "int64_t"
                return f"({acc})(!({c}))", I32
            if e.op == "~":
                return f"(~({c}))", t
            return f"({e.op}({c}))", t
        if isinstance(e, ir.Select):
            cc, _ = self.emit(e.cond)
            ac, at = self.emit(e.on_true)
            bc, bt = self.emit(e.on_false)
            t = promote(at, bt)
            ac = self._coerce(ac, at, t)
            bc = self._coerce(bc, bt, t)
            return f"(({cc}) ? ({ac}) : ({bc}))", t
        if isinstance(e, ir.BinOp):
            ac, at = self.emit(e.lhs)
            bc, bt = self.emit(e.rhs)
            op = e.op
            acc_c = "__int128" if self.acc128 else "int64_t"
            if op in ("&&", "||"):
                return f"({acc_c})(({ac}) != 0 {op} ({bc}) != 0)", I32
            if op in ("==", "!=", "<", ">", "<=", ">="):
                t = promote(at, bt)
                return f"({acc_c})(({self._coerce(ac, at, t)}) {op} ({self._coerce(bc, bt, t)}))", I32
            if op in ("<<", ">>"):
                return f"(({ac}) {op} ({bc}))", at
            t = promote(at, bt)
            ac = self._coerce(ac, at, t)
            bc = self._coerce(bc, bt, t)
            uw = 128 if self.acc128 else 64
            if op == "/" and t.is_int:
                if t.kind == "uint" and t.width >= uw:
                    return f"(({ac}) / ({bc}))", t  # unsigned / is already trunc
                return f"c_div({ac}, {bc})", t
            if op == "%" and t.is_int:
                if t.kind == "uint" and t.width >= uw:
                    return f"(({ac}) % ({bc}))", t
                return f"c_mod({ac}, {bc})", t
            if op == "%":
                return f"std::fmod({ac}, {bc})", t
            if t.is_float and t.width == 16:
                # force per-op rounding: GCC evaluates chained _Float16
                # arithmetic with f32 excess precision, but numpy float16
                # rounds after EVERY op — the explicit cast restores that
                return f"(_Float16)(({ac}) {op} ({bc}))", t
            return f"(({ac}) {op} ({bc}))", t
        if isinstance(e, ir.Call):
            args = [self.emit(a) for a in e.args]
            from ..ir.types import promote as pr

            if e.fn in ("min", "max", "fmin", "fmax"):
                t = args[0][1]
                for _, u in args[1:]:
                    t = pr(t, u)
                if e.fn in ("fmin", "fmax") and not t.is_float:
                    t = F32
                fn = "std::min" if e.fn in ("min", "fmin") else "std::max"
                cs = [self._coerce(c, u, t) for c, u in args]
                out = cs[0]
                for c in cs[1:]:
                    out = f"{fn}<{self.ctype(t)}>({out}, {c})"
                return out, t
            if e.fn == "abs":
                c, t = args[0]
                if t.is_int and t.kind == "uint" and t.width >= 64:
                    return c, t  # abs of unsigned is the identity
                if t.is_int and self.acc128:
                    return f"c_abs({c})", t  # std::abs lacks __int128
                return (f"std::abs({c})", t)
            if e.fn == "pow":
                t = pr(pr(args[0][1], args[1][1]), F32)
                return (f"std::pow({self._coerce(args[0][0], args[0][1], t)}, "
                        f"{self._coerce(args[1][0], args[1][1], t)})", t)
            if e.fn == "rsqrt":
                t = pr(args[0][1], F32)
                one = "1.0" if t.width == 64 else "1.0f"
                return f"({one} / std::sqrt({self._coerce(args[0][0], args[0][1], t)}))", t
            if e.fn in ("atan2", "copysign", "hypot"):
                t = pr(pr(args[0][1], args[1][1]), F32)
                return (f"std::{e.fn}({self._coerce(args[0][0], args[0][1], t)}, "
                        f"{self._coerce(args[1][0], args[1][1], t)})", t)
            cpp = {"fabs": "std::fabs", "round": "std::round"}.get(
                e.fn, f"std::{e.fn}")
            t = pr(args[0][1], F32)
            return f"{cpp}({self._coerce(args[0][0], args[0][1], t)})", t
        raise TypeError(f"cannot emit {e!r}")

    def _coerce(self, code: str, src: ScalarType, dst: ScalarType) -> str:
        if dst.is_float and (src.is_int or src.width != dst.width):
            return f"({self.ctype(dst)})({code})"
        if dst.is_int and src.is_int and self.ctype(src) != self.ctype(dst):
            return f"({self.ctype(dst)})({code})"  # signed<->unsigned carrier
        return code
