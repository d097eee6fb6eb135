"""Expression code for the CUDA kernels, from the C++ golden runner's printer.

`DeviceGen` subclasses `backend/cpp_gen.py::_Gen` (the port's copy of
`soda_tpu/backend/cpp.py::_Gen`), which prints the DSL's C semantics
operation for operation (int64 accumulators, C division, masking at
stores, f32 literals), and changes what differs on the device:

- `tap` reads the tensor's shared-memory ring instead of a bounds-checked
  global read: the ring already holds zeros outside the grid.  Rank 3
  (`csrc/linebuffer3d.cuh`): a z-plane slot, then the tile's row and
  column; rank 2 (`csrc/linebuffer2d.cuh`): a row slot, then the column;
- the runner's `std::` calls become `dm::` overloads that device code can
  call (`std::min<T>` -> `dm::min<T>`, `std::sqrt` -> `sqrtf`/`sqrt`, ...),
  so no `--expt-relaxed-constexpr` is needed;
- `half` (`_Float16` in the runner, which the device lacks) becomes
  `soda_half` (`csrc/soda_common.cuh`): an IEEE half converted through
  float at every operation, `_Float16` again under host emulation.

`RunGen`, `column_run` and `run_rows` print a column run, the unit of
work of both marches: one thread computes a stage at several consecutive
rows of one column, from tap values it loads from the rings into
registers once (a tap that neighbouring rows share is loaded once), with
32-bit row and column arithmetic.

32-bit integer carriers.  The golden runner carries every integer as
int64_t, and the H100 has no 64-bit integer datapath: a 64-bit add is two
instructions and a 64-bit division by a constant a chain of 32-bit
multiply-highs.  `int_range` gives every integer node of an expression the
interval of values it can take under the runner's C semantics (inputs and
params from their storage dtype, literals exact, each operator by its C
definition on int64 carriers); where every node of a stage lies in int32
(`int32_exact`), `column_run` prints that stage with int32_t carriers
(`DeviceGen.narrow`), which compute the same values.  Anything else keeps
int64_t, exactly as the runner prints it.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

from ..ir import expr as ir
from ..ir.program import StencilProgram
from ..ir.dtypes import check_kernel_types
from ..ir.types import ScalarType, promote
from ..utils.opcount import has_transcendental
from .cpp_gen import _Gen

# 32-bit registers a column run may hold in tap values; a stage with more
# taps runs fewer rows between loads
TAP_REG_WORDS = 48

INT32_MIN, INT32_MAX = -(2 ** 31), 2 ** 31 - 1
_UNBOUNDED = (-float("inf"), float("inf"))
_F32, _I32 = ScalarType("float", 32), ScalarType("int", 32)


def _width_range(t: ScalarType) -> tuple[int, int]:
    """The values `mask_int` leaves at `t`'s declared width."""
    if t.kind == "uint":
        return 0, 2 ** t.width - 1
    return -(2 ** (t.width - 1)), 2 ** (t.width - 1) - 1


def _storage_range(t: ScalarType) -> tuple[int, int]:
    """The values an array of `t` can hold (its storage dtype)."""
    info = np.iinfo(t.np_dtype())
    return int(info.min), int(info.max)


def _bits(lo, hi) -> int:
    """Bits k such that [lo, hi] lies in [-2^k, 2^k - 1]."""
    return max(v.bit_length() if v >= 0 else (~v).bit_length() for v in (lo, hi))


def _cdiv(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _node_type(program: StencilProgram, e: ir.Expr) -> ScalarType:
    """The type `_Gen.emit` gives node `e` (it differs from
    `StencilProgram.infer_type` on floor/ceil/round of an integer, which
    the printer computes in float)."""
    if isinstance(e, ir.Const):
        return e.type or (_F32 if isinstance(e.value, float) else _I32)
    if isinstance(e, ir.Ref):
        return program.tensors[e.name].type
    if isinstance(e, (ir.ParamRef, ir.Var)):
        return program.params[e.name].type
    if isinstance(e, ir.Cast):
        return e.type
    if isinstance(e, ir.UnOp):
        return _I32 if e.op == "!" else _node_type(program, e.operand)
    if isinstance(e, ir.Select):
        return promote(_node_type(program, e.on_true), _node_type(program, e.on_false))
    if isinstance(e, ir.BinOp):
        if e.op in DeviceGen._BOOL_OPS:
            return _I32
        lt = _node_type(program, e.lhs)
        return lt if e.op in ("<<", ">>") else promote(lt, _node_type(program, e.rhs))
    if isinstance(e, ir.Call):
        ts = [_node_type(program, a) for a in e.args]
        t = ts[0]
        for u in ts[1:]:
            t = promote(t, u)
        if e.fn in ("min", "max", "abs"):
            return t
        if e.fn in ("fmin", "fmax"):
            return t if t.is_float else _F32
        return promote(t, _F32)
    raise TypeError(f"cannot type {e!r}")


def int_range(program: StencilProgram, e: ir.Expr, _stages: dict | None = None):
    """(lo, hi) of the values integer node `e` takes under the golden
    runner's C semantics on int64 carriers, or None for a float node;
    (-inf, inf) where no bound is proven (a divisor or modulus that may be
    zero, a shift count outside [0, 31]).  A tap of an input or param
    ranges over its storage dtype; a tap of a stage over the values its
    expression stores, and zero (outside the grid)."""
    t = _node_type(program, e)
    if t.is_float:
        return None
    memo = {} if _stages is None else _stages
    sub = [int_range(program, c, memo) for c in e.children()]
    if isinstance(e, ir.Const):
        return int(e.value), int(e.value)
    if isinstance(e, ir.Ref) and program.tensors[e.name].expr is not None:
        if e.name not in memo:
            lo, hi = _width_range(t)
            a = int_range(program, program.tensors[e.name].expr, memo)
            if a is not None and lo <= a[0] and a[1] <= hi:
                lo, hi = a
            memo[e.name] = (min(lo, 0), max(hi, 0))
        return memo[e.name]
    if isinstance(e, (ir.Ref, ir.ParamRef, ir.Var)):
        return _storage_range(t)
    if isinstance(e, ir.Cast):
        lo, hi = _width_range(t)
        a = sub[0]
        return a if a is not None and lo <= a[0] and a[1] <= hi else (lo, hi)
    if isinstance(e, ir.Select):
        (a0, a1), (b0, b1) = sub[1], sub[2]
        return min(a0, b0), max(a1, b1)
    if isinstance(e, ir.UnOp):
        if e.op == "!":
            return 0, 1
        a0, a1 = sub[0]
        return {"-": (-a1, -a0), "~": (-a1 - 1, -a0 - 1)}.get(e.op, (a0, a1))
    if isinstance(e, ir.Call):
        if e.fn == "abs":
            a0, a1 = sub[0]
            return (a0, a1) if a0 >= 0 else (-a1, -a0) if a1 <= 0 else (0, max(-a0, a1))
        pick = min if e.fn == "min" else max
        return pick(s[0] for s in sub), pick(s[1] for s in sub)
    # BinOp
    if e.op in DeviceGen._BOOL_OPS:
        return 0, 1
    if None in sub or any(math.isinf(v) for s in sub for v in s):
        return _UNBOUNDED
    (a0, a1), (b0, b1) = sub
    if e.op == "+":
        return a0 + b0, a1 + b1
    if e.op == "-":
        return a0 - b1, a1 - b0
    if e.op == "*":
        ps = [a0 * b0, a0 * b1, a1 * b0, a1 * b1]
        return min(ps), max(ps)
    if e.op in ("/", "%"):
        if b0 <= 0 <= b1:
            return _UNBOUNDED
        if e.op == "/":
            qs = [_cdiv(a, b) for a in (a0, a1) for b in (b0, b1)]
            return min(qs), max(qs)
        m = max(abs(b0), abs(b1)) - 1
        return max(a0, -m) if a0 < 0 else 0, min(a1, m) if a1 > 0 else 0
    if e.op in ("<<", ">>"):
        if b0 < 0 or b1 > 31:
            return _UNBOUNDED
        f = (lambda v, s: v << s) if e.op == "<<" else (lambda v, s: v >> s)
        return min(f(a0, b0), f(a0, b1)), max(f(a1, b0), f(a1, b1))
    # & | ^
    if e.op == "&" and (a0 >= 0 or b0 >= 0):
        return 0, min(h for lo, h in ((a0, a1), (b0, b1)) if lo >= 0)
    k = max(_bits(a0, a1), _bits(b0, b1))
    if a0 >= 0 and b0 >= 0:
        return 0, 2 ** k - 1
    return -(2 ** k), 2 ** k - 1


def int32_exact(program: StencilProgram, e: ir.Expr) -> bool:
    """True when every integer node of `e` lies in int32 (`int_range`) and
    none is a full-width unsigned (carried as uint64_t): int32_t carriers
    then compute exactly the runner's values."""
    memo: dict = {}
    for n in ir.walk(e):
        t = _node_type(program, n)
        if t.is_float:
            continue
        if t.kind == "uint" and t.width >= 64:
            return False
        lo, hi = int_range(program, n, memo)
        if lo < INT32_MIN or hi > INT32_MAX:
            return False
    return True


def storage_ctype(t: ScalarType) -> str:
    """C type of a tensor or param element in device memory."""
    return "soda_half" if t.is_float and t.width == 16 else t.cpp_type()


def ring_var(name: str) -> str:
    return f"{name}_r"


def _device(code: str) -> str:
    return code.replace("std::", "dm::").replace("_Float16", "soda_half")


class DeviceGen(_Gen):
    """IR expression -> CUDA C++ reading the shared-memory rings.

    Rank 3: the code is evaluated at the chunk-local plane `pl`,
    tile-local row `ly` and column `lx`.  For each ring tensor `n` the
    kernel declares `n_r` (its shared memory) and the constants `n_D`
    (planes kept, a power of two; plane pl of the chunk sits in slot (pl -
    n_ZLO) & (n_D - 1)), `n_ZLO`, `n_YLO` (span lows), `n_XA` (its first
    column), `n_C` (columns) and `n_PS` (plane size in elements).

    Rank 2: the code is evaluated at row `p`, whose offset from the
    chunk's first row is the 32-bit `pl`, and strip-local column `lx`.
    Each ring `n` declares `n_r`, `n_D` (rows kept, a power of two; row r
    of the chunk sits in slot (r - n_YLO) & (n_D - 1)), `n_YLO`, `n_XLO`
    and `n_C`.

    Rank 1 has no march: only `RunGen` prints it, for the windows kernel
    (`backend/windows.py`), which reads every tap through its own load.

    With `narrow` set (a stage `int32_exact` proves), every integer is
    carried as int32_t: its type, literals, casts (`mask_int32`) and the
    0/1 results of `!`, comparisons and `&&`/`||`."""

    _BOOL_OPS = ("==", "!=", "<", ">", "<=", ">=", "&&", "||")

    def __init__(self, program: StencilProgram, rings: set[str]):
        if program.rank not in (1, 2, 3):
            raise ValueError(f"the device kernels take ranks 1 to 3, not {program.rank}")
        super().__init__(program, ["p", "ly", "lx"][3 - program.rank:])
        if self.acc128:
            check_kernel_types(program)
        self.rings = rings
        self.narrow = False

    def ctype(self, t):
        if self.narrow and t.is_int:
            return "int32_t"
        return _device(super().ctype(t))

    def int_literal(self, v):
        return f"int32_t({v})" if self.narrow else super().int_literal(v)

    def tap(self, name, off):
        if name not in self.rings:
            raise ValueError(f"{name!r} is tapped but has no shared-memory ring")
        t = self.p.tensors[name].type
        if self.p.rank == 3:
            oz, oy, ox = off
            at = (f"{ring_var(name)}[((pl + ({oz}) - {name}_ZLO) & ({name}_D - 1))"
                  f" * {name}_PS + (ly + ({oy}) - {name}_YLO) * {name}_C"
                  f" + (lx + ({ox}) - {name}_XA)]")
        else:
            oy, ox = off
            at = (f"{ring_var(name)}[((pl + ({oy}) - {name}_YLO) & ({name}_D - 1))"
                  f" * {name}_C + (lx + ({ox}) - {name}_XLO)]")
        return f"(({self.ctype(t)})({at}))", t

    def emit(self, e):
        code, t = super().emit(e)
        if (self.narrow and code.startswith("(int64_t)(")
                and (isinstance(e, ir.UnOp) and e.op == "!"
                     or isinstance(e, ir.BinOp) and e.op in self._BOOL_OPS)):
            code = "(int32_t)" + code[len("(int64_t)"):]
        return _device(code), t

    def cast_to(self, code, src, dst):
        if self.narrow and src.is_int and dst.is_int:
            return (f"(int32_t)mask_int32({code}, {dst.width}, "
                    f"{str(dst.kind == 'int').lower()})")
        return _device(super().cast_to(code, src, dst))


def offset_tag(v: int) -> str:
    """An offset as a C identifier part: 2 -> '2', -1 -> 'm1'."""
    return str(v) if v >= 0 else f"m{-v}"


class RunGen(DeviceGen):
    """`DeviceGen` for a column run along the rows (dim 0 of rank 2, dim 1
    of rank 3; rank 1 runs one cell at a time): the tap of ring `q` at
    offset `off` for row `row` of the run reads the register `__q_<key>`,
    `key` being `off` with its row offset moved by `row`; `loads` maps
    each such register to (q, key)."""

    def __init__(self, program: StencilProgram, rings: set[str]):
        super().__init__(program, rings)
        self.axis = max(program.rank - 2, 0)
        self.row = 0
        self.loads: dict[str, tuple[str, tuple[int, ...]]] = {}

    def tap(self, name, off):
        if name not in self.rings:
            raise ValueError(f"{name!r} is tapped but has no shared-memory ring")
        key = list(off)
        key[self.axis] += self.row
        var = "__" + name + "".join("_" + offset_tag(k) for k in key)
        self.loads[var] = (name, tuple(key))
        t = self.p.tensors[name].type
        return f"(({self.ctype(t)})({var}))", t


def column_run(gen: RunGen, stages: list[str], rows: int, rowvar: str,
               computes: str, in_regs: dict[str, str],
               after: dict[str, list[str]],
               load: Callable[[str, tuple[int, ...]], str],
               uniform: str | None = None,
               tail: Callable[[bool], list[str]] | None = None,
               checks: bool = True) -> list[str]:
    """C lines of one column run of `rows` rows: every tap of `stages`
    loaded into a register once (`load(q, key)` is the ring read, relative
    to the run's first row `pb`), then, for each row r (`rowvar` = pb + r),
    each stage's value `v_<stage>_<r>`: its expression where `computes` (a
    C condition) holds, else zero; `after[stage]` (lines that may use `v`
    and `rowvar`) follow the value where it is computed, and `tail(checked)`
    the run.  With `uniform` (a C condition under which `computes` holds at
    every row of the run) the rows are printed twice: without the per-row
    check where `uniform` holds, and with it elsewhere (`tail(False)` and
    `tail(True)`); without `uniform`, `checks` False prints the rows
    without the check alone (the caller knows that `computes` holds)."""
    program = gen.p
    gen.loads = {}

    def body(checked: bool) -> list[str]:
        out = []
        for r in range(rows):
            gen.row = r
            out.append(f"{{  const int {rowvar} = pb + {r};")
            for n in stages:
                t = program.tensors[n].type
                ct = storage_ctype(t)
                # 32-bit carriers where the range analysis proves them exact
                gen.narrow = int32_exact(program, program.tensors[n].expr)
                code, bt = gen.emit(program.tensors[n].expr)
                for a, b in in_regs.items():
                    code = code.replace(a, b)
                value = f"({ct})({gen.cast_to('__v', bt, t)})"
                if checked:
                    out += [f"  {{  {ct} v = {ct}(0);",
                            f"    if ({computes}) {{",
                            f"      const {gen.ctype(bt)} __v = {code};",
                            f"      v = {value};",
                            *("    " + ln for ln in after.get(n, [])),
                            "    }"]
                else:
                    out += [f"  {{  const {gen.ctype(bt)} __v = {code};",
                            f"    const {ct} v = {value};",
                            *("  " + ln for ln in after.get(n, []))]
                out += [f"    v_{n}_{r} = v;", "  }"]
                gen.narrow = False
            out.append("}")
        return out + (tail(checked) if tail else [])

    if uniform is None:
        main = body(checks)
    else:
        main = [f"if ({uniform}) {{  // every row of the run computes",
                *("  " + ln for ln in body(False)), "} else {",
                *("  " + ln for ln in body(True)), "}"]
    decl = [f"{storage_ctype(program.tensors[n].type)} v_{n}_{r};"
            for r in range(rows) for n in stages]
    loads = [f"const {storage_ctype(program.tensors[q].type)} {var} = {load(q, key)};"
             for var, (q, key) in sorted(gen.loads.items())]
    return loads + decl + main


def run_rows(gen: RunGen, stages: list[str], candidates: list[int],
             in_regs: dict[str, str]) -> int:
    """Rows per column run: the most of `candidates` whose tap loads fit
    TAP_REG_WORDS 32-bit registers, else the fewest; the fewest for a stage
    that calls libm (its inlined calls, repeated per row, would crowd the
    registers)."""
    program = gen.p
    candidates = sorted(candidates)
    if any(has_transcendental(program.tensors[n].expr) for n in stages):
        return candidates[0]
    for rs in reversed(candidates):
        column_run(gen, stages, rs, "p", "1", in_regs, {}, lambda q, k: "")
        words = sum(-(-program.tensors[q].type.np_dtype().itemsize // 4)
                    for q, _ in gen.loads.values())
        if words <= TAP_REG_WORDS:
            return rs
    return candidates[0]
