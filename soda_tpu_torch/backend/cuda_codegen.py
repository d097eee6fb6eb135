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
"""

from __future__ import annotations

from typing import Callable

from ..ir.program import StencilProgram
from ..ir.types import ScalarType, UnsupportedTypeError
from ..utils.opcount import has_transcendental
from .cpp_gen import _Gen

# 32-bit registers a column run may hold in tap values; a stage with more
# taps runs fewer rows between loads
TAP_REG_WORDS = 48


def storage_ctype(t: ScalarType) -> str:
    """C type of a tensor or param element in device memory."""
    return "soda_half" if t.is_float and t.width == 16 else t.cpp_type()


def ring_var(name: str) -> str:
    return f"{name}_r"


def _device(code: str) -> str:
    return code.replace("std::", "dm::").replace("_Float16", "soda_half")


class DeviceGen(_Gen):
    """IR expression -> CUDA C++ reading the shared-memory rings.

    Rank 3: the code is evaluated at plane `p`, tile-local row `ly` and
    column `lx`; `z0` is the chunk's first z index.  For each ring tensor
    `n` the kernel declares `n_r` (its shared memory) and the constants
    `n_D` (depth), `n_ZLO`, `n_YLO`, `n_XLO` (span lows), `n_C` (columns)
    and `n_PS` (plane size in elements).

    Rank 2: the code is evaluated at row `p`, whose offset from the
    chunk's first row is the 32-bit `pl`, and strip-local column `lx`.
    Each ring `n` declares `n_r`, `n_D` (rows kept, a power of two; row r
    of the chunk sits in slot (r - n_YLO) & (n_D - 1)), `n_YLO`, `n_XLO`
    and `n_C`.

    Rank 1 has no march: only `RunGen` prints it, for the windows kernel
    (`backend/windows.py`), which reads every tap through its own load."""

    def __init__(self, program: StencilProgram, rings: set[str]):
        if program.rank not in (1, 2, 3):
            raise ValueError(f"the device kernels take ranks 1 to 3, not {program.rank}")
        super().__init__(program, ["p", "ly", "lx"][3 - program.rank:])
        if self.acc128:
            raise UnsupportedTypeError(
                f"program {program.name!r} uses >64-bit integers")
        self.rings = rings

    def ctype(self, t):
        return _device(super().ctype(t))

    def tap(self, name, off):
        if name not in self.rings:
            raise ValueError(f"{name!r} is tapped but has no shared-memory ring")
        t = self.p.tensors[name].type
        if self.p.rank == 3:
            oz, oy, ox = off
            at = (f"{ring_var(name)}[soda_slot(p + ({oz}), z0 + {name}_ZLO, "
                  f"{name}_D) * {name}_PS + (ly + ({oy}) - {name}_YLO) * {name}_C"
                  f" + (lx + ({ox}) - {name}_XLO)]")
        else:
            oy, ox = off
            at = (f"{ring_var(name)}[((pl + ({oy}) - {name}_YLO) & ({name}_D - 1))"
                  f" * {name}_C + (lx + ({ox}) - {name}_XLO)]")
        return f"(({self.ctype(t)})({at}))", t

    def emit(self, e):
        code, t = super().emit(e)
        return _device(code), t

    def cast_to(self, code, src, dst):
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
               load: Callable[[str, tuple[int, ...]], str]) -> list[str]:
    """C lines of one column run of `rows` rows: every tap of `stages`
    loaded into a register once (`load(q, key)` is the ring read, relative
    to the run's first row `pb`), then, for each row r (`rowvar` = pb + r),
    each stage's value `v_<stage>_<r>`: its expression where `computes` (a
    C condition) holds, else zero; `after[stage]` (lines that may use `v`
    and `rowvar`) follow the value where it is computed."""
    program = gen.p
    gen.loads = {}
    body = []
    for r in range(rows):
        gen.row = r
        body.append(f"{{  const int {rowvar} = pb + {r};")
        for n in stages:
            t = program.tensors[n].type
            ct = storage_ctype(t)
            code, bt = gen.emit(program.tensors[n].expr)
            for a, b in in_regs.items():
                code = code.replace(a, b)
            body += [f"  {{  {ct} v = {ct}(0);",
                     f"    if ({computes}) {{",
                     f"      const {gen.ctype(bt)} __v = {code};",
                     f"      v = ({ct})({gen.cast_to('__v', bt, t)});",
                     *("    " + ln for ln in after.get(n, [])),
                     "    }",
                     f"    v_{n}_{r} = v;",
                     "  }"]
        body.append("}")
    decl = [f"{storage_ctype(program.tensors[n].type)} v_{n}_{r};"
            for r in range(rows) for n in stages]
    loads = [f"const {storage_ctype(program.tensors[q].type)} {var} = {load(q, key)};"
             for var, (q, key) in sorted(gen.loads.items())]
    return loads + decl + body


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
