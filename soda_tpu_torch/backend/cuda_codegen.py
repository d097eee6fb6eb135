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
"""

from __future__ import annotations

from ..ir.program import StencilProgram
from ..ir.types import ScalarType, UnsupportedTypeError
from .cpp_gen import _Gen


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
    and `n_C`."""

    def __init__(self, program: StencilProgram, rings: set[str]):
        if program.rank not in (2, 3):
            raise ValueError(f"the device kernels take ranks 2 and 3, not {program.rank}")
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
