"""The windows kernel: kernel source, plain version and wrapper.

Replaces TPU kernel 4, `soda_tpu/backend/pallas.py::build_group_fn`'s
windows branch (body `_build_kernel`, host padding `_pad_input`; rank 1
through `_lift_rank1`): any group of a rank-1, -2 or -3 program, one sweep
per call, evaluated block by block.  It runs every rank-1 program, every
group pinned with `plan(..., block=)`, and every stage whose line-buffer
rings fit no tile of the shared-memory budget (`plan/planner.py`).
`kernel_source` generates the group's CUDA kernel from the IR around the
window loader and the direct tap of `csrc/windows.cuh` (see the note there
for the design and what bounds it); `group_plain` is the plain version;
`GroupKernel` is the wrapper.

A CTA owns one block.  The code works in three dims whatever the rank
(a rank-1 or rank-2 program has unit leading dims): the block's local
coordinates are (lz, ly, lx), its corner in the grid (z0, y0, x0).  Each
windowed input is loaded whole (block + span) into shared memory; each
stage another stage reads is computed over its exact extent (block + its
span) into shared memory, zero outside the grid; the other outputs over
the block, straight to device memory; a barrier after each phase.  A
stage is computed in column runs along y (`column_run`: a thread takes a
column and several rows, each tap loaded into a register once), rank 1
one cell at a time.  An input read directly is tapped from device memory
with a bounds check that a CTA whose whole window lies in the grid skips.

The kernel computes every stage with the oracle's zero-fill semantics: an
input read outside the grid is zero, and so is an intermediate stage's
value there.  It therefore matches `interp/numpy_ref.py` on the whole
grid.  (The TPU kernel evaluates intermediates from zero-padded inputs,
which differs from the oracle inside the rim, docs/SEMANTICS.md.)
"""

from __future__ import annotations

import math

from ..ir.program import StencilProgram
from ..plan.planner import NTHREADS, GroupPlan
from . import linebuffer
from .cuda_codegen import RunGen, column_run, run_rows, storage_ctype
from .linebuffer import entry_points, kernel_args, min_blocks
from .linebuffer import group_plain  # noqa: F401  (the plain version)
from .linebuffer2d import PARAM_REGS_MAX

# kernel launches made through GroupKernel (the CPU plain path never counts)
LAUNCHES = 0

# rows a column run may take (the most whose taps fit the registers)
RUN_ROWS = (1, 2, 4, 8)

NOTE = """\
// The windows kernel (replaces TPU kernel 4, soda_tpu/backend/pallas.py::
// build_group_fn, windows branch).  Bound on the H100: one read of every
// input and one write of every output over 3.35 TB/s, or the operations,
// weighted by type, over 67 TFLOP/s, whichever is larger."""


def ctas_per_sm(g: GroupPlan) -> int:
    """CTAs per SM the registers must allow (`__launch_bounds__`):
    `linebuffer.min_blocks`, but at most 2 (128 registers a thread) for a
    group that reads an input tap by tap, which holds every tap of a cell
    in a register (49 f64 taps of the radius-8 star: 121 registers).  At 4
    CTAs an SM the star spilled and ran 1.2-1.5x slower (NVIDIA H100 80GB
    HBM3 at 700 W, PERF.md)."""
    n = min_blocks(g, NTHREADS)
    return min(n, 2) if g.direct else n


def _pad(t: tuple, fill) -> tuple:
    """A per-dim tuple of the program's rank as three dims (leading fill)."""
    return (fill,) * (3 - len(t)) + tuple(t)


def kernel_source(program: StencilProgram, g: GroupPlan) -> str:
    """CUDA C++ for one windows group under its plan (block, windows)."""
    if g.kernel != "windows":
        raise ValueError(f"not a windows plan: {g.kernel}")
    rank = program.rank
    held = {w.name: w for w in g.windows}
    gen = RunGen(program, set(held) | set(g.direct))
    out_set = set(g.outputs)
    b0, b1, b2 = _pad(g.block, 1)

    def ct(n: str) -> str:
        return storage_ctype(program.tensors[n].type)

    args, names = kernel_args(program, g)
    dims = ", ".join(f"int64_t d{d}" for d in range(rank))
    L = [*NOTE.splitlines(),
         f"// generated by soda_tpu_torch for kernel `{program.name}`, "
         f"stages {g.stages}",
         '#include "windows.cuh"', "",
         "namespace {",
         f"constexpr int B0 = {b0}, B1 = {b1}, B2 = {b2};",
         "#ifdef SODA_HOST_EMULATION",
         "constexpr int NT = 1;  // one thread per CTA",
         "#else",
         f"constexpr int NT = {NTHREADS};",
         "#endif",
         f"constexpr size_t SMEM_BYTES = {g.smem_bytes};"]
    for w in g.windows:
        lo = _pad(tuple(s[0] for s in w.span), 0)
        ext = _pad(w.extent, 1)
        L += [f"// {'window' if w.name in g.external_inputs else 'stage'} "
              f"{w.name}: span {w.span}",
              f"constexpr int {w.name}_LO0 = {lo[0]}, {w.name}_LO1 = {lo[1]}, "
              f"{w.name}_LO2 = {lo[2]}, {w.name}_E0 = {ext[0]}, "
              f"{w.name}_E1 = {ext[1]}, {w.name}_E2 = {ext[2]};",
              f"constexpr size_t {w.name}_OFF = {w.offset};"]
    L += ["}  // namespace", "",
          "SODA_BODY void soda_body(int bx, int by, int bz, int tid, unsigned char* smem,",
          "                       " + ", ".join(args + [dims]) + ") {",
          "  const int64_t D0 = {}, D1 = {}, D2 = {};".format(
              *_pad(tuple(f"d{d}" for d in range(rank)), "1"))]
    for w in g.windows:
        L.append(f"  {ct(w.name)}* {w.name}_s = reinterpret_cast<{ct(w.name)}*>"
                 f"(smem + {w.name}_OFF);")
    in_regs = {}
    for n in g.params:
        size = math.prod(program.params[n].shape)
        if size <= PARAM_REGS_MAX:
            in_regs[f"{n}_p["] = f"{n}_v["
            L += [f"  {storage_ctype(program.params[n].type)} {n}_v[{size}];",
                  "#pragma unroll",
                  f"  for (int k = 0; k < {size}; ++k) {n}_v[k] = {n}_p[k];"]
    # the block's corner and the grid in block-local coordinates (32-bit)
    L.append("  const int64_t big = (int64_t)1 << 30;")
    for d, (o, b) in enumerate(zip(("z0", "y0", "x0"), ("bz", "by", "bx"))):
        if d < 3 - rank:
            L.append(f"  const int64_t {o} = 0; const int lo{d} = 0, hi{d} = 1;")
        else:
            L += [f"  const int64_t {o} = (int64_t){b} * B{d};",
                  f"  const int lo{d} = (int)-({o} < big ? {o} : big), "
                  f"hi{d} = (int)(D{d} - {o} < big ? D{d} - {o} : big);"]
    for n in g.direct:
        # the whole window of a direct input inside the grid: no checks
        lo = _pad(tuple(s[0] for s in g.spans[n]), 0)
        hi = _pad(tuple(s[1] for s in g.spans[n]), 0)
        inside = " && ".join(f"lo{d} <= {lo[d]} && B{d} + {hi[d]} <= hi{d}"
                             for d in range(3))
        L.append(f"  const bool {n}_in = {inside};")
    # 1. the windows of the windowed inputs
    loads = [n for n in g.external_inputs if n in held]
    for n in loads:
        L.append(f"  soda_load_window<{n}_E0, {n}_E1, {n}_E2, NT>({n}_s, {n}_g, "
                 f"z0 + {n}_LO0, y0 + {n}_LO1, x0 + {n}_LO2, D0, D1, D2, tid);")
    if loads:
        L.append("  SODA_SYNC();")

    def load(q: str, key: tuple[int, ...]) -> str:
        k0, k1, k2 = _pad(key, 0)
        if q in held:
            return (f"{q}_s[((lz + ({k0}) - {q}_LO0) * {q}_E1 + (pb + ({k1}) - "
                    f"{q}_LO1)) * {q}_E2 + (lx + ({k2}) - {q}_LO2)]")
        check = " && ".join(f"{v} + ({k}) >= lo{d} && {v} + ({k}) < hi{d}"
                            for d, (v, k) in enumerate(zip(("lz", "pb", "lx"), (k0, k1, k2))))
        return (f"(({q}_in || ({check})) ? soda_ldg({q}_g + (go + (({k0}) * D1 + ({k1})) "
                f"* D2 + ({k2}))) : {ct(q)}(0))")

    def item(e1: int, e2: str, lo: tuple, rs: int, xin: str) -> list[str]:
        """A work item of a column run: column c, run s of rows, plane a."""
        runs = -(-e1 // rs)
        lines = [f"      const int c = i % {e2}, t = i / {e2}, s = t % {runs}, a = t / {runs};",
                 f"      const int r0 = s * {rs} < {e1 - rs} ? s * {rs} : {e1 - rs};",
                 f"      const int lz = a + ({lo[0]}), pb = r0 + ({lo[1]}), lx = c + ({lo[2]});",
                 f"      const bool xin = {xin};"]
        if g.direct:
            lines.append("      const int64_t go = ((z0 + lz) * D1 + (y0 + pb)) * D2 + (x0 + lx);")
        return lines

    def gstore(n: str) -> str:
        return f"    {n}_g[((z0 + lz) * D1 + (y0 + ly)) * D2 + (x0 + lx)] = v;"

    def rows_for(stages: list[str], e1: int) -> int:
        cands = [c for c in RUN_ROWS if c <= e1] if rank > 1 else [1]
        return run_rows(gen, stages, cands, in_regs)

    # 2. every stage another stage reads, over its exact extent
    for n in g.stages:
        if n not in held:
            continue
        w = held[n]
        lo = _pad(tuple(s[0] for s in w.span), 0)
        e0, e1, e2 = _pad(w.extent, 1)
        after = {n: ["  if (lz >= 0 && lz < B0 && ly >= 0 && ly < B1 && lx >= 0 && lx < B2)",
                     gstore(n)]} if n in out_set else {}
        rs = rows_for([n], e1)
        L += [f"  {{  // stage {n} (shared), runs of {rs} row(s)",
              f"    for (int i = tid; i < {e0 * e2 * -(-e1 // rs)}; i += NT) {{",
              *item(e1, str(e2), lo, rs,
                    "lz >= lo0 && lz < hi0 && lx >= lo2 && lx < hi2")]
        L += ["      " + ln for ln in column_run(
            gen, [n], rs, "ly", "xin && ly >= lo1 && ly < hi1", in_regs, after, load)]
        L += [f"      {n}_s[(a * {e1} + r0 + {r}) * {e2} + c] = v_{n}_{r};" for r in range(rs)]
        L += ["    }", "  }", "  SODA_SYNC();"]
    # 3. outputs no stage of the group reads: over the block, to device memory
    direct_out = [n for n in g.outputs if n not in held]
    if direct_out:
        rs = rows_for(direct_out, b1)
        L += [f"  {{  // outputs {direct_out}, runs of {rs} row(s)",
              f"    for (int i = tid; i < {b0 * b2 * -(-b1 // rs)}; i += NT) {{",
              *item(b1, "B2", (0, 0, 0), rs, "lz < hi0 && lx < hi2")]
        L += ["      " + ln for ln in column_run(
            gen, direct_out, rs, "ly", "xin && ly < hi1", in_regs,
            {n: [gstore(n)] for n in direct_out}, load)]
        L += ["    }", "  }"]
    L += ["}", ""]

    call = ", ".join(names + [f"d{d}" for d in range(rank)])
    per_dim = [f"(unsigned)((d{d} + B{d + 3 - rank} - 1) / B{d + 3 - rank})"
               for d in range(rank)]
    grid = list(reversed(per_dim)) + ["1u"] * (3 - rank)
    loops = [f"(int)((d{d} + B{d + 3 - rank} - 1) / B{d + 3 - rank})" for d in range(rank)]
    loops = ["1"] * (3 - rank) + loops
    L += entry_points(
        "soda_win_kernel", ", ".join(args + [dims]), call,
        "blockIdx.x, blockIdx.y, blockIdx.z, threadIdx.x", ", ".join(grid),
        [f"  for (int bz = 0; bz < {loops[0]}; ++bz)",
         f"    for (int by = 0; by < {loops[1]}; ++by)",
         f"      for (int bx = 0; bx < {loops[2]}; ++bx)",
         "        soda_body(bx, by, bz, 0, smem.data(),"],
        ctas_per_sm(g))
    return "\n".join(L)


class GroupKernel(linebuffer.GroupKernel):
    """Wrapper of one windows group's kernel (ranks 1 to 3):
    `linebuffer.GroupKernel` with the windows source, the program's rank
    and this module's `LAUNCHES`."""

    def __init__(self, program: StencilProgram, g: GroupPlan):
        if g.kernel != "windows":
            raise ValueError(f"not a windows plan: {g.kernel}")
        self.rank = program.rank
        self.prefix = f"win{program.rank}d"
        super().__init__(program, g)

    def _generate(self) -> str:
        return kernel_source(self.program, self.group)

    def _count(self) -> None:
        global LAUNCHES
        LAUNCHES += 1
