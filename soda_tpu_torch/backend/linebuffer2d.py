"""The 2-D line-buffer row-march: kernel source, plain version and wrapper.

Replaces `soda_tpu/backend/_linebuffer.py::build_linebuffer2d_group_fn`:
one fused group of a rank-2 single-sweep program over the whole grid.
`kernel_source` generates the group's CUDA kernel from the IR around the
march in `csrc/linebuffer2d.cuh` (see the note there for the design and
what bounds it); `group_plain` is the same group evaluated over full
grids by the plain PyTorch path; `GroupKernel` is the wrapper.

A CTA owns a strip of TX columns and a chunk of BY rows, and marches its
rows RB at a time.  Each step loads the RB leading rows of every input
ring, computes the RB leading rows of every ring stage in topological
order, then the RB output rows that no stage of the group reads, with a
barrier after each phase.  Steps before the chunk's first row only fill
the rings (the warm-up).

A stage is computed in column runs (`column_run`): a thread takes one
column and a run of consecutive rows of the step, loads every tap of the
run from the rings into registers once (a row that neighbouring rows
also read is loaded once), and computes the rows with 32-bit row and
column arithmetic.  The CTA has a thread for every column of its widest
stage row (`threads`), so a step's runs of a stage go in one pass; a
stage that calls libm runs one row at a time (`run_rows`).

The kernel computes every stage with the oracle's zero-fill semantics: an
input read outside the grid is zero, and so is an intermediate stage's
value there.  It therefore matches `interp/numpy_ref.py` on the whole
grid, multi-stage groups included.
"""

from __future__ import annotations

import math

from ..ir.program import StencilProgram
from ..plan.planner import GroupPlan
from . import linebuffer
from .cuda_codegen import RunGen, column_run, ring_var, run_rows, storage_ctype
from .linebuffer import entry_points, kernel_args, min_blocks
from .linebuffer import group_plain  # noqa: F401  (the plain version)

# kernel launches made through GroupKernel (the CPU plain path never counts)
LAUNCHES = 0

# params of at most this many elements are read into registers once per
# thread instead of from device memory at every cell
PARAM_REGS_MAX = 64


def _widest(g: GroupPlan) -> int:
    """The widest row a stage computes (a ring stage's ring width, or the
    strip for outputs no stage reads), in whole warps."""
    stage_rings = [r.cols for r in g.rings if r.name in g.stages]
    return -(-max(stage_rings + [g.tile[1]]) // 32) * 32


def threads(g: GroupPlan) -> int:
    """Threads per CTA: a multiple of the widest row of at least 256, so
    that a step's column runs of a stage go in one pass."""
    w = _widest(g)
    return min(1024, w * -(-256 // w))


def _segments(gen: RunGen, stages: list[str], width: int, rb: int, nt: int,
              in_regs: dict[str, str]) -> int:
    """Rows per column run of a step's RB rows: as many as leave one run
    per thread (a step's runs of the stage in one pass of NT threads) and
    whose taps fit the registers (`run_rows`)."""
    runs = max(1, min(rb, nt // width))
    while rb % runs:
        runs -= 1
    return run_rows(gen, stages, [d for d in range(1, rb // runs + 1)
                                  if rb % d == 0], in_regs)


def _item(width: str, runs: int) -> list[str]:
    """Column `c` and run `s` of work item `i`; with one run per column the
    run is 0 at compile time, so a run's row arithmetic depends on the step
    alone."""
    if runs == 1:
        return ["        const int c = i, s = 0;"]
    return [f"        const int c = i % {width}, s = i / {width};"]


def kernel_source(program: StencilProgram, g: GroupPlan,
                  kernel: str = "soda_lb2d_kernel", note: str = "") -> str:
    """CUDA C++ for one rank-2 group under one plan (RB, TX, BY, rings);
    the `__global__` is named `kernel`, and `note` (comment lines) heads
    the source."""
    rb, tx = g.tile
    ring_names = [r.name for r in g.rings]
    gen = RunGen(program, set(ring_names))
    out_set = set(g.outputs)

    def ct(n: str) -> str:
        return storage_ctype(program.tensors[n].type)

    args, names = kernel_args(program, g)
    dims = "int64_t d0, int64_t d1"

    L = [*note.splitlines(),
         f"// generated by soda_tpu_torch for kernel `{program.name}`, "
         f"stages {g.stages}",
         '#include "linebuffer2d.cuh"', "",
         "namespace {",
         f"constexpr int RB = {rb}, TX = {tx}, BY = {g.bz}, WARM = {g.warm};",
         "#ifdef SODA_HOST_EMULATION",
         "constexpr int NT = 1;  // one thread per CTA",
         "#else",
         f"constexpr int NT = {threads(g)};",
         "#endif",
         "constexpr int WSTEPS = (WARM + RB - 1) / RB;  // warm-up steps per chunk",
         f"constexpr size_t SMEM_BYTES = {g.smem_bytes};"]
    for r in g.rings:
        (ylo, yhi), (xlo, _) = r.span
        L.append(f"// ring {r.name}: span {r.span}")
        L.append(f"constexpr int {r.name}_D = {r.depth}, {r.name}_YLO = {ylo}, "
                 f"{r.name}_YHI = {yhi}, {r.name}_XLO = {xlo}, "
                 f"{r.name}_C = {r.cols};")
        L.append(f"constexpr size_t {r.name}_OFF = {r.offset};")
    L += ["}  // namespace", "",
          "SODA_BODY void soda_body(int bx, int by, int tid, unsigned char* smem,",
          "                       " + ", ".join(args + [dims]) + ") {"]
    for r in g.rings:
        L.append(f"  {ct(r.name)}* {ring_var(r.name)} = "
                 f"reinterpret_cast<{ct(r.name)}*>(smem + {r.name}_OFF);")
    in_regs = {}
    for n in g.params:
        size = math.prod(program.params[n].shape)
        if size <= PARAM_REGS_MAX:
            in_regs[f"{n}_p["] = f"{n}_v["
            L += [f"  {storage_ctype(program.params[n].type)} {n}_v[{size}];",
                  "#pragma unroll",
                  f"  for (int k = 0; k < {size}; ++k) {n}_v[k] = {n}_p[k];"]
    L += ["  const int64_t y0 = (int64_t)by * BY, x0 = (int64_t)bx * TX;",
          "  const int64_t yend = y0 + BY < d0 ? y0 + BY : d0;",
          "  // the grid in chunk-local rows and strip-local columns (32-bit)",
          "  const int64_t big = (int64_t)1 << 30;",
          "  const int ylo_l = (int)-(y0 < big ? y0 : big), xlo_l = (int)-(x0 < big ? x0 : big);",
          "  const int yhi_l = (int)(d0 - y0 < big ? d0 - y0 : big);",
          "  const int xhi_l = (int)(d1 - x0 < big ? d1 - x0 : big);",
          "  const int ylen = (int)(yend - y0);",
          "  for (int64_t y = y0 - WSTEPS * RB; y < yend; y += RB) {"]
    # 1. the RB leading rows of every input ring
    for n in g.external_inputs:
        L.append(f"    soda_load_rows<RB, {n}_C, NT>({ring_var(n)}, {n}_g, y + {n}_YHI, "
                 f"y0 + {n}_YLO, {n}_D, x0 + {n}_XLO, d0, d1, tid);")
    L.append("    SODA_SYNC();")

    # 2. the RB leading rows of every ring stage, in topological order: a
    # thread takes a column and computes its RB rows from taps it loads
    # from the rings once per run
    def load(q: str, key: tuple[int, ...]) -> str:
        k, ox = key
        return (f"{ring_var(q)}[((pb + ({k}) - {q}_YLO) & ({q}_D - 1)) * {q}_C "
                f"+ (lx + ({ox}) - {q}_XLO)]")

    nt = threads(g)
    for n in g.stages:
        if n not in ring_names:
            continue
        after = {n: [f"  if (p >= 0 && p < ylen && lx >= 0 && lx < TX)",
                     f"    {n}_g[(y0 + p) * d1 + (x0 + lx)] = v;"]
                 } if n in out_set else {}
        width = next(r.cols for r in g.rings if r.name == n)
        rs = _segments(gen, [n], width, rb, nt, in_regs)
        L += [f"    {{  // stage {n} (ring), runs of {rs} row(s)",
              f"      for (int i = tid; i < {n}_C * {rb // rs}; i += NT) {{",
              *_item(f"{n}_C", rb // rs),
              f"        const int lx = c + {n}_XLO;",
              "        const bool xin = lx >= xlo_l && lx < xhi_l;",
              f"        const int pb = (int)(y - y0) + {n}_YHI + s * {rs};"]
        L += ["        " + ln for ln in column_run(
            gen, [n], rs, "p", f"xin && p >= ylo_l && p < yhi_l && p >= {n}_YLO",
            in_regs, after, load)]
        L += [f"        if (pb + {r} >= {n}_YLO) {ring_var(n)}"
              f"[((pb + {r} - {n}_YLO) & ({n}_D - 1)) * {n}_C + c] = v_{n}_{r};"
              for r in range(rs)]
        L += ["      }", "    }", "    SODA_SYNC();"]
    # 3. outputs no stage of the group reads: straight to device memory
    direct = [n for n in g.outputs if n not in ring_names]
    if direct:
        after = {n: [f"  {n}_g[(y0 + p) * d1 + (x0 + lx)] = v;"] for n in direct}
        rs = _segments(gen, direct, tx, rb, nt, in_regs)
        L += [f"    if (y >= y0) {{  // outputs {direct}, runs of {rs} row(s)",
              f"      for (int i = tid; i < TX * {rb // rs}; i += NT) {{",
              *_item("TX", rb // rs),
              "        const int lx = c;",
              "        const bool xin = lx < xhi_l;",
              f"        const int pb = (int)(y - y0) + s * {rs};"]
        L += ["        " + ln for ln in column_run(
            gen, direct, rs, "p", "xin && p < ylen", in_regs, after, load)]
        L += ["      }", "    }", "    SODA_SYNC();"]
    L += ["  }", "}", ""]

    call = ", ".join(names + ["d0", "d1"])
    L += entry_points(
        kernel, ", ".join(args + [dims]), call,
        "blockIdx.x, blockIdx.y, threadIdx.x",
        "(unsigned)((d1 + TX - 1) / TX), (unsigned)((d0 + BY - 1) / BY)",
        ["  for (int by = 0; by < (int)((d0 + BY - 1) / BY); ++by)",
         "    for (int bx = 0; bx < (int)((d1 + TX - 1) / TX); ++bx)",
         "      soda_body(bx, by, 0, smem.data(),"], min_blocks(g, threads(g)))
    return "\n".join(L)


class GroupKernel(linebuffer.GroupKernel):
    """Wrapper of one rank-2 group's kernel: `linebuffer.GroupKernel` with
    the row-march's source, rank 2 and this module's `LAUNCHES`."""

    rank = 2
    prefix = "lb2d"

    def _generate(self) -> str:
        return kernel_source(self.program, self.group)

    def _count(self) -> None:
        global LAUNCHES
        LAUNCHES += 1
