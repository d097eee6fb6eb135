"""The 2-D line-buffer row-march: kernel source, plain version and wrapper.

Replaces `soda_tpu/backend/_linebuffer.py::build_linebuffer2d_group_fn`:
one fused group of a rank-2 program over the whole grid (and, through
`backend/sweeps.py`, a cascade of fused sweeps).  `kernel_source`
generates the group's CUDA kernel from the IR around the march in
`csrc/linebuffer2d.cuh` (see the note there for the design and what
bounds it); `group_plain` is the same group evaluated over full grids by
the plain PyTorch path; `GroupKernel` is the wrapper.

A CTA owns a strip of TX columns and a chunk of BY rows, and marches its
rows RB at a time, one wait per step.  During step s it copies the RB
rows of step s + 1 of every input ring (16-byte `cp.async` or element
loads through registers, `GroupPlan.load`) and computes each stage at
level L (`GroupPlan.levels`) at the rows of step s - (L - 1): its leading
RB rows (or, for outputs no stage of the group reads, RB output rows).
With `GroupPlan.sync` "skew" no stage reads a row written in the same
step, so the stages need no barrier between them; with "barrier" every
stage is at level 1 and a barrier follows each stage but the last.  The
step ends with the wait.  Steps before the chunk's first row only fill
the rings (the warm-up), and the last DRAIN steps only run the lagging
stages.

A stage is computed in column runs (`column_run`): a thread takes one
column and a run of consecutive rows of the step, loads every tap of the
run from the rings into registers once (a row that neighbouring rows
also read is loaded once), and computes the rows with 32-bit row and
column arithmetic; a run wholly inside the grid skips the per-row
zero-fill checks.  The CTA has a thread for every column of its widest
stage row (`GroupPlan.threads`), so a step's runs of a stage go in one
pass; a stage that calls libm runs one row at a time (`run_rows`).

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
        return ["          const int c = i, s = 0;"]
    return [f"          const int c = i % {width}, s = i / {width};"]


def kernel_source(program: StencilProgram, g: GroupPlan,
                  kernel: str = "soda_lb2d_kernel", note: str = "") -> str:
    """CUDA C++ for one rank-2 group under one plan (RB, TX, BY, rings,
    levels, load path); the `__global__` is named `kernel`, and `note`
    (comment lines) heads the source."""
    rb, tx = g.tile
    ring_names = [r.name for r in g.rings]
    gen = RunGen(program, set(ring_names))
    out_set = set(g.outputs)
    nt = g.threads
    vector = g.load == "vector"

    def ct(n: str) -> str:
        return storage_ctype(program.tensors[n].type)

    args, names = kernel_args(program, g)
    dims = "int64_t d0, int64_t d1"

    L = [*note.splitlines(),
         f"// generated by soda_tpu_torch for kernel `{program.name}`, "
         f"stages {g.stages}, levels {g.levels}, {g.sync} sync, "
         f"{g.load} row copies",
         '#include "linebuffer2d.cuh"', "",
         "namespace {",
         f"constexpr int RB = {rb}, TX = {tx}, BY = {g.bz}, WARM = {g.warm};",
         "#ifdef SODA_HOST_EMULATION",
         "constexpr int NT = 1;  // one thread per CTA",
         "#else",
         f"constexpr int NT = {nt};",
         "#endif",
         "constexpr int WSTEPS = (WARM + RB - 1) / RB;  // warm-up steps per chunk",
         f"constexpr int DRAIN = {max(g.levels.values()) - 1};  "
         "// steps the deepest level lags the first",
         f"constexpr size_t SMEM_BYTES = {g.smem_bytes};"]
    for r in g.rings:
        (ylo, yhi), _ = r.span
        L.append(f"// ring {r.name}: span {r.span}")
        L.append(f"constexpr int {r.name}_D = {r.depth}, {r.name}_YLO = {ylo}, "
                 f"{r.name}_YHI = {yhi}, {r.name}_XA = {r.col0}, "
                 f"{r.name}_C = {r.cols};")
        L.append(f"constexpr size_t {r.name}_OFF = {r.offset};")
    L += ["}  // namespace", "",
          "// a stage's work items; in reverse under the hazard emulation",
          "#ifdef SODA_HAZARD",
          "#define SODA_ITEMS(i, n) for (int i = (n) - 1 - tid; i >= 0; i -= NT)",
          "#else",
          "#define SODA_ITEMS(i, n) for (int i = tid; i < (n); i += NT)",
          "#endif", "",
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
          "  const int nsteps = (ylen + RB - 1) / RB;  // the chunk's own steps"]

    def fetch(n: str, step: str) -> list[str]:
        where = (f"y0 + (int64_t)({step}) * RB + {n}_YHI, y0 + {n}_YLO, {n}_D, "
                 f"x0 + {n}_XA, d0, d1, tid")
        if vector:
            return [f"soda_fetch_rows_v<RB, {n}_C, NT>({ring_var(n)}, {n}_g, {where});"]
        return [f"soda_fetch_rows_s<RB, {n}_C, NT>({n}_pre, {ring_var(n)}, {n}_g, {where});"]

    def store(n: str, step: str) -> list[str]:
        if vector:
            return []
        return [f"soda_store_rows_s<RB, {n}_C, NT>({ring_var(n)}, {n}_pre, "
                f"y0 + (int64_t)({step}) * RB + {n}_YHI, y0 + {n}_YLO, {n}_D, tid);"]

    def pre(n: str) -> list[str]:
        return [] if vector else [
            f"{ct(n)} {n}_pre[soda_per<RB, {n}_C, NT>()];"]

    ins = g.external_inputs
    L += ["  soda_cta_begin();",
          "  {  // the input rows of the first step",
          *("    " + ln for n in ins for ln in pre(n) + fetch(n, "-WSTEPS")
            + store(n, "-WSTEPS")),
          "  }",
          "  soda_step_wait();",
          "  for (int st = -WSTEPS; st < nsteps + DRAIN; ++st) {",
          "    // 1. the rows of step st + 1 of every input ring, in flight while",
          "    // this step computes",
          "    const bool ahead = st + 1 < nsteps;",
          *("    " + ln for n in ins for ln in pre(n)),
          "    if (ahead) {",
          *("      " + ln for n in ins for ln in fetch(n, "st + 1")),
          "    }"]

    # 2. every stage at the rows of its own step t = st - (level - 1): a
    # thread takes a column and computes its run of rows from taps it
    # loads from the rings once per run
    def load(q: str, key: tuple[int, ...]) -> str:
        k, ox = key
        return (f"{ring_var(q)}[((pb + ({k}) - {q}_YLO) & ({q}_D - 1)) * {q}_C "
                f"+ (lx + ({ox}) - {q}_XA)]")

    blocks = []
    for n in g.stages:
        if n not in ring_names:
            continue
        level = g.levels[n]
        after = {n: ["  if (p >= 0 && p < ylen && lx >= 0 && lx < TX)",
                     f"    {n}_g[(y0 + p) * d1 + (x0 + lx)] = v;"]
                 } if n in out_set else {}
        width = next(r.cols for r in g.rings if r.name == n)
        rs = _segments(gen, [n], width, rb, nt, in_regs)
        B = [f"    {{  // stage {n} (ring, level {level}), runs of {rs} row(s)",
             f"      const int t = st - {level - 1};",
             "      if (t >= -WSTEPS && t < nsteps) {",
             f"        SODA_ITEMS(i, {n}_C * {rb // rs}) {{",
             *_item(f"{n}_C", rb // rs),
             f"          const int lx = c + {n}_XA;",
             "          const bool xin = lx >= xlo_l && lx < xhi_l;",
             f"          const int pb = t * RB + {n}_YHI + s * {rs};",
             "          // the whole run inside the grid and the ring's rows",
             f"          const bool full = xin && pb >= ylo_l && pb + {rs} <= yhi_l"
             f" && pb >= {n}_YLO;"]

        def stores(checked: bool, n=n, rs=rs) -> list[str]:
            return [(f"if (pb + {r} >= {n}_YLO) " if checked else "")
                    + f"{ring_var(n)}[((pb + {r} - {n}_YLO) & ({n}_D - 1)) * {n}_C + c]"
                    f" = v_{n}_{r};" for r in range(rs)]

        B += ["          " + ln for ln in column_run(
            gen, [n], rs, "p", f"xin && p >= ylo_l && p < yhi_l && p >= {n}_YLO",
            in_regs, after, load, uniform="full", tail=stores)]
        blocks.append(B + ["        }", "      }", "    }"])
    # outputs no stage of the group reads: straight to device memory
    direct = [n for n in g.outputs if n not in ring_names]
    if direct:
        level = g.levels[direct[0]]
        after = {n: [f"  {n}_g[(y0 + p) * d1 + (x0 + lx)] = v;"] for n in direct}
        rs = _segments(gen, direct, tx, rb, nt, in_regs)
        B = [f"    {{  // outputs {direct} (level {level}), runs of {rs} row(s)",
             f"      const int t = st - {level - 1};",
             "      if (t >= 0 && t < nsteps) {",
             f"        SODA_ITEMS(i, TX * {rb // rs}) {{",
             *_item("TX", rb // rs),
             "          const int lx = c;",
             "          const bool xin = lx < xhi_l;",
             f"          const int pb = t * RB + s * {rs};",
             f"          const bool full = xin && pb + {rs} <= ylen;"]
        B += ["          " + ln for ln in column_run(
            gen, direct, rs, "p", "xin && p < ylen", in_regs, after, load,
            uniform="full")]
        blocks.append(B + ["        }", "      }", "    }"])
    if g.sync == "barrier":
        # every stage at level 1: a barrier between a stage and its readers
        L += ["    // 2. the stages, a barrier after each",
              *(ln for b in blocks[:-1] for ln in b + ["    SODA_SYNC();"]),
              *blocks[-1]]
    else:
        L += ["    // 2. the stages, each at its own step: none reads a row written",
              "    // in this step (in reverse under the hazard emulation)",
              "#ifndef SODA_HAZARD",
              *(ln for b in blocks for ln in b),
              "#else",
              *(ln for b in reversed(blocks) for ln in b),
              "#endif"]
    stores = [ln for n in ins for ln in store(n, "st + 1")]
    if stores:
        L += ["    if (ahead) {  // 3. the rows of step st + 1 into the rings",
              *("      " + ln for ln in stores), "    }"]
    L += ["    soda_step_wait();", "  }", "}", ""]

    call = ", ".join(names + ["d0", "d1"])
    L += entry_points(
        kernel, ", ".join(args + [dims]), call,
        "blockIdx.x, blockIdx.y, threadIdx.x",
        "(unsigned)((d1 + TX - 1) / TX), (unsigned)((d0 + BY - 1) / BY)",
        ["  for (int by = 0; by < (int)((d0 + BY - 1) / BY); ++by)",
         "    for (int bx = 0; bx < (int)((d1 + TX - 1) / TX); ++bx)",
         "      soda_body(bx, by, 0, smem.data(),"], min_blocks(g, nt))
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
