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

The kernel computes every stage with the oracle's zero-fill semantics: an
input read outside the grid is zero, and so is an intermediate stage's
value there.  It therefore matches `interp/numpy_ref.py` on the whole
grid, multi-stage groups included.
"""

from __future__ import annotations

import math

from ..ir.program import StencilProgram
from ..plan.planner import NTHREADS, GroupPlan
from . import linebuffer
from .cuda_codegen import DeviceGen, ring_var, storage_ctype
from .linebuffer import entry_points, kernel_args, stage_value
from .linebuffer import group_plain  # noqa: F401  (the plain version)

# kernel launches made through GroupKernel (the CPU plain path never counts)
LAUNCHES = 0

# params of at most this many elements are read into registers once per
# thread instead of from device memory at every cell
PARAM_REGS_MAX = 64


def kernel_source(program: StencilProgram, g: GroupPlan) -> str:
    """CUDA C++ for one rank-2 group under one plan (RB, TX, BY, rings)."""
    rb, tx = g.tile
    ring_names = [r.name for r in g.rings]
    gen = DeviceGen(program, set(ring_names))
    out_set = set(g.outputs)

    def ct(n: str) -> str:
        return storage_ctype(program.tensors[n].type)

    args, names = kernel_args(program, g)
    dims = "int64_t d0, int64_t d1"

    L = [f"// generated by soda_tpu_torch for kernel `{program.name}`, "
         f"stages {g.stages}",
         '#include "linebuffer2d.cuh"', "",
         "namespace {",
         f"constexpr int RB = {rb}, TX = {tx}, BY = {g.bz}, WARM = {g.warm};",
         "#ifdef SODA_HOST_EMULATION",
         "constexpr int NT = 1;  // one thread per CTA",
         "#else",
         f"constexpr int NT = {NTHREADS};",
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
          "  for (int64_t y = y0 - WSTEPS * RB; y < yend; y += RB) {"]
    # 1. the RB leading rows of every input ring
    for n in g.external_inputs:
        L.append(f"    soda_load_rows<RB, {n}_C, NT>({ring_var(n)}, {n}_g, y + {n}_YHI, "
                 f"y0 + {n}_YLO, {n}_D, x0 + {n}_XLO, d0, d1, tid);")
    L.append("    SODA_SYNC();")

    # 2. the RB leading rows of every ring stage, in topological order
    for n in g.stages:
        if n not in ring_names:
            continue
        L += [f"    {{  // stage {n} (ring)",
              f"      for (int i = tid; i < RB * {n}_C; i += NT) {{",
              f"        const int64_t p = y + {n}_YHI + i / {n}_C;",
              f"        const int lx = i % {n}_C + {n}_XLO;",
              f"        if (p < y0 + {n}_YLO) continue;",
              "        const int pl = (int)(p - y0);",
              "        const int64_t gx = x0 + lx;",
              f"        {ct(n)} v = {ct(n)}(0);",
              "        if (p >= 0 && p < d0 && gx >= 0 && gx < d1) {"]
        L += stage_value(gen, program, n, "          ", in_regs)
        if n in out_set:
            L += ["          if (p >= y0 && p < yend && lx >= 0 && lx < TX)",
                  f"            {n}_g[p * d1 + gx] = v;"]
        L += ["        }",
              f"        {ring_var(n)}[((pl - {n}_YLO) & ({n}_D - 1)) * {n}_C "
              f"+ (lx - {n}_XLO)] = v;",
              "      }", "    }", "    SODA_SYNC();"]
    # 3. outputs no stage of the group reads: straight to device memory
    direct = [n for n in g.outputs if n not in ring_names]
    if direct:
        L += ["    if (y >= y0) {",
              "      for (int i = tid; i < RB * TX; i += NT) {",
              "        const int64_t p = y + i / TX;",
              "        const int pl = (int)(p - y0), lx = i % TX;",
              "        const int64_t gx = x0 + lx;",
              "        if (p < yend && gx < d1) {"]
        for n in direct:
            L += [f"          {{  // output {n}",
                  f"            {ct(n)} v;"]
            L += stage_value(gen, program, n, "            ", in_regs)
            L += [f"            {n}_g[p * d1 + gx] = v;",
                  "          }"]
        L += ["        }", "      }", "    }", "    SODA_SYNC();"]
    L += ["  }", "}", ""]

    call = ", ".join(names + ["d0", "d1"])
    L += entry_points(
        "soda_lb2d_kernel", ", ".join(args + [dims]), call,
        "blockIdx.x, blockIdx.y, threadIdx.x",
        "(unsigned)((d1 + TX - 1) / TX), (unsigned)((d0 + BY - 1) / BY)",
        ["  for (int by = 0; by < (int)((d0 + BY - 1) / BY); ++by)",
         "    for (int bx = 0; bx < (int)((d1 + TX - 1) / TX); ++bx)",
         "      soda_body(bx, by, 0, smem.data(),"])
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
