"""The 3-D line-buffer z-march: kernel source, plain version and wrapper.

Replaces `soda_tpu/backend/_linebuffer.py::build_linebuffer_group_fn`:
one fused group of a rank-3 single-sweep program over the whole grid
(and, through `backend/sweeps.py`, the rank-3 cascade of fused sweeps).
`kernel_source` generates the group's CUDA kernel from the IR around the
march in `csrc/linebuffer3d.cuh` (see the note there for the design and
what bounds it: device-memory bytes, of which the y/x halo's sectors are
a tenth to a quarter, and copies in flight that cost the computing
threads nothing); `group_plain` is the same group evaluated over full
grids by the plain PyTorch path; `GroupKernel` is the wrapper.  A group
the planner gives the column z-march (`GroupPlan.march` "columns3d": a
stage at level 2 or deeper) runs `columns3d.GroupKernel`, this wrapper
with that march's source over the same feeds and entry points
(`cuda.group_kernel` picks it); `MARCH_LAUNCHES` counts launches by
march.

A CTA owns a (TY, TX) column tile and a chunk of BZ planes, and marches
its planes one a step.  How its input rings are fed is the plan's
`feed`: where the grid's rows are whole 16-byte chunks on an aligned
base ("tma"), thread 0 copies the input planes of step s + AHEAD
(`GroupPlan.ahead`) with one TMA instruction each during step s, into
ring slots guarded by mbarriers, and every thread waits on the slot of
the step's leading plane; elsewhere ("scalar") each thread loads its
elements of the next step's plane into registers during step s and
stores them to the ring before the step's wait.  `FEED_LAUNCHES` counts
the z-march's launches by feed, `STAGES` the stages they compute on chip.
Step s computes each stage at level L (`GroupPlan.levels`) at the plane
of step s - (L - 1): its leading plane (or, for outputs no stage of the
group reads, an output plane).  With
`GroupPlan.sync` "skew" no stage reads a plane written in the same step,
so the stages need no barrier between them; with "barrier" every stage
is at level 1 and a barrier follows each stage but the last.  A step
begins (TMA feed) or ends (scalar path) with the CTA's one barrier of
the step.  Steps before the chunk's first plane only fill the rings (the
warm-up), and the last DRAIN steps only run the lagging stages.  A stage
is computed in column runs (`column_run`), runs wholly inside the grid
without the per-row checks.

The kernel computes every stage with the oracle's zero-fill semantics: an
input read outside the grid is zero, and so is an intermediate stage's
value there.  It therefore matches the oracle (`interp/numpy_ref.py`) on
the whole grid, for multi-stage groups too.  (The TPU kernel evaluates
stages at constant extent from zero-filled inputs, which differs from the
oracle only inside the rim, `docs/SEMANTICS.md`.)
"""

from __future__ import annotations

import ctypes
from typing import Mapping

import torch

from ..ir.dtypes import torch_dtype
from ..ir.program import StencilProgram
from ..plan.planner import GroupPlan, ctas_per_sm
from ..utils import trace
from . import _build
from .cuda_codegen import RunGen, column_run, offset_tag, ring_var, run_rows, storage_ctype

# rows a column run may take (the most whose taps fit the registers)
RUN_ROWS = (1, 2, 4, 8)

# kernel launches made through GroupKernel (the CPU plain path never counts)
LAUNCHES = 0
# z-march launches (kernel 1, and the rank-3 cascade it runs) by the feed
# of their input rings (`GroupPlan.feed`): "tma" or "scalar"
FEED_LAUNCHES = {"tma": 0, "scalar": 0}
# launches by march (`GroupPlan.march`): the rank-2 cascades' column
# march (`columns2d.py`) or the row-march's rings, counted by
# `sweeps.GroupKernel`; and the z-march's (kernel 1, and the rank-3
# cascade it runs) column z-march (`columns3d.py`) or rings
MARCH_LAUNCHES = {"columns": 0, "rings": 0, "columns3d": 0, "rings3d": 0}
# stages computed on chip by the z-march's launches, each launch its
# group's (a cascade's once a sweep: `GroupPlan.stages` lists them so)
STAGES = 0
# device-memory bytes planned for the launches of every kernel wrapper,
# each launch its group's `GroupPlan.hbm_bytes_per_call`
PLANNED_BYTES = 0


def _ctype_store(program: StencilProgram, name: str) -> str:
    return storage_ctype(program.tensors[name].type)


def kernel_args(program: StencilProgram, g: GroupPlan) -> tuple[list[str], list[str]]:
    """Declarations and names of a generated kernel's pointer arguments:
    the group's external inputs, params and outputs, in that order (the
    order `GroupKernel.launch` passes them)."""
    args = [f"const {_ctype_store(program, n)}* __restrict__ {n}_g"
            for n in g.external_inputs]
    args += [f"const {storage_ctype(program.params[n].type)}* __restrict__ {n}_p"
             for n in g.params]
    args += [f"{_ctype_store(program, n)}* __restrict__ {n}_g" for n in g.outputs]
    names = ([f"{n}_g" for n in g.external_inputs] + [f"{n}_p" for n in g.params]
             + [f"{n}_g" for n in g.outputs])
    return args, names


def min_blocks(g: GroupPlan, nthreads: int) -> int:
    """CTAs per SM the registers must allow (`__launch_bounds__`): as many
    as shared memory lets share an SM, while each thread keeps at least 64
    registers.  Measured on the H100 against no bound and a bound of 24
    warps an SM (PERF.md, Findings): no slower on any row, and it stops the
    compiler from taking registers that would leave CTAs idle
    (`planner.ctas_per_sm`, which the row-march's plans count waves by).
    The column march keeps the registers its plan counts (`GroupPlan.regs`)."""
    return ctas_per_sm(g.smem_bytes, nthreads, g.regs)


def entry_points(kernel: str, decl: str, call: str, block: str, grid: str,
                 host_loops: list[str], ctas_per_sm: int) -> list[str]:
    """The `__global__` kernel and the C entry `soda_launch` of a generated
    source; under SODA_HOST_EMULATION, `soda_launch` runs `soda_body` for
    every CTA in turn on one thread (`host_loops`).  `ctas_per_sm` CTAs
    must fit an SM's registers (`__launch_bounds__`)."""
    bounds = "NT" if ctas_per_sm <= 1 else f"NT, {ctas_per_sm}"
    return ["#ifndef SODA_HOST_EMULATION",
            f'extern "C" __global__ void __launch_bounds__({bounds}) {kernel}(',
            f"    {decl}) {{",
            "  extern __shared__ __align__(16) unsigned char soda_smem[];",
            f"  soda_body({block}, soda_smem,",
            f"            {call});",
            "}",
            "",
            f'extern "C" int soda_launch({decl}, void* stream) {{',
            "  if (SMEM_BYTES > 48 * 1024) {",
            f"    cudaError_t e = cudaFuncSetAttribute({kernel}, "
            "cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);",
            "    if (e != cudaSuccess) return (int)e;",
            "  }",
            f"  const dim3 grid({grid});",
            f"  {kernel}<<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(",
            f"      {call});",
            "  return (int)cudaGetLastError();",
            "}",
            "#else",
            "#include <vector>",
            f'extern "C" int soda_launch({decl}, void* stream) {{',
            "  (void)stream;",
            "  std::vector<unsigned char> smem(SMEM_BYTES + 16);",
            *host_loops,
            f"      {call});",
            "  return 0;",
            "}",
            "#endif", ""]


def tma_entry_points(kernel: str, decl: str, call: str, block: str, grid: str,
                     host_loops: list[str], maps: list[str], ctas_per_sm: int) -> list[str]:
    """`entry_points` for a TMA-fed z-march: `soda_launch` first encodes a
    tensor map of each input in `maps` (its box the ring's rows by its
    columns, `<n>_R` x `<n>_C`; zeros outside the grid) and passes it to
    the kernel as a `__grid_constant__`.  Under SODA_HOST_EMULATION it
    fails where the emulated feed broke its protocol
    (`csrc/linebuffer3d.cuh`)."""
    params = ", ".join([f"const __grid_constant__ soda_tmap {n}_m" for n in maps] + [decl])
    passed = ", ".join([f"{n}_m" for n in maps] + [call])
    encode = [f"  soda_tmap {', '.join(f'{n}_m' for n in maps)};", "  int e = 0;",
              *(ln for n in maps for ln in (
                  f"  e = soda_tmap_encode(&{n}_m, {n}_g, (int)sizeof(*{n}_g), "
                  f"d0, d1, d2, {n}_C, {n}_R);",
                  "  if (e != 0) return e;"))]
    bounds = "NT" if ctas_per_sm <= 1 else f"NT, {ctas_per_sm}"
    return ["#ifndef SODA_HOST_EMULATION",
            f'extern "C" __global__ void __launch_bounds__({bounds}) {kernel}(',
            f"    {params}) {{",
            "  extern __shared__ __align__(128) unsigned char soda_smem[];",
            f"  soda_body({block}, soda_smem,",
            f"            {passed});",
            "}",
            "",
            f'extern "C" int soda_launch({decl}, void* stream) {{',
            *encode,
            "  if (SMEM_BYTES > 48 * 1024) {",
            f"    e = (int)cudaFuncSetAttribute({kernel}, "
            "cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);",
            "    if (e != 0) return e;",
            "  }",
            f"  const dim3 grid({grid});",
            f"  {kernel}<<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(",
            f"      {passed});",
            "  return (int)cudaGetLastError();",
            "}",
            "#else",
            "#include <vector>",
            f'extern "C" int soda_launch({decl}, void* stream) {{',
            "  (void)stream;",
            *encode,
            "  std::vector<unsigned char> smem(SMEM_BYTES + 16);",
            "  soda_emu_fault() = 0;",
            "  soda_boxes().clear();",
            *host_loops,
            f"      {passed});",
            "  return soda_emu_fault();",
            "}",
            "#endif", ""]


# an input ring's plane copies, in both z-marches (`columns3d.py`): `step`
# is a step's expression (its leading plane `n_ZHI` past it, copied once
# inside the ring's span), `slot(plane)` a plane's slot, `at` what
# prefixes the CTA's origin, bounds and thread (a context struct's "c.")
def tma_feed(n: str, step: str, tmap: str, at: str = "") -> list[str]:
    """Issue the TMA copy of step `step`'s plane of input `n` (tensor map
    `tmap`) into its slot, signalling the slot's mbarrier."""
    pl = f"{step} + {n}_ZHI"
    return [f"if ({pl} >= {n}_ZLO) {{",
            f"  const int f = ({pl} - {n}_ZLO) % {n}_D;",
            f"  soda_tma_plane({ring_var(n)} + f * {n}_PS, {tmap}, {n}_b + f, "
            f"(int)({at}x0 + {n}_XA), (int)({at}y0 + {n}_YLO), (int)({at}z0 + {pl}), "
            f"{n}_BYTES);",
            "}"]


def tma_wait(n: str, step: str) -> list[str]:
    """Wait until step `step`'s plane of input `n` has landed."""
    pl = f"{step} + {n}_ZHI"
    return [f"if ({pl} >= {n}_ZLO) {{",
            f"  const int f = {pl} - {n}_ZLO;",
            f"  soda_bar_wait({n}_b + f % {n}_D, (unsigned)(f / {n}_D) & 1u);",
            "}"]


def plane_pre(program: StencilProgram, n: str) -> str:
    """A thread's elements of one plane of input `n` on the scalar path."""
    return f"{_ctype_store(program, n)} {n}_pre[soda_per<{n}_R, {n}_C, NT>()];"


def fetch_plane(n: str, step: str, slot, at: str = "") -> list[str]:
    """Load a thread's elements of step `step`'s plane of input `n`."""
    pl = f"{step} + {n}_ZHI"
    return [f"if ({pl} >= {n}_ZLO) soda_fetch_plane_s<{n}_R, {n}_C, NT>({n}_pre, "
            f"{slot(pl)}, {n}_g, {at}z0 + {pl}, {at}y0 + {n}_YLO, {at}x0 + {n}_XA, "
            f"{at}d0, {at}d1, {at}d2, {at}tid);"]


def store_plane(n: str, step: str, slot, at: str = "") -> list[str]:
    """Store a thread's loaded elements of step `step`'s plane of input
    `n` into its slot."""
    pl = f"{step} + {n}_ZHI"
    return [f"if ({pl} >= {n}_ZLO) soda_store_plane_s<{n}_R, {n}_C, NT>("
            f"{slot(pl)}, {n}_pre, {at}tid);"]


def kernel_source(program: StencilProgram, g: GroupPlan,
                  kernel: str = "soda_lb3d_kernel", note: str = "") -> str:
    """CUDA C++ for one group under one plan (tile, chunk, rings, levels,
    feed); the `__global__` is named `kernel`, and `note` (comment lines)
    heads the source."""
    if g.march == "columns3d":
        raise ValueError("a column z-march plan takes columns3d.kernel_source")
    ty, tx = g.tile
    ring_names = [r.name for r in g.rings]
    gen = RunGen(program, set(ring_names))
    out_set = set(g.outputs)
    tma = g.feed == "tma"
    fed = [r.name for r in g.rings if r.pitch]   # the TMA-fed input rings
    args, names = kernel_args(program, g)
    dims = "int64_t d0, int64_t d1, int64_t d2"

    L = [*note.splitlines(),
         f"// generated by soda_tpu_torch for kernel `{program.name}`, "
         f"stages {g.stages}, levels {g.levels}, {g.sync} sync, "
         + (f"TMA plane copies {g.ahead} step(s) ahead" if tma
            else f"{g.load} plane copies"),
         '#include "linebuffer3d.cuh"', "",
         "namespace {",
         f"constexpr int TY = {ty}, TX = {tx}, BZ = {g.bz}, WARM = {g.warm};",
         *([f"constexpr int AHEAD = {g.ahead};  // steps the TMA feed runs ahead"]
           if tma else []),
         "#ifdef SODA_HOST_EMULATION",
         "constexpr int NT = 1;  // one thread per CTA",
         "#else",
         f"constexpr int NT = {g.threads};",
         "#endif",
         f"constexpr int DRAIN = {max(g.levels.values()) - 1};  "
         "// steps the deepest level lags the first",
         f"constexpr size_t SMEM_BYTES = {g.smem_bytes};"]
    for r in g.rings:
        (zlo, zhi), (ylo, _), _ = r.span
        L.append(f"// ring {r.name}: span {r.span}")
        L.append(f"constexpr int {r.name}_D = {r.depth}, {r.name}_ZLO = {zlo}, "
                 f"{r.name}_ZHI = {zhi}, {r.name}_YLO = {ylo}, "
                 f"{r.name}_XA = {r.col0}, {r.name}_R = {r.rows}, "
                 f"{r.name}_C = {r.cols}, {r.name}_PS = {r.slot};")
        L.append(f"constexpr size_t {r.name}_OFF = {r.offset};")
        if r.pitch:
            L.append(f"constexpr size_t {r.name}_BAR = {r.bar};  // its slots' mbarriers")
            L.append(f"constexpr unsigned {r.name}_BYTES = "
                     f"{r.rows * r.cols * r.elem_bytes};  // a plane's box")
    L += ["}  // namespace", "",
          "// a stage's work items; in reverse under the hazard emulation",
          "#ifdef SODA_HAZARD",
          "#define SODA_ITEMS(i, n) for (int i = (n) - 1 - tid; i >= 0; i -= NT)",
          "#else",
          "#define SODA_ITEMS(i, n) for (int i = tid; i < (n); i += NT)",
          "#endif", ""]
    L += ["SODA_BODY void soda_body(int bx, int by, int bzi, int tid, unsigned char* smem,",
          "                       " + ", ".join(
              [f"const soda_tmap& {n}_m" for n in fed] + args + [dims]) + ") {"]
    for r in g.rings:
        L.append(f"  {_ctype_store(program, r.name)}* {ring_var(r.name)} = "
                 f"reinterpret_cast<{_ctype_store(program, r.name)}*>"
                 f"(smem + {r.name}_OFF);")
    L += ["  const int64_t y0 = (int64_t)by * TY, x0 = (int64_t)bx * TX;",
          "  const int64_t z0 = (int64_t)bzi * BZ;",
          "  const int64_t zend = z0 + BZ < d0 ? z0 + BZ : d0;",
          "  // the grid in chunk-local planes and tile-local rows and columns",
          "  // (32-bit)",
          "  const int64_t big = (int64_t)1 << 30;",
          "  const int zlo_l = (int)-(z0 < big ? z0 : big);",
          "  const int zhi_l = (int)(d0 - z0 < big ? d0 - z0 : big);",
          "  const int ylo_l = (int)-(y0 < big ? y0 : big), xlo_l = (int)-(x0 < big ? x0 : big);",
          "  const int yhi_l = (int)(d1 - y0 < big ? d1 - y0 : big);",
          "  const int xhi_l = (int)(d2 - x0 < big ? d2 - x0 : big);",
          "  const int zlen = (int)(zend - z0);  // the chunk's own steps"]

    depth = {r.name: r.depth for r in g.rings}

    def wrap(n: str, plane: str) -> str:
        # a power-of-two ring's slot is a mask; another's (a TMA-fed ring's
        # always) a 32-bit remainder by a constant (plane >= n_ZLO)
        if n in fed or depth[n] & (depth[n] - 1):
            return f"({plane} - {n}_ZLO) % {n}_D"
        return f"({plane} - {n}_ZLO) & ({n}_D - 1)"

    def slot(n: str, plane: str) -> str:
        return f"{ring_var(n)} + ({wrap(n, plane)}) * {n}_PS"

    def fetch(n: str, step: str) -> list[str]:
        return fetch_plane(n, step, lambda pl: slot(n, pl))

    def store(n: str, step: str) -> list[str]:
        return store_plane(n, step, lambda pl: slot(n, pl))

    def pre(n: str) -> list[str]:
        return [plane_pre(program, n)]

    ins = g.external_inputs
    if tma:
        def feed(n: str, step: str) -> list[str]:
            return tma_feed(n, step, f"{n}_m")

        L += [*(f"  uint64_t* {n}_b = reinterpret_cast<uint64_t*>(smem + {n}_BAR);"
                for n in fed),
              *(f"  soda_bar_init({n}_b, {n}_D, tid);" for n in fed),
              "  SODA_SYNC();",
              "  // the feed (thread 0): the input planes of step s, copied at step",
              "  // s - AHEAD (the first AHEAD steps' before the march)",
              "  if (tid == 0) {",
              "    for (int s = -WARM; s < -WARM + AHEAD && s < zlen; ++s) {",
              *("      " + ln for n in fed for ln in feed(n, "s")),
              "    }",
              "  }",
              "  for (int zs = -WARM; zs < zlen + DRAIN; ++zs) {",
              "    // every thread is done with the step before: the slot the feed",
              "    // refills now, and the stage planes that step wrote",
              "    SODA_SYNC();",
              "    if (zs < zlen) {  // 1. the feed runs on; this step's input planes land",
              "      if (tid == 0 && zs + AHEAD < zlen) {",
              *("        " + ln for n in fed for ln in feed(n, "zs + AHEAD")),
              "      }",
              *("      " + ln for n in fed for ln in tma_wait(n, "zs")),
              "    }"]
    else:
        L += ["  soda_cta_begin();",
              "  {  // the input planes of the first step",
              *("    " + ln for n in ins for ln in pre(n) + fetch(n, "-WARM")
                + store(n, "-WARM")),
              "  }",
              "  soda_step_wait();",
              "  for (int zs = -WARM; zs < zlen + DRAIN; ++zs) {",
              "    // 1. the planes of step zs + 1 of every input ring, in flight",
              "    // while this step computes",
              "    const bool ahead = zs + 1 < zlen;",
              *("    " + ln for n in ins for ln in pre(n)),
              "    if (ahead) {",
              *("      " + ln for n in ins for ln in fetch(n, "zs + 1")),
              "    }"]

    # 2. every stage at the plane of its own step t = zs - (level - 1): a
    # thread takes a column and a run of rows of the plane (the last run
    # of a column overlaps the one before it) and computes them from taps
    # it loads from the rings once per run
    def load(q: str, key: tuple[int, ...]) -> str:
        oz, k, ox = key
        return (f"{ring_var(q)}[__s_{q}_{offset_tag(oz)} * {q}_PS + (pb + ({k}) - "
                f"{q}_YLO) * {q}_C + (lx + ({ox}) - {q}_XA)]")

    def slots(loads) -> list[str]:
        return [f"const int __s_{q}_{offset_tag(oz)} = {wrap(q, f'pl + ({oz})')};"
                for q, oz in sorted({(q, key[0]) for q, key in loads.values()})]

    blocks = []
    for n in g.stages:
        if n not in ring_names:
            continue
        level = g.levels[n]
        st = _ctype_store(program, n)
        rows = next(r.rows for r in g.rings if r.name == n)
        after = {n: ["  if (pl >= 0 && pl < zlen && ly >= 0 && ly < TY && lx >= 0 && lx < TX)",
                     f"    {n}_g[((z0 + pl) * d1 + (y0 + ly)) * d2 + (x0 + lx)] = v;"]
                 } if n in out_set else {}
        rs = run_rows(gen, [n], [c for c in RUN_ROWS if c <= rows], {})
        run = column_run(gen, [n], rs, "ly", "xin && ly >= ylo_l && ly < yhi_l",
                         {}, after, load, uniform="full")
        blocks.append([
            f"    {{  // stage {n} (ring, level {level}), runs of {rs} row(s)",
            f"      const int t = zs - {level - 1}, pl = t + {n}_ZHI;",
            f"      if (t >= -WARM && t < zlen && pl >= {n}_ZLO) {{",
            "        const bool zin = pl >= zlo_l && pl < zhi_l;",
            *("        " + ln for ln in slots(gen.loads)),
            f"        {st}* dst = {slot(n, 'pl')};",
            f"        SODA_ITEMS(i, {n}_C * {-(-rows // rs)}) {{",
            f"          const int c = i % {n}_C, s = i / {n}_C;",
            f"          const int r0 = s * {rs} < {n}_R - {rs} ? s * {rs} : {n}_R - {rs};",
            f"          const int lx = c + {n}_XA, pb = r0 + {n}_YLO;",
            "          const bool xin = zin && lx >= xlo_l && lx < xhi_l;",
            "          // the whole run inside the grid",
            f"          const bool full = xin && pb >= ylo_l && pb + {rs} <= yhi_l;",
            *("          " + ln for ln in run),
            *(f"          dst[(r0 + {r}) * {n}_C + c] = v_{n}_{r};" for r in range(rs)),
            "        }", "      }", "    }"])
    # outputs no stage of the group reads: straight to device memory
    direct = [n for n in g.outputs if n not in ring_names]
    if direct:
        level = g.levels[direct[0]]
        after = {n: [f"  {n}_g[((z0 + pl) * d1 + (y0 + ly)) * d2 + (x0 + lx)] = v;"]
                 for n in direct}
        rs = run_rows(gen, direct, [c for c in RUN_ROWS if c <= ty], {})
        run = column_run(gen, direct, rs, "ly", "xin && ly < yhi_l", {}, after, load,
                         uniform="full")
        blocks.append([
            f"    {{  // outputs {direct} (level {level}), runs of {rs} row(s)",
            f"      const int pl = zs - {level - 1};",
            "      if (pl >= 0 && pl < zlen) {",
            *("        " + ln for ln in slots(gen.loads)),
            f"        SODA_ITEMS(i, TX * {-(-ty // rs)}) {{",
            "          const int c = i % TX, s = i / TX;",
            f"          const int r0 = s * {rs} < TY - {rs} ? s * {rs} : TY - {rs};",
            "          const int lx = c, pb = r0;",
            "          const bool xin = lx < xhi_l;",
            f"          const bool full = xin && pb + {rs} <= yhi_l;",
            *("          " + ln for ln in run),
            "        }", "      }", "    }"])
    if g.sync == "barrier":
        # every stage at level 1: a barrier between a stage and its readers
        L += ["    // 2. the stages, a barrier after each",
              *(ln for b in blocks[:-1] for ln in b + ["    SODA_SYNC();"]),
              *(blocks[-1] if blocks else [])]
    else:
        L += ["    // 2. the stages, each at its own step: none reads a plane",
              "    // written in this step (in reverse under the hazard emulation)",
              "#ifndef SODA_HAZARD",
              *(ln for b in blocks for ln in b),
              "#else",
              *(ln for b in reversed(blocks) for ln in b),
              "#endif"]
    call = ", ".join(names + ["d0", "d1", "d2"])
    block = "blockIdx.x, blockIdx.y, blockIdx.z, threadIdx.x"
    grid = ("(unsigned)((d2 + TX - 1) / TX), (unsigned)((d1 + TY - 1) / TY), "
            "(unsigned)((d0 + BZ - 1) / BZ)")
    loops = ["  for (int bzi = 0; bzi < (int)((d0 + BZ - 1) / BZ); ++bzi)",
             "    for (int by = 0; by < (int)((d1 + TY - 1) / TY); ++by)",
             "      for (int bx = 0; bx < (int)((d2 + TX - 1) / TX); ++bx)",
             "        soda_body(bx, by, bzi, 0, smem.data(),"]
    if tma:
        L += ["  }", "  soda_feed_end();", "}", ""]
        L += tma_entry_points(kernel, ", ".join(args + [dims]), call, block, grid, loops,
                              fed, min_blocks(g, g.threads))
        return "\n".join(L)
    stores = [ln for n in ins for ln in store(n, "zs + 1")]
    if stores:
        L += ["    if (ahead) {  // 3. the planes of step zs + 1 into the rings",
              *("      " + ln for ln in stores), "    }"]
    L += ["    soda_step_wait();", "  }", "}", ""]

    L += entry_points(kernel, ", ".join(args + [dims]), call, block, grid, loops,
                      min_blocks(g, g.threads))
    return "\n".join(L)


def group_plain(program: StencilProgram, g: GroupPlan,
                values: Mapping[str, torch.Tensor],
                params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The group's stages over full grids through the plain PyTorch path
    (`eager.py`): the version the kernel is held against."""
    from .eager import eval_stages

    device = next(iter(values.values())).device
    arrays = {n: values[n] for n in g.external_inputs}
    eval_stages(program, g.stages, arrays, params, device)
    return {o: arrays[o] for o in g.outputs}


class GroupKernel:
    """Wrapper of one group's kernel (kernel 1, rank 3).

    Called on CPU tensors it runs `group_plain`.  Called on CUDA tensors it
    builds the kernel (once), checks every tensor, allocates the outputs
    (unless `out` provides them) and launches on the current stream; it
    never falls back.  `LAUNCHES` counts the launches, `PLANNED_BYTES` adds
    their planned bytes and, for the z-march, `FEED_LAUNCHES`,
    `MARCH_LAUNCHES` and `STAGES` their feed, march and stages.  On CUDA
    tensors the call is the span `soda.kernel` (`utils/trace.py`), with the
    group's stage count as its argument `stages` and, for the z-march, its
    `march`.

    `linebuffer2d.GroupKernel` (kernel 2, rank 2), `sweeps.GroupKernel`
    (fused sweeps, ranks 2 and 3), `columns3d.GroupKernel` (kernel 1's
    column z-march) and `windows.GroupKernel` (kernel 4, ranks 1 to 3)
    are this wrapper with their own source, rank, plain version and
    count."""

    rank = 3
    prefix = "lb3d"

    def __init__(self, program: StencilProgram, g: GroupPlan):
        self.program = program
        self.group = g
        self.name = f"{self.prefix}_{program.name}"
        self._source: str | None = None
        self._entry = None          # the loaded C entry, after the first build
        self._span_args = {"stages": len(g.stages)}
        if g.kernel == "linebuffer3d":
            self._span_args["march"] = g.march

    def _generate(self) -> str:
        return kernel_source(self.program, self.group)

    def _count(self) -> None:
        global LAUNCHES
        LAUNCHES += 1

    def _plain(self, values, params) -> dict[str, torch.Tensor]:
        return group_plain(self.program, self.group, values, params)

    @property
    def source(self) -> str:
        # generated at first use: the CPU path never needs it
        if self._source is None:
            self._source = self._generate()
        return self._source

    def build(self, emulate: bool = False, hazard: bool = False) -> _build.Built:
        """Compile (once) for the card, or as host C++ (`emulate`), with
        the marches' hazard emulation (`hazard`: copies land at issue, a
        step's stages and a stage's work items in reverse order,
        `csrc/async_copy.cuh`)."""
        built = _build.build(self.name, self.source, emulate=emulate, hazard=hazard)
        fn = built.lib.soda_launch
        n_ptr = (len(self.group.external_inputs) + len(self.group.params)
                 + len(self.group.outputs))
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int64] * self.rank
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        if not emulate:
            self._entry = fn
        return built

    def _check(self, name: str, t: torch.Tensor, dtype, shape, device) -> None:
        if t.device != device:
            raise ValueError(f"{name}: on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")

    def _check_vector_rows(self, values, shape) -> None:
        """A march's plan that copies planes or rows 16 bytes at a time
        (`load` "vector") takes grids whose rows are whole 16-byte chunks,
        and inputs that start on a 16-byte boundary."""
        for n in self.group.external_inputs:
            elem = values[n].element_size()
            if shape[-1] * elem % 16:
                raise ValueError(
                    f"{n}: rows of {shape[-1]} x {elem} B are not whole 16-byte "
                    f"chunks, which this plan's row copies need; plan this grid")
            if values[n].data_ptr() % 16:
                raise ValueError(f"{n}: data does not start on a 16-byte boundary, "
                                 f"which this plan's row copies need")

    def launch(self, entry, values, params, outs, stream: int) -> None:
        """Call the C entry (`build().lib.soda_launch`) on tensors already
        checked and allocated."""
        g = self.group
        shape = tuple(values[g.external_inputs[0]].shape)
        ptrs = ([values[n].data_ptr() for n in g.external_inputs]
                + [params[n].data_ptr() for n in g.params]
                + [outs[n].data_ptr() for n in g.outputs])
        rc = entry(*ptrs, *shape, stream)
        if rc != 0:
            raise RuntimeError(
                f"{self.prefix} kernel for {self.program.name!r} failed to "
                f"launch: cudaError {rc}")

    def __call__(self, values: Mapping[str, torch.Tensor],
                 params: Mapping[str, torch.Tensor],
                 out: Mapping[str, torch.Tensor] | None = None
                 ) -> dict[str, torch.Tensor]:
        g, p = self.group, self.program
        operands = [values[n] for n in g.external_inputs] + [params[n] for n in g.params]
        devices = {t.device for t in operands}
        if len(devices) != 1:
            raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
        device = devices.pop()
        if device.type == "cpu":
            return self._plain(values, params)
        if device.type != "cuda":
            raise ValueError(f"the {self.prefix} kernel runs on CUDA tensors, got {device}")
        with trace.span("soda.kernel", self._span_args):
            shape = tuple(values[g.external_inputs[0]].shape)
            if len(shape) != self.rank or min(shape) == 0:
                raise ValueError(f"the {self.prefix} kernel takes a non-empty "
                                 f"{self.rank}-D grid, got {shape}")
            for n in g.external_inputs:
                self._check(n, values[n], torch_dtype(p.tensors[n].type), shape, device)
            for n in g.params:
                self._check(n, params[n], torch_dtype(p.params[n].type),
                            p.params[n].shape, device)
            if g.load == "vector":
                self._check_vector_rows(values, shape)
            outs = {}
            for n in g.outputs:
                dt = torch_dtype(p.tensors[n].type)
                if out is not None and n in out:
                    self._check(f"out[{n}]", out[n], dt, shape, device)
                    if any(out[n].data_ptr() == t.data_ptr() for t in operands):
                        raise ValueError(f"out[{n}] is also an input of the kernel")
                    outs[n] = out[n]
                else:
                    outs[n] = torch.empty(shape, dtype=dt, device=device)
            if self._entry is None:
                self.build()
            with torch.cuda.device(device):
                self.launch(self._entry, values, params, outs,
                            torch.cuda.current_stream(device).cuda_stream)
            self._count()
            global PLANNED_BYTES, STAGES
            PLANNED_BYTES += g.hbm_bytes_per_call
            if g.kernel == "linebuffer3d":
                FEED_LAUNCHES[g.feed] += 1
                MARCH_LAUNCHES[g.march] += 1
                STAGES += len(g.stages)
            return outs
