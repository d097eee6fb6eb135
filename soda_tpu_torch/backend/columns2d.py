"""The column march of rank-2 fused cascades: kernel source.

`backend/sweeps.py` runs a rank-2 cascade through this generator where
the plan's march is "columns" (`GroupPlan.march`; the planner takes it
wherever the register window fits, `plan/planner.py`), else through the
row-march's rings (`linebuffer2d.kernel_source`).  See
`csrc/columns2d.cuh` for the design and what bounds it.

A CTA owns a strip of TX columns and a chunk of BY rows, and each of its
threads one column of the strip and the cascade's x halo (`XMIN` + its
index) for the whole chunk.  Member m of the group computes the rows s *
RB + lead_m .. + RB - 1 at step s (`GroupPlan.leads`), in one column run
(`column_run`): its in-column taps read the thread's window of the
tensor (rows carried in `soda_regs` from earlier steps, and the rows of
the step a member computed before it), its off-column taps the tapped
member's exchange buffer (slot `(PH + j) % NSLOT` of the step j steps
back, PH the step's phase in a loop unrolled NSLOT times) or the input's
ring.  A member with off-column consumers stores its RB rows to its
exchange buffer; after its last in-column consumer, a tensor's window
shifts by RB.  One barrier ends a step (`SODA_STEP_END`).  The chunk runs
from step `S_LO` (`planner.column_first_step`, the first rows each member
and input needs) to the step whose rows pass the chunk by `EXTRA`; a
member computes only its rows inside the grid and its span, zero
elsewhere.  A step at which every member's rows lie inside them
(`s_full_lo` .. `s_full_hi`, the chunk's middle) runs without the per-row
checks; the others check each row, and skip a member none of whose rows
computes.
"""

from __future__ import annotations

import math

from ..ir.program import StencilProgram
from ..plan import planner
from ..plan.planner import GroupPlan
from .cuda_codegen import RunGen, column_run, ring_var, storage_ctype
from .linebuffer import entry_points, kernel_args, min_blocks
from .linebuffer2d import PARAM_REGS_MAX


def kernel_source(program: StencilProgram, g: GroupPlan,
                  kernel: str = "soda_sw2d_kernel", note: str = "") -> str:
    """CUDA C++ of the column march for one rank-2 group (a cascade) under
    one plan; the `__global__` is named `kernel`, and `note` (comment
    lines) heads the source."""
    rb, tx = g.tile
    members, ins, spans, leads = g.stages, g.external_inputs, g.spans, g.leads
    rings = {r.name: r for r in g.rings}
    exchanged = [m for m in members if m in rings]
    phases = max((rings[m].depth // rb for m in exchanged), default=1)
    carried = planner.column_windows(program, members, spans, leads)
    s_lo = planner.column_first_step(members, ins, spans, leads, rb)
    extra = max(0, max(spans[m][0][1] - leads[m] for m in members))
    xmin = min(spans[m][1][0] for m in members)
    vector = g.load == "vector"
    gen = RunGen(program, set(ins) | set(members))
    last = {q: c for c in members for q, offs in program.tensors[c].window().items()
            if any(dx == 0 for _, dx in offs)}

    def ct(n: str) -> str:
        return storage_ctype(program.tensors[n].type)

    def base(q: str) -> int:
        return leads[q] if q in leads else spans[q][0][1]

    def window(q: str, i: int) -> str:
        """Row base(q) - K + i of the step (K the rows q carries): a carried
        register below K, else the step's own row i - K."""
        k = carried[q]
        return f"r.{q}_{i}" if i < k else f"n_{q}_{i - k}"

    args, names = kernel_args(program, g)
    dims = "int64_t d0, int64_t d1"
    in_regs = {}
    params = []
    for n in g.params:
        size = math.prod(program.params[n].shape)
        t = storage_ctype(program.params[n].type)
        params.append((n, t, size if size <= PARAM_REGS_MAX else 0))
        if size <= PARAM_REGS_MAX:
            in_regs[f"{n}_p["] = f"{n}_v["

    L = [*note.splitlines(),
         f"// generated by soda_tpu_torch for kernel `{program.name}`, "
         f"stages {g.stages}, leads {g.leads}, column march, "
         f"{g.load} row copies",
         '#include "columns2d.cuh"', "",
         "namespace {",
         f"constexpr int RB = {rb}, TX = {tx}, BY = {g.bz}, NT = {g.threads};",
         f"constexpr int XMIN = {xmin};  // the column of thread 0, strip-local",
         f"constexpr int S_LO = {s_lo};  // a chunk's first step",
         f"constexpr int EXTRA = {extra};  // rows the last step reaches past the chunk",
         f"constexpr int NSLOT = {phases};  // slots of an exchange buffer, used in turn",
         f"constexpr size_t SMEM_BYTES = {g.smem_bytes};"]
    for q in ins:
        r = rings[q]
        (ylo, yhi), _ = r.span
        L += [f"// input ring {q}: span {r.span}, copied a step ahead",
              f"constexpr int {q}_D = {r.depth}, {q}_YLO = {ylo}, {q}_YHI = {yhi}, "
              f"{q}_XA = {r.col0}, {q}_C = {r.cols};",
              f"constexpr size_t {q}_OFF = {r.offset};"]
    for m in members:
        (ylo, yhi), (xlo, xhi) = spans[m]
        L += [f"// member {m}: span {spans[m]}, lead {leads[m]}"
              + (f", exchange buffer of NSLOT x RB rows" if m in rings else ""),
              f"constexpr int {m}_YLO = {ylo}, {m}_YHI = {yhi}, {m}_XA = {xlo}, "
              f"{m}_C = {tx + xhi - xlo}, {m}_LEAD = {leads[m]};"]
        if m in rings:
            L.append(f"constexpr size_t {m}_OFF = {rings[m].offset};")
    L += ["}  // namespace", "",
          "// the rows of each tensor a thread carries from a step to the next, at",
          "// its column (registers)",
          "struct soda_regs {"]
    for q, k in carried.items():
        if k:
            L.append(f"  {ct(q)} " + ", ".join(f"{q}_{i}" for i in range(k)) + ";")
    L += ["};", "",
          "// a thread's CTA, column, grid bounds and pointers",
          "struct soda_ctx {",
          *(f"  {a.replace(' __restrict__', '')};" for a in args),
          *(f"  {t} {n}_v[{size}];" for n, t, size in params if size),
          "  unsigned char* smem;",
          "  int64_t y0, x0, d0, d1;",
          "  int ylen, nsteps, s_end, s_full_lo, s_full_hi, ylo_l, yhi_l, xlo_l, xhi_l, lx, tid;",
          "};", "",
          "SODA_BODY soda_ctx soda_make_ctx(int bx, int by, int tid, unsigned char* smem,",
          "                               " + ", ".join(args + [dims]) + ") {",
          "  soda_ctx c;",
          *(f"  c.{n} = {n};" for n in names)]
    for n, t, size in params:
        if size:
            L += ["#pragma unroll", f"  for (int k = 0; k < {size}; ++k) c.{n}_v[k] = {n}_p[k];"]
    L += ["  c.smem = smem;",
          "  c.d0 = d0, c.d1 = d1;",
          "  c.y0 = (int64_t)by * BY, c.x0 = (int64_t)bx * TX;",
          "  const int64_t yend = c.y0 + BY < d0 ? c.y0 + BY : d0;",
          "  // the grid in chunk-local rows and strip-local columns (32-bit)",
          "  const int64_t big = (int64_t)1 << 30;",
          "  c.ylo_l = (int)-(c.y0 < big ? c.y0 : big);",
          "  c.xlo_l = (int)-(c.x0 < big ? c.x0 : big);",
          "  c.yhi_l = (int)(d0 - c.y0 < big ? d0 - c.y0 : big);",
          "  c.xhi_l = (int)(d1 - c.x0 < big ? d1 - c.x0 : big);",
          "  c.ylen = (int)(yend - c.y0);",
          "  c.nsteps = (c.ylen + RB - 1) / RB;  // the steps whose input rows are copied",
          "  c.s_end = (c.ylen + EXTRA + RB - 1) / RB;  // the chunk's steps end here",
          "  c.lx = XMIN + tid, c.tid = tid;",
          "  // the steps at which every member's rows lie inside the grid and its",
          "  // span: [s_full_lo, s_full_hi)",
          "  c.s_full_lo = -(1 << 30), c.s_full_hi = 1 << 30;"]
    for m in members:
        L += [f"  {{  const int lo = c.ylo_l > {m}_YLO ? c.ylo_l : {m}_YLO;",
              f"     const int hi = c.yhi_l < c.ylen + {m}_YHI ? c.yhi_l : c.ylen + {m}_YHI;",
              f"     const int a = -soda_floor_div({m}_LEAD - lo, RB);",
              f"     const int b = soda_floor_div(hi - {m}_LEAD - RB, RB) + 1;",
              "     c.s_full_lo = a > c.s_full_lo ? a : c.s_full_lo;",
              "     c.s_full_hi = b < c.s_full_hi ? b : c.s_full_hi;  }"]
    L += ["  return c;",
          "}", ""]

    def pointers() -> list[str]:
        out = [f"  {a} = c.{n};" for a, n in zip(args, names)]
        out += [f"  const {t} (&{n}_v)[{size}] = c.{n}_v;" for n, t, size in params if size]
        out += [f"  {ct(q)}* {ring_var(q)} = reinterpret_cast<{ct(q)}*>(c.smem + {q}_OFF);"
                for q in ins]
        out += [f"  {ct(m)}* {m}_x = reinterpret_cast<{ct(m)}*>(c.smem + {m}_OFF);"
                for m in exchanged]
        return out

    def where(q: str, step: str) -> str:
        return (f"c.y0 + (int64_t)({step}) * RB + {q}_YHI, c.y0 + {q}_YLO, {q}_D, "
                f"c.x0 + {q}_XA, c.d0, c.d1, c.tid")

    def fetch(q: str, step: str) -> list[str]:
        if vector:
            return [f"soda_fetch_rows_v<RB, {q}_C, NT>({ring_var(q)}, {q}_g, {where(q, step)});"]
        return [f"soda_fetch_rows_s<RB, {q}_C, NT>({q}_pre, {ring_var(q)}, {q}_g, "
                f"{where(q, step)});"]

    def store(q: str, step: str) -> list[str]:
        return [] if vector else [
            f"soda_store_rows_s<RB, {q}_C, NT>({ring_var(q)}, {q}_pre, c.y0 + "
            f"(int64_t)({step}) * RB + {q}_YHI, c.y0 + {q}_YLO, {q}_D, c.tid);"]

    def pre(q: str) -> list[str]:
        return [] if vector else [f"{ct(q)} {q}_pre[soda_per<RB, {q}_C, NT>()];"]

    L += ["// the input rows of a chunk's first step",
          "SODA_BODY void soda_prologue(const soda_ctx& c) {",
          *pointers(),
          *("  " + ln for q in ins for ln in pre(q) + fetch(q, "S_LO") + store(q, "S_LO")),
          "}", ""]

    def tap(c: str):
        def load(q: str, key: tuple[int, ...]) -> str:
            k, ox = key
            if ox == 0:
                return window(q, leads[c] + k - base(q) + carried[q])
            if q in ins:
                return (f"{ring_var(q)}[((pb + ({k}) - {q}_YLO) & ({q}_D - 1)) * {q}_C "
                        f"+ (lx + ({ox}) - {q}_XA)]")
            rel = leads[c] + k - leads[q]
            back, row = rel // rb, rel % rb
            return (f"{q}_x[(((PH + NSLOT + ({back})) % NSLOT) * RB + {row}) * {q}_C "
                    f"+ (lx + ({ox}) - {q}_XA)]")
        return load

    S = ["// step s of a thread's march, PH = (s - S_LO) % NSLOT its phase",
         "template <int PH>",
         "SODA_BODY void soda_step(const int s, soda_regs& r, const soda_ctx& c) {",
         *pointers(),
         "  const int lx = c.lx, ylen = c.ylen;",
         "  const int64_t y0 = c.y0, x0 = c.x0, d1 = c.d1;",
         "  const bool xin = lx >= c.xlo_l && lx < c.xhi_l;",
         "  // 1. the rows of step s + 1 of every input ring, in flight while this",
         "  // step computes",
         "  const bool ahead = s + 1 < c.nsteps;",
         *("  " + ln for q in ins for ln in pre(q)),
         "  if (ahead) {",
         *("    " + ln for q in ins for ln in fetch(q, "s + 1")),
         "  }"]
    windowed = [q for q in ins if q in carried]
    if windowed:
        S.append("  // 2. each input's rows of this step at the thread's column")
    for q in windowed:
        S += [f"  {ct(q)} " + ", ".join(f"n_{q}_{i} = {ct(q)}(0)" for i in range(rb)) + ";",
              f"  if ((unsigned)(lx - {q}_XA) < (unsigned){q}_C) {{",
              *(f"    n_{q}_{i} = {ring_var(q)}[((s * RB + {q}_YHI + {i} - {q}_YLO) & "
                f"({q}_D - 1)) * {q}_C + (lx - {q}_XA)];" for i in range(rb)),
              "  }"]
    S += ["  // 3. the members, each at its own rows: with no check at a step where",
          "  // every member's rows lie inside the grid and its span",
          "  const bool interior = xin && s >= c.s_full_lo && s < c.s_full_hi;"]
    S += [f"  {ct(m)} " + ", ".join(f"n_{m}_{i}" for i in range(rb)) + ";"
          for m in members if m in carried]

    def members_at(checked: bool) -> list[str]:
        out = []
        for m in members:
            after = {}
            if m in g.outputs:
                # a member of span 0 computes only cells of the chunk
                put = f"{m}_g[(y0 + p) * d1 + (x0 + lx)] = v;"
                after[m] = ([put] if spans[m] == ((0, 0), (0, 0)) else
                            ["if (p >= 0 && p < ylen && lx >= 0 && lx < TX)", "  " + put])

            def tail(_: bool, m=m) -> list[str]:
                put = [f"{m}_x[((PH % NSLOT) * RB + {i}) * {m}_C + (lx - {m}_XA)] = v_{m}_{i};"
                       for i in range(rb) if m in rings]
                return put + [f"n_{m}_{i} = v_{m}_{i};" for i in range(rb) if m in carried]

            run = column_run(gen, [m], rb, "p", "xin && p >= lo && p < hi", in_regs,
                             after, tap(m), tail=tail, checks=checked)
            # a thread outside the member's columns, or a run with no row to
            # compute, carries zeros (and the run stores them)
            zero = [f"n_{m}_{i} = {ct(m)}(0);" for i in range(rb) if m in carried]
            if checked:
                put = [f"{m}_x[((PH % NSLOT) * RB + {i}) * {m}_C + (lx - {m}_XA)] = "
                       f"{ct(m)}(0);" for i in range(rb) if m in rings]
                run = [f"const int lo = c.ylo_l > {m}_YLO ? c.ylo_l : {m}_YLO;",
                       f"const int hi = c.yhi_l < ylen + {m}_YHI ? c.yhi_l : ylen + {m}_YHI;",
                       "if (xin && pb < hi && pb + RB > lo) {",
                       *("  " + ln for ln in run),
                       *(["} else {", *("  " + ln for ln in put + zero)] if put + zero else []),
                       "}"]
            out += [f"{{  // member {m}, lead {leads[m]}",
                    f"  const int pb = s * RB + {m}_LEAD;",
                    f"  if ((unsigned)(lx - {m}_XA) < (unsigned){m}_C) {{",
                    *("    " + ln for ln in run),
                    *(["  } else {", *("    " + ln for ln in zero)] if zero else []),
                    "  }", "}"]
            for q in [q for q, c in last.items() if c == m and carried[q]]:
                out.append(f"// {q}: the rows carried to the next step")
                out += [f"r.{q}_{i} = {window(q, i + rb)};" for i in range(carried[q])]
        return out

    S += ["  if (interior) {",
          *("    " + ln for ln in members_at(False)),
          "  } else {",
          *("    " + ln for ln in members_at(True)),
          "  }"]
    stores = [ln for q in ins for ln in store(q, "s + 1")]
    if stores:
        S += ["  if (ahead) {  // 4. the rows of step s + 1 into the rings",
              *("    " + ln for ln in stores), "  }"]
    L += S + ["}", ""]

    M = ["// a thread's march from step s up to its next step barrier (on the card,",
         "// to the chunk's end); returns the step it stops at",
         "SODA_BODY int soda_march(int s, soda_regs& r, const soda_ctx& c) {"]
    if phases > 1:
        M += ["#ifdef SODA_HOST_EMULATION",
              "  // a turn resumes at its step's phase",
              f"  switch ((s - S_LO) % {phases}) {{",
              *(f"    case {k}: goto phase{k};" for k in range(1, phases)),
              "    default: break;",
              "  }",
              "#endif"]
    M.append("  while (s < c.s_end) {")
    for k in range(phases):
        if k:
            M += ["    if (s == c.s_end) break;",
                  "#ifdef SODA_HOST_EMULATION",
                  f"  phase{k}:",
                  "#endif"]
        M += [f"    soda_step<{k}>(s, r, c);", "    ++s;", "    SODA_STEP_END();"]
    M += ["  }", "  return s;", "}", ""]
    L += M

    call = ", ".join(names + ["d0", "d1"])
    decl = ", ".join(args + [dims])
    L += ["SODA_BODY void soda_body(int bx, int by, int tid, unsigned char* smem,",
          f"                       {decl}) {{",
          f"  const soda_ctx c = soda_make_ctx(bx, by, tid, smem, {call});",
          "  soda_regs r{};",
          "  soda_cta_begin();",
          "  soda_prologue(c);",
          "  soda_step_wait();",
          "  soda_march(S_LO, r, c);",
          "}", "",
          "#ifdef SODA_HOST_EMULATION",
          "// a CTA on the host: its NT threads take turns, each up to its next step",
          "// barrier; the copies land once every thread has reached it",
          "SODA_BODY void soda_emulate_cta(int bx, int by, unsigned char* smem,",
          f"                              {decl}) {{",
          "  std::vector<soda_ctx> c;",
          "  for (int tid = 0; tid < NT; ++tid)",
          f"    c.push_back(soda_make_ctx(bx, by, tid, smem, {call}));",
          "  std::vector<soda_regs> r(NT, soda_regs{});",
          "  std::vector<int> at(NT, S_LO);",
          "  soda_cta_begin();",
          "  for (int tid = 0; tid < NT; ++tid) soda_prologue(c[tid]);",
          "  soda_step_wait();",
          "  for (bool more = true; more;) {",
          "    more = false;",
          "    for (int k = 0; k < NT; ++k) {",
          "      const int tid = SODA_TURN(k, NT);",
          "      if (at[tid] < c[tid].s_end) at[tid] = soda_march(at[tid], r[tid], c[tid]);",
          "      more = more || at[tid] < c[tid].s_end;",
          "    }",
          "    soda_step_wait();",
          "  }",
          "}",
          "#endif", ""]
    L += entry_points(
        kernel, decl, call, "blockIdx.x, blockIdx.y, threadIdx.x",
        "(unsigned)((d1 + TX - 1) / TX), (unsigned)((d0 + BY - 1) / BY)",
        ["  for (int by = 0; by < (int)((d0 + BY - 1) / BY); ++by)",
         "    for (int bx = 0; bx < (int)((d1 + TX - 1) / TX); ++bx)",
         "      soda_emulate_cta(bx, by, smem.data(),"], min_blocks(g, g.threads))
    return "\n".join(L)
