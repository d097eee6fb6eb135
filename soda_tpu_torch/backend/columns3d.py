"""The column z-march of rank-3 multi-level groups: kernel source and
wrapper.

`GroupKernel` (kernel 1, picked by `cuda.group_kernel`) and
`backend/sweeps.py` (the rank-3 cascade) run a group through this
generator where the plan's march is "columns3d" (`GroupPlan.march`; the
planner takes it for a group with a stage at level 2 or deeper wherever
its registers fit, `plan/planner.py`), else through the rings
(`linebuffer.kernel_source`, "rings3d").  See `csrc/columns3d.cuh` for
the design and what bounds it.

A CTA owns a (TY, TX) tile and a chunk of BZ planes; each of its NT
threads owns KT columns of the tile and KH of the halo around it
(`planner.zcolumn_halo`) for the whole chunk, their positions and checks
in `soda_ctx`, made once.  Member m computes the plane s + lead_m at step
s (`GroupPlan.leads`), at every column the thread owns inside its span,
in one column run of one cell (`column_run`): a tap at the thread's own
column reads the step's value `n_<q>_<k>` or a plane carried in
`soda_regs` (`planner.zcolumn_windows`, kept apart for the tile's columns
and the halo's), an in-plane tap the member's exchange buffer (slot
`(s - S_LO) % NSLOT` of the step, `planner.zcolumn_slots`) or the input's
ring.  A member's tile columns run without per-cell checks where the
plane and all of them lie inside the grid.  The inputs are fed as in the
rings (`csrc/linebuffer3d.cuh`): by TMA, thread 0 copying each input
plane `AHEAD` steps ahead and every thread waiting on the slot of the
step's leading plane, or on the scalar path, each thread loading its
elements of the next step's plane.  One barrier ends a step
(`SODA_STEP_END`).  The chunk runs from step `S_LO`
(`planner.zcolumn_steps`: the first plane each member and input needs)
to the step whose planes pass the chunk by `EXTRA`; a member computes
only the planes its span needs, zero outside the grid.
"""

from __future__ import annotations

from ..ir.program import StencilProgram
from ..plan import planner
from ..plan.planner import GroupPlan
from . import linebuffer
from .cuda_codegen import RunGen, column_run, offset_tag, ring_var, storage_ctype
from .linebuffer import (entry_points, fetch_plane, kernel_args, min_blocks, plane_pre,
                         store_plane, tma_entry_points, tma_feed, tma_wait)


def kernel_source(program: StencilProgram, g: GroupPlan,
                  kernel: str = "soda_lb3d_kernel", note: str = "") -> str:
    """CUDA C++ of the column z-march for one rank-3 group under one plan;
    the `__global__` is named `kernel`, and `note` (comment lines) heads
    the source."""
    ty, tx = g.tile
    nt = g.threads
    members, ins, spans, leads = g.stages, g.external_inputs, g.spans, g.leads
    rings = {r.name: r for r in g.rings}
    exchanged = [m for m in members if m in rings]
    tma = g.feed == "tma"
    kt = ty * tx // nt
    (hylo, hyhi, hxlo, hxhi), nh = planner.zcolumn_halo(g.tile, members, spans)
    kh = -(-nh // nt)
    halo = planner.zcolumn_halo_members(members, spans)
    bit = {m: 1 << i for i, m in enumerate(halo)}
    s_lo, extra = planner.zcolumn_steps(members, ins, spans, leads)
    # a slot class: its name, its slots (k global) and the members it computes
    classes = [("t", list(range(kt)), members), ("h", list(range(kt, kt + kh)), halo)]
    carried = {cls: planner.zcolumn_windows(program, readers, spans, leads)
               for cls, _, readers in classes}
    gen = RunGen(program, set(ins) | set(members))
    out_set = set(g.outputs)

    def ct(n: str) -> str:
        return storage_ctype(program.tensors[n].type)

    def own(q: str) -> int:
        """The plane (from the step's) of q's own value at a step."""
        return leads[q] if q in leads else spans[q][0][1]

    def index(cls: str, k: int) -> int:
        return k if cls == "t" else k - kt

    args, names = kernel_args(program, g)
    dims = "int64_t d0, int64_t d1, int64_t d2"
    maps = [f"const soda_tmap& {n}_m" for n in ins] if tma else []

    L = [*note.splitlines(),
         f"// generated by soda_tpu_torch for kernel `{program.name}`, "
         f"stages {g.stages}, leads {g.leads}, column z-march, "
         + (f"TMA plane copies {g.ahead} step(s) ahead" if tma else "scalar plane copies"),
         '#include "columns3d.cuh"', "",
         "namespace {",
         f"constexpr int TY = {ty}, TX = {tx}, BZ = {g.bz}, NT = {nt};",
         f"constexpr int KT = {kt}, KH = {kh};  // a thread's tile and halo columns",
         f"constexpr int HYLO = {hylo}, HYHI = {hyhi}, HXLO = {hxlo}, HXHI = {hxhi}, "
         f"NH = {nh};  // the halo and its columns",
         f"constexpr int S_LO = {s_lo};  // a chunk's first step",
         f"constexpr int EXTRA = {extra};  // planes the last step reaches past the chunk",
         *([f"constexpr int AHEAD = {g.ahead};  // steps the TMA feed runs ahead"]
           if tma else []),
         f"constexpr size_t SMEM_BYTES = {g.smem_bytes};"]
    for q in ins:
        r = rings[q]
        (zlo, zhi), (ylo, _), _ = r.span
        L += [f"// input ring {q}: span {r.span}",
              f"constexpr int {q}_D = {r.depth}, {q}_ZLO = {zlo}, {q}_ZHI = {zhi}, "
              f"{q}_YLO = {ylo}, {q}_XA = {r.col0}, {q}_R = {r.rows}, {q}_C = {r.cols}, "
              f"{q}_PS = {r.slot};",
              f"constexpr size_t {q}_OFF = {r.offset};"]
        if tma:
            L += [f"constexpr size_t {q}_BAR = {r.bar};  // its slots' mbarriers",
                  f"constexpr unsigned {q}_BYTES = {r.rows * r.cols * r.elem_bytes};"
                  "  // a plane's box"]
    for m in members:
        (zlo, zhi), (ylo, yhi), (xlo, xhi) = spans[m]
        L += [f"// member {m}: span {spans[m]}, lead {leads[m]}"
              + (f", exchange buffer of {rings[m].depth} planes" if m in rings else ""),
              f"constexpr int {m}_LEAD = {leads[m]}, {m}_ZLO = {zlo}, {m}_ZHI = {zhi}, "
              f"{m}_YLO = {ylo}, {m}_YHI = {yhi}, {m}_XLO = {xlo}, {m}_XHI = {xhi};"]
        if m in rings:
            r = rings[m]
            L += [f"constexpr int {m}_NSLOT = {r.depth}, {m}_C = {r.cols}, "
                  f"{m}_XPS = {r.slot};",
                  f"constexpr size_t {m}_OFF = {r.offset};"]
    L += ["}  // namespace", "",
          "// the planes of each tensor a thread carries from a step to the next at",
          "// its columns (registers; t: the tile's, h: the halo's; _0 the oldest)",
          "struct soda_regs {"]
    for cls, slots, _ in classes:
        for q, k in carried[cls].items():
            for i in range(len(slots)) if k else ():
                L.append(f"  {ct(q)} " + ", ".join(f"{q}_{cls}{i}_{j}" for j in range(k)) + ";")
    L += ["};", "",
          "// a thread's CTA, columns, grid bounds and pointers",
          "struct soda_ctx {",
          *(f"  {a.replace(' __restrict__', '')};" for a in args),
          *(f"  const soda_tmap* {n}_m;" for n in ins if tma),
          "  unsigned char* smem;",
          "  int64_t z0, y0, x0, d0, d1, d2;",
          "  int zlen, zlo_l, zhi_l, s_end, feed_end, tid;",
          "  bool tile_in;  // every tile column of the thread inside the grid",
          "  int ly[KT + KH], lx[KT + KH];  // its columns, tile-local",
          "  bool in[KT + KH];  // each inside the grid",
          *(["  unsigned foot[KH];  // each halo column: the members whose span holds it"]
            if kh else []),
          "};", "",
          "SODA_BODY soda_ctx soda_make_ctx(int bx, int by, int bzi, int tid, unsigned char* smem,",
          "                               " + ", ".join(maps + args + [dims]) + ") {",
          "  soda_ctx c;",
          *(f"  c.{n} = {n};" for n in names),
          *(f"  c.{n}_m = &{n}_m;" for n in ins if tma),
          "  c.smem = smem, c.tid = tid;",
          "  c.d0 = d0, c.d1 = d1, c.d2 = d2;",
          "  c.y0 = (int64_t)by * TY, c.x0 = (int64_t)bx * TX, c.z0 = (int64_t)bzi * BZ;",
          "  const int64_t zend = c.z0 + BZ < d0 ? c.z0 + BZ : d0;",
          "  // the grid in chunk-local planes and tile-local rows and columns (32-bit)",
          "  const int64_t big = (int64_t)1 << 30;",
          "  c.zlo_l = (int)-(c.z0 < big ? c.z0 : big);",
          "  c.zhi_l = (int)(d0 - c.z0 < big ? d0 - c.z0 : big);",
          "  const int ylo_l = (int)-(c.y0 < big ? c.y0 : big);",
          "  const int xlo_l = (int)-(c.x0 < big ? c.x0 : big);",
          "  const int yhi_l = (int)(d1 - c.y0 < big ? d1 - c.y0 : big);",
          "  const int xhi_l = (int)(d2 - c.x0 < big ? d2 - c.x0 : big);",
          "  c.zlen = (int)(zend - c.z0);  // the chunk's own planes",
          "  c.s_end = c.zlen + EXTRA;  // the chunk's steps end here",
          "  c.feed_end = c.zlen < c.s_end ? c.zlen : c.s_end;  // the steps an input feeds",
          "  c.tile_in = true;"]
    for k in range(kt):
        L += [f"  c.ly[{k}] = ({k} * NT + tid) / TX, c.lx[{k}] = ({k} * NT + tid) % TX;"]
    for k in range(kt, kt + kh):
        L += [f"  c.ly[{k}] = 0, c.lx[{k}] = 0;",
              f"  if ({k - kt} * NT + tid < NH)",
              f"    soda_halo_cell({k - kt} * NT + tid, TY, TX, HYLO, HYHI, HXLO, HXHI, "
              f"c.ly[{k}], c.lx[{k}]);"]
    for k in range(kt + kh):
        L += [f"  c.in[{k}] = c.ly[{k}] >= ylo_l && c.ly[{k}] < yhi_l && c.lx[{k}] >= xlo_l "
              f"&& c.lx[{k}] < xhi_l;"]
        if k < kt:
            L.append(f"  c.tile_in = c.tile_in && c.in[{k}];")
    for k in range(kt, kt + kh):
        held = [f"(c.ly[{k}] >= {m}_YLO && c.ly[{k}] < TY + {m}_YHI && c.lx[{k}] >= {m}_XLO "
                f"&& c.lx[{k}] < TX + {m}_XHI ? {bit[m]}u : 0u)" for m in halo]
        L += [f"  c.foot[{k - kt}] = 0;",
              f"  if ({k - kt} * NT + tid < NH)",
              f"    c.foot[{k - kt}] = " + "\n        | ".join(held or ["0u"]) + ";"]
    L += ["  return c;", "}", ""]

    def pointers() -> list[str]:
        out = [f"  {a} = c.{n};" for a, n in zip(args, names)]
        out += [f"  {ct(q)}* {ring_var(q)} = reinterpret_cast<{ct(q)}*>(c.smem + {q}_OFF);"
                for q in ins]
        out += [f"  uint64_t* {q}_b = reinterpret_cast<uint64_t*>(c.smem + {q}_BAR);"
                for q in ins if tma]
        out += [f"  {ct(m)}* {m}_x = reinterpret_cast<{ct(m)}*>(c.smem + {m}_OFF);"
                for m in exchanged]
        return out

    def feed(q: str, step: str) -> list[str]:
        return tma_feed(q, step, f"*c.{q}_m", "c.")

    def slot(q: str):
        return lambda pl: f"{ring_var(q)} + (({pl} - {q}_ZLO) % {q}_D) * {q}_PS"

    def fetch(q: str, step: str) -> list[str]:
        return fetch_plane(q, step, slot(q), "c.")

    def store(q: str, step: str) -> list[str]:
        return store_plane(q, step, slot(q), "c.")

    def pre(q: str) -> str:
        return plane_pre(program, q)

    if tma:
        L += ["// thread 0: the input planes of step t, copied AHEAD steps before it",
              "SODA_BODY void soda_feed(const int t, const soda_ctx& c) {",
              "  if (t >= c.feed_end) return;",
              *pointers(),
              *("  " + ln for q in ins for ln in feed(q, "t")),
              "}", "",
              "// a thread's part before the march: thread 0 copies the planes of the",
              "// first AHEAD steps",
              "SODA_BODY void soda_prologue(const soda_ctx& c) {",
              "  if (c.tid == 0)",
              "    for (int t = S_LO; t < S_LO + AHEAD; ++t) soda_feed(t, c);",
              "}", ""]
    else:
        L += ["// a thread's part before the march: its elements of the first step's",
              "// input planes",
              "SODA_BODY void soda_prologue(const soda_ctx& c) {",
              "  if (S_LO >= c.feed_end) return;",
              *pointers(),
              *("  " + ln for q in ins for ln in [pre(q)] + fetch(q, "S_LO") + store(q, "S_LO")),
              "}", ""]

    # the tap of q by member c at slot k of class cls (`column_run`'s load)
    def tap(c: str, cls: str, k: int):
        def load(q: str, key: tuple[int, ...]) -> str:
            dz, dy, dx = key
            rel = leads[c] + dz
            if dy == 0 and dx == 0:
                back = own(q) - rel
                return (f"n_{q}_{k}" if back == 0 else
                        f"r.{q}_{cls}{index(cls, k)}_{carried[cls][q] - back}")
            if q in ins:
                return (f"{ring_var(q)}[__s_{q}_{offset_tag(rel)} * {q}_PS + (ly + ({dy}) - "
                        f"{q}_YLO) * {q}_C + (lx + ({dx}) - {q}_XA)]")
            return (f"{q}_x[__x_{q}_{leads[q] - rel} * {q}_XPS + (ly + ({dy}) - {q}_YLO) * "
                    f"{q}_C + (lx + ({dx}) - {q}_XLO)]")
        return load

    # every plane of an input ring and every exchange slot a step reads
    ring_rel = {q: {own(q)} for q in ins}
    back = {m: {0} for m in exchanged}
    for c in members:
        for q, offs in program.tensors[c].window().items():
            for off in offs:
                if any(off[1:]):
                    if q in ins:
                        ring_rel[q].add(leads[c] + off[0])
                    else:
                        back[q].add(leads[q] - leads[c] - off[0])

    def slot_block(m: str, cls: str, k: int, checked: bool) -> list[str]:
        after = {}
        if m in out_set and cls == "t":
            after[m] = ["if (p >= 0 && p < zlen)",
                        f"  {m}_g[((z0 + p) * d1 + (y0 + ly)) * d2 + (x0 + lx)] = v;"]

        def tail(_: bool) -> list[str]:
            put = ([f"{m}_x[__x_{m}_0 * {m}_XPS + (ly - {m}_YLO) * {m}_C + "
                    f"(lx - {m}_XLO)] = v_{m}_0;"] if m in exchanged else [])
            return [f"n_{m}_{k} = v_{m}_0;"] + put

        run = column_run(gen, [m], 1, "p", f"zin && c.in[{k}]", {}, after,
                         tap(m, cls, k), tail=tail, checks=checked)
        return [f"{{  const int ly = c.ly[{k}], lx = c.lx[{k}];",
                *("  " + ln for ln in run), "}"]

    S = ["// step s of a thread's march",
         "SODA_BODY void soda_step(const int s, soda_regs& r, const soda_ctx& c) {",
         *pointers(),
         "  const int zlen = c.zlen;",
         "  const int64_t z0 = c.z0, y0 = c.y0, x0 = c.x0, d1 = c.d1, d2 = c.d2;",
         "  (void)z0, (void)y0, (void)x0, (void)d1, (void)d2;"]
    if tma:
        S += ["  if (s < c.feed_end) {  // 1. this step's leading input planes land",
              *("    " + ln for q in ins for ln in tma_wait(q, "s")),
              "  }"]
    else:
        S += ["  // 1. the planes of step s + 1 of every input ring, in flight while this",
              "  // step computes",
              "  const bool ahead = s + 1 < c.feed_end;",
              *("  " + pre(q) for q in ins),
              "  if (ahead) {",
              *("    " + ln for q in ins for ln in fetch(q, "s + 1")),
              "  }"]
    S += ["  // 2. the step's ring planes and exchange slots",
          *(f"  const int __s_{q}_{offset_tag(rel)} = (s + ({rel}) - {q}_ZLO) % {q}_D;"
            for q in ins for rel in sorted(ring_rel[q])),
          *(f"  const int __x_{m}_{j} = (s - S_LO + {m}_NSLOT - {j}) % {m}_NSLOT;"
            for m in exchanged for j in sorted(back[m])),
          "  // 3. each input's leading plane at the thread's columns",
          "  const bool lead = s < c.feed_end;"]
    for q in ins:
        readers = [m for m in halo if any(not any(o[1:]) for o in
                                          program.tensors[m].window().get(q, []))]
        for cls, slots, _ in classes:
            if q not in carried[cls]:
                continue
            for k in slots:
                at = (f"{ring_var(q)}[__s_{q}_{offset_tag(own(q))} * {q}_PS + "
                      f"(c.ly[{k}] - {q}_YLO) * {q}_C + (c.lx[{k}] - {q}_XA)]")
                cond = (f"lead && s + {q}_ZHI >= {q}_ZLO" if cls == "t" else
                        f"lead && s + {q}_ZHI >= {q}_ZLO && (c.foot[{k - kt}] & "
                        f"{sum(bit[m] for m in readers)}u)")
                S.append(f"  const {ct(q)} n_{q}_{k} = {cond} ? {at} : {ct(q)}(0);")
    S += ["  // 4. the members, each at its own plane, at every column it holds"]
    for m in members:
        slots = list(range(kt)) + (list(range(kt, kt + kh)) if m in halo else [])
        S.append(f"  {ct(m)} " + ", ".join(f"n_{m}_{k} = {ct(m)}(0)" for k in slots) + ";")
    for m in members:
        S += [f"  {{  // member {m}, lead {leads[m]}",
              f"    const int pb = s + {m}_LEAD;",
              f"    if (pb >= {m}_ZLO && pb < zlen + {m}_ZHI) {{",
              "      const bool zin = pb >= c.zlo_l && pb < c.zhi_l;",
              "      if (zin && c.tile_in) {  // every tile column inside the grid",
              *("        " + ln for k in range(kt) for ln in slot_block(m, "t", k, False)),
              "      } else {",
              *("        " + ln for k in range(kt) for ln in slot_block(m, "t", k, True)),
              "      }"]
        if m in halo:
            for k in range(kt, kt + kh):
                S += [f"      if (c.foot[{k - kt}] & {bit[m]}u) {{",
                      *("        " + ln for ln in slot_block(m, "h", k, True)),
                      "      }"]
        S += ["    }", "  }"]
    S.append("  // 5. the carried planes move on by one")
    for cls, slots, _ in classes:
        for q, n in carried[cls].items():
            for k in slots if n else ():
                i = index(cls, k)
                S += [f"  r.{q}_{cls}{i}_{j} = r.{q}_{cls}{i}_{j + 1};" for j in range(n - 1)]
                S.append(f"  r.{q}_{cls}{i}_{n - 1} = n_{q}_{k};")
    if not tma:
        S += ["  if (ahead) {  // 6. the planes of step s + 1 into the rings",
              *("    " + ln for q in ins for ln in store(q, "s + 1")), "  }"]
    L += S + ["}", ""]

    L += ["// a thread's march from step s up to its next step's end (on the card, to",
          "// the chunk's end); returns the step it stops at",
          "SODA_BODY int soda_march(int s, soda_regs& r, const soda_ctx& c) {",
          "  while (s < c.s_end) {",
          *(["    if (c.tid == 0) soda_feed(s + AHEAD, c);"] if tma else []),
          "    soda_step(s, r, c);",
          "    ++s;",
          "    SODA_STEP_END();",
          "  }",
          "  return s;",
          "}", ""]

    call = ", ".join(names + ["d0", "d1", "d2"])
    passed = ", ".join([f"{n}_m" for n in ins] + [call]) if tma else call
    decl = ", ".join(maps + args + [dims])
    def begin(tid: str) -> list[str]:
        # the CTA starts with no copy in flight, and the TMA feed's slot
        # barriers set
        return ["  soda_cta_begin();",
                *(f"  soda_bar_init(reinterpret_cast<uint64_t*>(smem + {q}_BAR), {q}_D, {tid});"
                  for q in ins if tma),
                *(["  SODA_SYNC();"] if tma else [])]

    L += ["SODA_BODY void soda_body(int bx, int by, int bzi, int tid, unsigned char* smem,",
          f"                       {decl}) {{",
          f"  const soda_ctx c = soda_make_ctx(bx, by, bzi, tid, smem, {passed});",
          "  soda_regs r{};",
          *begin("tid"),
          "  soda_prologue(c);",
          *([] if tma else ["  soda_step_wait();"]),
          "  soda_march(S_LO, r, c);",
          *(["  soda_feed_end();"] if tma else []),
          "}", "",
          "#ifdef SODA_HOST_EMULATION",
          "// a CTA on the host: its NT threads take turns, each up to its next step's",
          "// end; the scalar path's copies land once every thread has reached it",
          "SODA_BODY void soda_emulate_cta(int bx, int by, int bzi, unsigned char* smem,",
          f"                              {decl}) {{",
          "  std::vector<soda_ctx> c;",
          "  for (int tid = 0; tid < NT; ++tid)",
          f"    c.push_back(soda_make_ctx(bx, by, bzi, tid, smem, {passed}));",
          "  std::vector<soda_regs> r(NT, soda_regs{});",
          "  std::vector<int> at(NT, S_LO);",
          *begin("0"),
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
          *(["  soda_feed_end();"] if tma else []),
          "}",
          "#endif", ""]
    block = "blockIdx.x, blockIdx.y, blockIdx.z, threadIdx.x"
    grid = ("(unsigned)((d2 + TX - 1) / TX), (unsigned)((d1 + TY - 1) / TY), "
            "(unsigned)((d0 + BZ - 1) / BZ)")
    loops = ["  for (int bzi = 0; bzi < (int)((d0 + BZ - 1) / BZ); ++bzi)",
             "    for (int by = 0; by < (int)((d1 + TY - 1) / TY); ++by)",
             "      for (int bx = 0; bx < (int)((d2 + TX - 1) / TX); ++bx)",
             "        soda_emulate_cta(bx, by, bzi, smem.data(),"]
    if tma:
        L += tma_entry_points(kernel, ", ".join(args + [dims]), call, block, grid, loops,
                              ins, min_blocks(g, nt))
    else:
        L += entry_points(kernel, ", ".join(args + [dims]), call, block, grid, loops,
                          min_blocks(g, nt))
    return "\n".join(L)


class GroupKernel(linebuffer.GroupKernel):
    """Kernel 1's wrapper of a group in the column z-march:
    `linebuffer.GroupKernel`, its kernel name, checks and counts, with this
    module's source."""

    def _generate(self) -> str:
        return kernel_source(self.program, self.group)
