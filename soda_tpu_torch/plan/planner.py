"""Shared-memory planner for the Hopper line-buffer kernels.

Counterpart of `soda_tpu/plan/planner.py::plan` and `GroupPlan`.  The
stage grouping and the window arithmetic are the port's copies
(`plan/spans.py`); the TPU's VMEM model, its (8, 128) rules and its
Mosaic-calibrated constants are replaced by a model of one CUDA thread
block.  Both kernels march one axis and keep a ring in shared memory for
every tensor the group reads at an offset (the external inputs, and the
stages consumed by another stage of the group); a tensor's halo comes
from its span relative to the output cell (`group_spans`), its ring depth
from its lag (below):

- rank 3, kernel 1 (`csrc/linebuffer3d.cuh`): a CTA owns a (TY, TX)
  column tile of the (Y, X) plane and a z-chunk of BZ planes, and
  marches z one plane at a time; a ring holds (lag + 1) planes of the
  tile and its y/x halo;
- rank 2, kernel 2 (`csrc/linebuffer2d.cuh`): a CTA owns a strip of TX
  columns of the contiguous last axis and a chunk of BY rows, and
  marches the rows RB at a time; a ring holds a power of two of at least
  (lag + RB) rows, each TX + x halo wide.  `tile` is (RB, TX) and `bz`
  is BY.

A ring's lag is how far its leading plane (its span's hi along the
marched axis) runs ahead of the lowest plane any consumer in the group
reads at the same step: min over consumers c of (c's span hi + c's lowest
offset on it).  The ring keeps exactly the planes still read.

Fused sweeps (TPU kernel 3, `backend/sweeps.py`): an `iterate` program
with fused depth nf is planned as the group of `unroll_iterate(program,
nf)`, a cascade of nf sweep copies in which copy k reads copy k-1 through
a ring, so that every sweep between the first read and the last write
stays in shared memory.  nf divides the executed `iterate`; with
`sweeps=None` it is the divisor up to `AUTO_SWEEPS_MAX[rank]` with the
least modeled time per sweep (`GroupPlan.modeled_seconds`) among the
cascades that fit the budget, preferring those that fill the card.  A
fused group holds the whole sweep chain; when no depth above 1 fits, or
the program's feedback types differ, each call runs one sweep and the
stage DAG may split into chained groups as for any program.

Shared memory per CTA is at most 227 KB on the H100; the planner keeps
under `smem_budget` so that several CTAs share an SM, and prefers plans
with at least two CTAs per SM.

`hbm_bytes_per_call` counts every byte the kernel moves: each input cell
a CTA loads, with its tile halo across the marched axis (re-read by the
neighbouring tiles) and the warm-up of each chunk along it, clipped to
the grid; plus one write per output cell.  `cell_ops_per_call` counts the
operations the kernel computes: every stage over its whole ring width and
its chunk's warm-up (the cascade's trapezoid), clipped to the grid, times
its f32-equivalent operations per cell (`utils/opcount.py::typed_ops`).
"""

from __future__ import annotations

import copy
import dataclasses
import math

from ..ir import expr as ir
from ..ir.program import StencilProgram
from ..optimize.unroll import FeedbackTypeError, unroll_iterate
from ..utils.opcount import H100_SXM_PEAK_TFLOPS, ops_per_cell, typed_ops
from .spans import _group_io, group_spans

Span = tuple[tuple[int, int], ...]

SMEM_PER_BLOCK_MAX = 232_448        # H100: 227 KB of dynamic shared memory
SMEM_PER_SM = 233_472               # H100: 228 KB an SM gives its CTAs
SMEM_BUDGET = 96 * 1024             # default: at least two CTAs per SM
NUM_SMS = 132                       # H100 SXM
NTHREADS = 256                      # threads per CTA
MAX_GRID_YZ = 65_535                # CUDA limit on gridDim.y and gridDim.z
H100_SXM_PEAK_GBPS = 3350.0         # published HBM3 bandwidth at 700 W
TILE_CANDIDATES = ((32, 64), (16, 64), (32, 32), (16, 32), (8, 32))  # (TY, TX)
BZ_CANDIDATES = (256, 128, 64, 32, 16, 8)
ROW_TILE_CANDIDATES = ((8, 256), (4, 256), (8, 128), (4, 128), (2, 128),
                       (1, 128), (1, 64), (1, 32))                   # (RB, TX)
BY_CANDIDATES = (2048, 1024, 512, 256, 128, 64, 32, 16, 8)
# chunks longer than 64 planes / 512 rows only where the warm-up asks for
# them (a fused cascade): at most one warm-up per CHUNK_PER_WARM planes
CHUNK_BASE_MAX = {3: 64, 2: 512}
CHUNK_PER_WARM = 16
# the deepest depth `sweeps=None` picks, per rank: deeper cascades ran
# slower on the H100 than the model predicts (PERF.md, the depth sweeps)
AUTO_SWEEPS_MAX = {2: 8, 3: 2}

RANK1_ROADMAP = ("rank 1 runs through the windows kernel (kernel 4, "
                 "ROADMAP.md queue 1), which is not ported to CUDA yet; "
                 "run it on the CPU path (device='cpu')")
KERNELS = {3: "linebuffer3d", 2: "linebuffer2d"}


@dataclasses.dataclass(frozen=True)
class Ring:
    """A tensor held in shared memory as a ring of slots along the
    marched axis: z-planes of rows x cols (rank 3), or rows of 1 x cols
    (rank 2)."""

    name: str
    span: Span              # (lo, hi) per dim relative to the output cell
    elem_bytes: int
    depth: int              # slots kept
    rows: int               # TY + y halo (rank 3); 1 (rank 2)
    cols: int               # TX + x halo
    offset: int             # byte offset in the CTA's shared memory

    @property
    def nbytes(self) -> int:
        return self.depth * self.rows * self.cols * self.elem_bytes


@dataclasses.dataclass
class GroupPlan:
    """One fused kernel: a set of stages executed in one launch."""

    stages: list[str]                    # topo order within the group
    external_inputs: list[str]           # tensors read from outside the group
    outputs: list[str]                   # tensors written to device memory
    spans: dict[str, Span]               # extent of each tensor rel. to the output cell
    params: list[str]                    # params the group's stages read
    tile: tuple[int, int]                # (TY, TX) rank 3; (RB, TX) rank 2
    bz: int                              # chunk along the marched axis: BZ planes / BY rows
    grid: tuple[int, int, int]           # CUDA grid (x, y, z)
    rings: list[Ring]
    warm: int                            # marched-axis warm-up before a chunk's first output
    smem_bytes: int
    hbm_bytes_per_call: int
    useful_cells_per_call: int           # cells x sweeps x outputs
    sweeps: int = 1                      # fused sweeps per call (a cascade when > 1)
    kernel: str = "linebuffer3d"
    cell_ops_per_call: float = 0.0       # computed cells x ops, trapezoid included

    @property
    def modeled_seconds(self) -> float:
        """Modeled time of one call on the H100: the larger of its planned
        bytes over 3.35 TB/s and its computed operations over 67 TFLOP/s."""
        return max(self.hbm_bytes_per_call / (H100_SXM_PEAK_GBPS * 1e9),
                   self.cell_ops_per_call / (H100_SXM_PEAK_TFLOPS * 1e12))

    def describe(self) -> str:
        chunk = "bz" if self.kernel == "linebuffer3d" else "by"
        return (
            f"group(stages={self.stages}, {self.kernel}, sweeps={self.sweeps}, "
            f"tile={self.tile}, {chunk}={self.bz}, grid={self.grid}, "
            f"smem={self.smem_bytes / 1024:.1f}KiB, "
            f"traffic={self.hbm_bytes_per_call / max(self.useful_cells_per_call, 1):.3f}"
            f"B/cell-update)")


@dataclasses.dataclass
class Plan:
    program_name: str
    rank: int
    groups: list[GroupPlan]              # executed in order, chained through device memory
    grid_shape: tuple[int, ...]
    notes: list[str]
    ideal_bytes_per_cell: float          # inputs read once + outputs written once
    ops_per_cell: float                  # f32-equivalent ops, one sweep of the program
    sweeps_total: int = 1

    def describe(self) -> str:
        out = [f"plan for {self.program_name} on grid {self.grid_shape}:"]
        out += ["  " + g.describe() for g in self.groups]
        out += ["  note: " + n for n in self.notes]
        return "\n".join(out)


def cascade(program: StencilProgram, nf: int) -> StencilProgram:
    """The program a group of `nf` fused sweeps runs: `nf` chained sweep
    copies (`unroll_iterate`), whatever the program's own `iterate`."""
    if nf <= 1:
        return program
    one_call = copy.copy(program)
    one_call.iterate = nf
    return unroll_iterate(one_call, nf)


def _elem_bytes(program: StencilProgram, name: str) -> int:
    return program.tensors[name].type.np_dtype().itemsize


def _group_params(program: StencilProgram, stages: list[str]) -> list[str]:
    seen: dict[str, None] = {}
    for s in stages:
        for n in ir.walk(program.tensors[s].expr):
            if isinstance(n, (ir.ParamRef, ir.Var)):
                seen.setdefault(n.name, None)
    return list(seen)


def _covered(n: int, tile: int, lo: int, hi: int) -> int:
    """Sum over the tiles of one dim of the cells each tile loads,
    [start + lo, start + tile - 1 + hi], clipped to [0, n)."""
    total = 0
    for start in range(0, n, tile):
        a = max(start + lo, 0)
        b = min(start + tile - 1 + hi, n - 1)
        total += max(b - a + 1, 0)
    return total


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _shapes(rank: int, grid_shape, tile, bz, warm: int):
    """(tile, chunk, CUDA grid) candidates of one kernel on one grid."""
    longest = max(CHUNK_BASE_MAX[rank], CHUNK_PER_WARM * warm)
    if rank == 3:
        Z, Y, X = grid_shape
        for ty, tx in [tile] if tile else TILE_CANDIDATES:
            for bz_ in [bz] if bz else [c for c in BZ_CANDIDATES if c <= longest]:
                yield (ty, tx), bz_, (-(-X // tx), -(-Y // ty), -(-Z // bz_))
    else:
        H, W = grid_shape
        for rb, tx in [tile] if tile else ROW_TILE_CANDIDATES:
            for by in [bz] if bz else [c for c in BY_CANDIDATES if c <= longest]:
                if by % rb == 0:
                    yield (rb, tx), by, (-(-W // tx), -(-H // by), 1)


def _ring(rank: int, n: str, span: Span, lag: int, elem: int, tile, off: int) -> Ring:
    if rank == 3:
        (_, _), (ylo, yhi), (xlo, xhi) = span
        ty, tx = tile
        return Ring(n, span, elem, lag + 1, ty + yhi - ylo, tx + xhi - xlo, off)
    (_, _), (xlo, xhi) = span
    rb, tx = tile
    return Ring(n, span, elem, _pow2(lag + rb), 1, tx + xhi - xlo, off)


def _lags(program: StencilProgram, members: list[str], spans: dict[str, Span]
          ) -> dict[str, int]:
    """Per tensor read in the group: its span hi along the marched axis
    minus the lowest plane (relative to the step) any consumer reads."""
    lowest: dict[str, int] = {}
    for c in members:
        hi_c = spans[c][0][1]
        for q, offs in program.tensors[c].window().items():
            low = hi_c + min(o[0] for o in offs)
            lowest[q] = min(lowest.get(q, low), low)
    return {q: spans[q][0][1] - low for q, low in lowest.items()}


def _plan_group(program: StencilProgram, members: list[str],
                grid_shape: tuple[int, ...], smem_budget: int,
                tile: tuple[int, int] | None = None,
                bz: int | None = None, sweeps: int = 1) -> GroupPlan | None:
    rank = program.rank
    ext_inputs, outputs = _group_io(program, members)
    spans = group_spans(program, members, outputs)
    # dead stages (no path to a group output) are never materialized
    members = [m for m in members if m in spans]
    ext_inputs = [i for i in ext_inputs if i in spans]
    consumed = {p for m in members for p in program.tensors[m].parents()}
    ring_names = ext_inputs + [m for m in members if m in consumed]
    lags = _lags(program, members, spans)
    warm = max((spans[n][0][1] - spans[n][0][0] for n in ring_names), default=0)
    cells = math.prod(grid_shape)
    writes = cells * sum(_elem_bytes(program, o) for o in outputs)
    useful = cells * sweeps * max(len(outputs), 1)
    ops = {m: typed_ops(program, program.tensors[m].expr) for m in members}

    best = None
    for tl, chunk, grid in _shapes(rank, grid_shape, tile, bz, warm):
        rings, off = [], 0
        for n in ring_names:
            r = _ring(rank, n, spans[n], lags[n], _elem_bytes(program, n), tl, off)
            rings.append(r)
            off += -(-r.nbytes // 16) * 16
        if off > min(smem_budget, SMEM_PER_BLOCK_MAX):
            continue
        if grid[1] > MAX_GRID_YZ or grid[2] > MAX_GRID_YZ:
            continue
        # tile extent per dim: the marched axis in chunks, the others in tiles
        extents = (chunk,) + tuple(tl) if rank == 3 else (chunk, tl[1])

        def covered(n: str) -> int:
            return math.prod(_covered(grid_shape[d], extents[d], lo, hi)
                             for d, (lo, hi) in enumerate(spans[n]))

        reads = sum(_elem_bytes(program, n) * covered(n) for n in ext_inputs)
        # every stage over its ring width and warm-up (an output no stage
        # reads has span 0: exactly the grid)
        cell_ops = sum(ops[m] * covered(m) for m in members)
        gp = GroupPlan(
            stages=members, external_inputs=ext_inputs,
            outputs=outputs, spans=spans,
            params=_group_params(program, members),
            tile=tl, bz=chunk, grid=grid, rings=rings, warm=warm,
            smem_bytes=off, hbm_bytes_per_call=reads + writes,
            useful_cells_per_call=useful, sweeps=sweeps, kernel=KERNELS[rank],
            cell_ops_per_call=cell_ops)
        # too few CTAs to fill the card counts first, then the modeled
        # time; equal time prefers the larger tile and chunk
        key = (math.prod(grid) < 2 * NUM_SMS, gp.modeled_seconds,
               -tl[0] * tl[1], -chunk)
        if best is None or key < best[0]:
            best = (key, gp)
    return None if best is None else best[1]


def _fitting(program: StencilProgram, grid_shape: tuple[int, ...], depths,
             smem_budget: int, tile=None, bz=None):
    """(nf, GroupPlan) for each depth in `depths` whose whole cascade fits."""
    for d in depths:
        prog = cascade(program, d)
        g = _plan_group(prog, prog.stage_order(), grid_shape, smem_budget,
                        tile, bz, sweeps=d)
        if g is not None:
            yield d, g


def _plan_fused(program: StencilProgram, grid_shape: tuple[int, ...], it: int,
                sweeps: int | None, smem_budget: int, tile, bz,
                notes: list[str]) -> GroupPlan | None:
    """The fused group of an `iterate` program, or None to run one sweep
    per call.  A requested depth is snapped to a divisor of `it` and, if
    its cascade does not fit, reduced to the next divisor that does."""
    divisors = [d for d in range(1, it + 1) if it % d == 0]
    try:
        if sweeps is not None:
            nf = max(1, min(sweeps, it))
            while it % nf:
                nf -= 1
            if nf != sweeps:
                notes.append(f"requested sweeps {sweeps} adjusted to divisor {nf} "
                             f"of iterate {it}")
            deeper_first = sorted((d for d in divisors if 1 < d <= nf), reverse=True)
            d, g = next(_fitting(program, grid_shape, deeper_first, smem_budget,
                                 tile, bz), (nf, None))
            if g is not None and d != nf:
                notes.append(f"shared memory: reduced fused sweeps {nf} to {d}")
            if g is None and nf > 1:
                notes.append(f"shared memory: no fused depth up to {nf} fits; "
                             f"one sweep per call")
            return g
        cap = AUTO_SWEEPS_MAX[program.rank]
        fits = _fitting(program, grid_shape, [d for d in divisors if d <= cap],
                        smem_budget, tile, bz)
        best = min(fits, default=None, key=lambda dg: (
            math.prod(dg[1].grid) < 2 * NUM_SMS, dg[1].modeled_seconds / dg[0]))
    except FeedbackTypeError as e:
        notes.append(f"{e}: no cascade; one sweep per call")
        return None
    if best is None or best[0] == 1:
        return None
    g = best[1]
    notes.append(f"auto sweeps: {g.sweeps} fused sweeps, the least modeled "
                 f"time per sweep ({g.modeled_seconds / g.sweeps * 1e3:.4f} ms) "
                 f"among the divisors of {it} up to {cap} that fit")
    return g


def fused_depths(program: StencilProgram, grid_shape: tuple[int, ...]) -> list[int]:
    """The divisors above 1 of the program's `iterate` whose whole cascade
    fits `SMEM_BUDGET` on `grid_shape` (ascending)."""
    it = max(program.iterate, 1)
    return [d for d, _ in _fitting(program, tuple(grid_shape),
                                   [d for d in range(2, it + 1) if it % d == 0],
                                   SMEM_BUDGET)]


def plan(program: StencilProgram, grid_shape: tuple[int, ...], *,
         smem_budget: int = SMEM_BUDGET, sweeps: int | None = None,
         iterate: int | None = None, tile: tuple[int, int] | None = None,
         bz: int | None = None) -> Plan:
    """Plan `program` on a full grid of `grid_shape` for the CUDA path.

    `iterate` programs first try a fused group of nf sweeps (see the
    module note; `sweeps` requests a depth, `sweeps=1` asks for one sweep
    per call).  Otherwise the fusion policy is `soda_tpu`'s: all stages in
    one kernel when its rings fit the shared-memory budget; else the stage
    DAG is split greedily, in topological order, into kernels chained
    through device memory, each call running one sweep.  `tile` and `bz`
    pin the CTA shape instead of searching."""
    if program.rank == 1:
        raise NotImplementedError(
            f"program {program.name!r} has rank 1: {RANK1_ROADMAP}")
    if len(grid_shape) != program.rank:
        raise ValueError(f"grid rank {len(grid_shape)} != program rank {program.rank}")
    grid_shape = tuple(grid_shape)
    it = max(program.iterate if iterate is None else iterate, 1)
    notes: list[str] = []
    ideal = float(sum(_elem_bytes(program, n) for n in program.input_names)
                  + sum(_elem_bytes(program, n) for n in program.output_names))
    per_cell = dict(ideal_bytes_per_cell=ideal, ops_per_cell=ops_per_cell(program),
                    sweeps_total=it)
    if it > 1:
        fused = _plan_fused(program, grid_shape, it, sweeps, smem_budget,
                            tile, bz, notes)
        if fused is not None:
            notes.append(f"iterate={it} executed as {it // fused.sweeps} kernel "
                         f"call(s) x {fused.sweeps} fused sweeps")
            return Plan(program.name, program.rank, [fused], grid_shape, notes,
                        **per_cell)
    stages = program.stage_order()

    groups: list[GroupPlan] = []
    whole = _plan_group(program, stages, grid_shape, smem_budget, tile, bz)
    if whole is not None:
        groups.append(whole)
    else:
        cur: list[str] = []
        cur_plan = None
        for s in stages:
            gp = _plan_group(program, cur + [s], grid_shape, smem_budget, tile, bz)
            if gp is not None:
                cur, cur_plan = cur + [s], gp
                continue
            if cur_plan is None:
                raise ValueError(
                    f"stage {s!r} alone does not fit the shared-memory budget "
                    f"{smem_budget} on grid {grid_shape}")
            groups.append(cur_plan)
            cur = [s]
            cur_plan = _plan_group(program, cur, grid_shape, smem_budget, tile, bz)
            if cur_plan is None:
                raise ValueError(
                    f"stage {s!r} alone does not fit the shared-memory budget "
                    f"{smem_budget} on grid {grid_shape}")
        groups.append(cur_plan)
        notes.append(f"shared-memory pressure: split {len(stages)} stages "
                     f"into {len(groups)} chained kernels")
    notes.append(f"iterate={it} executed as {it} chained call(s) of one sweep")
    return Plan(program.name, program.rank, groups, grid_shape, notes, **per_cell)
