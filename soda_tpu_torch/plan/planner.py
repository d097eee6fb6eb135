"""Shared-memory planner for the Hopper line-buffer kernels.

Counterpart of `soda_tpu/plan/planner.py::plan` and `GroupPlan`.  The
stage grouping and the window arithmetic are the port's copies
(`plan/spans.py`); the TPU's VMEM model, its (8, 128) rules and its
Mosaic-calibrated constants are replaced by a model of one CUDA thread
block.  Both kernels march one axis and keep a ring in shared memory for
every tensor the group reads at an offset (the external inputs, and the
stages consumed by another stage of the group); a tensor's ring depth
and halo come from its span relative to the output cell (`group_spans`):

- rank 3, kernel 1 (`csrc/linebuffer3d.cuh`): a CTA owns a (TY, TX)
  column tile of the (Y, X) plane and a z-chunk of BZ planes, and
  marches z one plane at a time; a ring holds (z span) planes of the
  tile and its y/x halo;
- rank 2, kernel 2 (`csrc/linebuffer2d.cuh`): a CTA owns a strip of TX
  columns of the contiguous last axis and a chunk of BY rows, and
  marches the rows RB at a time; a ring holds a power of two of at least
  (y span + RB) rows, each TX + x halo wide.  `tile` is (RB, TX) and
  `bz` is BY.

Shared memory per CTA is at most 227 KB on the H100; the planner keeps
under `smem_budget` so that several CTAs share an SM, and prefers plans
with at least two CTAs per SM.

`hbm_bytes_per_call` counts every byte the kernel moves: each input cell
a CTA loads, with its tile halo across the marched axis (re-read by the
neighbouring tiles) and the warm-up of each chunk along it, clipped to
the grid; plus one write per output cell.  Each call runs one sweep;
`iterate` runs as chained calls.
"""

from __future__ import annotations

import dataclasses
import math

from ..ir import expr as ir
from ..ir.program import StencilProgram
from .spans import _group_io, group_spans

Span = tuple[tuple[int, int], ...]

SMEM_PER_BLOCK_MAX = 232_448        # H100: 227 KB of dynamic shared memory
SMEM_BUDGET = 96 * 1024             # default: at least two CTAs per SM
NUM_SMS = 132                       # H100 SXM
NTHREADS = 256                      # threads per CTA
MAX_GRID_YZ = 65_535                # CUDA limit on gridDim.y and gridDim.z
TILE_CANDIDATES = ((32, 64), (16, 64), (32, 32), (16, 32), (8, 32))  # (TY, TX)
BZ_CANDIDATES = (64, 32, 16, 8)
ROW_TILE_CANDIDATES = ((8, 256), (4, 256), (8, 128), (4, 128), (2, 128),
                       (1, 128), (1, 64), (1, 32))                   # (RB, TX)
BY_CANDIDATES = (512, 256, 128, 64, 32, 16, 8)

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
    useful_cells_per_call: int
    sweeps: int = 1
    kernel: str = "linebuffer3d"

    def describe(self) -> str:
        chunk = "bz" if self.kernel == "linebuffer3d" else "by"
        return (
            f"group(stages={self.stages}, {self.kernel}, tile={self.tile}, "
            f"{chunk}={self.bz}, grid={self.grid}, smem={self.smem_bytes / 1024:.1f}KiB, "
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
    sweeps_total: int = 1

    def describe(self) -> str:
        out = [f"plan for {self.program_name} on grid {self.grid_shape}:"]
        out += ["  " + g.describe() for g in self.groups]
        out += ["  note: " + n for n in self.notes]
        return "\n".join(out)


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


def _shapes(rank: int, grid_shape, tile, bz):
    """(tile, chunk, CUDA grid) candidates of one kernel on one grid."""
    if rank == 3:
        Z, Y, X = grid_shape
        for ty, tx in [tile] if tile else TILE_CANDIDATES:
            for bz_ in [bz] if bz else BZ_CANDIDATES:
                yield (ty, tx), bz_, (-(-X // tx), -(-Y // ty), -(-Z // bz_))
    else:
        H, W = grid_shape
        for rb, tx in [tile] if tile else ROW_TILE_CANDIDATES:
            for by in [bz] if bz else BY_CANDIDATES:
                if by % rb == 0:
                    yield (rb, tx), by, (-(-W // tx), -(-H // by), 1)


def _ring(rank: int, n: str, span: Span, elem: int, tile, off: int) -> Ring:
    if rank == 3:
        (zlo, zhi), (ylo, yhi), (xlo, xhi) = span
        ty, tx = tile
        return Ring(n, span, elem, zhi - zlo + 1, ty + yhi - ylo, tx + xhi - xlo, off)
    (ylo, yhi), (xlo, xhi) = span
    rb, tx = tile
    return Ring(n, span, elem, _pow2(yhi - ylo + rb), 1, tx + xhi - xlo, off)


def _plan_group(program: StencilProgram, members: list[str],
                grid_shape: tuple[int, ...], smem_budget: int,
                tile: tuple[int, int] | None = None,
                bz: int | None = None) -> GroupPlan | None:
    rank = program.rank
    ext_inputs, outputs = _group_io(program, members)
    spans = group_spans(program, members, outputs)
    # dead stages (no path to a group output) are never materialized
    members = [m for m in members if m in spans]
    ext_inputs = [i for i in ext_inputs if i in spans]
    consumed = {p for m in members for p in program.tensors[m].parents()}
    ring_names = ext_inputs + [m for m in members if m in consumed]
    warm = max((spans[n][0][1] - spans[n][0][0] for n in ring_names), default=0)
    cells = math.prod(grid_shape)
    writes = cells * sum(_elem_bytes(program, o) for o in outputs)
    useful = cells * max(len(outputs), 1)

    best = None
    for tl, chunk, grid in _shapes(rank, grid_shape, tile, bz):
        rings, off = [], 0
        for n in ring_names:
            r = _ring(rank, n, spans[n], _elem_bytes(program, n), tl, off)
            rings.append(r)
            off += -(-r.nbytes // 16) * 16
        if off > min(smem_budget, SMEM_PER_BLOCK_MAX):
            continue
        if grid[1] > MAX_GRID_YZ or grid[2] > MAX_GRID_YZ:
            continue
        # tile extent per dim: the marched axis in chunks, the others in tiles
        extents = (chunk,) + tuple(tl) if rank == 3 else (chunk, tl[1])
        reads = 0
        for n in ext_inputs:
            c = _elem_bytes(program, n)
            for d, (lo, hi) in enumerate(spans[n]):
                c *= _covered(grid_shape[d], extents[d], lo, hi)
            reads += c
        ctas = math.prod(grid)
        # too few CTAs to fill the card counts first, then traffic;
        # equal traffic prefers the larger tile and chunk
        key = (ctas < 2 * NUM_SMS, (reads + writes) / useful,
               -tl[0] * tl[1], -chunk)
        if best is None or key < best[0]:
            best = (key, GroupPlan(
                stages=members, external_inputs=ext_inputs,
                outputs=outputs, spans=spans,
                params=_group_params(program, members),
                tile=tl, bz=chunk, grid=grid, rings=rings, warm=warm,
                smem_bytes=off, hbm_bytes_per_call=reads + writes,
                useful_cells_per_call=useful, kernel=KERNELS[rank]))
    return None if best is None else best[1]


def plan(program: StencilProgram, grid_shape: tuple[int, ...], *,
         smem_budget: int = SMEM_BUDGET, sweeps: int | None = None,
         iterate: int | None = None, tile: tuple[int, int] | None = None,
         bz: int | None = None) -> Plan:
    """Plan `program` on a full grid of `grid_shape` for the CUDA path.

    Fusion policy (as `soda_tpu`'s planner): all stages in one kernel when
    its rings fit the shared-memory budget; otherwise the stage DAG is
    split greedily, in topological order, into kernels chained through
    device memory.  Each call runs one sweep: a requested `sweeps` depth is
    recorded in the notes and planned as 1, which divides every `iterate`.
    `tile` and `bz` pin the CTA shape instead of searching."""
    if program.rank == 1:
        raise NotImplementedError(
            f"program {program.name!r} has rank 1: {RANK1_ROADMAP}")
    if len(grid_shape) != program.rank:
        raise ValueError(f"grid rank {len(grid_shape)} != program rank {program.rank}")
    it = max(program.iterate if iterate is None else iterate, 1)
    notes = []
    if sweeps is not None and sweeps != 1:
        notes.append(
            f"requested sweeps {sweeps} planned as 1: the line-buffer kernel "
            f"runs one sweep per call (fused sweeps wait for kernel 3)")
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
                    f"{smem_budget} on grid {tuple(grid_shape)}")
            groups.append(cur_plan)
            cur = [s]
            cur_plan = _plan_group(program, cur, grid_shape, smem_budget, tile, bz)
            if cur_plan is None:
                raise ValueError(
                    f"stage {s!r} alone does not fit the shared-memory budget "
                    f"{smem_budget} on grid {tuple(grid_shape)}")
        groups.append(cur_plan)
        notes.append(f"shared-memory pressure: split {len(stages)} stages "
                     f"into {len(groups)} chained kernels")
    notes.append(f"iterate={it} executed as {it} chained call(s) of one sweep")
    ideal = float(sum(_elem_bytes(program, n) for n in program.input_names)
                  + sum(_elem_bytes(program, n) for n in program.output_names))
    return Plan(program.name, program.rank, groups, tuple(grid_shape), notes,
                ideal_bytes_per_cell=ideal, sweeps_total=it)
