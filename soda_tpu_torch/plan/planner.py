"""Shared-memory planner for the Hopper kernels.

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
  marches z one plane a step; a ring slot is a plane of the tile and its
  y/x halo.  `tile` is (TY, TX) and `bz` is BZ;
- rank 2, kernel 2 (`csrc/linebuffer2d.cuh`): a CTA owns a strip of TX
  columns of the contiguous last axis and a chunk of BY rows, and
  marches the rows RB at a time; a ring slot is a row.  `tile` is (RB,
  TX) and `bz` is BY.

Both marches copy the input planes or rows of step s + 1 while step s
computes (RB = 1 plane a step for rank 3).  With `sync` "skew" a stage
at level L (1 + the deepest level it reads in the group; inputs are
level 0) computes the planes or rows of step s - (L - 1), so no stage
reads a slot written in the same step and a step needs one wait; with
"barrier" every stage is at level 1 and a barrier follows each stage.
A ring holds a power of two of at least lag + (w + L_c) * RB slots for
each consumer c, where w is 1 for an input (copied a step ahead) and 1 -
L for a stage: the skew deepens the rings of a deep cascade, the
barriers leave room for wider tiles, and the planner tries both.  On the
H100 a barrier per stage cost less than the narrower tile the skew
forced at nf 4 and 8 on 8192^2 and 16384^2 grids; at an equal tile the
skew ran blur 16384^2 2.5% faster (0.4169 against 0.4275 ms) and blur
2048 x 4096 no slower (PERF.md); rank 3 takes the skew wherever it fits
the same tile (PERF.md).  `_plan_group(..., sync=)` pins one order for
tests and scripts.  Each ring row is TX + x halo wide, an input's row
widened to whole 16-byte chunks from an aligned first column (`col0`)
when the grid's width allows 16-byte copies (`load` "vector", else
"scalar").

Kernel 1 on a "vector" grid is fed by TMA (`GroupPlan.feed`): its input
planes are copied `ahead` steps ahead (w = ahead above), the deepest up
to TMA_AHEAD_MAX that keeps the CTAs an SM of one step ahead, into rings
of their own depth whose slots are 128-byte aligned, each with an 8-byte
mbarrier; one instruction copies a plane whatever its width, so the
planner also tries the tiles of TMA_TILE_CANDIDATES, 128 columns wide.

A ring's lag is how far its leading plane (its span's hi along the
marched axis) runs ahead of the lowest plane a consumer in the group
reads at the same step: c's span hi + c's lowest offset on it.

Fused sweeps (TPU kernel 3, `backend/sweeps.py`): an `iterate` program
with fused depth nf is planned as the group of `unroll_iterate(program,
nf)`, a cascade of nf sweep copies in which copy k reads copy k-1 through
a ring, so that every sweep between the first read and the last write
stays in shared memory.  nf divides the executed `iterate`; with
`sweeps=None` it is the divisor up to `AUTO_SWEEPS_MAX[rank]` with the
least modeled time per sweep (`GroupPlan.modeled_seconds`) among the
cascades that fit the budget, preferring those that fill the card.  A
fused group holds the whole sweep chain; when no depth above 1 fits, the
program's feedback types differ, or its stages already carry the copies'
names (a program unrolled before), each call runs one sweep and the
stage DAG may split into chained groups as for any program.

A rank-2 cascade of at least `COLUMN_MEMBERS_MIN` members runs the column
march (`backend/columns2d.py`, `GroupPlan.march` "columns") wherever its
register window fits, else the row-march's rings ("rings"; `march=` pins
either, for checks).  A thread owns one column of the strip for
the whole chunk; member m computes the rows s * RB + lead_m .. + RB - 1
at step s (`column_leads`), the highest that leaves every tap in time: an
in-column tap is the thread's own value, computed earlier in the step
and carried in registers (`column_windows`: the rows each tensor carries
to the next step), an off-column tap comes through the member's exchange
buffer in shared memory, written a step before at the latest
(`column_slots`: slots of RB rows used in turn), an input's rows through
its ring, copied a step ahead as in the row-march.  One barrier ends a
step.  The window fits where the registers a thread needs
(`COLUMN_REG_BASE`, the carried rows and three rows of values a row of
the step, in 32-bit words) stay within `COLUMN_REGS_MAX`.

A rank-3 group with a stage at level 2 or deeper runs the column z-march
(`backend/columns3d.py`, `GroupPlan.march` "columns3d") wherever its
registers fit, else the rings of the z-march above ("rings3d", the march
of every single-stage group; `march=` pins either, for checks).  A CTA
owns a tile and a chunk as in the rings, and each of its
threads fixed (y, x) columns for the whole chunk: tile
columns dealt in turn, then the halo columns that some member's span
adds around the tile.  Member m computes the plane s + lead_m at step s
(`zcolumn_leads`): a tap at the thread's own column (dy = dx = 0) reads
the thread's own value, computed earlier in the step or carried in
registers from an earlier one (`zcolumn_windows`), an in-plane tap the
member's exchange planes in shared memory, written a step before at the
latest (`zcolumn_slots`), and an input's taps its ring (the TMA feed or
the scalar path as above; the input's plane at the thread's column is
read once, at the step that leads it, and carried).  A member read only
at its own column never leaves the registers (denoise3d's grad), and one
barrier ends a step.  The registers fit where a thread's estimate
(`COLUMN_REG_BASE`, its columns' positions, the carried planes and a
step's values, in 32-bit words) stays within `COLUMN_REGS_MAX`; a tile
whose halo columns pass `ZCOLUMN_HALO_MAX` of its own is not taken (a
deep cascade's: heat3d x 4 runs the rings).

The windows kernel (TPU kernel 4, `backend/windows.py`): a CTA owns one
block of the grid (BX cells, BY x BX or BZ x BY x BX; the last axis is
tiled too) and marches nothing.  Each external input whose (block + span)
window fits the budget is loaded into shared memory whole; the others are
read tap by tap from device memory.  Every stage another stage of the
group reads is computed over its exact extent (block + span) into shared
memory; the other outputs over the block, straight to device memory.  It
plans rank 1 (no march), groups pinned with `block=`, and any stage whose
line-buffer rings fit no tile of the budget: such a stage gets a windows
group of its own where the greedy split would otherwise fail.  A stage
alone always has a windows plan (its inputs read directly need no shared
memory), unless the grid exceeds the launch limits.

Shared memory per CTA is at most 227 KB on the H100; the planner keeps
under `smem_budget` so that several CTAs share an SM, and prefers plans
with at least two CTAs per SM.  A rank-2 plan also counts waves: the
CTAs one SM runs at once (`ctas_per_sm`, from shared memory, threads and
64 registers a thread) make `waves` = CTAs / (that x 132 SMs), and its
modeled time is multiplied by ceil(waves) / waves, the share of the last
wave's slots left idle; beside the power-of-two chunks it tries the
chunks that fill whole waves.

`hbm_bytes_per_call` counts every byte the kernel moves: each input cell
a CTA loads, with its tile halo across the marched axis (re-read by the
neighbouring tiles; an input's ring row widened to whole 16-byte chunks
counts every column it copies) and the warm-up of each chunk along it, clipped to
the grid (the windows kernel: each block's window, whether loaded whole
or read tap by tap); plus one write per output cell.  `cell_ops_per_call`
counts the operations the kernel computes: every stage over its whole
ring width and its chunk's warm-up (the cascade's trapezoid; the windows
kernel: its exact extent), clipped to the grid, times its f32-equivalent
operations per cell (`utils/opcount.py::typed_ops`).
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
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
# the TMA-fed z-march's tiles besides: one copy a plane whatever its width,
# and 128 columns read fewer halo sectors a cell (jacobi3d on the H100: (32,
# 128) 0.4278 ms at 512^3 and 6.938 on a 1026 x 1026 x 2048 shard, against
# 0.4380 and 7.571 at (32, 64); PERF.md)
TMA_TILE_CANDIDATES = ((32, 128), (16, 128)) + TILE_CANDIDATES
BZ_CANDIDATES = (256, 128, 64, 32, 16, 8)
# (RB, TX): a step's RB rows are one column run a thread where the taps fit
# its registers, and longer runs load fewer taps a cell (blur 16384^2:
# RB 16 0.6056 ms, RB 8 0.6486, RB 4 0.7932 on the H100, PERF.md)
ROW_TILE_CANDIDATES = ((16, 256), (16, 128), (8, 256), (4, 256), (8, 128),
                       (4, 128), (2, 128), (1, 128), (1, 64), (1, 32))
BY_CANDIDATES = (2048, 1024, 512, 256, 128, 64, 32, 16, 8)
# chunks longer than 64 planes / 512 rows only where the warm-up asks for
# them (a fused cascade): at most one warm-up per CHUNK_PER_WARM planes
CHUNK_BASE_MAX = {3: 64, 2: 512}
CHUNK_PER_WARM = 16
# the row-march's modeled time counts bytes and operations, not the
# instructions that bound it on the card, so it is no finer than this:
# among the plans within it of the least, the planner prefers runs of at
# least ROW_RUN_MIN rows (fewer tap loads a cell), then SMs that hold
# ROW_WARPS_MIN warps, then the larger tile and chunk (on the H100 the
# cascades ran fastest at 18-27 warps an SM and up to 31% slower at 10-15,
# scripts/torch_row_shapes.py, PERF.md)
MODEL_SLACK = 0.10
ROW_RUN_MIN = 4
ROW_WARPS_MIN = 16
# the row-march's threads per CTA: a multiple of its widest stage row of
# at least this many, so that a step's runs of a stage take one pass
ROW_THREADS_MIN = 128
# the deepest depth `sweeps=None` picks, per rank: deeper cascades ran
# slower on the H100 than the model predicts (PERF.md, the depth sweeps:
# rank 2's fastest depths were 8 for jacobi2d and 5 for jacobi2d_i64, and
# nf 10 and 20 ran slower); a rank without an entry (rank 1: no march)
# runs one sweep per call
AUTO_SWEEPS_MAX = {2: 8, 3: 2}
# kernel 1's TMA feed: at most this many steps of input planes in flight
# (the planner takes the deepest that keeps the plan's CTAs an SM); a TMA
# box is at most 256 cells along each axis; a slot is 128-byte aligned
TMA_AHEAD_MAX = 4
TMA_BOX_MAX = 256
TMA_ALIGN = 128
# the column march (rank-2 cascades): its tiles, RB rows a step and TX
# columns a strip, TX a power of two or the widest that leaves the group's
# widest member whole warps of COLUMN_THREADS; among the plans within
# MODEL_SLACK of the least modeled time it prefers RB = COLUMN_RB_BEST,
# then lanes that own a column of the widest member (at least
# COLUMN_LANES_MIN of the CTA's), then SMs of ROW_WARPS_MIN warps, then the
# larger tile and chunk (jacobi2d 16384^2 x 8 on the H100: (4, 240) 1.52
# ms, (4, 112) 1.56, (2, 240) 1.59, (4, 256) 1.75, (8, 112) 1.81; PERF.md)
COLUMN_RB = (8, 4, 2, 1)
COLUMN_RB_BEST = 4
COLUMN_TX = (256, 128, 64, 32)
COLUMN_THREADS = (256, 128, 64)
COLUMN_LANES_MIN = 0.95
# its registers: a thread's fixed share (grid bounds, pointers, the step)
# and the most a thread may take before a cascade runs the rings instead
COLUMN_REG_BASE = 32
COLUMN_REGS_MAX = 96
# a cascade of fewer members saves too few barriers a step to pay for the
# column march's drain: jacobi2d x 2 ran 4.5% (2048^2) and 9.9% (16384^2)
# slower in it than in the rings on the H100 (PERF.md); below it, the rings
COLUMN_MEMBERS_MIN = 3
# the column z-march (rank-3 groups with a stage at level 2 or deeper):
# NTHREADS threads a CTA, each owning TY * TX / NTHREADS tile columns, its
# registers counted as the column march's (COLUMN_REG_BASE, at most
# COLUMN_REGS_MAX).  Among its plans of at least ZCOLUMN_CTAS_MIN CTAs an
# SM it takes the least modeled time (on the H100, denoise3d 512^3 ran
# 1.027 ms at (16, 32), 4 CTAs an SM, and 1.056 at (16, 64), 2; heat3d x 2
# 0.512 ms a call at (16, 64), 3 CTAs, and 0.619 at (16, 32), 4; CTAs of
# 512 or 1024 threads owning as many columns a thread were no faster;
# PERF.md), and no tile whose halo columns pass ZCOLUMN_HALO_MAX of its
# own: a thread's halo columns lengthen the step every thread waits for at
# its barrier (heat3d x 4, its halo 0.63 of the tile at (16, 32) and more
# at every other tile whose registers fit, ran 0.41-0.50 ms a sweep against
# the rings' 0.367; denoise3d at (8, 32), 0.33, 1.35 ms against 1.03 at
# (16, 32), 0.20).  No benchmark cell runs a rank-3 cascade yet, so only
# the kernel-alone times hold the halo rule (ROADMAP.md)
ZCOLUMN_CTAS_MIN = 3
ZCOLUMN_HALO_MAX = 0.25

KERNELS = {3: "linebuffer3d", 2: "linebuffer2d"}
# windows kernel blocks per rank, in cells per axis (the last axis last);
# the deep rank-3 blocks whose (y, x) plane is one cell per thread read
# an input tap by tap 1.3x faster than (8, 8, 64) at the same registers
# (NVIDIA H100 80GB HBM3 at 700 W, PERF.md): a CTA's threads walk the
# block plane by plane, so the planes an input's taps reach stay in L1
# from one plane to the next
WINDOW_BLOCKS = {
    1: ((4096,), (2048,), (1024,), (512,), (256,), (128,), (32,)),
    2: ((16, 128), (8, 128), (16, 64), (8, 64), (4, 64), (8, 32), (4, 32),
        (2, 32), (1, 32)),
    3: ((32, 8, 32), (16, 8, 32), (8, 8, 64), (4, 8, 64), (4, 4, 64),
        (8, 8, 32), (4, 8, 32), (2, 8, 32), (2, 4, 32), (1, 4, 32), (1, 1, 32)),
}


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
    cols: int               # TX + x halo (an input's: whole 16-byte chunks when copied so)
    offset: int             # byte offset in the CTA's shared memory
    col0: int = 0           # its first column relative to the tile or strip
    pitch: int = 0          # elements from a slot to the next (0: rows x cols)
    bar: int = -1           # byte offset of its slots' mbarriers (a TMA-fed ring)

    @property
    def slot(self) -> int:
        return self.pitch or self.rows * self.cols

    @property
    def nbytes(self) -> int:
        return self.depth * self.slot * self.elem_bytes


@dataclasses.dataclass(frozen=True)
class Window:
    """A tensor held whole in shared memory by the windows kernel: the
    block plus the tensor's span, row-major (an external input's window,
    or a stage computed over its exact extent)."""

    name: str
    span: Span
    elem_bytes: int
    extent: tuple[int, ...]  # block + span width, per dim
    offset: int              # byte offset in the CTA's shared memory

    @property
    def nbytes(self) -> int:
        return math.prod(self.extent) * self.elem_bytes


@dataclasses.dataclass
class GroupPlan:
    """One fused kernel: a set of stages executed in one launch."""

    stages: list[str]                    # topo order within the group
    external_inputs: list[str]           # tensors read from outside the group
    outputs: list[str]                   # tensors written to device memory
    spans: dict[str, Span]               # extent of each tensor rel. to the output cell
    params: list[str]                    # params the group's stages read
    tile: tuple[int, ...]                # (TY, TX) rank 3; (RB, TX) rank 2; () windows
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
    # the windows kernel: its block, the tensors it holds in shared memory
    # (windowed inputs, then the stages other stages read) and the inputs
    # it reads tap by tap from device memory
    block: tuple[int, ...] = ()
    windows: list[Window] = dataclasses.field(default_factory=list)
    direct: list[str] = dataclasses.field(default_factory=list)
    # the marches (ranks 2 and 3): threads per CTA, how input planes or
    # rows are copied ("vector": rows of whole 16-byte chunks, by TMA in
    # the z-march and 16-byte cp.async in the row-march; "scalar": element
    # loads through registers), how the stages of a step are ordered
    # ("skew": each at its level, lagging level - 1 steps, one wait a step;
    # "barrier": all at level 1, a barrier after each stage), each
    # member's level, CTAs per SM for the row-march's wave count (0: not
    # modeled, as for rank 3), and the steps of input planes the z-march's
    # TMA feed keeps in flight (0: not TMA-fed)
    threads: int = NTHREADS
    load: str = ""
    sync: str = ""
    levels: dict[str, int] = dataclasses.field(default_factory=dict)
    slots_per_sm: int = 0
    ahead: int = 0
    # the march: rank 2 "rings" (the row-march) or "columns" (the column
    # march of a cascade), rank 3 "rings3d" (the z-march's rings) or
    # "columns3d" (the column z-march); the column marches' leads (each
    # member's first row, or its plane, at step 0) and the registers a
    # thread may take (the CTAs an SM)
    march: str = ""
    leads: dict[str, int] = dataclasses.field(default_factory=dict)
    regs: int = 64

    @property
    def feed(self) -> str:
        """How the z-march's input rings are fed: "tma" (one copy a plane
        by the Tensor Memory Accelerator, `ahead` steps ahead, into
        mbarrier-guarded slots) or "scalar" (element loads through
        registers, a step ahead)."""
        return "tma" if self.ahead else "scalar"

    @property
    def fed(self) -> int:
        """The z-march's input rings fed by TMA (those with a pitch)."""
        return sum(1 for r in self.rings if r.pitch)

    def tma_copies(self, shape: tuple[int, ...]) -> tuple[int, int]:
        """The plane copies the z-march's TMA feed makes in one launch over
        a grid of `shape`, and the bytes they move: in each CTA, each fed
        ring copies its chunk's planes and its span's along the marched axis,
        a whole box each (zeros outside the grid included).  (0, 0) without
        the TMA feed."""
        if not self.ahead:
            return 0, 0
        d0, d1, d2 = shape
        columns = -(-d1 // self.tile[0]) * -(-d2 // self.tile[1])
        chunks = -(-d0 // self.bz)
        copies = nbytes = 0
        for r in self.rings:
            if r.pitch:
                (zlo, zhi) = r.span[0]
                n = columns * (d0 + chunks * (zhi - zlo))
                copies += n
                nbytes += n * r.rows * r.cols * r.elem_bytes
        return copies, nbytes

    @property
    def ctas_per_sm(self) -> int:
        """CTAs one SM runs at once (`ctas_per_sm`)."""
        return ctas_per_sm(self.smem_bytes, self.threads, self.regs)

    @property
    def warps_per_sm(self) -> int:
        """The warps an SM runs at once (0: not modeled)."""
        return self.slots_per_sm * -(-self.threads // 32)

    @property
    def waves(self) -> float:
        """CTAs over the CTAs the card runs at once (0: not modeled)."""
        if not self.slots_per_sm:
            return 0.0
        return math.prod(self.grid) / (self.slots_per_sm * NUM_SMS)

    @property
    def modeled_seconds(self) -> float:
        """Modeled time of one call on the H100: the larger of its planned
        bytes over 3.35 TB/s and its computed operations over 67 TFLOP/s;
        for the row-march, times ceil(waves) / waves (the last wave's idle
        slots)."""
        t = max(self.hbm_bytes_per_call / (H100_SXM_PEAK_GBPS * 1e9),
                self.cell_ops_per_call / (H100_SXM_PEAK_TFLOPS * 1e12))
        w = self.waves
        return t * math.ceil(w) / w if w else t

    def describe(self) -> str:
        traffic = self.hbm_bytes_per_call / max(self.useful_cells_per_call, 1)
        if self.kernel == "windows":
            shape = (f"block={self.block}, windowed="
                     f"{[w.name for w in self.windows if w.name in self.external_inputs]}, "
                     f"direct={self.direct}")
        elif self.kernel == "linebuffer3d":
            feed = f"feed=tma, ahead={self.ahead}" if self.ahead else "feed=scalar"
            shape = (f"tile={self.tile}, bz={self.bz}, march={self.march}, {feed}, "
                     f"load={self.load}, sync={self.sync}, threads={self.threads}, "
                     f"ctas/SM={self.ctas_per_sm}")
        else:
            shape = (f"tile={self.tile}, by={self.bz}, march={self.march}, "
                     f"load={self.load}, sync={self.sync}, threads={self.threads}, "
                     f"ctas/SM={self.slots_per_sm}, waves={self.waves:.2f}")
        return (
            f"group(stages={self.stages}, {self.kernel}, sweeps={self.sweeps}, "
            f"{shape}, grid={self.grid}, smem={self.smem_bytes / 1024:.1f}KiB, "
            f"traffic={traffic:.3f}B/cell-update)")


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

    def to_json(self) -> dict:
        """The plan as JSON-ready data (`sodac --dump-plan`): the keys of
        `soda_tpu/plan/planner.py::Plan.to_json` where they mean the same
        thing, and the CUDA kernels' own (`kernel`, the CTA shape, rings,
        windows, threads, load path, step order, levels, CTAs an SM,
        waves, modeled seconds) in place of the TPU's."""
        def group(g: GroupPlan) -> dict:
            return {
                "stages": g.stages,
                "kernel": g.kernel,
                "external_inputs": g.external_inputs,
                "outputs": g.outputs,
                "sweeps": g.sweeps,
                "grid": list(g.grid),
                "hbm_bytes_per_call": g.hbm_bytes_per_call,
                "useful_cells_per_call": g.useful_cells_per_call,
                "bytes_per_cell_update": (g.hbm_bytes_per_call
                                          / max(g.useful_cells_per_call, 1)),
                "tile": list(g.tile),
                "bz": g.bz,
                "rings": [dataclasses.asdict(r) for r in g.rings],
                "smem_bytes": g.smem_bytes,
                "threads": g.threads,
                "load": g.load,
                "feed": g.feed if g.kernel == "linebuffer3d" else "",
                "ahead": g.ahead,
                "sync": g.sync,
                "levels": g.levels,
                "march": g.march,
                "leads": g.leads,
                "regs": g.regs,
                "slots_per_sm": g.slots_per_sm,
                "waves": g.waves,
                "block": list(g.block),
                "windows": [dataclasses.asdict(w) for w in g.windows],
                "direct": g.direct,
                "modeled_seconds": g.modeled_seconds,
            }

        return {
            "program": self.program_name,
            "grid_shape": list(self.grid_shape),
            "groups": [group(g) for g in self.groups],
            "notes": self.notes,
            "ideal_bytes_per_cell": self.ideal_bytes_per_cell,
            "ops_per_cell": self.ops_per_cell,
            "sweeps_total": self.sweeps_total,
        }


class CascadeNameError(ValueError):
    """A sweep copy's name (`<stage>__it<k>`) is already a tensor of the
    program, as in a program unrolled before (`sodac --unroll-iterate`)."""


def cascade(program: StencilProgram, nf: int) -> StencilProgram:
    """The program a group of `nf` fused sweeps runs: `nf` chained sweep
    copies (`unroll_iterate`), whatever the program's own `iterate`."""
    if nf <= 1:
        return program
    taken = [f"{s}__it{k}" for s in program.stage_order() for k in range(nf - 1)
             if f"{s}__it{k}" in program.tensors]
    if taken:
        raise CascadeNameError(f"program {program.name!r}: sweep copies would "
                               f"reuse the names {taken}")
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
    [start + lo, start + tile - 1 + hi], clipped to [0, n): the tiles
    k_lo..k_hi load tile + hi - lo cells each, the few at the edges are
    clipped one by one (a 2^28-cell axis has millions of tiles)."""
    count = -(-n // tile)

    def one(k: int) -> int:
        a = max(k * tile + lo, 0)
        b = min(k * tile + tile - 1 + hi, n - 1)
        return max(b - a + 1, 0)

    k_lo = min(-(-max(-lo, 0) // tile), count)
    k_hi = min((n - tile - hi) // tile, count - 1)
    if k_hi < k_lo:
        return sum(one(k) for k in range(count))
    return ((k_hi - k_lo + 1) * (tile + hi - lo) + sum(one(k) for k in range(k_lo))
            + sum(one(k) for k in range(k_hi + 1, count)))


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def ctas_per_sm(smem_bytes: int, threads: int, regs: int = 64) -> int:
    """CTAs one SM runs at once: its shared memory (with the 1 KiB the
    runtime reserves a CTA), 2048 threads, and `regs` registers a thread
    (64 for the marches' rings; the kernels' `__launch_bounds__`,
    `linebuffer.min_blocks`)."""
    return max(1, min(SMEM_PER_SM // (smem_bytes + 1024), 2048 // threads,
                      65536 // (threads * regs), 32))


def _shapes3(grid_shape, tile, bz, warm: int, tiles=TILE_CANDIDATES):
    """(tile, chunk, CUDA grid) candidates of kernel 1 on one grid."""
    longest = max(CHUNK_BASE_MAX[3], CHUNK_PER_WARM * warm)
    Z, Y, X = grid_shape
    for ty, tx in [tile] if tile else tiles:
        for bz_ in [bz] if bz else [c for c in BZ_CANDIDATES if c <= longest]:
            yield (ty, tx), bz_, (-(-X // tx), -(-Y // ty), -(-Z // bz_))


def _row_chunks(grid_shape, rb: int, tx: int, bz, warm: int, slots: int) -> list[int]:
    """Chunk lengths BY (multiples of RB) to try for kernel 2's tile (RB,
    TX): the powers of two (rounded down to a multiple of RB), and the
    lengths whose CTAs fill 1 to 4 whole waves of `slots` CTAs an SM."""
    if bz:
        return [bz] if bz % rb == 0 else []
    H, W = grid_shape
    longest = max(CHUNK_BASE_MAX[2], CHUNK_PER_WARM * warm)
    out = {c // rb * rb for c in BY_CANDIDATES if c >= rb}
    strips = -(-W // tx)
    for k in (1, 2, 3, 4):
        chunks = max(1, k * slots * NUM_SMS // strips)
        out.add(rb * -(-H // (rb * chunks)))
    return sorted((c for c in out if BY_CANDIDATES[-1] <= c <= longest), reverse=True)


def _consumer_lags(program: StencilProgram, members: list[str],
                   spans: dict[str, Span]) -> list[tuple[str, str, int]]:
    """(tensor q, consumer c, lag) for every tensor a member c reads: q's
    span hi along the marched axis minus the lowest plane (relative to the
    step) c reads of it."""
    out = []
    for c in members:
        hi_c = spans[c][0][1]
        for q, offs in program.tensors[c].window().items():
            out.append((q, c, spans[q][0][1] - (hi_c + min(o[0] for o in offs))))
    return out


def _levels(program: StencilProgram, members: list[str]) -> dict[str, int]:
    """Each member's level (topological order): 1 + the deepest level of
    the members it reads; the group's inputs are level 0."""
    lv: dict[str, int] = {}
    for m in members:
        lv[m] = 1 + max((lv[q] for q in program.tensors[m].parents() if q in lv),
                        default=0)
    return lv


def _ring_layout(program: StencilProgram, ring_names: list[str],
                 ext_inputs: list[str], spans: dict[str, Span],
                 pairs: list[tuple[str, str, int]], lv: dict[str, int], step: int,
                 rows: int | None, tx: int, vector: bool,
                 pow2: bool = True, ahead: int = 0) -> tuple[list[Ring], int]:
    """The rings of one march (`step` slots a step: RB rows, or one
    plane) and the shared memory they take: each of at least lag + (w +
    L_c) * step slots for each consumer c (w 1 for an input, copied a step
    ahead; 1 - L for a stage at level L), rounded up to a power of two
    where `pow2`, of `rows` tile rows plus the ring's y halo (rank 3;
    None: one row), and TX plus its x halo in columns, an input's widened
    to whole 16-byte chunks from an aligned first column where `vector`.

    `ahead` > 0: the z-march's TMA feed.  An input ring is copied `ahead`
    steps ahead (w = ahead) and keeps its own depth (a plane's slot is a
    remainder); its row is the box's, whole 16-byte chunks from an
    aligned first column (the TMA faults on a box whose first column is
    not 16-byte aligned: an illegal instruction on the H100), its slots
    are 128-byte aligned, and after the rings come its slots' 8-byte
    mbarriers."""
    out, off = [], 0
    for n in ring_names:
        elem = _elem_bytes(program, n)
        tma = ahead > 0 and n in ext_inputs
        w = (ahead if tma else 1) if n in ext_inputs else 1 - lv[n]
        depth = max(lag + (w + lv[c]) * step for q, c, lag in pairs if q == n)
        depth = _pow2(depth) if pow2 and not tma else depth
        xlo, xhi = spans[n][-1]
        v = 16 // elem if (vector or tma) and n in ext_inputs else 1
        col0 = xlo // v * v
        cols = -(-(tx + xhi - col0) // v) * v
        height = 1 if rows is None else rows + spans[n][1][1] - spans[n][1][0]
        pitch = 0
        if tma:
            pitch = -(-height * cols * elem // TMA_ALIGN) * TMA_ALIGN // elem
            off = -(-off // TMA_ALIGN) * TMA_ALIGN
        out.append(Ring(n, spans[n], elem, depth, height, cols, off, col0, pitch))
        off += -(-out[-1].nbytes // 16) * 16
    for i, r in enumerate(out):
        if r.pitch:
            out[i] = dataclasses.replace(r, bar=off)
            off += 8 * r.depth
    return out, off


def column_leads(program: StencilProgram, members: list[str],
                 spans: dict[str, Span], rb: int) -> dict[str, int]:
    """The column march's lead of each member (topological order): at step
    s it computes the chunk-local rows s * rb + lead .. + rb - 1.  The
    highest lead that leaves every tap in time: an input's rows s * rb +
    hi .. are in its ring at step s (hi its span's, copied a step ahead),
    a member's in-column taps (dx 0) are the thread's own values of the
    same step, its off-column taps those of the step before."""
    leads: dict[str, int] = {}
    for c in members:
        at = []
        for q, offs in program.tensors[c].window().items():
            for dy, dx in offs:
                at.append(leads[q] - dy - (rb if dx else 0) if q in leads
                          else spans[q][0][1] - dy)
        leads[c] = min(at, default=spans[c][0][1])
    return leads


def column_windows(program: StencilProgram, members: list[str],
                   spans: dict[str, Span], leads: dict[str, int]) -> dict[str, int]:
    """Rows of each tensor tapped in-column that a thread carries from one
    step to the next: from the lowest row such a tap reads at a step up
    to the tensor's first row of the step (a member's lead, an input's
    span hi), below which the step's own rows come."""
    low: dict[str, int] = {}
    for c in members:
        for q, offs in program.tensors[c].window().items():
            for dy, dx in offs:
                if dx == 0:
                    low[q] = min(low.get(q, leads[c] + dy), leads[c] + dy)
    return {q: max(0, (leads[q] if q in leads else spans[q][0][1]) - lo)
            for q, lo in low.items()}


def column_slots(program: StencilProgram, members: list[str],
                 leads: dict[str, int], rb: int) -> dict[str, int]:
    """Slots of rb rows each member tapped off-column keeps in its exchange
    buffer: the step's own, which it writes, and those back to the lowest
    row a consumer reads of it."""
    slots: dict[str, int] = {}
    for c in members:
        for q, offs in program.tensors[c].window().items():
            for dy, dx in offs:
                if dx and q in leads:
                    need = 1 - (leads[c] + dy - leads[q]) // rb
                    slots[q] = max(slots.get(q, 1), need)
    return slots


def column_first_step(members: list[str], ext_inputs: list[str], spans: dict[str, Span],
                      leads: dict[str, int], rb: int) -> int:
    """The column march's first step of a chunk: the least at which every
    member's first row (its span lo) and every input's are reached."""
    return min([(spans[m][0][0] - leads[m]) // rb for m in members]
               + [(spans[q][0][0] - spans[q][0][1]) // rb for q in ext_inputs])


def _in_column(off: tuple[int, ...]) -> bool:
    """A rank-3 tap at the reader's own (y, x) column."""
    return not any(off[1:])


def zcolumn_leads(program: StencilProgram, members: list[str],
                  spans: dict[str, Span]) -> dict[str, int]:
    """The column z-march's lead of each member: at step s it computes the
    chunk-local plane s + lead.  First the highest lead that leaves every
    tap in time (topological order): an input's planes up to s + hi are
    in its ring at step s (hi its span's), a member's tap at the reader's
    own column is the thread's own value of the same step, an in-plane
    tap the exchange plane of the step before.  Then, in reverse, each
    member read by others only as high as its readers need, so that no
    value waits in the registers longer than it must."""
    leads: dict[str, int] = {}
    for c in members:
        at = []
        for q, offs in program.tensors[c].window().items():
            for off in offs:
                at.append(leads[q] - off[0] - (0 if _in_column(off) else 1)
                          if q in leads else spans[q][0][1] - off[0])
        leads[c] = min(at, default=spans[c][0][1])
    for q in reversed(members):
        need = [leads[c] + off[0] + (0 if _in_column(off) else 1)
                for c in members for off in program.tensors[c].window().get(q, [])]
        if need:
            leads[q] = min(leads[q], max(need))
    return leads


def zcolumn_windows(program: StencilProgram, readers: list[str],
                    spans: dict[str, Span], leads: dict[str, int]) -> dict[str, int]:
    """Planes of each tensor that `readers` tap at their own column which a
    thread carries from one step to the next: from the lowest such plane a
    step reads up to the tensor's plane of the step (a member's lead, an
    input's span hi; that one is the step's own value).  Every tensor so
    tapped has an entry, 0 where the step's own value is all it needs."""
    low: dict[str, int] = {}
    for c in readers:
        for q, offs in program.tensors[c].window().items():
            for off in offs:
                if _in_column(off):
                    low[q] = min(low.get(q, leads[c] + off[0]), leads[c] + off[0])
    return {q: (leads[q] if q in leads else spans[q][0][1]) - lo for q, lo in low.items()}


def zcolumn_slots(program: StencilProgram, members: list[str],
                  leads: dict[str, int]) -> dict[str, int]:
    """Exchange planes each member tapped in-plane keeps: the step's own,
    which it writes, and those back to the lowest plane a reader taps."""
    slots: dict[str, int] = {}
    for c in members:
        for q, offs in program.tensors[c].window().items():
            for off in offs:
                if q in leads and not _in_column(off):
                    slots[q] = max(slots.get(q, 1), 1 + leads[q] - leads[c] - off[0])
    return slots


def zcolumn_halo_members(members: list[str], spans: dict[str, Span]) -> list[str]:
    """The members whose span reaches past the tile in y or x: the only ones
    computed at the halo columns."""
    return [m for m in members if any(spans[m][1] + spans[m][2])]


def zcolumn_steps(members: list[str], ext_inputs: list[str], spans: dict[str, Span],
                  leads: dict[str, int]) -> tuple[int, int]:
    """The column z-march's first step of a chunk (the least at which every
    member's first plane and every input's is reached) and the planes its
    last step reaches past the chunk's last."""
    first = min([spans[m][0][0] - leads[m] for m in members]
                + [spans[q][0][0] - spans[q][0][1] for q in ext_inputs])
    return first, max(spans[m][0][1] - leads[m] for m in members)


def _zcolumn_layout(program: StencilProgram, members: list[str], ext_inputs: list[str],
                    spans: dict[str, Span], tile: tuple[int, int], ahead: int):
    """The column z-march's shared memory at `tile`: (rings, bytes, leads).
    An input's ring holds the planes from the lowest an in-plane tap reads
    at a step to the step's leading one, and those in flight (`ahead`
    steps of the TMA feed, rows of whole 16-byte chunks from an aligned
    first column, 128-byte-aligned slots and an mbarrier each; one step
    on the scalar path); a member's exchange buffer `zcolumn_slots`
    planes of its span around the tile."""
    ty, tx = tile
    leads = zcolumn_leads(program, members, spans)
    slots = zcolumn_slots(program, members, leads)
    out, off = [], 0
    for n in ext_inputs:
        elem = _elem_bytes(program, n)
        (_, zhi), (ylo, yhi), (xlo, xhi) = spans[n]
        low = min([zhi] + [leads[c] + o[0] for c in members
                           for o in program.tensors[c].window().get(n, [])
                           if not _in_column(o)])
        depth = max(ahead, 1) + zhi - low + 1
        v = 16 // elem if ahead else 1
        col0 = xlo // v * v
        cols = -(-(tx + xhi - col0) // v) * v
        rows = ty + yhi - ylo
        pitch = 0
        if ahead:
            pitch = -(-rows * cols * elem // TMA_ALIGN) * TMA_ALIGN // elem
            off = -(-off // TMA_ALIGN) * TMA_ALIGN
        out.append(Ring(n, spans[n], elem, depth, rows, cols, off, col0, pitch))
        off += -(-out[-1].nbytes // 16) * 16
    for m in members:
        if m in slots:
            _, (ylo, yhi), (xlo, xhi) = spans[m]
            out.append(Ring(m, spans[m], _elem_bytes(program, m), slots[m], ty + yhi - ylo,
                            tx + xhi - xlo, off, xlo))
            off += -(-out[-1].nbytes // 16) * 16
    for i, r in enumerate(out):
        if r.pitch:
            out[i] = dataclasses.replace(r, bar=off)
            off += 8 * r.depth
    return out, off, leads


def zcolumn_halo(tile: tuple[int, int], members: list[str], spans: dict[str, Span]):
    """The halo around the tile that the column z-march deals to its
    threads: (y lo, y hi, x lo, x hi) of the rectangle every member's span
    makes around the tile, and its columns outside the tile."""
    ty, tx = tile
    ylo = min(spans[m][1][0] for m in members)
    yhi = max(spans[m][1][1] for m in members)
    xlo = min(spans[m][2][0] for m in members)
    xhi = max(spans[m][2][1] for m in members)
    return (ylo, yhi, xlo, xhi), (ty + yhi - ylo) * (tx + xhi - xlo) - ty * tx


def _zcolumn_regs(program: StencilProgram, members: list[str], ext_inputs: list[str],
                  spans: dict[str, Span], leads: dict[str, int], tile: tuple[int, int],
                  rings: list[Ring], ahead: int) -> int:
    """A column z-march thread's registers (an estimate, in multiples of 8):
    COLUMN_REG_BASE, two a column for its position, and at each of its
    tile and halo columns the planes carried and the step's value of every
    tensor tapped there at the column; on the scalar path, the next plane's
    elements in flight."""
    kt = tile[0] * tile[1] // NTHREADS
    kh = -(-zcolumn_halo(tile, members, spans)[1] // NTHREADS)
    words = {n: -(-_elem_bytes(program, n) // 4) for n in spans}
    regs = COLUMN_REG_BASE + 2 * (kt + kh)
    for k, readers in ((kt, members), (kh, zcolumn_halo_members(members, spans))):
        carried = zcolumn_windows(program, readers, spans, leads)
        regs += k * sum((n + 1) * words[q] for q, n in carried.items())
    if not ahead:
        regs += sum(-(-r.rows * r.cols // NTHREADS) * words[r.name]
                    for r in rings if r.name in ext_inputs)
    return -(-regs // 8) * 8


def _column_lanes(g: GroupPlan) -> float:
    """The share of a column-march CTA's lanes that own a column of its
    widest member."""
    xs = [g.spans[m][1] for m in g.stages]
    return (g.tile[1] + max(x[1] for x in xs) - min(x[0] for x in xs)) / g.threads


def _column_layout(program: StencilProgram, members: list[str], ext_inputs: list[str],
                   spans: dict[str, Span], rb: int, tx: int, vector: bool):
    """The column march's shared memory at tile (rb, tx): (rings, bytes,
    leads, threads, registers a thread).  An input's ring holds the rows
    of the step before its leading ones that an off-column tap still
    reads, the step's own and the next step's, in flight (a power of
    two); a member's exchange buffer NSLOT slots of rb rows (the most any
    member needs), its row the member's columns.  Threads: one a column
    of the widest member, in whole warps."""
    leads = column_leads(program, members, spans, rb)
    carried = column_windows(program, members, spans, leads)
    slots = column_slots(program, members, leads, rb)
    nslot = max(slots.values(), default=1)
    out, off = [], 0
    for n in ext_inputs + [m for m in members if m in slots]:
        elem = _elem_bytes(program, n)
        (ylo, yhi), (xlo, xhi) = spans[n]
        if n in ext_inputs:
            low = [leads[c] + dy for c in members
                   for dy, dx in program.tensors[c].window().get(n, []) if dx]
            depth = _pow2(2 * rb + max(0, yhi - min(low, default=yhi)))
            v = 16 // elem if vector else 1
        else:
            depth, v = nslot * rb, 1
        col0 = xlo // v * v
        cols = -(-(tx + xhi - col0) // v) * v
        out.append(Ring(n, spans[n], elem, depth, 1, cols, off, col0))
        off += -(-out[-1].nbytes // 16) * 16
    xmin = min(spans[m][1][0] for m in members)
    xmax = max(tx + spans[m][1][1] for m in members)
    threads = -(-(xmax - xmin) // 32) * 32
    words = {n: -(-_elem_bytes(program, n) // 4) for n in spans}
    regs = (COLUMN_REG_BASE + sum(k * words[q] for q, k in carried.items())
            + 3 * rb * max(words[m] for m in members))
    return out, off, leads, threads, -(-regs // 8) * 8


def _plan_group(program: StencilProgram, members: list[str],
                grid_shape: tuple[int, ...], smem_budget: int,
                tile: tuple[int, int] | None = None,
                bz: int | None = None, sweeps: int = 1,
                sync: str | None = None, march: str | None = None) -> GroupPlan | None:
    """The line buffer's plan of `members`, or None when no tile fits the
    budget; `sync` ("skew" or "barrier") keeps one order of a step's
    stages of the rings (a group of one level has only "skew"); `march`
    keeps one march: "columns" or "rings" of a rank-2 cascade, which
    otherwise runs the column march where it has `COLUMN_MEMBERS_MIN`
    members and its window fits, and "columns3d" or "rings3d" of a
    rank-3 group, which otherwise runs the column z-march where a stage
    is at level 2 or deeper and its registers fit ("rings" and a pinned
    `sync` keep the rings of either rank)."""
    rank = program.rank
    ext_inputs, outputs = _group_io(program, members)
    spans = group_spans(program, members, outputs)
    # dead stages (no path to a group output) are never materialized
    members = [m for m in members if m in spans]
    ext_inputs = [i for i in ext_inputs if i in spans]
    consumed = {p for m in members for p in program.tensors[m].parents()}
    ring_names = ext_inputs + [m for m in members if m in consumed]
    pairs = _consumer_lags(program, members, spans)
    warm = max((spans[n][0][1] - spans[n][0][0] for n in ring_names), default=0)
    cells = math.prod(grid_shape)
    writes = cells * sum(_elem_bytes(program, o) for o in outputs)
    useful = cells * sweeps * max(len(outputs), 1)
    ops = {m: typed_ops(program, program.tensors[m].expr) for m in members}
    budget = min(smem_budget, SMEM_PER_BLOCK_MAX)
    common = dict(stages=members, external_inputs=ext_inputs, outputs=outputs,
                  spans=spans, params=_group_params(program, members), warm=warm,
                  useful_cells_per_call=useful, sweeps=sweeps, kernel=KERNELS[rank])

    def covered(n: str, extents, x_cols=None) -> int:
        """Cells of `n` the CTAs load or compute, over its span around
        each tile (`x_cols`: a ring's own columns (lo, hi) along x)."""
        lims = list(spans[n])
        if x_cols:
            lims[-1] = x_cols
        return math.prod(_covered(grid_shape[d], extents[d], lo, hi)
                         for d, (lo, hi) in enumerate(lims))

    def consider(best, gp: GroupPlan, area: int):
        # too few CTAs to fill the card counts first, then the modeled
        # time; equal time prefers the larger tile and chunk, then one wait
        # a step over a barrier per stage
        key = (math.prod(gp.grid) < 2 * NUM_SMS, gp.modeled_seconds, -area, -gp.bz,
               gp.sync != "skew")
        return (key, gp) if best is None or key < best[0] else best

    levels = _levels(program, members)
    # the outputs no stage reads are computed together, at the deepest of
    # their levels
    direct = [o for o in outputs if o not in ring_names]
    for o in direct:
        levels[o] = max(levels[d] for d in direct)
    vector = all(grid_shape[-1] % (16 // _elem_bytes(program, n)) == 0
                 for n in ext_inputs)
    load = "vector" if vector else "scalar"
    # "skew": one wait a step, each stage a step behind the stages it
    # reads; "barrier": every stage at level 1, a barrier after each
    # (shallower rings: room for wider tiles)
    modes = {"skew": levels}
    if max(levels.values()) > 1:
        modes["barrier"] = dict.fromkeys(levels, 1)
    if sync in modes:
        modes = {sync: modes[sync]}

    def row_plans(rb: int, tx: int, rings: list[Ring], off: int, nt: int, slots: int,
                  **kw) -> list[GroupPlan]:
        # a rank-2 march's plans at tile (rb, tx), one a chunk length
        out = []
        for chunk in _row_chunks(grid_shape, rb, tx, bz, warm, slots):
            grid = (-(-grid_shape[1] // tx), -(-grid_shape[0] // chunk), 1)
            if grid[1] > MAX_GRID_YZ:
                continue
            extents = (chunk, tx)
            reads = sum(r.elem_bytes * covered(
                r.name, extents, (r.col0, r.col0 + r.cols - tx))
                for r in rings if r.name in ext_inputs)
            cell_ops = sum(ops[m] * covered(m, extents) for m in members)
            out.append(GroupPlan(tile=(rb, tx), bz=chunk, grid=grid, rings=rings,
                                 smem_bytes=off, hbm_bytes_per_call=reads + writes,
                                 cell_ops_per_call=cell_ops, threads=nt, load=load,
                                 slots_per_sm=slots, **kw, **common))
        return out

    def pick(cands: list[GroupPlan], prefer) -> GroupPlan | None:
        # fill the card first; then, among the plans within MODEL_SLACK of
        # the least modeled time, the most preferred
        fill = [c for c in cands if math.prod(c.grid) >= 2 * NUM_SMS] or cands
        if not fill:
            return None
        least = min(c.modeled_seconds for c in fill)
        return max((c for c in fill if c.modeled_seconds <= least * (1 + MODEL_SLACK)),
                   key=lambda c: (*prefer(c), -c.modeled_seconds))

    if (rank == 2 and sweeps > 1 and sync is None and march != "rings"
            and (march == "columns" or len(members) >= COLUMN_MEMBERS_MIN)):
        halo = (max(spans[m][1][1] for m in members)
                - min(spans[m][1][0] for m in members))
        v = max((16 // _elem_bytes(program, n) for n in ext_inputs), default=1) if vector else 1
        txs = set(COLUMN_TX) | {(nt - halo) // v * v for nt in COLUMN_THREADS if nt - halo >= v}
        cols = []
        for rb, tx in [tile] if tile else [(rb, tx) for tx in sorted(txs, reverse=True)
                                           for rb in COLUMN_RB]:
            rings, off, leads, nt, regs = _column_layout(
                program, members, ext_inputs, spans, rb, tx, vector)
            if off <= budget and regs <= COLUMN_REGS_MAX and nt <= 1024:
                cols += row_plans(rb, tx, rings, off, nt, ctas_per_sm(off, nt, regs),
                                  levels=levels, sync="skew", march="columns",
                                  leads=leads, regs=regs)
        best = pick(cols, lambda c: (
            c.tile[0] == COLUMN_RB_BEST, _column_lanes(c) >= COLUMN_LANES_MIN,
            c.warps_per_sm >= ROW_WARPS_MIN, c.tile[0] * c.tile[1], c.bz))
        if best is not None:
            return best
    if march == "columns":
        return None
    if rank == 2:
        cands = []
        for (rb, tx), (order, lv) in itertools.product(
                [tile] if tile else ROW_TILE_CANDIDATES, modes.items()):
            rings, off = _ring_layout(program, ring_names, ext_inputs, spans, pairs,
                                      lv, rb, None, tx, vector)
            if off > budget:
                continue
            widest = max([r.cols for r in rings if r.name in members] + [tx])
            widest = -(-widest // 32) * 32
            nt = min(1024, widest * -(-ROW_THREADS_MIN // widest))
            cands += row_plans(rb, tx, rings, off, nt, ctas_per_sm(off, nt),
                               levels=lv, sync=order, march="rings")
        # those whose SMs hold ROW_WARPS_MIN warps (if any), the larger tile
        # (fewer steps, and waits, per row), the longer chunk, and one wait
        # a step over a barrier per stage (2.5% on blur 16384^2 at an equal
        # tile, PERF.md)
        return pick(cands, lambda c: (
            c.tile[0] >= ROW_RUN_MIN, c.warps_per_sm >= ROW_WARPS_MIN,
            c.tile[0] * c.tile[1], c.bz, c.sync == "skew"))

    if (sync is None and march not in ("rings", "rings3d")
            and (march == "columns3d" or max(levels.values()) >= 2)):
        nt = NTHREADS

        def zlayout(tl: tuple[int, int]):
            # (rings, shared memory, leads, registers, planes in flight) of
            # one tile, or None: the TMA feed `ahead` steps ahead, the
            # deepest (up to TMA_AHEAD_MAX) that keeps the CTAs an SM
            halo = zcolumn_halo(tl, members, spans)[1] / (tl[0] * tl[1])
            if tl[0] * tl[1] % nt or (march != "columns3d" and halo > ZCOLUMN_HALO_MAX):
                return None
            ahead = 1 if vector else 0
            rings, off, leads = _zcolumn_layout(program, members, ext_inputs, spans, tl,
                                                ahead)
            regs = _zcolumn_regs(program, members, ext_inputs, spans, leads, tl, rings, ahead)
            if (off > budget or regs > COLUMN_REGS_MAX
                    or any(max(r.rows, r.cols) > TMA_BOX_MAX for r in rings if r.pitch)):
                return None
            ctas = ctas_per_sm(off, nt, regs)
            for k in range(TMA_AHEAD_MAX, 1, -1) if vector else ():
                deeper, end, _ = _zcolumn_layout(program, members, ext_inputs, spans, tl, k)
                if end <= budget and ctas_per_sm(end, nt, regs) == ctas:
                    rings, off, ahead = deeper, end, k
                    break
            return rings, off, leads, regs, ahead

        zbest, zlayouts = None, {}
        for tl, chunk, grid in _shapes3(grid_shape, tile, bz, warm,
                                        TMA_TILE_CANDIDATES if vector else TILE_CANDIDATES):
            if tl not in zlayouts:
                zlayouts[tl] = zlayout(tl)
            if zlayouts[tl] is None or grid[1] > MAX_GRID_YZ or grid[2] > MAX_GRID_YZ:
                continue
            rings, off, leads, regs, ahead = zlayouts[tl]
            extents = (chunk,) + tuple(tl)
            reads = sum(r.elem_bytes * covered(r.name, extents, (r.col0, r.col0 + r.cols - tl[1]))
                        for r in rings if r.name in ext_inputs)
            gp = GroupPlan(tile=tl, bz=chunk, grid=grid, rings=rings, smem_bytes=off,
                           hbm_bytes_per_call=reads + writes,
                           cell_ops_per_call=sum(ops[m] * covered(m, extents) for m in members),
                           threads=nt, load=load, levels=levels, sync="skew",
                           ahead=ahead, march="columns3d", leads=leads, regs=regs, **common)
            # fill the card first, and where the grid does, with
            # ZCOLUMN_CTAS_MIN CTAs an SM; then the modeled time, the fewest
            # operations (the halo columns), the larger tile and chunk
            small = math.prod(grid) < 2 * NUM_SMS
            key = (small, not small and gp.ctas_per_sm < ZCOLUMN_CTAS_MIN,
                   gp.modeled_seconds, gp.cell_ops_per_call, -tl[0] * tl[1], -chunk)
            if zbest is None or key < zbest[0]:
                zbest = (key, gp)
        if zbest is not None or march == "columns3d":
            return None if zbest is None else zbest[1]

    def rings3(tl: tuple[int, int], lv: dict[str, int]):
        # (rings, shared memory, planes in flight) of one tile, or None:
        # power-of-two depths (a plane's slot is a mask) where they fit,
        # else the depths themselves (a 32-bit remainder by a constant,
        # once a step for each plane a stage taps); with the TMA feed
        # (`vector`), the input rings copied `ahead` steps ahead, the
        # deepest (up to TMA_AHEAD_MAX) that keeps the CTAs an SM of one
        # step ahead
        def layout(ahead: int, pow2: bool):
            return _ring_layout(program, ring_names, ext_inputs, spans, pairs, lv, 1,
                                tl[0], tl[1], False, pow2=pow2, ahead=ahead)

        first = 1 if vector else 0
        pow2 = True
        rings, off = layout(first, True)
        if off > budget:
            pow2 = False
            rings, off = layout(first, False)
        if off > budget or any(max(r.rows, r.cols) > TMA_BOX_MAX for r in rings if r.pitch):
            return None
        ahead = first
        for k in range(TMA_AHEAD_MAX, 1, -1) if vector else ():
            deeper, end = layout(k, pow2)
            if end <= budget and ctas_per_sm(end, NTHREADS) == ctas_per_sm(off, NTHREADS):
                rings, off, ahead = deeper, end, k
                break
        return rings, off, ahead

    best = None
    layouts = {}
    tiles = TMA_TILE_CANDIDATES if vector else TILE_CANDIDATES
    for (tl, chunk, grid), (order, lv) in itertools.product(
            _shapes3(grid_shape, tile, bz, warm, tiles), modes.items()):
        ty, tx = tl
        if (tl, order) not in layouts:
            layouts[tl, order] = rings3(tl, lv)
        if layouts[tl, order] is None:
            continue
        rings, off, ahead = layouts[tl, order]
        if grid[1] > MAX_GRID_YZ or grid[2] > MAX_GRID_YZ:
            continue
        # tile extent per dim: the marched axis in chunks, the others in tiles
        extents = (chunk,) + tuple(tl)
        reads = sum(r.elem_bytes * covered(r.name, extents, (r.col0, r.col0 + r.cols - tx))
                    for r in rings if r.name in ext_inputs)
        # every stage over its ring width and warm-up (an output no stage
        # reads has span 0: exactly the grid)
        cell_ops = sum(ops[m] * covered(m, extents) for m in members)
        gp = GroupPlan(tile=tl, bz=chunk, grid=grid, rings=rings, smem_bytes=off,
                       hbm_bytes_per_call=reads + writes,
                       cell_ops_per_call=cell_ops, load=load, levels=lv, sync=order,
                       ahead=ahead, march="rings3d", **common)
        best = consider(best, gp, ty * tx)
    return None if best is None else best[1]


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _plan_windows(program: StencilProgram, members: list[str],
                  grid_shape: tuple[int, ...], smem_budget: int,
                  block: tuple[int, ...] | None = None) -> GroupPlan | None:
    """The windows kernel's plan of `members` (one sweep), or None when the
    stages that other stages of the group read do not fit `smem_budget` in
    any block, or the CUDA grid exceeds the launch limits.  Those stages
    are held in shared memory first; then each external input, in order,
    whose window still fits; the rest are read tap by tap."""
    rank = program.rank
    ext_inputs, outputs = _group_io(program, members)
    spans = group_spans(program, members, outputs)
    members = [m for m in members if m in spans]
    ext_inputs = [i for i in ext_inputs if i in spans]
    consumed = {p for m in members for p in program.tensors[m].parents()}
    held = [m for m in members if m in consumed]
    cells = math.prod(grid_shape)
    writes = cells * sum(_elem_bytes(program, o) for o in outputs)
    ops = {m: typed_ops(program, program.tensors[m].expr) for m in members}
    budget = min(smem_budget, SMEM_PER_BLOCK_MAX)

    best = None
    for blk in [tuple(block)] if block else WINDOW_BLOCKS[rank]:
        per_dim = [-(-grid_shape[d] // blk[d]) for d in range(rank)]
        grid = tuple(reversed(per_dim)) + (1,) * (3 - rank)   # (x, y, z)
        if grid[0] >= 2**31 or grid[1] > MAX_GRID_YZ or grid[2] > MAX_GRID_YZ:
            continue

        def window(n: str, off: int) -> Window:
            ext = tuple(b + hi - lo for b, (lo, hi) in zip(blk, spans[n]))
            return Window(n, spans[n], _elem_bytes(program, n), ext, off)

        wins, off = [], 0
        for n in held:
            wins.append(window(n, off))
            off += _round16(wins[-1].nbytes)
        if off > budget:
            continue
        for n in ext_inputs:
            w = window(n, off)
            if off + _round16(w.nbytes) <= budget:
                wins.append(w)
                off += _round16(w.nbytes)
        in_smem = {w.name for w in wins}

        def covered(n: str) -> int:
            return math.prod(_covered(grid_shape[d], blk[d], lo, hi)
                             for d, (lo, hi) in enumerate(spans[n]))

        direct = [n for n in ext_inputs if n not in in_smem]
        gp = GroupPlan(
            stages=members, external_inputs=ext_inputs, outputs=outputs,
            spans=spans, params=_group_params(program, members), tile=(),
            bz=0, grid=grid, rings=[], warm=0, smem_bytes=off,
            hbm_bytes_per_call=(sum(_elem_bytes(program, n) * covered(n)
                                    for n in ext_inputs) + writes),
            useful_cells_per_call=cells * max(len(outputs), 1),
            kernel="windows",
            cell_ops_per_call=sum(ops[m] * covered(m) for m in members),
            block=blk, windows=wins, direct=direct)
        # fill the card first, then window every input that fits, then
        # the modeled time; equal time prefers the larger block
        key = (math.prod(grid) < 2 * NUM_SMS, bool(direct), gp.modeled_seconds,
               -math.prod(blk))
        if best is None or key < best[0]:
            best = (key, gp)
    return None if best is None else best[1]


def _split(stages: list[str], fit, alone) -> list[GroupPlan]:
    """All `stages` (topological order) in one group when `fit` plans them;
    else split greedily into groups chained through device memory, each as
    many consecutive stages as `fit` plans; a stage that `fit` cannot plan
    alone gets `alone`'s group (None: refused)."""
    whole = fit(stages)
    if whole is not None:
        return [whole]
    groups: list[GroupPlan] = []
    cur: list[str] = []
    cur_plan = None
    for s in stages:
        gp = fit(cur + [s])
        if gp is not None:
            cur, cur_plan = cur + [s], gp
            continue
        if cur_plan is not None:
            groups.append(cur_plan)
            cur, cur_plan = [s], fit([s])
            if cur_plan is not None:
                continue
        gp = alone(s)
        if gp is None:
            raise ValueError(f"stage {s!r} alone does not fit: no line-buffer "
                             f"tile within the shared-memory budget and no "
                             f"windows block within the launch limits")
        groups.append(gp)
        cur, cur_plan = [], None
    if cur_plan is not None:
        groups.append(cur_plan)
    return groups


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
    its cascade does not fit, reduced to the next divisor that does.  A
    rank without an `AUTO_SWEEPS_MAX` entry has no march to cascade: depth
    1, one sweep per call."""
    cap = AUTO_SWEEPS_MAX.get(program.rank, 1)
    if cap == 1:
        if sweeps is not None and sweeps > 1:
            notes.append(f"rank {program.rank}: no fused cascade; one sweep per call")
        return None
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
        fits = _fitting(program, grid_shape, [d for d in divisors if d <= cap],
                        smem_budget, tile, bz)
        best = min(fits, default=None, key=lambda dg: (
            math.prod(dg[1].grid) < 2 * NUM_SMS, dg[1].modeled_seconds / dg[0]))
    except (FeedbackTypeError, CascadeNameError) as e:
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
    fits `SMEM_BUDGET` on `grid_shape` (ascending); none for a rank
    without a march."""
    if program.rank not in AUTO_SWEEPS_MAX:
        return []
    it = max(program.iterate, 1)
    return [d for d, _ in _fitting(program, tuple(grid_shape),
                                   [d for d in range(2, it + 1) if it % d == 0],
                                   SMEM_BUDGET)]


def plan(program: StencilProgram, grid_shape: tuple[int, ...], *,
         smem_budget: int = SMEM_BUDGET, sweeps: int | None = None,
         iterate: int | None = None, tile: tuple[int, int] | None = None,
         bz: int | None = None, block: tuple[int, ...] | None = None) -> Plan:
    """Plan `program` on a full grid of `grid_shape` for the CUDA path.

    `iterate` programs first try a fused group of nf sweeps (see the
    module note; `sweeps` requests a depth, `sweeps=1` asks for one sweep
    per call).  Otherwise the fusion policy is `soda_tpu`'s: all stages in
    one kernel when its rings fit the shared-memory budget; else the stage
    DAG is split greedily, in topological order, into kernels chained
    through device memory, each call running one sweep; a stage whose
    rings fit no tile alone runs in the windows kernel.  `tile` and `bz`
    pin the line buffer's CTA shape instead of searching (the row-march's
    order of a step's stages stays the planner's).  Rank 1 plans to
    the windows kernel; `block` pins the windows kernel with that block
    (one sweep per call), for any rank."""
    rank = program.rank
    if len(grid_shape) != rank:
        raise ValueError(f"grid rank {len(grid_shape)} != program rank {rank}")
    grid_shape = tuple(grid_shape)
    if block is not None:
        block = tuple(int(b) for b in block)
        if len(block) != rank or min(block) < 1:
            raise ValueError(f"block {block} is not {rank} positive sizes")
        if tile is not None or bz is not None:
            raise ValueError("block= pins the windows kernel; tile= and bz= "
                             "pin the line buffer's")
        if sweeps is not None and sweeps > 1:
            raise ValueError("block= pins the windows kernel, which runs one "
                             "sweep per call")
    it = max(program.iterate if iterate is None else iterate, 1)
    notes: list[str] = []
    ideal = float(sum(_elem_bytes(program, n) for n in program.input_names)
                  + sum(_elem_bytes(program, n) for n in program.output_names))
    per_cell = dict(ideal_bytes_per_cell=ideal, ops_per_cell=ops_per_cell(program),
                    sweeps_total=it)
    if it > 1 and block is None:
        fused = _plan_fused(program, grid_shape, it, sweeps, smem_budget,
                            tile, bz, notes)
        if fused is not None:
            notes.append(f"iterate={it} executed as {it // fused.sweeps} kernel "
                         f"call(s) x {fused.sweeps} fused sweeps")
            return Plan(program.name, rank, [fused], grid_shape, notes,
                        **per_cell)
    stages = program.stage_order()

    def windows(members: list[str]) -> GroupPlan | None:
        return _plan_windows(program, members, grid_shape, smem_budget, block)

    if block is not None or rank not in KERNELS:
        notes.append("windows kernel: " + (f"block {block} pinned" if block
                                           else f"rank {rank} has no march"))
        groups = _split(stages, windows, lambda s: None)
    else:
        def alone(s: str) -> GroupPlan | None:
            notes.append(f"shared memory: no line-buffer tile of stage {s!r} "
                         f"fits {smem_budget} B; it runs in the windows kernel")
            return windows([s])

        groups = _split(
            stages, lambda ms: _plan_group(program, ms, grid_shape, smem_budget,
                                           tile, bz), alone)
    if len(groups) > 1:
        notes.append(f"shared-memory pressure: split {len(stages)} stages "
                     f"into {len(groups)} chained kernels")
    notes.append(f"iterate={it} executed as {it} chained call(s) of one sweep")
    return Plan(program.name, program.rank, groups, grid_shape, notes, **per_cell)
