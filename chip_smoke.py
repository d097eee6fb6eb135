"""Drive the torch port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero):
1. device: needs torch.cuda; prints the card's name and power limit;
2. build: generates and compiles (nvcc, sm_90a) the line-buffer kernel of
   every program and grid below, up to 32 nvcc processes at once, printing
   build seconds and ptxas lines;
3. small grids, rank 3: the six rank-3 corpus programs and two integer
   programs on an aligned and two odd grids, through
   `soda_tpu_torch.backend.cuda.run`, held against the plain PyTorch
   version on the card and against the port's NumPy reference over the
   whole grid; the kernel-1 launch count must rise by groups x iterate;
   then the z-march's pinned variants (`PINNED_3D` on
   `PINNED_3D_PROGRAMS`: one wait a step and a barrier after each stage,
   a chunk of one plane, shorter than the warm-up, and rings of their own
   depth where the powers of two exceed a small budget, each on (32, 64,
   128), whose planes are copied 16 bytes at a time, and on (13, 37, 45),
   copied element by element), each launching kernel 1 and equal bit for
   bit to the planner's kernel and, without libm, to the plain version;
4. kernel 1's main path at full size: jacobi3d 512^3 f32, one sweep, with
   kernel 1's launch counter reset just before and read just after; held
   against the plain version at 1e-4 over the whole grid, then both timed
   with CUDA events (plain, kernel, kernel, plain) beside the bound (ideal
   bytes over 3.35 TB/s) and `F.conv3d` (TF32 off); denoise3d, heat3d and
   poisson3d_f64 at 256^3, and jacobi3d 1024^3 when the card has room;
   then kernel 1's column z-march at the benchmark's size (`ZMARCH`:
   denoise3d 512^3 f32 through `cuda.build_fn`, the counters reset just
   before: 1 launch, 1 "columns3d" in `cuda.march_counts()`, 3 stages),
   bit for bit against the plain version on the whole grid and timed
   beside it (plain, kernel, kernel, plain) and its bound, the kernels
   line's "columns3d" row;
   then jacobi3d on grids no tile divides (`AT_SIZE_ODD`: 500^3, rows of
   whole 16-byte chunks, and 511^3, the scalar load path), each through
   `cuda.build_fn` with the counters reset just before (kernel 1, 1
   launch), against the plain version on the whole grid at KERNEL_TOL
   (saying whether bit for bit) and alone beside its bound and 512^3;
   each row prints its plan (tile, chunk, load path, order of a step's
   stages, CTAs an SM) and the registers `ptxas` reported;
5. small grids, rank 2: the 22 rank-2 corpus programs of at most 64 bits
   on (64, 256), (37, 45) and (7, 13), as in phase 3 with kernel 2's
   count; integers and half bit for bit against the plain version; then
   the row-march's pinned variants (`PINNED_2D` on `PINNED_2D_PROGRAMS`:
   RB 1, RB 16, a chunk shorter than the warm-up, a barrier after each
   stage instead of the planner's skew, each on (64, 256), whose rows are
   copied 16 bytes at a time, and on (37, 45), copied element by element),
   each launching kernel 2 and equal bit for bit to the planner's kernel
   and, without libm, to the plain version;
6. the CLI on blur 2048x4096 with no --device: it runs on the card,
   checks against the NumPy reference and exits 0;
7. kernel 2's main path at full size: blur 2048x4096 uint16 with kernel
   2's launch counter reset just before and read just after, bit for bit
   against the plain version over the whole grid; then blur and conv5x5
   at 16384^2 (conv5x5 beside `F.conv2d`, TF32 off), accum64 and
   poisson_f64 at 2048^2 and jacobi2d 2048^2 (iterate 8 as chained
   calls), each checked against the plain version over the whole grid
   and timed with CUDA events in turns (plain, kernel, kernel, plain)
   beside its bound; the kernels' device time alone (`device_ms`) is
   printed too;
8. small grids, fused sweeps: the six `iterate` corpus programs (rank 2:
   jacobi2d, seidel2d, residual2d, denoise2p, jacobi2d_i64; rank 3:
   heat3d) on the small grids of phases 3 and 5, at the planner's depth
   and at the deepest depth that fits, through `cuda.run`: the fused
   kernel's launch count must rise by groups x iterate / nf, every output
   must equal the chained one-sweep kernels (`sweeps=1`) bit for bit, pass
   `device_gate` against the plain version and `compare_outputs` against
   the port's NumPy reference on the whole grid; then `PINNED_SWEEPS_PROGRAMS`
   at depth = iterate pinned to RB 1 and to a chunk shorter than the
   cascade's warm-up, skewed and with barriers, on both load paths
   (`PINNED_SWEEPS`), bit for bit against the chained kernels;
9. fused sweeps at size: the main path jacobi2d 2048^2 iterate 8 with the
   fused kernel's launch counter reset just before and read just after
   (8 / nf launches, nf > 1); then jacobi2d 16384^2 iterate 8 (1 GiB per
   array, beyond L2), jacobi2d_i64 2048^2 iterate 20, residual2d and
   denoise2p 8192^2, heat3d 256^3 and 512^3 iterate 4, each checked as in
   phase 8 (the NumPy reference on the whole grid too, up to
   `ORACLE_MAX_CELLS`, in threads beside the next row's checks and done
   before its timing starts) and timed with CUDA
   events three ways in turns (fused, chained, plain, plain, chained,
   fused), beside the device time of the fused kernel alone and of the
   chained kernels alone (`device_ms`), its bound per call (and what
   bounds it), the planned bytes per cell-update, the plan and its
   registers, and the card's name and power limit;
10. the depth sweep: every row of phase 9 at every fused depth that fits
   (and 1), in ms per sweep beside the planner's modeled time and plan
   (tile, chunk, load path, order, CTAs an SM, rank 2's waves, registers),
   each output equal to the chained kernels bit for bit;
11. small grids, the windows kernel (`backend/windows.py`, kernel 4):
   smooth1d (rank 1) at lengths 1, 7, 300 and 4099, at its default block
   and at a block of 32 cells; every rank-3 and rank-2 program of phases 3
   and 5 pinned to windows blocks (`block=`) that cut several CTAs on the
   odd grids of those phases; the radius-8 f64 star (`STAR3D_R8`) at
   (40, 45, 51), whose plan at the default budget must be windows.  Each
   case: the windows launch count rises by groups x iterate, the output
   passes `device_gate` against the plain version (integers and half bit
   for bit), `compare_outputs` against the port's NumPy reference on the
   whole grid, and equals the line-buffer kernel (`sweeps=1`) bit for bit
   on every program that calls no libm;
12. the windows kernel's main path at full size: smooth1d 2^28 f32 (1 GiB
   per array) with the windows launch counter reset just before and read
   just after (1 launch), bit for bit against the plain version over the
   whole grid, timed with CUDA events in turns (plain, kernel, kernel,
   plain) and alone (`device_ms`) beside its bound and `F.conv1d` with
   five 0.2 weights (TF32 off, held at LIBRARY_TOL);
13. the windows kernel on ranks 2 and 3 at size: STAR3D_R8 512^3 f64 at
   the default budget (the fallback; its line-buffer plan needs
   smem_budget=227 KiB), and jacobi3d 512^3, denoise3d 256^3, blur 16384^2
   and conv5x5 16384^2 pinned to windows, each checked against the plain
   version over the whole grid and timed beside its line-buffer kernel in
   turns (line buffer, windows, windows, line buffer) and alone; conv5x5
   also beside `F.conv2d`;
14. the computation-reuse rewrite (`--tcse`, `optimize/tcse.py`) through
   the kernels: gauss5x5 (uint16), erode2d (a `min` cover) and seidel2d
   (f32, iterate 4) on small grids, rewritten and not, each against the
   port's NumPy reference of its own program on the whole grid, the
   rewritten kernel against its plain version (integers bit for bit,
   floats at `device_gate`) and against the unrewritten kernel outside the
   rewritten program's `valid_rim()`; then gauss5x5 16384^2 both ways
   through `cuda.build_fn` with kernel 2's counter reset just before and
   read just after, bit for bit against each other outside the rim and
   the rewritten kernel bit for bit against its plain version on the whole
   grid, timed in turns (plain program, rewritten, rewritten, plain) by
   CUDA events and alone (`device_ms`) beside the bound and the plan's
   operations per cell;
15. host tiling (`parallel/host_tile.py`): the pinned host-to-card and
   card-to-host bandwidth of a 1 GiB copy; jacobi3d 1024^3 f32 (4 GiB an
   array) at one sweep a pass under a 2 GiB budget (16 tiles), bit for bit
   against the whole-grid `cuda.run` on the whole grid, and jacobi2d
   32768^2 f32 iterate 8 with tiles and sweeps a pass chosen under a 2 GiB
   budget, bit for bit against the whole-grid run on the whole grid;
   each run with two tiles in flight and with one, in turns (2, 1, 1, 2),
   every run checked, printing the tiles, passes, read amplification, wall
   seconds a pass, bytes across the host link and the share of the pass
   the measured bandwidth needs for them; then `scripts/tpu_check.py`'s
   host-tiling gate (`HOST_TILE_GATE`: jacobi3d 512^3 in (256, 256, 512),
   jacobi2d 2048^2 in (1024, 1024), accum64 1024x2048 int64 in (512,
   1024), jacobi2d 2048^2 with tiles and cadence chosen under 32 MiB), each
   bit for bit against the whole-grid run on the whole grid; and host
   tiling over a mesh (`HOST_TILED_MESH`: jacobi2d 8192^2 x 8, at least 4
   tiles, each sharded over a [2, 2] mesh of the visible cards round
   robin), bit for bit on the whole grid at one sweep an exchange and
   outside `valid_rim()` at the automatic cadence, the kernel launches
   equal to the shards' group calls, bytes exchanged and s a pass;
16. the CLI on the card with no --device: `--tcse --report --dump-plan
   --run` on gauss5x5, `--host-tile auto --hbm-budget 8 MiB
   --host-tile-sweeps auto --run` on jacobi2d 2048^2, and `--benchmark`
   on jacobi3d 512^3 (CUDA events, beside phase 4's figure); then
   `--host-tile 512,0 --mesh 2,2 --device cuda:0 --run` on jacobi2d
   1024^2 x 8 (`CLI_HOST_TILED_MESH`: every tile's shards on card 0);
17. the mesh on the card (`parallel/mesh.py`), every shard on cuda:0: the
   on-card copy rate of a 1 GiB copy; then (`MESH_ROWS`) a. jacobi3d
   512^3 (kernel 1) on a 2x2 mesh, synchronous and overlapped, each bit for
   bit against the whole-grid kernel and the overlap against the
   synchronous run; b. jacobi2d 2048^2 x 8 (kernel 3) on 4 shards at one
   sweep an exchange (bit for bit) and at the automatic cadence (8, bit
   for bit outside `valid_rim()`); c. the same on `dcn:2,x:2` with the
   nested cadence {dcn: 8, x: 2} (outside the rim); d. blur 2047x4095
   uint16 (kernel 2) and e. smooth1d 2^24 + 3 (kernel 4) on 4 shards,
   padded to shard, bit for bit; each run's kernel launches must equal the
   group calls its shards made, and each prints ms a call by CUDA events
   beside the whole-grid `build_fn` in turns (whole, mesh, whole), the
   bytes exchanged a call, and the shards' plans; every run also takes
   its grid resident (`parallel/sharded.py`: `shard_grid` in, a
   `ShardedGrid` out), with launches equal to its group calls, 0 bytes
   scattered and gathered, the gathered output bit for bit against the
   gathered call, and two chained calls bit for bit against `run_sharded`
   at twice the sweeps and one sweep an exchange (outside the rim where
   the run's cadence is deeper), the first output unchanged by the second
   call; a loop of chained calls timed by events in the same turns
   (whole, gathered, resident, whole) with the host's enqueue
   (`mesh ... resident` lines); f. `sodac jacobi3d.soda
   --grid-shape 512,512,512 --mesh 2,2 --device cuda:0 --run` exits 0;
18. wide integers (`wide_phase`): the uint64 programs of `U64_SOURCES`
   at size with inputs over the whole range [0, 2^64), each through its
   kernel (`U64_ROWS`: u64_3d 512^3 kernel 1, u64_2d and u64_param 8192^2
   kernel 2, u64_iter 8192^2 x4 kernel 3 at the planner's depth, u64_1d
   2^27 kernel 4) with every launch counter reset just before and read
   just after, bit for bit against the plain version on the whole grid and
   the NumPy reference (on a grid cut to 2^26 cells past that), timed in
   turns (plain, kernel, kernel, plain) and alone beside the bound; u64_2d
   8192^2 on 4 shards of cuda:0 and u64_2d 16384^2 host-tiled under a 1
   GiB budget, bit for bit against the whole grid; accum128 (128-bit
   integers) at 4096^2 on the plain path's limbs on the card, bit for bit
   against the C++ golden runner at that size and the NumPy reference at
   512^2, and `cuda.build_fn` refusing it with a typed error;
19. random programs (`fuzz_phase`): 46 programs of the generators of
   `soda_tpu`'s fuzzers (`utils/fuzz.py`; `FUZZ_*`), at unaligned grids
   of about 2^20 cells, through `cuda.build_fn` with every launch counter
   set to 0 just before and read just after each: `gen_program` at ranks
   1-3, `gen_wide` (int64, uint64, double, half with abs, iterate 2 and
   4), `gen_signed_chain` and `gen_two_input_program`, two programs
   pinned to the windows kernel, and four `gen_mesh` seeds on 4 shards
   of cuda:0; each against the plain version on the card and the NumPy
   reference on the whole grid (integers bit for bit), one `fuzz ...`
   line a program; kernels 1-4 must all be launched;
20. the entry points (`soda_tpu_torch/entry.py`, `__graft_entry__.py`'s counterpart): `entry()`'s
   fn on its input launches kernel 1 once and is within KERNEL_TOL of the
   plain version, timed alone; `dryrun_multichip(4)` and `(8)` on the
   visible cards (shard i on cuda:(i mod count)), each raising on a failed
   check, print what they ran (`entry: ...` lines).

Each phase logs the seconds since the start when it ends.  Phases 4 and
7 run their programs one sweep per call (`sweeps=1`), so
they time kernels 1 and 2; phases 8-10 time the fused cascades
(`backend/sweeps.py`), phases 12-13 the windows kernel.  The line before the last is the kernel summary
as JSON (`launches`: the main path's own run; `fuzz_launches`: phase
19's); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import math
import pathlib
import re
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent

SMALL_SHAPES = ((32, 64, 128), (13, 37, 45), (7, 11, 13))
AT_SIZE = (("jacobi3d", (512, 512, 512)), ("denoise3d", (256, 256, 256)),
           ("heat3d", (256, 256, 256)), ("poisson3d_f64", (256, 256, 256)))
BIG = ("jacobi3d", (1024, 1024, 1024))
# kernel 1's column z-march at the size of the benchmark's cell
# `denoise3d-512.loop` (phase 4)
ZMARCH = ("denoise3d", (512, 512, 512))
# phase 4's rank-3 grids that no tile divides (`scripts/tpu_check.py:40`'s
# "core + rim"): 500^3 has rows of 2000 B, whole 16-byte chunks (the vector
# load path); 511^3 rows of 2044 B (the scalar load path)
AT_SIZE_ODD = (("jacobi3d", (500, 500, 500)), ("jacobi3d", (511, 511, 511)))
# the z-march pinned (phase 3): a barrier after each stage instead of the
# planner's skew, a chunk (1 plane) shorter than every warm-up, and a
# budget under which denoise3d's power-of-two rings do not fit the tile
# (8, 32) but their own depths do, on both load paths; on an f32 program
# of three levels (libm) and an int16 one of two
PINNED_3D = ({"tile": (8, 32), "bz": 8}, {"tile": (8, 32), "bz": 8, "sync": "barrier"},
             {"tile": (16, 32), "bz": 1}, {"tile": (8, 32), "bz": 4, "smem_budget": 26000})
PINNED_3D_PROGRAMS = ("denoise3d", "divneg_i16")
SMALL_SHAPES_2D = ((64, 256), (37, 45), (7, 13))
# the row-march pinned (phase 5): RB 1, RB 16, a chunk (2 rows) shorter
# than the warm-up of the radius-2 programs (4 rows), and a barrier after
# each stage instead of the skew (`utils/testing.py::pinned_plan`), on
# both load paths; on a uint16 program of two levels and radius 2, and an
# f32 one of three levels and two inputs
PINNED_2D = ({"tile": (1, 32), "bz": 8}, {"tile": (16, 64), "bz": 16},
             {"tile": (2, 32), "bz": 2}, {"tile": (2, 32), "bz": 8, "sync": "barrier"})
PINNED_2D_PROGRAMS = ("gaussian2d", "denoise2d")
# the rank-2 cascades at depth = iterate pinned (phase 8): RB 1, and a
# chunk shorter than the warm-up (2 x iterate rows), with the copies
# skewed by level and with a barrier after each; on an f32 cascade of two
# outputs and an auxiliary input, and the deepest, int64 one
PINNED_SWEEPS = ({"tile": (1, 32), "bz": 8}, {"tile": (2, 32), "bz": 4},
                 {"tile": (2, 32), "bz": 4, "sync": "barrier"})
PINNED_SWEEPS_PROGRAMS = ("residual2d", "jacobi2d_i64")
AT_SIZE_2D = (("blur", (2048, 4096)), ("blur", (16384, 16384)),
              ("conv5x5", (16384, 16384)), ("accum64", (2048, 2048)),
              ("poisson_f64", (2048, 2048)), ("jacobi2d", (2048, 2048)))
MAIN_2D = AT_SIZE_2D[0]
ITERATE_CORPUS = ("jacobi2d", "seidel2d", "residual2d", "denoise2p",
                  "jacobi2d_i64", "heat3d")
AT_SIZE_SWEEPS = (("jacobi2d", (2048, 2048)), ("jacobi2d", (16384, 16384)),
                  ("jacobi2d_i64", (2048, 2048)), ("residual2d", (8192, 8192)),
                  ("denoise2p", (8192, 8192)), ("heat3d", (256, 256, 256)),
                  ("heat3d", (512, 512, 512)))
MAIN_SWEEPS = AT_SIZE_SWEEPS[0]
# phase 9 runs the NumPy oracle on the host up to this many cells (the same
# programs at 2048^2 and 256^3 have it); past it, a row is held against the
# chained kernels and the plain version on the card
ORACLE_MAX_CELLS = 2**26
DEPTH_SWEEP = AT_SIZE_SWEEPS   # every fused row at every depth that fits
KERNEL_TOL = 1e-4   # f32 kernel vs plain (the same IEEE operations, no FMA)
LIBRARY_TOL = 1e-4  # the library call vs the kernel (another summation order)
SMALL_SHAPES_1D = ((1,), (7,), (300,), (4099,))
SMALL_BLOCKS = {1: (32,), 2: (8, 32), 3: (4, 8, 32)}   # several CTAs per axis
STAR_SMALL = (40, 45, 51)
MAIN_WINDOWS = ("smooth1d", (2**28,))
AT_SIZE_WINDOWS = (("star3d_r8", (512, 512, 512), None),
                   ("jacobi3d", (512, 512, 512), (8, 8, 64)),
                   ("denoise3d", (256, 256, 256), (8, 8, 64)),
                   ("blur", (16384, 16384), (16, 128)),
                   ("conv5x5", (16384, 16384), (16, 128)))
STAR_LB_BUDGET = 227 * 1024   # the line buffer's star plan: one CTA an SM
TCSE_PROGRAMS = ("gauss5x5", "erode2d", "seidel2d")
TCSE_SHAPES = ((64, 256), (37, 45))    # 16-byte row copies, element copies
TCSE_MAIN = ("gauss5x5", (16384, 16384))
# (program, grid, sweeps a pass or "auto", device budget in bytes)
HOST_TILED = (("jacobi3d", (1024, 1024, 1024), 1, 2 * 2**30),
              ("jacobi2d", (32768, 32768), "auto", 2 * 2**30))
CLI_HOST_TILED = ("jacobi2d", (2048, 2048), 8 * 2**20)
# `sodac --host-tile ... --mesh 2,2 --device cuda:0 --run` (phase 16): every
# tile's shards on card 0, through `shard_grid` and `gather_grid`
CLI_HOST_TILED_MESH = ("jacobi2d", (1024, 1024), (512, 0), "2,2")
# host tiling's gate of `scripts/tpu_check.py:111-116` (phase 15): (program,
# grid, tiles, sweeps a pass); "auto" chooses both under HOST_TILE_GATE_BUDGET
HOST_TILE_GATE = (("jacobi3d", (512, 512, 512), (256, 256, 512), None),
                  ("jacobi2d", (2048, 2048), (1024, 1024), None),
                  ("accum64", (1024, 2048), (512, 1024), None),
                  ("jacobi2d", (2048, 2048), "auto", "auto"))
HOST_TILE_GATE_BUDGET = 32 * 2**20
# host tiling over a mesh (phase 15): jacobi2d 8192^2 x 8, every tile sharded
# over a [2, 2] mesh of the visible cards round robin, under a budget a device
# that forces at least HOST_TILED_MESH_TILES tiles
HOST_TILED_MESH = ("jacobi2d", (8192, 8192), (2, 2), 80 * 2**20)
HOST_TILED_MESH_TILES = 4
# the mesh on the card (phase 17), every shard on cuda:0: (row, program,
# grid, axis sizes, axis names, sharded dims, runs of (cadence, overlap,
# bit for bit on the whole grid: else outside `valid_rim()`))
MESH_ROWS = (
    ("a", "jacobi3d", (512, 512, 512), (2, 2), None, (0, 1),
     ((1, False, True), (1, True, True))),
    ("b", "jacobi2d", (2048, 2048), (4,), None, (0,),
     ((1, False, True), (None, False, False))),
    ("c", "jacobi2d", (2048, 2048), (2, 2), ("dcn", "x"), (0, 1),
     (({"dcn": 8, "x": 2}, False, False),)),
    ("d", "blur", (2047, 4095), (4,), None, (0,), ((None, False, True),)),
    ("e", "smooth1d", (2**24 + 3,), (4,), None, (0,), ((None, False, True),)),
)
MESH_CLI = ["jacobi3d.soda", "--grid-shape", "512,512,512", "--mesh", "2,2",
            "--device", "cuda:0", "--run"]
MESH_REPS = 10
MESH_SLEEPS = 4      # the sleep that covers a mesh call's enqueue: 6 ms
# wide integers (phase 18): the uint64 programs of `U64_SOURCES` at size,
# each with the kernel that must run it; u64_param's k lies above 2^63
# (u64_iter first: its oracle, four sweeps, takes the longest)
U64_ROWS = (("u64_iter", (8192, 8192), "sweeps"),
            ("u64_3d", (512, 512, 512), "linebuffer3d"),
            ("u64_2d", (8192, 8192), "linebuffer2d"),
            ("u64_param", (8192, 8192), "linebuffer2d"),
            ("u64_1d", (2**27,), "windows"))
U64_K = 2**63 + 10_000_000_019
U64_MESH = ("u64_2d", (8192, 8192), (4,))
U64_HOST_TILED = ("u64_2d", (16384, 16384), 2**30)   # 2 GiB an array, 1 GiB budget
W128_MAIN = ("accum128", (4096, 4096))
W128_ORACLE = (512, 512)
# the fuzz phase (19): random programs (`utils/fuzz.py`, the generators of
# `soda_tpu`'s fuzzers) at unaligned grids of about 2^20 cells, by rank
FUZZ_SHAPES = {1: (1048573,), 2: (1021, 1031), 3: (61, 127, 137)}
# gen_program(Random(1000 * rank + seed), rank), seeds by rank (the seeds of
# tests/test_fuzz.py::test_fuzz_backends_agree)
FUZZ_PROGRAM_SEEDS = {1: range(4), 2: range(6), 3: range(6)}
# gen_wide seeds (scripts/fuzz_wide.py): half with abs through kernel 2
# (125), kernel 1 (165, 60) and the rank-2 cascade (130 at iterate 2, 15 at
# 4); int64, uint64 and double through kernels 1 and 2 and cascades at
# iterate 2 and 4 (tests/test_torch_fuzz.py's list)
FUZZ_WIDE_SEEDS = (125, 165, 130, 15, 60, 0, 10, 5, 26, 1, 30, 109, 2, 34, 4, 111)
FUZZ_CHAIN_SEEDS = range(4)   # gen_signed_chain and gen_two_input_program
FUZZ_PINNED = ((2, 0), (3, 1))   # (rank, gen_program seed) pinned to windows
# mesh_case seeds on 4 shards of cuda:0 (a 1-D mesh as [4], a 2-D one as
# [2, 2]): int64 iterate 2 overlapped, uint16 iterate 4, float iterate 4 at
# the automatic cadence, float overlapped
FUZZ_MESH_SEEDS = (2, 5, 8, 11)
# a phase-19 program that calls libm is held to the oracle by the share of
# its cells beyond `compare_outputs`' tolerance: an ulp of the card's libm
# flips a compare on a value rounded to about zero.  Measured at most
# 6.65e-6 (7 of 1,052,651 cells, gen_program rank 2 seed 4, on an H100);
# a control with LIBM_CONTROL_CELLS wrong cells (about one row at rank 2,
# 9.8e-4 of the grid) must fail the same gate
LIBM_FLIP_SHARE = 1e-4
LIBM_CONTROL_CELLS = 1024
# the entry points (phase 20, `soda_tpu_torch/entry.py`)
DRYRUN_DEVICES = (4, 8)
PINNED_COPY_BYTES = 2**30
SLEEP_CYCLES = 3_000_000   # at most 1.98 GHz: at least 1.5 ms
SLEEP_COVERS_S = 1e-3


def log(*a) -> None:
    print(*a, flush=True)


def events_ms(fn, reps: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, sleeps: int = 1) -> float | None:
    """Device time of the kernels one `fn()` enqueues, in ms (the mean of
    `reps`), by CUDA events: a sleep kernel (`sleeps` x SLEEP_CYCLES) holds
    the stream while the host enqueues the start event, `fn`'s kernels and
    the end event, so no host gap is timed.  None ("not measured") where
    the host took longer to enqueue than the sleep lasts.  (torch.profiler
    on the card's machine dropped kernel records after a few profiles in
    one process.)"""
    import torch

    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES * sleeps)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        if host_s > SLEEP_COVERS_S * sleeps:
            log(f"device time: the host enqueued for {host_s * 1e3:.3f} ms, longer "
                f"than the sleep; not measured")
            return None
        total += start.elapsed_time(end)
    return total / reps


def fmt(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def max_abs_err(a: dict, b: dict) -> float:
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)


def device_gate(p, got: dict, want: dict, exact: bool) -> bool:
    """`compare_outputs` on the card: integers (and, with `exact`, every
    output) bit for bit; floats at the program's tolerance."""
    import torch

    from soda_tpu_torch.utils.testing import tolerance

    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    for k in want:
        t = p.tensors[k].type
        if exact or not t.is_float:
            # integers as int64, floats as their bit patterns
            a, b = ((got[k].view(bits[got[k].element_size()]),
                     want[k].view(bits[want[k].element_size()])) if t.is_float
                    else (got[k].to(torch.int64), want[k].to(torch.int64)))
            if not torch.equal(a, b):
                return False
        elif not torch.allclose(got[k].double(), want[k].double(),
                                rtol=tolerance(p), atol=tolerance(p)):
            return False
    return True


def bitwise_equal(a: dict, b: dict) -> bool:
    """Every output of `a` equal to `b`'s bit for bit (floats by pattern)."""
    import torch

    bits = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return all(torch.equal(a[k].view(bits[a[k].element_size()]),
                           b[k].view(bits[b[k].element_size()])) for k in a)


def ptxas_registers(log: str) -> str:
    """The registers (and spills) `ptxas -v` reported for a kernel."""
    regs = re.search(r"Used (\d+) registers", log)
    spills = re.search(r"(\d+) bytes spill stores", log)
    return ((f"{regs.group(1)} registers" if regs else "registers not reported")
            + (f", {spills.group(1)} B spill stores" if spills else ""))


def random_bits(shape, gen, dev):
    """Uniform 64-bit words made on the card from `gen`, as int64."""
    import torch

    hi = torch.randint(-2**31, 2**31, shape, generator=gen, device=dev, dtype=torch.int64)
    lo = torch.randint(0, 2**32, shape, generator=gen, device=dev, dtype=torch.int64)
    return (hi << 32) | lo


def oracle_shape(shape) -> tuple[int, ...]:
    """`shape`, cut along dim 0 to at most ORACLE_MAX_CELLS cells."""
    return (min(shape[0], ORACLE_MAX_CELLS * shape[0] // math.prod(shape)), *shape[1:])


def host_arrays(values: dict) -> dict:
    """Tensors on the card as numpy arrays (uint64 through its int64 view)."""
    import numpy as np
    import torch

    return {k: (v.view(torch.int64).cpu().numpy().view(np.uint64) if v.dtype == torch.uint64
                else v.cpu().numpy()) for k, v in values.items()}


def device_inputs(p, shape, gen, dev) -> dict:
    """Random inputs made on the card from `gen`, in the distributions of
    `rand_inputs` (uint16 in [0, 250), int64 in [-2^40, 2^40), floats
    standard normal), but uint64 over its whole range [0, 2^64)."""
    import torch

    from soda_tpu_torch.ir.dtypes import torch_dtype

    ins = {}
    for n in p.input_names:
        t = p.tensors[n].type
        dt = torch_dtype(t)
        if dt == torch.uint64 and t.width == 64:
            ins[n] = random_bits(shape, gen, dev).view(torch.uint64)
        elif t.is_float:
            ins[n] = torch.randn(shape, generator=gen, device=dev, dtype=dt)
        elif t.kind == "int" and t.width > 32:
            ins[n] = torch.randint(-(1 << 40), 1 << 40, shape, generator=gen,
                                   device=dev, dtype=dt)
        else:
            ins[n] = torch.randint(0, 250, shape, generator=gen, device=dev,
                                   dtype=torch.int32).to(dt)
    return ins


def wide_phase(dev, gen, card, u64p, u64_mesh_fn, u64_tiling) -> bool:
    """Phase 18: the uint64 rows through kernels 1-4 (`U64_ROWS`), the mesh
    (`U64_MESH`) and host tiling (`U64_HOST_TILED`), each bit for bit; the
    128-bit program on the plain path's limbs against the golden runner and
    the oracle, and `cuda.build_fn` refusing it.  The NumPy oracles (about
    70 s of host work at 2^26 cells) run in threads beside the card's
    rows; host tiling runs first, on a quiet host, since its time is the
    host's copies.  Logs each row; False on the first failure."""
    import numpy as np
    import torch

    from soda_tpu_torch.backend import cpp, cuda, eager
    from soda_tpu_torch.backend.io import to_numpy, to_torch
    from soda_tpu_torch.frontend.parser import parse_file
    from soda_tpu_torch.ir.types import UnsupportedTypeError
    from soda_tpu_torch.parallel import host_tile
    from soda_tpu_torch.utils import report
    from soda_tpu_torch.utils.testing import CORPUS, oracle

    t18 = time.perf_counter()
    # host tiling: 2 GiB arrays under a 1 GiB budget, against the whole grid
    n, shape, budget = U64_HOST_TILED
    p = u64p[n]
    tiles, _, ext, n_tiles, _, _, amp = u64_tiling
    x = random_bits(shape, gen, dev).view(torch.uint64)
    whole = host_arrays(cuda.run(p, {"a": x}, {}, device=dev))["o"]
    x_host = host_arrays({"a": x})
    del x
    torch.cuda.empty_cache()
    st = {}
    cuda.reset_launches()
    out = host_tile.run_host_tiled(p, x_host, tiles=tiles, sweeps_per_pass=1, device=dev,
                                   stats=st)
    launched = sum(cuda.launch_counts().values())
    ok = (launched == math.prod(n_tiles) and st["n_tiles"] == n_tiles
          and np.array_equal(out["o"], whole))
    log(f"wide u64 host tiled {n} {shape} under {budget} B: {'x'.join(map(str, n_tiles))} "
        f"tiles of {'x'.join(map(str, tiles))} (+halo -> {'x'.join(map(str, ext))}), "
        f"read amplification {amp:.4f}; launches {launched}/{math.prod(n_tiles)}; "
        f"{'bit for bit' if ok else 'MISMATCH'} against the whole-grid run; "
        f"{sum(st['pass_seconds']):.3f} s; {st['h2d_bytes']} B to the card and "
        f"{st['d2h_bytes']} B back; card {card}")
    if not ok:
        log("FAILED wide check: host tiling")
        return False
    del whole, x_host, out

    oracles = concurrent.futures.ThreadPoolExecutor(max_workers=4)
    try:
        checks = []    # (what, the result's host arrays, the oracle's future)
        u64_whole = {}
        for n, shape, kernel in U64_ROWS:
            p = u64p[n]
            k_np = {"k": np.uint64(U64_K)} if p.params else {}
            ins, pars = to_torch(p, device_inputs(p, shape, gen, dev), k_np, dev)
            fn = cuda.build_fn(p, grid_shape=shape)
            want = len(fn.plan.groups) * max(p.iterate, 1) // fn.plan.groups[0].sweeps
            cuda.reset_launches()
            got = fn(ins, pars)
            torch.cuda.synchronize()
            counts = cuda.launch_counts()
            # the NumPy oracle on the leading 2^26 cells, through the kernel at
            # that grid past the cap
            cut = oracle_shape(shape)
            if cut == shape:
                cut_ins, cut_got = ins, got
            else:
                cut_ins = {k: v[:cut[0]].contiguous() for k, v in ins.items()}
                cut_got = cuda.build_fn(p, grid_shape=cut)(cut_ins, pars)
            checks.append((f"{n} {cut}", host_arrays(cut_got),
                           oracles.submit(oracle, p, host_arrays(cut_ins), k_np)))
            del cut_ins, cut_got
            plain = eager.run(p, ins, pars, device=dev)
            ok_plain = bitwise_equal(got, plain)
            del plain
            torch.cuda.empty_cache()

            def run_kernel():
                fn(ins, pars)

            def run_plain():
                eager.run(p, ins, pars, device=dev)

            t = [events_ms(run_plain, 3), events_ms(run_kernel, 5),
                 events_ms(run_kernel, 5), events_ms(run_plain, 3)]
            k_ms, p_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
            alone = device_ms(run_kernel, 3, 2)
            rep = report.analyze(fn.plan)
            ok = ok_plain and counts[kernel] == want and sum(counts.values()) == want
            log(f"wide u64 {n} {shape} (kernel {kernel}): launches {counts[kernel]}/{want} "
                f"({counts}); {'bit for bit' if ok_plain else 'MISMATCH'} against the plain "
                f"version on the whole grid; ms a run kernel {k_ms:.4f} [{t[1]:.4f}, "
                f"{t[2]:.4f}] (alone {fmt(alone)}) plain {p_ms:.4f} [{t[0]:.4f}, {t[3]:.4f}]; "
                f"bound {rep.program_bound_ms:.4f} ({rep.bound_by}: bytes "
                f"{rep.bytes_bound_ms * rep.calls:.4f}, operations "
                f"{rep.ops_bound_ms * rep.calls:.4f}), {100 * rep.program_bound_ms / k_ms:.1f}% "
                f"of the bound; {fn.plan.groups[0].describe()}; card {card}")
            if not ok:
                log(f"FAILED wide check: {n} {shape}")
                return False
            if (n, shape) == U64_MESH[:2]:
                u64_whole = {"ins": ins, "out": got, "fn": fn}
            else:
                del ins, got
            del fn
            torch.cuda.empty_cache()
        # the mesh: 4 shards of cuda:0, against the whole grid
        n, shape, sizes = U64_MESH
        ins, whole, whole_fn = u64_whole["ins"], u64_whole["out"], u64_whole["fn"]
        cuda.reset_launches()
        got = u64_mesh_fn(ins, {})
        torch.cuda.synchronize()
        launched = sum(cuda.launch_counts().values())
        calls = u64_mesh_fn.stats["group_calls"]
        ok = launched == calls > 0 and bitwise_equal(got, whole)
        ms = events_ms(lambda: u64_mesh_fn(ins, {}), 5)
        whole_ms = events_ms(lambda: whole_fn(ins, {}), 5)
        log(f"wide u64 mesh {n} {shape} over {'x'.join(map(str, sizes))} on cuda:0: shards of "
            f"{'x'.join(map(str, u64_mesh_fn.shard_shape))}; launches {launched}/{calls}; "
            f"{'bit for bit' if ok else 'MISMATCH'} against the whole grid; "
            f"{u64_mesh_fn.stats['exchange_bytes']} B exchanged a call; {ms:.4f} ms a call "
            f"(events), whole grid {whole_ms:.4f}; card {card}")
        if not ok:
            log("FAILED wide check: the mesh")
            return False
        del ins, whole, whole_fn, got, u64_whole
        torch.cuda.empty_cache()
        # 128 bits: the plain path's limbs on the card, the golden runner, the oracle
        n, shape = W128_MAIN
        p = parse_file(CORPUS / f"{n}.soda")
        try:
            cuda.build_fn(p, grid_shape=shape)
            log(f"FAILED wide check: cuda.build_fn took {n}, which has >64-bit integers")
            return False
        except UnsupportedTypeError as e:
            log(f"wide 128 {n}: cuda.build_fn refuses it: {e}")
        words = random_bits(shape + (2,), gen, dev).view(torch.uint64)
        t0 = time.perf_counter()
        golden = oracles.submit(cpp.compile_and_run, p, host_arrays({"a": words}), pairs=True)
        small = words[:W128_ORACLE[0], :W128_ORACLE[1]].contiguous()
        checks.append((f"{n} {W128_ORACLE}", to_numpy(p, eager.run(p, {"a": small}, device=dev)),
                       oracles.submit(oracle, p, to_numpy(p, {"a": small}), {})))
        secs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = eager.run(p, {"a": words}, device=dev)["o"]
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
        ok_golden = np.array_equal(host_arrays({"o": out})["o"], golden.result()["o"])
        log(f"wide 128 {n} {shape} on {dev} (eager, quad limbs): {secs[0]:.3f} s, "
            f"{secs[1]:.3f} s a run (host clock, synchronized); golden runner (g++, "
            f"__int128) {'bit for bit' if ok_golden else 'MISMATCH'} at {shape}, done "
            f"{time.perf_counter() - t0:.3f} s after its start, its build included; card {card}")
        if not ok_golden:
            log("FAILED wide check: 128 bits against the golden runner")
            return False
        del words, out, small
        torch.cuda.empty_cache()
        for what, got, gold in checks:
            gold = gold.result()
            ok = all(np.array_equal(got[o], gold[o]) for o in gold)
            log(f"wide oracle {what}: {'bit for bit' if ok else 'MISMATCH'} against the NumPy "
                f"reference")
            if not ok:
                log(f"FAILED wide check: {what} against the oracle")
                return False
    finally:
        oracles.shutdown(cancel_futures=True)
    log(f"wide: phase 18 took {time.perf_counter() - t18:.1f} s")
    return True


def fuzz_cases(dev) -> list[dict]:
    """Phase 19's programs (`utils/fuzz.py`): each a dict of its label, its
    program, grid, numpy inputs, iterate and plan (the planner's, or pinned
    to the windows kernel), `base` (the base type of a `gen_wide` program,
    which takes that generator's gate), and for a mesh seed `mesh`, the
    case (`fuzz.MeshCase`) and its sharded fn on 4 shards of `dev`."""
    import random

    import numpy as np

    from soda_tpu_torch.frontend.parser import parse
    from soda_tpu_torch.parallel import mesh
    from soda_tpu_torch.plan.planner import plan
    from soda_tpu_torch.utils import fuzz

    cases = []

    def add(label, src, ins, it=None, base=None, **plan_kw):
        p = parse(src)
        shape = next(iter(ins.values())).shape
        it = max(p.iterate if it is None else it, 1)
        cases.append(dict(label=label, source=src, program=p, shape=shape, inputs=ins, iterate=it,
                          base=base, plan=plan(p, shape, iterate=it, **plan_kw), mesh=None))

    def program_input(src, rank, seed):
        return {"a": fuzz.make_input(parse(src), FUZZ_SHAPES[rank], np.random.default_rng(seed))}

    for rank, seeds in FUZZ_PROGRAM_SEEDS.items():
        for seed in seeds:
            src = fuzz.gen_program(random.Random(1000 * rank + seed), rank)
            add(f"gen_program rank {rank} seed {seed}", src, program_input(src, rank, seed))
    for seed in FUZZ_WIDE_SEEDS:
        c = fuzz.wide_case(seed, FUZZ_SHAPES[fuzz.wide_case(seed).program.rank])
        add(f"gen_wide seed {seed} ({c.base})", c.source, c.inputs, base=c.base)
    for seed in FUZZ_CHAIN_SEEDS:
        rng = random.Random(1500 + seed)    # test_fuzz_mixed_sign_chains's draws
        rank = rng.choice([2, 3])
        src = fuzz.gen_signed_chain(rng, rank)
        it = rng.choice([1, 2, 4])
        x = np.random.default_rng(seed).standard_normal(FUZZ_SHAPES[rank]).astype(np.float32)
        add(f"gen_signed_chain seed {seed}", src, {"a": x}, it)
        rnp = np.random.default_rng(seed)
        a, b = (rnp.standard_normal(FUZZ_SHAPES[2]).astype(np.float32) for _ in range(2))
        add(f"gen_two_input_program seed {seed}",
            fuzz.gen_two_input_program(random.Random(9000 + seed)), {"a": a, "b": b})
    for rank, seed in FUZZ_PINNED:
        src = fuzz.gen_program(random.Random(1000 * rank + seed), rank)
        add(f"gen_program rank {rank} seed {seed} pinned to windows", src,
            program_input(src, rank, seed), block=SMALL_BLOCKS[rank])
    for seed in FUZZ_MESH_SEEDS:
        c = fuzz.mesh_case(seed, FUZZ_SHAPES[2])
        sizes = [4] if len(c.axis_sizes) == 1 else [2, 2]
        add(f"gen_mesh seed {seed} on {'x'.join(map(str, sizes))} shards of {dev}", c.source,
            c.inputs)
        cases[-1]["mesh"] = (c, mesh.build_sharded_fn(
            c.program, mesh.make_mesh(sizes, None, [dev] * 4), grid_shape=c.shape,
            dims=c.dims, sweeps_per_exchange=c.sweeps_per_exchange, overlap=c.overlap))
    return cases


def fuzz_phase(dev, card, cases: list[dict], build_seconds: dict) -> dict | None:
    """Phase 19: every program of `fuzz_cases` through `cuda.build_fn` (a
    mesh seed through its sharded fn), every kernel counter set to 0 just
    before and read just after: each group's kernel launched iterate / nf
    times (a mesh: once a group call); the outputs against the plain
    version on the card (`device_gate`: bit for bit where no libm is
    called) and against the NumPy oracle on the whole grid
    (`compare_outputs`; a program calling libm by the share of cells beyond
    its gate, under `LIBM_FLIP_SHARE`, which a control with one row's worth
    of wrong cells must exceed; a `gen_wide` program at its generator's
    gate, integers bit for bit; a mesh seed at `fuzz.mesh_gate`, and bit
    for bit against the whole-grid kernels where the gate compares).  The oracles
    run in threads beside the card.  Returns the launches of each kernel;
    None if a program failed."""
    import collections

    import numpy as np
    import torch

    from soda_tpu_torch.backend import cuda, eager
    from soda_tpu_torch.backend.io import to_numpy, to_torch
    from soda_tpu_torch.utils import fuzz
    from soda_tpu_torch.utils.testing import compare_outputs, kernel_names, oracle, tolerance

    totals = collections.Counter()
    marches = collections.Counter()
    failed = []
    t19 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as oracles:
        golds = [oracles.submit(oracle, c["program"], c["inputs"], {}, c["iterate"])
                 for c in cases]
        for c, gold in zip(cases, golds):
            p, it, pl = c["program"], c["iterate"], c["plan"]
            ins, _ = to_torch(p, c["inputs"], {}, dev)
            whole = cuda.build_fn(p, pl, iterate=it)
            run = c["mesh"][1] if c["mesh"] else whole
            cuda.reset_launches()
            got = run(ins, {})
            torch.cuda.synchronize()
            counts = {k: v for k, v in cuda.launch_counts().items() if v}
            totals.update(counts)
            marches.update(cuda.march_counts())
            if c["mesh"]:
                case, fn = c["mesh"]
                names = sorted({k for lp in fn.local_plans().values() for k in kernel_names(lp)})
                want = fn.stats["group_calls"]
                ok_launch = sum(counts.values()) == want > 0 and set(counts) == set(names)
                exact_everywhere = (len(p.stage_order()) == 1
                                    and (case.sweeps_per_exchange == 1 or it == 1))
                rim = 0 if exact_everywhere else p.valid_rim()
            else:
                names = kernel_names(pl)
                want = dict(collections.Counter(n for n in names for _ in range(
                    it // pl.groups[0].sweeps)))
                ok_launch = counts == want
                rim = 0
            inner = tuple(slice(rim, n - rim) for n in c["shape"])

            def cut(outs):
                return {k: v[inner].contiguous() for k, v in outs.items()}

            plain = eager.run(p, ins, device=dev, iterate=it)
            ok_plain = device_gate(p, cut(got), cut(plain),
                                   exact=not p.uses_libm_transcendentals())
            ok_whole = True
            if c["mesh"]:
                ok_whole = bitwise_equal(cut(got), cut(whole(ins, {})))
            got_np, gold = to_numpy(p, got), gold.result()
            flips = ""
            if c["mesh"]:
                ok_oracle = fuzz.mesh_gate(c["mesh"][0], gold["out"], got_np["out"])
            elif c["base"]:
                ok_oracle = fuzz.wide_gate(p, c["base"], gold["out"], got_np["out"])
                if not p.tensors["out"].type.is_float:
                    ok_oracle = ok_oracle and np.array_equal(got_np["out"], gold["out"])
            elif p.uses_libm_transcendentals():
                def beyond(outs):
                    return max(float(np.mean(~np.isclose(
                        outs[k].astype(np.float64), gold[k].astype(np.float64),
                        rtol=tolerance(p), atol=tolerance(p)))) for k in gold)

                wrong = {k: v.copy() for k, v in got_np.items()}
                for v in wrong.values():
                    v.flat[:LIBM_CONTROL_CELLS] = -v.flat[:LIBM_CONTROL_CELLS] - 1
                share, control = beyond(got_np), beyond(wrong)
                ok_oracle = share < LIBM_FLIP_SHARE <= control
                flips = (f", {share:.2e} of the cells beyond {tolerance(p)} (limit "
                         f"{LIBM_FLIP_SHARE:g}; {LIBM_CONTROL_CELLS} wrong cells: {control:.2e})")
            else:
                ok_oracle = compare_outputs(p, got_np, gold, 0)
            ok = ok_launch and ok_plain and ok_whole and bool(ok_oracle)
            plans = c["mesh"][1].local_plans() if c["mesh"] else {"whole grid": pl}
            secs = sum(build_seconds.get(cuda.group_kernel(p, g).source, 0.0)
                       for lp in plans.values() for g in lp.groups)
            plans = "; ".join(f"{key}: " + ", ".join(g.describe() for g in lp.groups)
                              for key, lp in plans.items())
            log(f"fuzz {c['label']}: {'+'.join(names)} {c['shape']} iterate {it}; plan "
                f"{plans}; launches {counts} (want {want}); "
                f"{'equal' if ok_plain else 'MISMATCH'} to the plain version"
                f"{f' outside the rim {rim}' if rim else ''}"
                f"{'' if not c['mesh'] else ', bit for bit to the whole grid' if ok_whole else ', MISMATCH to the whole grid'}"
                f"; {'passes' if ok_oracle else 'FAILS'} the oracle's gate{flips}; nvcc {secs:.1f} s; "
                f"{'OK' if ok else 'FAILED'}")
            if not ok:
                log(f"FAILED fuzz check: {c['label']}:\n{c['source']}")
                failed.append(c["label"])
            del ins, got, plain, whole
    log(f"fuzz: phase 19 ran {len(cases)} programs in {time.perf_counter() - t19:.1f} s, "
        f"{len(failed)} failed {failed}; launches {dict(totals)}; marches "
        f"{dict(marches)}; card {card}")
    return None if failed else {**totals, "columns3d": marches["columns3d"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch.nn.functional as F

    from soda_tpu_torch import entry as entry_points
    from soda_tpu_torch.backend import cpp, cuda, eager, linebuffer
    from soda_tpu_torch.backend.io import to_numpy, to_torch
    from soda_tpu_torch.cli import sodac
    from soda_tpu_torch.frontend.parser import parse, parse_file
    from soda_tpu_torch.ir.types import UnsupportedTypeError
    from soda_tpu_torch.optimize import tcse
    from soda_tpu_torch.parallel import host_tile, mesh
    from soda_tpu_torch.parallel.sharded import gather_grid, shard_grid
    from soda_tpu_torch.plan.planner import fused_depths, plan
    from soda_tpu_torch.utils import report
    from soda_tpu_torch.utils.testing import (CORPUS, INT3D_SOURCES,
                                              RANK1_CORPUS, RANK2_CORPUS,
                                              RANK3_CORPUS, STAR3D_R8,
                                              U64_SOURCES, compare_outputs,
                                              oracle, pinned_plan, rand_inputs)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t_start = time.perf_counter()

    def mark(phase: int) -> None:
        log(f"phase {phase} done at {time.perf_counter() - t_start:.1f} s")

    # ---- 1. device ---------------------------------------------------------
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = report.card()
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    log(f"nvidia-smi name, power.limit: {card}")

    programs = {n: parse_file(CORPUS / f"{n}.soda") for n in RANK3_CORPUS}
    programs.update({n: parse(s) for n, s in INT3D_SOURCES.items()})
    programs2 = {n: parse_file(CORPUS / f"{n}.soda") for n in RANK2_CORPUS}
    programs1 = {n: parse_file(CORPUS / f"{n}.soda") for n in RANK1_CORPUS}
    star = parse(STAR3D_R8)

    # ---- 2. build -------------------------------------------------------------
    jobs = {}

    def add_plan(p, the_plan):
        for g in the_plan.groups:
            k = cuda.group_kernel(p, g)
            jobs[k.source] = k

    def add_jobs(p, shape, **kw):
        add_plan(p, plan(p, shape, **kw))

    allp = {**programs, **programs2}
    small_depths = {}    # (name, shape) -> fused depths phase 8 runs
    for n in ITERATE_CORPUS:
        p = allp[n]
        for shape in SMALL_SHAPES if p.rank == 3 else SMALL_SHAPES_2D:
            small_depths[(n, shape)] = sorted({plan(p, shape).groups[0].sweeps,
                                               max(fused_depths(p, shape))})
    sweep_depths = {(n, shape): [1] + fused_depths(allp[n], shape)
                    for n, shape in DEPTH_SWEEP}
    for n, p in programs.items():
        for shape in SMALL_SHAPES:
            add_jobs(p, shape)
    for n in PINNED_3D_PROGRAMS:
        for shape in SMALL_SHAPES[:2]:
            for kw in PINNED_3D:
                add_plan(programs[n], pinned_plan(programs[n], shape, kw))
    for n, shape in AT_SIZE + (BIG, ZMARCH) + AT_SIZE_ODD:
        add_jobs(programs[n], shape, sweeps=1)
    for n, p in programs2.items():
        for shape in SMALL_SHAPES_2D:
            add_jobs(p, shape)
    for n, shape in AT_SIZE_2D:
        add_jobs(programs2[n], shape, sweeps=1)
    for n in PINNED_2D_PROGRAMS:
        for shape in SMALL_SHAPES_2D[:2]:
            for kw in PINNED_2D:
                add_plan(programs2[n], pinned_plan(programs2[n], shape, kw))
    for (n, shape), depths in small_depths.items():
        for d in [1] + depths:
            add_jobs(allp[n], shape, sweeps=d)
        if n in PINNED_SWEEPS_PROGRAMS and shape in SMALL_SHAPES_2D[:2]:
            for kw in PINNED_SWEEPS:
                add_plan(allp[n], pinned_plan(allp[n], shape,
                                              dict(kw, sweeps=allp[n].iterate)))
    for n, shape in AT_SIZE_SWEEPS:
        add_jobs(allp[n], shape)
        add_jobs(allp[n], shape, sweeps=1)
    for (n, shape), depths in sweep_depths.items():
        for d in depths:
            add_jobs(allp[n], shape, sweeps=d)
    # the windows kernel (phases 11-13)
    allp.update(programs1)
    allp["star3d_r8"] = star
    for p in programs1.values():
        for shape in SMALL_SHAPES_1D:
            add_jobs(p, shape)
            add_jobs(p, shape, block=SMALL_BLOCKS[1])
    for n, p in {**programs, **programs2}.items():
        for shape in SMALL_SHAPES[1:] if p.rank == 3 else SMALL_SHAPES_2D[1:]:
            add_jobs(p, shape, block=SMALL_BLOCKS[p.rank])
            add_jobs(p, shape, sweeps=1)
    add_jobs(star, STAR_SMALL)
    add_jobs(star, STAR_SMALL, smem_budget=STAR_LB_BUDGET)
    add_jobs(allp[MAIN_WINDOWS[0]], MAIN_WINDOWS[1])
    for n, shape, block in AT_SIZE_WINDOWS:
        add_jobs(allp[n], shape, block=block)
        add_jobs(allp[n], shape, sweeps=1,
                 **({"smem_budget": STAR_LB_BUDGET} if n == "star3d_r8" else {}))
    # the rewritten programs (phase 14), the tiles' plans (phase 15) and the
    # CLI's (phase 16)
    rewritten = {n: tcse.apply(allp[n]) for n in TCSE_PROGRAMS}
    for n, q in rewritten.items():
        for shape in TCSE_SHAPES:
            add_jobs(q, shape)
            add_jobs(allp[n], shape)
    add_jobs(rewritten[TCSE_MAIN[0]], TCSE_MAIN[1])
    add_jobs(allp[TCSE_MAIN[0]], TCSE_MAIN[1])
    tilings = {}
    for n, shape, nf, budget in HOST_TILED + ((*CLI_HOST_TILED[:2], "auto",
                                               CLI_HOST_TILED[2]),):
        p = allp[n]
        if nf == "auto":
            nf, tiles = host_tile.choose_sweeps_per_pass(p, shape, None, budget)
        else:
            tiles = host_tile.choose_host_tiles(p, shape, budget, nf)
        tilings[(n, shape)] = host_tile.plan_host_tiling(p, shape, tiles, nf)
        it = max(p.iterate, 1)
        add_jobs(p, tilings[(n, shape)][2], iterate=None if nf == it else nf)
        add_jobs(p, shape)     # the whole-grid run it is held against
    # host tiling's gate: each case's tiles, cadence and geometry, and its
    # whole grid
    gate_tilings = []
    for n, shape, tiles, nf in HOST_TILE_GATE:
        p = allp[n]
        if tiles == "auto":
            nf, tiles = host_tile.choose_sweeps_per_pass(p, shape, None,
                                                         HOST_TILE_GATE_BUDGET)
        geo = host_tile.plan_host_tiling(p, shape, tiles, nf)
        gate_tilings.append((tiles, geo))
        win = tuple(min(e, d) for e, d in zip(geo[2], shape))
        add_jobs(p, win, iterate=None if geo[4] == max(p.iterate, 1) else geo[4])
        add_jobs(p, shape)
    # host tiling over a mesh: the shards' plans of a tile at both cadences
    n, shape, msizes, budget = HOST_TILED_MESH
    cards = torch.cuda.device_count()
    tiled_mesh = mesh.make_mesh(msizes, None, [torch.device("cuda", i % cards)
                                               for i in range(math.prod(msizes))])
    tiled_mesh_geo = host_tile.plan_host_tiling(
        allp[n], shape, host_tile.choose_host_tiles(allp[n], shape, budget,
                                                    mesh_shape=msizes))
    tiled_mesh_win = tuple(min(e, d) for e, d in zip(tiled_mesh_geo[2], shape))
    for cadence in (1, None):
        for pl in mesh.build_sharded_fn(
                allp[n], tiled_mesh, grid_shape=tiled_mesh_win,
                iterate=tiled_mesh_geo[4], sweeps_per_exchange=cadence).local_plans().values():
            add_plan(allp[n], pl)
    add_jobs(allp[n], shape)
    # the mesh's shards (phase 17): each run's local plans, and the whole grid
    mesh_fns = {}
    for row, n, shape, sizes, names, dims, runs in MESH_ROWS:
        on_card = mesh.make_mesh(sizes, names, [dev] * math.prod(sizes))
        for i, (cadence, overlap, _) in enumerate(runs):
            mesh_fns[(row, i)] = fn = mesh.build_sharded_fn(
                allp[n], on_card, grid_shape=shape, dims=dims,
                sweeps_per_exchange=cadence, overlap=overlap)
            for pl in fn.local_plans().values():
                add_plan(allp[n], pl)
        # two resident calls are held against run_sharded at twice the
        # sweeps, one sweep an exchange
        it = max(allp[n].iterate, 1)
        for pl in mesh.build_sharded_fn(allp[n], on_card, grid_shape=shape, dims=dims,
                                        iterate=2 * it, sweeps_per_exchange=1
                                        ).local_plans().values():
            add_plan(allp[n], pl)
        add_jobs(allp[n], shape)
    # the CLI's host tiles over a mesh of cuda:0 (phase 16): the shards of a tile
    n, shape, tiles, spec = CLI_HOST_TILED_MESH
    geo = host_tile.plan_host_tiling(allp[n], shape, tiles)
    sizes, names, links = sodac._parse_mesh(spec)
    for pl in mesh.build_sharded_fn(
            allp[n], mesh.make_mesh(sizes, names, [dev] * math.prod(sizes)),
            grid_shape=tuple(min(e, d) for e, d in zip(geo[2], shape)), iterate=geo[4],
            link_classes=links).local_plans().values():
        add_plan(allp[n], pl)
    gauss_cli = rewritten["gauss5x5"]
    add_jobs(gauss_cli, sodac._grid_shape(gauss_cli, sodac.make_parser().parse_args(
        [str(CORPUS / "gauss5x5.soda")])))
    # wide integers (phase 18): every uint64 row at size and cut to the
    # oracle's cells, the mesh's shards, the host tiles and their whole grid
    u64p = {n: parse(s) for n, s in U64_SOURCES.items()}
    for n, shape, _ in U64_ROWS:
        add_jobs(u64p[n], shape)
        add_jobs(u64p[n], oracle_shape(shape))
    n, shape, sizes = U64_MESH
    u64_mesh_fn = mesh.build_sharded_fn(
        u64p[n], mesh.make_mesh(sizes, None, [dev] * math.prod(sizes)),
        grid_shape=shape, dims=(0,))
    for pl in u64_mesh_fn.local_plans().values():
        add_plan(u64p[n], pl)
    n, shape, budget = U64_HOST_TILED
    u64_tiling = host_tile.plan_host_tiling(
        u64p[n], shape, host_tile.choose_host_tiles(u64p[n], shape, budget, 1), 1)
    add_jobs(u64p[n], u64_tiling[2])
    add_jobs(u64p[n], shape)
    # the entry points (phase 20): entry()'s sweep, and each dry run's shards
    # and whole grid
    add_jobs(programs["jacobi3d"], entry_points.ENTRY_GRID, iterate=1)
    for n_dev in DRYRUN_DEVICES:
        for cfg in entry_points.dryrun_configs(n_dev):
            q = cfg["program"]
            for pl in mesh.build_sharded_fn(
                    q, mesh.make_mesh(cfg["sizes"], cfg["names"], [dev] * n_dev),
                    grid_shape=cfg["grid"], dims=cfg["dims"],
                    iterate=entry_points.DRYRUN_ITERATE,
                    sweeps_per_exchange=1).local_plans().values():
                add_plan(q, pl)
            add_jobs(q, cfg["grid"], iterate=entry_points.DRYRUN_ITERATE)
    # the fuzz phase (19): every program's plan, and a mesh seed's shards
    fuzz = fuzz_cases(dev)
    for c in fuzz:
        add_plan(c["program"], c["plan"])
        if c["mesh"]:
            for pl in c["mesh"][1].local_plans().values():
                add_plan(c["program"], pl)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=min(len(jobs), 32)) as pool:
        built = list(pool.map(lambda k: (k, k.build()), jobs.values()))
    wall = time.perf_counter() - t0
    for k, b in built:
        ptxas = [ln.strip() for ln in b.log.splitlines()
                 if re.search(r"registers|spill|smem", ln)]
        g = k.group
        cta = (f"block {g.block}" if g.kernel == "windows"
               else f"tile {g.tile}, chunk {g.bz}")
        log(f"build {b.path.name}: {b.seconds:.1f} s ({cta}, smem {g.smem_bytes} B)")
        for ln in ptxas:
            log(f"  {ln}")
    log(f"build: {len(built)} kernels in {wall:.1f} s wall")
    build_seconds = {k.source: b.seconds for k, b in built}

    mark(2)

    # ---- 3. small grids: kernel vs plain on the card vs oracle ---------------
    failures = []
    for n, p in programs.items():
        for shape in SMALL_SHAPES:
            ins, ps = rand_inputs(p, shape, np.random.default_rng(0))
            the_plan = plan(p, shape)
            cuda.reset_launches()
            got = cuda.run(p, ins, ps, device=dev)
            torch.cuda.synchronize()
            launched = sum(cuda.launch_counts().values())
            want = len(the_plan.groups) * max(p.iterate, 1) // the_plan.groups[0].sweeps
            plain = eager.run(p, ins, ps, device=dev)
            got_np, plain_np = to_numpy(p, got), to_numpy(p, plain)
            ok_plain = compare_outputs(p, got_np, plain_np, 0)
            ok_oracle = compare_outputs(p, got_np, oracle(p, ins, ps), 0)
            err = max_abs_err(got, plain)
            ok = ok_plain and ok_oracle and launched == want
            log(f"small {n} {shape}: launches {launched}/{want}, max|kernel-plain| "
                f"{err:.3g}, plain {'ok' if ok_plain else 'MISMATCH'}, oracle "
                f"{'ok' if ok_oracle else 'MISMATCH'}")
            if not ok:
                failures.append(f"{n} {shape}")
    for n in PINNED_3D_PROGRAMS:
        p = programs[n]
        libm = p.uses_libm_transcendentals()
        for shape in SMALL_SHAPES[:2]:
            ins, ps = rand_inputs(p, shape, np.random.default_rng(0))
            ref = cuda.run(p, ins, ps, device=dev)
            plain = eager.run(p, ins, ps, device=dev)
            for kw in PINNED_3D:
                the_plan = pinned_plan(p, shape, kw)
                cuda.reset_launches()
                got = cuda.run(p, ins, ps, device=dev, the_plan=the_plan)
                torch.cuda.synchronize()
                launched = cuda.launch_counts()["linebuffer3d"]
                ok_ref = bitwise_equal(got, ref)
                ok_plain = device_gate(p, got, plain, not libm)
                ok = (launched == len(the_plan.groups) and ok_ref and ok_plain
                      and {g.kernel for g in the_plan.groups} == {"linebuffer3d"}
                      and the_plan.groups[0].sync == kw.get("sync", "skew"))
                log(f"pinned {n} {shape} {kw}: {the_plan.groups[0].describe()}; ring "
                    f"depths {[r.depth for r in the_plan.groups[0].rings]}; launches "
                    f"{launched}, planner's kernel {'bit for bit' if ok_ref else 'MISMATCH'}, "
                    f"plain {'ok' if ok_plain else 'MISMATCH'}{'' if libm else ' (bit for bit)'}")
                if not ok:
                    failures.append(f"pinned {n} {shape} {kw}")
    if failures:
        log(f"FAILED small-grid checks: {failures}")
        return 1

    mark(3)

    # ---- 4. main path at full size --------------------------------------------
    summary = {}
    gen = torch.Generator(device=dev).manual_seed(0)
    for n, shape in AT_SIZE:
        p = programs[n]
        ins = {}
        for i in p.input_names:
            dt = {32: torch.float32, 64: torch.float64}[p.tensors[i].type.width]
            ins[i] = torch.randn(shape, generator=gen, device=dev, dtype=dt)
        ins, pars = to_torch(p, ins, {}, dev)
        # one sweep per call: kernel 1's rows (heat3d as chained calls)
        fn = cuda.build_fn(p, grid_shape=shape, sweeps=1)
        if n == "jacobi3d":
            cuda.reset_launches()
            got = cuda.run(p, ins, {}, device=dev)
            torch.cuda.synchronize()
            launches = cuda.launch_counts()["linebuffer3d"]
        else:
            got = fn(ins, pars)
            launches = None
        plain = eager.run(p, ins, {}, device=dev)
        err = max_abs_err(got, plain)
        # f64 and multi-stage f32 chains: relative gate of compare_outputs
        ok = compare_outputs(p, to_numpy(p, got), to_numpy(p, plain), 0)
        if n == "jacobi3d":
            ok = ok and err <= KERNEL_TOL and launches >= 1
        kept = got if n == "jacobi3d" else None
        del got, plain
        torch.cuda.empty_cache()

        def run_kernel():
            fn(ins, pars)

        def run_plain():
            eager.run(p, ins, {}, device=dev)

        run_kernel(), run_plain()
        torch.cuda.synchronize()
        reps = 20 if n == "jacobi3d" else 5
        t = [events_ms(run_plain, reps), events_ms(run_kernel, reps),
             events_ms(run_kernel, reps), events_ms(run_plain, reps)]
        calls = max(p.iterate, 1)
        k_ms, p_ms = (t[1] + t[2]) / 2 / calls, (t[0] + t[3]) / 2 / calls
        rep = report.analyze(fn.plan)
        r = report.rates(rep, k_ms / 1e3, card)
        g = fn.plan.groups[0]
        log(f"at-size {n} {shape}: max|kernel-plain| {err:.3g} "
            f"({'ok' if ok else 'MISMATCH'}); ms/sweep kernel {k_ms:.4f} "
            f"[{t[1]:.4f}, {t[2]:.4f}]/{calls} plain {p_ms:.4f} "
            f"[{t[0]:.4f}, {t[3]:.4f}]/{calls}; bound {rep.bound_ms:.4f}; "
            f"{r['achieved_gbps_at_ideal_bytes']:.1f} "
            f"GB/s at {rep.ideal_bytes_per_cell:g} B/cell = "
            f"{100 * r['share_of_3350_gbps']:.1f}% of 3.35 TB/s; plan "
            f"{rep.plan_bytes_per_cell:.3f} B/cell; {g.describe()}; "
            f"{ptxas_registers(cuda.group_kernel(p, g).build().log)}; card {card}")
        if not ok:
            log(f"FAILED at-size check: {n} {shape}")
            return 1
        lib_ms = None
        if n == "jacobi3d":
            # where the time goes: host enqueue per call vs device kernel time
            t0 = time.perf_counter()
            for _ in range(reps):
                run_kernel()
            host_ms = (time.perf_counter() - t0) / reps * 1e3
            torch.cuda.synchronize()
            dev_ms = device_ms(run_kernel, reps)
            alone_512 = dev_ms
            log(f"at-size {n} {shape}: host {host_ms:.4f} ms per call "
                f"(enqueue, no sync); device time of the kernel alone "
                f"{fmt(dev_ms)} ms per sweep")
            # the library yardstick: one 3-D convolution with the 7 taps
            w = torch.zeros((1, 1, 3, 3, 3), device=dev)
            c = float(np.float32(0.142857))
            for dz, dy, dx in [(1, 1, 1), (1, 1, 2), (1, 1, 0), (1, 2, 1),
                               (1, 0, 1), (2, 1, 1), (0, 1, 1)]:
                w[0, 0, dz, dy, dx] = c
            x5 = ins["t0"][None, None]

            def run_library():
                return F.conv3d(x5, w, padding=1)

            lib_err = float((run_library()[0, 0] - kept["t1"]).abs().max())
            lib_ms = (events_ms(run_library, reps) + events_ms(run_library, reps)) / 2
            log(f"at-size {n} {shape}: library F.conv3d (TF32 off) {lib_ms:.4f} ms, "
                f"max|library-kernel| {lib_err:.3g}")
            if lib_err > LIBRARY_TOL:
                log(f"FAILED library check: {n} {shape}")
                return 1
            del kept, x5
        summary[n] = dict(err=err, ms=k_ms, plain_ms=p_ms, launches=launches,
                          bound_ms=rep.bound_ms, bound_by=rep.bound_by,
                          library_ms=lib_ms)
        del ins, pars, fn
        torch.cuda.empty_cache()

    # the column z-march at the benchmark's size: one launch of it through
    # build_fn with the counters just reset, the whole grid bit for bit
    # against the plain version, then both timed in turns
    n, shape = ZMARCH
    p = programs[n]
    ins = {i: torch.rand(shape, generator=gen, device=dev) for i in p.input_names}
    fn = cuda.build_fn(p, grid_shape=shape, sweeps=1)
    cuda.reset_launches()
    got = fn(ins, {})
    torch.cuda.synchronize()
    launched, marches, stages = cuda.launch_counts(), cuda.march_counts(), cuda.stage_count()
    plain = eager.run(p, ins, {}, device=dev)
    err, exact = max_abs_err(got, plain), bitwise_equal(got, plain)
    ok = (exact and stages == 3 and marches["columns3d"] == sum(marches.values()) == 1
          and launched["linebuffer3d"] == sum(launched.values()) == 1)
    del got, plain
    torch.cuda.empty_cache()

    def run_kernel():
        fn(ins, {})

    def run_plain():
        eager.run(p, ins, {}, device=dev)

    run_kernel(), run_plain()
    torch.cuda.synchronize()
    t = [events_ms(run_plain, 5), events_ms(run_kernel, 10),
         events_ms(run_kernel, 10), events_ms(run_plain, 5)]
    k_ms, p_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    rep = report.analyze(fn.plan)
    g = fn.plan.groups[0]
    log(f"at-size {n} {shape} column z-march: launches {launched}, marches {marches}, "
        f"stages {stages}; max|kernel-plain| {err:.3g} on the whole grid "
        f"({'bit for bit' if exact else 'not bit for bit'}; {'ok' if ok else 'MISMATCH'}); "
        f"ms kernel {k_ms:.4f} [{t[1]:.4f}, {t[2]:.4f}] plain {p_ms:.4f} "
        f"[{t[0]:.4f}, {t[3]:.4f}]; bound {rep.bound_ms:.4f} ({rep.bound_by}), "
        f"{100 * rep.bound_ms / k_ms:.1f}% of it; plan {rep.plan_bytes_per_cell:.3f} "
        f"B/cell; {g.describe()}; {ptxas_registers(cuda.group_kernel(p, g).build().log)}; "
        f"card {card}")
    if not ok:
        log(f"FAILED at-size check: {n} {shape} column z-march")
        return 1
    zmarch = dict(err=err, ms=k_ms, plain_ms=p_ms, launches=marches["columns3d"],
                  bound_ms=rep.bound_ms, bound_by=rep.bound_by)
    del ins, fn
    torch.cuda.empty_cache()

    # grids no tile divides: kernel 1 once with its counter just reset, the
    # whole grid against the plain version, then alone beside 512^3
    for n, shape in AT_SIZE_ODD:
        p = programs[n]
        x = {"t0": torch.randn(shape, generator=gen, device=dev)}
        fn = cuda.build_fn(p, grid_shape=shape, sweeps=1)
        cuda.reset_launches()
        got = fn(x, {})
        torch.cuda.synchronize()
        launched = cuda.launch_counts()
        plain = eager.run(p, x, {}, device=dev)
        err, exact = max_abs_err(got, plain), bitwise_equal(got, plain)
        del got, plain
        fn(x, {})
        alone = device_ms(lambda: fn(x, {}), 10)
        rep = report.analyze(fn.plan)
        g = fn.plan.groups[0]
        ok = launched["linebuffer3d"] == sum(launched.values()) == 1 and err <= KERNEL_TOL
        log(f"at-size {n} {shape}: rows of {4 * shape[-1]} B, load {g.load}; launches "
            f"{launched}; max|kernel-plain| {err:.3g} on the whole grid "
            f"({'bit for bit' if exact else 'not bit for bit'}; "
            f"{'ok' if ok else 'MISMATCH'}); alone {fmt(alone)} ms / bound "
            f"{rep.bound_ms:.4f}"
            f"{f' ({100 * rep.bound_ms / alone:.1f}%)' if alone else ''}, 512^3 alone "
            f"{fmt(alone_512)}; {g.describe()}; "
            f"{ptxas_registers(cuda.group_kernel(p, g).build().log)}; card {card}")
        if not ok:
            log(f"FAILED at-size check: {n} {shape}")
            return 1
        del x, fn
        torch.cuda.empty_cache()

    n, shape = BIG
    free, _ = torch.cuda.mem_get_info(dev)
    if free >= 48 * 2**30:
        p = programs[n]
        x = torch.randn(shape, generator=gen, device=dev)
        got = cuda.run(p, {"t0": x}, {}, device=dev)
        err = max_abs_err(got, eager.run(p, {"t0": x}, {}, device=dev))
        # timed once the 4 GiB output's block is back in the allocator's
        # cache: a fresh one would time cudaMalloc, not the kernel
        del got
        fn = cuda.build_fn(p, grid_shape=shape)
        fn({"t0": x}, {})
        t = device_ms(lambda: fn({"t0": x}, {}), 3)
        log(f"at-size {n} {shape}: max|kernel-plain| {err:.3g}; kernel alone "
            f"{fmt(t)} ms/sweep; card {card}")
        if err > KERNEL_TOL:
            log(f"FAILED at-size check: {n} {shape}")
            return 1
        del fn, x
        torch.cuda.empty_cache()
    else:
        log(f"at-size {n} {shape}: skipped, {free / 2**30:.1f} GiB free")

    mark(4)

    # ---- 5. small grids, rank 2: kernel 2 vs plain on the card vs oracle -----
    for n, p in programs2.items():
        exact = any(t.type.is_float and t.type.width == 16 for t in p.tensors.values())
        for shape in SMALL_SHAPES_2D:
            ins, ps = rand_inputs(p, shape, np.random.default_rng(0))
            the_plan = plan(p, shape)
            cuda.reset_launches()
            got = cuda.run(p, ins, ps)
            torch.cuda.synchronize()
            launched = sum(cuda.launch_counts().values())
            want = len(the_plan.groups) * max(p.iterate, 1) // the_plan.groups[0].sweeps
            plain = eager.run(p, ins, ps)
            ok_plain = device_gate(p, got, plain, exact)
            ok_oracle = compare_outputs(p, to_numpy(p, got), oracle(p, ins, ps), 0)
            err = max_abs_err(got, plain)
            ok = ok_plain and ok_oracle and launched == want
            log(f"small {n} {shape}: {len(the_plan.groups)} group(s), launches "
                f"{launched}/{want}, max|kernel-plain| {err:.3g}, plain "
                f"{'ok' if ok_plain else 'MISMATCH'}"
                f"{' (bit for bit)' if exact else ''}, oracle "
                f"{'ok' if ok_oracle else 'MISMATCH'}")
            if not ok:
                failures.append(f"{n} {shape}")
    for n in PINNED_2D_PROGRAMS:
        p = programs2[n]
        libm = p.uses_libm_transcendentals()
        for shape in SMALL_SHAPES_2D[:2]:
            ins, ps = rand_inputs(p, shape, np.random.default_rng(0))
            ref = cuda.run(p, ins, ps)
            plain = eager.run(p, ins, ps)
            for kw in PINNED_2D:
                the_plan = pinned_plan(p, shape, kw)
                cuda.reset_launches()
                got = cuda.run(p, ins, ps, the_plan=the_plan)
                torch.cuda.synchronize()
                launched = cuda.launch_counts()["linebuffer2d"]
                ok_ref = bitwise_equal(got, ref)
                ok_plain = device_gate(p, got, plain, not libm)
                ok = (launched == len(the_plan.groups) and ok_ref and ok_plain
                      and {g.kernel for g in the_plan.groups} == {"linebuffer2d"}
                      and the_plan.groups[0].sync == kw.get("sync", "skew"))
                log(f"pinned {n} {shape} {kw}: {the_plan.groups[0].describe()}; "
                    f"launches {launched}, planner's kernel "
                    f"{'bit for bit' if ok_ref else 'MISMATCH'}, plain "
                    f"{'ok' if ok_plain else 'MISMATCH'}{'' if libm else ' (bit for bit)'}")
                if not ok:
                    failures.append(f"pinned {n} {shape} {kw}")
    if failures:
        log(f"FAILED rank-2 small-grid checks: {failures}")
        return 1

    mark(5)

    # ---- 6. the CLI, on the card by default ------------------------------------
    cuda.reset_launches()
    rc = sodac.main([str(CORPUS / "blur.soda"), "--grid-shape", "2048,4096", "--run"])
    torch.cuda.synchronize()
    launched = cuda.launch_counts()["linebuffer2d"]
    log(f"cli: sodac blur.soda --grid-shape 2048,4096 --run (no --device): rc {rc}, "
        f"kernel-2 launches {launched}")
    if rc != 0 or launched < 1:
        log("FAILED cli check")
        return 1

    mark(6)

    # ---- 7. kernel 2 at full size ---------------------------------------------
    summary2 = {}
    for n, shape in AT_SIZE_2D:
        p = programs2[n]
        exact = all(not t.type.is_float for t in p.tensors.values())
        params = {pp.name: np.random.default_rng(1).standard_normal(pp.shape).astype(
            pp.type.np_dtype()) for pp in p.params.values()}
        ins, pars = to_torch(p, device_inputs(p, shape, gen, dev), params, dev)
        # one sweep per call: kernel 2's rows (jacobi2d as chained calls)
        fn = cuda.build_fn(p, grid_shape=shape, sweeps=1)
        main_path = (n, shape) == MAIN_2D
        if main_path:
            cuda.reset_launches()
            got = cuda.run(p, ins, pars, sweeps=1)
            torch.cuda.synchronize()
            launches = cuda.launch_counts()["linebuffer2d"]
        else:
            got = fn(ins, pars)
            launches = None
        plain = eager.run(p, ins, pars)
        err = max_abs_err(got, plain)
        ok = device_gate(p, got, plain, exact)
        if main_path:
            ok = ok and launches == len(fn.plan.groups)
        del plain
        torch.cuda.empty_cache()

        def run_kernel():
            fn(ins, pars)

        def run_plain():
            eager.run(p, ins, pars)

        run_kernel(), run_plain()
        torch.cuda.synchronize()
        big = shape[0] * shape[1] > 2**26
        reps = 5 if big else 20
        t = [events_ms(run_plain, reps), events_ms(run_kernel, reps),
             events_ms(run_kernel, reps), events_ms(run_plain, reps)]
        calls = max(p.iterate, 1)
        k_ms, p_ms = (t[1] + t[2]) / 2 / calls, (t[0] + t[3]) / 2 / calls
        dev_ms = device_ms(run_kernel, reps)
        dev_ms = None if dev_ms is None else dev_ms / calls
        rep = report.analyze(fn.plan)
        r = report.rates(rep, k_ms / 1e3, card)
        log(f"at-size {n} {shape}: {len(fn.plan.groups)} group(s) x {calls} sweep(s); "
            f"max|kernel-plain| {err:.3g} ({'ok' if ok else 'MISMATCH'}"
            f"{', bit for bit' if exact else ''}); ms/sweep kernel {k_ms:.4f} "
            f"[{t[1]:.4f}, {t[2]:.4f}]/{calls} (kernel alone "
            f"{fmt(dev_ms)}) plain {p_ms:.4f} [{t[0]:.4f}, {t[3]:.4f}]/{calls}; "
            f"bound {rep.bound_ms:.4f}; {r['achieved_gbps_at_ideal_bytes']:.1f} GB/s at "
            f"{rep.ideal_bytes_per_cell:g} B/cell = "
            f"{100 * r['share_of_3350_gbps']:.1f}% of 3.35 TB/s; plan "
            f"{rep.plan_bytes_per_cell:.3f} B/cell; {fn.plan.groups[0].describe()}; "
            f"card {card}")
        if not ok:
            log(f"FAILED at-size check: {n} {shape}")
            return 1
        lib_ms = None
        if n == "conv5x5":
            x4 = ins["src"][None, None]
            w = pars["coef"][None, None]

            def run_library():
                return F.conv2d(x4, w, padding=2)

            lib = run_library()[0, 0]
            lib_ok = torch.allclose(lib, got["dst"], rtol=LIBRARY_TOL, atol=LIBRARY_TOL)
            lib_err = float((lib - got["dst"]).abs().max())
            del lib
            lib_ms = (events_ms(run_library, reps) + events_ms(run_library, reps)) / 2
            log(f"at-size {n} {shape}: library F.conv2d (TF32 off) {lib_ms:.4f} ms, "
                f"max|library-kernel| {lib_err:.3g}")
            if not lib_ok:
                log(f"FAILED library check: {n} {shape}")
                return 1
            del x4
        elif n == "blur":
            log(f"at-size {n} {shape}: library none (no one PyTorch call computes "
                f"a uint16 divide-by-3 stencil)")
        summary2[(n, shape)] = dict(err=err, ms=k_ms, plain_ms=p_ms, dev_ms=dev_ms,
                                    launches=launches, bound_ms=rep.bound_ms,
                                    bound_by=rep.bound_by, library_ms=lib_ms)
        del got, ins, pars, fn
        torch.cuda.empty_cache()

    mark(7)

    # ---- 8. small grids, fused sweeps: fused vs chained vs plain vs oracle ----
    for (n, shape), depths in small_depths.items():
        p = allp[n]
        it = max(p.iterate, 1)
        ins, ps = rand_inputs(p, shape, np.random.default_rng(0))
        chained = cuda.run(p, ins, ps, sweeps=1)
        plain = eager.run(p, ins, ps)
        gold = oracle(p, ins, ps)
        for d in depths:
            the_plan = plan(p, shape, sweeps=d)
            nf = the_plan.groups[0].sweeps
            cuda.reset_launches()
            got = cuda.run(p, ins, ps, sweeps=d)
            torch.cuda.synchronize()
            launched = cuda.launch_counts()["sweeps"]
            want = len(the_plan.groups) * it // nf
            ok_bits = bitwise_equal(got, chained)
            ok_plain = device_gate(p, got, plain, False)
            ok_oracle = compare_outputs(p, to_numpy(p, got), gold, 0)
            ok = nf > 1 and launched == want and ok_bits and ok_plain and ok_oracle
            log(f"fused small {n} {shape} nf {nf}: launches {launched}/{want}, "
                f"chained {'bit for bit' if ok_bits else 'MISMATCH'}, max|fused-plain| "
                f"{max_abs_err(got, plain):.3g} plain {'ok' if ok_plain else 'MISMATCH'}, "
                f"oracle {'ok' if ok_oracle else 'MISMATCH'}")
            if not ok:
                failures.append(f"fused {n} {shape} nf {d}")
        if n in PINNED_SWEEPS_PROGRAMS and shape in SMALL_SHAPES_2D[:2]:
            for kw in PINNED_SWEEPS:
                the_plan = pinned_plan(p, shape, dict(kw, sweeps=it))
                g = the_plan.groups[0]
                cuda.reset_launches()
                got = cuda.run(p, ins, ps, the_plan=the_plan)
                torch.cuda.synchronize()
                launched = cuda.launch_counts()["sweeps"]
                ok_bits = bitwise_equal(got, chained)
                ok = (g.sweeps == it and launched == 1 and ok_bits
                      and g.sync == kw.get("sync", "skew")
                      and device_gate(p, got, plain, False))
                log(f"fused pinned {n} {shape} nf {g.sweeps} {kw}: {g.describe()}; "
                    f"warm-up {g.warm} rows, launches {launched}, chained "
                    f"{'bit for bit' if ok_bits else 'MISMATCH'}")
                if not ok:
                    failures.append(f"fused pinned {n} {shape} {kw}")
    if failures:
        log(f"FAILED fused small-grid checks: {failures}")
        return 1

    mark(8)

    # ---- 9. fused sweeps at size: fused vs chained vs plain, timed ------------
    summary3 = {}
    # the NumPy oracles (about 40 s of host work) run in threads beside the
    # next row's checks, and are waited for before its timing starts: no
    # host thread competes with the one that enqueues the timed calls.  The
    # main path's, 1 s, runs before its own row is timed
    oracles9 = concurrent.futures.ThreadPoolExecutor(max_workers=4)
    pending9 = []    # (row, program, the result's host arrays, the oracle's future, begun)
    for n, shape in AT_SIZE_SWEEPS:
        p = allp[n]
        it = max(p.iterate, 1)
        ins = device_inputs(p, shape, gen, dev)
        fused = cuda.build_fn(p, grid_shape=shape)
        chained = cuda.build_fn(p, grid_shape=shape, sweeps=1)
        nf = fused.plan.groups[0].sweeps
        main_path = (n, shape) == MAIN_SWEEPS
        if main_path:
            cuda.reset_launches()
            got = cuda.run(p, ins, {})
            torch.cuda.synchronize()
            launches = cuda.launch_counts()["sweeps"]
        else:
            got = fused(ins, {})
            launches = None
        ok_bits = bitwise_equal(got, chained(ins, {}))
        plain = eager.run(p, ins, {})
        err = max_abs_err(got, plain)
        ok_plain = device_gate(p, got, plain, False)
        del plain
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ok_oracle, oracle_s, later = True, None, None
        if math.prod(shape) <= ORACLE_MAX_CELLS:
            host_ins = {k: v.cpu().numpy() for k, v in ins.items()}
            if main_path:
                ok_oracle = compare_outputs(p, to_numpy(p, got), oracle(p, host_ins, {}), 0)
                oracle_s = time.perf_counter() - t0
            else:
                later = (f"{n} {shape}", p, to_numpy(p, got), host_ins, t0)
        ok = nf > 1 and ok_bits and ok_plain and ok_oracle
        if main_path:
            ok = ok and launches == it // nf
            kept = got["t1"]
        del got

        def run_fused():
            fused(ins, {})

        def run_chained():
            chained(ins, {})

        def run_plain():
            eager.run(p, ins, {})

        concurrent.futures.wait([row[3] for row in pending9])
        run_fused(), run_chained(), run_plain()
        torch.cuda.synchronize()
        big = math.prod(shape) > 2**26
        reps = 2 if big else 10
        t = [events_ms(f, reps) for f in (run_fused, run_chained, run_plain,
                                          run_plain, run_chained, run_fused)]
        f_ms, c_ms, p_ms = ((t[0] + t[5]) / 2 / it, (t[1] + t[4]) / 2 / it,
                            (t[2] + t[3]) / 2 / it)
        dev_ms, dev_c = device_ms(run_fused, reps), device_ms(run_chained, reps)
        dev_ms = None if dev_ms is None else dev_ms / it
        dev_c = None if dev_c is None else dev_c / it
        rep = report.analyze(fused.plan)
        r = report.rates(rep, f_ms * nf / 1e3, card)
        log(f"fused at-size {n} {shape}: iterate {it}, nf {nf}, {it // nf} call(s)"
            f"{f', launches {launches}' if main_path else ''}; chained "
            f"{'bit for bit' if ok_bits else 'MISMATCH'}, max|fused-plain| {err:.3g} "
            f"plain {'ok' if ok_plain else 'MISMATCH'}, oracle "
            + ("not run (past 2^26 cells); " if math.prod(shape) > ORACLE_MAX_CELLS
               else "checked below; " if oracle_s is None
               else f"{'ok' if ok_oracle else 'MISMATCH'} ({oracle_s:.1f} s on the host); ")
            + f"ms/sweep fused {f_ms:.4f} [{t[0]:.4f}, {t[5]:.4f}]/{it} (kernel alone "
            f"{fmt(dev_ms)}) chained {c_ms:.4f} [{t[1]:.4f}, {t[4]:.4f}]/{it} (kernels "
            f"alone {fmt(dev_c)}) "
            f"plain {p_ms:.4f} [{t[2]:.4f}, {t[3]:.4f}]/{it}; bound per call "
            f"{rep.bound_ms:.4f} ({rep.bound_by}; {rep.bound_ms / nf:.4f} per sweep, "
            f"program {rep.program_bound_ms:.4f}); {100 * r['share_of_bound']:.1f}% "
            f"of the bound; plan {rep.plan_bytes_per_cell_update:.3f} B/cell-update; "
            f"{fused.plan.groups[0].describe()}; "
            f"{ptxas_registers(cuda.group_kernel(p, fused.plan.groups[0]).build().log)}; "
            f"card {card}")
        if not ok:
            log(f"FAILED fused at-size check: {n} {shape}")
            return 1
        if later:
            what, q, got_np, host_ins, begun = later
            pending9.append((what, q, got_np, oracles9.submit(oracle, q, host_ins, {}), begun))
        lib_ms = None
        if main_path:
            # the library yardstick: `it` chained 3x3 F.conv2d (the five
            # taps, zero corners, padding 1: zero outside the grid)
            w = torch.zeros((1, 1, 3, 3), device=dev)
            for dy, dx in ((1, 1), (1, 2), (2, 1), (1, 0), (0, 1)):
                w[0, 0, dy, dx] = float(np.float32(0.2))
            x4 = ins["t0"][None, None]

            def run_library():
                y = x4
                for _ in range(it):
                    y = F.conv2d(y, w, padding=1)
                return y

            lib_err = float((run_library()[0, 0] - kept).abs().max())
            lib_ms = (events_ms(run_library, reps) + events_ms(run_library, reps)) / 2 / it
            log(f"fused at-size {n} {shape}: library {it} chained F.conv2d (TF32 off) "
                f"{lib_ms:.4f} ms/sweep against the fused kernel's {f_ms:.4f}, "
                f"max|library-kernel| {lib_err:.3g}; card {card}")
            if lib_err > LIBRARY_TOL:
                log(f"FAILED library check: {n} {shape}")
                return 1
            del kept, x4
        summary3[(n, shape)] = dict(err=err, ms=f_ms, chained_ms=c_ms, plain_ms=p_ms,
                                    dev_ms=dev_ms, chained_dev_ms=dev_c, launches=launches,
                                    bound_ms=rep.bound_ms / nf, bound_by=rep.bound_by,
                                    library_ms=lib_ms)
        del ins, fused, chained
        torch.cuda.empty_cache()
    with oracles9:
        for what, p, got_np, gold, t0 in pending9:
            ok = compare_outputs(p, got_np, gold.result(), 0)
            log(f"fused at-size oracle {what}: {'ok' if ok else 'MISMATCH'} on the whole grid "
                f"(done {time.perf_counter() - t0:.1f} s after its row began)")
            if not ok:
                log(f"FAILED fused at-size check: {what} against the oracle")
                return 1
    del pending9

    mark(9)

    # ---- 10. the depth sweep: ms per sweep at every depth that fits ----------
    for (n, shape), depths in sweep_depths.items():
        p = allp[n]
        it = max(p.iterate, 1)
        ins = device_inputs(p, shape, gen, dev)
        ref = cuda.build_fn(p, grid_shape=shape, sweeps=1)(ins, {})
        chosen = plan(p, shape).groups[0].sweeps
        measured = {}
        for d in depths:
            fn = cuda.build_fn(p, grid_shape=shape, sweeps=d)
            got = fn(ins, {})
            ok = bitwise_equal(got, ref)
            del got
            fn(ins, {})
            torch.cuda.synchronize()
            ms = (events_ms(lambda: fn(ins, {}), 2) + events_ms(lambda: fn(ins, {}), 2)) / 2 / it
            g = fn.plan.groups[0]
            measured[d] = ms
            shape_of = (f"tile {g.tile}, chunk {g.bz}, smem {g.smem_bytes} B, "
                        f"load {g.load}, sync {g.sync}, threads {g.threads}, CTAs/SM "
                        f"{linebuffer.min_blocks(g, g.threads)}"
                        + (f", waves {g.waves:.2f}" if g.kernel == "linebuffer2d" else "")
                        + f", {ptxas_registers(cuda.group_kernel(p, g).build().log)}")
            log(f"depth sweep {n} {shape} nf {d}: {ms:.4f} ms/sweep measured, "
                f"{g.modeled_seconds / d * 1e3:.4f} modeled; "
                f"{'bit for bit' if ok else 'MISMATCH'} vs chained; {shape_of}; "
                f"card {card}")
            if not ok:
                log(f"FAILED depth sweep: {n} {shape} nf {d}")
                return 1
        best = min(measured, key=measured.get)
        log(f"depth sweep {n} {shape}: fastest nf {best}, the planner chose nf "
            f"{chosen} ({measured[chosen] / measured[best]:.3f}x the fastest)")
        del ins, ref
        torch.cuda.empty_cache()

    mark(10)

    # ---- 11. small grids, the windows kernel: vs plain, oracle, line buffer --
    cases = [(p, shape, kw) for p in programs1.values() for shape in SMALL_SHAPES_1D
             for kw in ({}, {"block": SMALL_BLOCKS[1]})]
    cases += [(p, shape, {"block": SMALL_BLOCKS[p.rank]})
              for p in {**programs, **programs2}.values()
              for shape in (SMALL_SHAPES[1:] if p.rank == 3 else SMALL_SHAPES_2D[1:])]
    cases.append((star, STAR_SMALL, {}))
    for p, shape, kw in cases:
        the_plan = plan(p, shape, **kw)
        kinds = {g.kernel for g in the_plan.groups}
        ins, ps = rand_inputs(p, shape, np.random.default_rng(0))
        cuda.reset_launches()
        got = cuda.run(p, ins, ps, **kw)
        torch.cuda.synchronize()
        launched = cuda.launch_counts()["windows"]
        want = len(the_plan.groups) * max(p.iterate, 1)
        half = any(t.type.is_float and t.type.width == 16 for t in p.tensors.values())
        plain = eager.run(p, ins, ps)
        ok_plain = device_gate(p, got, plain, half)
        ok_oracle = compare_outputs(p, to_numpy(p, got), oracle(p, ins, ps), 0)
        libm = p.uses_libm_transcendentals()
        lb_kw = {"smem_budget": STAR_LB_BUDGET} if p is star else {"sweeps": 1}
        ok_lb = p.rank == 1 or libm or bitwise_equal(got, cuda.run(p, ins, ps, **lb_kw))
        ok = kinds == {"windows"} and launched == want and ok_plain and ok_oracle and ok_lb
        log(f"windows small {p.name} {shape} {kw or 'default'}: "
            f"{the_plan.groups[0].describe()}; launches {launched}/{want}, "
            f"max|kernel-plain| {max_abs_err(got, plain):.3g} plain "
            f"{'ok' if ok_plain else 'MISMATCH'}{' (bit for bit)' if half else ''}, "
            f"oracle {'ok' if ok_oracle else 'MISMATCH'}, line buffer "
            f"{'n/a' if p.rank == 1 or libm else 'bit for bit' if ok_lb else 'MISMATCH'}")
        if not ok:
            failures.append(f"windows {p.name} {shape} {kw}")
    if failures:
        log(f"FAILED windows small-grid checks: {failures}")
        return 1

    mark(11)

    # ---- 12. the windows kernel's main path at full size: smooth1d 2^28 -----
    n, shape = MAIN_WINDOWS
    p = allp[n]
    x = torch.randn(shape, generator=gen, device=dev)
    ins = {"w_in": x}
    fn = cuda.build_fn(p, grid_shape=shape)
    cuda.reset_launches()
    got = cuda.run(p, ins, {})
    torch.cuda.synchronize()
    launches = cuda.launch_counts()["windows"]
    plain = eager.run(p, ins, {})
    ok = bitwise_equal(got, plain) and launches == 1
    err = max_abs_err(got, plain)
    del plain
    torch.cuda.empty_cache()

    def run_kernel():
        fn(ins, {})

    def run_plain():
        eager.run(p, ins, {})

    run_kernel(), run_plain()
    torch.cuda.synchronize()
    t = [events_ms(run_plain, 5), events_ms(run_kernel, 20),
         events_ms(run_kernel, 20), events_ms(run_plain, 5)]
    k_ms, p_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    dev_ms = device_ms(run_kernel, 10)
    rep = report.analyze(fn.plan)
    r = report.rates(rep, k_ms / 1e3, card)
    w = torch.full((1, 1, 5), float(np.float32(0.2)), device=dev)
    x3 = x[None, None]

    def run_library():
        return F.conv1d(x3, w, padding=2)

    lib = run_library()[0, 0]
    lib_err = float((lib - got["w_out"]).abs().max())
    del lib
    lib_ms = (events_ms(run_library, 20) + events_ms(run_library, 20)) / 2
    log(f"windows main {n} {shape}: launches {launches}, max|kernel-plain| {err:.3g} "
        f"({'bit for bit' if ok else 'MISMATCH'}); ms kernel {k_ms:.4f} [{t[1]:.4f}, "
        f"{t[2]:.4f}] (alone {fmt(dev_ms)}) plain {p_ms:.4f} [{t[0]:.4f}, {t[3]:.4f}]; "
        f"bound {rep.bound_ms:.4f} ({rep.bound_by}); {r['achieved_gbps_at_ideal_bytes']:.1f} "
        f"GB/s at {rep.ideal_bytes_per_cell:g} B/cell = {100 * r['share_of_3350_gbps']:.1f}% "
        f"of 3.35 TB/s; library F.conv1d (TF32 off) {lib_ms:.4f} ms, max|library-kernel| "
        f"{lib_err:.3g}; {fn.plan.groups[0].describe()}; card {card}")
    if not ok or lib_err > LIBRARY_TOL:
        log(f"FAILED windows main path: {n} {shape}")
        return 1
    summary4 = dict(err=err, ms=k_ms, plain_ms=p_ms, dev_ms=dev_ms, launches=launches,
                    bound_ms=rep.bound_ms, bound_by=rep.bound_by, library_ms=lib_ms)
    del got, ins, x, x3, fn
    torch.cuda.empty_cache()

    mark(12)

    # ---- 13. the windows kernel on ranks 2 and 3 at size, beside the line buffer
    for n, shape, block in AT_SIZE_WINDOWS:
        p = allp[n]
        params = {pp.name: np.random.default_rng(1).standard_normal(pp.shape).astype(
            pp.type.np_dtype()) for pp in p.params.values()}
        ins, pars = to_torch(p, device_inputs(p, shape, gen, dev), params, dev)
        win = cuda.build_fn(p, grid_shape=shape, block=block)
        lb = cuda.build_fn(p, grid_shape=shape, sweeps=1,
                           **({"smem_budget": STAR_LB_BUDGET} if p is star else {}))
        got = win(ins, pars)
        exact = all(not t.type.is_float for t in p.tensors.values())
        plain = eager.run(p, ins, pars)
        err = max_abs_err(got, plain)
        ok_plain = device_gate(p, got, plain, exact)
        del plain
        torch.cuda.empty_cache()
        libm = p.uses_libm_transcendentals()
        ok_lb = libm or bitwise_equal(got, lb(ins, pars))
        ok = ({g.kernel for g in win.plan.groups} == {"windows"} and ok_plain and ok_lb
              and {g.kernel for g in lb.plan.groups} == {f"linebuffer{p.rank}d"})

        def run_win():
            win(ins, pars)

        def run_lb():
            lb(ins, pars)

        run_win(), run_lb()
        torch.cuda.synchronize()
        reps = 5 if math.prod(shape) > 2**26 else 20
        t = [events_ms(run_lb, reps), events_ms(run_win, reps),
             events_ms(run_win, reps), events_ms(run_lb, reps)]
        w_ms, l_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        w_dev, l_dev = device_ms(run_win, reps), device_ms(run_lb, reps)
        rep = report.analyze(win.plan)
        lib = ""
        if n == "conv5x5":
            x4, wt = ins["src"][None, None], pars["coef"][None, None]

            def run_library():
                return F.conv2d(x4, wt, padding=2)

            lib_ok = torch.allclose(run_library()[0, 0], got["dst"], rtol=LIBRARY_TOL,
                                    atol=LIBRARY_TOL)
            lib_ms = (events_ms(run_library, reps) + events_ms(run_library, reps)) / 2
            lib = f"; library F.conv2d (TF32 off) {lib_ms:.4f} ms"
            ok = ok and lib_ok
            del x4
        log(f"windows at-size {n} {shape}: max|kernel-plain| {err:.3g} plain "
            f"{'ok' if ok_plain else 'MISMATCH'}, line buffer "
            f"{'n/a (libm)' if libm else 'bit for bit' if ok_lb else 'MISMATCH'}; ms "
            f"windows {w_ms:.4f} [{t[1]:.4f}, {t[2]:.4f}] (alone {fmt(w_dev)}) line "
            f"buffer {l_ms:.4f} [{t[0]:.4f}, {t[3]:.4f}] (alone {fmt(l_dev)}); bound "
            f"{rep.bound_ms:.4f} ({rep.bound_by}); plan {rep.plan_bytes_per_cell:.3f} "
            f"B/cell{lib}; {win.plan.groups[0].describe()}; line buffer "
            f"{lb.plan.groups[0].describe()}; card {card}")
        if not ok:
            log(f"FAILED windows at-size check: {n} {shape}")
            return 1
        del got, ins, pars, win, lb
        torch.cuda.empty_cache()

    mark(13)

    # ---- 14. tcse: the rewritten programs through the kernels ---------------
    for n in TCSE_PROGRAMS:
        p, q = allp[n], rewritten[n]
        exact = not any(t.type.is_float for t in q.tensors.values())
        rim = q.valid_rim()
        for shape in TCSE_SHAPES:
            ins, ps = rand_inputs(p, shape, np.random.default_rng(0))
            pl = plan(q, shape)
            want = len(pl.groups) * max(q.iterate, 1) // pl.groups[0].sweeps
            cuda.reset_launches()
            got_q = cuda.run(q, ins, ps)
            torch.cuda.synchronize()
            launched = sum(cuda.launch_counts().values())
            got_p = cuda.run(p, ins, ps)
            ok_plain = device_gate(q, got_q, eager.run(q, ins, ps), exact)
            ok_q = compare_outputs(q, to_numpy(q, got_q), oracle(q, ins, ps), 0)
            ok_p = compare_outputs(p, to_numpy(p, got_p), oracle(p, ins, ps), 0)
            ok_rim = compare_outputs(p, to_numpy(q, got_q), to_numpy(p, got_p), rim)
            ok = launched == want and ok_plain and ok_q and ok_p and ok_rim
            log(f"tcse small {n} {shape}: {tcse.count_ops(p)} -> {tcse.count_ops(q)} "
                f"operations, stages {q.stage_order()}; launches {launched}/{want}, "
                f"plain {'ok' if ok_plain else 'MISMATCH'}"
                f"{' (bit for bit)' if exact else ''}, oracle of the rewritten "
                f"{'ok' if ok_q else 'MISMATCH'}, oracle of the original "
                f"{'ok' if ok_p else 'MISMATCH'}, original kernel outside the rim "
                f"{rim} {'ok' if ok_rim else 'MISMATCH'}")
            if not ok:
                failures.append(f"tcse {n} {shape}")
    if failures:
        log(f"FAILED tcse small-grid checks: {failures}")
        return 1
    n, shape = TCSE_MAIN
    p, q = allp[n], rewritten[n]
    ins = {"q_in": torch.randint(0, 1 << 16, shape, generator=gen, device=dev,
                                 dtype=torch.int32).to(torch.uint16)}
    fns = {"original": cuda.build_fn(p, grid_shape=shape),
           "tcse": cuda.build_fn(q, grid_shape=shape)}
    cuda.reset_launches()
    got = {k: fn(ins, {})["q_out"] for k, fn in fns.items()}
    torch.cuda.synchronize()
    launches = cuda.launch_counts()["linebuffer2d"]
    rim = q.valid_rim()
    inner = (slice(rim, -rim),) * 2
    ok_rim = torch.equal(got["original"][inner], got["tcse"][inner])
    plain = eager.run(q, ins, {})["q_out"]
    ok_plain = torch.equal(got["tcse"], plain)
    del plain, got
    torch.cuda.empty_cache()
    ok = ok_rim and ok_plain and launches == 2
    runs = {k: (lambda fn=fn: fn(ins, {})) for k, fn in fns.items()}
    t = [events_ms(runs[k], 10) for k in ("original", "tcse", "tcse", "original")]
    ms = {"original": (t[0] + t[3]) / 2, "tcse": (t[1] + t[2]) / 2}
    alone = {k: device_ms(f, 10) for k, f in runs.items()}
    for k, fn in fns.items():
        rep = report.analyze(fn.plan)
        g = fn.plan.groups[0]
        log(f"tcse at-size {n} {shape} {k}: {len(g.stages)} stage(s), "
            f"{fn.plan.ops_per_cell:g} typed operations a cell (plan), "
            f"{g.cell_ops_per_call / math.prod(shape):.2f} with the tile's overlap; "
            f"ms {ms[k]:.4f} (events, in turns; alone {fmt(alone[k])}); bound "
            f"{rep.bound_ms:.4f} ({rep.bound_by}), "
            f"{100 * rep.bound_ms / ms[k]:.1f}% of it; {g.describe()}; card {card}")
    log(f"tcse at-size {n} {shape}: launches {launches}/2, original vs rewritten "
        f"outside the rim {rim} {'bit for bit' if ok_rim else 'MISMATCH'}, rewritten "
        f"vs its plain version on the whole grid {'bit for bit' if ok_plain else 'MISMATCH'}; "
        f"rewritten/original time {ms['tcse'] / ms['original']:.3f}")
    if not ok:
        log(f"FAILED tcse at-size check: {n} {shape}")
        return 1
    del ins, fns, runs
    torch.cuda.empty_cache()

    mark(14)

    # ---- 15. host tiling: grids beyond the card's memory, tile by tile ----------
    pinned = torch.empty(PINNED_COPY_BYTES // 4, dtype=torch.float32, pin_memory=True)
    on_dev = torch.empty(PINNED_COPY_BYTES // 4, dtype=torch.float32, device=dev)
    bw = {}
    for way, (dst, src) in (("h2d", (on_dev, pinned)), ("d2h", (pinned, on_dev))):
        dst.copy_(src, non_blocking=True)
        bw[way] = PINNED_COPY_BYTES / (events_ms(lambda: dst.copy_(src, non_blocking=True), 5)
                                       / 1e3)
    log(f"host link: pinned {PINNED_COPY_BYTES} B copies, host to card "
        f"{bw['h2d'] / 1e9:.2f} GB/s, card to host {bw['d2h'] / 1e9:.2f} GB/s; card {card}")
    del pinned, on_dev
    for n, shape, _, budget in HOST_TILED:
        p = allp[n]
        tiles, halos, ext, n_tiles, nf, passes, amp = tilings[(n, shape)]
        x = torch.randn(shape, generator=gen, device=dev)
        whole = cuda.run(p, {p.input_names[0]: x}, {})[p.output_names[0]].cpu().numpy()
        x_host = {p.input_names[0]: x.cpu().numpy()}
        del x
        torch.cuda.empty_cache()
        # every tile runs at its window's shape: the extended tile, at most the grid
        win = tuple(min(e, d) for e, d in zip(ext, shape))
        tile_plan = plan(p, win, iterate=None if nf == max(p.iterate, 1) else nf)
        want = (math.prod(n_tiles) * passes * len(tile_plan.groups)
                * nf // tile_plan.groups[0].sweeps)
        seconds = {1: [], 2: []}
        for k in (2, 1, 1, 2):
            st = {}
            cuda.reset_launches()
            out = host_tile.run_host_tiled(p, x_host, tiles=tiles, sweeps_per_pass=nf,
                                           in_flight=k, stats=st)
            launched = sum(cuda.launch_counts().values())
            got = out[p.output_names[0]]
            ok = (launched == want and st["n_tiles"] == n_tiles
                  and np.array_equal(got.view(np.uint32), whole.view(np.uint32)))
            seconds[k] += st["pass_seconds"]
            link = (st["h2d_bytes"] / bw["h2d"] + st["d2h_bytes"] / bw["d2h"]) / passes
            per_pass = sum(st["pass_seconds"]) / passes
            log(f"host tiled {n} {shape} in flight {k}: {'x'.join(map(str, n_tiles))} "
                f"tiles of {'x'.join(map(str, tiles))} (+halo -> "
                f"{'x'.join(map(str, ext))}), {passes} pass(es) x {nf} sweep(s), read "
                f"amplification {amp:.4f}; launches {launched}/{want}; "
                f"{'bit for bit' if ok else 'MISMATCH'} against the whole-grid run "
                f"on the whole grid; "
                f"{per_pass:.3f} s a pass; {st['h2d_bytes']} B to the card and "
                f"{st['d2h_bytes']} B back; the link needs {link:.3f} s a pass at the "
                f"measured bandwidth, {100 * link / per_pass:.1f}% of the pass; card {card}")
            del out, got
            if not ok:
                log(f"FAILED host-tiling check: {n} {shape} in flight {k}")
                return 1
        log(f"host tiled {n} {shape}: s a pass with two tiles in flight "
            f"{sum(seconds[2]) / len(seconds[2]):.3f} {seconds[2]}, with one "
            f"{sum(seconds[1]) / len(seconds[1]):.3f} {seconds[1]}; plan of a tile "
            f"{tile_plan.groups[0].describe()}")
        del whole, x_host
        torch.cuda.empty_cache()
    # the gate of `scripts/tpu_check.py`: each case bit for bit against the
    # whole-grid run on the whole grid
    for (n, shape, _, _), (tiles, geo) in zip(HOST_TILE_GATE, gate_tilings):
        p = allp[n]
        n_tiles, nf, passes = geo[3], geo[4], geo[5]
        ins, ps = rand_inputs(p, shape, np.random.default_rng(7))
        whole = to_numpy(p, cuda.run(p, ins, ps))
        win = tuple(min(e, d) for e, d in zip(geo[2], shape))
        tile_plan = plan(p, win, iterate=None if nf == max(p.iterate, 1) else nf)
        want = (math.prod(n_tiles) * passes * len(tile_plan.groups)
                * nf // tile_plan.groups[0].sweeps)
        st = {}
        cuda.reset_launches()
        got = host_tile.run_host_tiled(p, ins, ps, tiles=tiles, sweeps_per_pass=nf, stats=st)
        launched = cuda.launch_counts()
        ok = (sum(launched.values()) == want and all(
            np.array_equal(got[k].view(np.uint8), whole[k].view(np.uint8)) for k in whole))
        log(f"host-tiling gate {n} {shape} ({', '.join(str(p.tensors[k].type) for k in whole)}): "
            f"{'x'.join(map(str, n_tiles))} tiles of {'x'.join(map(str, tiles))} (+halo -> "
            f"{'x'.join(map(str, win))}), {passes} pass(es) x {nf} sweep(s); launches "
            f"{launched} ({want} wanted); {'bit for bit' if ok else 'MISMATCH'} against "
            f"the whole-grid run on the whole grid; "
            f"{sum(st['pass_seconds']) / passes:.3f} s a pass; card {card}")
        if not ok:
            log(f"FAILED host-tiling gate: {n} {shape} {tiles}")
            return 1
        del ins, whole, got
    # over a mesh of the visible cards (round robin): at one sweep an exchange
    # bit for bit on the whole grid, at the automatic cadence outside the rim
    n, shape, msizes, budget = HOST_TILED_MESH
    p = allp[n]
    tiles, n_tiles, nf, passes = (tiled_mesh_geo[0], tiled_mesh_geo[3],
                                  tiled_mesh_geo[4], tiled_mesh_geo[5])
    x = torch.randn(shape, generator=gen, device=dev)
    whole = cuda.run(p, {"t0": x}, {})["t1"].cpu().numpy()
    x_host = {"t0": x.cpu().numpy()}
    del x
    for cadence in (1, None):
        st = {}
        cuda.reset_launches()
        got = host_tile.run_host_tiled(p, x_host, tiles=tiles, mesh=tiled_mesh,
                                       sweeps_per_exchange=cadence, stats=st)["t1"]
        launched = cuda.launch_counts()
        rim = 0 if cadence == 1 else p.valid_rim()
        inner = tuple(slice(rim, d - rim) for d in shape)
        same = np.array_equal(got[inner].view(np.uint32), whole[inner].view(np.uint32))
        ok = (same and st["mesh_exchange_bytes"] > 0 and math.prod(n_tiles) >= HOST_TILED_MESH_TILES
              and sum(launched.values()) == st["mesh_group_calls"] > 0)
        log(f"host tiled over a mesh {n} {shape} x {max(p.iterate, 1)}: "
            f"{'x'.join(map(str, n_tiles))} tiles of {'x'.join(map(str, tiles))} under "
            f"{budget} B a device, each over {'x'.join(map(str, msizes))} on "
            f"{sorted({str(d) for d in tiled_mesh.devices.flat})}, cadence "
            f"{cadence or 'auto'}, {passes} pass(es) x {nf} sweep(s); launches {launched}, "
            f"the shards' group calls {st['mesh_group_calls']}; "
            f"{st['mesh_exchange_bytes']} B exchanged; "
            f"{'bit for bit' if same else 'MISMATCH'} against the whole grid"
            f"{f' outside the rim {rim}' if rim else ' on the whole grid'}; "
            f"{sum(st['pass_seconds']) / passes:.3f} s a pass; card {card}")
        if not ok:
            log(f"FAILED host tiling over a mesh: cadence {cadence}")
            return 1
        del got
    del whole, x_host
    torch.cuda.empty_cache()

    mark(15)

    # ---- 16. the CLI on the card, no --device ----------------------------------
    n, shape, budget = CLI_HOST_TILED
    runs = ((["gauss5x5.soda", "--tcse", "--report", "--dump-plan", "--run"], False),
            ([f"{n}.soda", "--grid-shape", ",".join(map(str, shape)), "--host-tile",
              "auto", "--hbm-budget", str(budget), "--host-tile-sweeps", "auto",
              "--run"], False),
            (["jacobi3d.soda", "--grid-shape", "512,512,512", "--benchmark"], True),
            ([f"{CLI_HOST_TILED_MESH[0]}.soda", "--grid-shape",
              ",".join(map(str, CLI_HOST_TILED_MESH[1])), "--host-tile",
              ",".join(map(str, CLI_HOST_TILED_MESH[2])), "--mesh", CLI_HOST_TILED_MESH[3],
              "--device", "cuda:0", "--run"], False))
    for argv, show in runs:
        buf = io.StringIO()
        cuda.reset_launches()
        with contextlib.redirect_stdout(buf):
            rc = sodac.main([str(CORPUS / argv[0]), *argv[1:]])
        torch.cuda.synchronize()
        launched = sum(cuda.launch_counts().values())
        text = buf.getvalue()
        last = [ln for ln in text.splitlines() if ln.startswith(
            ("OK", "MISMATCH", "host tiling:", "benchmark", "bound:", "  host tiling"))]
        log(f"cli: sodac {' '.join(argv)}: rc {rc}, kernel launches {launched}; "
            + " | ".join(last))
        if rc != 0 or launched < 1 or (not show and "OK" not in last):
            log(f"FAILED cli check: {argv}")
            return 1

    mark(16)

    # ---- 17. the mesh on the card: every shard on cuda:0 -----------------------
    src = torch.empty(PINNED_COPY_BYTES // 4, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    dst.copy_(src)
    copy_ms = events_ms(lambda: dst.copy_(src), 5)
    log(f"mesh: on-card copy of {PINNED_COPY_BYTES} B in {copy_ms:.4f} ms: "
        f"{PINNED_COPY_BYTES / (copy_ms / 1e3) / 1e9:.1f} GB/s copied (each byte read "
        f"once and written once); card {card}")
    del src, dst
    for row, n, shape, sizes, names, dims, runs in MESH_ROWS:
        p = allp[n]
        ins = device_inputs(p, shape, gen, dev)
        whole_fn = cuda.build_fn(p, grid_shape=shape)
        whole = whole_fn(ins, {})
        whole_ms = [events_ms(lambda: whole_fn(ins, {}), MESH_REPS)]
        got_runs = []
        for i, (cadence, overlap, exact) in enumerate(runs):
            fn = mesh_fns[(row, i)]
            cuda.reset_launches()
            got = fn(ins, {})
            torch.cuda.synchronize()
            launched = sum(cuda.launch_counts().values())
            calls = fn.stats["group_calls"]
            rim = 0 if exact else p.valid_rim()
            inner = tuple(slice(rim, d - rim) for d in shape)
            ok = launched == calls > 0 and bitwise_equal(
                {k: v[inner].contiguous() for k, v in got.items()},
                {k: whole[k][inner].contiguous() for k in got})
            # the resident call: ShardedGrids in and out, nothing scattered
            # or gathered; then two of them chained
            grids = {k: shard_grid(v, fn.mesh, fn.dims) for k, v in ins.items()}
            cuda.reset_launches()
            res = fn(grids, {})
            torch.cuda.synchronize()
            res_launched = sum(cuda.launch_counts().values())
            res_calls = fn.stats["group_calls"]
            moved = fn.stats["scatter_bytes"] + fn.stats["gather_bytes"]
            first = {k: gather_grid(v, dev) for k, v in res.items()}
            res_same = bitwise_equal(first, got)
            it = max(p.iterate, 1)
            twice = fn({**grids, p.input_names[0]: res[p.output_names[0]]}, {})
            # the next call leaves the grid it was given as it was
            res_kept = bitwise_equal({k: gather_grid(v, dev) for k, v in res.items()}, first)
            chained = {k: gather_grid(v, dev) for k, v in twice.items()}
            along = mesh.run_sharded(p, ins, {}, mesh=fn.mesh, dims=dims, iterate=2 * it,
                                     sweeps_per_exchange=1)
            # the same schedule at one sweep an exchange, else the mesh's rim
            rim2 = 0 if fn.sweeps_per_exchange == 1 else p.valid_rim(2 * it)
            inner2 = tuple(slice(rim2, d - rim2) for d in shape)
            chain_same = bitwise_equal({k: v[inner2].contiguous() for k, v in chained.items()},
                                       {k: along[k][inner2].contiguous() for k in chained})
            del res, twice, chained, along, first
            state = [grids]

            def step():
                # a call of the loop: its output is the next call's input
                out = fn(state[0], {})
                state[0] = {**state[0], p.input_names[0]: out[p.output_names[0]]}

            ms = events_ms(lambda: fn(ins, {}), MESH_REPS)
            res_ms = events_ms(step, MESH_REPS)
            whole_ms.append(events_ms(lambda: whole_fn(ins, {}), MESH_REPS))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(MESH_REPS):
                fn(ins, {})
            host_ms = (time.perf_counter() - t0) * 1e3 / MESH_REPS
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(MESH_REPS):
                step()
            res_host_ms = (time.perf_counter() - t0) * 1e3 / MESH_REPS
            del grids, state
            alone = device_ms(lambda: fn(ins, {}), 3, MESH_SLEEPS)
            whole_alone = device_ms(lambda: whole_fn(ins, {}), 3)
            plans = "; ".join(
                f"{'x'.join(map(str, key[0]))} x{key[1]}: "
                + ", ".join(f"{g.kernel} sweeps={g.sweeps}" for g in pl.groups)
                for key, pl in fn.local_plans().items())
            log(f"mesh {row} {n} {shape} over {'x'.join(map(str, sizes))}"
                f"{' ' + ','.join(names) if names else ''} on cuda:0, dims {dims}, "
                f"cadence {fn.sweeps_per_exchange}, {'overlap' if overlap else 'sync'}: "
                f"shards of {'x'.join(map(str, fn.shard_shape))} ({plans}); launches "
                f"{launched}/{calls}; {'bit for bit' if ok else 'MISMATCH'} against the "
                f"whole grid{'' if exact else f' outside the rim {rim}'}; "
                f"{fn.stats['exchange_bytes']} B exchanged a call; {ms:.4f} ms a call "
                f"(events), whole grid {whole_ms[-2]:.4f} / {whole_ms[-1]:.4f}; alone "
                f"{fmt(alone)}, whole grid alone {fmt(whole_alone)}; the host's enqueue "
                f"{host_ms:.4f} ms a call; card {card}")
            res_ok = (res_same and res_kept and chain_same and moved == 0
                      and res_launched == res_calls > 0)
            log(f"mesh {row} resident {n} {shape} over {'x'.join(map(str, sizes))}, "
                f"cadence {fn.sweeps_per_exchange}, {'overlap' if overlap else 'sync'}: "
                f"ShardedGrids in and out; launches {res_launched}/{res_calls}; "
                f"{'bit for bit' if res_same else 'MISMATCH'} against the gathered call"
                f"{'' if res_kept else ', OVERWRITTEN by the next call'}; "
                f"two chained calls {'bit for bit' if chain_same else 'MISMATCH'} against "
                f"run_sharded at iterate {2 * it}, one sweep an exchange"
                f"{f' outside the rim {rim2}' if rim2 else ' on the whole grid'}; "
                f"{moved} B scattered and gathered; {res_ms:.4f} ms a call of the loop (events), "
                f"gathered {ms:.4f}, whole grid {whole_ms[-2]:.4f} / {whole_ms[-1]:.4f}; the "
                f"host's enqueue {res_host_ms:.4f} ms a call (gathered {host_ms:.4f}); "
                f"card {card}")
            if not (ok and res_ok):
                log(f"FAILED mesh check: row {row} run {i}")
                return 1
            got_runs.append(got)
        if row == "a" and not bitwise_equal(got_runs[1], got_runs[0]):
            log("FAILED mesh check: row a, overlap against the synchronous run")
            return 1
        del ins, whole, got_runs, whole_fn
        for i in range(len(runs)):
            del mesh_fns[(row, i)]
        torch.cuda.empty_cache()
    buf = io.StringIO()
    cuda.reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = sodac.main([str(CORPUS / MESH_CLI[0]), *MESH_CLI[1:]])
    torch.cuda.synchronize()
    launched = sum(cuda.launch_counts().values())
    last = [ln for ln in buf.getvalue().splitlines()
            if ln.startswith(("mesh:", "executed", "OK", "MISMATCH"))]
    log(f"mesh f: sodac {' '.join(MESH_CLI)}: rc {rc}, kernel launches {launched}; "
        + " | ".join(last))
    if rc != 0 or launched < 1 or "OK" not in last:
        log("FAILED mesh check: row f (the CLI)")
        return 1

    mark(17)

    # ---- 18. wide integers on the card -------------------------------------------
    if not wide_phase(dev, gen, card, u64p, u64_mesh_fn, u64_tiling):
        return 1

    mark(18)

    # ---- 19. random programs on the card -------------------------------------------
    fuzzed = fuzz_phase(dev, card, fuzz, build_seconds)
    if fuzzed is None or set(fuzzed) - {"columns3d"} != {"linebuffer3d", "linebuffer2d",
                                                          "sweeps", "windows"}:
        log(f"FAILED fuzz check: phase 19 launched {fuzzed}, not every kernel")
        return 1
    del fuzz

    mark(19)

    # ---- 20. the entry points ------------------------------------------------------
    fn, args = entry_points.entry()
    cuda.reset_launches()
    y = fn(*args)
    torch.cuda.synchronize()
    launched = cuda.launch_counts()
    plain = eager.run(programs["jacobi3d"], {"t0": args[0]}, {}, device=dev)["t1"]
    err = float((y - plain).abs().max())
    alone = device_ms(lambda: fn(*args), 20)
    ok = (launched["linebuffer3d"] == sum(launched.values()) == 1 and err <= KERNEL_TOL
          and tuple(y.shape) == entry_points.ENTRY_GRID and y.device == dev)
    log(f"entry: entry() on {y.device}: launches {launched}; max|kernel-plain| "
        f"{err:.3g} ({'ok' if ok else 'MISMATCH'}); alone {fmt(alone)} ms; card {card}")
    if not ok:
        log("FAILED entry check: entry()")
        return 1
    del y, plain, fn, args
    for n_dev in DRYRUN_DEVICES:
        t0 = time.perf_counter()
        # raises on any failed check
        ran = entry_points.dryrun_multichip(n_dev)
        log(f"entry: dryrun_multichip({n_dev}) passed in {time.perf_counter() - t0:.2f} s: "
            f"{json.dumps(ran)}")

    mark(20)
    j, b, f = summary["jacobi3d"], summary2[MAIN_2D], summary3[MAIN_SWEEPS]
    for row, name in ((j, "linebuffer3d"), (b, "linebuffer2d"), (f, "sweeps"),
                      (summary4, "windows"), (zmarch, "columns3d")):
        row["fuzz_launches"] = fuzzed[name]
    log(card)
    log(json.dumps({"kernels": [{
        "name": "linebuffer3d", "route": "cuda",
        "source": "soda_tpu_torch/csrc/linebuffer3d.cuh",
        "replaces": "soda_tpu/backend/_linebuffer.py:309",
        "launches": j["launches"],
        "fuzz_launches": j["fuzz_launches"], "max_abs_err": j["err"],
        "ms": j["ms"], "plain_ms": j["plain_ms"], "bound_ms": j["bound_ms"],
        "bound_by": j["bound_by"], "library_ms": j["library_ms"]}, {
        "name": "linebuffer2d", "route": "cuda",
        "source": "soda_tpu_torch/csrc/linebuffer2d.cuh",
        "replaces": "soda_tpu/backend/_linebuffer.py:106",
        "launches": b["launches"],
        "fuzz_launches": b["fuzz_launches"], "max_abs_err": b["err"],
        "ms": b["ms"], "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"], "library_ms": b["library_ms"]}, {
        # ms, plain_ms, chained_ms and bound_ms per sweep of jacobi2d 2048^2 x 8
        "name": "sweeps", "route": "cuda",
        "source": "soda_tpu_torch/backend/sweeps.py",
        "replaces": "soda_tpu/backend/pallas.py:634",
        "launches": f["launches"],
        "fuzz_launches": f["fuzz_launches"], "max_abs_err": f["err"],
        "ms": f["ms"], "plain_ms": f["plain_ms"], "chained_ms": f["chained_ms"],
        "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
        "library_ms": f["library_ms"]}, {
        # kernel 1's column z-march, denoise3d 512^3 (phase 4); its
        # fuzz_launches count the "columns3d" launches of phase 19
        "name": "columns3d", "route": "cuda",
        "source": "soda_tpu_torch/csrc/columns3d.cuh",
        "replaces": "soda_tpu/backend/_linebuffer.py:309",
        "launches": zmarch["launches"],
        "fuzz_launches": zmarch["fuzz_launches"], "max_abs_err": zmarch["err"],
        "ms": zmarch["ms"], "plain_ms": zmarch["plain_ms"], "bound_ms": zmarch["bound_ms"],
        "bound_by": zmarch["bound_by"], "library_ms": None}, {
        # smooth1d 2^28 f32 (phase 12)
        "name": "windows", "route": "cuda",
        "source": "soda_tpu_torch/csrc/windows.cuh",
        "replaces": "soda_tpu/backend/pallas.py:1000",
        "launches": summary4["launches"],
        "fuzz_launches": summary4["fuzz_launches"], "max_abs_err": summary4["err"],
        "ms": summary4["ms"], "plain_ms": summary4["plain_ms"],
        "bound_ms": summary4["bound_ms"], "bound_by": summary4["bound_by"],
        "library_ms": summary4["library_ms"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
