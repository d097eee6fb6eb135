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
4. kernel 1's main path at full size: jacobi3d 512^3 f32, one sweep, with
   kernel 1's launch counter reset just before and read just after; held
   against the plain version at 1e-4 over the whole grid, then both timed
   with CUDA events (plain, kernel, kernel, plain) beside the bound (ideal
   bytes over 3.35 TB/s) and `F.conv3d` (TF32 off); denoise3d, heat3d and
   poisson3d_f64 at 256^3, and jacobi3d 1024^3 when the card has room;
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
   phase 8 (the NumPy reference on the whole grid too) and timed with CUDA
   events three ways in turns (fused, chained, plain, plain, chained,
   fused), beside the device time of the fused kernel alone and of the
   chained kernels alone (`device_ms`), its bound per call (and what
   bounds it), the planned bytes per cell-update, and the card's name and
   power limit;
10. the depth sweep: every row of phase 9 at every fused depth that fits
   (and 1), in ms per sweep beside the planner's modeled time and plan
   (tile, chunk, load path, CTAs an SM, waves), each output equal to the
   chained kernels bit for bit;
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
   budget, bit for bit against the whole-grid run outside `valid_rim()`;
   each run with two tiles in flight and with one, in turns (2, 1, 1, 2),
   every run checked, printing the tiles, passes, read amplification, wall
   seconds a pass, bytes across the host link and the share of the pass
   the measured bandwidth needs for them;
16. the CLI on the card with no --device: `--tcse --report --dump-plan
   --run` on gauss5x5, `--host-tile auto --hbm-budget 8 MiB
   --host-tile-sweeps auto --run` on jacobi2d 2048^2, and `--benchmark`
   on jacobi3d 512^3 (CUDA events, beside phase 4's figure).

Each phase logs the seconds since the start when it ends.  Phases 4 and
7 run their programs one sweep per call (`sweeps=1`), so
they time kernels 1 and 2; phases 8-10 time the fused cascades
(`backend/sweeps.py`), phases 12-13 the windows kernel.  The line before the last is the kernel summary
as JSON; the last line is {"ok": true, "device": {...}}.
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


def device_ms(fn, reps: int) -> float | None:
    """Device time of the kernels one `fn()` enqueues, in ms (the mean of
    `reps`), by CUDA events: a sleep kernel holds the stream while the host
    enqueues the start event, `fn`'s kernels and the end event, so no host
    gap is timed.  None ("not measured") where the host took longer to
    enqueue than the sleep lasts.  (torch.profiler on the card's machine
    dropped kernel records after a few profiles in one process.)"""
    import torch

    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        if host_s > SLEEP_COVERS_S:
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


def launch_count() -> int:
    """Launches of every kernel wrapper of the port."""
    from soda_tpu_torch.backend import linebuffer, linebuffer2d, sweeps, windows

    return (linebuffer.LAUNCHES + linebuffer2d.LAUNCHES + sweeps.LAUNCHES
            + windows.LAUNCHES)


def device_inputs(p, shape, gen, dev) -> dict:
    """Random inputs made on the card from `gen`, in the distributions of
    `rand_inputs` (uint16 in [0, 250), int64 in [-2^40, 2^40), floats
    standard normal)."""
    import torch

    from soda_tpu_torch.ir.dtypes import torch_dtype

    ins = {}
    for n in p.input_names:
        t = p.tensors[n].type
        dt = torch_dtype(t)
        if t.is_float:
            ins[n] = torch.randn(shape, generator=gen, device=dev, dtype=dt)
        elif t.kind == "int" and t.width > 32:
            ins[n] = torch.randint(-(1 << 40), 1 << 40, shape, generator=gen,
                                   device=dev, dtype=dt)
        else:
            ins[n] = torch.randint(0, 250, shape, generator=gen, device=dev,
                                   dtype=torch.int32).to(dt)
    return ins


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch.nn.functional as F

    from soda_tpu_torch.backend import (cuda, eager, linebuffer, linebuffer2d, sweeps,
                                        windows)
    from soda_tpu_torch.backend.io import to_numpy, to_torch
    from soda_tpu_torch.cli import sodac
    from soda_tpu_torch.frontend.parser import parse, parse_file
    from soda_tpu_torch.optimize import tcse
    from soda_tpu_torch.parallel import host_tile
    from soda_tpu_torch.plan.planner import fused_depths, plan
    from soda_tpu_torch.utils import report
    from soda_tpu_torch.utils.testing import (CORPUS, INT3D_SOURCES,
                                              RANK1_CORPUS, RANK2_CORPUS,
                                              RANK3_CORPUS, STAR3D_R8,
                                              compare_outputs, oracle,
                                              pinned_plan, rand_inputs)

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
    for n, shape in AT_SIZE + (BIG,):
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
    gauss_cli = rewritten["gauss5x5"]
    add_jobs(gauss_cli, sodac._grid_shape(gauss_cli, sodac.make_parser().parse_args(
        [str(CORPUS / "gauss5x5.soda")])))
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

    mark(2)

    # ---- 3. small grids: kernel vs plain on the card vs oracle ---------------
    failures = []
    for n, p in programs.items():
        for shape in SMALL_SHAPES:
            ins, ps = rand_inputs(p, shape, np.random.default_rng(0))
            the_plan = plan(p, shape)
            before = launch_count()
            got = cuda.run(p, ins, ps, device=dev)
            torch.cuda.synchronize()
            launched = launch_count() - before
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
            linebuffer.LAUNCHES = 0
            got = cuda.run(p, ins, {}, device=dev)
            torch.cuda.synchronize()
            launches = linebuffer.LAUNCHES
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
        log(f"at-size {n} {shape}: max|kernel-plain| {err:.3g} "
            f"({'ok' if ok else 'MISMATCH'}); ms/sweep kernel {k_ms:.4f} "
            f"[{t[1]:.4f}, {t[2]:.4f}]/{calls} plain {p_ms:.4f} "
            f"[{t[0]:.4f}, {t[3]:.4f}]/{calls}; bound {rep.bound_ms:.4f}; "
            f"{r['achieved_gbps_at_ideal_bytes']:.1f} "
            f"GB/s at {rep.ideal_bytes_per_cell:g} B/cell = "
            f"{100 * r['share_of_3350_gbps']:.1f}% of 3.35 TB/s; plan "
            f"{rep.plan_bytes_per_cell:.3f} B/cell; card {card}")
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
            before = launch_count()
            got = cuda.run(p, ins, ps)
            torch.cuda.synchronize()
            launched = launch_count() - before
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
                before = linebuffer2d.LAUNCHES
                got = cuda.run(p, ins, ps, the_plan=the_plan)
                torch.cuda.synchronize()
                launched = linebuffer2d.LAUNCHES - before
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
    before = linebuffer2d.LAUNCHES
    rc = sodac.main([str(CORPUS / "blur.soda"), "--grid-shape", "2048,4096", "--run"])
    torch.cuda.synchronize()
    launched = linebuffer2d.LAUNCHES - before
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
            linebuffer2d.LAUNCHES = 0
            got = cuda.run(p, ins, pars, sweeps=1)
            torch.cuda.synchronize()
            launches = linebuffer2d.LAUNCHES
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
            before = sweeps.LAUNCHES
            got = cuda.run(p, ins, ps, sweeps=d)
            torch.cuda.synchronize()
            launched = sweeps.LAUNCHES - before
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
                before = sweeps.LAUNCHES
                got = cuda.run(p, ins, ps, the_plan=the_plan)
                torch.cuda.synchronize()
                launched = sweeps.LAUNCHES - before
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
    for n, shape in AT_SIZE_SWEEPS:
        p = allp[n]
        it = max(p.iterate, 1)
        ins = device_inputs(p, shape, gen, dev)
        fused = cuda.build_fn(p, grid_shape=shape)
        chained = cuda.build_fn(p, grid_shape=shape, sweeps=1)
        nf = fused.plan.groups[0].sweeps
        main_path = (n, shape) == MAIN_SWEEPS
        if main_path:
            sweeps.LAUNCHES = 0
            got = cuda.run(p, ins, {})
            torch.cuda.synchronize()
            launches = sweeps.LAUNCHES
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
        ok_oracle = compare_outputs(p, to_numpy(p, got),
                                    oracle(p, {k: v.cpu().numpy() for k, v in ins.items()}, {}), 0)
        oracle_s = time.perf_counter() - t0
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
            f"{'ok' if ok_oracle else 'MISMATCH'} ({oracle_s:.1f} s on the host); "
            f"ms/sweep fused {f_ms:.4f} [{t[0]:.4f}, {t[5]:.4f}]/{it} (kernel alone "
            f"{fmt(dev_ms)}) chained {c_ms:.4f} [{t[1]:.4f}, {t[4]:.4f}]/{it} (kernels "
            f"alone {fmt(dev_c)}) "
            f"plain {p_ms:.4f} [{t[2]:.4f}, {t[3]:.4f}]/{it}; bound per call "
            f"{rep.bound_ms:.4f} ({rep.bound_by}; {rep.bound_ms / nf:.4f} per sweep, "
            f"program {rep.program_bound_ms:.4f}); {100 * r['share_of_bound']:.1f}% "
            f"of the bound; plan {rep.plan_bytes_per_cell_update:.3f} B/cell-update; "
            f"{fused.plan.groups[0].describe()}; card {card}")
        if not ok:
            log(f"FAILED fused at-size check: {n} {shape}")
            return 1
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
            shape_of = (f"tile {g.tile}, chunk {g.bz}, smem {g.smem_bytes} B"
                        + (f", load {g.load}, sync {g.sync}, threads {g.threads}, "
                           f"CTAs/SM {g.slots_per_sm}, waves {g.waves:.2f}"
                           if g.kernel == "linebuffer2d" else ""))
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
        before = windows.LAUNCHES
        got = cuda.run(p, ins, ps, **kw)
        torch.cuda.synchronize()
        launched = windows.LAUNCHES - before
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
    windows.LAUNCHES = 0
    got = cuda.run(p, ins, {})
    torch.cuda.synchronize()
    launches = windows.LAUNCHES
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
            before = launch_count()
            got_q = cuda.run(q, ins, ps)
            torch.cuda.synchronize()
            launched = launch_count() - before
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
    linebuffer2d.LAUNCHES = 0
    got = {k: fn(ins, {})["q_out"] for k, fn in fns.items()}
    torch.cuda.synchronize()
    launches = linebuffer2d.LAUNCHES
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
        rim = 0 if nf == 1 else p.valid_rim()
        inner = tuple(slice(rim, d - rim) for d in shape)
        tile_plan = plan(p, ext, iterate=None if nf == max(p.iterate, 1) else nf)
        want = (math.prod(n_tiles) * passes * len(tile_plan.groups)
                * nf // tile_plan.groups[0].sweeps)
        seconds = {1: [], 2: []}
        for k in (2, 1, 1, 2):
            st = {}
            before = launch_count()
            out = host_tile.run_host_tiled(p, x_host, tiles=tiles, sweeps_per_pass=nf,
                                           in_flight=k, stats=st)
            launched = launch_count() - before
            got = out[p.output_names[0]]
            ok = (launched == want and st["n_tiles"] == n_tiles
                  and np.array_equal(got[inner].view(np.uint32), whole[inner].view(np.uint32)))
            seconds[k] += st["pass_seconds"]
            link = (st["h2d_bytes"] / bw["h2d"] + st["d2h_bytes"] / bw["d2h"]) / passes
            per_pass = sum(st["pass_seconds"]) / passes
            log(f"host tiled {n} {shape} in flight {k}: {'x'.join(map(str, n_tiles))} "
                f"tiles of {'x'.join(map(str, tiles))} (+halo -> "
                f"{'x'.join(map(str, ext))}), {passes} pass(es) x {nf} sweep(s), read "
                f"amplification {amp:.4f}; launches {launched}/{want}; "
                f"{'bit for bit' if ok else 'MISMATCH'} against the whole-grid run "
                f"{'on the whole grid' if rim == 0 else f'outside the rim {rim}'}; "
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

    mark(15)

    # ---- 16. the CLI on the card, no --device ----------------------------------
    n, shape, budget = CLI_HOST_TILED
    runs = ((["gauss5x5.soda", "--tcse", "--report", "--dump-plan", "--run"], False),
            ([f"{n}.soda", "--grid-shape", ",".join(map(str, shape)), "--host-tile",
              "auto", "--hbm-budget", str(budget), "--host-tile-sweeps", "auto",
              "--run"], False),
            (["jacobi3d.soda", "--grid-shape", "512,512,512", "--benchmark"], True))
    for argv, show in runs:
        buf = io.StringIO()
        before = launch_count()
        with contextlib.redirect_stdout(buf):
            rc = sodac.main([str(CORPUS / argv[0]), *argv[1:]])
        torch.cuda.synchronize()
        launched = launch_count() - before
        text = buf.getvalue()
        last = [ln for ln in text.splitlines() if ln.startswith(
            ("OK", "MISMATCH", "host tiling:", "benchmark", "bound:", "  host tiling"))]
        log(f"cli: sodac {' '.join(argv)}: rc {rc}, kernel launches {launched}; "
            + " | ".join(last))
        if rc != 0 or launched < 1 or (not show and "OK" not in last):
            log(f"FAILED cli check: {argv}")
            return 1

    mark(16)
    j, b, f = summary["jacobi3d"], summary2[MAIN_2D], summary3[MAIN_SWEEPS]
    log(card)
    log(json.dumps({"kernels": [{
        "name": "linebuffer3d", "route": "cuda",
        "source": "soda_tpu_torch/csrc/linebuffer3d.cuh",
        "replaces": "soda_tpu/backend/_linebuffer.py:309",
        "launches": j["launches"], "max_abs_err": j["err"],
        "ms": j["ms"], "plain_ms": j["plain_ms"], "bound_ms": j["bound_ms"],
        "bound_by": j["bound_by"], "library_ms": j["library_ms"]}, {
        "name": "linebuffer2d", "route": "cuda",
        "source": "soda_tpu_torch/csrc/linebuffer2d.cuh",
        "replaces": "soda_tpu/backend/_linebuffer.py:106",
        "launches": b["launches"], "max_abs_err": b["err"],
        "ms": b["ms"], "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"], "library_ms": b["library_ms"]}, {
        # ms, plain_ms, chained_ms and bound_ms per sweep of jacobi2d 2048^2 x 8
        "name": "sweeps", "route": "cuda",
        "source": "soda_tpu_torch/backend/sweeps.py",
        "replaces": "soda_tpu/backend/pallas.py:634",
        "launches": f["launches"], "max_abs_err": f["err"],
        "ms": f["ms"], "plain_ms": f["plain_ms"], "chained_ms": f["chained_ms"],
        "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
        "library_ms": f["library_ms"]}, {
        # smooth1d 2^28 f32 (phase 12)
        "name": "windows", "route": "cuda",
        "source": "soda_tpu_torch/csrc/windows.cuh",
        "replaces": "soda_tpu/backend/pallas.py:1000",
        "launches": summary4["launches"], "max_abs_err": summary4["err"],
        "ms": summary4["ms"], "plain_ms": summary4["plain_ms"],
        "bound_ms": summary4["bound_ms"], "bound_by": summary4["bound_by"],
        "library_ms": summary4["library_ms"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
