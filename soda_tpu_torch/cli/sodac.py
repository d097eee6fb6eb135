"""sodac for the torch port: compile a `.soda` program for the card.

Counterpart of `soda_tpu/cli/sodac.py`, with its flags where they have a
meaning on the card.  Parses a `.soda` file (the DSL's knobs overridable:
`--unroll-factor --tile-size --iterate --burst-width --dram-in
--dram-out --border --cluster`, CLI beats DSL), optionally rewrites it
(`--unroll-iterate [N]`, `--tcse`), plans it for the CUDA kernels, prints
the plan, and then does what the flags ask:

  --dump-plan [FILE]    the plan as JSON (`Plan.to_json`)
  --report              the plan report (bytes, the H100's bound), the
                        knobs accepted but inert on the card, and the host
                        tiling's read amplification
  --cpp-golden FILE     the native C++ golden runner's source
                        (`backend/cpp.py`); --xocl-kernel/--xocl-host FILE
                        write the same runner, --xocl-header FILE its
                        dimensions, for flows that expect those artifacts
  --torch-driver FILE   a standalone Python driver that runs the program
                        through `soda_tpu_torch.backend.cuda.run`
  --run                 run on random inputs made from --seed and check
                        against the NumPy reference (exit 1 on mismatch)
  --benchmark           time the selected backend on the card with CUDA
                        events (back-to-back calls after a warm-up)
  --profile DIR         a torch.profiler trace of --run/--benchmark, then
                        the program's spans (count, total and self ms) and,
                        on a mesh, its device intervals by card

`--backend` picks what runs: `cuda` (the default: the hand-written
kernels), `eager` (the plain PyTorch path) or `numpy` (the reference).
Integers wider than 64 bits run on `eager` and `numpy` (and in the golden
runner); `cuda`, and so `--mesh` and `--host-tile`, refuse them with a
message naming `--backend eager`, as the reference names `--backend xla`.
`--device` is `cuda` (the default: the card, never a fallback) or `cpu`
(every kernel's plain version).  `--host-tile T0,..|auto` runs a grid
larger than the card as overlapping tiles (`parallel/host_tile.py`),
`--host-tile-sweeps K|auto` sweeps a pass, under `--hbm-budget` bytes
(default: half the card's free memory); the plan and the report are then
the kernel's at the extended tile shape.  `--sweeps N` asks for N fused
sweeps a kernel call, `--block` pins the windows kernel, `--smem-budget`
bounds a CTA's shared memory (the counterpart of `--vmem-budget`).

`--mesh 2,2` (or named axes, `dcn:2,x:2`) shards the grid over a mesh of
devices (`parallel/mesh.py`): `--device cuda` over the visible cards,
`--device cuda:N` every shard on card N, `--device cpu` on CPU shards; with
`--host-tile`, every tile is sharded.  `--sweeps-per-exchange K[,K..]` sets
the exchange cadence, `--mesh-local-backend cuda|eager` what each shard
runs, `--mesh-overlap` overlaps the exchange with the shards' interiors,
`--link-model` calibrates the links that choose the automatic cadence (an
axis named `dcn*` rides the slow link).

Not ported: `--interpret` (use `--device cpu`), `--lb-engine` and
`--compile-cache` (TPU-only), `--pallas-driver` (here `--torch-driver`).

    python -m soda_tpu_torch.cli.sodac tests/soda/blur.soda \\
        --grid-shape 2048,4096 --run
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import pathlib
import sys
import time

import numpy as np

logger = logging.getLogger("soda_tpu_torch")


def _shape(s: str) -> tuple[int, ...]:
    try:
        shape = tuple(int(v) for v in s.replace("x", ",").split(",") if v)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"want comma-separated integers, got {s!r}") from None
    if not shape or min(shape) <= 0:
        raise argparse.ArgumentTypeError(f"want positive sizes, got {s!r}")
    return shape


def _host_tile(s: str):
    """'auto' or tile sizes, 0 = the whole extent."""
    if s == "auto":
        return s
    try:
        tiles = tuple(int(v) for v in s.replace("x", ",").split(",") if v)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"want 'auto' or comma-separated tile sizes, got {s!r}") from None
    if not tiles or min(tiles) < 0:
        raise argparse.ArgumentTypeError(f"want sizes >= 0, got {s!r}")
    return tiles


def _count_or_auto(s: str):
    if s == "auto":
        return s
    try:
        k = int(s)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"want 'auto' or a positive count, got {s!r}") from None
    if k < 1:
        raise argparse.ArgumentTypeError(f"want a positive count, got {s!r}")
    return k


def _parse_mesh(s: str):
    """'2,4' (or '2x4') or 'dcn:2,x:4' -> (sizes, names, link classes).

    An axis named dcn* rides the slow link between hosts
    (`mesh.SLOW_LINK`), every other axis the fast one (`mesh.FAST_LINK`).
    Unnamed axes are ax0, ax1, ...  The 'x' separator applies only to the
    unnamed form ('x' is an axis name in the named form)."""
    from ..parallel.mesh import FAST_LINK, SLOW_LINK

    if ":" not in s:
        s = s.replace("x", ",")
    sizes, names = [], []
    for i, part in enumerate(p for p in s.split(",") if p):
        name, size = part.split(":", 1) if ":" in part else (f"ax{i}", part)
        names.append(name)
        sizes.append(int(size))
    links = {n: (SLOW_LINK if n.startswith("dcn") else FAST_LINK) for n in names}
    return tuple(sizes), tuple(names), links


def _parse_cadence(s: str | None, axis_names):
    """'4' (every axis) or '4,2' (one per mesh axis) -> int | dict | None."""
    if s is None:
        return None
    try:
        ks = [int(x) for x in s.split(",") if x]
    except ValueError:
        raise SystemExit(f"--sweeps-per-exchange: want integers, got {s!r}") from None
    if len(ks) == 1:
        return ks[0]
    if len(ks) != len(axis_names):
        raise SystemExit(f"--sweeps-per-exchange: {len(ks)} values for "
                         f"{len(axis_names)} mesh axes")
    return dict(zip(axis_names, ks))


def _make_mesh(args):
    """The --mesh over --device: 'cpu' CPU shards, 'cuda:N' every shard on
    card N, 'cuda' one shard a visible card."""
    from ..parallel.mesh import make_mesh

    sizes, names, _ = args.mesh
    n = math.prod(sizes)
    devices = (["cpu"] * n if args.device == "cpu"
               else [args.device] * n if ":" in args.device else None)
    try:
        return make_mesh(sizes, names, devices)
    except ValueError as e:
        raise SystemExit(f"--mesh: {e}; --device cuda:0 puts every shard on "
                         f"card 0") from None


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="sodac-torch",
        description="Compile and run a .soda stencil program on PyTorch/CUDA")
    ap.add_argument("soda_src", help="input .soda file")
    # the DSL's knobs (CLI beats DSL)
    ap.add_argument("--unroll-factor", type=int, default=None,
                    help="accepted for compatibility; inert on the card")
    ap.add_argument("--tile-size", type=_shape, default=None,
                    help="override the input tile size, e.g. 512,512")
    ap.add_argument("--iterate", type=int, default=None)
    ap.add_argument("--burst-width", type=int, default=None,
                    help="accepted for compatibility; inert on the card")
    ap.add_argument("--dram-in", type=str, default=None)
    ap.add_argument("--dram-out", type=str, default=None)
    ap.add_argument("--border", type=str, default=None, choices=["ignore"])
    ap.add_argument("--cluster", type=str, default=None, choices=["none"])
    # grid and execution
    ap.add_argument("--grid-shape", type=_shape, default=None,
                    help="full grid shape, e.g. 64,64,128 (default: from the "
                         "input's tile sizes, '*' dims as 128)")
    ap.add_argument("--backend", choices=["cuda", "eager", "numpy"], default="cuda",
                    help="'cuda' (the kernels), 'eager' (the plain PyTorch "
                         "path) or 'numpy' (the reference)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default: the card, never a fallback) or 'cpu'")
    ap.add_argument("--sweeps", type=int, default=None,
                    help="fused sweeps per kernel call for iterate programs "
                         "(default: the planner's choice; 1 = one sweep per "
                         "call; a non-divisor of iterate is snapped to one)")
    ap.add_argument("--block", type=_shape, default=None,
                    help="pin the windows kernel with this block, one size "
                         "per axis, e.g. 8,32 (one sweep per call)")
    ap.add_argument("--smem-budget", type=int, default=None,
                    help="shared-memory bytes a CTA may use (default: the "
                         "planner's, 96 KiB)")
    ap.add_argument("--host-tile", type=_host_tile, default=None,
                    metavar="T0,T1,...|auto",
                    help="run a grid larger than the card as overlapping "
                         "tiles through the kernels; 'auto' picks tiles that "
                         "fit --hbm-budget; 0 = the whole extent of a dim")
    ap.add_argument("--host-tile-sweeps", type=_count_or_auto, default=None,
                    metavar="K|auto",
                    help="sweeps per host-tiling pass (must divide iterate; "
                         "default: all in one pass); K=1 equals the whole-grid "
                         "run on the whole grid, deeper K differs only in the "
                         "border-invalid rim; 'auto' minimizes the modeled "
                         "bytes across the host link")
    ap.add_argument("--hbm-budget", type=int, default=None,
                    help="device bytes for --host-tile auto (default: half "
                         "the card's free memory)")
    ap.add_argument("--mesh", type=str, default=None,
                    help="shard over a mesh of devices: sizes ('2,2') or named "
                         "axes ('dcn:2,x:2'; an axis named dcn* rides the slow "
                         "link and exchanges its halo less often); --device "
                         "cuda shards over the visible cards, cuda:N puts "
                         "every shard on card N, cpu on CPU shards")
    ap.add_argument("--sweeps-per-exchange", type=str, default=None,
                    metavar="K[,K...]",
                    help="halo-exchange cadence for --mesh: one value, or one "
                         "per mesh axis (each divides iterate, together a "
                         "divisor chain); default: the modeled automatic one")
    ap.add_argument("--mesh-local-backend", choices=["cuda", "eager"],
                    default="cuda",
                    help="what each shard runs under --mesh: the kernels "
                         "(default) or the plain PyTorch sweeps")
    ap.add_argument("--mesh-overlap", action="store_true",
                    help="exchange the halos while the shards' interiors run "
                         "(equal results; see parallel/mesh.py)")
    ap.add_argument("--link-model", type=str, default=None,
                    metavar="CLASS=GBPS:LAT[,...]",
                    help="calibrate the links that pick the automatic "
                         "cadence, e.g. 'nvlink=392.9:2.81e-5,ib=50:2e-5' (also "
                         "SODA_LINK_MODEL); nvlink's default is measured on "
                         "four H100s, ib's the data sheet's: see parallel/mesh.py")
    ap.add_argument("--unroll-iterate", type=int, nargs="?", const=0,
                    default=None, metavar="N",
                    help="unroll N sweeps into chained stage copies (no N: "
                         "all of iterate)")
    ap.add_argument("--tcse", action="store_true",
                    help="computation-reuse rewrite (DAC'20): hoist shifted "
                         "repeated partial sums into stages; reassociates "
                         "float sums and widens the border-invalid rim")
    # artifacts
    ap.add_argument("--cpp-golden", type=str, default=None, metavar="FILE")
    ap.add_argument("--xocl-kernel", type=str, default=None, metavar="FILE")
    ap.add_argument("--xocl-host", type=str, default=None, metavar="FILE")
    ap.add_argument("--xocl-header", type=str, default=None, metavar="FILE")
    ap.add_argument("--torch-driver", type=str, default=None, metavar="FILE")
    ap.add_argument("--profile", type=str, default=None, metavar="DIR",
                    help="write a torch.profiler trace of --run/--benchmark and "
                         "print the program's spans and, on a mesh, its device "
                         "intervals by card (utils/trace.py)")
    ap.add_argument("--dump-plan", type=str, nargs="?", const="-",
                    default=None, metavar="FILE")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--run", action="store_true",
                    help="run on random inputs and check against the oracle")
    ap.add_argument("--benchmark", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-v", "--verbose", action="count", default=0)
    return ap


def _overrides(args) -> dict:
    ov = {k: getattr(args, k) for k in
          ("unroll_factor", "iterate", "burst_width", "border", "cluster",
           "tile_size") if getattr(args, k) is not None}
    for k in ("dram_in", "dram_out"):
        if getattr(args, k) is not None:
            ov[k] = _shape(getattr(args, k))
    return ov


def _grid_shape(program, args) -> tuple[int, ...]:
    if args.grid_shape is not None:
        if len(args.grid_shape) != program.rank:
            raise SystemExit(f"--grid-shape has rank {len(args.grid_shape)}, "
                             f"program rank is {program.rank}")
        return args.grid_shape
    tile = program.tensors[program.input_names[0]].tile_size or ()
    return tuple(128 if d is None else d for d in tile)


def _inert_lines(program) -> list[str]:
    """The DSL's knobs that the card's kernels accept and ignore."""
    inert = []
    if program.unroll_factor > 1:
        inert.append(f"unroll factor {program.unroll_factor} (the planner's "
                     f"tiles and column runs set the work a thread does)")
    if program.burst_width:
        inert.append(f"burst width {program.burst_width} (rows are copied 16 "
                     f"bytes a thread where they allow it: the plan's load)")
    if any(t.dram != (1,) for t in program.tensors.values()):
        inert.append("dram channel lists (one device memory on the card)")
    if program.cluster and program.cluster != "none":
        inert.append(f"cluster {program.cluster}")
    return inert


_DRIVER_TEMPLATE = '''#!/usr/bin/env python
"""Standalone PyTorch/CUDA driver for the stencil program {name!r}.

Runs it through soda_tpu_torch.backend.cuda.run on the card (pass --device
cpu for the plain PyTorch path) on random inputs and prints each output's
shape, dtype and sum.
"""
import sys

import numpy as np

from soda_tpu_torch.backend import cuda
from soda_tpu_torch.backend.io import to_numpy
from soda_tpu_torch.frontend.parser import parse

SODA_SRC = {src!r}
GRID_SHAPE = {grid_shape!r}

program = parse(SODA_SRC)


def run(inputs, params=None, device="cuda", **plan_kwargs):
    return to_numpy(program, cuda.run(program, inputs, params, device=device,
                                      **plan_kwargs))


if __name__ == "__main__":
    device = sys.argv[sys.argv.index("--device") + 1] if "--device" in sys.argv else "cuda"
    rng = np.random.default_rng(0)
    ins = {{}}
    for n in program.input_names:
        t = program.tensors[n].type
        ins[n] = (rng.standard_normal(GRID_SHAPE).astype(t.np_dtype())
                  if t.is_float else
                  rng.integers(0, 255, GRID_SHAPE).astype(t.np_dtype()))
    ps = {{p.name: rng.standard_normal(p.shape).astype(p.type.np_dtype())
          for p in program.params.values()}}
    for k, v in run(ins, ps, device).items():
        print(k, v.shape, v.dtype, float(np.asarray(v, dtype=np.float64).sum()))
'''


def _write_artifacts(program, grid_shape, args) -> bool:
    from ..backend import cpp

    did = False
    if args.cpp_golden or args.xocl_kernel or args.xocl_host:
        src = cpp.generate(program, grid_shape)
        for path, banner in ((args.cpp_golden, ""),
                             (args.xocl_kernel,
                              "// --xocl-kernel compatibility artifact: the card\n"
                              "// runs no HLS kernel; this is the golden\n"
                              "// loop nest with identical semantics.\n"),
                             (args.xocl_host, "")):
            if path:
                pathlib.Path(path).write_text(banner + src)
                print(f"wrote C++ golden runner: {path}")
                did = True
    if args.xocl_header:
        lines = [f"// generated by soda_tpu_torch for kernel `{program.name}`",
                 "#pragma once"]
        lines += [f"#define SODA_DIM_{d} {n}" for d, n in enumerate(grid_shape)]
        lines.append(f"#define SODA_ITERATE {max(program.iterate, 1)}")
        lines.append(f"#define SODA_VALID_RIM {program.valid_rim()}")
        pathlib.Path(args.xocl_header).write_text("\n".join(lines) + "\n")
        print(f"wrote header: {args.xocl_header}")
        did = True
    if args.torch_driver:
        pathlib.Path(args.torch_driver).write_text(_DRIVER_TEMPLATE.format(
            name=program.name, src=pathlib.Path(args.soda_src).read_text(),
            grid_shape=tuple(grid_shape)))
        print(f"wrote PyTorch driver: {args.torch_driver}")
        did = True
    return did


def _host_tiling(program, grid_shape, args, mesh_shape=None):
    """Resolve --host-tile / --host-tile-sweeps / --hbm-budget into the
    tiling's geometry (`plan_host_tiling`), or exit naming the flag.  Under
    --mesh (`mesh_shape`) the budget is a device's."""
    from ..parallel import host_tile

    budget = args.hbm_budget
    if budget is None and "auto" in (args.host_tile, args.host_tile_sweeps):
        if args.device == "cpu":
            raise SystemExit("--host-tile auto and --host-tile-sweeps auto on "
                             "--device cpu need --hbm-budget (there is no card "
                             "to size the tiles from)")
        budget = host_tile.default_hbm_budget(args.device)
        logger.info("--hbm-budget: %d bytes (half the card's free memory)", budget)
    try:
        tiles = (None if args.host_tile == "auto"
                 else host_tile.normalize_tiles(grid_shape, args.host_tile))
        nf = args.host_tile_sweeps
        if nf == "auto":
            nf, tiles = host_tile.choose_sweeps_per_pass(
                program, grid_shape, tiles, budget, mesh_shape=mesh_shape)
        elif tiles is None:
            tiles = host_tile.choose_host_tiles(program, grid_shape, budget, nf,
                                                mesh_shape=mesh_shape)
            logger.info("--host-tile auto -> %s", "x".join(map(str, tiles)))
        return host_tile.plan_host_tiling(program, grid_shape, tiles, nf)
    except ValueError as e:
        raise SystemExit(f"--host-tile: {e}") from None


def _footprint_warning(program, grid_shape, args) -> None:
    """A whole grid that cannot fit the card should point at --host-tile."""
    import torch

    from ..ir.dtypes import storage_bytes

    if args.hbm_budget is not None:
        budget = args.hbm_budget
    elif args.device != "cpu" and torch.cuda.is_available():
        budget, _ = torch.cuda.mem_get_info(torch.device(args.device))
    else:
        return
    foot = 2 * math.prod(grid_shape) * storage_bytes(
        program, program.input_names + program.output_names)
    if foot > budget:
        logger.warning(
            "grid %s needs ~%.1f GiB of device memory (%.1f GiB %s): a "
            "whole-grid run will likely run out of memory; use --host-tile auto",
            grid_shape, foot / 2**30, budget / 2**30,
            "budget" if args.hbm_budget is not None else "free on the card")


def _mesh_report_line(program, shape, tiling, mesh) -> str:
    """The modeled halo exchange of a shard (of a tile, with --host-tile)
    over a pass, beside the bytes of the shard's state with its halos."""
    from ..ir.dtypes import storage_bytes
    from ..parallel import host_tile

    sizes, _, links = mesh
    ext, nf = (tiling[2], tiling[4]) if tiling else (shape, max(program.iterate, 1))
    xbytes, shard = host_tile.model_mesh_exchange(program, ext, sizes, None, nf)
    state = math.prod(shard) * storage_bytes(program, program.input_names)
    xh = (f"{xbytes / 2**20:.1f} MiB" if xbytes >= 2**20
          else f"{xbytes / 2**10:.1f} KiB")
    return (f"  mesh{' per tile' if tiling else ''}: shards of "
            f"{'x'.join(map(str, shard))} over {'x'.join(map(str, sizes))} "
            f"devices; modeled {'+'.join(sorted(set(links.values())))} halo "
            f"exchange {xh}/device/pass ({100 * xbytes / state:.2f}% of the "
            f"shard's state bytes; cadence-invariant total, see "
            f"parallel/host_tile.model_mesh_exchange)")


def _verify(program, outs, gold, rim) -> bool:
    from ..utils.testing import compare_outputs

    for n in program.output_names:
        diff = np.abs(outs[n].astype(np.float64) - gold[n].astype(np.float64))
        if rim:
            diff = diff[tuple(slice(rim, -rim) for _ in range(diff.ndim))]
        print(f"{n}: max |diff| vs oracle = {float(diff.max()) if diff.size else 0.0}"
              + (f" (outside the rim of {rim})" if rim else ""))
    return compare_outputs(program, outs, gold, rim)


def _benchmark(program, the_plan, ins, ps, args, updates_per_cell: int) -> None:
    """Time the selected backend on the card with CUDA events: a warm-up
    call (which builds the kernels), then back-to-back calls."""
    import torch

    from ..backend import cuda, eager
    from ..backend.io import to_torch
    from ..utils import report
    from ..utils.device import resolve

    dev = resolve(args.device)
    tins, tps = to_torch(program, ins, ps, dev)
    if args.backend == "cuda":
        fn = cuda.build_fn(program, the_plan)

        def call():
            fn(tins, tps)
    else:
        def call():
            eager.run(program, tins, tps, device=dev)

    call()
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    call()
    end.record()
    end.synchronize()
    reps = max(3, min(100, int(500 / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        call()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    updates = math.prod(the_plan.grid_shape) * max(program.iterate, 1) * updates_per_cell
    rep = report.analyze(the_plan)
    r = report.rates(rep, ms / 1e3 / rep.calls, report.card())
    print(f"benchmark ({args.backend}, {reps} calls after a warm-up, CUDA events): "
          f"{ms:.4f} ms/call  {updates / (ms / 1e3) / 1e9:.2f} GCell-updates/s")
    print(f"bound: {rep.program_bound_ms:.4f} ms a program run ({rep.bound_by}); "
          f"{100 * r['share_of_bound']:.1f}% of the bound; "
          f"{r['achieved_gbps_at_ideal_bytes']:.1f} GB/s at the ideal "
          f"{rep.ideal_bytes_per_cell:g} B/cell a call; card {r['card']}")


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose >= 2 else
        logging.INFO if args.verbose == 1 else logging.WARNING,
        format="%(levelname)s %(name)s: %(message)s")
    from ..frontend.parser import parse_file
    from ..plan.planner import plan
    from ..utils import report
    from ..utils.testing import rand_inputs

    if args.sweeps is not None and args.sweeps < 1:
        raise SystemExit(f"--sweeps wants a positive count, got {args.sweeps}")
    if args.benchmark and (args.host_tile or args.backend == "numpy"):
        # refused from argv, before any (possibly long) run
        raise SystemExit(
            "--benchmark times --backend cuda|eager on the whole grid (got "
            f"{'--host-tile' if args.host_tile else '--backend numpy'})")
    if args.benchmark and args.device == "cpu":
        raise SystemExit("--benchmark times the card: drop --device cpu")
    if args.host_tile is None and args.host_tile_sweeps is not None:
        raise SystemExit("--host-tile-sweeps needs --host-tile")
    if args.host_tile and args.backend == "eager":
        raise SystemExit("--host-tile runs the kernels: use --backend cuda")
    mesh_flags = [f for f, v in (("--sweeps-per-exchange", args.sweeps_per_exchange),
                                 ("--mesh-overlap", args.mesh_overlap),
                                 ("--link-model", args.link_model)) if v]
    if args.mesh_local_backend != "cuda":
        mesh_flags.append("--mesh-local-backend")
    if args.mesh is None and mesh_flags:
        raise SystemExit(f"{', '.join(mesh_flags)} needs --mesh")
    if args.mesh is not None:
        if args.benchmark:
            # refused from argv, as the reference does
            raise SystemExit("--benchmark times one card's kernels on the whole "
                             "grid: drop --mesh")
        if args.backend != "cuda":
            raise SystemExit("--mesh runs --mesh-local-backend on every shard: "
                             "drop --backend")
        if args.sweeps is not None or args.block or args.smem_budget is not None:
            raise SystemExit("--sweeps, --block and --smem-budget plan the whole "
                             "grid; under --mesh every shard is planned for its "
                             "own shape")
        try:
            args.mesh = _parse_mesh(args.mesh)
        except ValueError:
            raise SystemExit(f"--mesh: want sizes ('2,2') or named axes "
                             f"('dcn:2,x:2'), got {args.mesh!r}") from None
        args.sweeps_per_exchange = _parse_cadence(args.sweeps_per_exchange, args.mesh[1])
        if args.link_model:
            from ..parallel.mesh import set_link_model
            try:
                set_link_model(args.link_model)
            except ValueError as e:
                raise SystemExit(str(e)) from None
    program = parse_file(args.soda_src, _overrides(args))
    updates_per_cell = 1
    if args.unroll_iterate is not None:
        from ..optimize.unroll import unroll_iterate
        factor = args.unroll_iterate or max(program.iterate, 1)
        if program.iterate <= 1 or factor <= 1:
            logger.warning("--unroll-iterate has no effect: iterate=%d",
                           program.iterate)
        else:
            try:
                program = unroll_iterate(program, factor)
            except (ValueError, TypeError) as e:
                raise SystemExit(f"--unroll-iterate: {e}") from None
            updates_per_cell = factor
    if args.tcse:
        from ..optimize import tcse
        before = tcse.count_adds(program)
        program = tcse.apply(program)
        logger.info("tcse: %d adds -> %d", before, tcse.count_adds(program))
    print(program.describe())
    shape = _grid_shape(program, args)
    if args.mesh is not None:
        from ..parallel.sharded import check_mesh_dims
        try:
            check_mesh_dims(program.rank, args.mesh[0])
        except ValueError as e:
            raise SystemExit(f"--mesh: {e}") from None

    plan_kw = {k: v for k, v in (("sweeps", args.sweeps), ("block", args.block),
                                 ("smem_budget", args.smem_budget))
               if v is not None}
    tiling = None
    try:
        if args.host_tile:
            # the plan (and the report) of the kernel every tile runs: at
            # the halo-extended tile shape and the pass's sweeps
            tiling = _host_tiling(program, shape, args,
                                  args.mesh[0] if args.mesh else None)
            _, _, ext, _, nf, _, _ = tiling
            the_plan = plan(program, ext, **plan_kw,
                            iterate=None if nf == max(program.iterate, 1) else nf)
        else:
            the_plan = plan(program, shape, **plan_kw)
            if args.mesh is None:
                _footprint_warning(program, shape, args)
    except ValueError as e:
        raise SystemExit(f"no CUDA plan: {e}") from None
    print(the_plan.describe())

    if args.dump_plan is not None:
        j = json.dumps(the_plan.to_json(), indent=2)
        if args.dump_plan == "-":
            print(j)
        else:
            pathlib.Path(args.dump_plan).write_text(j)
    if args.report:
        rep = report.analyze(the_plan)
        print(rep.pretty())
        for line in _inert_lines(program):
            print(f"  accepted-inert: {line}")
        if tiling is not None:
            from ..ir.dtypes import storage_bytes
            tiles, _, ext, nt, nf, passes, ov = tiling
            link = (math.prod(nt) * math.prod(ext)
                    * storage_bytes(program, program.input_names)
                    + math.prod(shape)
                    * storage_bytes(program, program.output_names))
            print(f"  host tiling: {'x'.join(map(str, nt))} tiles of "
                  f"{'x'.join(map(str, tiles))} (+halo -> "
                  f"{'x'.join(map(str, ext))}), {passes} pass(es) x {nf} "
                  f"sweep(s); read amplification {ov:.3f}x a pass (the "
                  f"halos' recompute); the plan above is the kernel's at the "
                  f"extended tile shape; effective "
                  f"{rep.plan_bytes_per_cell_update * ov:.3f} B/cell-update on "
                  f"the card = per tile x amplification; {link / 2**20:.1f} MiB "
                  f"across the host link a pass")
        if args.mesh is not None:
            print(_mesh_report_line(program, shape, tiling, args.mesh))
    _write_artifacts(program, shape, args)

    if not (args.run or args.benchmark):
        return 0
    if args.backend == "cuda":
        # the kernels (and so the mesh and host tiling) take integers up
        # to 64 bits; the message names the backends that take wider ones
        from ..ir.dtypes import check_kernel_types
        from ..ir.types import UnsupportedTypeError
        try:
            check_kernel_types(program)
        except UnsupportedTypeError as e:
            raise SystemExit(str(e)) from None
    ins, ps = rand_inputs(program, shape, np.random.default_rng(args.seed))
    profiler = None
    if args.profile:
        import torch

        from ..utils import trace
        acts = [torch.profiler.ProfilerActivity.CPU]
        if args.device != "cpu" and torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
        from ..backend import cuda
        cuda.reset_launches()   # the spans, intervals and counts of the run alone
        profiler.__enter__()
    rc = 0
    try:
        if args.run:
            rc = _run_and_verify(program, the_plan, tiling, shape, ins, ps, args, plan_kw)
        if args.benchmark and rc == 0:
            _benchmark(program, the_plan, ins, ps, args, updates_per_cell)
    finally:
        if profiler is not None:
            profiler.__exit__(None, None, None)
            out = pathlib.Path(args.profile)
            out.mkdir(parents=True, exist_ok=True)
            profiler.export_chrome_trace(str(out / f"{program.name}.trace.json"))
            print(f"profiler trace written to {out / f'{program.name}.trace.json'}")
            for line in _trace_table(the_plan):
                print(line)
    return rc


def _trace_table(the_plan) -> list[str]:
    """The program's spans over the profiled run (count, total and self
    ms) and its device intervals by card, as `utils/trace.py` holds them;
    then the z-march's launches by feed (`cuda.feed_counts()`), the stages
    they computed on chip (`cuda.stage_count()`), the rank-2 cascades'
    launches by march (`cuda.march_counts()`), the bytes planned for every
    launch (`cuda.planned_bytes()`) and each z-march group's feed."""
    from ..backend import cuda
    from ..utils import trace

    lines = [f"{'span':<24} {'count':>8} {'total ms':>12} {'self ms':>12}"]
    for name, t in sorted(trace.totals().items()):
        lines.append(f"{name:<24} {t.count:>8} {t.total_s * 1e3:>12.3f} "
                     f"{t.self_s * 1e3:>12.3f}")
    for kind, by_card in trace.device_ms().items():
        for card, (n, ms) in by_card.items():
            lines.append(f"interval {kind} on {card}: {n} x, {ms:.3f} ms, "
                         f"{ms / n:.4f} ms each")
    lines.append(f"z-march launches by feed: {cuda.feed_counts()}")
    lines.append(f"z-march stages on chip: {cuda.stage_count()}")
    lines.append(f"march launches (rank-2 cascades, z-march): {cuda.march_counts()}")
    lines.append(f"planned device-memory bytes: {cuda.planned_bytes()}")
    for i, g in enumerate(the_plan.groups):
        if g.kernel == "linebuffer3d":
            ahead = f", {g.ahead} step(s) ahead" if g.ahead else ""
            lines.append(f"group {i}: march {g.march}, feed {g.feed}{ahead}, "
                         f"{g.ctas_per_sm} CTAs an SM, grid {g.grid}")
    return lines


def _run_and_verify(program, the_plan, tiling, shape, ins, ps, args, plan_kw) -> int:
    from ..backend import cuda, eager
    from ..backend.io import to_numpy
    from ..utils.testing import oracle

    t0 = time.perf_counter()
    rim = 0
    if args.backend == "numpy":
        outs = oracle(program, ins, ps)
    elif tiling is not None:
        from ..parallel.host_tile import run_host_tiled
        tiles, _, _, _, nf, _, _ = tiling
        st = {}
        mesh_kw = {}
        if args.mesh is not None:
            # every tile sharded over the mesh
            mesh_kw = dict(
                mesh=_make_mesh(args), link_classes=args.mesh[2],
                local_backend=args.mesh_local_backend,
                sweeps_per_exchange=args.sweeps_per_exchange, overlap=args.mesh_overlap)
        outs = run_host_tiled(program, ins, ps, tiles=tiles, sweeps_per_pass=nf,
                              device=args.device, stats=st, **plan_kw, **mesh_kw)
        # deeper passes differ from the whole grid inside the rim, by design,
        # and so do a mesh's shards of a multi-stage program at the grid's edge
        rim = 0 if nf == 1 and not mesh_kw else program.valid_rim()
        print(f"host tiling: {st['n_tiles']} tiles, {st['passes']} pass(es), "
              f"{sum(st['pass_seconds']):.3f} s; {st['h2d_bytes']} B to the "
              f"card, {st['d2h_bytes']} B back"
              + (f"; {st['mesh_exchange_bytes']} B between shards; into the shards "
                 f"by source {st['scatter_from']}" if mesh_kw else ""))
    elif args.mesh is not None:
        from ..parallel.mesh import run_sharded
        sizes, _, links = args.mesh
        st = {}
        outs = to_numpy(program, run_sharded(
            program, ins, ps, mesh=_make_mesh(args), link_classes=links,
            sweeps_per_exchange=args.sweeps_per_exchange,
            local_backend=args.mesh_local_backend, overlap=args.mesh_overlap,
            stats=st))
        rim = program.valid_rim()
        print(f"mesh: {'x'.join(map(str, sizes))} shards of "
              f"{'x'.join(map(str, st['shard_shape']))} on {st['devices']}, "
              f"{st['sweeps_per_exchange']} sweep(s) an exchange; "
              f"{st['exchange_bytes']} B between shards, {st['group_calls']} "
              f"group calls; into the shards by source {st['scatter_from']}, "
              f"{st['gather_bytes']} B gathered")
    elif args.backend == "eager":
        outs = to_numpy(program, eager.run(program, ins, ps, device=args.device))
    else:
        outs = to_numpy(program, cuda.run(program, ins, ps, device=args.device,
                                          the_plan=the_plan))
    wall = time.perf_counter() - t0
    print(f"executed {program.name} on {shape} ({args.backend}"
          f"{' mesh' if args.mesh else ''}, {args.device}): "
          f"{wall:.3f} s (kernel builds included)")
    if args.backend == "numpy":
        return 0
    ok = _verify(program, outs, oracle(program, ins, ps), rim)
    print("OK" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
