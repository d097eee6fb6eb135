"""Host tiling: a grid larger than the card runs as a loop over
overlapping tiles.

The port of `soda_tpu/parallel/host_tile.py`.  The full grid lives in host
memory as numpy arrays; each tile is extended by a halo (its window), runs
through the port's main path (`backend/cuda.py::build_fn`: kernels 1 to 4
and the fused sweeps), and the tile's interior is stitched back on the
host.  Only two extended tiles at a time touch the card, so the grid is
bounded by host memory, not by the card's 80 GB.  With a mesh
(`run_host_tiled(mesh=...)`) each tile runs sharded over it
(`parallel/mesh.py::build_sharded_fn`): host tiles, then mesh shards, then
the kernels' tiles, for a grid larger than all the mesh's devices; the
budget is then per device (`_shard_ext_shape`), and `model_mesh_exchange`
models the halo bytes a tile's shards exchange.  A tile's window then goes
from the host grid straight to every shard's device, and its outputs come
straight back (`parallel/sharded.py`), each card on a copy stream and a
compute stream of its own (`_mesh_tiles`).

The geometry is the reference's:
- halo per tiled dim = the chain creep of one sweep x sweeps per pass,
  so every stitched cell lies at least `creep x nf` deep in its extended
  tile and equals the whole-grid evaluation;
- all tiles share one extended shape, so one `build_fn` (one plan, one
  set of kernels) serves every tile and every pass;
- between passes the first output feeds the first input, auxiliary
  inputs carry over.
Where an extended tile would cross the grid's edge, its window moves
inside the grid until its side lies on the edge (a dim whose extended
tile exceeds the grid takes the whole dim), and the tile's cells are
stitched from where they sit in the moved window.  The kernels store zero
outside their grid at every stage and every fused sweep, as the oracle
does outside the whole grid, so a window's side on the grid's edge is
evaluated as the whole grid is there, and its other sides lie at least
`creep x nf` from every stitched cell.
Correctness contract: every stitched cell is evaluated as the whole-grid
run evaluates it, multi-stage programs included, on the whole grid: bit
for bit at one sweep a pass, and with deeper passes up to the order in
which the window's plan and the whole grid's fuse sweeps (integers bit
for bit); over a mesh, the mesh's contract.  That is more than
docs/SEMANTICS.md asks: the reference zero-fills a tile past the grid's
edge, so an intermediate stage evaluated there, and every sweep of a
deeper pass, differ inside `valid_rim()`.

On the card the tiles overlap (`in_flight=2`): two pinned host staging
buffers per input (each an extended tile) and per output (each a tile
interior), a copy stream and the compute stream.  Tile k+1's window is
sliced straight from the host grid into its pinned buffer
(torch's `copy_`, which uses the host's threads) and copied to the card
on the copy stream while the compute stream runs tile k; tile k's
interior comes back on the copy stream into a pinned output buffer and is
stitched once its event has fired.  CUDA events order the streams; the
host waits only on the event of the slot it is about to reuse.  The
device buffers (inputs, and every output through `build_fn`'s `bufs=`)
are allocated once a run and stay alive until the run has synchronised,
so the caching allocator never hands them to another stream meanwhile.
On the CPU (`device="cpu"`) each tile runs the plain versions, as
`cuda.run(device="cpu")` does.  Every integer up to 64 bits runs, uint64
copied through its int64 view (`ir/dtypes.py::bits`); wider
ones are refused, as the reference refuses them
(`ir/dtypes.py::check_kernel_types`).

Cost (`sodac --report`): per pass each tile reads (T + 2h)^d cells to
produce T^d, the reference host's halo recompute, and `passes = iterate /
nf` passes each stream the whole grid across the host link once.
"""

from __future__ import annotations

import itertools
import logging
import math
import time

import numpy as np
import torch

from ..backend.cuda import build_fn
from ..backend.io import check_io, params_to_torch
from ..ir.dtypes import bits, check_kernel_types, storage_bytes, torch_dtype
from ..ir.program import StencilProgram
from ..utils.device import resolve
from .mesh import build_sharded_fn
from .sharded import check_mesh_dims, gather_grid, on_streams, shard_grid

logger = logging.getLogger(__name__)

# the share of the card's free memory `default_hbm_budget` gives the tiles
FREE_MEMORY_SHARE = 0.5


def normalize_tiles(grid_shape, tiles) -> tuple[int, ...]:
    """Clamp the requested tile shape to the grid; 0/None = full extent."""
    if len(tiles) != len(grid_shape):
        raise ValueError(
            f"--host-tile rank {len(tiles)} != grid rank {len(grid_shape)}")
    out = []
    for t, n in zip(tiles, grid_shape):
        t = n if not t else min(int(t), n)
        if t < 1:
            raise ValueError(f"tile size {t} must be >= 1")
        out.append(t)
    return tuple(out)


def plan_host_tiling(program: StencilProgram, grid_shape, tiles,
                     sweeps_per_pass: int | None = None,
                     iterate: int | None = None):
    """Geometry shared by run_host_tiled and the report: returns
    (tiles, halos, ext_shape, n_tiles, nf, passes, overhead) where
    `overhead` is the per-pass read amplification prod(ext/tile)."""
    it = max(program.iterate if iterate is None else iterate, 1)
    nf = it if sweeps_per_pass is None else int(sweeps_per_pass)
    if nf < 1 or it % nf != 0:
        raise ValueError(
            f"sweeps_per_pass {nf} must divide iterate {it}")
    tiles = normalize_tiles(grid_shape, tiles)
    creep = program.chain_creep()
    halos = tuple(
        (-creep[d][0] * nf, creep[d][1] * nf) if tiles[d] < grid_shape[d]
        else (0, 0)
        for d in range(program.rank))
    ext_shape = tuple(t + lo + hi for t, (lo, hi) in zip(tiles, halos))
    n_tiles = tuple(-(-n // t) for n, t in zip(grid_shape, tiles))
    overhead = math.prod(ext_shape) / math.prod(tiles)
    return tiles, halos, ext_shape, n_tiles, nf, it // nf, overhead


def _shard_ext_shape(program: StencilProgram, ext_shape, mesh_shape,
                     mesh_dims, nf: int) -> tuple[int, ...]:
    """Shape of one device's shard when a (halo-extended) host tile of
    `ext_shape` is sharded over a mesh of `mesh_shape` along `mesh_dims`
    (default: the leading dims, as `mesh.build_sharded_fn`): each sharded
    dim becomes ceil(ext / m) plus the exchange halo, at most the chain
    creep x nf (the automatic cadence only shrinks it)."""
    dims = check_mesh_dims(program.rank, mesh_shape, mesh_dims)
    creep = program.chain_creep()
    shard = list(ext_shape)
    for m, d in zip(mesh_shape, dims):
        lo, hi = -creep[d][0] * nf, creep[d][1] * nf
        shard[d] = -(-ext_shape[d] // int(m)) + lo + hi
    return tuple(shard)


def model_mesh_exchange(program: StencilProgram, ext_shape, mesh_shape,
                        mesh_dims, nf: int):
    """Modelled halo-exchange bytes of one device in the middle of every
    axis, for one mesh-sharded host tile over one pass of `nf` sweeps: each
    sharded axis moves nf x (lo + hi) rows (lo, hi: the chain creep of one
    sweep) whatever the cadence (cadence k moves k x (lo + hi) rows nf / k
    times), which is what `mesh.halo_exchange` moves.  A row spans the
    halos of the axes exchanged before it and the centres of those after
    it (the exchange goes axis by axis in mesh order); its payload is the
    inputs in their storage dtypes.  Returns (bytes, the shard's shape
    with its halos)."""
    dims = check_mesh_dims(program.rank, mesh_shape, mesh_dims)
    shard = _shard_ext_shape(program, ext_shape, mesh_shape, dims, nf)
    creep = program.chain_creep()
    state = storage_bytes(program, program.input_names)
    centre = {d: -(-ext_shape[d] // int(m)) for m, d in zip(mesh_shape, dims)}
    per_dev = 0
    for q, (m, d) in enumerate(zip(mesh_shape, dims)):
        if int(m) <= 1:
            continue
        cross = math.prod(centre[e] if e in dims[q + 1:] else shard[e]
                          for e in range(len(shard)) if e != d)
        per_dev += nf * (-creep[d][0] + creep[d][1]) * cross * state
    return per_dev, shard


def choose_sweeps_per_pass(program: StencilProgram, grid_shape,
                           tiles=None, hbm_budget: int | None = None,
                           iterate: int | None = None, mesh_shape=None,
                           mesh_dims=None):
    """Pick `sweeps_per_pass` minimizing modeled streamed traffic: each
    pass streams every (halo-extended) tile across the host link once,
    and halos grow with chain-creep x nf, so small nf pays more passes
    while large nf pays halo recompute (and can outgrow the tile).  Scores
    every divisor nf of iterate by passes x (the tiles' extended input
    bytes + the grid's output bytes); ties prefer the DEEPER nf (fewer
    passes).  With tiles=None ('--host-tile auto'), tiles are re-chosen
    per candidate under `hbm_budget` (per device with `mesh_shape`, as
    `choose_host_tiles`).  Returns (nf, tiles)."""
    if tiles is None and hbm_budget is None:
        raise ValueError(
            "choose_sweeps_per_pass needs explicit tiles or an "
            "hbm_budget to choose them under")
    if mesh_shape:
        check_mesh_dims(program.rank, mesh_shape, mesh_dims)
    it = max(program.iterate if iterate is None else iterate, 1)
    divisors = [k for k in range(1, it + 1) if it % k == 0]
    in_b = storage_bytes(program, program.input_names)
    out_b = storage_bytes(program, program.output_names)
    best = None  # ((cost, -nf), nf, tiles)
    for nf in divisors:
        try:
            ts = tiles if tiles is not None else choose_host_tiles(
                program, grid_shape, hbm_budget, nf, iterate, mesh_shape,
                mesh_dims)
            _, _, ext, nt, _, passes, _ = plan_host_tiling(
                program, grid_shape, ts, nf, iterate)
        except ValueError:
            continue  # nf's halos don't fit any admissible tile
        cost = passes * (math.prod(nt) * math.prod(ext) * in_b
                         + math.prod(grid_shape) * out_b)
        key = (cost, -nf)
        if best is None or key < best[0]:
            best = (key, nf, ts)
    if best is None:
        raise ValueError(
            f"no sweeps_per_pass admits a tile of grid "
            f"{tuple(grid_shape)} under the budget; raise --hbm-budget")
    logger.info("--host-tile-sweeps auto -> %d (of iterate %d)",
                best[1], it)
    return best[1], best[2]


def choose_host_tiles(program: StencilProgram, grid_shape,
                      hbm_budget: int, sweeps_per_pass: int | None = None,
                      iterate: int | None = None, mesh_shape=None,
                      mesh_dims=None) -> tuple[int, ...]:
    """Pick a tile shape whose device footprint fits `hbm_budget` bytes:
    repeatedly halve the largest leading dim (the last, contiguous dim
    last, floored at 256) until it fits.  Footprint = every program tensor
    at the halo-extended tile shape in its storage dtype (`half` 2 B, 64-bit
    values 8 B), x 2 (two tiles in flight, or the feedback's two copies).
    With `mesh_shape` (the tile runs sharded over a mesh) the budget is per
    device: the footprint is taken at a shard's shape with its exchange
    halos (`_shard_ext_shape`)."""
    if mesh_shape:
        check_mesh_dims(program.rank, mesh_shape, mesh_dims)
    tiles = list(normalize_tiles(grid_shape, (0,) * len(grid_shape)))
    per_cell = storage_bytes(program, program.tensors)

    def footprint(ts) -> int:
        _, _, ext, _, nf, _, _ = plan_host_tiling(
            program, grid_shape, ts, sweeps_per_pass, iterate)
        if mesh_shape:
            ext = _shard_ext_shape(program, ext, mesh_shape, mesh_dims, nf)
        return math.prod(ext) * per_cell * 2

    rank = program.rank
    while footprint(tiles) > hbm_budget:
        # cut leading dims first: a halo on the last dim makes the rows
        # odd, which costs the row-march its 16-byte copies
        cut = [i for i in range(rank - 1) if tiles[i] > 8] or (
            [rank - 1] if tiles[rank - 1] > 256 else [])
        if not cut:
            raise ValueError(
                f"cannot tile grid {tuple(grid_shape)} under hbm budget "
                f"{hbm_budget} bytes: minimum tile footprint is "
                f"{footprint(tiles)} bytes (tiles {tuple(tiles)}); raise "
                f"--hbm-budget or pass --host-tile explicitly")
        d = max(cut, key=lambda i: tiles[i])
        tiles[d] = -(-tiles[d] // 2)
    return tuple(tiles)


def default_hbm_budget(device="cuda") -> int:
    """FREE_MEMORY_SHARE of the card's free memory now
    (`torch.cuda.mem_get_info`); raises `NoCudaDevice` without a card."""
    free, _ = torch.cuda.mem_get_info(resolve(device))
    return int(free * FREE_MEMORY_SHARE)


def _window(starts, tiles, halos, win, grid_shape):
    """(origin, dst, src): where the tile's window starts in the grid (its
    extended tile, moved inside the grid), the tile's cells in the grid
    (edge tiles clip to it), and where they sit in the window."""
    origin = tuple(min(max(s - lo, 0), n - w)
                   for s, (lo, _), w, n in zip(starts, halos, win, grid_shape))
    dst = tuple(slice(s, min(s + t, n))
                for s, t, n in zip(starts, tiles, grid_shape))
    src = tuple(slice(sl.start - o, sl.stop - o) for o, sl in zip(origin, dst))
    return origin, dst, src


def _card_tiles(program: StencilProgram, fn, dev, params, win, tiles, slots: int,
                record: dict):
    """A tile at a time through `build_fn` on one device: `run(s, windows,
    src)` starts slot `s`'s tile (the inputs' windows) and returns what the
    slot holds; `stitch(s, held)` returns the tile's cells (`src` of its
    window) on the host, once they are there.

    On the card: two pinned staging buffers a slot (the extended tile, its
    interior), a copy stream and the compute stream, ordered by events;
    device buffers made once.  On the CPU each tile runs at once."""
    pars = params_to_torch(program, params, dev)
    dtypes = {n: torch_dtype(program.tensors[n].type) for n in program.tensors
              if n in program.input_names or n in program.output_names}
    on_card = dev.type == "cuda"
    stage_in = [{n: torch.empty(win, dtype=dtypes[n], pin_memory=on_card)
                 for n in program.input_names} for _ in range(slots)]
    if not on_card:
        def run_cpu(s: int, windows: dict, src):
            for n, buf in stage_in[s].items():
                bits(buf).copy_(bits(windows[n]))
            outs = fn(stage_in[s], pars)
            return {n: outs[n][src] for n in program.output_names}

        return run_cpu, lambda s, cells: cells
    dev_in = [{n: torch.empty(win, dtype=dtypes[n], device=dev)
               for n in program.input_names} for _ in range(slots)]
    dev_bufs = [fn.alloc(dev) for _ in range(slots)]
    stage_out = [{n: torch.empty(math.prod(tiles), dtype=dtypes[n], pin_memory=True)
                  for n in program.output_names} for _ in range(slots)]
    copy_stream = torch.cuda.Stream(dev)
    compute_stream = torch.cuda.Stream(dev)
    # the params were copied to the card on the current stream
    compute_stream.wait_stream(torch.cuda.current_stream(dev))
    h2d_done = [torch.cuda.Event() for _ in range(slots)]
    computed = [torch.cuda.Event() for _ in range(slots)]
    d2h_done = [torch.cuda.Event() for _ in range(slots)]
    in_bytes = math.prod(win) * storage_bytes(program, program.input_names)
    out_cell = storage_bytes(program, program.output_names)

    def run(s: int, windows: dict, src):
        t0 = time.perf_counter()
        for n, buf in stage_in[s].items():
            bits(buf).copy_(bits(windows[n]))
        record["stage_seconds"] += time.perf_counter() - t0
        with torch.cuda.stream(copy_stream):
            for n, buf in stage_in[s].items():
                bits(dev_in[s][n]).copy_(bits(buf), non_blocking=True)
            h2d_done[s].record(copy_stream)
        compute_stream.wait_event(h2d_done[s])
        with torch.cuda.stream(compute_stream):
            outs = fn(dev_in[s], pars, bufs=dev_bufs[s])
            computed[s].record(compute_stream)
        # the interior goes back on the copy stream once the tile is
        # computed, into the slot's pinned buffer
        shape = tuple(sl.stop - sl.start for sl in src)
        copy_stream.wait_event(computed[s])
        with torch.cuda.stream(copy_stream):
            for n, buf in stage_out[s].items():
                bits(buf)[:math.prod(shape)].view(shape).copy_(
                    bits(outs[n])[src], non_blocking=True)
            d2h_done[s].record(copy_stream)
        record["h2d_bytes"] += in_bytes
        record["d2h_bytes"] += math.prod(shape) * out_cell
        return {n: buf[:math.prod(shape)].view(shape) for n, buf in stage_out[s].items()}

    def stitch(s: int, cells: dict) -> dict:
        t0 = time.perf_counter()
        d2h_done[s].synchronize()
        record["wait_seconds"] += time.perf_counter() - t0
        return cells

    return run, stitch


def _mesh_tiles(program: StencilProgram, fn, mesh, params, win, slots: int, record: dict):
    """A tile at a time sharded over `mesh` (`fn` from `build_sharded_fn`),
    with `_card_tiles`' interface.  The host copies a tile's window into
    its slot's pinned window (one a slot for every input and output, made
    once); `shard_grid` copies that to every shard by its contiguous runs
    on each card's copy stream; each card's compute stream runs once that
    card's copies have landed; and `gather_grid(..., "cpu", out=)` brings
    the outputs back by runs into the slot's pinned windows on the copy
    streams once each card has computed them.  No byte passes through
    another card.  On CPU shards each tile runs at once."""
    cards = sorted({d for d in mesh.devices.flat if d.type == "cuda"}, key=str)
    copy_streams = {d: torch.cuda.Stream(d) for d in cards}
    compute_streams = {d: torch.cuda.Stream(d) for d in cards}
    for d, stream in compute_streams.items():
        stream.wait_stream(torch.cuda.current_stream(d))
    h2d_done = [{d: torch.cuda.Event() for d in cards} for _ in range(slots)]
    computed = [{d: torch.cuda.Event() for d in cards} for _ in range(slots)]
    dtypes = {n: torch_dtype(program.tensors[n].type)
              for n in [*program.input_names, *program.output_names]}
    pinned = [{n: torch.empty(win, dtype=dt, pin_memory=bool(cards))
               for n, dt in dtypes.items()} for _ in range(slots)]
    record["scatter_from"] = {}

    def run(s: int, windows: dict, src):
        moved: dict = {}
        t0 = time.perf_counter()
        for n, w in windows.items():
            bits(pinned[s][n]).copy_(bits(w))
        with on_streams(copy_streams.values()):
            grids = {n: shard_grid(pinned[s][n], mesh, fn.dims, stats=moved)
                     for n in windows}
            for d, stream in copy_streams.items():
                h2d_done[s][d].record(stream)
        record["stage_seconds"] += time.perf_counter() - t0
        for d, stream in compute_streams.items():
            stream.wait_event(h2d_done[s][d])
        with on_streams(compute_streams.values()):
            outs = fn(grids, params)
            for d, stream in compute_streams.items():
                computed[s][d].record(stream)
        record["mesh_exchange_bytes"] += fn.stats["exchange_bytes"]
        record["mesh_group_calls"] += fn.stats["group_calls"]
        if cards:
            record["h2d_bytes"] += moved["scatter_bytes"]
        for dev, nbytes in moved["scatter_from"].items():
            record["scatter_from"][dev] = record["scatter_from"].get(dev, 0) + nbytes
        return src, grids, outs       # the input shards live until stitched

    def stitch(s: int, held) -> dict:
        src, _, outs = held
        for d, stream in copy_streams.items():
            stream.wait_event(computed[s][d])
        moved: dict = {}
        t0 = time.perf_counter()
        with on_streams(copy_streams.values()):
            host = {n: gather_grid(g, "cpu", stats=moved, out=pinned[s][n])
                    for n, g in outs.items()}
        record["wait_seconds"] += time.perf_counter() - t0
        if cards:
            record["d2h_bytes"] += moved.get("gather_bytes", 0)
        return {n: t[src] for n, t in host.items()}

    return run, stitch


def run_host_tiled(program: StencilProgram, inputs, params=None, *,
                   tiles, grid_shape=None, sweeps_per_pass=None,
                   iterate=None, device="cuda", in_flight: int = 2,
                   stats: dict | None = None, mesh=None, mesh_dims=None,
                   sweeps_per_exchange=None, local_backend="cuda",
                   overlap=False, link_classes=None, **plan_kwargs) -> dict:
    """Run `program` over a grid held in host memory by looping
    overlapping tiles through the port's main path on `device` ("cuda",
    the default, or "cpu").  Inputs are numpy arrays (or CPU tensors) of
    the whole grid; returns numpy outputs in the declared dtypes.

    `in_flight` tiles share the card (2: tile k+1's copies overlap tile
    k's kernels; 1: one tile at a time).  `stats`, if given, receives the
    geometry, the wall seconds of each pass, the host's seconds in all
    copying windows into pinned staging (`stage_seconds`), waiting for a
    tile's outputs to reach the host (`wait_seconds`) and copying its cells
    into the grid (`stitch_seconds`), and the bytes copied to and from the
    card (and, with a mesh, between its shards, and the shards'
    group calls: on cards, their kernel launches).

    With `mesh` (`parallel/mesh.py::Mesh`) each tile runs sharded over it
    along `mesh_dims`, with the mesh's cadence, local backend, overlap and
    link classes (`mesh.build_sharded_fn`): each shard of a tile's window
    goes from the host straight to its own device and back
    (`parallel/sharded.py`), and `stats["scatter_from"]` counts the bytes
    by source.  The mesh's contract (`parallel/mesh.py`) then holds:
    deeper passes, and a multi-stage program's intermediate stages, differ
    inside `valid_rim()`, where the shards' exchange zero-fills."""
    if mesh is not None:
        check_mesh_dims(program.rank, mesh.devices.shape, mesh_dims)
        device = mesh.devices.flat[0]
    dev = resolve(device)
    if in_flight not in (1, 2):
        raise ValueError(f"in_flight is 1 or 2, not {in_flight}")
    check_kernel_types(program)
    params = dict(params or {})
    check_io(program, inputs, params)
    host = {n: torch.from_numpy(np.ascontiguousarray(
                np.asarray(inputs[n], dtype=program.tensors[n].type.np_dtype())))
            for n in program.input_names}
    if grid_shape is None:
        grid_shape = tuple(next(iter(host.values())).shape)
    grid_shape = tuple(grid_shape)
    for n, a in host.items():
        if tuple(a.shape) != grid_shape:
            # a window would silently read past the mismatch
            raise ValueError(
                f"input {n!r} has shape {tuple(a.shape)}, expected grid "
                f"shape {grid_shape}")
    tiles, halos, ext_shape, n_tiles, nf, passes, overhead = \
        plan_host_tiling(program, grid_shape, tiles, sweeps_per_pass, iterate)
    # every tile's window: its extended tile, moved inside the grid
    win = tuple(min(e, n) for e, n in zip(ext_shape, grid_shape))
    logger.info(
        "host tiling %s: %s tiles of %s (+halo -> %s), %d pass(es) of %d "
        "sweep(s), read amplification %.3fx/pass, %d tile(s) in flight",
        program.name, "x".join(map(str, n_tiles)), "x".join(map(str, tiles)),
        "x".join(map(str, win)), passes, nf, overhead, in_flight)
    # one fn for every tile and pass: all windows share one shape.  iterate=
    # None when a pass covers the whole iterate keeps the planner's own
    # fused depth; otherwise the planner snaps to a divisor of nf
    it_arg = None if (iterate is None and nf == max(program.iterate, 1)) else nf
    if plan_kwargs.get("sweeps") is None:
        plan_kwargs.pop("sweeps", None)
    if mesh is not None and plan_kwargs:
        raise ValueError(f"{sorted(plan_kwargs)} plan a whole tile; over a mesh "
                         f"every shard is planned for its own shape")
    if mesh is not None:
        # the sharded fn plans its shards' kernels itself
        fn = build_sharded_fn(
            program, mesh, grid_shape=win, dims=mesh_dims, iterate=nf,
            sweeps_per_exchange=sweeps_per_exchange, local_backend=local_backend,
            overlap=overlap, link_classes=link_classes)
    else:
        fn = build_fn(program, grid_shape=win, iterate=it_arg, **plan_kwargs)
    on_card = dev.type == "cuda"
    slots = in_flight if on_card else 1
    outs_t = {n: torch_dtype(program.tensors[n].type) for n in program.output_names}
    record = {"tiles": tuple(tiles), "halos": halos, "ext_shape": win,
              "n_tiles": n_tiles, "sweeps_per_pass": nf, "passes": passes,
              "read_amplification": overhead, "in_flight": slots,
              "pass_seconds": [], "stage_seconds": 0.0, "wait_seconds": 0.0,
              "stitch_seconds": 0.0, "h2d_bytes": 0, "d2h_bytes": 0,
              "mesh_exchange_bytes": 0, "mesh_group_calls": 0}
    if mesh is not None:
        run_tile, stitch_tile = _mesh_tiles(program, fn, mesh, params, win, slots,
                                            record)
    else:
        run_tile, stitch_tile = _card_tiles(program, fn, dev, params, win, tiles,
                                            slots, record)

    in0, out0 = program.input_names[0], program.output_names[0]
    values = host
    host_out: dict[str, torch.Tensor] = {}
    for _ in range(passes):
        t0 = time.perf_counter()
        host_out = {n: torch.empty(grid_shape, dtype=dt) for n, dt in outs_t.items()}
        pending: list = [None] * slots   # per slot: (dst, what the tile holds)

        def stitch(s: int) -> None:
            # the slot's cells reach the host, go into the grid, and the
            # slot's buffers may be reused
            dst, held = pending[s]
            cells = stitch_tile(s, held)
            t0 = time.perf_counter()
            for n, t in cells.items():
                bits(host_out[n])[dst].copy_(bits(t))
            record["stitch_seconds"] += time.perf_counter() - t0
            pending[s] = None

        for k, idx in enumerate(itertools.product(*(range(m) for m in n_tiles))):
            s = k % slots
            starts = tuple(i * t for i, t in zip(idx, tiles))
            origin, dst, src = _window(starts, tiles, halos, win, grid_shape)
            window = tuple(slice(o, o + w) for o, w in zip(origin, win))
            if pending[s] is not None:
                stitch(s)
            pending[s] = (dst, run_tile(s, {n: values[n][window] for n in host}, src))
            if not on_card:
                stitch(s)
        for s in range(slots):
            if pending[s] is not None:
                stitch(s)
        record["pass_seconds"].append(time.perf_counter() - t0)
        if passes > 1:
            values = dict(host)
            values[in0] = host_out[out0]
    if on_card:
        torch.cuda.synchronize(dev)
    if stats is not None:
        stats.update(record)
    return {n: bits(t).numpy().view(program.tensors[n].type.np_dtype())
            for n, t in host_out.items()}
