"""Host tiling: a grid larger than the card runs as a loop over
overlapping tiles.

The port of `soda_tpu/parallel/host_tile.py`, without the mesh (its
arguments, `_shard_ext_shape` and `model_mesh_exchange` come with the
port of `parallel/mesh.py`).  The full grid lives in host memory as numpy
arrays; each tile is extended by a zero-filled halo, runs through the
port's main path (`backend/cuda.py::build_fn`: kernels 1 to 4 and the
fused sweeps), and the tile's interior is stitched back on the host.  Only
two extended tiles at a time touch the card, so the grid is bounded by host
memory, not by the card's 80 GB.

The geometry is the reference's:
- halo per tiled dim = the chain creep of one sweep x sweeps per pass,
  so every stitched cell lies at least `creep x nf` deep in its extended
  tile and equals the whole-grid evaluation;
- all tiles share one extended shape, so one `build_fn` (one plan, one
  set of kernels) serves every tile and every pass; tiles past the grid's
  edge are zero-filled (zero is the out-of-grid tap value);
- between passes the first output feeds the first input, auxiliary
  inputs carry over.
Correctness contract (docs/SEMANTICS.md): with one sweep a pass the
result equals the whole-grid run bit for bit on the whole grid (the
kernels store zero outside the grid at every stage, as the oracle does);
deeper passes differ only inside the border-invalid rim
(`valid_rim()`), because a tile's halo cells past the grid edge are
re-zeroed only once a pass.  The whole-grid path masks nothing more, and
neither does this one.

On the card the tiles overlap (`in_flight=2`): two pinned host staging
buffers per input (each an extended tile) and per output (each a tile
interior), a copy stream and the compute stream.  Tile k+1 is sliced
with its zero fill straight from the host grid into its pinned buffer
(torch's `copy_`, which uses the host's threads) and copied to the card
on the copy stream while the compute stream runs tile k; tile k's
interior comes back on the copy stream into a pinned output buffer and is
stitched once its event has fired.  CUDA events order the streams; the
host waits only on the event of the slot it is about to reuse.  The
device buffers (inputs, and every output through `build_fn`'s `bufs=`)
are allocated once a run and stay alive until the run has synchronised,
so the caching allocator never hands them to another stream meanwhile.
On the CPU (`device="cpu"`) each tile runs the plain versions, as
`cuda.run(device="cpu")` does.

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
from ..ir.dtypes import check_types_supported, torch_dtype
from ..ir.program import StencilProgram
from ..utils.device import resolve

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


def storage_bytes(program: StencilProgram, names) -> int:
    """Bytes a cell of the tensors `names` takes in the port's storage
    dtypes (`half` 2, 64-bit values 8)."""
    return sum(program.tensors[n].type.np_dtype().itemsize for n in names)


def choose_sweeps_per_pass(program: StencilProgram, grid_shape,
                           tiles=None, hbm_budget: int | None = None,
                           iterate: int | None = None):
    """Pick `sweeps_per_pass` minimizing modeled streamed traffic: each
    pass streams every (halo-extended) tile across the host link once,
    and halos grow with chain-creep x nf, so small nf pays more passes
    while large nf pays halo recompute (and can outgrow the tile).  Scores
    every divisor nf of iterate by passes x (the tiles' extended input
    bytes + the grid's output bytes); ties prefer the DEEPER nf (fewer
    passes).  With tiles=None ('--host-tile auto'), tiles are re-chosen
    per candidate under `hbm_budget`.  Returns (nf, tiles)."""
    if tiles is None and hbm_budget is None:
        raise ValueError(
            "choose_sweeps_per_pass needs explicit tiles or an "
            "hbm_budget to choose them under")
    it = max(program.iterate if iterate is None else iterate, 1)
    divisors = [k for k in range(1, it + 1) if it % k == 0]
    in_b = storage_bytes(program, program.input_names)
    out_b = storage_bytes(program, program.output_names)
    best = None  # ((cost, -nf), nf, tiles)
    for nf in divisors:
        try:
            ts = tiles if tiles is not None else choose_host_tiles(
                program, grid_shape, hbm_budget, nf, iterate)
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
                      iterate: int | None = None) -> tuple[int, ...]:
    """Pick a tile shape whose device footprint fits `hbm_budget` bytes:
    repeatedly halve the largest leading dim (the last, contiguous dim
    last, floored at 256) until it fits.  Footprint = every program tensor
    at the halo-extended tile shape in its storage dtype (`half` 2 B, 64-bit
    values 8 B), x 2 (two tiles in flight, or the feedback's two copies)."""
    tiles = list(normalize_tiles(grid_shape, (0,) * len(grid_shape)))
    per_cell = storage_bytes(program, program.tensors)

    def footprint(ts) -> int:
        _, _, ext, _, _, _, _ = plan_host_tiling(
            program, grid_shape, ts, sweeps_per_pass, iterate)
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


def _interior(starts, tiles, halos, grid_shape):
    """(dst, src): the tile's cells in the grid, and where they sit in the
    extended tile (edge tiles clip to the grid)."""
    dst = tuple(slice(s, min(s + t, n))
                for s, t, n in zip(starts, tiles, grid_shape))
    src = tuple(slice(lo, lo + (sl.stop - sl.start))
                for (lo, _), sl in zip(halos, dst))
    return dst, src


def _fill(buf: torch.Tensor, grid: torch.Tensor, starts) -> None:
    """buf = grid[starts : starts + buf.shape], zero outside the grid."""
    src, dst = [], []
    for st, sz, n in zip(starts, buf.shape, grid.shape):
        s0, s1 = max(st, 0), min(st + sz, n)
        src.append(slice(s0, max(s1, s0)))
        dst.append(slice(s0 - st, max(s1, s0) - st))
    whole = all(d.start == 0 and d.stop == sz for d, sz in zip(dst, buf.shape))
    if not whole:
        buf.zero_()
    buf[tuple(dst)].copy_(grid[tuple(src)])


def run_host_tiled(program: StencilProgram, inputs, params=None, *,
                   tiles, grid_shape=None, sweeps_per_pass=None,
                   iterate=None, device="cuda", in_flight: int = 2,
                   stats: dict | None = None, **plan_kwargs) -> dict:
    """Run `program` over a grid held in host memory by looping
    overlapping tiles through the port's main path on `device` ("cuda",
    the default, or "cpu").  Inputs are numpy arrays (or CPU tensors) of
    the whole grid; returns numpy outputs in the declared dtypes.

    `in_flight` tiles share the card (2: tile k+1's copies overlap tile
    k's kernels; 1: one tile at a time).  `stats`, if given, receives the
    geometry, the wall seconds of each pass, and the bytes copied to and
    from the card."""
    dev = resolve(device)
    if in_flight not in (1, 2):
        raise ValueError(f"in_flight is 1 or 2, not {in_flight}")
    check_types_supported(program)
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
            # _fill would silently zero-fill the mismatch
            raise ValueError(
                f"input {n!r} has shape {tuple(a.shape)}, expected grid "
                f"shape {grid_shape}")
    tiles, halos, ext_shape, n_tiles, nf, passes, overhead = \
        plan_host_tiling(program, grid_shape, tiles, sweeps_per_pass, iterate)
    logger.info(
        "host tiling %s: %s tiles of %s (+halo -> %s), %d pass(es) of %d "
        "sweep(s), read amplification %.3fx/pass, %d tile(s) in flight",
        program.name, "x".join(map(str, n_tiles)), "x".join(map(str, tiles)),
        "x".join(map(str, ext_shape)), passes, nf, overhead, in_flight)
    # one fn for every tile and pass: all tiles share ext_shape.  iterate=
    # None when a pass covers the whole iterate keeps the planner's own
    # fused depth; otherwise the planner snaps to a divisor of nf
    it_arg = None if (iterate is None and nf == max(program.iterate, 1)) else nf
    if plan_kwargs.get("sweeps") is None:
        plan_kwargs.pop("sweeps", None)
    fn = build_fn(program, grid_shape=ext_shape, iterate=it_arg, **plan_kwargs)
    pars = params_to_torch(program, params, dev)
    on_card = dev.type == "cuda"
    slots = in_flight if on_card else 1
    outs_t = {n: torch_dtype(program.tensors[n].type) for n in program.output_names}
    stage_in = [{n: torch.empty(ext_shape, dtype=a.dtype, pin_memory=on_card)
                 for n, a in host.items()} for _ in range(slots)]
    if on_card:
        dev_in = [{n: torch.empty(ext_shape, dtype=a.dtype, device=dev)
                   for n, a in host.items()} for _ in range(slots)]
        dev_bufs = [fn.alloc(dev) for _ in range(slots)]
        stage_out = [{n: torch.empty(math.prod(tiles), dtype=dt, pin_memory=True)
                      for n, dt in outs_t.items()} for _ in range(slots)]
        copy_stream = torch.cuda.Stream(dev)
        compute_stream = torch.cuda.Stream(dev)
        # the params were copied to the card on the current stream
        compute_stream.wait_stream(torch.cuda.current_stream(dev))
        h2d_done = [torch.cuda.Event() for _ in range(slots)]
        computed = [torch.cuda.Event() for _ in range(slots)]
        d2h_done = [torch.cuda.Event() for _ in range(slots)]
    else:
        dev_in = stage_in
    in_bytes = math.prod(ext_shape) * storage_bytes(program, program.input_names)
    out_cell = storage_bytes(program, program.output_names)
    record = {"tiles": tuple(tiles), "halos": halos, "ext_shape": ext_shape,
              "n_tiles": n_tiles, "sweeps_per_pass": nf, "passes": passes,
              "read_amplification": overhead, "in_flight": slots,
              "pass_seconds": [], "h2d_bytes": 0, "d2h_bytes": 0}

    in0, out0 = program.input_names[0], program.output_names[0]
    values = host
    host_out: dict[str, torch.Tensor] = {}
    for _ in range(passes):
        t0 = time.perf_counter()
        host_out = {n: torch.empty(grid_shape, dtype=dt) for n, dt in outs_t.items()}
        pending: list = [None] * slots      # per slot: (dst, its cells' shape)

        def stitch(s: int) -> None:
            # the slot's copy to the host has landed: its interior goes
            # into the grid, and the slot's buffers may be reused
            dst, shape = pending[s]
            d2h_done[s].synchronize()
            for n, buf in stage_out[s].items():
                host_out[n][dst].copy_(buf[:math.prod(shape)].view(shape))
            pending[s] = None

        for k, idx in enumerate(itertools.product(*(range(m) for m in n_tiles))):
            s = k % slots
            starts = tuple(i * t for i, t in zip(idx, tiles))
            dst, src = _interior(starts, tiles, halos, grid_shape)
            if on_card and pending[s] is not None:
                stitch(s)
            for n, buf in stage_in[s].items():
                _fill(buf, values[n], tuple(st - lo for st, (lo, _) in zip(starts, halos)))
            if not on_card:
                outs = fn(dev_in[s], pars)
                for n in outs_t:
                    host_out[n][dst].copy_(outs[n][src])
                continue
            with torch.cuda.stream(copy_stream):
                for n, buf in stage_in[s].items():
                    dev_in[s][n].copy_(buf, non_blocking=True)
                h2d_done[s].record(copy_stream)
            compute_stream.wait_event(h2d_done[s])
            with torch.cuda.stream(compute_stream):
                outs = fn(dev_in[s], pars, bufs=dev_bufs[s])
                computed[s].record(compute_stream)
            copy_stream.wait_event(computed[s])
            shape = tuple(sl.stop - sl.start for sl in dst)
            with torch.cuda.stream(copy_stream):
                for n, buf in stage_out[s].items():
                    buf[:math.prod(shape)].view(shape).copy_(outs[n][src],
                                                             non_blocking=True)
                d2h_done[s].record(copy_stream)
            pending[s] = (dst, shape)
            record["h2d_bytes"] += in_bytes
            record["d2h_bytes"] += math.prod(shape) * out_cell
        if on_card:
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
    return {n: t.numpy().astype(program.tensors[n].type.np_dtype(), copy=False)
            for n, t in host_out.items()}
