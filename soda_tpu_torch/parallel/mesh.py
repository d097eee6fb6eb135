"""A grid sharded over a mesh of torch devices, with halo exchange.

The port of `soda_tpu/parallel/mesh.py`.  Like the reference it is
single-controller: one process holds every shard of a grid, one tensor a
mesh position on that position's `torch.device`, and drives them all.
The reference's `ppermute` becomes `copy_` between those tensors: a peer
copy between two cards, an on-card copy where two shards share a card
(`make_mesh(..., devices=["cuda:0"] * 4)`), a host copy between CPU
shards (`devices=["cpu"] * 8`, the tests' counterpart of the reference's
8-device CPU mesh).  A copy between two cards is torch's peer copy, which
orders itself against the current streams of both cards (an event
recorded on the receiver's stream is waited for by the sender's before
the copy, and one recorded after it by the receiver's), so the exchange
needs no event of its own; within a card, stream order suffices.

Each sweep, or each chunk of `sweeps_per_exchange` fused sweeps, a shard
is extended along every sharded dim by its neighbours' rows (the chain
creep of one sweep x the chunk's sweeps, `StencilProgram.chain_creep`),
runs the chunk on the extended shard (its window) and keeps the shard:
the reference's overlapped tiling across devices.  Shards at the mesh's
edge get zero halos past the grid's edge, which is the zero-fill border of
a single stage.  A multi-stage program's intermediate stages are not zero
when evaluated there (grad = sqrt(... + 0.0001f) of zeros, or a tap of a
cell inside the grid), whereas the whole grid holds every stage at zero
outside it.  So on one level of exchanges an edge shard's window moves
inside the grid until its side lies on the grid's edge, as host tiling's
windows do: the first shard along an axis takes both halos from above it,
the last from below, and an axis of one shard takes none.  The local
evaluation's own edge is then the grid's, where the kernels and the plain
path store zero at every stage and every fused sweep.  Every window keeps
one shape, so one `build_fn` still serves every shard; a shard sits in
its window where the window's move puts it (`low`).  Every local evaluation
goes through `backend/cuda.py::build_fn` at its own shape (`local_backend
="cuda"`): on a card kernels 1 to 4 and the fused sweeps, as the planner
chooses for the shape, on the CPU each group's plain version; or through
the plain PyTorch sweeps (`"eager"`), the counterpart of the reference's
`"xla"`.  One `build_fn` serves every shard of a shape.  A buffer belongs
to the schedule that reads it: it is made where the schedule first uses
it, and kept only where every later call uses it again.  A resident call
of one level keeps none: it exchanges a returned grid in place (its halo
room), extends any other input into a copy for that call alone, and
returns buffers the kernels made.  The fn's closures refer to no closure
of their own, so dropping the fn frees its buffers without the collector.

A sharded fn takes and returns `ShardedGrid`s (`parallel/sharded.py`),
the reference's arrays laid out by its tensor spec: a loop of calls keeps
the grid on the mesh and moves only halos, as the reference's jitted
`shard_map` step does.  Whole-grid tensors are scattered to the shards
and the outputs gathered onto the first device.

Uneven grids pad to shard: each sharded dim is zero-padded up to a
multiple of its mesh axis, the pad rows of every output are re-zeroed
after every chunk (so an exchange carries zeros from them, the zero-fill
contract), and the result is sliced back.  Correctness contract
(docs/SEMANTICS.md "Border"): the whole-grid run, bit for bit on the whole
grid, for a single-stage program at one sweep an exchange, and for a
multi-stage program on one level of exchanges at any cadence where the
mesh divides the grid evenly and each window fits in the grid (both halos
within the other shards of the axis).  Elsewhere the result differs only
inside `valid_rim()`: a single stage's deeper cadences, a multi-stage
program's nested cadences, the far edge of a padded dim (a pad row is
not the grid's edge to the local evaluation) and windows wider than the
grid.  A multi-stage program whose windows move runs the synchronous
chunk, `overlap` or not.

Shards keep the declared storage dtypes between chunks: int64, uint64
and f64 shard natively (the reference's f32/int32 local cast and 64-bit
plane pairs are TPU workarounds; uint64 is copied and zeroed through its
int64 view, `ir/dtypes.py::bits`); integers wider than 64 bits are
refused with a typed error naming `--backend eager`, as the reference
refuses them (`ir/dtypes.py::check_kernel_types`).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
from typing import Mapping, Sequence

import numpy as np
import torch

from ..backend import cuda, eager
from ..backend.io import check_io, finalize_outputs, params_to_torch, to_torch
from ..ir.dtypes import bits, check_kernel_types, storage_bytes, torch_dtype
from ..ir.program import StencilProgram
from ..utils import trace
from ..utils.device import resolve
from ..utils.opcount import H100_SXM_PEAK_TFLOPS, ops_per_cell
from .sharded import (ShardedGrid, check_mesh_dims, copy_padded, describe_layout,
                      gather_grid, narrow, padded_shard_shape, positions as mesh_positions,
                      on_streams, region, same_mesh, shard_grid)


class Mesh:
    """Devices in a grid of named axes: `devices` is a numpy object array of
    `torch.device`s in the mesh's shape; a device may repeat."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{len(axis_names)} axis names for a mesh of "
                             f"{devices.ndim} axes")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str] | None = None,
              devices=None) -> Mesh:
    """A mesh of `axis_sizes` over `devices` (torch devices or their names,
    taken in order, repeats allowed); by default the visible cards
    `cuda:0 .. cuda:n-1`, which raises `NoCudaDevice` without a card."""
    axis_sizes = tuple(int(s) for s in axis_sizes)
    axis_names = tuple(axis_names or [f"ax{i}" for i in range(len(axis_sizes))])
    if not axis_sizes or min(axis_sizes) < 1:
        raise ValueError(f"mesh sizes must be positive, got {axis_sizes}")
    if len(axis_names) != len(axis_sizes) or len(set(axis_names)) != len(axis_names):
        raise ValueError(f"mesh axis names {axis_names} must name each of the "
                         f"{len(axis_sizes)} axes once")
    n = math.prod(axis_sizes)
    hint = ""
    if devices is None:
        resolve("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        hint = (f"; pass devices= to put several shards on one device, e.g. "
                f"['cuda:0'] * {n} or ['cpu'] * {n}")
    devices = [resolve(d) for d in devices][:n]
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}{hint}")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devices):
        grid[i] = d
    return Mesh(grid.reshape(axis_sizes), axis_names)


def _halo_rows(n_loc: int, lo: int, hi: int):
    """The halo slabs of a shard of `n_loc` rows: (hop, count, row in the
    extended shard, row in the neighbour's centre) for the low side,
    farthest neighbour first, then the high side, nearest first.  A halo
    wider than one shard gathers from k-hop neighbours."""
    rows, at = [], 0
    for k in range(-(-lo // n_loc), 0, -1):
        cnt = min(n_loc, lo - (k - 1) * n_loc)
        rows.append((-k, cnt, at, n_loc - cnt))
        at += cnt
    at = lo + n_loc
    for k in range(1, -(-hi // n_loc) + 1):
        cnt = min(n_loc, hi - (k - 1) * n_loc)
        rows.append((k, cnt, at, 0))
        at += cnt
    return rows


def _exchange(ext: Sequence[torch.Tensor], dim: int, lo: int, hi: int,
              lows: Sequence[int] | None = None) -> int:
    """Fill the halo rows of `ext[i]` along `dim` from the shards of its
    neighbours along the list, zeros past its ends: the `lows[i]` rows
    before shard i (by default `lo` for every shard) and the lo + hi -
    lows[i] rows after it; shard i starts at row `lows[i]` of `ext[i]`.
    Returns the bytes copied between shards."""
    n_loc = ext[0].shape[dim] - lo - hi
    lows = lows or [lo] * len(ext)
    moved = 0
    for i, x in enumerate(ext):
        for hop, cnt, at, src in _halo_rows(n_loc, lows[i], lo + hi - lows[i]):
            dst = bits(x).narrow(dim, at, cnt)
            if 0 <= i + hop < len(ext):
                dst.copy_(bits(ext[i + hop]).narrow(dim, lows[i + hop] + src, cnt))
                moved += dst.numel() * dst.element_size()
            else:
                dst.zero_()
    return moved


def halo_exchange(shards: Sequence[torch.Tensor], dim: int, lo: int,
                  hi: int) -> list[torch.Tensor]:
    """The ordered shards of one mesh axis, each extended along `dim` by
    `lo` rows of its lower neighbours and `hi` rows of its upper ones.

    Shard i gets the last `lo` rows before it and the first `hi` rows
    after it in the axis's order; past the axis's ends, zeros (the
    zero-fill border).  Halos wider than one shard gather from k-hop
    neighbours, farthest first on the low side (the reference's
    `ppermute` per hop).  Each extended shard lies on its shard's device."""
    ext = []
    for x in shards:
        shape = list(x.shape)
        shape[dim] += lo + hi
        e = torch.empty(shape, dtype=x.dtype, device=x.device)
        bits(e).narrow(dim, lo, x.shape[dim]).copy_(bits(x))
        ext.append(e)
    _exchange(ext, dim, lo, hi)
    return ext


# ---- link model --------------------------------------------------------
# Link constants per class: (GB/s each way for one device, s of latency an
# exchange).  Only their ratio to the card's arithmetic rate picks a cadence.
# - "nvlink", between the cards of one host: measured by
#   `scripts/torch_mesh_cards.py` on four NVIDIA H100 80GB HBM3 at a
#   700.00 W power limit (`nvidia-smi --query-gpu=name,power.limit`): the
#   median over the 12 ordered pairs of a 1 GiB peer `copy_`, 392.9 GB/s
#   (386.4-394.6; the data sheet's 450), and of a 4 KiB one by the host
#   clock around both cards' synchronisation, 28.1 us (24.9-37.2): what one
#   exchange costs the single controller.  A second run read 390.6 GB/s
#   and 31.9 us; both pick the same cadences for heat3d 512^3 and jacobi2d
#   16384^2.
# - "ib", between hosts: NDR InfiniBand, 400 Gb/s = 50 GB/s a card (one
#   adapter a card), the data sheet's figure; the 20 us latency is an
#   assumption.  Not measured: no machine here spans two hosts.
# Calibrate with `sodac --link-model 'nvlink=392.9:2.81e-5,ib=50:2e-5'`, the
# SODA_LINK_MODEL variable (same syntax) or set_link_model().
LINK_MODEL = {
    "nvlink": (392.9, 2.81e-5),
    "ib": (50.0, 20e-6),
}
FAST_LINK, SLOW_LINK = "nvlink", "ib"


def set_link_model(spec: str) -> None:
    """Override link constants from 'class=GB/s:latency_s[,...]', e.g.
    'nvlink=400:4e-6,ib=25:3e-5': the calibration hook."""
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            name, val = part.split("=", 1)
            bw, lat = val.split(":", 1)
            LINK_MODEL[name.strip()] = (float(bw), float(lat))
        except ValueError as e:
            raise ValueError(
                f"bad --link-model entry {part!r}: expected "
                f"class=GBps:latency_s (e.g. nvlink=392.9:2.81e-5)") from e


_env_spec = os.environ.get("SODA_LINK_MODEL")
if _env_spec:
    set_link_model(_env_spec)


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def choose_exchange_cadence(
    program: StencilProgram,
    grid_shape: tuple[int, ...],
    mesh: Mesh,
    dims: Sequence[int],
    iterate: int,
    link_classes: Mapping[str, str],
) -> dict[str, int]:
    """Pick sweeps-per-exchange for each mesh axis from the modelled link
    costs.

    For each axis on its own, scores every divisor k of `iterate` by
    (it/k)·(latency + halo_bytes(k)/bandwidth) + it·extra_cells(k)·(typed
    operations a cell over the H100's 67 TFLOP/s): fewer, deeper exchanges
    amortise a slow link's latency and bytes at the price of recomputing
    the halo.  Then rounds the choices to a divisor chain (slow axes
    exchange at multiples of fast axes' cadence) so the schedule nests."""
    it = max(iterate, 1)
    out_span = program.chain_creep()
    mesh_sizes = mesh.shape
    cell_s = max(ops_per_cell(program), 1) / (H100_SXM_PEAK_TFLOPS * 1e12)
    dtype_b = max(storage_bytes(program, [n]) for n in program.tensors)

    cad: dict[str, int] = {}
    for ax, d in zip(mesh.axis_names, dims):
        bw_gbps, lat = LINK_MODEL[link_classes.get(ax, FAST_LINK)]
        r = (-out_span[d][0]) + out_span[d][1]
        if r == 0 or it == 1:
            cad[ax] = it
            continue
        # the shard's cross-section perpendicular to d
        local_shape = []
        for e in range(len(grid_shape)):
            sz = grid_shape[e]
            for a2, d2 in zip(mesh.axis_names, dims):
                if d2 == e:
                    sz //= mesh_sizes[a2]
            local_shape.append(sz)
        cross = math.prod(local_shape) // max(local_shape[d], 1)
        best_k, best_t = 1, float("inf")
        for k in _divisors(it):
            halo_bytes = k * r * cross * dtype_b
            comm = (it // k) * (lat + halo_bytes / (bw_gbps * 1e9))
            extra = it * (k * r) * cross * cell_s
            t = comm + extra
            if t < best_t:
                best_k, best_t = k, t
        cad[ax] = best_k
    order = sorted(cad, key=lambda a: -cad[a])
    for prev, nxt in zip(order, order[1:]):
        k = cad[nxt]
        while cad[prev] % k != 0:
            k -= 1
        cad[nxt] = k
    return cad


def _eager_fn(program: StencilProgram, n: int):
    """`n` plain PyTorch sweeps on whatever extents the inputs have, with
    `build_fn`'s signature (the `"eager"` local backend)."""
    in0, out0 = program.input_names[0], program.output_names[0]

    def fn(inputs, params, bufs=None):
        device = next(iter(inputs.values())).device
        arrays = dict(inputs)
        for s in range(n):
            arrays = eager.sweep(program, arrays, params, device)
            if s + 1 < n:
                arrays = {**{k: inputs[k] for k in program.input_names},
                          in0: arrays[out0]}
        return {k: arrays[k] for k in program.output_names}

    fn.plan = None
    return fn


def _copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst[...] = src (uint64 through the int64 views)."""
    bits(dst).copy_(bits(src))


def build_sharded_fn(
    program: StencilProgram,
    mesh: Mesh,
    *,
    grid_shape: tuple[int, ...],
    dims: Sequence[int] | None = None,
    iterate: int | None = None,
    sweeps_per_exchange: int | Mapping[str, int] | None = None,
    local_backend: str = "cuda",
    overlap: bool = False,
    link_classes: Mapping[str, str] | None = None,
):
    """fn(inputs, params) -> outputs for `grid_shape`, sharded over `mesh`.

    Inputs are either all `ShardedGrid`s laid out for this fn
    (`shard_grid(x, mesh, fn.dims)`, or an earlier call's outputs): fn
    reads each shard on its own device and returns a `ShardedGrid` per
    output, scattering and gathering nothing, the reference's jitted
    `shard_map` step; or all whole-grid tensors in their declared dtypes on
    any device: fn scatters them to the shards, runs, and gathers the
    outputs onto the mesh's first device.  No later call writes a
    returned grid's shards, and their pad rows hold zero; on the uniform
    synchronous schedule each is the centre of a buffer of its own whose
    halo rows the next call refills in place, elsewhere a copy.  A
    `ShardedGrid` of another mesh, other dims or another grid is refused
    with a ValueError naming both layouts.  Params are tensors or numpy
    arrays.  `dims[k]` is the grid dim that mesh axis k shards (default:
    the leading dims; `fn.dims`, beside `fn.mesh`).

    The cadence: an int (every axis exchanges every that many sweeps), a
    mapping of axis name to sweeps (a nested schedule, slowest axis
    outermost, when they differ), or None: the automatic cadence of
    `choose_exchange_cadence` when `link_classes` (axis name to a class of
    `LINK_MODEL`) puts an axis on the slow link, else the whole `iterate`
    per exchange, shrunk until the halo fits one shard.

    `overlap`: the shards' interiors run from their own rows on the
    compute stream while the halos are exchanged on a copy stream; then
    only the boundary slabs (2·lo + hi rows a side) run again on the
    extended shard and are stitched in.  Equal to the synchronous chunk
    bit for bit; halos wider than one shard, nested cadences and a
    multi-stage program whose edge windows move inside the grid take the
    synchronous chunk.

    `fn.stats` holds the last call's `scatter_bytes` (whole inputs into
    the shards) with `scatter_from` (the same by source device),
    `gather_bytes` (the shards' outputs onto the first device), both 0 for
    `ShardedGrid`s, `exchange_bytes` (copied between shards) and
    `group_calls` (calls of a group's kernel, or of its plain version on
    CPU shards).

    While a profiler records (`utils/trace.py`), a call is the span
    `soda.mesh.call`, each exchange the span `soda.mesh.exchange` and, on
    every card, the interval "exchange", and each shard's local
    evaluation the interval "local" on its card."""
    check_kernel_types(program)
    if local_backend not in ("cuda", "eager"):
        raise ValueError(f"local_backend is 'cuda' or 'eager', not {local_backend!r}")
    it = max(program.iterate if iterate is None else iterate, 1)
    axis_names = mesh.axis_names
    msize = mesh.devices.shape
    dims = check_mesh_dims(program.rank, msize, dims)
    grid_shape = tuple(int(g) for g in grid_shape)
    if len(grid_shape) != program.rank:
        raise ValueError(f"grid shape {grid_shape} has rank {len(grid_shape)}, "
                         f"program rank is {program.rank}")

    # the cadence: uniform, an explicit per-axis mapping, or automatic per
    # axis when an axis rides the slow link
    cad: dict[str, int] | None = None
    if isinstance(sweeps_per_exchange, Mapping):
        cad = {ax: int(sweeps_per_exchange.get(ax, it)) for ax in axis_names}
    elif (sweeps_per_exchange is None and link_classes and it > 1
          and any(link_classes.get(ax) == SLOW_LINK for ax in axis_names)):
        cad = choose_exchange_cadence(program, grid_shape, mesh, dims, it,
                                      link_classes)
    if cad is not None:
        for ax, k in cad.items():
            if k < 1 or it % k != 0:
                raise ValueError(
                    f"cadence {k} for mesh axis {ax!r} must divide iterate {it}")
        chain = sorted(cad.values(), reverse=True)
        for a, b in zip(chain, chain[1:]):
            if a % b != 0:
                raise ValueError(
                    f"per-axis exchange cadences must form a divisor chain "
                    f"(slow axes exchange at multiples of fast axes); got {cad}")
        if len(set(cad.values())) == 1:
            sweeps_per_exchange, cad = chain[0], None
    nf = (sweeps_per_exchange if isinstance(sweeps_per_exchange, int) else None) or it
    if it % nf != 0:
        raise ValueError(f"sweeps_per_exchange {nf} must divide iterate {it}")

    # pad to shard; the automatic cadence prefers halos within one shard (an
    # explicit one is honoured: wider halos gather from k-hop neighbours)
    creep = program.chain_creep()
    shard = padded_shard_shape(grid_shape, msize, dims)
    pads: dict[int, int] = {}      # mesh axis -> rows of the real grid
    for a, (m, d) in enumerate(zip(msize, dims)):
        if shard[d] * m != grid_shape[d]:
            pads[a] = grid_shape[d]
        r = max(-creep[d][0], creep[d][1])
        if sweeps_per_exchange is None and cad is None:
            while nf > 1 and (nf * r > shard[d] or it % nf != 0):
                nf -= 1

    # the schedule: levels of (mesh axes, sweeps per exchange), outermost
    # first; one level for a uniform cadence, one per axis, slowest first,
    # for a nested one
    if cad is None:
        levels = [(tuple(range(len(msize))), nf)]
    else:
        order = sorted(range(len(msize)), key=lambda a: -cad[axis_names[a]])
        levels = [((a,), cad[axis_names[a]]) for a in order]

    # a multi-stage program on one level: the windows move inside the grid
    multi = len(levels) == 1 and len(program.stage_order()) > 1

    def halo(a: int, k: int) -> tuple[int, int]:
        if multi and msize[a] == 1:
            return 0, 0         # the axis's one shard: its edges are the grid's
        d = dims[a]
        return -creep[d][0] * k, creep[d][1] * k

    # the axes along which an edge shard's window moves inside the grid:
    # those whose windows fit in it
    moves = {a for a in range(len(msize)) if multi and msize[a] > 1
             and sum(halo(a, nf)) <= (msize[a] - 1) * shard[dims[a]]}

    def low(level: int, a: int, i: int) -> int:
        """Rows of the window before position i's shard along mesh axis a,
        at level `level`: the low halo, or where the window moves, none at
        the first position and both halos at the last."""
        lo, hi = halo(a, levels[level][1])
        if a not in moves or 0 < i < msize[a] - 1:
            return lo
        return 0 if i == 0 else lo + hi

    # the shape each level's arrays take once extended along its axes
    ext_shapes = []
    shape = list(shard)
    for axes, k in levels:
        for a in axes:
            shape[dims[a]] += sum(halo(a, k))
        ext_shapes.append(tuple(shape))
    overlap_ok = (overlap and cad is None and not moves
                  and all(max(halo(a, nf)) <= shard[dims[a]] for a in range(len(msize))))
    # the overlap's boundary slabs: (axis, first row in the extended shard =
    # the first of the shard's rows its strip replaces, rows, strip rows)
    slabs = []
    if overlap_ok:
        for a in range(len(msize)):
            lo, hi = halo(a, nf)
            slabs += [(a, start, rows, width) for start, rows, width in (
                (0, 2 * lo + hi, lo), (shard[dims[a]] - hi, 2 * hi + lo, hi)) if width]

    def slab_shape(a: int, rows: int) -> tuple[int, ...]:
        return tuple(rows if d == dims[a] else n for d, n in enumerate(ext_shapes[0]))

    # every local evaluation, (shape, sweeps) -> fn, planned now: one fn
    # serves every shard of a shape
    keys = ([(shard, nf)] + [(slab_shape(a, rows), nf) for a, _, rows, _ in slabs]
            if overlap_ok else [(ext_shapes[-1], levels[-1][1])])
    local = {key: (cuda.build_fn(program, grid_shape=key[0], iterate=key[1])
                   if local_backend == "cuda" else _eager_fn(program, key[1]))
             for key in keys}

    in0, out0 = program.input_names[0], program.output_names[0]
    positions = mesh_positions(msize)
    device_of = {idx: mesh.devices[idx] for idx in positions}
    cards = list(dict.fromkeys(device_of.values()))
    buffers: dict = {}
    stats = {"scatter_bytes": 0, "scatter_from": {}, "gather_bytes": 0,
             "exchange_bytes": 0, "group_calls": 0}

    def call(f, n: int, idx, values: dict, params: dict, bufs) -> dict:
        """`f` on position `idx`'s shard: the interval "local" on its card."""
        if f.plan is not None:
            stats["group_calls"] += len(f.plan.groups) * n // f.plan.groups[0].sweeps
        with trace.device_interval("local", device_of[idx]):
            return f(values, params, bufs=bufs)

    def alloc(f, idx):
        dev = device_of[idx]
        return f.alloc(dev) if dev.type == "cuda" and f.plan is not None else None

    def empty(shape, name, idx) -> torch.Tensor:
        return torch.empty(shape, dtype=torch_dtype(program.tensors[name].type),
                           device=device_of[idx])

    def centre(x: torch.Tensor, level: int, idx) -> torch.Tensor:
        """Position `idx`'s shard in `x`, its window at level `level`."""
        return narrow(x, {dims[a]: (low(level, a, idx[a]), shard[dims[a]])
                          for a in levels[level][0]})

    def exchange(level: int, ext: dict, names) -> None:
        """Fill the halos of level `level`'s axes in `ext[idx][name]`
        (arrays at the level's extended shape whose centres hold the
        shards), axis by axis in mesh order: an axis's slabs span the halos
        of the axes before it and the centres of those after it.  The span
        `soda.mesh.exchange`, and on every card the interval "exchange"."""
        axes, k = levels[level]
        with trace.span("soda.mesh.exchange"), trace.device_interval("exchange", *cards):
            for q, a in enumerate(axes):
                lo, hi = halo(a, k)
                if lo == hi == 0:
                    continue
                # where the windows move (passed only then: the benchmark's
                # fault `no_exchange` replaces `_exchange` with four arguments)
                kw = {"lows": [low(level, a, i) for i in range(msize[a])]} if a in moves else {}
                for rest in itertools.product(*(range(m) if b != a else [None]
                                                for b, m in enumerate(msize))):
                    line = [rest[:a] + (i,) + rest[a + 1:] for i in range(msize[a])]
                    later = {dims[b]: (low(level, b, rest[b]), shard[dims[b]])
                             for b in axes[q + 1:]}
                    for name in names:
                        stats["exchange_bytes"] += _exchange(
                            [narrow(ext[idx][name], later) for idx in line],
                            dims[a], lo, hi, **kw)

    def mask_pads(outs: dict, level: int) -> None:
        """Zero the pad rows of level `level`'s dims in every output: only
        the trailing shard(s) of a padded axis hold any."""
        for a in levels[level][0]:
            if a not in pads:
                continue
            d = dims[a]
            for idx, vals in outs.items():
                valid = max(pads[a] - idx[a] * shard[d], 0)
                if valid < shard[d]:
                    for v in vals.values():
                        bits(v).narrow(d, valid, shard[d] - valid).zero_()

    room_strides = torch.empty(ext_shapes[0], device="meta").stride()

    def room(t: torch.Tensor, idx):
        """The level-0 extended buffer around `t` when `t` is position
        `idx`'s shard in it, as the shards of a grid this fn returned are
        (their halo rows are free to refill), else None."""
        offset = sum(low(0, a, idx[a]) * room_strides[dims[a]] for a in range(len(msize)))
        if (t.stride() == room_strides and t.storage_offset() == offset
                and t.untyped_storage().nbytes()
                == math.prod(ext_shapes[0]) * t.element_size()):
            return t.as_strided(ext_shapes[0], room_strides, 0)
        return None

    def kept(key, make):
        """The buffers cached under `key`, made by `make()` at their first use."""
        if key not in buffers:
            buffers[key] = make()
        return buffers[key]

    def run_level(level: int, source, sweeps: int, pars: dict, deeper,
                  fresh: bool = False) -> dict:
        """`sweeps` sweeps of every shard at this level: every `k` of them
        an exchange along the level's axes, then the next level (`deeper`,
        this function: passed in, so that no closure refers to itself) or
        the local evaluation on the extended arrays, whose centres are kept.
        `source(idx, name)` gives the level's input arrays.  `fresh` (one
        level only): an input that is the centre of an extended buffer
        (`room`) is exchanged in place, any other is extended into a copy
        for this call alone, and the last chunk's outputs go to buffers of
        their own, whose centres are returned; the fn keeps none of them."""
        axes, k = levels[level]
        shape = ext_shapes[level]
        inner = level + 1 == len(levels)
        f = local[(shape, k)] if inner else None
        ext = None if fresh else kept((level, "ext"), lambda: {
            idx: {n: empty(shape, n, idx) for n in program.input_names} for idx in positions})
        outs, full, first = None, None, None
        for j in range(sweeps // k):
            if j == 0:
                first = {idx: {} for idx in positions}
                for idx in positions:
                    for n in program.input_names:
                        x = source(idx, n)
                        base = room(x, idx) if fresh else None
                        if base is None:
                            base = ext[idx][n] if ext else empty(shape, n, idx)
                            copy_padded(centre(base, level, idx), x)
                        first[idx][n] = base
                exchange(level, first, program.input_names)
                ins = first
            elif inner:
                # the last call's first output holds the new centres: its
                # halos are refilled in place
                ins = {idx: {**first[idx], in0: full[idx][out0]} for idx in positions}
                exchange(level, ins, [in0])
            else:
                for idx in positions:
                    _copy(centre(ext[idx][in0], level, idx), outs[idx][out0])
                exchange(level, ext, [in0])
                ins = ext
            if inner:
                own = fresh and j + 1 == sweeps // k
                bufs = None if own else kept((level, j % 2), lambda: {
                    idx: alloc(f, idx) for idx in positions})
                full = {idx: call(f, k, idx, ins[idx], pars[device_of[idx]],
                                  bufs[idx] if bufs else None)
                        for idx in positions}
            else:
                full = deeper(level + 1, lambda idx, n: ext[idx][n], k, pars, deeper)
            outs = {idx: {n: centre(v, level, idx) for n, v in full[idx].items()}
                    for idx in positions}
            mask_pads(outs, level)
        return outs

    def run_overlap(source, pars: dict) -> dict:
        """The uniform schedule with the exchange beside the interiors."""
        axes, k = levels[0]
        shape = ext_shapes[0]
        f_in = local[(shard, k)]
        if "overlap" not in buffers:
            slab_bufs = {}
            for a, start, rows, _ in slabs:
                f = local[(slab_shape(a, rows), k)]
                slab_bufs[(a, start)] = {idx: (
                    {n: empty(slab_shape(a, rows), n, idx) for n in program.input_names},
                    alloc(f, idx)) for idx in positions}
            cards = {d for d in device_of.values() if d.type == "cuda"}
            buffers["overlap"] = (
                {idx: {n: empty(shard, n, idx) for n in program.input_names}
                 for idx in positions},
                {idx: {n: empty(shape, n, idx) for n in program.input_names}
                 for idx in positions},
                slab_bufs, {d: torch.cuda.Stream(d) for d in cards})
        first_state, ext, slab_bufs, copy_streams = buffers["overlap"]
        state = {idx: dict(first_state[idx]) for idx in positions}
        outs = None
        for j in range(it // k):
            names = program.input_names if j == 0 else [in0]
            for idx in positions:
                if j == 0:
                    for n in names:
                        copy_padded(state[idx][n], source(idx, n))
                else:
                    state[idx][in0] = outs[idx][out0]
            # the exchange on each card's copy stream, after what its
            # compute stream wrote before
            for dev, s in copy_streams.items():
                s.wait_event(torch.cuda.current_stream(dev).record_event())
            with on_streams(copy_streams.values()):
                for idx in positions:
                    for n in names:
                        _copy(centre(ext[idx][n], 0, idx), state[idx][n])
                exchange(0, ext, names)
                copied = {dev: s.record_event() for dev, s in copy_streams.items()}
            # meanwhile the interiors, from the shards' own rows
            bufs = kept(("overlap", j % 2), lambda: {idx: alloc(f_in, idx) for idx in positions})
            outs = {idx: call(f_in, k, idx, state[idx], pars[device_of[idx]], bufs[idx])
                    for idx in positions}
            for dev, ev in copied.items():
                torch.cuda.current_stream(dev).wait_event(ev)
            # then the boundary slabs from the extended shards: a slab keeps
            # the other axes' halos, so its strip is exact to the corners
            for a, start, rows, width in slabs:
                d = dims[a]
                f = local[(slab_shape(a, rows), k)]
                others = {dims[b]: (halo(b, k)[0], shard[dims[b]]) for b in axes if b != a}
                for idx in positions:
                    slab_in, bufs = slab_bufs[(a, start)][idx]
                    for n in program.input_names:
                        _copy(slab_in[n], ext[idx][n].narrow(d, start, rows))
                    res = call(f, k, idx, slab_in, pars[device_of[idx]], bufs)
                    for n in program.output_names:
                        strip = narrow(res[n], others).narrow(d, halo(a, k)[0], width)
                        _copy(outs[idx][n].narrow(d, start, width), strip)
            mask_pads(outs, 0)
        return outs

    def check_layout(name: str, g: ShardedGrid) -> None:
        if not (same_mesh(g.mesh, mesh) and tuple(g.dims) == dims
                and tuple(g.grid_shape) == grid_shape and tuple(g.shard_shape) == shard):
            raise ValueError(
                f"input {name!r} is a ShardedGrid laid out as {g.layout()}; this fn "
                f"takes the {describe_layout(mesh, dims, grid_shape, shard)}")
        want = torch_dtype(program.tensors[name].type)
        if g.dtype != want:
            raise ValueError(f"input {name!r} is a ShardedGrid of {g.dtype}; this fn "
                             f"takes {want}")

    def step(inputs: Mapping, params: Mapping) -> dict:
        stats.update(scatter_bytes=0, scatter_from={}, gather_bytes=0, exchange_bytes=0,
                     group_calls=0)
        resident = [n for n in program.input_names if isinstance(inputs[n], ShardedGrid)]
        if resident and len(resident) != len(program.input_names):
            raise ValueError(f"inputs {resident} are ShardedGrids and the others are "
                             f"not: pass every input as a ShardedGrid or none")
        for n in program.input_names:
            x = inputs[n]
            if resident:
                check_layout(n, x)
                continue
            if tuple(x.shape) != grid_shape:
                raise ValueError(f"input {n!r} has shape {tuple(x.shape)}, "
                                 f"this fn was built for {grid_shape}")
            nbytes = x.numel() * x.element_size()
            stats["scatter_bytes"] += nbytes
            by = stats["scatter_from"]
            by[str(x.device)] = by.get(str(x.device), 0) + nbytes
        pars = {dev: params_to_torch(program, params, dev)
                for dev in set(device_of.values())}

        def source(idx, name):
            if resident:
                return inputs[name].shards[idx]
            return narrow(inputs[name], region(idx, grid_shape, shard, dims))

        # a resident call of one level writes its last outputs to buffers of
        # their own; the others' outputs view buffers the next call rewrites
        own = bool(resident) and not overlap_ok and len(levels) == 1
        outs = (run_overlap(source, pars) if overlap_ok
                else run_level(0, source, it, pars, run_level, fresh=own))
        grids = {n: ShardedGrid(mesh, dims, grid_shape, shard,
                                torch_dtype(program.tensors[n].type),
                                {idx: outs[idx][n] for idx in positions})
                 for n in program.output_names}
        if not resident:
            return {n: gather_grid(g, device_of[positions[0]], stats=stats)
                    for n, g in grids.items()}
        if own:
            return grids
        return {n: dataclasses.replace(g, shards={
            idx: bits(v).clone(memory_format=torch.contiguous_format).view(g.dtype)
            for idx, v in g.shards.items()}) for n, g in grids.items()}

    def fn(inputs: Mapping, params: Mapping) -> dict:
        with trace.span("soda.mesh.call"):
            return step(inputs, params)

    fn.stats = stats
    fn.sweeps_per_exchange = cad if cad is not None else nf
    fn.shard_shape = shard
    fn.mesh, fn.dims = mesh, dims
    fn.local_plans = lambda: {key: f.plan for key, f in local.items()}
    return fn


def run_sharded(
    program: StencilProgram,
    inputs: Mapping,
    params: Mapping | None = None,
    *,
    mesh: Mesh | None = None,
    axis_sizes: Sequence[int] | None = None,
    devices=None,
    dims: Sequence[int] | None = None,
    iterate: int | None = None,
    sweeps_per_exchange: int | Mapping[str, int] | None = None,
    local_backend: str = "cuda",
    overlap: bool = False,
    link_classes: Mapping[str, str] | None = None,
    axis_names: Sequence[str] | None = None,
    stats: dict | None = None,
) -> dict[str, torch.Tensor]:
    """Shard numpy arrays or tensors over a mesh, run, gather.  Without a
    `mesh`, one of `axis_sizes` (default: one axis over every device) over
    `devices` (default: the visible cards; the CPU only when asked for,
    e.g. `devices=["cpu"] * 8`).  Each input goes to the shards through
    `shard_grid`, from the host (numpy arrays, CPU tensors) straight to
    every card, or from the card it is on.  Returns tensors on the mesh's
    first device in the declared dtypes.  `stats`, if given, receives the
    run's `fn.stats` with the scatter's and the gather's bytes, the shard
    shape, the cadence and the devices."""
    params = dict(params or {})
    check_io(program, inputs, params)
    if mesh is None:
        if axis_sizes is None and devices is None:
            resolve("cuda")
            axis_sizes = [torch.cuda.device_count()]
        elif axis_sizes is None:
            axis_sizes = [len(devices)]
        mesh = make_mesh(axis_sizes, axis_names, devices)
    on = next((v.device for v in inputs.values()
               if isinstance(v, torch.Tensor) and v.device.type == "cuda"),
              torch.device("cpu"))
    ins, _ = to_torch(program, inputs, params, on)
    grid_shape = tuple(next(iter(ins.values())).shape)
    fn = build_sharded_fn(
        program, mesh, grid_shape=grid_shape, dims=dims, iterate=iterate,
        sweeps_per_exchange=sweeps_per_exchange, local_backend=local_backend,
        overlap=overlap, link_classes=link_classes)
    moved: dict = {}
    grids = fn({n: shard_grid(x, mesh, fn.dims, stats=moved) for n, x in ins.items()},
               params)
    outs = finalize_outputs(program, {
        n: gather_grid(g, mesh.devices.flat[0], stats=moved) for n, g in grids.items()})
    if stats is not None:
        stats.update(fn.stats, **moved, shard_shape=fn.shard_shape,
                     sweeps_per_exchange=fn.sweeps_per_exchange,
                     devices=sorted({str(d) for d in mesh.devices.flat}))
    return outs
