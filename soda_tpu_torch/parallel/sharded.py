"""A grid laid out over a mesh: one block a mesh position, kept on that
position's device between calls.

The port's counterpart of a `jax.Array` sharded by `soda_tpu`'s tensor
spec (`P(...)` with mesh axis k on grid dim `dims[k]`), which the
reference's jitted `shard_map` step takes and returns
(`soda_tpu/parallel/mesh.py::build_sharded_fn`): its output goes straight
back into the next call, and no byte of the grid passes through one
device.  `parallel/mesh.py::build_sharded_fn`'s fn takes and returns
`ShardedGrid`s the same way:

    g = {"t0": shard_grid(x, mesh, fn.dims)}      # host -> each card
    for _ in range(steps):
        g = fn(g, params)                         # stays on the mesh
        g = {"t0": g["t1"]}
    y = gather_grid(g["t0"], "cpu")               # each card -> host

Each sharded dim is padded up to a multiple of its mesh axis, as the
sharded fn pads it (pad to shard); the pad rows of every shard hold zero,
which is the zero-fill border the sharded fn keeps (`mask_pads`).  A grid
the sharded fn returned keeps each shard inside a buffer with room for its
halos (its window), so the next call refills those rows in place and
copies no shard; the rows around a shard belong to the mesh, its own never
change.
Integers up to 64 bits, uint64 copied through its int64 view
(`ir/dtypes.py::bits`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import Mapping

import numpy as np
import torch

from ..ir.dtypes import bits
from ..utils.device import resolve


@dataclasses.dataclass(frozen=True)
class ShardedGrid:
    """A grid of `grid_shape` split over `mesh`: mesh axis k splits grid
    dim `dims[k]`; `shards[idx]` is the block of mesh position `idx`, a
    tensor of `shard_shape` in `dtype` on `mesh.devices[idx]`."""

    mesh: object                  # parallel/mesh.py::Mesh
    dims: tuple[int, ...]
    grid_shape: tuple[int, ...]
    shard_shape: tuple[int, ...]
    dtype: torch.dtype
    shards: Mapping[tuple[int, ...], torch.Tensor]

    def layout(self) -> str:
        return describe_layout(self.mesh, self.dims, self.grid_shape, self.shard_shape)


def check_mesh_dims(rank: int, mesh_shape, mesh_dims=None) -> tuple[int, ...]:
    """The grid dims that the axes of a mesh of `mesh_shape` shard (default:
    the leading ones), one distinct dim of the grid per axis; a ValueError
    names the mesh and the grid's rank otherwise."""
    mesh_shape = tuple(mesh_shape)
    if mesh_dims is None:
        if len(mesh_shape) > rank:
            raise ValueError(
                f"a mesh of {len(mesh_shape)} axes {mesh_shape} cannot shard a "
                f"grid of rank {rank}: one tensor dim per mesh axis")
        return tuple(range(len(mesh_shape)))
    dims = tuple(int(d) for d in mesh_dims)
    if len(dims) != len(mesh_shape):
        raise ValueError(f"mesh dims {dims} for a mesh of {len(mesh_shape)} axes "
                         f"{mesh_shape}: one tensor dim per mesh axis")
    if any(not 0 <= d < rank for d in dims) or len(set(dims)) != len(dims):
        raise ValueError(f"mesh dims {dims} of the mesh {mesh_shape} must be "
                         f"distinct dims of a grid of rank {rank}")
    return dims


def padded_shard_shape(grid_shape, mesh_shape, dims) -> tuple[int, ...]:
    """The shape of a shard: each sharded dim ceil(grid / mesh axis)."""
    shard = list(grid_shape)
    for m, d in zip(mesh_shape, dims):
        shard[d] = -(-grid_shape[d] // m)
    return tuple(shard)


def positions(mesh_shape) -> list[tuple[int, ...]]:
    return list(itertools.product(*(range(m) for m in mesh_shape)))


def region(idx, grid_shape, shard_shape, dims) -> dict[int, tuple[int, int]]:
    """The rows of the real grid that the shard at mesh position `idx`
    holds, (start, size) along each sharded dim; a shard wholly in the
    padding has size 0."""
    spans = {}
    for a, d in enumerate(dims):
        start = min(idx[a] * shard_shape[d], grid_shape[d])
        spans[d] = (start, min(shard_shape[d], grid_shape[d] - start))
    return spans


def describe_layout(mesh, dims, grid_shape, shard_shape) -> str:
    axes = ",".join(f"{n}={s}" for n, s in mesh.shape.items())
    devices = ",".join(str(d) for d in mesh.devices.flat)
    return (f"grid {tuple(grid_shape)} in shards of {tuple(shard_shape)} along dims "
            f"{tuple(dims)} over the mesh [{axes}] on [{devices}]")


def same_mesh(a, b) -> bool:
    """Two meshes with the same axes over the same devices."""
    return a is b or (a.axis_names == b.axis_names and a.devices.shape == b.devices.shape
                      and all(x == y for x, y in zip(a.devices.flat, b.devices.flat)))


def narrow(x: torch.Tensor, spans: Mapping[int, tuple[int, int]]) -> torch.Tensor:
    for d, (start, size) in spans.items():
        x = x.narrow(d, start, size)
    return x


def zero_pads(t: torch.Tensor, sizes) -> None:
    """Zero `t` past `sizes` along each dim."""
    for d, n in enumerate(sizes):
        if n < t.shape[d]:
            bits(t).narrow(d, n, t.shape[d] - n).zero_()


def copy_padded(dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst[:src.shape] = src, zeros in the rest of dst (src may be empty)."""
    zero_pads(dst, src.shape)
    if src.numel():
        bits(narrow(dst, {d: (0, n) for d, n in enumerate(src.shape)})).copy_(bits(src))


# a copy between the host and a card moves contiguous bytes: up to this many
# contiguous runs are copied one by one, more go through a pinned block
RUNS_MAX = 4096


def copy_runs(dst: torch.Tensor, src: torch.Tensor, non_blocking: bool = False) -> bool:
    """dst[...] = src as the fewest copies of contiguous runs: over the
    leading dims until what is left is contiguous in both.  Copies nothing
    and returns False when that takes more than `RUNS_MAX` copies."""
    dst, src = bits(dst), bits(src)
    for k in range(dst.ndim + 1):
        lead = tuple(dst.shape[:k])
        if math.prod(lead) > RUNS_MAX:
            return False
        if src.numel() == 0:
            return True
        at = (0,) * k
        if dst[at].is_contiguous() and src[at].is_contiguous():
            for i in itertools.product(*(range(n) for n in lead)):
                dst[i].copy_(src[i], non_blocking=non_blocking)
            return True
    return False


@contextlib.contextmanager
def on_streams(streams):
    """Make each stream the current one of its card, at once."""
    with contextlib.ExitStack() as stack:
        for s in streams:
            stack.enter_context(torch.cuda.stream(s))
        yield


def _count(stats: dict | None, key: str, nbytes: int, source=None) -> None:
    if stats is None:
        return
    stats[key] = stats.get(key, 0) + nbytes
    if source is not None:
        by = stats.setdefault("scatter_from", {})
        by[source] = by.get(source, 0) + nbytes


def shard_grid(x, mesh, dims=None, *, stats: dict | None = None) -> ShardedGrid:
    """`x` (a numpy array or a tensor) laid out over `mesh`, each mesh
    position's block on its own device.

    From the host (numpy, or a CPU tensor) each block is copied to its
    card with `non_blocking` on that card's current stream, from a pinned
    `x` straight by its contiguous runs (`copy_runs`), else through a block
    of pinned memory: no block passes through another card.  From a card,
    each receiving card's block is a peer copy of its own, on a stream of
    the source card for that receiver (torch runs a peer copy on the
    source's stream), so the copies to several cards run side by side; the
    source's current stream then waits for them.  `stats`, if given,
    accumulates `scatter_bytes` (the grid's bytes each shard receives) and
    `scatter_from` (the same by source device)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    grid_shape = tuple(x.shape)
    dims = check_mesh_dims(x.ndim, mesh.devices.shape, dims)
    shard = padded_shard_shape(grid_shape, mesh.devices.shape, dims)
    src = x.device
    current = torch.cuda.current_stream(src) if src.type == "cuda" else None
    side: dict = {}               # receiving card -> stream of the source card
    shards = {}
    for idx in positions(mesh.devices.shape):
        dev = resolve(mesh.devices[idx])
        block = narrow(x, region(idx, grid_shape, shard, dims))
        out = torch.empty(shard, dtype=x.dtype, device=dev)
        if src.type == "cpu" and dev.type == "cuda":
            cells = narrow(out, {d: (0, n) for d, n in enumerate(block.shape)})
            if x.is_pinned() and copy_runs(cells, block, non_blocking=True):
                zero_pads(out, block.shape)
            else:
                stage = torch.empty(shard, dtype=x.dtype, pin_memory=True)
                copy_padded(stage, block)
                bits(out).copy_(bits(stage), non_blocking=True)
        elif src.type == "cuda" and dev != src:
            if dev not in side:
                side[dev] = torch.cuda.Stream(src)
                side[dev].wait_stream(current)
            with torch.cuda.stream(side[dev]):
                copy_padded(out, block)
        else:
            copy_padded(out, block)
        shards[idx] = out
        _count(stats, "scatter_bytes", block.numel() * block.element_size(), str(src))
    for s in side.values():
        current.wait_stream(s)
    return ShardedGrid(mesh, dims, grid_shape, shard, x.dtype, shards)


def gather_grid(g: ShardedGrid, device, *, stats: dict | None = None,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """The whole grid of `g` as one tensor on `device` in `g.dtype`.

    To a card: each shard's rows are copied in by its own card (a peer
    copy runs on the source's stream), on-card where they share it.  To
    "cpu": every shard goes straight into one pinned host tensor by its
    contiguous runs there (`copy_runs`; through a pinned block of its own
    where they are too many), and the call returns once every copy has
    landed.  `out`, if given, is the tensor to gather into (the caller's to
    reuse).  A "cuda" device without a card raises `NoCudaDevice`.
    `stats`, if given, accumulates `gather_bytes`."""
    dev = resolve(device)
    cards = {s.device for s in g.shards.values() if s.device.type == "cuda"}
    pinned = dev.type == "cpu" and bool(cards)
    if out is None:
        out = torch.empty(g.grid_shape, dtype=g.dtype, device=dev, pin_memory=pinned)
    elif (tuple(out.shape), out.dtype, out.device) != (g.grid_shape, g.dtype, dev):
        raise ValueError(f"gathering a {g.dtype} grid of {g.grid_shape} to {dev} into a "
                         f"{out.dtype} tensor of {tuple(out.shape)} on {out.device}")
    staged = []
    for idx, shard in g.shards.items():
        spans = region(idx, g.grid_shape, g.shard_shape, g.dims)
        if any(size == 0 for _, size in spans.values()):
            continue
        dst = bits(narrow(out, spans))
        src = bits(narrow(shard, {d: (0, size) for d, (_, size) in spans.items()}))
        if not (pinned and shard.device.type == "cuda"):
            dst.copy_(src)
        elif not copy_runs(dst, src, non_blocking=True):
            block = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            block.copy_(src, non_blocking=True)
            staged.append((dst, block))
        _count(stats, "gather_bytes", math.prod(src.shape) * src.element_size())
    if pinned:
        for d in cards:
            torch.cuda.current_stream(d).synchronize()
        for dst, block in staged:
            dst.copy_(block)
    return out
