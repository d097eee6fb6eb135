"""The grid kept on a mesh of cards between calls: the sharded fn of
`soda_tpu_torch.parallel.mesh.build_sharded_fn` on `ShardedGrid`s in and
out, `g = {"t0": fn(g, {})["t1"]}` (the resident loop of
scripts/torch_mesh_cards.py, copied, not imported).  The grid is laid out
once by `shard_grid` from the tensor the benchmark made on the first card.
The check reads each shard on its own card by the benchmark's own
arithmetic of the layout (a sharded dim split in equal blocks, the last
padded), not by the program's `gather_grid`."""

from __future__ import annotations

import itertools

import torch


class System:
    def __init__(self, program, config: dict, grid: tuple[int, ...], devices: list):
        from soda_tpu_torch.parallel.mesh import build_sharded_fn, make_mesh

        m = config["mesh"]
        self.sizes, self.dims = tuple(m["sizes"]), tuple(m["dims"])
        n = 1
        for s in self.sizes:
            n *= s
        self.mesh = make_mesh(self.sizes, m["axes"], devices[:n])
        self.devices = list(dict.fromkeys(torch.device(d) for d in devices[:n]))
        self.grid = tuple(grid)
        self.fn = build_sharded_fn(program, self.mesh, grid_shape=self.grid,
                                   dims=list(self.dims), iterate=config["iterate"])
        self.src, self.dst = program.input_names[0], program.output_names[0]
        self.shard = list(self.grid)
        for size, d in zip(self.sizes, self.dims):
            self.shard[d] = -(-self.grid[d] // size)

    def load(self, x: torch.Tensor):
        from soda_tpu_torch.parallel.sharded import shard_grid

        return shard_grid(x, self.mesh, list(self.dims))

    def call(self, g):
        return self.fn({self.src: g}, {})[self.dst]

    def planes(self, g, a: int, b: int, device) -> torch.Tensor:
        """Planes [a, b) of dim 0 of the grid, assembled on `device` from
        the shards that hold them."""
        out = torch.empty((b - a, *self.grid[1:]), dtype=g.dtype, device=device)
        for idx in itertools.product(*(range(s) for s in self.sizes)):
            t = g.shards[idx]
            if tuple(t.shape) != tuple(self.shard):
                raise ValueError(f"shard {idx} is {tuple(t.shape)}, the layout says "
                                 f"{tuple(self.shard)}")
            rows = [(0, n) for n in self.grid]
            for k, d in enumerate(self.dims):
                lo = idx[k] * self.shard[d]
                rows[d] = (lo, min(lo + self.shard[d], self.grid[d]))
            z0, z1 = max(rows[0][0], a), min(rows[0][1], b)
            if z0 >= z1:
                continue
            src = t[z0 - rows[0][0]:z1 - rows[0][0]]
            dst = out[z0 - a:z1 - a]
            for d in range(1, len(self.grid)):
                lo, hi = rows[d]
                src = src.narrow(d, 0, hi - lo)
                dst = dst.narrow(d, lo, hi - lo)
            dst.copy_(src)
        return out

    def reset_counters(self) -> None:
        from soda_tpu_torch.backend import cuda

        cuda.reset_launches()

    def counters(self) -> dict:
        """Launches since `reset_counters`; the rest of the last call."""
        from soda_tpu_torch.backend import cuda

        s = self.fn.stats
        return {"launches": sum(cuda.launch_counts().values()),
                "group_calls": s["group_calls"], "exchange_bytes": s["exchange_bytes"],
                "scatter_bytes": s["scatter_bytes"], "gather_bytes": s["gather_bytes"]}

    def close(self) -> None:
        self.fn = None
