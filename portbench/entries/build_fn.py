"""The port's main path on one card: `soda_tpu_torch.backend.cuda.build_fn`'s
fn, each call's output the next call's input, the fn allocating its
outputs (nothing written in place).  The state is the grid, a tensor on
the card."""

from __future__ import annotations

import torch


class System:
    def __init__(self, program, config: dict, grid: tuple[int, ...], devices: list):
        from soda_tpu_torch.backend import cuda

        self.devices = [torch.device(devices[0])]
        self.fn = cuda.build_fn(program, grid_shape=grid, iterate=config["iterate"])
        self.src, self.dst = program.input_names[0], program.output_names[0]
        self.cuda = cuda

    def load(self, x: torch.Tensor) -> torch.Tensor:
        """The first state from the grid the benchmark made on the card."""
        return x

    def call(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn({self.src: x}, {})[self.dst]

    def planes(self, x: torch.Tensor, a: int, b: int, device) -> torch.Tensor:
        """Planes [a, b) of dim 0 of the state, inside the grid."""
        return x[a:b].to(device)

    def reset_counters(self) -> None:
        self.cuda.reset_launches()

    def counters(self) -> dict:
        """The program's counters since `reset_counters`."""
        return {"launches": sum(self.cuda.launch_counts().values())}

    def close(self) -> None:
        self.fn = None
