"""Plain PyTorch reference of `programs/jacobi3d.soda`, written from the
program's semantics (docs/SEMANTICS.md): a tap out of the grid reads zero,
the expression is evaluated as written (left to right, every operation
rounded to the storage type, no reassociation, no contraction), float
literals are float32.

    t1(0,0,0) = (t0(0,0,0) + t0(0,0,1) + t0(0,0,-1) + t0(0,1,0)
                 + t0(0,-1,0) + t0(1,0,0) + t0(-1,0,0)) * 0.142857f

An offset (a, b, c) reads the cell a, b, c further along grid dims 0, 1, 2.
It imports torch alone: nothing of the program under test.
"""

from __future__ import annotations

import torch

# planes of dim 0 that one output plane reads on each side
HALO = 1
COEF = 0.142857


def sweep(block: torch.Tensor) -> torch.Tensor:
    """One sweep over `block`: planes [HALO, n - HALO) of dim 0 are
    computed, the HALO planes on each side are read only (zero planes
    stand for the outside of the grid).  Dims 1 and 2 are whole: out of
    them a tap reads zero.  The arithmetic is in `block`'s dtype."""
    n = block.shape[0] - 2 * HALO
    if n < 1:
        raise ValueError(f"a block of {block.shape[0]} planes has none to compute")
    x = torch.nn.functional.pad(block, (1, 1, 1, 1))   # dims 2 and 1

    def tap(a: int, b: int, d: int) -> torch.Tensor:
        return x[1 + a:1 + a + n, 1 + b:x.shape[1] - 1 + b, 1 + d:x.shape[2] - 1 + d]

    s = tap(0, 0, 0) + tap(0, 0, 1)
    s = s + tap(0, 0, -1)
    s = s + tap(0, 1, 0)
    s = s + tap(0, -1, 0)
    s = s + tap(1, 0, 0)
    s = s + tap(-1, 0, 0)
    return s * torch.tensor(COEF, dtype=block.dtype, device=block.device)
