"""Plain PyTorch reference of `programs/jacobi2d.soda`, written from the
program's semantics (docs/SEMANTICS.md): a tap out of the grid reads zero,
the expression is evaluated as written (left to right, every operation
rounded to the storage type, no reassociation, no contraction), float
literals are float32, and `iterate: 8` runs the sweep 8 times, each sweep's
output the next one's input, with zero outside the grid at every sweep.

    t1(0,0) = (t0(0,1) + t0(1,0) + t0(0,0) + t0(0,-1) + t0(-1,0)) * 0.2f

An offset (a, b) reads the cell a, b further along grid dims 0, 1.
It imports torch alone: nothing of the program under test.
"""

from __future__ import annotations

import torch

SWEEPS = 8
# planes of dim 0 that one output plane reads on each side, over all sweeps
HALO = SWEEPS
COEF = 0.2


def one_sweep(block: torch.Tensor) -> torch.Tensor:
    """One sweep over `block`: rows [1, n - 1) of dim 0 are computed, the
    row on each side is read only.  Dim 1 is whole: out of it a tap reads
    zero.  The arithmetic is in `block`'s dtype."""
    n = block.shape[0] - 2
    if n < 1:
        raise ValueError(f"a block of {block.shape[0]} rows has none to compute")
    x = torch.nn.functional.pad(block, (1, 1))   # dim 1

    def tap(a: int, b: int) -> torch.Tensor:
        return x[1 + a:1 + a + n, 1 + b:x.shape[1] - 1 + b]

    s = tap(0, 1) + tap(1, 0)
    s = s + tap(0, 0)
    s = s + tap(0, -1)
    s = s + tap(-1, 0)
    return s * torch.tensor(COEF, dtype=block.dtype, device=block.device)


def sweep_at(block: torch.Tensor, z0: int, n0: int) -> torch.Tensor:
    """SWEEPS sweeps over `block`, rows [z0, z0 + len) of a grid of n0
    rows (zero rows stand for the outside): rows [HALO, len - HALO) of
    the block are returned.  After each sweep the rows outside [0, n0)
    are set to zero again, as the grid's outside reads zero at every
    sweep."""
    for _ in range(SWEEPS):
        block = one_sweep(block)
        z0 += 1
        lo, hi = max(0, -z0), min(block.shape[0], n0 - z0)
        if lo > 0 or hi < block.shape[0]:
            block = block.clone()
            block[:lo] = 0
            block[max(hi, lo):] = 0
    return block
