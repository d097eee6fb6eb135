"""Plain PyTorch reference of `programs/blur.soda`, written from the
program's semantics (docs/SEMANTICS.md, "Integer arithmetic"): a uint16
value promotes to the int32 accumulator, `/` truncates toward zero, a
stage's value is stored in its declared type (blur_x as uint16) before a
later stage reads it, and a tap outside the grid reads zero.

    blur_x(0, 0) = (input(0, 0) + input(0, 1) + input(0, 2)) / 3
    blur_y(0, 0) = (blur_x(-1, 0) + blur_x(0, 0) + blur_x(1, 0)) / 3

An offset (a, b) reads the cell a, b further along grid dims 0, 1.  The
stores take the block's dtype, so the control, given a block in a
narrower type, stores in that type.
It imports torch alone: nothing of the program under test.
"""

from __future__ import annotations

import torch

# rows of dim 0 that one output row reads on each side (blur_y's taps)
HALO = 1


def _third(s: torch.Tensor) -> torch.Tensor:
    return torch.div(s, 3, rounding_mode="trunc")


def sweep(block: torch.Tensor) -> torch.Tensor:
    """blur_y over `block`: rows [1, n - 1) of dim 0 are computed, the row on
    each side is read only (zero rows stand for the outside, where blur_x is
    zero too).  Dim 1 is whole: beyond it a tap reads zero."""
    if block.shape[0] < 3:
        raise ValueError(f"a block of {block.shape[0]} rows has none to compute")
    x = torch.nn.functional.pad(block.to(torch.int32), (0, 2))      # dim 1
    n1 = block.shape[1]
    blur_x = _third(x[:, 0:n1] + x[:, 1:n1 + 1] + x[:, 2:n1 + 2]).to(block.dtype)
    b = blur_x.to(torch.int32)
    return _third(b[:-2] + b[1:-1] + b[2:]).to(block.dtype)
