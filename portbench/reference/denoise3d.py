"""Plain PyTorch reference of `programs/denoise3d.soda`, written from the
program's semantics (docs/SEMANTICS.md): a tap out of the grid reads zero,
every stage is zero outside the grid (so `grad` and `w` are, where `unew`
taps them), the expressions are evaluated as written (left to right, every
operation rounded to the storage type, no reassociation, no contraction),
and float literals are float32.

    grad(0,0,0) = sqrt((u(0,0,1) - u(0,0,-1)) * (u(0,0,1) - u(0,0,-1))
                       + (u(0,1,0) - u(0,-1,0)) * (u(0,1,0) - u(0,-1,0))
                       + (u(1,0,0) - u(-1,0,0)) * (u(1,0,0) - u(-1,0,0)) + 0.0001f)
    w(0,0,0)    = 1.0f / (1.0f + grad(0,0,0))
    unew(0,0,0) = (u(0,0,0) + 0.1f * (w(0,0,1) * u(0,0,1) + w(0,0,-1) * u(0,0,-1)
                                      + w(0,1,0) * u(0,1,0) + w(0,-1,0) * u(0,-1,0)
                                      + w(1,0,0) * u(1,0,0) + w(-1,0,0) * u(-1,0,0))
                   + 0.05f * rhs(0,0,0))
                  / (1.0f + 0.1f * (w(0,0,1) + w(0,0,-1) + w(0,1,0) + w(0,-1,0)
                                    + w(1,0,0) + w(-1,0,0)) + 0.05f)

An offset (a, b, c) reads the cell a, b, c further along grid dims 0, 1, 2.
`u` is the state, `rhs` the fixed field.  It imports torch alone: nothing
of the program under test.
"""

from __future__ import annotations

import torch

# planes of dim 0 that one output plane reads on each side: unew taps w one
# plane away, and w (through grad) taps u one further
HALO = 2


def _pad(x: torch.Tensor) -> torch.Tensor:
    """Zero rows and columns around dims 1 and 2 (the outside of the grid)."""
    return torch.nn.functional.pad(x, (1, 1, 1, 1))


def _zero_outside(x: torch.Tensor, z0: int, n0: int) -> torch.Tensor:
    """`x`, planes [z0, z0 + len) of a grid of n0 planes, with the planes
    outside [0, n0) set to zero."""
    lo, hi = max(0, -z0), min(x.shape[0], n0 - z0)
    if lo > 0 or hi < x.shape[0]:
        x = x.clone()
        x[:lo] = 0
        x[max(hi, lo):] = 0
    return x


def sweep_at(block: torch.Tensor, z0: int, n0: int, rhs: torch.Tensor) -> torch.Tensor:
    """One sweep: `block` holds planes [z0, z0 + len) of u in a grid of n0
    planes (zero planes outside it), `rhs` the same planes of the field;
    returns unew's planes [z0 + HALO, z0 + len - HALO).  Dims 1 and 2 are
    whole.  The arithmetic is in `block`'s dtype."""
    if block.shape[0] - 2 * HALO < 1:
        raise ValueError(f"a block of {block.shape[0]} planes has none to compute")

    def f(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=block.dtype, device=block.device)

    u = _pad(block)
    m = block.shape[0] - 2              # grad and w on the block's planes [1, len - 1)

    def tu(a: int, b: int, c: int, first: int, n: int) -> torch.Tensor:
        return u[first + a:first + a + n, 1 + b:u.shape[1] - 1 + b, 1 + c:u.shape[2] - 1 + c]

    def tg(a: int, b: int, c: int) -> torch.Tensor:
        return tu(a, b, c, 1, m)

    grad = torch.sqrt((tg(0, 0, 1) - tg(0, 0, -1)) * (tg(0, 0, 1) - tg(0, 0, -1))
                      + (tg(0, 1, 0) - tg(0, -1, 0)) * (tg(0, 1, 0) - tg(0, -1, 0))
                      + (tg(1, 0, 0) - tg(-1, 0, 0)) * (tg(1, 0, 0) - tg(-1, 0, 0))
                      + f(0.0001))
    grad = _zero_outside(grad, z0 + 1, n0)
    w = _zero_outside(f(1.0) / (f(1.0) + grad), z0 + 1, n0)
    W = _pad(w)
    n = m - 2                           # unew on the block's planes [2, len - 2)

    def tw(a: int, b: int, c: int) -> torch.Tensor:
        return W[1 + a:1 + a + n, 1 + b:W.shape[1] - 1 + b, 1 + c:W.shape[2] - 1 + c]

    def t(a: int, b: int, c: int) -> torch.Tensor:
        return tu(a, b, c, 2, n)

    num = (t(0, 0, 0)
           + f(0.1) * (tw(0, 0, 1) * t(0, 0, 1) + tw(0, 0, -1) * t(0, 0, -1)
                       + tw(0, 1, 0) * t(0, 1, 0) + tw(0, -1, 0) * t(0, -1, 0)
                       + tw(1, 0, 0) * t(1, 0, 0) + tw(-1, 0, 0) * t(-1, 0, 0))
           + f(0.05) * rhs[2:2 + n])
    den = (f(1.0) + f(0.1) * (tw(0, 0, 1) + tw(0, 0, -1) + tw(0, 1, 0) + tw(0, -1, 0)
                              + tw(1, 0, 0) + tw(-1, 0, 0))
           + f(0.05))
    return num / den
