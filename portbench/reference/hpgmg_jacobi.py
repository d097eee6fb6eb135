"""Plain PyTorch reference of `programs/hpgmg_jacobi.soda`, written from the
program's semantics (docs/SEMANTICS.md): a tap out of the grid reads zero,
the expressions are evaluated as written (left to right, every operation
rounded to the storage type, no reassociation, no contraction), and float
literals are float32, widened to the block's dtype: the weight
0.6666666666666666 reads as 0.666666686534881591796875, 2e-8 above 2/3.

HPGMG-FV's weighted-Jacobi smoother of the variable-coefficient Helmholtz
operator A x = a alpha x - b div(beta grad x) on a cell-centred grid with
face-centred coefficients beta_i, beta_j, beta_k (hpgmg.org; Adams et al.,
"HPGMG 1.0", LBNL-6630E, 2014):

    Ax     = a alpha x - b h^-2 ( beta_i[i+1] (x[i+1] - x) - beta_i[i] (x - x[i-1])
                                + beta_j[j+1] (x[j+1] - x) - beta_j[j] (x - x[j-1])
                                + beta_k[k+1] (x[k+1] - x) - beta_k[k] (x - x[k-1]) )
    D^-1   = 1 / (a alpha + b h^-2 (beta_i[i] + beta_i[i+1] + beta_j[j] + beta_j[j+1]
                                   + beta_k[k] + beta_k[k+1]))
    x'     = x + (2/3) D^-1 (rhs - Ax)

as the program writes it:

    dinv(0,0,0) = 1.0 / (alpha(0,0,0) + 262144.0 * (beta_i(0,0,0) + beta_i(0,0,1)
                         + beta_j(0,0,0) + beta_j(0,1,0) + beta_k(0,0,0) + beta_k(1,0,0)))
    xn(0,0,0)   = x(0,0,0) + 0.6666666666666666 * dinv(0,0,0) * (rhs(0,0,0)
                  - (alpha(0,0,0) * x(0,0,0) - 262144.0 * (
                       beta_i(0,0,1) * (x(0,0,1) - x(0,0,0)) - beta_i(0,0,0) * (x(0,0,0) - x(0,0,-1))
                     + beta_j(0,1,0) * (x(0,1,0) - x(0,0,0)) - beta_j(0,0,0) * (x(0,0,0) - x(0,-1,0))
                     + beta_k(1,0,0) * (x(1,0,0) - x(0,0,0)) - beta_k(0,0,0) * (x(0,0,0) - x(-1,0,0)))))

An offset (a, b, c) reads the cell a, b, c further along grid dims 0, 1, 2:
HPGMG's i is dim 2 (contiguous), k is dim 0 (the marched one).  The
departures from HPGMG-FV: a = b = 1 and h = 1/512 (h^-2 = 262144); D^-1
computed in the sweep, not stored; a tap outside the grid reads zero (the
ghost x is 0 on each near face and beta 0 on each far face, where HPGMG
extrapolates Dirichlet ghosts); one 512^3 grid for the eight 256^3 boxes
of `hpgmg-fv 8 8`, so no ghost exchange between boxes.

`x` is the state, the other five the fixed fields.  It imports torch
alone: nothing of the program under test.
"""

from __future__ import annotations

import torch

# planes of dim 0 that one output plane reads on each side
HALO = 1
H2INV = 262144.0
WEIGHT = 0.6666666666666666


def sweep(block: torch.Tensor, rhs: torch.Tensor, alpha: torch.Tensor, beta_i: torch.Tensor,
          beta_j: torch.Tensor, beta_k: torch.Tensor) -> torch.Tensor:
    """One sweep over `block`, planes of x: planes [HALO, n - HALO) of dim 0
    are computed, the HALO planes on each side are read only (zero planes
    stand for the outside of the grid); each field holds the same planes.
    Dims 1 and 2 are whole: out of them a tap reads zero.  The arithmetic
    is in `block`'s dtype."""
    n = block.shape[0] - 2 * HALO
    if n < 1:
        raise ValueError(f"a block of {block.shape[0]} planes has none to compute")

    def c(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32).to(block.dtype).to(block.device)

    def taps(t: torch.Tensor):
        p = torch.nn.functional.pad(t, (1, 1, 1, 1))   # dims 2 and 1

        def tap(a: int, b: int, d: int) -> torch.Tensor:
            return p[1 + a:1 + a + n, 1 + b:p.shape[1] - 1 + b, 1 + d:p.shape[2] - 1 + d]
        return tap

    x, bi, bj, bk = taps(block), taps(beta_i), taps(beta_j), taps(beta_k)
    x0, al, f = x(0, 0, 0), alpha[HALO:HALO + n], rhs[HALO:HALO + n]

    s = bi(0, 0, 0) + bi(0, 0, 1)
    s = s + bj(0, 0, 0)
    s = s + bj(0, 1, 0)
    s = s + bk(0, 0, 0)
    s = s + bk(1, 0, 0)
    dinv = c(1.0) / (al + c(H2INV) * s)

    t = bi(0, 0, 1) * (x(0, 0, 1) - x0) - bi(0, 0, 0) * (x0 - x(0, 0, -1))
    t = t + bj(0, 1, 0) * (x(0, 1, 0) - x0)
    t = t - bj(0, 0, 0) * (x0 - x(0, -1, 0))
    t = t + bk(1, 0, 0) * (x(1, 0, 0) - x0)
    t = t - bk(0, 0, 0) * (x0 - x(-1, 0, 0))
    ax = al * x0 - c(H2INV) * t
    return x0 + c(WEIGHT) * dinv * (f - ax)
