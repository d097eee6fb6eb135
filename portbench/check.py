"""The comparison that decides `correct`.

Each checked sweep is judged by itself: the reference computes one sweep
from the sweep's input (the seed's grid, made again, for the first sweep;
the program's own state for a later one) and every cell of the program's
output is compared with it, bit for bit, in chunks of planes along dim 0
on one device.  Nothing the program derived is used but the states it
produced, which are what is judged.

A reference module defines `HALO` and either `sweep(block, **fields)` or
`sweep_at(block, z0, n0, **fields)`.  `block` holds planes [z0, z0 + len)
of dim 0 of a grid of n0 planes, zero planes standing for the outside;
`sweep_at` is also told where the block lies, which a reference that
fuses several sweeps needs, to zero the planes outside [0, n0) again
after each one, as the program stores zero outside the grid at every
sweep.  Each fixed field of the configuration comes as a block of the
same planes, by its name.
"""

from __future__ import annotations

import torch

_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(_BITS[t.element_size()])


def zero_outside(get, a: int, b: int, n0: int, like_shape, dtype, device) -> torch.Tensor:
    """Planes [a, b) of a grid of n0 planes in `dtype`, `get(lo, hi)` for
    those inside and zero planes outside."""
    lo, hi = max(a, 0), min(b, n0)
    if lo == a and hi == b:
        return get(a, b)
    out = torch.zeros((b - a, *like_shape), dtype=dtype, device=device)
    if hi > lo:
        out[lo - a:hi - a] = get(lo, hi)
    return out


def reference_sweep(reference, block: torch.Tensor, z0: int, n0: int,
                    fields: dict | None = None) -> torch.Tensor:
    """The reference's output planes [z0 + HALO, z0 + len - HALO) from
    `block`, planes [z0, z0 + len) of a grid of n0 planes."""
    if hasattr(reference, "sweep_at"):
        return reference.sweep_at(block, z0, n0, **(fields or {}))
    return reference.sweep(block, **(fields or {}))


def compare_sweep(reference, src, dst, n0: int, plane_shape, chunk: int, dtype,
                  device, fields: dict | None = None) -> dict:
    """One sweep judged: `src(a, b)` and `dst(a, b)` give planes [a, b) of
    the sweep's input and of the program's output (inside the grid), in
    `dtype` on `device`; `fields` maps each fixed field's name to a
    `get(a, b)` alike.  Returns the cells whose bits differ from the
    reference's (`cells_off`) and the widest gap."""
    h = reference.HALO
    off, gap = 0, 0.0
    for z in range(0, n0, chunk):
        z1 = min(z + chunk, n0)
        block = zero_outside(src, z - h, z1 + h, n0, plane_shape, dtype, device)
        blocks = {name: zero_outside(get, z - h, z1 + h, n0, plane_shape, dtype, device)
                  for name, get in (fields or {}).items()}
        want = reference_sweep(reference, block, z - h, n0, blocks)
        got = dst(z, z1)
        off += int((bits(got) != bits(want)).sum())
        gap = max(gap, float((got.double() - want.double()).abs().max()))
        del block, blocks, want, got
    return {"cells_off": off, "max_gap": gap}


def sweep_in_chunks(reference, x: torch.Tensor, chunk: int, dtype: torch.dtype,
                    fields: dict | None = None) -> torch.Tensor:
    """A whole sweep of the grid `x` by the reference computed in `dtype`,
    chunk by chunk, returned in `x`'s dtype (the control, put in the
    program's place); `fields` maps each fixed field's name to its whole
    grid."""
    h, n0 = reference.HALO, x.shape[0]
    out = torch.empty_like(x)
    for z in range(0, n0, chunk):
        z1 = min(z + chunk, n0)

        def low(g):
            return zero_outside(lambda a, b: g[a:b], z - h, z1 + h, n0, g.shape[1:], g.dtype,
                                g.device).to(dtype)

        blocks = {name: low(g) for name, g in (fields or {}).items()}
        out[z:z1] = reference_sweep(reference, low(x), z - h, n0, blocks).to(x.dtype)
    return out
