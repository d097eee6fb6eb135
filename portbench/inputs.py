"""The cells' input grids, made on the device from the seed.

A configuration's `dtype` and its `inputs` say what is made: `dist` (only
"uniform": torch.rand scaled to [low, high) for a float type, torch.randint
on [low, high) for an integer type) and `slab_planes`.  A grid is made in
slabs of that many planes along dim 0, slab k from a generator of its own
seeded by (seed, k), so any run of planes can be made again, on the same
device, without the rest of the grid: the check rebuilds the first input
plane by plane instead of holding it.
"""

from __future__ import annotations

import dataclasses

import torch

_MIX = 0x9E3779B97F4A7C15
_MASK = (1 << 63) - 1
DISTS = ("uniform",)


def dtype_of(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"no torch dtype named {name!r}")
    return dtype


@dataclasses.dataclass(frozen=True)
class Spec:
    """What one configuration's grid holds."""
    dtype: torch.dtype
    low: float
    high: float
    slab: int

    @classmethod
    def of(cls, config: dict) -> "Spec":
        got = config["inputs"]
        if got["dist"] not in DISTS:
            raise ValueError(f"inputs.dist {got['dist']!r}: the generator makes only {DISTS}")
        spec = cls(dtype_of(config["dtype"]), got["low"], got["high"], got["slab_planes"])
        if not spec.low < spec.high:
            raise ValueError(f"inputs on [{spec.low}, {spec.high}): an empty range")
        return spec


def slab_seed(seed: int, k: int) -> int:
    return (seed * 1_000_003 ^ (k + 1) * _MIX) & _MASK


def _slab(shape, seed: int, k: int, spec: Spec, device) -> torch.Tensor:
    rows = (min(spec.slab, shape[0] - k * spec.slab), *shape[1:])
    gen = torch.Generator(device=device).manual_seed(slab_seed(seed, k))
    if spec.dtype.is_floating_point:
        out = torch.rand(rows, generator=gen, device=device, dtype=spec.dtype)
        if (spec.low, spec.high) != (0, 1):
            out.mul_(spec.high - spec.low).add_(spec.low)
        return out
    return torch.randint(int(spec.low), int(spec.high), rows, generator=gen, device=device,
                         dtype=spec.dtype)


def planes(shape, seed: int, a: int, b: int, spec: Spec, device) -> torch.Tensor:
    """Planes [a, b) of dim 0 of the grid of `shape` made from `seed`,
    zero planes outside [0, shape[0])."""
    out = torch.zeros((b - a, *shape[1:]), dtype=spec.dtype, device=device)
    lo, hi = max(a, 0), min(b, shape[0])
    for k in range(lo // spec.slab, -(-hi // spec.slab) if hi > lo else lo // spec.slab):
        s = _slab(shape, seed, k, spec, device)
        z0 = k * spec.slab
        c0, c1 = max(lo, z0), min(hi, z0 + s.shape[0])
        out[c0 - a:c1 - a] = s[c0 - z0:c1 - z0]
    return out


def grid(shape, seed: int, spec: Spec, device) -> torch.Tensor:
    """The whole grid, one generator call a slab."""
    out = torch.empty(tuple(shape), dtype=spec.dtype, device=device)
    for k in range(-(-shape[0] // spec.slab)):
        out[k * spec.slab:(k + 1) * spec.slab] = _slab(shape, seed, k, spec, device)
    return out
