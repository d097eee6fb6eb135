"""The cells' input grids, made on the device from the seed.

A configuration's `dtype` and its `inputs` say what is made: `dist` (only
"uniform": torch.rand scaled to [low, high) for a float type, torch.randint
on [low, high) for an integer type) and `slab_planes`.  A grid is made in
slabs of that many planes along dim 0, slab k from a generator of its own
seeded by (seed, k), so any run of planes can be made again, on the same
device, without the rest of the grid: the check rebuilds the first input
plane by plane instead of holding it.

A configuration may also name `fields`: inputs of the program held fixed
through the run beside the state, in the configuration's `dtype`, each
with its own `dist`, `low`, `high` and `slab_planes`.  A field is made the
same way from a seed of its own, `field_seed(seed, name)`, so the check
makes any of its planes again too.  A traffic that feeds a ring of frames
makes frame k from `frame_seed(seed, k)`, derived the same way.
"""

from __future__ import annotations

import dataclasses
import hashlib

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
        """The state's: the configuration's `dtype` and `inputs`."""
        return cls._make(config["dtype"], config["inputs"], "inputs")

    @classmethod
    def _make(cls, dtype: str, got: dict, what: str) -> "Spec":
        if got["dist"] not in DISTS:
            raise ValueError(f"{what}.dist {got['dist']!r}: the generator makes only {DISTS}")
        spec = cls(dtype_of(dtype), got["low"], got["high"], got["slab_planes"])
        if not spec.low < spec.high:
            raise ValueError(f"{what} on [{spec.low}, {spec.high}): an empty range")
        return spec


def fields_of(config: dict) -> dict[str, Spec]:
    """The configuration's fixed fields by name (none without `fields`)."""
    return {name: Spec._make(config["dtype"], got, f"fields.{name}")
            for name, got in (config.get("fields") or {}).items()}


def field_seed(seed: int, name: str) -> int:
    """The seed the field `name` is made from, for a run of `seed`."""
    salt = int.from_bytes(hashlib.blake2b(name.encode(), digest_size=8).digest(), "little")
    return (seed * 1_000_033 ^ salt) & _MASK


def frame_seed(seed: int, k: int) -> int:
    """The seed frame k of a ring of input frames is made from."""
    return field_seed(seed, f"frame.{k}")


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
