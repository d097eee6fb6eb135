"""DSL scalar types -> torch dtypes.

Counterpart of `soda_tpu/ir/types.py::np_dtype`, `jnp_dtype` and
`tpu_storage_dtype`.  The GPU has native f16, f64 and int64, so tensors
are stored in their DECLARED storage dtype (`ScalarType.np_dtype`): no
container remapping and no f16 bit patterns.  Integers compute in the
signed int64 accumulator of the oracle (`EvalContext.int_width == 64`).
"""

from __future__ import annotations

import numpy as np
import torch

from .types import ScalarType, UnsupportedTypeError

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.uint64): torch.uint64,
}


def from_numpy_dtype(dt) -> torch.dtype:
    """torch dtype of a numpy dtype (or a torch dtype, returned as is)."""
    if isinstance(dt, torch.dtype):
        return dt
    try:
        return _NP_TO_TORCH[np.dtype(dt)]
    except KeyError:
        raise UnsupportedTypeError(f"no torch dtype for numpy {dt!r}") from None


def torch_dtype(t: ScalarType) -> torch.dtype:
    """Storage dtype of DSL type `t`: the declared width's container."""
    if t.is_int and t.width > 64:
        raise UnsupportedTypeError(
            f"{t}: integers wider than 64 bits are not ported to torch yet "
            f"(ROADMAP.md queue 1, the `wide128` item); run soda_tpu's XLA "
            f"backend or the NumPy oracle")
    return from_numpy_dtype(t.np_dtype())


def check_types_supported(program) -> None:
    """Reject programs whose types the torch namespace cannot carry:
    integers wider than 64 bits (no int128) and full-width uint64, whose
    unsigned 64-bit carrier (`EvalContext.acc_of`) needs arithmetic that
    torch does not implement for `torch.uint64`."""
    types = [(n, t.type) for n, t in program.tensors.items()]
    types += [(p.name, p.type) for p in program.params.values()]
    for name, t in types:
        torch_dtype(t)
        if t.is_int and t.kind == "uint" and t.width == 64:
            raise UnsupportedTypeError(
                f"{name}: {t} needs an unsigned 64-bit carrier, and torch "
                f"has no uint64 arithmetic; not ported yet (ROADMAP.md "
                f"queue 1, the `wide128` item)")
