"""DSL scalar types -> torch dtypes, and which paths carry which integers.

Counterpart of `soda_tpu/ir/types.py::np_dtype`, `jnp_dtype` and
`tpu_storage_dtype`, and of `soda_tpu/backend/pallas.py::check_tpu_supported`.
The GPU has native f16, f64 and int64, so tensors are stored in their
DECLARED storage dtype (`ScalarType.np_dtype`): no container remapping and
no f16 bit patterns.  Integers compute in the signed int64 accumulator of
the oracle (`EvalContext.int_width == 64`); full-width uint64 rides the
unsigned carrier of `interp/torch_xp.py`.

Which path takes which integers, as in `soda_tpu`: every path takes up to
64 bits (uint64 included); integers wider than 64 bits run on the oracle
(`interp/numpy_ref.py`), the plain path (`backend/eager.py`, limb
carriers) and the C++ golden runner (`backend/cpp.py`, `__int128`), and
the kernels, the mesh and host tiling refuse them (`check_kernel_types`).

Torch implements little for `torch.uint64` beyond allocation and
conversion, and not the same on the CPU and the card: every operation on
uint64 storage (copies, fills, zeros, slices, comparisons) goes through
`bits`, its int64 view.
"""

from __future__ import annotations

import numpy as np
import torch

from ..interp.wide128 import is_wide
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
    """Storage dtype of DSL type `t`: the declared width's container.
    Integers wider than 64 bits have none: the plain path holds them as
    limbs (`interp/torch_wide128.py`) and hands them over as (..., 2)
    uint64 word pairs (`backend/io.py`)."""
    if is_wide(t):
        raise UnsupportedTypeError(f"{t}: no torch dtype holds integers wider "
                                   f"than 64 bits")
    return from_numpy_dtype(t.np_dtype())


def storage_bytes(program, names) -> int:
    """Bytes a cell of the tensors `names` takes in the port's storage
    dtypes (`half` 2, 64-bit values 8)."""
    return sum(program.tensors[n].type.np_dtype().itemsize for n in names)


def bits(t: torch.Tensor) -> torch.Tensor:
    """`t` with its uint64 storage seen as int64 (the same bits, a view);
    any other tensor as it is."""
    return t.view(torch.int64) if t.dtype == torch.uint64 else t


def check_kernel_types(program) -> None:
    """Refuse integers wider than 64 bits on a path that runs the CUDA
    kernels (`cuda.build_fn`, the mesh, host tiling), as `soda_tpu`'s
    Pallas kernels refuse them; every narrower type, uint64 included, runs."""
    wide = [f"{n}:{v.type}" for n, v in [*program.tensors.items(), *program.params.items()]
            if is_wide(v.type)]
    if wide:
        raise UnsupportedTypeError(
            f"program {program.name!r} uses integers wider than 64 bits "
            f"({', '.join(wide)}): the CUDA kernels carry integers up to 64 "
            f"bits; run with "
            f"`--backend eager` (limb carriers, exact), `--backend numpy` or "
            f"the C++ golden runner")
