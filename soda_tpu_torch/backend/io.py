"""Host boundary of the torch port: checks, dtype conversion, numpy <-> torch.

Counterpart of `soda_tpu/backend/pallas.py::finalize_outputs` and
`_check_io` (the kernels' type check is `ir/dtypes.py::check_kernel_types`).
`to_torch`/`to_numpy` carry the JAX package's inputs and params (numpy
arrays) across to the port, so both packages compute on the same data in
the tests: uint64 values as they are (above 2^63 too), and integers wider
than 64 bits (object arrays of Python ints) as (..., 2) uint64 tensors of
their 64-bit words, low word first (the golden runner's 16-byte layout,
`interp/wide128.py::object_to_pairs`), which the plain path turns into
limbs (`interp/torch_wide128.py`).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..interp.wide128 import is_wide, object_to_pairs, pairs_to_object
from ..ir.dtypes import bits, torch_dtype
from ..ir.program import StencilProgram
from ..ir.types import ScalarType


def check_io(program: StencilProgram, inputs: Mapping, params: Mapping) -> None:
    missing = [n for n in program.input_names if n not in inputs]
    if missing:
        raise ValueError(
            f"missing input tensor(s) {missing}; program {program.name!r} "
            f"expects inputs {program.input_names}")
    missing_p = [n for n in program.params if n not in params]
    if missing_p:
        raise ValueError(
            f"missing param(s) {missing_p}; program {program.name!r} "
            f"declares params {list(program.params)}")


def _as_tensor(v, t: ScalarType, device: torch.device) -> torch.Tensor:
    """`v` as a contiguous tensor on `device` in `t`'s storage dtype; for
    an integer wider than 64 bits, its (..., 2) uint64 words (from an
    object array of Python ints, or from such words already)."""
    if is_wide(t):
        if not isinstance(v, torch.Tensor):
            a = np.asarray(v)
            v = torch.from_numpy(np.ascontiguousarray(
                a if a.dtype == np.uint64 else object_to_pairs(a)))
        dtype = torch.uint64
    else:
        dtype = torch_dtype(t)
        if not isinstance(v, torch.Tensor):
            a = np.asarray(v, dtype=t.np_dtype())
            v = torch.from_numpy(np.ascontiguousarray(a) if a.ndim else a)
    if dtype == torch.uint64:
        # through the int64 view: torch does not copy or convert uint64
        # alike on every device (other integers extend by their sign)
        v = bits(v) if v.dtype == torch.uint64 else v.to(torch.int64)
        return v.to(device).contiguous().view(torch.uint64)
    return v.to(device=device, dtype=dtype).contiguous()


def _shape(t: torch.Tensor, st: ScalarType) -> tuple[int, ...]:
    """The grid (or param) shape of a tensor: without the word axis of a
    >64-bit integer's (..., 2) words."""
    if is_wide(st):
        if t.ndim == 0 or t.shape[-1] != 2:
            raise ValueError(f"a >64-bit integer ({st}) crosses as (..., 2) "
                             f"uint64 words, got shape {tuple(t.shape)}")
        return tuple(t.shape[:-1])
    return tuple(t.shape)


def to_torch(program: StencilProgram, inputs_np: Mapping,
             params_np: Mapping | None, device
             ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """Inputs and params (numpy arrays or tensors) as contiguous tensors on
    `device` in their declared storage dtypes (integers wider than 64
    bits as (..., 2) uint64 words).  Validates names, ranks and param
    shapes."""
    device = torch.device(device)
    params_np = dict(params_np or {})
    check_io(program, inputs_np, params_np)
    ins, shapes = {}, set()
    for n in program.input_names:
        st = program.tensors[n].type
        t = _as_tensor(inputs_np[n], st, device)
        shape = _shape(t, st)
        if len(shape) != program.rank:
            raise ValueError(
                f"input {n!r} rank {len(shape)} != program rank {program.rank}")
        ins[n] = t
        shapes.add(shape)
    if len(shapes) != 1:
        raise ValueError(f"inputs disagree on the grid shape: {sorted(shapes)}")
    return ins, params_to_torch(program, params_np, device)


def params_to_torch(program: StencilProgram, params_np: Mapping,
                    device) -> dict[str, torch.Tensor]:
    """The params as contiguous tensors on `device` in their declared
    dtypes; checks their shapes."""
    pars = {}
    for p in program.params.values():
        t = _as_tensor(params_np[p.name], p.type, torch.device(device))
        if _shape(t, p.type) != tuple(p.shape):
            raise ValueError(
                f"param {p.name!r} shape {_shape(t, p.type)} != declared {p.shape}")
        pars[p.name] = t
    return pars


def finalize_outputs(program: StencilProgram, outs: Mapping) -> dict:
    """Outputs as plain tensors in their declared storage dtypes (>64-bit
    integers: (..., 2) uint64 words).  Stage stores already mask narrow
    integers (`evaluator.store_cast` and the kernel's `mask_int`), so this
    only normalizes the dtype."""
    res = {}
    for n, v in outs.items():
        t = torch.as_tensor(v).as_subclass(torch.Tensor)
        st = program.tensors[n].type
        dt = torch.uint64 if is_wide(st) else torch_dtype(st)
        res[n] = t if t.dtype == dt else t.to(dt)
    return res


def to_numpy(program: StencilProgram, outs: Mapping) -> dict[str, np.ndarray]:
    """Outputs as numpy arrays in the declared storage dtypes (what
    `soda_tpu`'s `run` functions and the oracle return: object arrays of
    Python ints above 64 bits)."""
    res = {}
    for n, v in finalize_outputs(program, outs).items():
        st = program.tensors[n].type
        a = bits(v).detach().cpu().numpy()
        if v.dtype == torch.uint64:
            a = a.view(np.uint64)
        res[n] = (pairs_to_object(a, st.is_signed) if is_wide(st)
                  else a.astype(st.np_dtype(), copy=False))
    return res
