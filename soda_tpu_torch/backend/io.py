"""Host boundary of the torch port: checks, dtype conversion, numpy <-> torch.

Counterpart of `soda_tpu/backend/pallas.py::finalize_outputs`, `_check_io`
and `check_tpu_supported` (here `ir/dtypes.py::check_types_supported`).
`to_torch`/`to_numpy` carry the JAX package's inputs and params (numpy
arrays) across to the port, so both packages compute on the same data in
the tests.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..ir.dtypes import check_types_supported, torch_dtype
from ..ir.program import StencilProgram


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


def _as_tensor(v, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype).contiguous()
    a = np.asarray(v)
    t = torch.from_numpy(np.ascontiguousarray(a) if a.ndim else a)
    return t.to(device=device, dtype=dtype).contiguous()


def to_torch(program: StencilProgram, inputs_np: Mapping,
             params_np: Mapping | None, device
             ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """Inputs and params (numpy arrays or tensors) as contiguous tensors on
    `device` in their declared storage dtypes.  Validates names, ranks and
    param shapes."""
    device = torch.device(device)
    params_np = dict(params_np or {})
    check_types_supported(program)
    check_io(program, inputs_np, params_np)
    ins = {}
    for n in program.input_names:
        t = _as_tensor(inputs_np[n], torch_dtype(program.tensors[n].type),
                       device)
        if t.ndim != program.rank:
            raise ValueError(
                f"input {n!r} rank {t.ndim} != program rank {program.rank}")
        ins[n] = t
    shapes = {tuple(t.shape) for t in ins.values()}
    if len(shapes) != 1:
        raise ValueError(f"inputs disagree on the grid shape: {sorted(shapes)}")
    pars = {}
    for p in program.params.values():
        t = _as_tensor(params_np[p.name], torch_dtype(p.type), device)
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(
                f"param {p.name!r} shape {tuple(t.shape)} != declared {p.shape}")
        pars[p.name] = t
    return ins, pars


def finalize_outputs(program: StencilProgram, outs: Mapping) -> dict:
    """Outputs as plain tensors in their declared storage dtypes.  Stage
    stores already mask narrow integers (`evaluator.store_cast` and the
    kernel's `mask_int`), so this only normalizes the dtype."""
    res = {}
    for n, v in outs.items():
        t = torch.as_tensor(v).as_subclass(torch.Tensor)
        res[n] = t.to(torch_dtype(program.tensors[n].type))
    return res


def to_numpy(program: StencilProgram, outs: Mapping) -> dict[str, np.ndarray]:
    """Outputs as numpy arrays in the declared storage dtypes (what
    `soda_tpu`'s `run` functions and the oracle return)."""
    res = {}
    for n, v in finalize_outputs(program, outs).items():
        res[n] = v.detach().cpu().numpy().astype(
            program.tensors[n].type.np_dtype(), copy=False)
    return res
