"""Full-grid plain PyTorch backend, for every rank.

Counterpart of `soda_tpu/backend/xla.py` (`shifted_jnp`, `_sweep`,
`build_fn`, `run`).  It is the port's CPU path and the plain version that
the CUDA kernel is held against.  Every stage is evaluated over the whole
grid by the evaluator (`interp/evaluator.py`) with the torch namespace
(`interp/torch_xp.py`): zero-fill taps, int64 accumulators, C division,
masking at stores -- the oracle's semantics operation for operation.
"""

from __future__ import annotations

from typing import Mapping

import torch

from ..interp.evaluator import EvalContext, eval_expr, store_cast
from ..interp.torch_xp import TorchXP, plain
from ..ir.program import StencilProgram
from ..utils.device import resolve
from .io import finalize_outputs, to_torch


def shifted(a: torch.Tensor, offsets: tuple[int, ...]) -> torch.Tensor:
    """out[i] = a[i + off], zero fill out of bounds."""
    out = torch.zeros_like(a)
    src, dst = [], []
    for n, off in zip(a.shape, offsets):
        lo, hi = max(off, 0), min(n + off, n)
        if hi <= lo:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - off, hi - off))
    out[tuple(dst)] = a[tuple(src)]
    return out


def eval_stages(program: StencilProgram, stages: list[str],
                arrays: dict[str, torch.Tensor],
                params: Mapping[str, torch.Tensor],
                device: torch.device) -> dict[str, torch.Tensor]:
    """Evaluate `stages` (topological order) over full grids, adding each
    stage's stored value to `arrays` (plain tensors, declared dtypes)."""
    xp = TorchXP(device)
    ctx = EvalContext(
        program=program, xp=xp,
        tap=lambda name, off: shifted(arrays[name], off),
        params={k: xp.asarray(v) for k, v in params.items()},
        int_width=64)
    for name in stages:
        t = program.tensors[name]
        v, vt = eval_expr(t.expr, ctx)
        arrays[name] = plain(store_cast(ctx, v, vt, t.type))
    return arrays


def sweep(program: StencilProgram, arrays: dict, params: Mapping,
          device: torch.device) -> dict:
    """One sweep of the whole stage DAG."""
    return eval_stages(program, program.stage_order(), arrays, params, device)


def run(program: StencilProgram, inputs: Mapping, params: Mapping | None = None,
        *, device="cuda", iterate: int | None = None) -> dict[str, torch.Tensor]:
    """Run the program (all sweeps) on `device` ("cuda", the default, or
    "cpu"); outputs are tensors in the declared storage dtypes.  For iterate > 1 the first output feeds the
    first input each sweep; other inputs carry over; other outputs take
    their final-sweep values."""
    device = resolve(device)
    ins, pars = to_torch(program, inputs, params, device)
    it = max(program.iterate if iterate is None else iterate, 1)
    arrays = dict(ins)
    for s in range(it):
        arrays = sweep(program, arrays, pars, device)
        if s + 1 < it:
            arrays[program.input_names[0]] = arrays[program.output_names[0]]
    return finalize_outputs(program, {n: arrays[n] for n in program.output_names})
