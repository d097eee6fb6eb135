"""Full-grid plain PyTorch backend, for every rank.

Counterpart of `soda_tpu/backend/xla.py` (`shifted_jnp`, `_sweep`,
`build_fn`, `run`).  It is the port's CPU path and the plain version that
the CUDA kernel is held against.  Every stage is evaluated over the whole
grid by the evaluator (`interp/evaluator.py`) with the torch namespace
(`interp/torch_xp.py`): zero-fill taps, int64 accumulators, C division,
masking at stores -- the oracle's semantics operation for operation.

Programs with integers wider than 64 bits, which no kernel runs (as in
`soda_tpu`, whose XLA path alone runs them), take the quad-limb namespace
(`interp/torch_wide128.py`) at `int_width=128`, as
`soda_tpu/backend/xla.py:166-200` does:
their inputs and outputs cross as (..., 2) uint64 words (`backend/io.py`),
limbs inside.
"""

from __future__ import annotations

from typing import Mapping

import torch

from ..interp import torch_wide128 as w128
from ..interp.evaluator import EvalContext, eval_expr, store_cast
from ..interp.torch_xp import TorchXP, plain
from ..interp.wide128 import carrier_rep, is_wide, program_is_128
from ..ir.dtypes import bits
from ..ir.program import StencilProgram
from ..utils.device import resolve
from .io import finalize_outputs, to_torch


def shifted(a: torch.Tensor, offsets: tuple[int, ...]) -> torch.Tensor:
    """out[i] = a[i + off], zero fill out of bounds (uint64 through its
    int64 view)."""
    b = bits(a)
    out = torch.zeros_like(b)
    src, dst = [], []
    for n, off in zip(a.shape, offsets):
        lo, hi = max(off, 0), min(n + off, n)
        if hi <= lo:
            return out.view(a.dtype)
        src.append(slice(lo, hi))
        dst.append(slice(lo - off, hi - off))
    out[tuple(dst)] = b[tuple(src)]
    return out.view(a.dtype)


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


def sweep_128(program: StencilProgram, arrays: dict, params: Mapping,
              device: torch.device) -> dict:
    """One sweep of a >64-bit program (`numpy_ref.run_once_128` over
    torch): values are limb vectors (`torch_wide128.V`) for the wide
    integers, plain tensors for the rest."""
    def tap(name, off):
        v = arrays[name]
        if isinstance(v, w128.V):
            return v.map(lambda t: shifted(t, off))
        return shifted(v, off)

    ctx = EvalContext(program=program, xp=w128.Wide128XP(TorchXP(device)),
                      tap=tap, params=params, int_width=128)
    for name in program.stage_order():
        t = program.tensors[name]
        v, vt = eval_expr(t.expr, ctx)
        s = store_cast(ctx, v, vt, t.type)
        arrays[name] = plain(s.l) if s.rep == "p" else s
    return arrays


def run(program: StencilProgram, inputs: Mapping, params: Mapping | None = None,
        *, device="cuda", iterate: int | None = None) -> dict[str, torch.Tensor]:
    """Run the program (all sweeps) on `device` ("cuda", the default, or
    "cpu"); outputs are tensors in the declared storage dtypes (integers
    wider than 64 bits as (..., 2) uint64 words, `io.to_numpy` makes them
    Python ints).  For iterate > 1 the first output feeds the first input
    each sweep; other inputs carry over; other outputs take their
    final-sweep values."""
    device = resolve(device)
    ins, pars = to_torch(program, inputs, params, device)
    it = max(program.iterate if iterate is None else iterate, 1)
    step = sweep
    if program_is_128(program):
        # the wide integers' words become limbs in their carrier's rep
        xp = TorchXP(device)

        def limbs(v, t):
            return (w128.from_pairs(v, carrier_rep(t), xp)
                    if is_wide(t) else v)

        ins = {n: limbs(v, program.tensors[n].type) for n, v in ins.items()}
        pars = {n: limbs(v, program.params[n].type) for n, v in pars.items()}
        step = sweep_128
    arrays = dict(ins)
    for s in range(it):
        arrays = step(program, arrays, pars, device)
        if s + 1 < it:
            arrays[program.input_names[0]] = arrays[program.output_names[0]]
    outs = {n: arrays[n] for n in program.output_names}
    return finalize_outputs(program, {n: w128.to_pairs(v) if isinstance(v, w128.V) else v
                                      for n, v in outs.items()})
