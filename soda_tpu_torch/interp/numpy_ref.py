"""The NumPy reference: the port's oracle.

The port's copy of `soda_tpu/interp/numpy_interp.py` for types up to 64
bits: every stage evaluated over the whole grid by the evaluator with
numpy as the namespace, zero-fill taps, int64 accumulators, C division,
masking at stores.  It is what the port's kernels and plain path are held
against.  Integers wider than 64 bits (the original's quad-limb path,
`wide128`) raise `UnsupportedTypeError`.

Border convention: `border: ignore` -- out-of-grid taps read zeros; the
whole grid is defined, and every path of the port matches it there.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from ..ir.program import StencilProgram
from ..ir.types import UnsupportedTypeError
from .evaluator import EvalContext, eval_expr, store_cast


def shifted(a: np.ndarray, offsets: tuple[int, ...]) -> np.ndarray:
    """out[i] = a[i + off] with zero fill out of bounds."""
    out = np.zeros_like(a)
    src = []
    dst = []
    for n, off in zip(a.shape, offsets):
        lo_src = max(off, 0)
        hi_src = min(n + off, n)
        if hi_src <= lo_src:
            return out
        src.append(slice(lo_src, hi_src))
        dst.append(slice(lo_src - off, hi_src - off))
    out[tuple(dst)] = a[tuple(src)]
    return out


def run_once(
    program: StencilProgram,
    arrays: dict[str, np.ndarray],
    params: Mapping[str, np.ndarray],
) -> None:
    """Evaluate every stage once (one sweep), updating `arrays` in place."""
    ctx = EvalContext(
        program=program,
        xp=np,
        tap=lambda name, off: shifted(arrays[name], off),
        params=dict(params),
    )
    for name in program.stage_order():
        t = program.tensors[name]
        v, vt = eval_expr(t.expr, ctx)
        arrays[name] = np.asarray(store_cast(ctx, v, vt, t.type))


def run(
    program: StencilProgram,
    inputs: Mapping[str, np.ndarray],
    params: Mapping[str, np.ndarray] | None = None,
    iterate: int | None = None,
) -> dict[str, np.ndarray]:
    """Run the full program (including temporal iteration) on full grids.

    Returns {output_name: array}.  For iterate>1 the FIRST-declared
    output feeds back into the first input each sweep; further outputs
    take their final-sweep values (docs/SEMANTICS.md "multi-output
    iterate")."""
    wide = [n for n, t in list(program.tensors.items()) + list(program.params.items())
            if t.type.is_int and t.type.width > 64]
    if wide:
        raise UnsupportedTypeError(
            f"program {program.name!r}: {wide} wider than 64 bits; the port's "
            f"reference carries integers up to 64 bits (ROADMAP.md queue 1)")
    it = program.iterate if iterate is None else iterate
    params = dict(params or {})
    arrays: dict = {}
    for n in program.input_names:
        t = program.tensors[n]
        a = np.asarray(inputs[n], dtype=t.type.np_dtype())
        if a.ndim != program.rank:
            raise ValueError(f"input {n!r} rank {a.ndim} != program rank {program.rank}")
        arrays[n] = a

    for p in program.params.values():
        if p.name not in params:
            raise ValueError(f"missing param {p.name!r}")
        pv = np.asarray(params[p.name], dtype=p.type.np_dtype())
        if tuple(pv.shape) != tuple(p.shape):
            raise ValueError(
                f"param {p.name!r} shape {pv.shape} != declared {p.shape}")
        params[p.name] = pv

    for sweep in range(max(it, 1)):
        run_once(program, arrays, params)
        if it > 1 and sweep + 1 < it:
            arrays[program.input_names[0]] = arrays[program.output_names[0]]
    return {n: arrays[n] for n in program.output_names}
