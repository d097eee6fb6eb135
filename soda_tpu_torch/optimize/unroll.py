"""The port's copy of `soda_tpu/optimize/unroll.py`: an `iterate` program
as a cascade of sweep copies.

`unroll_iterate(program, nf)` replicates the stage chain `nf` times as
renamed copies, sweep k reading sweep k-1's feedback output where the
original reads its first input.  The result is a plain multi-stage DAG,
so the line-buffer marches run it as one group: each copy is one more
stage of the group, reading the copy before it through a shared-memory
ring (`backend/sweeps.py`).  The port imports nothing of `soda_tpu`;
`tests/test_torch_copies.py` holds this copy equal to the original.

Semantics: identical to running `nf` sweeps, operation for operation.
- the first declared output feeds back into the first input;
- auxiliary inputs keep their names and are read by every copy;
- the intermediate copies of outputs that are not fed back are dead
  stages (no consumer), which `plan/spans.py::group_spans` prunes;
- a feedback output whose type differs from the first input's raises
  `FeedbackTypeError` (the chained calls would cast it; a cascade cannot).
"""

from __future__ import annotations

from ..ir import expr as ir
from ..ir.program import StencilProgram, Tensor


class FeedbackTypeError(TypeError):
    """The fed-back output's type differs from the first input's."""


def unroll_iterate(program: StencilProgram, factor: int | None = None
                   ) -> StencilProgram:
    """Unroll `factor` sweeps (default: all) into chained stage copies.

    Requires iterate > 1.  The feedback pair is first-input <-
    FIRST-declared output; with multiple outputs the intermediate sweeps'
    copies of non-feedback outputs are dead stages (no consumer) and the
    planner prunes them.  The result has iterate = program.iterate // factor."""
    it = max(program.iterate, 1)
    factor = it if factor is None else factor
    if it <= 1 or factor <= 1:
        return program
    if it % factor != 0:
        raise ValueError(f"unroll factor {factor} must divide iterate {it}")

    in_name = program.input_names[0]
    out_name = program.output_names[0]
    t_in, t_out = program.tensors[in_name].type, program.tensors[out_name].type
    if repr(t_in) != repr(t_out):
        raise FeedbackTypeError(
            f"program {program.name!r}: output {out_name!r} ({t_out}) feeds "
            f"back into input {in_name!r} ({t_in}); the types must match")
    stage_names = program.stage_order()

    tensors: dict[str, Tensor] = {}
    for n in program.input_names:
        t = program.tensors[n]
        tensors[n] = Tensor(n, t.type, None, t.dram, t.tile_size)

    prev_out = in_name
    for sweep in range(factor):
        last = sweep == factor - 1
        mapping = {in_name: prev_out}
        for s in stage_names:
            mapping[s] = s if last else f"{s}__it{sweep}"
        for s in stage_names:
            t = program.tensors[s]
            body = ir.rename(t.expr, mapping)
            nm = mapping[s]
            tensors[nm] = Tensor(
                nm, t.type, body, t.dram,
                is_output=(last and t.is_output))
        prev_out = mapping[out_name]

    return StencilProgram(
        name=program.name,
        tensors=tensors,
        params=program.params,
        rank=program.rank,
        burst_width=program.burst_width,
        iterate=it // factor,
        unroll_factor=program.unroll_factor,
        border=program.border,
        cluster=program.cluster,
    )
