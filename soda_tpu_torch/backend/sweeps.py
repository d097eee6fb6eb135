"""Fused `iterate` sweeps on the H100: kernel source, plain version and wrapper.

Replaces TPU kernel 3, `soda_tpu/backend/pallas.py::_build_strips_group_fn`
(its body `_eval_group`, the trapezoid and the constant-extent fused loop):
nf sweeps of an `iterate` program in one launch, every sweep between the
first read and the last write kept on chip.

The TPU kernel reads a (block + nf * halo) window through clamped strips
and runs all sweeps over it in VMEM, which holds many megabytes.  A CTA
has at most 227 KB of shared memory, and a 3-D tile with an nf-deep halo
would read several times its cells.  So the card runs SODA's own design,
a cascade of sweep copies in the line-buffer marches: the group is
`unroll_iterate(program, nf)` (`plan/planner.py::cascade`), where sweep k
is one more stage of the group and reads sweep k-1 through a shared-memory
ring sized by its lag, exactly as a multi-stage group's stages read each
other.  Kernel 1's z-march (`csrc/linebuffer3d.cuh`) runs rank 3 and
kernel 2's row-march (`csrc/linebuffer2d.cuh`) rank 2; the generated
`__global__` is `soda_sw3d_kernel` / `soda_sw2d_kernel`.

What bounds it on the H100: one call reads every input cell once (plus
the strip halo and the chunk's warm-up of 2 * nf * radius planes or rows)
and writes every output cell once for nf sweeps, so device-memory bytes
per sweep fall by about nf.  What is left is on chip: the cascade's
arithmetic over its trapezoid (every copy computes its full ring width
and the warm-up), which the planner's model (`GroupPlan.modeled_seconds`)
weighs when it picks nf, and each copy's shared-memory taps and their
address arithmetic per cell, which it does not.  Both marches copy the
input planes (rank 3) or rows (rank 2) a step ahead and order a step's
copies one of two ways (`GroupPlan.sync`): skewed, copy k one level
deeper than copy k-1 and a step behind it, so one wait ends a step and no
barrier separates the copies; or every copy at level 1 with a barrier
after each.  The skew deepens every ring by a step (RB rows, or a
plane), which in a deep rank-2 cascade leaves room only for narrow tiles
(jacobi2d x 8: RB 4, 128 columns), so the planner takes the barriers
where they admit a larger tile; heat3d's rings are 4 planes either way
(a power of two), so rank 3 runs the skew.  The automatic depth is capped
per rank where the measured depth sweeps ran deeper cascades slower
(`planner.AUTO_SWEEPS_MAX`).

A cell outside the grid is zero at every sweep, as in the chained
one-sweep calls, so the fused result equals the oracle and the chained
calls on the whole grid, bit for bit (the same operations in the same
order, no FMA).  The TPU kernel differs from the oracle inside the rim
(radius x sweeps, docs/SEMANTICS.md "Border").

`group_plain` is the plain version: nf sweeps of the program through
`eager.eval_stages`, the first output fed back into the first input as
`eager.run` does.  On CPU tensors the wrapper runs it; on CUDA tensors it
launches the fused kernel or raises, never chained calls.
"""

from __future__ import annotations

from typing import Mapping

import torch

from ..ir.program import StencilProgram
from ..plan.planner import GroupPlan, cascade
from . import linebuffer, linebuffer2d

# fused-kernel launches made through GroupKernel (the CPU plain path never counts)
LAUNCHES = 0

KERNEL_NAMES = {3: "soda_sw3d_kernel", 2: "soda_sw2d_kernel"}
MARCHES = {3: "z-march", 2: "row-march"}

NOTE = """\
// Fused iterate sweeps (replaces TPU kernel 3,
// soda_tpu/backend/pallas.py::_build_strips_group_fn).  The group is a
// cascade of {nf} sweep copies in the line-buffer march: copy k reads copy
// k-1 through a shared-memory ring, so the {nf} sweeps between the first
// read and the last write never touch device memory.  Bound on the H100:
// one read of every input and one write of every output per call of {nf}
// sweeps over 3.35 TB/s, or {nf} sweeps' operations, weighted by type,
// over 67 TFLOP/s, whichever is larger; what limits it is each copy's
// shared-memory taps and their address arithmetic per cell.  In the
// {march} copy k either lags copy k-1 by one step (one wait a step, no
// barrier between copies) or follows it behind a barrier (the plan's
// sync).  Cells outside the grid are zero at every sweep, as in the
// chained calls."""


def kernel_source(program: StencilProgram, g: GroupPlan) -> str:
    """CUDA C++ for a fused group of `g.sweeps` sweeps of `program`."""
    if g.sweeps < 2:
        raise ValueError(f"a fused group runs at least 2 sweeps, got {g.sweeps}")
    prog = cascade(program, g.sweeps)
    gen = linebuffer.kernel_source if program.rank == 3 else linebuffer2d.kernel_source
    return gen(prog, g, kernel=KERNEL_NAMES[program.rank],
               note=NOTE.format(nf=g.sweeps, march=MARCHES[program.rank]))


def group_plain(program: StencilProgram, g: GroupPlan,
                values: Mapping[str, torch.Tensor],
                params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """`g.sweeps` sweeps of the whole program over full grids through the
    plain PyTorch path: the version the fused kernel is held against."""
    from .eager import eval_stages

    device = next(iter(values.values())).device
    arrays = {n: values[n] for n in program.input_names}
    in0, out0 = program.input_names[0], program.output_names[0]
    stages = program.stage_order()
    for s in range(g.sweeps):
        eval_stages(program, stages, arrays, params, device)
        if s + 1 < g.sweeps:
            arrays[in0] = arrays[out0]
    return {o: arrays[o] for o in g.outputs}


class GroupKernel(linebuffer.GroupKernel):
    """Wrapper of one fused group's kernel (`g.sweeps` > 1, rank 2 or 3):
    `linebuffer.GroupKernel` with the cascade's source, the program's
    rank, `group_plain` and this module's `LAUNCHES`."""

    def __init__(self, program: StencilProgram, g: GroupPlan):
        if g.sweeps < 2:
            raise ValueError(f"a fused group runs at least 2 sweeps, got {g.sweeps}")
        if program.rank not in KERNEL_NAMES:
            raise ValueError(f"fused sweeps run ranks 2 and 3, got {program.rank}")
        self.rank = program.rank
        self.prefix = f"sw{program.rank}d"
        super().__init__(program, g)
        self.name = f"{self.prefix}_{program.name}_x{g.sweeps}"

    def _generate(self) -> str:
        return kernel_source(self.program, self.group)

    def _plain(self, values, params) -> dict[str, torch.Tensor]:
        return group_plain(self.program, self.group, values, params)

    def _count(self) -> None:
        global LAUNCHES
        LAUNCHES += 1
