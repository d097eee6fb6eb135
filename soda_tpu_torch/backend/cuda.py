"""The port's main path: plan, build one kernel per group, run.

Counterpart of `soda_tpu/backend/pallas.py::build_group_fn`, `build_fn`
and `run`.  Groups are chained through device memory; `iterate` runs as
chained one-sweep calls, the first output feeding the first input and the
auxiliary inputs carried over, with two sets of output buffers used in
turn (ping-pong).  Outputs are tensors in the declared dtypes.

The entry point runs on the card unless the caller asks for the CPU
(`device="cpu"`); without a card it raises `NoCudaDevice`.  On CPU tensors
every group runs its plain version (`linebuffer.group_plain`); on CUDA
tensors every group runs its kernel or raises: kernel 1 (the 3-D z-march,
`linebuffer.py`) for rank 3, kernel 2 (the 2-D row-march,
`linebuffer2d.py`) for rank 2 (a rank-3 group with a stage at level 2
or deeper as the column z-march, `columns3d.py`, where its registers
fit), for a plan that fuses nf > 1 sweeps the
fused cascade (`sweeps.py`, kernel 3's counterpart: the column marches,
`columns2d.py` and `columns3d.py`, where their registers fit, else the
marches' rings), `iterate / nf` calls of it, and for a windows group (every rank-1 program, a group pinned with
`block=`, a stage whose rings fit no tile) the windows kernel
(`windows.py`, kernel 4's counterpart).  Every kernel takes integers up
to 64 bits, full-width uint64 included (`uint64_t` carriers);
wider ones are refused with a typed error naming `--backend eager`
(`ir/dtypes.py::check_kernel_types`), as `soda_tpu`'s kernels refuse
them naming `--backend xla`.
"""

from __future__ import annotations

from typing import Mapping

import torch

from ..ir.dtypes import check_kernel_types, torch_dtype
from ..ir.program import StencilProgram
from ..plan.planner import GroupPlan, Plan
from ..plan.planner import plan as make_plan
from ..utils import trace
from ..utils.device import resolve
from . import columns3d, linebuffer, linebuffer2d, sweeps, windows
from .io import finalize_outputs, to_torch

WRAPPERS = {3: linebuffer.GroupKernel, 2: linebuffer2d.GroupKernel}


# each kernel wrapper's module by kernel (the names of `GroupPlan.kernel`,
# the fused sweeps as "sweeps"); each counts its launches in `LAUNCHES`
COUNTED = {"linebuffer3d": linebuffer, "linebuffer2d": linebuffer2d,
           "sweeps": sweeps, "windows": windows}


def launch_counts() -> dict[str, int]:
    """Launches of each kernel wrapper since `reset_launches`, by kernel;
    the CPU plain path never counts."""
    return {k: m.LAUNCHES for k, m in COUNTED.items()}


def feed_counts() -> dict[str, int]:
    """Z-march launches (kernel 1, and the rank-3 cascade it runs) since
    `reset_launches`, by the feed of their input rings: "tma" or
    "scalar" (`linebuffer.FEED_LAUNCHES`)."""
    return dict(linebuffer.FEED_LAUNCHES)


def march_counts() -> dict[str, int]:
    """Launches since `reset_launches` by march
    (`linebuffer.MARCH_LAUNCHES`): the rank-2 cascades' "columns" (the
    column march, `columns2d.py`) or "rings" (the row-march's rings), and
    the z-march's (kernel 1, and the rank-3 cascade it runs) "columns3d"
    (the column z-march, `columns3d.py`) or "rings3d" (its rings)."""
    return dict(linebuffer.MARCH_LAUNCHES)


def stage_count() -> int:
    """Stages computed on chip by the z-march's launches since
    `reset_launches`, summed over the launches: a launch of one sweep
    computes its group's stages (3 for denoise3d, 1 for jacobi3d), a
    cascade's each of its fused sweeps' (`linebuffer.STAGES`)."""
    return linebuffer.STAGES


def planned_bytes() -> int:
    """Device-memory bytes planned for every kernel wrapper's launches since
    `reset_launches`, each launch its group's
    `GroupPlan.hbm_bytes_per_call` (`linebuffer.PLANNED_BYTES`)."""
    return linebuffer.PLANNED_BYTES


def reset_launches() -> None:
    """Set every kernel wrapper's launch count, the z-march's counts by
    feed and by march and its stage count, the rank-2 cascades' counts by
    march and the planned bytes to 0, and clear the timing spans and
    device intervals (`utils/trace.py::reset`) with them."""
    for m in COUNTED.values():
        m.LAUNCHES = 0
    for counts in (linebuffer.FEED_LAUNCHES, linebuffer.MARCH_LAUNCHES):
        for key in counts:
            counts[key] = 0
    linebuffer.STAGES = linebuffer.PLANNED_BYTES = 0
    trace.reset()


def group_kernel(program: StencilProgram, g: GroupPlan) -> linebuffer.GroupKernel:
    """The wrapper of one planned group: the fused cascade when the group
    fuses sweeps, the windows kernel for a windows group, the column
    z-march where the plan gives it, else the line-buffer kernel of the
    program's rank."""
    if g.sweeps > 1:
        return sweeps.GroupKernel(program, g)
    if g.kernel == "windows":
        return windows.GroupKernel(program, g)
    if g.march == "columns3d":
        return columns3d.GroupKernel(program, g)
    return WRAPPERS[program.rank](program, g)


def build_fn(program: StencilProgram, the_plan: Plan | None = None,
             grid_shape: tuple[int, ...] | None = None, *,
             iterate: int | None = None, **plan_kwargs):
    """fn(inputs, params) -> outputs for the whole program (all groups, all
    sweeps) on one grid shape.  Inputs and params are tensors on one device
    in their declared dtypes (`io.to_torch`).  The kernels allocate their
    outputs, unless `fn(..., bufs=fn.alloc(device))` hands them buffers
    made once (host tiling runs every tile through the same ones).  While a
    profiler records, each call is the span `soda.fn` (`utils/trace.py`)."""
    check_kernel_types(program)
    it = max(program.iterate if iterate is None else iterate, 1)
    if the_plan is None:
        if grid_shape is None:
            raise ValueError("need grid_shape or a Plan")
        the_plan = make_plan(program, tuple(grid_shape), iterate=it, **plan_kwargs)
    depth = the_plan.groups[0].sweeps
    if it % depth != 0:
        # a plan whose kernel depth does not divide the executed sweep
        # count would silently under-execute in the chunk loop -- refuse
        raise ValueError(
            f"plan fuses {depth} sweeps per call, which does not divide the "
            f"executed iterate {it}; re-plan with iterate={it} or pick a divisor")
    kernels = [group_kernel(program, g) for g in the_plan.groups]
    chunks = it // depth
    in0, out0 = program.input_names[0], program.output_names[0]

    def fn(inputs: Mapping[str, torch.Tensor],
           params: Mapping[str, torch.Tensor],
           bufs: list[dict] | None = None) -> dict[str, torch.Tensor]:
        with trace.span("soda.fn"):
            values = dict(inputs)
            bufs = list(bufs or [])
            bufs += [None] * (2 - len(bufs))
            for c in range(chunks):
                produced: dict[str, torch.Tensor] = {}
                for k in kernels:
                    outs = k(values, params, out=bufs[c % 2])
                    values.update(outs)
                    produced.update(outs)
                bufs[c % 2] = produced
                if c + 1 < chunks:
                    values = {n: inputs[n] for n in program.input_names}
                    values[in0] = produced[out0]
            return {n: values[n] for n in program.output_names}

    def alloc(device) -> list[dict[str, torch.Tensor]]:
        """Buffers for every tensor the groups write, at the plan's grid
        shape on `device`: one set, two when the calls alternate (`chunks`
        > 1).  `fn(..., bufs=alloc(device))` writes into them and
        allocates nothing; its outputs are views of them."""
        return [{n: torch.empty(the_plan.grid_shape, device=device,
                                dtype=torch_dtype(program.tensors[n].type))
                 for k in kernels for n in k.group.outputs}
                for _ in range(min(chunks, 2))]

    fn.plan = the_plan
    fn.alloc = alloc
    return fn


def run(program: StencilProgram, inputs: Mapping, params: Mapping | None = None,
        *, device="cuda", iterate: int | None = None,
        the_plan: Plan | None = None, **plan_kwargs) -> dict[str, torch.Tensor]:
    """Run `program` on `device` ("cuda", the default, or "cpu"); inputs
    and params may be numpy arrays or tensors.  Returns tensors on
    `device` in the declared storage dtypes."""
    check_kernel_types(program)
    dev = resolve(device)
    ins, pars = to_torch(program, inputs, params, dev)
    grid_shape = tuple(next(iter(ins.values())).shape)
    fn = build_fn(program, the_plan, grid_shape, iterate=iterate, **plan_kwargs)
    return finalize_outputs(program, fn(ins, pars))
