"""Stage grouping arithmetic, copied for the port.

The port's copy of `soda_tpu/plan/planner.py::group_spans` and
`_group_io`: which tensors a candidate group reads from outside and
writes for outside, and how far each tensor reaches relative to the
group's output cell (SODA's cumulative window math in N-D).  Nothing of
VMEM, Mosaic or the TPU's tiling rules is here; the port imports nothing
of `soda_tpu`.
"""

from __future__ import annotations

from ..ir.program import StencilProgram

Span = tuple[tuple[int, int], ...]


def group_spans(program: StencilProgram, stages: list[str],
                outputs: list[str]) -> dict[str, Span]:
    """Backward-propagate required extents (relative to the output block)
    through the group's stage DAG — SODA's cumulative window math in N-D."""
    rank = program.rank
    spans: dict[str, Span] = {o: tuple((0, 0) for _ in range(rank)) for o in outputs}
    for name in reversed(stages):
        s = spans.get(name)
        if s is None:
            continue  # stage not needed by this group's outputs
        t = program.tensors[name]
        for parent, offs in t.window().items():
            base = spans.get(parent, tuple((0, 0) for _ in range(rank)))
            lo = [b[0] for b in base]
            hi = [b[1] for b in base]
            for off in offs:
                for d in range(rank):
                    lo[d] = min(lo[d], s[d][0] + off[d])
                    hi[d] = max(hi[d], s[d][1] + off[d])
            spans[parent] = tuple(zip(lo, hi))
    return spans


def _group_io(program: StencilProgram, members: list[str]
              ) -> tuple[list[str], list[str]]:
    """(external_inputs, outputs) of a candidate stage set: inputs are
    tensors read from outside; outputs are members visible outside (program
    outputs, or read by a stage not in the set)."""
    mset = set(members)
    ext: dict[str, None] = {}
    for s in members:
        for p in program.tensors[s].parents():
            if p not in mset:
                ext.setdefault(p, None)
    cons = program.consumers()
    outs = [s for s in members
            if program.tensors[s].is_output
            or any(c not in mset for c in cons[s])]
    return list(ext), outs
