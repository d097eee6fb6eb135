"""planned_b_per_cell.denoise: bytes of device memory the program's plans
give one call, over the cells: the program's counter of planned bytes
(`cuda.planned_bytes()`, each launch its group's
`GroupPlan.hbm_bytes_per_call`) over its launches since the profiled slice
opened, times the launches a call (the spans `soda.kernel` a span
`soda.fn` in the slice), over the cells.  Read from `soda_tpu_torch` as
program_trace.py reads the spans; it also prints the program's counters on
standard error.  None where the program has no such counter, or the slice
recorded no launch on the card."""

import sys


def read(t):
    try:
        from soda_tpu_torch.backend import cuda
        from soda_tpu_torch.utils import trace
    except ImportError:
        return None
    if not hasattr(cuda, "planned_bytes"):
        return None
    got = {"launches": sum(cuda.launch_counts().values()),
           "z-march stages": cuda.stage_count(), "planned bytes": cuda.planned_bytes()}
    print(f"program counters since the profiled slice opened: {got}", file=sys.stderr,
          flush=True)
    spans = trace.totals()
    if not got["launches"] or "soda.kernel" not in spans or "soda.fn" not in spans:
        return None
    per_call = spans["soda.kernel"].count / spans["soda.fn"].count
    return got["planned bytes"] / got["launches"] * per_call / t.cells
