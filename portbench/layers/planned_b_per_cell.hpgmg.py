"""planned_b_per_cell.hpgmg: bytes of device memory the program's plans
give one call of HPGMG's smoother, over the cells, read as
planned_b_per_cell.denoise reads them (`cuda.planned_bytes()` over the
launches since the profiled slice opened, times the launches a call, over
the cells).  None where the program has no such counter, or the slice
recorded no launch on the card."""

from portbench import harness


def read(t):
    return harness.load_module("layers", "planned_b_per_cell.denoise").read(t)
