"""Bytes per cell from the port's plan, the bound, and rates from a measured time.

Counterpart of `soda_tpu/utils/report.py::analyze`.  The analytic ideal is
hardware-independent: every input read once and every output written once
per call, in storage dtypes (8 B/cell for f32 jacobi3d and smooth1d, 4
B/cell for uint16 blur), for ranks 1 to 3 and every kernel alike.  A call
runs `sweeps` fused sweeps (1 for the line-buffer and windows kernels, nf
for a fused cascade), so the ideal per sweep is the call's over nf.
`analyze` adds the plan's own bytes (tile halos, warm-up and window halos
included) and the bound: the least time the H100 could take for one call,
the larger of
- the ideal bytes of the call over its published 3.35 TB/s, and
- nf x the program's operations per cell x cells over its published
  67 TFLOP/s of f32 outside the tensor cores, each operation weighted by
  the card's rate for its type (`utils/opcount.py::typed_ops`, recorded
  by the planner in `Plan.ops_per_cell`),
and says which one bounds (`bound_by`); `program_bound_ms` is the bound of
all `iterate / nf` calls.  Given the time of a call measured on the card,
`rates` gives the achieved GB/s at the ideal bytes and its share of
3.35 TB/s, and the time per sweep, with the card's name and power limit
beside it: a card set below 700 W runs slower under load.
"""

from __future__ import annotations

import dataclasses
import math
import shutil
import subprocess

from ..plan.planner import H100_SXM_PEAK_GBPS, Plan
from .opcount import H100_SXM_PEAK_TFLOPS


@dataclasses.dataclass
class PlanReport:
    program: str
    grid_shape: tuple[int, ...]
    ideal_bytes_per_cell: float          # per call: inputs read once, outputs written once
    plan_bytes_per_cell: float           # per call, incl. halos and warm-up
    cells: int
    ops_per_cell: float                  # f32-equivalent, one sweep of every stage
    sweeps: int = 1                      # fused sweeps per call
    calls: int = 1                       # calls per program run (iterate / sweeps)

    @property
    def bytes_bound_ms(self) -> float:
        """Ideal bytes of one call over 3.35 TB/s, in ms."""
        return self.ideal_bytes_per_cell * self.cells / (H100_SXM_PEAK_GBPS * 1e9) * 1e3

    @property
    def ops_bound_ms(self) -> float:
        """Operations of one call (nf sweeps) over 67 TFLOP/s, in ms."""
        return (self.sweeps * self.ops_per_cell * self.cells
                / (H100_SXM_PEAK_TFLOPS * 1e12) * 1e3)

    @property
    def bound_ms(self) -> float:
        """The least time of one call on the H100, in ms."""
        return max(self.bytes_bound_ms, self.ops_bound_ms)

    @property
    def bound_by(self) -> str:
        return "bytes" if self.bytes_bound_ms >= self.ops_bound_ms else "operations"

    @property
    def program_bound_ms(self) -> float:
        """The least time of a whole program run (all calls), in ms."""
        return self.bound_ms * self.calls

    @property
    def plan_bytes_per_cell_update(self) -> float:
        return self.plan_bytes_per_cell / self.sweeps


def analyze(plan: Plan) -> PlanReport:
    """The report of `plan`: its bytes and its bound."""
    cells = math.prod(plan.grid_shape)
    total = sum(g.hbm_bytes_per_call for g in plan.groups)
    nf = plan.groups[0].sweeps
    return PlanReport(
        program=plan.program_name, grid_shape=tuple(plan.grid_shape),
        ideal_bytes_per_cell=plan.ideal_bytes_per_cell,
        plan_bytes_per_cell=total / cells, cells=cells,
        ops_per_cell=plan.ops_per_cell, sweeps=nf,
        calls=max(plan.sweeps_total // nf, 1))


def card() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card, or
    "not measured" where nvidia-smi is missing or fails."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "not measured"
    r = subprocess.run([exe, "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if r.returncode == 0 and lines else "not measured"


def rates(report: PlanReport, seconds_per_call: float, card_info: str) -> dict:
    """Achieved rates of one call (the plan's `report.sweeps` fused sweeps)
    measured on the card."""
    gbps = report.ideal_bytes_per_cell * report.cells / seconds_per_call / 1e9
    return {
        "achieved_gbps_at_ideal_bytes": gbps,
        "share_of_3350_gbps": gbps / H100_SXM_PEAK_GBPS,
        "ms_per_sweep": seconds_per_call / report.sweeps * 1e3,
        "share_of_bound": report.bound_ms / (seconds_per_call * 1e3),
        "card": card_info,
    }
