"""Bytes per cell from the port's plan, and rates from a measured time.

Counterpart of `soda_tpu/utils/report.py::analyze`.  The analytic ideal is
hardware-independent: every input read once and every output written once
per sweep, in storage dtypes (8 B/cell for f32 jacobi3d, 4 B/cell for
uint16 blur), for ranks 2 and 3 alike.  `analyze` adds the plan's own bytes
(tile halos and warm-up included) and the bound: the least time the H100
could take for one sweep, the ideal bytes over its published 3.35 TB/s
(the stencils do far fewer operations per byte than the card's peak
rates allow, so bytes bound them).  Given a time measured on the card,
`rates` gives the achieved GB/s at the ideal bytes and its share of
3.35 TB/s, with the card's name and power limit beside it: a card set
below 700 W runs slower under load.
"""

from __future__ import annotations

import dataclasses
import math
import shutil
import subprocess

from ..plan.planner import Plan

H100_SXM_PEAK_GBPS = 3350.0  # published HBM3 bandwidth of the H100 SXM at 700 W


@dataclasses.dataclass
class PlanReport:
    program: str
    grid_shape: tuple[int, ...]
    ideal_bytes_per_cell: float          # per sweep
    plan_bytes_per_cell: float           # per sweep, incl. halos and warm-up
    cells: int

    @property
    def bound_ms(self) -> float:
        """Ideal bytes of one sweep over 3.35 TB/s, in ms."""
        return self.ideal_bytes_per_cell * self.cells / (H100_SXM_PEAK_GBPS * 1e9) * 1e3


def analyze(plan: Plan) -> PlanReport:
    cells = math.prod(plan.grid_shape)
    total = sum(g.hbm_bytes_per_call for g in plan.groups)
    return PlanReport(
        program=plan.program_name, grid_shape=tuple(plan.grid_shape),
        ideal_bytes_per_cell=plan.ideal_bytes_per_cell,
        plan_bytes_per_cell=total / cells, cells=cells)


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


def rates(report: PlanReport, seconds_per_sweep: float, card_info: str) -> dict:
    """Achieved bandwidth of one sweep measured on the card."""
    gbps = report.ideal_bytes_per_cell * report.cells / seconds_per_sweep / 1e9
    return {
        "achieved_gbps_at_ideal_bytes": gbps,
        "share_of_3350_gbps": gbps / H100_SXM_PEAK_GBPS,
        "card": card_info,
    }
