// columns2d.cuh -- the column march of rank-2 fused cascades for Hopper (sm_90a).
//
// backend/columns2d.py generates one kernel per (program, cascade, plan)
// around this header; the input rows are copied by the row-march's helpers
// (linebuffer2d.cuh), the 16-byte copy, the step's wait and its end
// (SODA_STEP_END) are async_copy.cuh's.
//
// What computes what.  A CTA owns a strip of TX columns (and the cascade's
// x halo) and a chunk of BY rows, as in the row-march; each thread owns one
// column of it for the whole chunk and walks down the rows RB at a time,
// SODA's own dataflow, in which a processing element streams one column.
// Member m of the group (a sweep copy, or a stage of one) computes the rows
// s * RB + LEAD_m .. + RB - 1 at step s; the leads (plan/planner.py::
// column_leads) skew the members so that
//
// - an in-column tap (dx 0) reads the thread's own values of the tensor:
//   the rows carried from earlier steps in registers (`soda_regs`, a
//   window that shifts by RB a step) and the rows the member computed
//   earlier in the same step.  No shared memory, no ring address;
// - an off-column tap reads the neighbour's value from the tensor's
//   exchange buffer in shared memory, NSLOT slots of RB rows used in turn,
//   written at an earlier step.  The step loop is unrolled NSLOT times
//   (`soda_step<PH>`), so every slot is a constant and, the column fixed,
//   every exchange read one load at a constant offset;
// - an input is read through its ring, copied a step ahead with
//   soda_fetch_rows_v / _s; each thread loads its column's rows of the step
//   into its window once.
//
// So the members of a step need no barrier between them: one barrier ends
// the step (the copies landed, every exchange store seen).  A step at which
// every member's rows lie inside the grid and the member's span (the
// chunk's middle) computes them with no per-row check.
//
// What bounds it on the H100.  At 16384^2, device-memory bytes (one read
// and one write a cell a call); on chip, each cell-sweep's instructions:
// its operations, one exchange load a neighbour and one store, against the
// row-march's shared-memory load a tap and ring addressing.
//
// Every member keeps the oracle's zero-fill semantics (an input read
// outside the grid is zero, and so is a member's value there), so the
// kernel equals interp/numpy_ref.py on the whole grid.
//
// Built with -DSODA_HOST_EMULATION the same source compiles as host C++:
// the NT threads of a CTA take turns, each running its march up to its
// next step barrier (SODA_STEP_END); the copies land once every thread has
// reached it (async_copy.cuh), or with -DSODA_HAZARD at issue, and then
// the turns go in reverse order.  A step without its barrier, or an
// exchange buffer too shallow, shows as a wrong result.

#pragma once

#include "linebuffer2d.cuh"

// floor(a / b) for b > 0
SODA_HD int soda_floor_div(int a, int b) { return a >= 0 ? a / b : -((b - 1 - a) / b); }

