// columns3d.cuh -- the column z-march of rank-3 multi-level groups for Hopper
// (sm_90a).
//
// backend/columns3d.py generates one kernel per (program, group, plan)
// around this header for a group with a stage at level 2 or deeper
// (denoise3d, orient3d, the rank-3 cascades); single-stage groups keep the
// z-march's rings (linebuffer3d.cuh), whose input feeds (the TMA feed and
// the scalar path) this march shares.  The step's end (SODA_STEP_END) is
// async_copy.cuh's.
//
// What computes what.  A CTA owns a (TY, TX) column tile and a chunk of BZ
// planes, as in the rings, and marches z one plane a step.  Each of its NT
// threads owns fixed (y, x) columns for the whole chunk: KT columns of the
// tile (column k * NT + tid, so a warp's lanes hold consecutive x), and KH
// of the halo that the members' spans add around it (soda_halo_cell), so
// that no thread computes a cell twice.  Their positions, grid checks and
// the members whose span holds each halo column are computed once, before
// the march.  Member m computes the plane s + LEAD_m at step s
// (plan/planner.py::zcolumn_leads), so that
//
// - a tap at the thread's own column (dy = dx = 0) reads the thread's own
//   value: computed earlier in the same step, or carried in registers from
//   an earlier one (`soda_regs`: each tensor's planes below its step's
//   own, shifted by one plane a step).  A member read only there never
//   touches shared memory (denoise3d's grad: computed inside w's
//   evaluation, one sqrt a cell of w's columns);
// - an in-plane tap (y or x off) reads the member's exchange buffer in
//   shared memory: NSLOT planes of its span around the tile, the step's
//   own written as the member computes it, the earlier ones read;
// - an input's in-plane taps read its ring (the feeds of linebuffer3d.cuh);
//   its plane at the thread's column is read once, at the step whose
//   leading plane it is, and carried.
//
// So a step needs no barrier between its members: one barrier ends the
// step (every exchange store and ring slot seen).  Every intermediate cell
// of the footprint is computed exactly once a step.
//
// What bounds it on the H100: the instructions a cell (denoise3d: a sqrt
// and two IEEE divisions), against the rings' passes, each with its own
// work items, clamped column runs and ring addressing per item; then
// device-memory bytes, as in the rings.
//
// Every member keeps the oracle's zero-fill semantics (an input read
// outside the grid is zero, and so is a member's value there), so the
// kernel equals interp/numpy_ref.py on the whole grid.
//
// Built with -DSODA_HOST_EMULATION the same source compiles as host C++:
// the NT threads of a CTA take turns, each running its march up to its
// next step's end; thread 0 issues the feed's copies in its turn, and a
// copy lands at the wait on its slot (TMA) or once every thread has
// reached the step's end (the scalar path), or with -DSODA_HAZARD at
// issue, and then the turns go in reverse order.  A step without its
// barrier, an exchange buffer or a ring too shallow shows as a wrong
// result.

#pragma once

#include "linebuffer3d.cuh"

// The (ly, lx) of halo column h, tile-local: the halo is the rectangle of
// rows [ylo, ty + yhi) and columns [xlo, tx + xhi) outside the ty x tx
// tile, dealt row by row: the rows above the tile, those below, then each
// tile row's columns left of the tile and right of it.
SODA_HD void soda_halo_cell(int h, int ty, int tx, int ylo, int yhi, int xlo, int xhi,
                            int& ly, int& lx) {
  const int rw = tx + xhi - xlo, top = -ylo * rw, bottom = yhi * rw;
  if (h < top) {
    ly = ylo + h / rw;
    lx = xlo + h % rw;
  } else if (h < top + bottom) {
    ly = ty + (h - top) / rw;
    lx = xlo + (h - top) % rw;
  } else {
    const int side = h - top - bottom, per = xhi - xlo, j = side % per;
    ly = side / per;
    lx = j < -xlo ? xlo + j : tx + j + xlo;
  }
}
