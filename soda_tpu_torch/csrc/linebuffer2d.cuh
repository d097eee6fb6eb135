// linebuffer2d.cuh -- the 2-D line-buffer row-march for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel soda_tpu/backend/_linebuffer.py::
// build_linebuffer2d_group_fn (both its emit_pipeline and mosaic engines):
// one fused group of a rank-2 stencil program over the whole (H, W) grid,
// and (backend/sweeps.py) the cascade of fused iterate sweeps.
// backend/linebuffer2d.py generates one kernel per (program, group, plan)
// from the IR; this header holds the march's row copies, async_copy.cuh
// the 16-byte copy and the step's wait, and soda_common.cuh the C
// semantics, math overloads and `soda_half`.
//
// What computes what.  The TPU kernel walks row blocks in order on one
// core and carries the last rows of every input from one grid step to the
// next.  CUDA blocks run in parallel and in no order, so a CTA owns a
// strip of TX columns and a chunk of BY rows and marches its rows RB at a
// time, with its own warm-up.  Every tensor the group taps at a row offset
// (inputs and intermediate stages) has a ring of rows in shared memory; a
// row's slot is (row - base) & (depth - 1).
//
// What bounds it on the H100.  At the 16384^2 grids, device-memory bytes:
// one read of every input and one write of every output per call over
// 3.35 TB/s.  At the main path's 16 MiB grids, which stay in the 50 MB L2
// between calls, latency.  A march that loads each step's rows
// synchronously waits one full memory latency per step, then meets a
// CTA-wide barrier after every stage (nine a step for jacobi2d x 8).  Past
// both, the shared-memory taps and their address arithmetic per cell
// (scripts/torch_sass_mix.py counts them).  So:
//
// - One wait per step (`sync` "skew").  A stage at level L (1 + the
//   deepest level it reads in the group, inputs level 0) computes the
//   rows of step s - (L - 1) during step s, so no stage reads a row
//   written in the same step -- SODA's dataflow of one processing element
//   per stage with buffers between them, skewed by whole steps.  The
//   stages of a step run one after another in each thread with no barrier
//   between them; the one wait (cp.async.wait_all, then __syncthreads)
//   ends the step.  The skew costs deeper rings (the planner sizes each
//   ring for its consumers' lag in steps) and DRAIN = deepest level - 1
//   more steps a chunk, in which only the lagging stages compute: the
//   work is the same.  In a deep cascade the deeper rings leave room only
//   for narrow tiles, so the planner may instead put every stage at level
//   1 with a barrier after each (`sync` "barrier"): shallower rings, wider
//   tiles or more CTAs an SM, the same one wait for the row copies.
// - Row copies one step ahead.  The input rows of step s + 1 are copied
//   while step s computes.  Where the grid's width is a whole number of
//   16-byte chunks (`load` "vector"), a ring row is widened to whole
//   chunks and copied with cp.async.cg 16 bytes at a time, the source size
//   0 outside the grid (the copy fills zeros).  TMA was not taken: a ring
//   row (TX + halo = 258 columns at TX 256) exceeds one box's 256 elements
//   per dimension, and a step copies only RB short rows, which one
//   cp.async per thread covers.  Otherwise ("scalar", e.g. 37 x 45) each
//   thread loads its elements of the rows into registers at the start of
//   the step and stores them to the ring after the stages, before the
//   wait.
// - 32-bit integer carriers where a range analysis proves them exact
//   (backend/cuda_codegen.py::int32_exact): blur's divisions by 3 are
//   32-bit divisions.
//
// Every stage keeps the oracle's zero-fill semantics: an input read
// outside the grid is zero, and so is an intermediate stage's value there,
// so the kernel equals interp/numpy_ref.py on the whole grid.
//
// Built with -DSODA_HOST_EMULATION the same source compiles as host C++
// (soda_common.cuh), one thread per CTA, which is how the CPU tests check
// the march.  The row copies, their emulation and the step's wait are
// async_copy.cuh's: a copy lands at the wait, or with -DSODA_HAZARD at
// issue; under -DSODA_HAZARD the work items of a stage run in reverse
// order too, and so do the stages of a step where no barrier orders them
// ("skew"), so a copy or a stage that overwrites a row still read in the
// step shows as a wrong result.

#pragma once

#include "async_copy.cuh"

// Ring slot of row p in a ring of `depth` rows (a power of two) whose
// first row is `base`; the march never asks for a row below base.
SODA_HD int soda_row(int64_t p, int64_t base, int depth) {
  return (int)((p - base) & (int64_t)(depth - 1));
}

// Vector path: rows [p0, p0 + NROWS) of columns [xs, xs + COLS) of the
// (d0, d1) grid `src` into the ring, 16 bytes (V elements) per cp.async,
// skipping rows below `base`.  xs and d1 are multiples of V, so a chunk
// lies wholly inside or wholly outside the grid; outside, the source size
// is 0 and the copy fills zeros.
template <int NROWS, int COLS, int NT, typename T>
SODA_BODY void soda_fetch_rows_v(T* __restrict__ ring, const T* __restrict__ src,
                                 int64_t p0, int64_t base, int depth, int64_t xs,
                                 int64_t d0, int64_t d1, int tid) {
  constexpr int V = 16 / (int)sizeof(T), CH = COLS / V;
  static_assert(COLS % V == 0, "a vector-copied ring row is whole 16-byte chunks");
  for (int i = tid; i < NROWS * CH; i += NT) {
    const int64_t p = p0 + i / CH, gx = xs + (int64_t)(i % CH) * V;
    if (p < base) continue;
    const bool in = p >= 0 && p < d0 && gx >= 0 && gx < d1;
    soda_copy16(ring + soda_row(p, base, depth) * COLS + (i % CH) * V,
                in ? src + p * d1 + gx : src, in);
  }
  soda_commit();
}

// Scalar path, first half: thread `tid` of NT loads its elements of rows
// [p0, p0 + NROWS) x [xs, xs + COLS) into `v` (zero outside the grid), all
// before the first use, so that they are in flight while the step
// computes.  Under host emulation the copy is issued instead.
template <int NROWS, int COLS, int NT, typename T>
SODA_BODY void soda_fetch_rows_s(T (&v)[soda_per<NROWS, COLS, NT>()], T* __restrict__ ring,
                                 const T* __restrict__ src, int64_t p0, int64_t base,
                                 int depth, int64_t xs, int64_t d0, int64_t d1, int tid) {
  constexpr int TOTAL = NROWS * COLS, PER = soda_per<NROWS, COLS, NT>();
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * NT;
    const int64_t p = p0 + i / COLS, gx = xs + i % COLS;
    const bool in = i < TOTAL && p >= 0 && p < d0 && gx >= 0 && gx < d1;
#ifdef SODA_HOST_EMULATION
    if (i < TOTAL && p >= base)
      soda_issue(ring + soda_row(p, base, depth) * COLS + i % COLS,
                 in ? src + p * d1 + gx : nullptr, (int)sizeof(T));
#else
    (void)ring; (void)base; (void)depth;
    v[k] = in ? src[p * d1 + gx] : T(0);
#endif
  }
}

// Scalar path, second half: the registers into the ring, after the step's
// stages and before its wait.
template <int NROWS, int COLS, int NT, typename T>
SODA_BODY void soda_store_rows_s(T* __restrict__ ring, const T (&v)[soda_per<NROWS, COLS, NT>()],
                                 int64_t p0, int64_t base, int depth, int tid) {
#ifndef SODA_HOST_EMULATION
  constexpr int TOTAL = NROWS * COLS, PER = soda_per<NROWS, COLS, NT>();
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * NT;
    const int64_t p = p0 + i / COLS;
    if (i < TOTAL && p >= base) ring[soda_row(p, base, depth) * COLS + i % COLS] = v[k];
  }
#else
  (void)ring; (void)v; (void)p0; (void)base; (void)depth; (void)tid;
#endif
}
