// linebuffer2d.cuh -- the 2-D line-buffer row-march for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel soda_tpu/backend/_linebuffer.py::
// build_linebuffer2d_group_fn (both its emit_pipeline and mosaic engines):
// one fused group of a rank-2, single-sweep stencil program over the whole
// (H, W) grid.  backend/linebuffer2d.py generates one kernel per (program,
// group, plan) from the IR; this header holds the march's row loader, and
// soda_common.cuh the C semantics, math overloads and `soda_half`.
//
// What computes what.  The TPU kernel walks row blocks in order on one
// core and carries the last rows of every input from one grid step to the
// next, with a look-ahead of the next block's first rows.  CUDA blocks run
// in parallel and in no order, so nothing carries between them: a CTA
// owns a strip of TX columns and a chunk of BY rows, and marches the rows
// of its chunk RB at a time, with its own warm-up of ceil(span / RB) steps.
// Every tensor the group taps at a row offset (inputs and intermediate
// stages) has a ring of rows in shared memory, each row TX + x halo wide;
// the ring's depth is a power of two of at least (row span + RB), so a
// row's slot is (row - base) & (depth - 1) and a step's new rows never
// overwrite a row that the step still reads.
//
// What bounds it on the H100: device-memory bytes.  blur does about a
// dozen integer operations for every 4 bytes (a uint16 read and a uint16
// write per cell) against 3.35 TB/s.  Every input cell is read from device
// memory once per chunk; only the x halo of each strip is read twice, by
// the neighbouring strip, and the warm-up rows once more per chunk.  No
// host padding and no rim pass: loads outside the grid fill zeros, and an
// intermediate stage's value outside the grid is stored as zero -- the
// oracle's zero-fill semantics on the whole grid, for every grid shape.
//
// A simple kernel first: plain loads (no cp.async, no TMA) and a barrier
// after each phase of a step.  The loader issues all of a thread's loads
// of a step before it stores any, so that several loads are in flight per
// thread (2-byte elements move little per load).  The generated stages
// compute in column runs: a thread takes a column and several rows of
// the step, loads each tap of the run from the ring into a register once
// and computes the rows with 32-bit index arithmetic, which cuts the
// shared-memory loads and index instructions per cell that bound the
// march (backend/linebuffer2d.py).  The same march runs the cascades of
// fused iterate sweeps (backend/sweeps.py), one ring per sweep copy.
//
// Built with -DSODA_HOST_EMULATION the same source compiles as host C++
// (soda_common.cuh), which is how the CPU tests check the march.

#pragma once

#include "soda_common.cuh"

// Ring slot of row p in a ring of `depth` rows (a power of two) whose
// first row is `base`; the march never asks for a row below base.
SODA_HD int soda_row(int64_t p, int64_t base, int depth) {
  return (int)((p - base) & (int64_t)(depth - 1));
}

// Load rows [p0, p0 + NROWS) of columns [xs, xs + COLS) of the (d0, d1)
// grid `src` into the ring, skipping rows below `base` (the chunk's
// warm-up needs none of them), with zero outside the grid.  Thread `tid`
// of NT takes every NT-th element: all its loads are issued into
// registers before the first store to shared memory, so each thread keeps
// (NROWS * COLS / NT) loads in flight instead of one.  Index arithmetic is
// 64-bit.
template <int NROWS, int COLS, int NT, typename T>
SODA_HD void soda_load_rows(T* __restrict__ ring, const T* __restrict__ src,
                            int64_t p0, int64_t base, int depth, int64_t xs,
                            int64_t d0, int64_t d1, int tid) {
  constexpr int TOTAL = NROWS * COLS, PER = (TOTAL + NT - 1) / NT;
  T v[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * NT;
    const int64_t p = p0 + i / COLS, gx = xs + i % COLS;
    v[k] = T(0);
    if (i < TOTAL && p >= base && p >= 0 && p < d0 && gx >= 0 && gx < d1)
      v[k] = src[p * d1 + gx];
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * NT;
    const int64_t p = p0 + i / COLS;
    if (i < TOTAL && p >= base) ring[soda_row(p, base, depth) * COLS + i % COLS] = v[k];
  }
}
