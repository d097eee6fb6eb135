// linebuffer3d.cuh -- the 3-D line-buffer z-march for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel soda_tpu/backend/_linebuffer.py::
// build_linebuffer_group_fn (both its emit_pipeline and mosaic engines):
// one fused group of a rank-3, single-sweep stencil program over the whole
// grid.  backend/linebuffer.py generates one kernel per (program, group,
// plan) from the IR; this header holds the march's plane loader, and
// soda_common.cuh the C semantics, math overloads and `soda_half` that
// every generated kernel shares.
//
// What bounds it on the H100: device-memory bytes.  jacobi3d does about 8
// flops for every 8 bytes (one f32 read and one f32 write per cell) against
// 3.35 TB/s; the card's arithmetic is far from the limit.  The design
// therefore reads every input cell from device memory once per z-chunk:
// a CTA owns a (TY, TX) column tile and marches z over its chunk, keeping
// a ring of z-planes in shared memory for every tensor the group taps at
// an offset (inputs and intermediate stages).  Only the y/x tile halos are
// read twice, by neighbouring tiles, and L2 may absorb those; the z halo
// costs one warm-up of (span) planes per chunk.  No host padding and no
// rim pass: loads outside the grid fill zeros, and an intermediate stage's
// value outside the grid is stored as zero -- the oracle's zero-fill
// semantics on the whole grid.
//
// Expressions are compiled with --fmad=false and without fast-math: the
// evaluation order of the IR is kept exactly, as docs/SEMANTICS.md promises.
//
// Built with -DSODA_HOST_EMULATION the same source compiles as host C++
// (soda_common.cuh), which is how the CPU tests check the march.

#pragma once

#include "soda_common.cuh"

// ---- the march --------------------------------------------------------------

// Ring slot of z-plane p for a ring whose first plane is `base`; the march
// never asks for a plane below base.
SODA_HD int soda_slot(int64_t p, int64_t base, int depth) {
  return (int)((p - base) % depth);
}

// Load the (rows x cols) window of z-plane p whose corner is (ys, xs) into
// a ring slot, with zero outside the (d0, d1, d2) grid.  Index arithmetic
// is 64-bit: a 1024^3 f32 array is 4 GiB.
template <typename T>
SODA_HD void soda_load_plane(T* __restrict__ dst, const T* __restrict__ src,
                             int64_t p, int64_t ys, int64_t xs, int rows,
                             int cols, int64_t d0, int64_t d1, int64_t d2,
                             int tid, int nt) {
  const bool zin = p >= 0 && p < d0;
  for (int i = tid; i < rows * cols; i += nt) {
    const int64_t gy = ys + i / cols, gx = xs + i % cols;
    T v = T(0);
    if (zin && gy >= 0 && gy < d1 && gx >= 0 && gx < d2)
      v = src[(p * d1 + gy) * d2 + gx];
    dst[i] = v;
  }
}
