// linebuffer3d.cuh -- the 3-D line-buffer z-march for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel soda_tpu/backend/_linebuffer.py::
// build_linebuffer_group_fn (both its emit_pipeline and mosaic engines):
// one fused group of a rank-3, single-sweep stencil program over the whole
// grid, and (backend/sweeps.py) the rank-3 cascade of fused iterate
// sweeps.  backend/linebuffer.py generates one kernel per (program, group,
// plan) from the IR; this header holds the march's plane copies,
// async_copy.cuh the 16-byte copy and the step's wait, and soda_common.cuh
// the C semantics, math overloads and `soda_half`.
//
// What computes what.  The TPU kernel walks z in order on one core and
// carries planes from one grid step to the next.  CUDA blocks run in
// parallel and in no order, so a CTA owns a (TY, TX) column tile and a
// chunk of BZ planes, and marches z over its chunk one plane a step, with
// its own warm-up.  Every tensor the group taps at an offset (inputs and
// intermediate stages) has a ring of z-planes of the tile and its y/x halo
// in shared memory; plane pl of the chunk sits in slot (pl - ZLO) & (D -
// 1), the depth D a power of two (where no tile fits the powers of two,
// the ring keeps its own depth and the slot is (pl - ZLO) % D).
//
// What bounds it on the H100: device-memory bytes.  jacobi3d does about 8
// operations for every 8 bytes (one f32 read and one f32 write per cell)
// against 3.35 TB/s; the card's arithmetic is far from the limit.  Each
// input cell is read from device memory once per z-chunk; only the y/x
// tile halos are read again, by neighbouring tiles (L2 may absorb those),
// and the z halo costs one warm-up of WARM planes per chunk.  What keeps
// a march from that bound is latency: at four CTAs an SM (registers cap
// them, not shared memory) a march that loads each plane synchronously
// waits one full memory latency a plane with nothing to compute, then
// computes with no load in flight, and meets a CTA-wide barrier after
// every stage.  So, as the row-march (linebuffer2d.cuh):
//
// - Plane copies one step ahead.  The leading plane of every input for
//   step s + 1 is copied while step s computes.  Where the grid's rows are
//   whole 16-byte chunks (`load` "vector"), a ring row is widened to whole
//   chunks from an aligned first column and copied with cp.async.cg 16
//   bytes at a time, the source size 0 outside the grid; otherwise
//   ("scalar", e.g. 13 x 37 x 45) each thread loads its elements of the
//   plane into registers at the start of the step and stores them to the
//   ring after the stages, before the wait.  Rows and chunks advance by
//   the thread count: no division per element.  TMA was not taken: a
//   plane's rows are copied by cp.async as the row-march's are.
// - One wait a step (`sync` "skew").  A stage at level L (1 + the deepest
//   level it reads in the group, inputs level 0) computes the plane of
//   step s - (L - 1) during step s, so no stage reads a plane written in
//   the same step; the stages of a step run one after another in each
//   thread with no barrier between them, and the one wait ends the step.
//   The skew costs deeper rings and DRAIN = deepest level - 1 more steps
//   a chunk, in which only the lagging stages compute.  Where that costs
//   a smaller tile, the planner may instead put every stage at level 1
//   with a barrier after each (`sync` "barrier"): the same one wait for
//   the plane copies.
// - Runs of rows wholly inside the grid skip the per-row zero-fill checks.
//
// No host padding and no rim pass: copies outside the grid fill zeros,
// and an intermediate stage's value outside the grid is stored as zero --
// the oracle's zero-fill semantics on the whole grid.  Expressions are
// compiled with --fmad=false and without fast-math: the evaluation order
// of the IR is kept exactly, as docs/SEMANTICS.md promises.
//
// Built with -DSODA_HOST_EMULATION the same source compiles as host C++
// (soda_common.cuh), one thread per CTA, which is how the CPU tests check
// the march; -DSODA_HAZARD lands a copy at issue (async_copy.cuh) and runs
// a stage's work items, and the stages of a step where no barrier orders
// them, in reverse, so a copy or a stage that overwrites a plane still
// read in its step shows as a wrong result.

#pragma once

#include "async_copy.cuh"

// Vector path: the (R x C) window of z-plane p whose corner is (ys, xs),
// of the (d0, d1, d2) grid `src`, into one ring slot, 16 bytes (V
// elements) per cp.async.  xs and d2 are multiples of V, so a chunk lies
// wholly inside or wholly outside the grid; outside, the source size is 0
// and the copy fills zeros.
template <int R, int C, int NT, typename T>
SODA_BODY void soda_fetch_plane_v(T* __restrict__ slot, const T* __restrict__ src,
                                  int64_t p, int64_t ys, int64_t xs, int64_t d0,
                                  int64_t d1, int64_t d2, int tid) {
  constexpr int V = 16 / (int)sizeof(T), CH = C / V;
  static_assert(C % V == 0, "a vector-copied ring row is whole 16-byte chunks");
  const bool zin = p >= 0 && p < d0;
  const int64_t plane = (zin ? p : 0) * d1;
  int r = tid / CH, c = tid % CH;  // once a call; then by NT
  for (int i = tid; i < R * CH; i += NT) {
    const int64_t gy = ys + r, gx = xs + (int64_t)c * V;
    const bool in = zin && gy >= 0 && gy < d1 && gx >= 0 && gx < d2;
    soda_copy16(slot + i * V, in ? src + (plane + gy) * d2 + gx : src, in);
    r += NT / CH;
    c += NT % CH;
    if (c >= CH) { c -= CH; ++r; }
  }
  soda_commit();
}

// Scalar path, first half: thread `tid` of NT loads its elements of the
// (R x C) window of z-plane p whose corner is (ys, xs) into `v` (zero
// outside the grid), all before the first use, so that they are in flight
// while the step computes.  Under host emulation the copy is issued
// instead.
template <int R, int C, int NT, typename T>
SODA_BODY void soda_fetch_plane_s(T (&v)[soda_per<R, C, NT>()], T* __restrict__ slot,
                                  const T* __restrict__ src, int64_t p, int64_t ys,
                                  int64_t xs, int64_t d0, int64_t d1, int64_t d2,
                                  int tid) {
  constexpr int N = R * C, PER = soda_per<R, C, NT>();
  const bool zin = p >= 0 && p < d0;
  const int64_t plane = (zin ? p : 0) * d1;
  int r = tid / C, c = tid % C;  // once a call; then by NT
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * NT;
    const int64_t gy = ys + r, gx = xs + c;
    const bool in = i < N && zin && gy >= 0 && gy < d1 && gx >= 0 && gx < d2;
#ifdef SODA_HOST_EMULATION
    (void)v;
    if (i < N) soda_issue(slot + i, in ? src + (plane + gy) * d2 + gx : nullptr, (int)sizeof(T));
#else
    (void)slot;
    v[k] = in ? src[(plane + gy) * d2 + gx] : T(0);
#endif
    r += NT / C;
    c += NT % C;
    if (c >= C) { c -= C; ++r; }
  }
}

// Scalar path, second half: the registers into the ring slot, after the
// step's stages and before its wait.
template <int R, int C, int NT, typename T>
SODA_BODY void soda_store_plane_s(T* __restrict__ slot,
                                  const T (&v)[soda_per<R, C, NT>()], int tid) {
#ifndef SODA_HOST_EMULATION
  constexpr int N = R * C, PER = soda_per<R, C, NT>();
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * NT;
    if (i < N) slot[i] = v[k];
  }
#else
  (void)slot; (void)v; (void)tid;
#endif
}
