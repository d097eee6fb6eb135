// linebuffer3d.cuh -- the 3-D line-buffer z-march for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel soda_tpu/backend/_linebuffer.py::
// build_linebuffer_group_fn (both its emit_pipeline and mosaic engines):
// one fused group of a rank-3, single-sweep stencil program over the whole
// grid, and (backend/sweeps.py) the rank-3 cascade of fused iterate
// sweeps.  backend/linebuffer.py generates one kernel per (program, group,
// plan) from the IR; this header holds the march's plane copies (the TMA
// feed and the scalar path), async_copy.cuh the scalar path's copies and
// the step's wait, and soda_common.cuh the C semantics, math overloads and
// `soda_half`.
//
// What computes what.  The TPU kernel walks z in order on one core and
// carries planes from one grid step to the next.  CUDA blocks run in
// parallel and in no order, so a CTA owns a (TY, TX) column tile and a
// chunk of BZ planes, and marches z over its chunk one plane a step, with
// its own warm-up of WARM planes.  Every tensor the group taps at an offset
// (inputs and intermediate stages) has a ring of z-planes of the tile and
// its y/x halo in shared memory.
//
// What bounds it on the H100: device-memory bytes.  jacobi3d does about 8
// operations for every 8 bytes (one f32 read and one f32 write per cell)
// against 3.35 TB/s (in practice 2.99 TB/s: y.copy_(x) at 512^3,
// scripts/torch_copy_ceiling.py); the arithmetic is far from its limit.
// Each input cell is read once per chunk; the y/x halos are read again by
// the neighbouring tiles, in whole 32-byte sectors (at TX 64 a row's two
// halo columns cost 2 sectors beside its 8), and the z halo costs a
// warm-up per chunk.  So the march needs copies in flight while it
// computes, copies that cost its threads nothing, and wide tiles.
//
// The TMA feed (`load` "vector": rows of whole 16-byte chunks on a
// 16-byte-aligned base, the condition TMA's strides and base need):
// - Thread 0 copies each input plane with one instruction: a 3-D tiled
//   tensor map per input (encoded on the host in soda_launch, passed as a
//   __grid_constant__), its box the ring's rows by its columns, whole
//   16-byte chunks from an aligned first column (a box whose first column
//   is not 16-byte aligned faults with an illegal instruction on the
//   H100).  The hardware fills zeros outside the grid at all six faces,
//   negative coordinates included: the oracle's zero fill.  Since one
//   instruction copies a plane whatever its width, the planner also tries
//   tiles of 128 columns (two halo sectors beside 16).
// - Every ring slot has an mbarrier; the copy arrives on it with the
//   box's bytes (expect_tx), and every thread waits on the slot's phase
//   at the step that first reads the plane.  Slots are 128-byte aligned.
// - The planes of step s are copied at step s - AHEAD: a ring holds the
//   planes a step reads plus AHEAD in flight (the planner's AHEAD: the
//   deepest, up to 4, that keeps the CTAs an SM of one step ahead), and a
//   plane's slot is its index from the chunk's first plane modulo the
//   ring's own depth, not a power-of-two mask.
// - One barrier a step, at its start: the slot thread 0 refills then was
//   last read in the step before, and a stage ring written in one step is
//   read in the next.  No thread waits for copies it did not need.
// A CTA a chunk, as on the scalar path: the same march in persistent CTAs
// (one wave, every tile column cut into equal shares, the feed running on
// across a share's end) ran 5-11% slower at every size (PERF.md).
//
// The scalar path (`load` "scalar", e.g. 13 x 37 x 45 or 511^3): each
// thread loads its elements of the next step's plane into registers at
// the start of a step and stores them to the ring after the stages,
// before the step's one wait (plane pl in slot (pl - ZLO) & (D - 1), or % D
// where no power of two fits).
//
// Both paths: a stage at level L (1 + the deepest level it reads in the
// group, inputs level 0) computes the plane of step s - (L - 1) during
// step s (`sync` "skew"), so no stage reads a plane written in the same
// step; or every stage is at level 1 with a barrier after each ("barrier").
// Runs of rows wholly inside the grid skip the per-row zero-fill checks.
// An intermediate stage's value outside the grid is stored as zero -- the
// oracle's zero-fill semantics on the whole grid.  Expressions are
// compiled with --fmad=false and without fast-math: the evaluation order
// of the IR is kept exactly, as docs/SEMANTICS.md promises.
//
// Built with -DSODA_HOST_EMULATION the same source compiles as host C++
// (soda_common.cuh), one thread per CTA: a TMA copy is a queued box copy,
// zero-filled outside the grid, that lands at the wait on its slot, and
// soda_launch fails where the card would fault or hang (a box whose first
// column is not 16-byte aligned, a wait whose phase would not complete, a
// copy never waited for).  -DSODA_HAZARD lands every copy at issue
// (async_copy.cuh) and runs a stage's work items, and the stages of a
// step where no barrier orders them, in reverse, so a copy or a stage that
// overwrites a plane still read in its step shows as a wrong result.

#pragma once

#include "async_copy.cuh"

#ifndef SODA_HOST_EMULATION
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#endif

// ---- the TMA feed ----------------------------------------------------------

#ifdef SODA_HOST_EMULATION
#include <algorithm>
#include <vector>

// A 3-D tiled tensor map as the emulation needs it: the grid, and a box of
// box_r rows by box_c columns of one plane.
struct soda_tmap {
  const unsigned char* base;
  int64_t d0, d1, d2;
  int box_c, box_r, elem;
};
// A box copy issued and not yet landed.
struct soda_box {
  unsigned char* dst;
  const soda_tmap* map;
  uint64_t* bar;
  int x, y, z;
};
inline std::vector<soda_box>& soda_boxes() {
  static std::vector<soda_box> q;
  return q;
}
// set when the emulated march breaks the feed's protocol; soda_launch
// returns it
inline int& soda_emu_fault() {
  static int f = 0;
  return f;
}
// the box copies started and the bytes they move (a box whole, zeros outside
// the grid included), counted from the process's start; read through
// `soda_emu_copies`
inline uint64_t* soda_emu_counts() {
  static uint64_t n[2] = {0, 0};
  return n;
}
extern "C" void soda_emu_copies(uint64_t* out) {
  out[0] = soda_emu_counts()[0];
  out[1] = soda_emu_counts()[1];
}
inline void soda_box_land(const soda_box& b) {
  const soda_tmap& m = *b.map;
  const int row = m.box_c * m.elem;
  for (int r = 0; r < m.box_r; ++r) {
    unsigned char* d = b.dst + (size_t)r * row;
    const int64_t gy = (int64_t)b.y + r;
    for (int c = 0; c < m.box_c; ++c) {
      const int64_t gx = (int64_t)b.x + c;
      const bool in = b.z >= 0 && b.z < m.d0 && gy >= 0 && gy < m.d1 && gx >= 0 && gx < m.d2;
      const int64_t cell = ((int64_t)b.z * m.d1 + gy) * m.d2 + gx;
      if (in) std::memcpy(d + c * m.elem, m.base + cell * m.elem, m.elem);
      else std::memset(d + c * m.elem, 0, m.elem);
    }
  }
  ++*b.bar;  // the emulated mbarrier counts its completed phases
}
#else
typedef CUtensorMap soda_tmap;
#endif

// Encode (on the host) the tensor map of the (d0, d1, d2) grid of
// `elem`-byte cells at `base`, whose box is box_r rows of box_c columns of
// one plane, zeros outside the grid.  0, or a CUDA error code.
inline int soda_tmap_encode(soda_tmap* m, const void* base, int elem, int64_t d0,
                            int64_t d1, int64_t d2, int box_c, int box_r) {
#ifdef SODA_HOST_EMULATION
  *m = soda_tmap{static_cast<const unsigned char*>(base), d0, d1, d2, box_c, box_r, elem};
  return 0;
#else
  typedef CUresult (*encode_t)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                               const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                               const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                               CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static encode_t encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                                  cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return (int)e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<encode_t>(fn);
  }
  // the copy moves bits: an unsigned type of the cell's size; no L2
  // promotion (promoting to 128-byte lines was no faster on the H100 and
  // slower on the mesh cell's shard, PERF.md)
  const CUtensorMapDataType type =
      elem == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
      : elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
      : elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_UINT32 : CU_TENSOR_MAP_DATA_TYPE_UINT64;
  const cuuint64_t dims[3] = {(cuuint64_t)d2, (cuuint64_t)d1, (cuuint64_t)d0};
  const cuuint64_t strides[2] = {(cuuint64_t)(d2 * elem), (cuuint64_t)(d1 * d2 * elem)};
  const cuuint32_t box[3] = {(cuuint32_t)box_c, (cuuint32_t)box_r, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(m, type, 3, const_cast<void*>(base), dims, strides, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_NONE,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
#endif
}

// Thread 0: `n` slot barriers, each completed by one copy; then every
// thread waits at the CTA's barrier before the first use.
SODA_BODY void soda_bar_init(uint64_t* bar, int n, int tid) {
#ifdef SODA_HOST_EMULATION
  (void)tid;
  for (int i = 0; i < n; ++i) bar[i] = 0;
#else
  if (tid == 0) {
    for (int i = 0; i < n; ++i) {
      const unsigned a = (unsigned)__cvta_generic_to_shared(bar + i);
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(a) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
#endif
}

// Thread 0: copy the box at (x, y, z) of map `m` (`bytes`, the whole box,
// zeros outside the grid included) into `dst`; it completes `bar`'s phase.
SODA_BODY void soda_tma_plane(void* dst, const soda_tmap& m, uint64_t* bar, int x, int y,
                              int z, unsigned bytes) {
#ifdef SODA_HOST_EMULATION
  soda_emu_counts()[0] += 1;
  soda_emu_counts()[1] += bytes;
  // the card faults on a box whose first column is not 16-byte aligned
  if ((int64_t)x * m.elem % 16 != 0) soda_emu_fault() = 1;
  const soda_box b{static_cast<unsigned char*>(dst), &m, bar, x, y, z};
#ifdef SODA_HAZARD
  soda_box_land(b);
#else
  soda_boxes().push_back(b);
#endif
#else
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(b), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(d), "l"(reinterpret_cast<uint64_t>(&m)), "r"(b), "r"(x), "r"(y), "r"(z)
      : "memory");
#endif
}

// Every thread: wait until the phase of `bar` with this parity completed
// (its copy has landed).
SODA_BODY void soda_bar_wait(uint64_t* bar, unsigned parity) {
#ifdef SODA_HOST_EMULATION
  std::vector<soda_box>& q = soda_boxes();
  for (const soda_box& b : q)
    if (b.bar == bar) soda_box_land(b);
  q.erase(std::remove_if(q.begin(), q.end(), [bar](const soda_box& b) { return b.bar == bar; }),
          q.end());
  // the card waits until the current phase's parity differs from `parity`
  if ((*bar & 1) == parity) soda_emu_fault() = 1;
#else
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(a), "r"(parity) : "memory");
#endif
}

// A CTA's march ends with every copy waited for (the emulation checks).
SODA_BODY void soda_feed_end() {
#ifdef SODA_HOST_EMULATION
  if (!soda_boxes().empty()) soda_emu_fault() = 1;
  soda_boxes().clear();
#endif
}

// ---- the scalar path --------------------------------------------------------

// First half: thread `tid` of NT loads its elements of the (R x C) window
// of z-plane p whose corner is (ys, xs) into `v` (zero outside the grid),
// all before the first use, so that they are in flight while the step
// computes.  Under host emulation the copy is issued instead.
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

// Second half: the registers into the ring slot, after the step's stages
// and before its wait.
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
