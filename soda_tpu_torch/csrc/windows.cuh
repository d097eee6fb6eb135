// windows.cuh -- the windows kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel soda_tpu/backend/pallas.py::build_group_fn, its
// windows branch (kernel body _build_kernel, host padding _pad_input, and
// rank 1 lifted to (1, X) by _lift_rank1): any fused group of a rank-1, -2
// or -3 single-sweep stencil program, evaluated block by block over
// (block + halo) windows.  backend/windows.py generates one kernel per
// (program, group, plan) from the IR; this header holds the window loader
// and the read-only load, and soda_common.cuh the C semantics, math
// overloads and `soda_half`.
//
// What computes what.  The TPU kernel pads every input on the host (a
// padded copy in device memory), then each grid step reads an Element-
// indexed (block + halo) window of it spanning the whole last axis, and
// evaluates the group's stages at their exact extents in VMEM.  On the
// card a CTA owns one block of every axis, the last one tiled too (BX
// cells; BY x BX; BZ x BY x BX), and marches nothing:
//   1. each windowed input: the block plus the input's span is loaded into
//      shared memory, masked, zero outside the grid (soda_load_window) --
//      no padded copy is ever made;
//   2. each stage that another stage of the group reads: computed over its
//      exact extent (block + its span) into shared memory, zero outside
//      the grid, as the oracle's intermediates are;
//   3. the other outputs: computed over the block, straight to device
//      memory.
// A barrier separates the phases.  An input whose window does not fit the
// shared-memory budget is read tap by tap from device memory instead
// (soda_ldg, through the read-only cache; bounds-checked unless the CTA's
// whole window of it lies in the grid), so no stage is ever refused for
// its radius.  A CTA holds the whole window at once, so the TPU's megabytes
// of VMEM become the planner's choice of which inputs to window.
//
// What bounds it on the H100: device-memory bytes for the programs it
// exists for (smooth1d reads and writes 4 B per cell against 5 adds and a
// multiply); each window re-reads its halo, which the neighbouring blocks
// also read (L2 may absorb it).  An input read tap by tap costs a load
// instruction per tap through L1 and L2: the radius-8 f64 star's 49 taps a
// cell run far above its bound (PERF.md).  Deep blocks walked plane by
// plane (a CTA's threads on one plane, so the planes the taps reach stay
// in L1 from one plane to the next) narrow that gap but do not close it.
// A simple kernel first: plain masked loads in batches (several in flight
// per thread), no TMA, no warp-shuffle taps.  Index arithmetic into device
// memory is 64-bit (a rank-1 grid may exceed 2^31 cells); inside the block
// it is 32-bit.
//
// Built with -DSODA_HOST_EMULATION the same source compiles as host C++
// (soda_common.cuh), which is how the CPU tests check the kernel.

#pragma once

#include <cstring>

#include "soda_common.cuh"

// One element through the read-only data cache (__ldg) by its bits: the
// overloads of __ldg cover the unsigned integer types, which carry every
// storage type (soda_half included) bit for bit.
template <typename T>
SODA_HD T soda_ldg(const T* p) {
#ifdef __CUDA_ARCH__
  static_assert(sizeof(T) == 1 || sizeof(T) == 2 || sizeof(T) == 4 || sizeof(T) == 8,
                "soda_ldg: 1, 2, 4 or 8 bytes");
  T v;
  if constexpr (sizeof(T) == 8) {
    const unsigned long long b = __ldg(reinterpret_cast<const unsigned long long*>(p));
    memcpy(&v, &b, 8);
  } else if constexpr (sizeof(T) == 4) {
    const unsigned int b = __ldg(reinterpret_cast<const unsigned int*>(p));
    memcpy(&v, &b, 4);
  } else if constexpr (sizeof(T) == 2) {
    const unsigned short b = __ldg(reinterpret_cast<const unsigned short*>(p));
    memcpy(&v, &b, 2);
  } else {
    const unsigned char b = __ldg(reinterpret_cast<const unsigned char*>(p));
    memcpy(&v, &b, 1);
  }
  return v;
#else
  return *p;
#endif
}

// The value of the (D0, D1, D2) grid `src` at (g0, g1, g2), zero outside
// it: the window loader's masked read.  A rank-1 or rank-2 grid has unit
// leading dims.
template <typename T>
SODA_HD T soda_tap(const T* __restrict__ src, int64_t g0, int64_t g1, int64_t g2,
                   int64_t D0, int64_t D1, int64_t D2) {
  if (g0 >= 0 && g0 < D0 && g1 >= 0 && g1 < D1 && g2 >= 0 && g2 < D2)
    return soda_ldg(src + (g0 * D1 + g1) * D2 + g2);
  return T(0);
}

// Load the (E0, E1, E2) window of the (D0, D1, D2) grid `src` whose corner
// is (o0, o1, o2) into shared memory, row-major, zero outside the grid.
// Thread `tid` of NT takes every NT-th element and issues BATCH loads into
// registers before it stores any, so that several loads are in flight per
// thread.
template <int E0, int E1, int E2, int NT, typename T>
SODA_HD void soda_load_window(T* __restrict__ dst, const T* __restrict__ src,
                              int64_t o0, int64_t o1, int64_t o2, int64_t D0,
                              int64_t D1, int64_t D2, int tid) {
  constexpr int TOTAL = E0 * E1 * E2, BATCH = 8;
  for (int base = tid; base < TOTAL; base += NT * BATCH) {
    T v[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = base + k * NT;
      v[k] = T(0);
      if (i < TOTAL) {
        const int c = i % E2, r = i / E2;
        v[k] = soda_tap(src, o0 + r / E1, o1 + r % E1, o2 + c, D0, D1, D2);
      }
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = base + k * NT;
      if (i < TOTAL) dst[i] = v[k];
    }
  }
}
