// async_copy.cuh -- the copies both marches issue a step ahead, and the
// step's one wait.
//
// Kernel 2's row-march (linebuffer2d.cuh) copies the leading rows of every
// input ring for step s + 1 while step s computes, and so does kernel 1's
// z-march (linebuffer3d.cuh) on its scalar path (element loads through
// registers; its TMA feed has mbarriers of its own).  A row-march copy is
// a 16-byte cp.async.cg from device memory into shared memory, its source
// size 0 outside the grid (the copy fills zeros); the step ends with one
// wait (every copy this thread issued has landed) and the CTA's barrier.
//
// Under SODA_HOST_EMULATION (one thread per CTA, soda_common.cuh) a copy
// is queued and lands at the step's wait, the latest it can on the card,
// so a read before the wait sees the stale slot.  With SODA_HAZARD too it
// lands at issue, the earliest, so a copy that overwrites a slot still
// read in its step shows as a wrong result.

#pragma once

#include "soda_common.cuh"

#ifdef SODA_HOST_EMULATION
#include <cstring>
#include <vector>

// Copies issued and not yet landed (one CTA at a time runs on the host).
struct soda_copy {
  unsigned char* dst;
  const unsigned char* src;  // nullptr: zero fill
  int bytes;
};
inline std::vector<soda_copy>& soda_pending() {
  static std::vector<soda_copy> q;
  return q;
}
inline void soda_land(const soda_copy& c) {
  if (c.src) std::memcpy(c.dst, c.src, c.bytes);
  else std::memset(c.dst, 0, c.bytes);
}
inline void soda_issue(void* dst, const void* src, int bytes) {
  const soda_copy c{static_cast<unsigned char*>(dst),
                    static_cast<const unsigned char*>(src), bytes};
#ifdef SODA_HAZARD
  soda_land(c);
#else
  soda_pending().push_back(c);
#endif
}
#endif

// Elements of a scalar copy of NROWS x COLS (rows, or a plane's rows) each
// of NT threads holds in registers.
template <int NROWS, int COLS, int NT>
SODA_HD constexpr int soda_per() { return (NROWS * COLS + NT - 1) / NT; }

// A CTA's march starts with no copy in flight.
SODA_BODY void soda_cta_begin() {
#ifdef SODA_HOST_EMULATION
  soda_pending().clear();
#endif
}

// One 16-byte copy into shared memory: from `src` where `in`, else zeros
// (source size 0; `src` must still be a valid address).
SODA_BODY void soda_copy16(void* dst, const void* src, bool in) {
#ifdef SODA_HOST_EMULATION
  soda_issue(dst, in ? src : nullptr, 16);
#else
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(in ? 16 : 0) : "memory");
#endif
}

// Close the group of copies this thread issued since the last commit.
SODA_BODY void soda_commit() {
#ifndef SODA_HOST_EMULATION
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// The step's one wait: every copy this thread issued has landed, then the
// CTA's barrier makes every thread's copies and ring stores visible.
SODA_BODY void soda_step_wait() {
#ifdef SODA_HOST_EMULATION
  for (const soda_copy& c : soda_pending()) soda_land(c);
  soda_pending().clear();
#else
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
#endif
}
