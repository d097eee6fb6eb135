// soda_common.cuh -- what every generated line-buffer kernel shares.
//
// The C semantics helpers of the golden runner (soda_tpu/backend/cpp.py
// _HEADER) as __host__ __device__ functions, the math overloads the
// generated expressions call (dm::), and the `soda_half` type.  Included
// by async_copy.cuh (which both marches, kernels 1 and 2, include) and by
// windows.cuh (kernel 4).
//
// Built with -DSODA_HOST_EMULATION the same source compiles as host C++:
// every CTA runs on one thread (tid 0 of 1), so each phase between two
// barriers runs whole before the next, which is what the barrier
// guarantees on the card.  The CPU tests use that to check the march.

#pragma once

#include <cmath>
#include <cstddef>
#include <cstdint>

// SODA_HD: arithmetic shared by host and device code.  SODA_BODY: the
// per-CTA march, which synchronizes the block and so is device-only.
#ifdef SODA_HOST_EMULATION
#define SODA_HD inline
#define SODA_BODY inline
#define SODA_SYNC() ((void)0)
#else
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#define SODA_HD __host__ __device__ __forceinline__
#define SODA_BODY __device__ __forceinline__
#define SODA_SYNC() __syncthreads()
#endif

// ---- C semantics of the DSL (as in the C++ golden runner) ------------------

SODA_HD int64_t mask_int(int64_t v, int width, bool is_signed) {
  if (width >= 64) return v;
  uint64_t m = (uint64_t(1) << width) - 1;
  uint64_t u = uint64_t(v) & m;
  if (is_signed) {
    uint64_t sign = uint64_t(1) << (width - 1);
    if (u & sign) return int64_t(u) - (int64_t(1) << width);
  }
  return int64_t(u);
}
// mask_int on a 32-bit carrier (a stage whose every integer node the range
// analysis, backend/cuda_codegen.py::int32_exact, proves to lie in int32):
// the same value as mask_int of the same value carried in 64 bits.
SODA_HD int32_t mask_int32(int32_t v, int width, bool is_signed) {
  if (width >= 32) return v;
  const uint32_t m = (uint32_t(1) << width) - 1, u = uint32_t(v) & m;
  if (is_signed && ((u >> (width - 1)) & 1u)) return int32_t(u | ~m);
  return int32_t(u);
}
template <typename T> SODA_HD T c_div(T a, T b) { return a / b; }  // C trunc
template <typename T> SODA_HD T c_mod(T a, T b) { return a % b; }
template <typename T> SODA_HD T c_abs(T a) { return a < 0 ? T(-a) : a; }

// ---- half ---------------------------------------------------------------------
//
// The golden runner carries `half` as _Float16 and casts after every
// operation, so each operation rounds to half as numpy's float16 does.
// The device has no _Float16: soda_half stores an IEEE half (__half) and
// converts through float for every operation (`operator float`), the
// generated code casting the result back.  A single correctly rounded
// float operation on two halves, rounded again to half, equals the
// correctly rounded half operation (24 >= 2 * 11 + 2), which is what
// numpy computes.  Conversions from double and integers go through
// double (__double2half, round to nearest even).
#ifdef SODA_HOST_EMULATION
typedef _Float16 soda_half;
#else
struct soda_half {
  __half h;
  soda_half() = default;
  SODA_HD soda_half(float f) : h(__float2half_rn(f)) {}
  template <typename T>
  SODA_HD soda_half(T v) : h(__double2half(static_cast<double>(v))) {}
  SODA_HD operator float() const { return __half2float(h); }
};
static_assert(sizeof(soda_half) == 2, "soda_half must be stored in 2 bytes");
#endif

// The golden runner's std:: calls, as overloads that device code can call:
// the emitted expressions say dm::sqrt(x) where the runner says
// std::sqrt(x), and overload resolution picks the float or double function
// exactly as it does for std::.  A `half` operand reaches only abs and
// fmod (`%` on half): the codegen casts it to float for every other call,
// and min/max name their type.  Those two take soda_half by an overload of
// their own, an exact match in both builds: under SODA_HOST_EMULATION
// _Float16 converts to every other overload at one rank (ambiguous), and
// on the card the struct would reach abs(float) through operator float.
// Both are exact in half: |x|, and fmod's remainder, which is
// representable in its operands' format, computed in float.
namespace dm {
template <typename T> SODA_HD T min(T a, T b) { return (b < a) ? b : a; }
template <typename T> SODA_HD T max(T a, T b) { return (a < b) ? b : a; }
SODA_HD int64_t abs(int64_t a) { return c_abs(a); }
SODA_HD int32_t abs(int32_t a) { return c_abs(a); }
SODA_HD float abs(float a) { return ::fabsf(a); }
SODA_HD double abs(double a) { return ::fabs(a); }
SODA_HD soda_half abs(soda_half a) { return soda_half(::fabsf(float(a))); }
SODA_HD soda_half fmod(soda_half a, soda_half b) {
  return soda_half(::fmodf(float(a), float(b)));
}
#define SODA_MATH1(fn)                                  \
  SODA_HD float fn(float a) { return ::fn##f(a); }      \
  SODA_HD double fn(double a) { return ::fn(a); }
#define SODA_MATH2(fn)                                           \
  SODA_HD float fn(float a, float b) { return ::fn##f(a, b); }   \
  SODA_HD double fn(double a, double b) { return ::fn(a, b); }
SODA_MATH1(sqrt) SODA_MATH1(exp) SODA_MATH1(exp2) SODA_MATH1(log)
SODA_MATH1(log2) SODA_MATH1(log10) SODA_MATH1(sin) SODA_MATH1(cos)
SODA_MATH1(tan) SODA_MATH1(tanh) SODA_MATH1(floor) SODA_MATH1(ceil)
SODA_MATH1(fabs) SODA_MATH1(round) SODA_MATH1(trunc) SODA_MATH1(atan)
SODA_MATH1(asin) SODA_MATH1(acos) SODA_MATH1(sinh) SODA_MATH1(cosh)
SODA_MATH1(expm1) SODA_MATH1(log1p)
SODA_MATH2(pow) SODA_MATH2(atan2) SODA_MATH2(copysign) SODA_MATH2(hypot)
SODA_MATH2(fmod)
#undef SODA_MATH1
#undef SODA_MATH2
}  // namespace dm
