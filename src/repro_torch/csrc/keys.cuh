// Key types of the kernels, and how each compares.
//
// Every kernel compares keys as the JAX package's TPU kernel does: `<` and
// `==` on the key type, so for floats NaN compares false with everything
// and -0.0 equals +0.0 (bfloat16 is widened to float first, which is exact).
// `order` is the other comparison the JAX package uses: its sort
// comparator (jnp.searchsorted, lax.sort), under which -0.0 == +0.0 and
// every NaN is equal and above +inf; it maps a key to an int32 of that
// order.
//
// Dtype codes (shared with kernels/_build.py): 0 int32, 1 float32,
// 2 uint32, 3 bfloat16, 4 int64.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ int32_t float_order(float f) {
  int32_t b = (f == 0.0f) ? 0 : __float_as_int(f);  // -0.0 -> +0.0
  if (f != f) b = 0x7fc00000;                         // every NaN -> one NaN
  return b ^ ((b >> 31) & 0x7fffffff);
}

struct KeyI32 {
  using T = int32_t;
  static __device__ __forceinline__ bool lt(T a, T b) { return a < b; }
  static __device__ __forceinline__ bool eq(T a, T b) { return a == b; }
  static __device__ __forceinline__ bool isnan(T) { return false; }
  static __device__ __forceinline__ T sentinel() { return 0x7fffffff; }
  static __device__ __forceinline__ int32_t order(T a) { return a; }
};

// int64: the segmented sort's (segment, key) composites and 64-bit keys.
// No `order`: only the float routes replay the JAX comparator.
struct KeyI64 {
  using T = int64_t;
  static __device__ __forceinline__ bool lt(T a, T b) { return a < b; }
  static __device__ __forceinline__ bool eq(T a, T b) { return a == b; }
  static __device__ __forceinline__ bool isnan(T) { return false; }
  static __device__ __forceinline__ T sentinel() { return 0x7fffffffffffffffLL; }
};

struct KeyU32 {
  using T = uint32_t;
  static __device__ __forceinline__ bool lt(T a, T b) { return a < b; }
  static __device__ __forceinline__ bool eq(T a, T b) { return a == b; }
  static __device__ __forceinline__ bool isnan(T) { return false; }
  static __device__ __forceinline__ T sentinel() { return 0xffffffffu; }
  static __device__ __forceinline__ int32_t order(T a) {
    return static_cast<int32_t>(a ^ 0x80000000u);
  }
};

struct KeyF32 {
  using T = float;
  static __device__ __forceinline__ bool lt(T a, T b) { return a < b; }
  static __device__ __forceinline__ bool eq(T a, T b) { return a == b; }
  static __device__ __forceinline__ bool isnan(T a) { return a != a; }
  static __device__ __forceinline__ T sentinel() { return CUDART_INF_F; }
  static __device__ __forceinline__ int32_t order(T a) { return float_order(a); }
};

// bfloat16 held as its 16 bits; compared as the float it widens to.
struct KeyBF16 {
  using T = uint16_t;
  static __device__ __forceinline__ float f(T a) {
    return __uint_as_float(static_cast<uint32_t>(a) << 16);
  }
  static __device__ __forceinline__ bool lt(T a, T b) { return f(a) < f(b); }
  static __device__ __forceinline__ bool eq(T a, T b) { return f(a) == f(b); }
  static __device__ __forceinline__ bool isnan(T a) { return f(a) != f(a); }
  static __device__ __forceinline__ T sentinel() { return 0x7f80; }  // +inf
  static __device__ __forceinline__ int32_t order(T a) { return float_order(f(a)); }
};

}  // namespace repro
