// Merge-path building blocks shared by the rank kernel (K2) and the merge
// kernel (K3): a slice of a row staged in shared memory by 16-byte
// cp.async copies, a staged slice stored back by 16-byte stores, and the
// warp-cooperative search of a merge path's diagonal split.
//
// A slice starts anywhere in its row, so its shared-memory copy is placed
// at the same offset within a 16-byte line as its address in device
// memory: the whole lines then move 16 bytes a thread, and only the few
// elements before the first whole line and after the last one move alone.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

__host__ __device__ __forceinline__ int round16(int bytes) { return (bytes + 15) & ~15; }
__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

__device__ __forceinline__ unsigned char* align16(const void* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 15) & ~uintptr_t{15});
}

// Where in the 16-byte aligned buffer `buf` a copy of the slice at `g`
// starts; the buffer needs 15 bytes beyond the slice.
template <class T>
__device__ __forceinline__ T* placed(unsigned char* buf, const void* g) {
  return reinterpret_cast<T*>(buf + (reinterpret_cast<uintptr_t>(g) & 15));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// Waits for the calling thread's cp.async copies; a __syncthreads() must
// follow before other threads read them.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Elements of a slice at `g` before its first whole 16-byte line, and the
// number of whole lines in n elements.
template <class T>
__device__ __forceinline__ void lines_of(const void* g, int n, int& head, int& lines) {
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
  head = min(n, ((16 - off) & 15) / static_cast<int>(sizeof(T)));
  lines = (n - head) / static_cast<int>(16 / sizeof(T));
}

// Copies src[0, n) into the buffer `buf` (16-byte aligned, n * sizeof(T) +
// 15 bytes) and returns where the copy starts. Every thread of the block
// calls it; then cp_async_wait_all() and __syncthreads().
template <class T>
__device__ __forceinline__ T* stage(unsigned char* buf, const T* src, int n) {
  constexpr int kPer = 16 / sizeof(T);
  T* s = placed<T>(buf, src);
  int head, lines;
  lines_of<T>(src, n, head, lines);
  for (int k = threadIdx.x; k < head; k += blockDim.x) s[k] = src[k];
  for (int k = threadIdx.x; k < lines; k += blockDim.x)
    cp_async16(s + head + k * kPer, src + head + k * kPer);
  for (int k = head + lines * kPer + threadIdx.x; k < n; k += blockDim.x) s[k] = src[k];
  return s;
}

// Writes s[0, n) to dst[0, n), where s = placed<T>(buf, dst). Every thread
// of the block calls it, after a __syncthreads() that follows the writes
// to s.
template <class T>
__device__ __forceinline__ void store(T* dst, const T* s, int n) {
  constexpr int kPer = 16 / sizeof(T);
  int head, lines;
  lines_of<T>(dst, n, head, lines);
  for (int k = threadIdx.x; k < head; k += blockDim.x) dst[k] = s[k];
  for (int k = threadIdx.x; k < lines; k += blockDim.x)
    reinterpret_cast<int4*>(dst + head)[k] = reinterpret_cast<const int4*>(s + head)[k];
  for (int k = head + lines * kPer + threadIdx.x; k < n; k += blockDim.x) dst[k] = s[k];
}

// The least i in [lo, hi) with !pred(i), or hi, where pred holds on a
// prefix of [lo, hi). The 32 lanes of the calling warp probe 32 points at
// once, so each step cuts a range of m to under m / 32 + 1: about 4 steps
// for the 158 016 diagonals of a 79 008-wide merge, against 17 dependent
// loads of a binary search. Every lane calls it and gets the answer.
template <class Pred>
__device__ __forceinline__ int64_t warp_search(int64_t lo, int64_t hi, Pred pred) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) >> 5;
    const int64_t i = lo + lane * step;
    const int t = __popc(__ballot_sync(0xffffffffu, i < hi && pred(i)));
    if (t == 0) break;  // pred(lo) fails
    hi = min64(hi, lo + t * step);
    lo += (t - 1) * step + 1;
  }
  return lo;
}

}  // namespace repro
