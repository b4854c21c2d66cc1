// A CPU stand-in for the parts of the CUDA runtime that csrc/bitonic_sort.cu
// uses, so that its kernels can be compiled by a host C++20 compiler and
// run on the CPU in the tests: one OS thread per CUDA thread, a
// std::barrier per block for __syncthreads and one per warp for
// __shfl_xor_sync. Blocks run one after another. The test rewrites the
// source's dynamic shared-memory declaration to read `emu_smem` and each
// `kernel<<<grid, block, smem, stream>>>(args)` to
// `emu_launch(kernel, grid, block, smem, stream, args)`.
#pragma once

#include <barrier>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
};
inline thread_local dim3 threadIdx, blockIdx;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
cudaError_t cudaFuncSetAttribute(F*, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

struct EmuWarp {
  uint64_t slot[32];
  std::unique_ptr<std::barrier<>> bar;
};
inline thread_local EmuWarp* emu_warp;
inline std::barrier<>* emu_block_barrier;
inline unsigned char* emu_smem;

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }

template <class U>
U __shfl_xor_sync(unsigned, U v, int mask) {
  EmuWarp& w = *emu_warp;
  const unsigned lane = threadIdx.x & 31;
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(U));
  w.slot[lane] = bits;
  w.bar->arrive_and_wait();
  const uint64_t got = w.slot[lane ^ mask];
  w.bar->arrive_and_wait();
  U r;
  std::memcpy(&r, &got, sizeof(U));
  return r;
}

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}

template <class Kernel, class... Args>
void emu_launch(Kernel kernel, unsigned grid, unsigned block, size_t smem, cudaStream_t,
                Args... args) {
  for (unsigned b = 0; b < grid; ++b) {
    std::vector<unsigned char> shared(smem + 16);
    emu_smem = shared.data();
    std::barrier<> block_barrier(block);
    emu_block_barrier = &block_barrier;
    std::vector<EmuWarp> warps((block + 31) / 32);
    for (auto& w : warps) w.bar = std::make_unique<std::barrier<>>(block < 32 ? block : 32);
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block; ++t) {
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        emu_warp = &warps[t / 32];
        kernel(args...);
      });
    }
    for (auto& th : threads) th.join();
  }
}
