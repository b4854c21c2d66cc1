// A CPU stand-in for the parts of the CUDA runtime that csrc/bitonic_sort.cu
// and csrc/merge_path.cu use, so that their kernels can be compiled by a
// host C++20 compiler and run on the CPU in the tests: every CUDA thread of a
// block is a fiber (its own stack, ucontext) of one OS thread, run in turn
// until it waits at a barrier, one barrier per block for __syncthreads and one
// per warp for __shfl_xor_sync and __ballot_sync. Blocks run one after
// another. One OS thread a block keeps a run's time its own: OS threads
// spinning at barriers slowed tenfold on a loaded host. The
// tests rewrite a source's dynamic shared-memory declaration to read
// `emu_smem`, each `kernel<<<grid, block, smem, stream>>>(args)` to
// `emu_launch(kernel, grid, block, smem, stream, args)`, and the cp.async
// instructions to `emu_cp_async16` (a plain 16-byte copy, done at once)
// and `emu_cp_async_wait` (nothing left to wait for).
#pragma once

#include <ucontext.h>

#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
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
inline dim3 threadIdx, blockIdx, blockDim, gridDim;
struct alignas(16) int4 {
  int x, y, z, w;
};

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
template <class F>
cudaError_t cudaFuncSetAttribute(F*, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* device) {
  *device = 0;
  return cudaSuccess;
}
// One SM that holds one CTA, so a kernel that walks its work with a grid
// sized to the card walks all of it here.
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = 1;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, F*, int, size_t) {
  *blocks = 1;
  return cudaSuccess;
}

// The fibers of the running block, the scheduler's context and the fiber
// that runs now.
struct EmuFiber {
  ucontext_t ctx;
  std::unique_ptr<char[]> stack;
  bool done = false;
};
inline ucontext_t emu_scheduler;
inline std::vector<EmuFiber>* emu_fibers;
inline unsigned emu_current;
inline const std::function<void()>* emu_body;

inline void emu_yield() { swapcontext(&(*emu_fibers)[emu_current].ctx, &emu_scheduler); }

// A barrier of `expected` fibers: the last to arrive opens it and goes on,
// the others yield until it has opened.
struct EmuBarrier {
  unsigned expected = 0, count = 0;
  uint64_t generation = 0;
  void arrive_and_wait() {
    const uint64_t g = generation;
    if (++count == expected) {
      count = 0;
      ++generation;
      return;
    }
    while (generation == g) emu_yield();
  }
};

struct EmuWarp {
  uint64_t slot[32];
  EmuBarrier bar;
};
inline EmuWarp* emu_warp;
inline EmuBarrier* emu_block_barrier;
inline unsigned char* emu_smem;

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }

// Shared memory addresses are offsets into the block's buffer.
inline size_t __cvta_generic_to_shared(const void* p) {
  return static_cast<size_t>(static_cast<const unsigned char*>(p) - emu_smem);
}
inline void emu_cp_async16(unsigned shared, const void* global) {
  std::memcpy(emu_smem + shared, global, 16);
}
inline void emu_cp_async_wait() {}

inline unsigned __ballot_sync(unsigned, int pred) {
  EmuWarp& w = *emu_warp;
  const unsigned lane = threadIdx.x & 31;
  const unsigned lanes = blockDim.x - (threadIdx.x & ~31u) < 32 ? blockDim.x - (threadIdx.x & ~31u) : 32;
  w.slot[lane] = pred != 0;
  w.bar.arrive_and_wait();
  unsigned mask = 0;
  for (unsigned l = 0; l < lanes; ++l) mask |= static_cast<unsigned>(w.slot[l]) << l;
  w.bar.arrive_and_wait();
  return mask;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }

template <class U>
U __shfl_xor_sync(unsigned, U v, int mask) {
  EmuWarp& w = *emu_warp;
  const unsigned lane = threadIdx.x & 31;
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(U));
  w.slot[lane] = bits;
  w.bar.arrive_and_wait();
  const uint64_t got = w.slot[lane ^ mask];
  w.bar.arrive_and_wait();
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
inline int32_t __float_as_int(float f) { return static_cast<int32_t>(__float_as_uint(f)); }

inline void emu_fiber_entry() {
  (*emu_body)();
  (*emu_fibers)[emu_current].done = true;
}

template <class Kernel, class... Args>
void emu_launch(Kernel kernel, unsigned grid, unsigned block, size_t smem, cudaStream_t,
                Args... args) {
  constexpr size_t kStack = 256 * 1024;
  const std::function<void()> body = [&] { kernel(args...); };
  for (unsigned b = 0; b < grid; ++b) {
    std::vector<unsigned char> shared(smem + 16);
    emu_smem = shared.data();
    EmuBarrier block_barrier;
    block_barrier.expected = block;
    emu_block_barrier = &block_barrier;
    std::vector<EmuWarp> warps((block + 31) / 32);
    for (unsigned w = 0; w < warps.size(); ++w)
      warps[w].bar.expected = block - 32 * w < 32 ? block - 32 * w : 32;
    std::vector<EmuFiber> fibers(block);
    for (auto& f : fibers) {
      f.stack.reset(new char[kStack]);
      getcontext(&f.ctx);
      f.ctx.uc_stack.ss_sp = f.stack.get();
      f.ctx.uc_stack.ss_size = kStack;
      f.ctx.uc_link = &emu_scheduler;
      makecontext(&f.ctx, emu_fiber_entry, 0);
    }
    emu_fibers = &fibers;
    emu_body = &body;
    blockIdx.x = b;
    blockDim.x = block;
    gridDim.x = grid;
    for (bool running = true; running;) {
      running = false;
      for (unsigned t = 0; t < block; ++t) {
        if (fibers[t].done) continue;
        running = true;
        emu_current = t;
        threadIdx.x = t;
        emu_warp = &warps[t / 32];
        swapcontext(&emu_scheduler, &fibers[t].ctx);
      }
    }
  }
}
