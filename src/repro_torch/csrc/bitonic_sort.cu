// K1 — bitonic sort of every row of a (rows, width) tile.
//
// Replaces: src/repro/kernels/bitonic/kernel.py, bitonic_sort_tiles
// (pallas_call body _sort_kernel -> sort_network -> _stage): Batcher's
// bitonic network over each row, width a power of two in [128, 16384].
//
// What bounds it on an H100: each row is read once and written once
// (8 bytes per int32/float32 key), but the network does
// width/2 * lg(width) * (lg(width)+1) / 2 compare-exchanges per row, and
// every substage ends in a block-wide barrier. At width 16384 that is 105
// substages over a 64 KiB row: the kernel is bound by shared-memory
// traffic and barriers, not by device memory.
//
// Design: one CTA per row keeps the whole row in dynamic shared memory
// (64 KiB at width 16384, so the launch raises the CTA's dynamic shared
// memory limit first) and runs the same compare-exchange network as the
// TPU kernel, so the result is bit-identical to it. Device memory is
// touched once on the way in and once on the way out, coalesced. Up to
// 1024 threads each take width/2/1024 compare-exchange pairs per substage.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWidth = 16384;
constexpr int kMinWidth = 128;

template <typename T>
__global__ void bitonic_sort_rows_kernel(const T* __restrict__ in,
                                         T* __restrict__ out, int width) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int64_t row = blockIdx.x;
  const T* src = in + row * width;
  T* dst = out + row * width;
  for (int i = threadIdx.x; i < width; i += blockDim.x) s[i] = src[i];
  __syncthreads();
  const int half = width >> 1;
  for (int k = 2; k <= width; k <<= 1) {
    for (int j = k >> 1; j >= 1; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        // pair t: low element i (bit j clear), partner i + j
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int l = i + j;
        const T a = s[i];
        const T b = s[l];
        const bool ascending = (i & k) == 0;
        const bool swap = ascending ? (a > b) : (a < b);
        if (swap) {
          s[i] = b;
          s[l] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < width; i += blockDim.x) dst[i] = s[i];
}

template <typename T>
cudaError_t launch(const void* in, void* out, int64_t rows, int width,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(width) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      bitonic_sort_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int threads = (width / 2) < 1024 ? (width / 2) : 1024;
  bitonic_sort_rows_kernel<T><<<static_cast<unsigned>(rows), threads, smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), width);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = int32, 1 = float32. Returns a cudaError_t.
extern "C" int repro_bitonic_sort_rows(const void* in, void* out, int64_t rows,
                                       int width, int dtype, void* stream) {
  if (width < kMinWidth || width > kMaxWidth || (width & (width - 1)) != 0 ||
      rows < 0 || rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<int32_t>(in, out, rows, width, s));
    case 1: return static_cast<int>(launch<float>(in, out, rows, width, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
