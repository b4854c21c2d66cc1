// K1 and K4 — bitonic sort of every row of a (rows, width) tile, keys
// alone (K1) or keys with a value row swapped alongside (K4).
//
// Replaces: src/repro/kernels/bitonic/kernel.py, bitonic_sort_tiles
// (pallas_call body _sort_kernel -> sort_network -> _stage) and
// bitonic_sort_kv_tiles (_sort_kv_kernel -> sort_network_kv -> _stage_kv):
// Batcher's bitonic network over each row, width a power of two in
// [128, 16384]. Keys int32, uint32, float32 or bfloat16 (keys.cuh).
//
// What bounds it on an H100: each row is read once and written once (8
// bytes per 4-byte key, plus the values for K4), but the network does
// width/2 * lg(width) * (lg(width)+1) / 2 compare-exchanges per row, and
// every substage ends in a block-wide barrier. At width 16384 that is 105
// substages over a row in shared memory: the kernels are bound by
// shared-memory traffic and barriers, not by device memory.
//
// Design: one CTA per row keeps the whole row in dynamic shared memory (64
// KiB of 4-byte keys at width 16384; K4 adds the values, up to 192 KiB
// for 8-byte values, so the launch raises the CTA's dynamic shared memory
// limit first) and runs the same compare-exchange network as the TPU
// kernel, with its comparison, so keys and values are bit-identical to
// it: equal keys that differ in their bits (-0.0/+0.0, NaNs) and the
// values of equal keys land where the TPU network puts them. The network
// is not stable, and K4 keeps it so. K4 moves values as opaque 2-, 4- or
// 8-byte words. Device memory is touched once on the way in and once on
// the way out, coalesced. Up to 1024 threads each take width/2/1024
// compare-exchange pairs per substage.
#include "keys.cuh"

namespace {

using namespace repro;

constexpr int kMaxWidth = 16384;
constexpr int kMinWidth = 128;

// The TPU kernel's _stage over the whole network; `sv` (may be null) is
// swapped on the keys' predicate.
template <class K, typename V>
__device__ __forceinline__ void network(typename K::T* s, V* sv, int width) {
  const int half = width >> 1;
  for (int k = 2; k <= width; k <<= 1) {
    for (int j = k >> 1; j >= 1; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        // pair t: low element i (bit j clear), partner i + j
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int l = i + j;
        const typename K::T a = s[i];
        const typename K::T b = s[l];
        const bool ascending = (i & k) == 0;
        const bool swap = ascending ? K::lt(b, a) : K::lt(a, b);
        if (swap) {
          s[i] = b;
          s[l] = a;
          if (sv != nullptr) {
            const V va = sv[i];
            sv[i] = sv[l];
            sv[l] = va;
          }
        }
      }
      __syncthreads();
    }
  }
}

template <class K>
__global__ void bitonic_sort_rows_kernel(const typename K::T* __restrict__ in,
                                         typename K::T* __restrict__ out, int width) {
  using T = typename K::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int64_t row = blockIdx.x;
  const T* src = in + row * width;
  T* dst = out + row * width;
  for (int i = threadIdx.x; i < width; i += blockDim.x) s[i] = src[i];
  __syncthreads();
  network<K, uint32_t>(s, nullptr, width);
  for (int i = threadIdx.x; i < width; i += blockDim.x) dst[i] = s[i];
}

template <class K, typename V>
__global__ void bitonic_sort_kv_rows_kernel(const typename K::T* __restrict__ kin,
                                            const V* __restrict__ vin,
                                            typename K::T* __restrict__ kout,
                                            V* __restrict__ vout, int width) {
  using T = typename K::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* sv = reinterpret_cast<V*>(smem_raw);  // values first: 8-byte aligned
  T* sk = reinterpret_cast<T*>(smem_raw + static_cast<size_t>(width) * sizeof(V));
  const int64_t base = static_cast<int64_t>(blockIdx.x) * width;
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    sk[i] = kin[base + i];
    sv[i] = vin[base + i];
  }
  __syncthreads();
  network<K, V>(sk, sv, width);
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    kout[base + i] = sk[i];
    vout[base + i] = sv[i];
  }
}

int threads_for(int width) { return (width / 2) < 1024 ? (width / 2) : 1024; }

template <class K>
cudaError_t launch(const void* in, void* out, int64_t rows, int width, cudaStream_t stream) {
  using T = typename K::T;
  const size_t smem = static_cast<size_t>(width) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(bitonic_sort_rows_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bitonic_sort_rows_kernel<K><<<static_cast<unsigned>(rows), threads_for(width), smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), width);
  return cudaGetLastError();
}

template <class K, typename V>
cudaError_t launch_kv(const void* kin, const void* vin, void* kout, void* vout, int64_t rows,
                      int width, cudaStream_t stream) {
  using T = typename K::T;
  const size_t smem = static_cast<size_t>(width) * (sizeof(T) + sizeof(V));
  cudaError_t err = cudaFuncSetAttribute(bitonic_sort_kv_rows_kernel<K, V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bitonic_sort_kv_rows_kernel<K, V>
      <<<static_cast<unsigned>(rows), threads_for(width), smem, stream>>>(
          static_cast<const T*>(kin), static_cast<const V*>(vin), static_cast<T*>(kout),
          static_cast<V*>(vout), width);
  return cudaGetLastError();
}

template <class K>
cudaError_t launch_kv_words(const void* kin, const void* vin, void* kout, void* vout,
                            int64_t rows, int width, int value_bytes, cudaStream_t s) {
  switch (value_bytes) {
    case 2: return launch_kv<K, uint16_t>(kin, vin, kout, vout, rows, width, s);
    case 4: return launch_kv<K, uint32_t>(kin, vin, kout, vout, rows, width, s);
    case 8: return launch_kv<K, unsigned long long>(kin, vin, kout, vout, rows, width, s);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_shape(int64_t rows, int width) {
  return width < kMinWidth || width > kMaxWidth || (width & (width - 1)) != 0 || rows < 0 ||
         rows > 0x7fffffffLL;
}

}  // namespace

// dtype: 0 int32, 1 float32, 2 uint32, 3 bfloat16. Returns a cudaError_t.
extern "C" int repro_bitonic_sort_rows(const void* in, void* out, int64_t rows, int width,
                                       int dtype, void* stream) {
  if (bad_shape(rows, width)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<KeyI32>(in, out, rows, width, s));
    case 1: return static_cast<int>(launch<KeyF32>(in, out, rows, width, s));
    case 2: return static_cast<int>(launch<KeyU32>(in, out, rows, width, s));
    case 3: return static_cast<int>(launch<KeyBF16>(in, out, rows, width, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Keys as for repro_bitonic_sort_rows; values (rows, width) of words of
// value_bytes (2, 4 or 8). Returns a cudaError_t.
extern "C" int repro_bitonic_sort_kv_rows(const void* kin, const void* vin, void* kout,
                                          void* vout, int64_t rows, int width, int dtype,
                                          int value_bytes, void* stream) {
  if (bad_shape(rows, width)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_kv_words<KeyI32>(kin, vin, kout, vout, rows, width, value_bytes, s));
    case 1: return static_cast<int>(launch_kv_words<KeyF32>(kin, vin, kout, vout, rows, width, value_bytes, s));
    case 2: return static_cast<int>(launch_kv_words<KeyU32>(kin, vin, kout, vout, rows, width, value_bytes, s));
    case 3: return static_cast<int>(launch_kv_words<KeyBF16>(kin, vin, kout, vout, rows, width, value_bytes, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
