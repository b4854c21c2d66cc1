// K3 — merge-path merge of sorted row pairs.
//
// Replaces: src/repro/kernels/merge_path/kernel.py, merge_sorted_tiles
// (pallas_call body _merge_kernel -> merge_rows), as driven by
// merge_path/ops.py merge_partitioned: the output row is cut into
// TILE-wide spans, each span's start in a and in b (its diagonal) is
// solved from rank positions outside the kernel, sentinel-filled windows
// of TILE keys per side are gathered, and the kernel merges each window
// pair with a bitonic network and keeps the first TILE outputs.
//
// What bounds it on an H100: a merge reads each input key once and writes
// each output key once, so the floor is device-memory bytes. The TPU
// version also materialised the (rows, spans, TILE) windows of both sides
// in device memory — 4 GiB a side at the exact tier of the full-width
// configuration — and ran lg(2*TILE)+1 network substages per window.
//
// Design: the GPU merge path the TPU version avoided. One CTA per
// (row, span) finds its own diagonal by a binary search over the row
// pair in device memory (a-elements first on ties, the same split as
// ia(d) = #{i : i + #{b_j < a_i} < d}), loads its two TILE windows
// straight into shared memory with sentinel fill past the row end, and
// places every window element by its rank in the other window (a: count
// of smaller b; b: count of a that are not greater), keeping the ranks
// below TILE. No window tensor exists in device memory, and only output
// columns below out_width are produced. The values equal those of the
// TPU kernel's output, including real keys that equal the sentinel.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxTile = 1024;
constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T sentinel();
template <>
__device__ __forceinline__ int32_t sentinel<int32_t>() { return 0x7fffffff; }
template <>
__device__ __forceinline__ float sentinel<float>() { return CUDART_INF_F; }

template <typename T>
__global__ void merge_path_kernel(const T* __restrict__ a,
                                  const T* __restrict__ b,
                                  T* __restrict__ out, int64_t width,
                                  int64_t out_width, int tile,
                                  int64_t spans) {
  __shared__ T sa[kMaxTile];
  __shared__ T sb[kMaxTile];
  __shared__ int64_t s_ia;
  const int64_t block = blockIdx.x;
  const int64_t row = block / spans;
  const int64_t d = (block % spans) * tile;  // first output column of the span
  const T* ar = a + row * width;
  const T* br = b + row * width;
  if (threadIdx.x == 0) {
    // merge path: a-elements among the first d outputs, a first on ties
    int64_t lo = d > width ? d - width : 0;
    int64_t hi = d < width ? d : width;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (!(br[d - 1 - mid] < ar[mid])) lo = mid + 1; else hi = mid;
    }
    s_ia = lo;
  }
  __syncthreads();
  const int64_t ia = s_ia;
  const int64_t ib = d - ia;
  const T fill = sentinel<T>();
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    sa[t] = (ia + t < width) ? ar[ia + t] : fill;
    sb[t] = (ib + t < width) ? br[ib + t] : fill;
  }
  __syncthreads();
  T* orow = out + row * out_width + d;
  const int64_t limit = out_width - d;  // columns of this span to produce
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    const T va = sa[t];
    int lo = 0, hi = tile;
    while (lo < hi) {  // #{sb < va}
      const int mid = (lo + hi) >> 1;
      if (sb[mid] < va) lo = mid + 1; else hi = mid;
    }
    int pos = t + lo;
    if (pos < tile && pos < limit) orow[pos] = va;
    const T vb = sb[t];
    lo = 0;
    hi = tile;
    while (lo < hi) {  // #{sa <= vb}
      const int mid = (lo + hi) >> 1;
      if (!(vb < sa[mid])) lo = mid + 1; else hi = mid;
    }
    pos = t + lo;
    if (pos < tile && pos < limit) orow[pos] = vb;
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* out, int64_t rows,
                   int64_t width, int64_t out_width, int tile,
                   cudaStream_t stream) {
  const int64_t spans = (out_width + tile - 1) / tile;
  const int64_t blocks = rows * spans;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  merge_path_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out),
      width, out_width, tile, spans);
  return cudaGetLastError();
}

}  // namespace

// a, b (rows, width) sorted rows; out (rows, out_width), out_width <=
// 2 * width; tile a power of two in [1, 1024]. dtype: 0 = int32,
// 1 = float32. Returns a cudaError_t.
extern "C" int repro_merge_path(const void* a, const void* b, void* out,
                                int64_t rows, int64_t width, int64_t out_width,
                                int tile, int dtype, void* stream) {
  if (rows < 0 || width < 0 || out_width < 0 || out_width > 2 * width ||
      tile < 1 || tile > kMaxTile || (tile & (tile - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || out_width == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<int32_t>(a, b, out, rows, width, out_width, tile, s));
    case 1: return static_cast<int>(launch<float>(a, b, out, rows, width, out_width, tile, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
