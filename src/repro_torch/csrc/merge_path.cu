// K3 — merge-path merge of sorted row pairs.
//
// Replaces: src/repro/kernels/merge_path/kernel.py, merge_sorted_tiles
// (pallas_call body _merge_kernel -> merge_rows), as driven by
// merge_path/ops.py merge_partitioned: the output row is cut into
// TILE-wide spans, each span's start in a and in b (its diagonal) is
// solved from rank positions outside the kernel (jnp.searchsorted),
// sentinel-filled windows of TILE keys per side are gathered, and the
// kernel merges each window pair with the bitonic merge network over
// concat(aw, reverse(bw)) and keeps the first TILE outputs.
//
// What bounds it on an H100: a merge reads each input key once and writes
// each output key once, so the floor is device-memory bytes. The TPU
// version also materialised the (rows, spans, TILE) windows of both sides
// in device memory — 4 GiB a side at the exact tier of the full-width
// configuration — and ran lg(2*TILE) network substages per window.
//
// Design: the GPU merge path. One CTA per (row, span) loads its two TILE
// windows straight into shared memory with sentinel fill past the row end
// and writes only output columns below out_width; no window tensor exists
// in device memory. Two routes, by key type:
//
// * int32 keys: the CTA finds its diagonal itself by one binary search
//   over the row pair in device memory (a-elements first on ties, the
//   split ia(d) = #{i : i + #{b_j < a_i} < d}), and places every window
//   element by its rank in the other window. Equal integer keys are equal
//   in every bit, so this gives the TPU network's bytes.
// * float32 and bfloat16 keys: -0.0 and +0.0 compare equal but differ in
//   their bits, and NaNs compare false, so only the TPU's own network
//   gives its bytes, and only jnp.searchsorted's own probe sequence gives
//   its diagonal where NaNs left a run unsorted (the bitonic tile sort
//   does). A first kernel, one thread per (row, span), replays that search
//   (ia = searchsorted(pos_a, d), each probe of pos_a itself a replayed
//   searchsorted of a_i in b, lg(W+1)^2 loads from L2), and the merge
//   kernel runs the network: lg(2*TILE) substages (11 at TILE = 1024) with
//   a barrier each.
#include "keys.cuh"

namespace {

using namespace repro;

constexpr int kMaxTile = 1024;
constexpr int kThreads = 256;

__device__ __forceinline__ int search_levels(int64_t n) {  // ceil(lg(n + 1))
  int levels = 0;
  while ((int64_t{1} << levels) < n + 1) ++levels;
  return levels;
}

// jnp.searchsorted(arr, q, side="left") as the JAX function runs it: a
// fixed number of halving steps on (low, high) = (0, n), in the order of
// the JAX sort comparator; qo is the query's order key.
template <class K>
__device__ __forceinline__ int64_t replay_search_left(const typename K::T* arr, int64_t n,
                                                      int32_t qo) {
  int64_t low = 0, high = n;
  for (int l = search_levels(n); l > 0; --l) {
    const int64_t mid = (low + high) >> 1;
    if (qo <= K::order(arr[mid])) high = mid; else low = mid;
  }
  return high;
}

template <class K>
__global__ void merge_path_diag_kernel(const typename K::T* __restrict__ a,
                                       const typename K::T* __restrict__ b,
                                       int32_t* __restrict__ diag, int64_t rows,
                                       int64_t width, int tile, int64_t spans) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= rows * spans) return;
  const int64_t row = idx / spans;
  const int64_t d = (idx % spans) * tile;
  const typename K::T* ar = a + row * width;
  const typename K::T* br = b + row * width;
  // ia = searchsorted(pos_a, d), pos_a(i) = i + searchsorted(b, a_i)
  int64_t low = 0, high = width;
  for (int l = search_levels(width); l > 0; --l) {
    const int64_t mid = (low + high) >> 1;
    const int64_t pos = mid + replay_search_left<K>(br, width, K::order(ar[mid]));
    if (d <= pos) high = mid; else low = mid;
  }
  diag[idx] = static_cast<int32_t>(high);
}

template <class K>
__global__ void merge_network_kernel(const typename K::T* __restrict__ a,
                                     const typename K::T* __restrict__ b,
                                     typename K::T* __restrict__ out,
                                     const int32_t* __restrict__ diag, int64_t width,
                                     int64_t out_width, int tile, int64_t spans) {
  using T = typename K::T;
  __shared__ T s[2 * kMaxTile];
  const int64_t block = blockIdx.x;
  const int64_t row = block / spans;
  const int64_t d = (block % spans) * tile;
  const T* ar = a + row * width;
  const T* br = b + row * width;
  const int64_t ia = diag[block];
  const int64_t ib = d - ia;  // negative only on a run left unsorted
  const T fill = K::sentinel();
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    const int64_t ga = ia + t;
    const int64_t gb = ib + t;
    s[t] = ga < width ? ar[ga] : fill;
    s[2 * tile - 1 - t] = gb < width ? br[gb < 0 ? 0 : gb] : fill;  // b reversed
  }
  __syncthreads();
  for (int j = tile; j >= 1; j >>= 1) {  // every region ascending
    for (int p = threadIdx.x; p < tile; p += blockDim.x) {
      const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
      const T x = s[i];
      const T y = s[i + j];
      if (K::lt(y, x)) {
        s[i] = y;
        s[i + j] = x;
      }
    }
    __syncthreads();
  }
  T* orow = out + row * out_width + d;
  const int64_t limit = out_width - d;  // columns of this span to produce
  for (int t = threadIdx.x; t < tile && t < limit; t += blockDim.x) orow[t] = s[t];
}

__global__ void merge_path_rank_kernel(const int32_t* __restrict__ a,
                                       const int32_t* __restrict__ b,
                                       int32_t* __restrict__ out, int64_t width,
                                       int64_t out_width, int tile, int64_t spans) {
  __shared__ int32_t sa[kMaxTile];
  __shared__ int32_t sb[kMaxTile];
  __shared__ int64_t s_ia;
  const int64_t block = blockIdx.x;
  const int64_t row = block / spans;
  const int64_t d = (block % spans) * tile;  // first output column of the span
  const int32_t* ar = a + row * width;
  const int32_t* br = b + row * width;
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
  const int32_t fill = KeyI32::sentinel();
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    sa[t] = (ia + t < width) ? ar[ia + t] : fill;
    sb[t] = (ib + t < width) ? br[ib + t] : fill;
  }
  __syncthreads();
  int32_t* orow = out + row * out_width + d;
  const int64_t limit = out_width - d;  // columns of this span to produce
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    const int32_t va = sa[t];
    int lo = 0, hi = tile;
    while (lo < hi) {  // #{sb < va}
      const int mid = (lo + hi) >> 1;
      if (sb[mid] < va) lo = mid + 1; else hi = mid;
    }
    int pos = t + lo;
    if (pos < tile && pos < limit) orow[pos] = va;
    const int32_t vb = sb[t];
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

template <class K>
cudaError_t launch_network(const void* a, const void* b, void* out, int32_t* diag,
                           int64_t rows, int64_t width, int64_t out_width, int tile,
                           int64_t spans, cudaStream_t stream) {
  using T = typename K::T;
  if (diag == nullptr) return cudaErrorInvalidValue;
  const int64_t diag_blocks = (rows * spans + kThreads - 1) / kThreads;
  merge_path_diag_kernel<K><<<static_cast<unsigned>(diag_blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), diag, rows, width, tile, spans);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_network_kernel<K><<<static_cast<unsigned>(rows * spans), kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out), diag, width,
      out_width, tile, spans);
  return cudaGetLastError();
}

}  // namespace

// a, b (rows, width) sorted rows; out (rows, out_width), out_width <=
// 2 * width; diag (rows * spans,) int32 scratch for float keys (may be
// NULL for int32), spans = ceil(out_width / tile); tile a power of two in
// [1, 1024]. dtype: 0 int32, 1 float32, 3 bfloat16. Returns a cudaError_t.
extern "C" int repro_merge_path(const void* a, const void* b, void* out, void* diag,
                                int64_t rows, int64_t width, int64_t out_width, int tile,
                                int dtype, void* stream) {
  if (rows < 0 || width < 0 || out_width < 0 || out_width > 2 * width || tile < 1 ||
      tile > kMaxTile || (tile & (tile - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || out_width == 0) return 0;
  const int64_t spans = (out_width + tile - 1) / tile;
  if (rows * spans > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* dg = static_cast<int32_t*>(diag);
  switch (dtype) {
    case 0:
      merge_path_rank_kernel<<<static_cast<unsigned>(rows * spans), kThreads, 0, s>>>(
          static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
          static_cast<int32_t*>(out), width, out_width, tile, spans);
      return static_cast<int>(cudaGetLastError());
    case 1: return static_cast<int>(launch_network<KeyF32>(a, b, out, dg, rows, width, out_width, tile, spans, s));
    case 3: return static_cast<int>(launch_network<KeyBF16>(a, b, out, dg, rows, width, out_width, tile, spans, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
