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
// What bounds it on an H100: a merge reads each input key that reaches
// the output once and writes each output key once, so the floor is
// device-memory bytes: rows * (min(2W, out_width) + out_width) words. The
// TPU version also materialised the (rows, spans, TILE) windows of both
// sides in device memory — 4 GiB a side at the exact tier of the
// full-width configuration — and ran lg(2*TILE) network substages per
// window.
//
// Design: the GPU merge path, with no window tensor in device memory and
// only output columns below out_width written. Two routes, by key type:
//
// * int32 and int64 keys (uint32 keys arrive biased to int32; int64 are
//   the segmented sort's composites and 64-bit keys): two launches. A
//   partition kernel, one thread per span boundary of every row at once,
//   binary-searches the merge path's split there (a-elements first on
//   ties) into an int32 scratch. The merge kernel, one CTA per (row,
//   span) of 256 threads x an odd count of items (at most 3840 outputs;
//   60 KiB of shared memory for int64 keys),
//   stages exactly the span's inputs a[ia:ia'] and b[ib:ib'] in shared
//   memory by 16-byte cp.async copies; each thread finds its own
//   sub-diagonal by one search in shared memory, merges its items in
//   registers into a shared-memory copy of the span (an odd item count
//   keeps those writes free of bank conflicts), and the span goes out by
//   16-byte stores. Equal integer keys are equal in every bit, so any
//   span width gives the TPU network's bytes. No thread searches alone on
//   a CTA's critical path, and no element is placed by a search of its
//   own.
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
#include "merge_path.cuh"

namespace {

using namespace repro;

constexpr int kMaxTile = 1024;  // float route: network window
constexpr int kThreads = 256;
constexpr int kMaxItems = 15;  // int route: outputs per thread

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

// Integer route, first launch: split[row, k] = the a-elements among the
// first d = min(k * span, out_width) outputs of the row's merge, a first
// on ties; one thread per boundary k in [0, spans] of every row.
template <class T>
__global__ void merge_path_split_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                        int32_t* __restrict__ split, int64_t rows,
                                        int64_t width, int64_t out_width, int span,
                                        int64_t spans) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= rows * (spans + 1)) return;
  const int64_t row = idx / (spans + 1);
  const int64_t d = min64((idx % (spans + 1)) * span, out_width);
  const T* ar = a + row * width;
  const T* br = b + row * width;
  int64_t lo = max64(0, d - width), hi = min64(d, width);
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (!(br[d - 1 - mid] < ar[mid])) lo = mid + 1; else hi = mid;
  }
  split[idx] = static_cast<int32_t>(lo);
}

__host__ __device__ __forceinline__ int inputs_bytes(int span, int key_bytes) {
  return round16(span * key_bytes + 48);
}

// Integer route, second launch: one CTA per (row, span) merges the span's
// inputs, which the first launch's splits bound, into output columns
// [d0, d1).
template <class T>
__global__ void __launch_bounds__(kThreads)
    merge_path_int_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
                          const int32_t* __restrict__ split, int64_t width, int64_t out_width,
                          int span, int64_t spans) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t row = blockIdx.x / spans;
  const int64_t k = blockIdx.x % spans;
  const int64_t d0 = k * span;
  const int64_t d1 = min64(d0 + span, out_width);
  const int32_t* sp = split + row * (spans + 1) + k;
  const int64_t a0 = sp[0];
  const int64_t b0 = d0 - a0;
  const int na = sp[1] - sp[0];
  const int nb = static_cast<int>(d1 - sp[1] - b0);
  const int len = static_cast<int>(d1 - d0);
  const T* sa = stage(smem, a + row * width + a0, na);
  const T* sb = stage(align16(sa + na), b + row * width + b0, nb);
  T* orow = out + row * out_width + d0;
  T* so = placed<T>(smem + inputs_bytes(span, sizeof(T)), orow);
  cp_async_wait_all();
  __syncthreads();
  const int items = span / kThreads;
  const int dd = threadIdx.x * items;
  if (dd < len) {
    int lo = max(0, dd - nb), hi = min(dd, na);
    while (lo < hi) {  // a-elements among the span's first dd outputs
      const int mid = (lo + hi) >> 1;
      if (!(sb[dd - 1 - mid] < sa[mid])) lo = mid + 1; else hi = mid;
    }
    int i = lo, j = dd - lo;
    // one past a slice is still inside the buffer; the guards never take it
    T va = sa[i], vb = sb[j];
    const int end = min(dd + items, len);
    for (int c = dd; c < end; ++c) {
      if (j >= nb || (i < na && !(vb < va))) {
        so[c] = va;
        va = sa[++i];
      } else {
        so[c] = vb;
        vb = sb[++j];
      }
    }
  }
  __syncthreads();
  store(orow, so, len);
}

template <class T>
cudaError_t launch_int(const void* a_, const void* b_, void* out_, int32_t* split, int64_t rows,
                       int64_t width, int64_t out_width, int span, int64_t spans,
                       cudaStream_t stream) {
  const T* a = static_cast<const T*>(a_);
  const T* b = static_cast<const T*>(b_);
  T* out = static_cast<T*>(out_);
  const int64_t bounds = rows * (spans + 1);
  merge_path_split_kernel<T><<<static_cast<unsigned>((bounds + kThreads - 1) / kThreads), kThreads,
                               0, stream>>>(a, b, split, rows, width, out_width, span, spans);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = inputs_bytes(span, sizeof(T)) + span * static_cast<int>(sizeof(T)) + 16;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(merge_path_int_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  merge_path_int_kernel<T><<<static_cast<unsigned>(rows * spans), kThreads, smem, stream>>>(
      a, b, out, split, width, out_width, span, spans);
  return cudaGetLastError();
}

template <class K>
cudaError_t launch_network(const void* a, const void* b, void* out, int32_t* diag,
                           int64_t rows, int64_t width, int64_t out_width, int tile,
                           int64_t spans, cudaStream_t stream) {
  using T = typename K::T;
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
// 2 * width. tile: the outputs per span — for integer keys a multiple of 256
// up to 256 * 15 (an odd multiple keeps the staging free of bank
// conflicts), for float keys the network's window, a power of two in
// [1, 1024]; spans = ceil(out_width / tile). diag: int32 scratch of
// rows * (spans + 1) (integers: the splits at the span boundaries) or rows
// * spans (float: the windows' diagonals). dtype: 0 int32, 1 float32, 3
// bfloat16, 4 int64. Returns a cudaError_t.
extern "C" int repro_merge_path(const void* a, const void* b, void* out, void* diag,
                                int64_t rows, int64_t width, int64_t out_width, int tile,
                                int dtype, void* stream) {
  if (rows < 0 || width < 0 || width > 0x7fffffffLL || out_width < 0 || out_width > 2 * width ||
      tile < 1 || diag == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || out_width == 0) return 0;
  const bool int_route = dtype == 0 || dtype == 4;
  if (int_route ? (tile % kThreads != 0 || tile > kThreads * kMaxItems)
                : (tile > kMaxTile || (tile & (tile - 1)) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t spans = (out_width + tile - 1) / tile;
  if (rows * (spans + 1) > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* dg = static_cast<int32_t*>(diag);
  switch (dtype) {
    case 0: return static_cast<int>(launch_int<int32_t>(a, b, out, dg, rows, width, out_width, tile, spans, s));
    case 4: return static_cast<int>(launch_int<int64_t>(a, b, out, dg, rows, width, out_width, tile, spans, s));
    case 1: return static_cast<int>(launch_network<KeyF32>(a, b, out, dg, rows, width, out_width, tile, spans, s));
    case 3: return static_cast<int>(launch_network<KeyBF16>(a, b, out, dg, rows, width, out_width, tile, spans, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
