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
// only output columns below out_width written.
//
// * The merge route, for every integer row pair (int32, uint32 biased to
//   int32, int64) and for float32/bfloat16 row pairs free of NaNs: two
//   launches. A partition kernel, one thread per span boundary of every
//   row at once, binary-searches the merge path's split there (a-elements
//   first on ties) into an int32 scratch. The merge kernel, one CTA per
//   (row, span) of 256 threads x an odd count of items (at most 3840
//   outputs; 60 KiB of shared memory for int64 keys), stages exactly the
//   span's inputs a[ia:ia'] and b[ib:ib'] in shared memory by 16-byte
//   cp.async copies; each thread finds its own sub-diagonal by one search
//   in shared memory, merges its items in registers into a shared-memory
//   copy of the span (an odd item count keeps those writes free of bank
//   conflicts), and the span goes out by 16-byte stores. No thread
//   searches alone on a CTA's critical path, and no element is placed by a
//   search of its own.
// * Why that gives the TPU's bytes. Equal integer keys are equal in every
//   bit, so any span width gives the network's bytes. A NaN-free float row
//   is sorted under the JAX comparator, where the replayed jnp.searchsorted
//   equals the merge path's split; a reference span's window then holds
//   the span's keys, and the network's first TILE outputs are the TILE
//   smallest keys of the window, which differ from a stable merge only
//   inside a class of tied keys. Tied float keys are equal in every bit
//   unless the class holds -0.0 and +0.0, and then only in columns that
//   receive a zero. So a CTA of float keys asks whether its own inputs can
//   hold a zero (the end keys of each slice, one load each); only then does
//   a warp per reference span [k*TILE, (k+1)*TILE) that meets its columns
//   find that span's split and scan its whole window (TILE keys a side: a
//   +0.0 at a[ia'] followed by a -0.0 past the span's own inputs counts
//   too), and each window that holds both zeros is merged again by the TPU
//   network, inside the same CTA, into the columns of the CTA it meets. That
//   is the reference's own semantics for those columns, not a fallback.
// * The network route, for float row pairs that may hold a NaN. NaNs
//   compare false, so a run the bitonic tile sort left holding a NaN can be
//   unsorted, and only jnp.searchsorted's own probe sequence gives its
//   diagonal. A first kernel, one thread per (row, TILE span), replays that
//   search (ia = searchsorted(pos_a, d), each probe of pos_a itself a
//   replayed searchsorted of a_i in b, lg(W+1)^2 loads from L2), and the
//   network kernel merges each window: lg(2*TILE) substages (11 at TILE =
//   1024) with a barrier each, all but the first on the lower half alone
//   (the upper half is not output), so 6144 compare-exchanges a window
//   instead of 11264. A NaN-free row of a sort whose other rows hold NaNs
//   can be unsorted too, so the route is chosen for a whole call.
// * Row strides: the rows of a and of b may each lie at their own stride.
//   Ph2's merge rounds over K1's tiles (kernels/bitonic/ops.py) read a pair
//   as rows 2k and 2k + 1 of the buffer the round before wrote (stride 2 *
//   width), so no round copies its pairs apart; Ph6 passes contiguous rows.
// * Choosing the route without a host sync: a float call takes a device
//   byte, nonzero if any of its rows may hold a NaN (the merge tree hands
//   every round one flag, reduced from the keys as they enter it). All four
//   kernels are launched; the kernels of the route not taken read the byte
//   and return. The network kernel walks its windows with a grid of as many CTAs as the
//   SMs hold at once, so its idle launch stays short: on an H100 (700 W) a
//   grid of one CTA a window idles 0.016 ms at whp round 1 (8192 x 1256)
//   and 0.38 ms at the exact round (8192 x 65536), this grid 0.002 ms; its
//   windows then take about a sixth longer (0.195 against 0.166 ms at
//   round 1).
#include <type_traits>

#include "keys.cuh"
#include "merge_path.cuh"

namespace {

using namespace repro;

constexpr int kMaxTile = 1024;  // network window
constexpr int kMinTile = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxItems = 15;  // merge route: outputs per thread
// reference spans that meet one merge CTA's span: 3840 / 128 + 2
constexpr int kMaxRefSpans = kThreads * kMaxItems / kMinTile + 2;

template <class K>
constexpr bool kFloatKeys = std::is_same<K, KeyF32>::value || std::is_same<K, KeyBF16>::value;

// 1 if the key is +0.0, 2 if it is -0.0, else 0.
__device__ __forceinline__ unsigned zero_bits(float x) {
  return x == 0.0f ? 1u << (__float_as_uint(x) >> 31) : 0u;
}
__device__ __forceinline__ unsigned zero_bits(uint16_t x) {
  return (x & 0x7fff) == 0 ? 1u << (x >> 15) : 0u;
}

// Whether x[lo, hi) of a sorted NaN-free row may hold a zero.
template <class K>
__device__ __forceinline__ bool may_hold_zero(const typename K::T* x, int64_t lo, int64_t hi) {
  const typename K::T zero = 0;
  return lo < hi && !K::lt(zero, x[lo]) && !K::lt(x[hi - 1], zero);
}

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

// Network route, first launch: the reference's diagonal of every (row,
// TILE span), one thread each.
template <class K>
__global__ void merge_path_diag_kernel(const typename K::T* __restrict__ a,
                                       const typename K::T* __restrict__ b,
                                       int32_t* __restrict__ diag, int64_t rows,
                                       int64_t width, int64_t a_stride, int64_t b_stride,
                                       int tile, int64_t spans,
                                       const unsigned char* __restrict__ nan) {
  if (*nan == 0) return;  // the merge route runs
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= rows * spans) return;
  const int64_t row = idx / spans;
  const int64_t d = (idx % spans) * tile;
  const typename K::T* ar = a + row * a_stride;
  const typename K::T* br = b + row * b_stride;
  // ia = searchsorted(pos_a, d), pos_a(i) = i + searchsorted(b, a_i)
  int64_t low = 0, high = width;
  for (int l = search_levels(width); l > 0; --l) {
    const int64_t mid = (low + high) >> 1;
    const int64_t pos = mid + replay_search_left<K>(br, width, K::order(ar[mid]));
    if (d <= pos) high = mid; else low = mid;
  }
  diag[idx] = static_cast<int32_t>(high);
}

// The TPU's merge of one window pair, by every thread of the block: s[0,
// 2 * tile) <- a[ia, ia + tile), b[ib, ib + tile) reversed (the sentinel
// past the row), then the bitonic merge network; s[0, tile) is the span.
// Only the span is kept, so after the first substage (stride tile, the one
// that crosses the halves) the network runs on the lower half alone: its
// later substages pair i with i + j inside blocks of 2j <= tile, so the
// lower half's bytes never depend on the upper half's again. That is the
// reference's network with the compare-exchanges it throws away left out.
template <class K>
__device__ __forceinline__ void network_window(typename K::T* s, const typename K::T* ar,
                                               const typename K::T* br, int64_t width,
                                               int64_t ia, int64_t ib, int tile) {
  using T = typename K::T;
  const T fill = K::sentinel();
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    const int64_t ga = ia + t;
    const int64_t gb = ib + t;  // negative only on a run left unsorted
    s[t] = ga < width ? ar[ga] : fill;
    s[2 * tile - 1 - t] = gb < width ? br[gb < 0 ? 0 : gb] : fill;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < tile; p += blockDim.x) {  // stride tile: the lower element
    const T y = s[p + tile];
    if (K::lt(y, s[p])) s[p] = y;
  }
  __syncthreads();
  for (int j = tile >> 1; j >= 1; j >>= 1) {  // every region ascending
    for (int p = threadIdx.x; p < tile >> 1; p += blockDim.x) {
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
}

// Network route, second launch: a grid of as many CTAs as the SMs hold at
// once walks the (row, TILE span) windows, each merged from the first
// launch's diagonal. Two window buffers take turns, so no barrier stands
// between one window's stores and the next window's loads.
template <class K>
__global__ void __launch_bounds__(kThreads)
    merge_network_kernel(const typename K::T* __restrict__ a, const typename K::T* __restrict__ b,
                         typename K::T* __restrict__ out, const int32_t* __restrict__ diag,
                         int64_t rows, int64_t width, int64_t a_stride, int64_t b_stride,
                         int64_t out_width, int tile, int64_t spans,
                         const unsigned char* __restrict__ nan) {
  using T = typename K::T;
  if (*nan == 0) return;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem);
  for (int64_t block = blockIdx.x; block < rows * spans; block += gridDim.x) {
    const int64_t row = block / spans;
    const int64_t d = (block % spans) * tile;
    const int64_t ia = diag[block];
    network_window<K>(s, a + row * a_stride, b + row * b_stride, width, ia, d - ia, tile);
    T* orow = out + row * out_width + d;
    const int64_t limit = out_width - d;  // columns of this span to produce
    for (int t = threadIdx.x; t < tile && t < limit; t += blockDim.x) orow[t] = s[t];
    // the other buffer next: every thread passes that window's barriers
    // before this one is filled again
    s = s == reinterpret_cast<T*>(smem) ? s + 2 * tile : reinterpret_cast<T*>(smem);
  }
}

// Merge route, first launch: split[row, k] = the a-elements among the
// first d = min(k * span, out_width) outputs of the row's merge, a first
// on ties; one thread per boundary k in [0, spans] of every row.
template <class K>
__global__ void merge_path_split_kernel(const typename K::T* __restrict__ a,
                                        const typename K::T* __restrict__ b,
                                        int32_t* __restrict__ split, int64_t rows,
                                        int64_t width, int64_t a_stride, int64_t b_stride,
                                        int64_t out_width, int span, int64_t spans,
                                        const unsigned char* __restrict__ nan) {
  if (nan != nullptr && *nan != 0) return;  // the network route runs
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= rows * (spans + 1)) return;
  const int64_t row = idx / (spans + 1);
  const int64_t d = min64((idx % (spans + 1)) * span, out_width);
  const typename K::T* ar = a + row * a_stride;
  const typename K::T* br = b + row * b_stride;
  int64_t lo = max64(0, d - width), hi = min64(d, width);
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (!K::lt(br[d - 1 - mid], ar[mid])) lo = mid + 1; else hi = mid;
  }
  split[idx] = static_cast<int32_t>(lo);
}

// Shared memory of a merge CTA: the staged inputs (for float keys, room
// for a network window too), the output span, and for float keys one int
// per reference span plus the zero flag.
__host__ __device__ __forceinline__ int inputs_bytes(int span, int tile, int key_bytes,
                                                     bool floats) {
  const int staged = round16(span * key_bytes + 48);
  const int window = round16(2 * tile * key_bytes);
  return floats && window > staged ? window : staged;
}

__host__ __device__ __forceinline__ int merge_smem_bytes(int span, int tile, int key_bytes,
                                                         bool floats) {
  return inputs_bytes(span, tile, key_bytes, floats) + round16(span * key_bytes + 16) +
         (floats ? (kMaxRefSpans + 1) * 4 : 0);
}

// Float keys, after the span's merge: every reference span [k * tile,
// (k + 1) * tile) that meets output columns [d0, d1) and whose window holds
// both -0.0 and +0.0 is merged by the network into the columns it meets.
// `net` is the inputs' buffer (free now), `ref` kMaxRefSpans ints.
template <class K>
__device__ void redo_mixed_zero_windows(const typename K::T* ar, const typename K::T* br,
                                        typename K::T* so, typename K::T* net, int* ref,
                                        int64_t width, int64_t d0, int64_t d1, int tile) {
  const int64_t k0 = d0 / tile;
  const int nref = static_cast<int>((d1 - 1) / tile - k0 + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < nref; r += kWarps) {
    const int64_t d = (k0 + r) * tile;
    const int64_t ia = warp_search(max64(0, d - width), min64(d, width),
                                   [&](int64_t i) { return !K::lt(br[d - 1 - i], ar[i]); });
    const int64_t ib = d - ia;
    const int64_t ea = min64(ia + tile, width), eb = min64(ib + tile, width);
    unsigned z = 0;
    if (may_hold_zero<K>(ar, ia, ea))
      for (int64_t i = ia + lane; i < ea; i += 32) z |= zero_bits(ar[i]);
    if (may_hold_zero<K>(br, ib, eb))
      for (int64_t i = ib + lane; i < eb; i += 32) z |= zero_bits(br[i]);
    const bool mixed = __ballot_sync(0xffffffffu, z & 1u) && __ballot_sync(0xffffffffu, z & 2u);
    if (lane == 0) ref[r] = mixed ? static_cast<int>(ia) : -1;
  }
  __syncthreads();
  for (int r = 0; r < nref; ++r) {
    const int64_t ia = ref[r];
    if (ia < 0) continue;  // the same for every thread
    const int64_t d = (k0 + r) * tile;
    network_window<K>(net, ar, br, width, ia, d - ia, tile);
    const int64_t lo = max64(d, d0), hi = min64(d + tile, d1);
    for (int64_t c = lo + threadIdx.x; c < hi; c += blockDim.x) so[c - d0] = net[c - d];
    __syncthreads();
  }
}

// Merge route, second launch: one CTA per (row, span) merges the span's
// inputs, which the first launch's splits bound, into output columns
// [d0, d1).
template <class K>
__global__ void __launch_bounds__(kThreads)
    merge_path_kernel(const typename K::T* __restrict__ a, const typename K::T* __restrict__ b,
                      typename K::T* __restrict__ out, const int32_t* __restrict__ split,
                      int64_t width, int64_t a_stride, int64_t b_stride, int64_t out_width,
                      int span, int64_t spans, int tile, const unsigned char* __restrict__ nan) {
  using T = typename K::T;
  constexpr bool floats = kFloatKeys<K>;
  if (nan != nullptr && *nan != 0) return;
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
  const T* ar = a + row * a_stride;
  const T* br = b + row * b_stride;
  const T* sa = stage(smem, ar + a0, na);
  const T* sb = stage(align16(sa + na), br + b0, nb);
  T* orow = out + row * out_width + d0;
  const int in_bytes = inputs_bytes(span, tile, sizeof(T), floats);
  T* so = placed<T>(smem + in_bytes, orow);
  int* ref = reinterpret_cast<int*>(smem + in_bytes + round16(span * sizeof(T) + 16));
  int* maybe_zero = ref + kMaxRefSpans;
  if constexpr (floats) {
    // only columns that receive a zero can differ from the network's
    if (threadIdx.x == 0)
      *maybe_zero = may_hold_zero<K>(ar, a0, a0 + na) || may_hold_zero<K>(br, b0, b0 + nb);
  }
  cp_async_wait_all();
  __syncthreads();
  const int items = span / kThreads;
  const int dd = threadIdx.x * items;
  if (dd < len) {
    int lo = max(0, dd - nb), hi = min(dd, na);
    while (lo < hi) {  // a-elements among the span's first dd outputs
      const int mid = (lo + hi) >> 1;
      if (!K::lt(sb[dd - 1 - mid], sa[mid])) lo = mid + 1; else hi = mid;
    }
    int i = lo, j = dd - lo;
    // one past a slice is still inside the buffer; the guards never take it
    T va = sa[i], vb = sb[j];
    const int end = min(dd + items, len);
    for (int c = dd; c < end; ++c) {
      if (j >= nb || (i < na && !K::lt(vb, va))) {
        so[c] = va;
        va = sa[++i];
      } else {
        so[c] = vb;
        vb = sb[++j];
      }
    }
  }
  __syncthreads();
  if constexpr (floats) {
    if (*maybe_zero)  // the same for every thread
      redo_mixed_zero_windows<K>(ar, br, so, reinterpret_cast<T*>(smem), ref, width, d0, d1,
                                 tile);
  }
  store(orow, so, len);
}

template <class K>
cudaError_t launch_merge(const void* a_, const void* b_, void* out_, int32_t* split, int64_t rows,
                         int64_t width, int64_t a_stride, int64_t b_stride, int64_t out_width,
                         int span, int tile, const unsigned char* nan, cudaStream_t stream) {
  using T = typename K::T;
  const T* a = static_cast<const T*>(a_);
  const T* b = static_cast<const T*>(b_);
  T* out = static_cast<T*>(out_);
  const int64_t spans = (out_width + span - 1) / span;
  const int64_t bounds = rows * (spans + 1);
  merge_path_split_kernel<K><<<static_cast<unsigned>((bounds + kThreads - 1) / kThreads), kThreads,
                               0, stream>>>(a, b, split, rows, width, a_stride, b_stride,
                                            out_width, span, spans, nan);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = merge_smem_bytes(span, tile, sizeof(T), kFloatKeys<K>);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(merge_path_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
  }
  merge_path_kernel<K><<<static_cast<unsigned>(rows * spans), kThreads, smem, stream>>>(
      a, b, out, split, width, a_stride, b_stride, out_width, span, spans, tile, nan);
  return cudaGetLastError();
}

template <class K>
cudaError_t launch_network(const void* a, const void* b, void* out, int32_t* diag,
                           int64_t rows, int64_t width, int64_t a_stride, int64_t b_stride,
                           int64_t out_width, int tile, const unsigned char* nan,
                           cudaStream_t stream) {
  using T = typename K::T;
  const int64_t spans = (out_width + tile - 1) / tile;
  const int64_t diag_blocks = (rows * spans + kThreads - 1) / kThreads;
  merge_path_diag_kernel<K><<<static_cast<unsigned>(diag_blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), diag, rows, width, a_stride, b_stride,
      tile, spans, nan);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = 4 * tile * static_cast<int>(sizeof(T));  // two windows
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, merge_network_kernel<K>, kThreads,
                                                           smem)) != cudaSuccess)
    return err;
  const int64_t grid = min64(rows * spans, static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1));
  merge_network_kernel<K><<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out), diag, rows, width,
      a_stride, b_stride, out_width, tile, spans, nan);
  return cudaGetLastError();
}

// Both routes; the kernels of the one the device byte does not pick return.
template <class K>
cudaError_t launch_float(const void* a, const void* b, void* out, int32_t* scratch, int64_t rows,
                         int64_t width, int64_t a_stride, int64_t b_stride, int64_t out_width,
                         int span, int tile, const unsigned char* nan, cudaStream_t stream) {
  const cudaError_t err = launch_merge<K>(a, b, out, scratch, rows, width, a_stride, b_stride,
                                          out_width, span, tile, nan, stream);
  if (err != cudaSuccess) return err;
  return launch_network<K>(a, b, out, scratch, rows, width, a_stride, b_stride, out_width, tile,
                           nan, stream);
}

}  // namespace

// a, b (rows, width) sorted rows, row r of a at a + r * a_stride and of b
// at b + r * b_stride (strides >= width, in keys: a round of a merge tree
// reads its pairs as the even and odd rows of one buffer, stride 2 *
// width, where the round before wrote them); out (rows, out_width)
// contiguous, out_width <= 2 * width. span: the merge route's outputs per
// CTA, a multiple of 256 up to 256 * 15 (an odd multiple keeps the staging
// free of bank conflicts). tile: float keys' reference span and network
// window, a power of two in [128, 1024] (ignored for integer keys).
// scratch: int32, rows * (ceil(out_width / span) + 1) entries (the merge
// route's splits at the span boundaries), and for float keys at least rows
// * ceil(out_width / tile) (the network route's diagonals). nan: float keys
// only (NULL for integer keys), a device byte, nonzero if the rows may hold
// a NaN (then the network route runs; on 0 the merge route, which needs
// every row sorted). dtype: 0 int32, 1 float32, 3 bfloat16, 4 int64.
// Returns a cudaError_t.
extern "C" int repro_merge_path(const void* a, const void* b, void* out, void* scratch,
                                int64_t rows, int64_t width, int64_t a_stride, int64_t b_stride,
                                int64_t out_width, int span, int tile, const void* nan, int dtype,
                                void* stream) {
  if (rows < 0 || width < 0 || width > 0x7fffffffLL || out_width < 0 || out_width > 2 * width ||
      a_stride < width || b_stride < width || scratch == nullptr || span < kThreads ||
      span % kThreads != 0 || span > kThreads * kMaxItems)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool floats = dtype == 1 || dtype == 3;
  if (floats && (nan == nullptr || tile < kMinTile || tile > kMaxTile || (tile & (tile - 1)) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || out_width == 0) return 0;
  const int64_t spans = (out_width + span - 1) / span;
  if (rows * (spans + 1) > 0x7fffffffLL || (floats && rows * ((out_width + tile - 1) / tile) > 0x7fffffffLL))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* sc = static_cast<int32_t*>(scratch);
  const unsigned char* flag = static_cast<const unsigned char*>(nan);
  const int64_t as = a_stride, bs = b_stride;
  switch (dtype) {
    case 0: return static_cast<int>(launch_merge<KeyI32>(a, b, out, sc, rows, width, as, bs, out_width, span, tile, nullptr, s));
    case 4: return static_cast<int>(launch_merge<KeyI64>(a, b, out, sc, rows, width, as, bs, out_width, span, tile, nullptr, s));
    case 1: return static_cast<int>(launch_float<KeyF32>(a, b, out, sc, rows, width, as, bs, out_width, span, tile, flag, s));
    case 3: return static_cast<int>(launch_float<KeyBF16>(a, b, out, sc, rows, width, as, bs, out_width, span, tile, flag, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
