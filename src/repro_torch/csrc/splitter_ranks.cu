// K2 — ranks of tagged queries in runs, batched over rows.
//
// Replaces: src/repro/kernels/searchsorted/kernel.py, splitter_ranks
// (pallas_call body _ranks_kernel): for each query (key, proc, idx), the
// number of run elements (x_i, me, i) lexicographically smaller, computed
// there as a masked count over 2048-wide blocks — O(n * S) work.
//
// What bounds it on an H100: device-memory bytes. On the main path both
// sides of a row are sorted — Ph6's rank merge ranks one sorted run in the
// other, then the output slots arange(2w) in the increasing rank positions
// — so a row's ranks are one merge of its run with its queries: n + S
// compares on n + 2S words (n + S words and S / B more when one query row
// is broadcast over the rows). A binary search per query in device memory
// pays ~lg n dependent scattered loads per query, and a pass that checks a
// row's order before the ranks reads every word twice.
//
// Keys: int32, float32, bfloat16 and int64 (the segmented sort's
// composites), one template on the key codec; 8-byte keys double the
// staged key slices of a tile (up to 80 KiB of shared memory with tags).
//
// Design: per row, the route follows the order of its run and its queries.
// * Run and queries in order (the main path): the merge path. Run and
//   query row are one merge, cut along its diagonals into tiles of at most
//   4096 items, one CTA each; the CTA stages exactly its slices of run and
//   queries in shared memory by 16-byte cp.async copies, each thread splits
//   its items by one short search in shared memory and walks them in
//   order, and the ranks go out by 16-byte stores. O(n + S) work.
// * Run in order, queries not (NaN query keys, or a caller's unsorted
//   queries): a binary search per query over the run.
// * Run out of order (NaN keys in a key-value merge leave the next round's
//   rank positions unsorted, F1): the masked count, element by element, as
//   the TPU kernel does.
// A row of at most 4096 items (every row of the main path's first rounds)
// is one tile: its CTA stages the whole row, checks both orders in shared
// memory and takes the route there, in one launch that reads each word
// once. A longer row is cut into several tiles: an order pass (CTAs over
// 4096-element chunks of every row) clears a row's flag bits first, two
// warps of each merge CTA find the tile's diagonal splits with 32-lane
// probes (about 4 steps at 79 008), and rows out of order search or count
// in device memory, one query a thread.
// The predicate is (x_i, me, i) < (q_key, q_proc, q_idx) under the key
// type's < and ==, so NaN compares false and -0.0 == +0.0. On a run in
// order (NaNs last) it holds on a prefix of the run, which makes the
// search and the count agree; on queries in order (lexicographically, no
// NaN key) that prefix only grows from one query to the next, which makes
// the merge agree. Every rank is a count over the n real elements, so none
// exceeds n and no clamp follows.
#include "keys.cuh"
#include "merge_path.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;
constexpr int kMaxTile = 4096;  // merge items (run + queries) per CTA
enum : int32_t { kMerge = 0, kSearch = 1, kCount = 2 };  // row routes
constexpr int32_t kRunInOrder = 1, kQueriesInOrder = 2;  // row flag bits

template <class K>
__device__ __forceinline__ bool less(typename K::T v, int64_t i, typename K::T key, int32_t qp,
                                     int32_t qi, int32_t me) {
  return K::lt(v, key) || (K::eq(v, key) && (me < qp || (me == qp && i < qi)));
}

// Queries: keys, and procs / idxs, or the constants that stand for them
// (proc_tag, 0); in device or in shared memory.
template <class K>
struct Queries {
  const typename K::T* key;
  const int32_t* proc;
  const int32_t* idx;
  int32_t proc_tag;
  __device__ __forceinline__ int32_t p(int64_t j) const { return proc ? proc[j] : proc_tag; }
  __device__ __forceinline__ int32_t i(int64_t j) const { return idx ? idx[j] : 0; }
};

// This thread's share of the order checks of the pairs (i, i + 1), i in
// [i0, i1), of the run and (j, j + 1), j in [j0, j1), of the queries: the
// run is in order if no element is above the next and no NaN is followed
// by a number; the queries if each is <= the next, lexicographically,
// with no NaN key. Returns kRunInOrder | kQueriesInOrder bits.
template <class K>
__device__ __forceinline__ int32_t order_bits(const typename K::T* x, int64_t i0, int64_t i1,
                                              const Queries<K>& q, int64_t j0, int64_t j1) {
  using T = typename K::T;
  bool run_ok = true, q_ok = true;
  for (int64_t i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
    const T a = x[i];
    const T b = x[i + 1];
    run_ok &= K::isnan(b) || (!K::isnan(a) && !K::lt(b, a));
  }
  for (int64_t j = j0 + threadIdx.x; j < j1; j += blockDim.x) {
    const T a = q.key[j];
    const T b = q.key[j + 1];
    const int32_t pa = q.p(j), pb = q.p(j + 1);
    q_ok &= !K::isnan(a) && !K::isnan(b) &&
            (K::lt(a, b) || (K::eq(a, b) && (pa < pb || (pa == pb && q.i(j) <= q.i(j + 1)))));
  }
  return (run_ok ? kRunInOrder : 0) | (q_ok ? kQueriesInOrder : 0);
}

__device__ __forceinline__ int32_t route_of(int32_t flags) {
  return !(flags & kRunInOrder) ? kCount : ((flags & kQueriesInOrder) ? kMerge : kSearch);
}

// Rows of several tiles: row_flags[row] (all bits set before) loses the
// bit of each order that chunk blockIdx.x % chunks of the row breaks.
template <class K>
__global__ void __launch_bounds__(kThreads)
    row_order_kernel(const typename K::T* __restrict__ data, int64_t n, Queries<K> q,
                     int64_t qstride, int64_t S, int chunks, int32_t* __restrict__ row_flags) {
  const int64_t row = blockIdx.x / chunks;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x % chunks) * kMaxTile;
  const Queries<K> qr{q.key + row * qstride, q.proc ? q.proc + row * qstride : nullptr,
                      q.idx ? q.idx + row * qstride : nullptr, q.proc_tag};
  const int32_t bits = order_bits<K>(data + row * n, c0, min64(c0 + kMaxTile, n - 1), qr, c0,
                                     min64(c0 + kMaxTile, S - 1));
  const int run_ok = __syncthreads_and(bits & kRunInOrder);
  const int q_ok = __syncthreads_and(bits & kQueriesInOrder);
  if (threadIdx.x == 0 && !(run_ok && q_ok))
    atomicAnd(row_flags + row, (run_ok ? kRunInOrder : 0) | (q_ok ? kQueriesInOrder : 0));
}

// Shared memory of a tile: run and query key slices, query procs and idxs
// (where given), ranks.
__host__ __device__ __forceinline__ int keys_bytes(int tile, int key_bytes) {
  return round16(tile * key_bytes + 48);
}
__host__ __device__ __forceinline__ int tags_bytes(int tile, bool tags) {
  return tags ? round16(2 * (tile * 4 + 32)) : 0;
}
__host__ __device__ __forceinline__ int smem_bytes(int tile, int key_bytes, bool tags) {
  return keys_bytes(tile, key_bytes) + tags_bytes(tile, tags) + tile * 4 + 16;
}

template <class K>
__global__ void __launch_bounds__(kThreads)
    ranks_kernel(const typename K::T* __restrict__ data, int64_t n, Queries<K> q, int64_t qstride,
                 const int32_t* __restrict__ row_proc, int64_t S, int tile, int tiles,
                 const int32_t* __restrict__ row_flags, int32_t* __restrict__ out) {
  using T = typename K::T;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int64_t split[2];
  const int64_t row = blockIdx.x / tiles;
  const int t = static_cast<int>(blockIdx.x % tiles);
  const T* x = data + row * n;
  const int64_t r = row * qstride;
  const Queries<K> qr{q.key + r, q.proc ? q.proc + r : nullptr, q.idx ? q.idx + r : nullptr,
                      q.proc_tag};
  const int32_t me = row_proc ? row_proc[row] : 0;
  int32_t* o = out + row * S;
  int32_t route = kMerge;
  int64_t d0 = 0, d1 = n + S;
  if (tiles == 1) {
    if (threadIdx.x == 0) {
      split[0] = 0;
      split[1] = n;
    }
  } else {
    route = route_of(row_flags[row]);
    if (route != kMerge) {  // the row's tiles share its queries, one thread each
      for (int64_t j = static_cast<int64_t>(t) * kThreads + threadIdx.x; j < S;
           j += static_cast<int64_t>(tiles) * kThreads) {
        const T key = qr.key[j];
        const int32_t qp = qr.p(j), qi = qr.i(j);
        int64_t lo = 0;
        if (route == kSearch) {
          int64_t hi = n;
          while (lo < hi) {
            const int64_t mid = (lo + hi) >> 1;
            if (less<K>(x[mid], mid, key, qp, qi, me)) lo = mid + 1; else hi = mid;
          }
        } else {
          for (int64_t i = 0; i < n; ++i) lo += less<K>(x[i], i, key, qp, qi, me);
        }
        o[j] = static_cast<int32_t>(lo);
      }
      return;
    }
    // the tile's diagonal splits: a run element goes first iff it is less
    d0 = static_cast<int64_t>(t) * tile;
    d1 = min64(d0 + tile, n + S);
    const int warp = threadIdx.x >> 5;
    if (warp < 2) {
      const int64_t d = warp ? d1 : d0;
      const int64_t s = warp_search(max64(0, d - S), min64(d, n), [&](int64_t i) {
        const int64_t j = d - 1 - i;
        return less<K>(x[i], i, qr.key[j], qr.p(j), qr.i(j), me);
      });
      if ((threadIdx.x & 31) == 0) split[warp] = s;
    }
  }
  __syncthreads();
  const int64_t a0 = split[0];
  const int64_t b0 = d0 - a0;
  const int na = static_cast<int>(split[1] - a0);
  const int nb = static_cast<int>(d1 - split[1] - b0);
  const bool tags = q.proc || q.idx;
  T* sa = stage(smem, x + a0, na);
  T* sb = stage(align16(sa + na), qr.key + b0, nb);
  unsigned char* tag_buf = smem + keys_bytes(tile, sizeof(T));
  int32_t* sp = qr.proc ? stage(tag_buf, qr.proc + b0, nb) : nullptr;
  int32_t* si = qr.idx ? stage(tag_buf + tile * 4 + 32, qr.idx + b0, nb) : nullptr;
  int32_t* sr = placed<int32_t>(tag_buf + tags_bytes(tile, tags), o + b0);
  cp_async_wait_all();
  __syncthreads();
  const Queries<K> sq{sb, sp, si, q.proc_tag};
  if (tiles == 1) {  // the whole row is here: its route from its order
    const int32_t bits = order_bits<K>(sa, 0, na - 1, sq, 0, nb - 1);
    const int run_ok = __syncthreads_and(bits & kRunInOrder);
    const int q_ok = __syncthreads_and(bits & kQueriesInOrder);
    route = route_of((run_ok ? kRunInOrder : 0) | (q_ok ? kQueriesInOrder : 0));
  }

  if (route == kMerge) {
    const int items = tile / kThreads;
    const int dd = threadIdx.x * items;
    const int len = na + nb;
    if (dd < len) {
      auto before = [&](int i, int j) {  // run element i goes before query j
        return less<K>(sa[i], a0 + i, sb[j], sq.p(j), sq.i(j), me);
      };
      int lo = max(0, dd - nb), hi = min(dd, na);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (before(mid, dd - 1 - mid)) lo = mid + 1; else hi = mid;
      }
      int i = lo, j = dd - lo;
      const int end = min(dd + items, len);
      for (int k = dd; k < end; ++k) {
        if (j >= nb || (i < na && before(i, j))) {
          ++i;
        } else {
          sr[j] = static_cast<int32_t>(a0 + i);
          ++j;
        }
      }
    }
  } else {  // one tile holding the whole row, out of order
    for (int j = threadIdx.x; j < nb; j += kThreads) {
      const T key = sb[j];
      const int32_t qp = sq.p(j), qi = sq.i(j);
      int lo = 0;
      if (route == kSearch) {
        int hi = na;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (less<K>(sa[mid], mid, key, qp, qi, me)) lo = mid + 1; else hi = mid;
        }
      } else {
        for (int i = 0; i < na; ++i) lo += less<K>(sa[i], i, key, qp, qi, me);
      }
      sr[j] = lo;
    }
  }
  __syncthreads();
  store(o + b0, sr, nb);
}

template <class K>
cudaError_t launch(const void* data, int64_t n, const void* qkey, const int32_t* qproc,
                   int32_t proc_tag, const int32_t* qidx, int64_t qstride,
                   const int32_t* row_proc, int64_t S, int64_t B, int32_t* row_flags,
                   int32_t* out, cudaStream_t stream) {
  using T = typename K::T;
  const Queries<K> q{static_cast<const T*>(qkey), qproc, qidx, proc_tag};
  // tiles of equal size, a multiple of the block, at most kMaxTile items
  const int64_t total = n + S;
  const int64_t tiles = (total + kMaxTile - 1) / kMaxTile;
  const int64_t per = (total + tiles - 1) / tiles;
  const int tile = static_cast<int>((per + kThreads - 1) / kThreads * kThreads);
  const int64_t chunks = (max64(n, S) + kMaxTile - 1) / kMaxTile;
  if (B * tiles > 0x7fffffffLL || B * chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err;
  if (tiles > 1) {
    err = cudaMemsetAsync(row_flags, 0xff, B * sizeof(int32_t), stream);
    if (err != cudaSuccess) return err;
    row_order_kernel<K><<<static_cast<unsigned>(B * chunks), kThreads, 0, stream>>>(
        static_cast<const T*>(data), n, q, qstride, S, static_cast<int>(chunks), row_flags);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int smem = smem_bytes(tile, sizeof(T), qproc || qidx);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(ranks_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  ranks_kernel<K><<<static_cast<unsigned>(B * tiles), kThreads, smem, stream>>>(
      static_cast<const T*>(data), n, q, qstride, row_proc, S, tile, static_cast<int>(tiles),
      row_flags, out);
  return cudaGetLastError();
}

}  // namespace

// data (B, n) rows; qkey (B, S) with rows qstride elements apart (S, or 0
// for one row broadcast over all rows); qproc/qidx laid out as qkey, int32,
// or NULL (then every query's proc is proc_tag and its idx 0); row_proc
// (B,) int32 or NULL (then 0); row_flags (B,) int32 scratch; out (B, S)
// int32. dtype: 0 int32, 1 float32, 3 bfloat16, 4 int64. Returns a
// cudaError_t.
extern "C" int repro_splitter_ranks(const void* data, int64_t n, const void* qkey,
                                    const void* qproc, int proc_tag, const void* qidx,
                                    int64_t qstride, const void* row_proc, int64_t S, int64_t B,
                                    void* row_flags, void* out, int dtype, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || S < 0 || B < 0 || B > 0x7fffffffLL || qstride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B * S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* qp = static_cast<const int32_t*>(qproc);
  const int32_t* qi = static_cast<const int32_t*>(qidx);
  const int32_t* rp = static_cast<const int32_t*>(row_proc);
  int32_t* flags = static_cast<int32_t*>(row_flags);
  int32_t* o = static_cast<int32_t*>(out);
  switch (dtype) {
    case 0: return static_cast<int>(launch<KeyI32>(data, n, qkey, qp, proc_tag, qi, qstride, rp, S, B, flags, o, s));
    case 1: return static_cast<int>(launch<KeyF32>(data, n, qkey, qp, proc_tag, qi, qstride, rp, S, B, flags, o, s));
    case 3: return static_cast<int>(launch<KeyBF16>(data, n, qkey, qp, proc_tag, qi, qstride, rp, S, B, flags, o, s));
    case 4: return static_cast<int>(launch<KeyI64>(data, n, qkey, qp, proc_tag, qi, qstride, rp, S, B, flags, o, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
