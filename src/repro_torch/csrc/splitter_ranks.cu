// K2 — ranks of tagged queries in runs, batched over rows.
//
// Replaces: src/repro/kernels/searchsorted/kernel.py, splitter_ranks
// (pallas_call body _ranks_kernel): for each query (key, proc, idx), the
// number of run elements (x_i, me, i) lexicographically smaller, computed
// there as a masked count over 2048-wide blocks — O(n * S) work.
//
// What bounds it on an H100: on the main path S is about n (the Ph6 rank
// merges rank every element of one run in the other, and every output
// slot in the rank positions), so the masked count would be quadratic in
// the merge width (n up to 79008 per processor at the full-width
// configuration). The least work is S * ceil(lg(n+1)) comparisons on
// n + 2S words of traffic per row.
//
// Design: one thread per query binary-searches the predicate
// (x_i, me, i) < (q_key, q_proc, q_idx) over the n real elements. Where
// the row is sorted with any NaNs last, (x_i, me, i) only grows along i
// and the predicate is true on a prefix, so the search returns exactly
// the masked count, already clamped to n. Every caller passes such rows,
// except where NaN keys reach a key-value merge: a NaN ranks 0 there, its
// rank positions stop growing, and the next round's row is out of order.
// So a first kernel checks each row's order (one CTA per row, one pass
// over it), and the queries of a row that fails count element by element,
// as the TPU kernel does. The queries of one row share its run, which
// stays in L2 (at most 316 KB a row).
#include "keys.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;

// row_ok[row] = 1 iff along the row every element is <= the next, or the
// next is NaN and so is everything after it.
template <class K>
__global__ void row_order_kernel(const typename K::T* __restrict__ data, int64_t n,
                                 int32_t* __restrict__ row_ok) {
  const typename K::T* x = data + static_cast<int64_t>(blockIdx.x) * n;
  int ok = 1;
  for (int64_t i = threadIdx.x; i + 1 < n; i += blockDim.x) {
    const typename K::T a = x[i];
    const typename K::T b = x[i + 1];
    ok &= K::isnan(b) || (!K::isnan(a) && !K::lt(b, a));
  }
  ok = __syncthreads_and(ok);
  if (threadIdx.x == 0) row_ok[blockIdx.x] = ok;
}

template <class K>
__global__ void splitter_ranks_kernel(const typename K::T* __restrict__ data, int64_t n,
                                      const typename K::T* __restrict__ qkey,
                                      const int32_t* __restrict__ qproc, int32_t proc_tag,
                                      const int32_t* __restrict__ qidx,
                                      const int32_t* __restrict__ row_proc, int64_t S,
                                      int64_t B, const int32_t* __restrict__ row_ok,
                                      int32_t* __restrict__ out) {
  using T = typename K::T;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= B * S) return;
  const int64_t row = q / S;
  const T* x = data + row * n;
  const T key = qkey[q];
  const int32_t qp = qproc ? qproc[q] : proc_tag;
  const int64_t qi = qidx ? qidx[q] : 0;
  const int32_t me = row_proc ? row_proc[row] : 0;
  const bool tag_less = me < qp;
  const bool tag_eq = me == qp;
  int64_t lo = 0;
  if (row_ok[row]) {
    int64_t hi = n;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      const T v = x[mid];
      const bool less = K::lt(v, key) || (K::eq(v, key) && (tag_less || (tag_eq && mid < qi)));
      if (less) lo = mid + 1; else hi = mid;
    }
  } else {
    for (int64_t i = 0; i < n; ++i) {
      const T v = x[i];
      lo += K::lt(v, key) || (K::eq(v, key) && (tag_less || (tag_eq && i < qi)));
    }
  }
  out[q] = static_cast<int32_t>(lo);
}

template <class K>
cudaError_t launch(const void* data, int64_t n, const void* qkey, const int32_t* qproc,
                   int32_t proc_tag, const int32_t* qidx, const int32_t* row_proc, int64_t S,
                   int64_t B, int32_t* row_ok, int32_t* out, cudaStream_t stream) {
  using T = typename K::T;
  row_order_kernel<K><<<static_cast<unsigned>(B), kThreads, 0, stream>>>(
      static_cast<const T*>(data), n, row_ok);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t blocks = (B * S + kThreads - 1) / kThreads;
  splitter_ranks_kernel<K><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(data), n, static_cast<const T*>(qkey), qproc, proc_tag, qidx,
      row_proc, S, B, row_ok, out);
  return cudaGetLastError();
}

}  // namespace

// data (B, n) rows; qkey (B, S); qproc/qidx (B, S) int32 or NULL (then
// every query's proc is proc_tag and its idx 0); row_proc (B,) int32 or
// NULL (then 0); row_ok (B,) int32 scratch; out (B, S) int32. dtype: 0
// int32, 1 float32, 3 bfloat16. Returns a cudaError_t.
extern "C" int repro_splitter_ranks(const void* data, int64_t n, const void* qkey,
                                    const void* qproc, int proc_tag, const void* qidx,
                                    const void* row_proc, int64_t S, int64_t B, void* row_ok,
                                    void* out, int dtype, void* stream) {
  if (n < 0 || S < 0 || B < 0 || B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if ((B * S + kThreads - 1) / kThreads > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B * S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* qp = static_cast<const int32_t*>(qproc);
  const int32_t* qi = static_cast<const int32_t*>(qidx);
  const int32_t* rp = static_cast<const int32_t*>(row_proc);
  int32_t* ok = static_cast<int32_t*>(row_ok);
  int32_t* o = static_cast<int32_t*>(out);
  switch (dtype) {
    case 0: return static_cast<int>(launch<KeyI32>(data, n, qkey, qp, proc_tag, qi, rp, S, B, ok, o, s));
    case 1: return static_cast<int>(launch<KeyF32>(data, n, qkey, qp, proc_tag, qi, rp, S, B, ok, o, s));
    case 3: return static_cast<int>(launch<KeyBF16>(data, n, qkey, qp, proc_tag, qi, rp, S, B, ok, o, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
