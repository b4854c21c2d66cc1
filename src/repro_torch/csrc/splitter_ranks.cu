// K2 — ranks of tagged queries in sorted runs, batched over rows.
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
// Design: one thread per query binary-searches the monotone predicate
// (x_i, me, i) < (q_key, q_proc, q_idx) over the n real elements. Every
// caller passes sorted runs (sorted keys; strictly increasing rank
// positions), so along i the tagged tuple (x_i, me, i) is strictly
// increasing and the predicate is true on a prefix: the search returns
// exactly the masked count, which is already clamped to n. The queries of
// one row share its run, which stays in L2 (at most 316 KB a row).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void splitter_ranks_kernel(const T* __restrict__ data, int64_t n,
                                      const T* __restrict__ qkey,
                                      const int32_t* __restrict__ qproc,
                                      int32_t proc_tag,
                                      const int32_t* __restrict__ qidx,
                                      const int32_t* __restrict__ row_proc,
                                      int64_t S, int64_t B,
                                      int32_t* __restrict__ out) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= B * S) return;
  const int64_t row = q / S;
  const T* x = data + row * n;
  const T key = qkey[q];
  const int32_t qp = qproc ? qproc[q] : proc_tag;
  const int64_t qi = qidx ? qidx[q] : 0;
  const int32_t me = row_proc ? row_proc[row] : 0;
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    const T v = x[mid];
    const bool less = (v < key) || (v == key && (me < qp || (me == qp && mid < qi)));
    if (less) lo = mid + 1; else hi = mid;
  }
  out[q] = static_cast<int32_t>(lo);
}

template <typename T>
cudaError_t launch(const void* data, int64_t n, const void* qkey,
                   const int32_t* qproc, int32_t proc_tag, const int32_t* qidx,
                   const int32_t* row_proc, int64_t S, int64_t B, int32_t* out,
                   cudaStream_t stream) {
  const int64_t blocks = (B * S + kThreads - 1) / kThreads;
  splitter_ranks_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(data), n, static_cast<const T*>(qkey), qproc,
      proc_tag, qidx, row_proc, S, B, out);
  return cudaGetLastError();
}

}  // namespace

// data (B, n) sorted rows; qkey (B, S); qproc/qidx (B, S) int32 or NULL
// (then every query's proc is proc_tag and its idx 0); row_proc (B,) int32
// or NULL (then 0); out (B, S) int32. dtype: 0 = int32, 1 = float32.
extern "C" int repro_splitter_ranks(const void* data, int64_t n, const void* qkey,
                                    const void* qproc, int proc_tag,
                                    const void* qidx, const void* row_proc,
                                    int64_t S, int64_t B, void* out, int dtype,
                                    void* stream) {
  if (n < 0 || S < 0 || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((B * S + kThreads - 1) / kThreads > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B * S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* qp = static_cast<const int32_t*>(qproc);
  const int32_t* qi = static_cast<const int32_t*>(qidx);
  const int32_t* rp = static_cast<const int32_t*>(row_proc);
  int32_t* o = static_cast<int32_t*>(out);
  switch (dtype) {
    case 0: return static_cast<int>(launch<int32_t>(data, n, qkey, qp, proc_tag, qi, rp, S, B, o, s));
    case 1: return static_cast<int>(launch<float>(data, n, qkey, qp, proc_tag, qi, rp, S, B, o, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
