// K1 and K4 — bitonic sort of every row of a (rows, width) tile, keys
// alone (K1) or keys with a value row swapped alongside (K4).
//
// Replaces: src/repro/kernels/bitonic/kernel.py, bitonic_sort_tiles
// (pallas_call body _sort_kernel -> sort_network -> _stage) with
// repro_bitonic_sort_rows, and bitonic_sort_kv_tiles (_sort_kv_kernel ->
// sort_network_kv -> _stage_kv) with repro_bitonic_sort_kv_rows: Batcher's
// bitonic network over each row, width a power of two in [128, 16384].
// Keys int32, uint32, float32 or bfloat16; K4's values are opaque 2-, 4- or
// 8-byte words.
//
// What bounds it on an H100: each row is read once and written once (8
// bytes per 4-byte key, plus the values for K4: 0.020 ms for K1 at
// (512, 16384) over 3.35 TB/s), but the network does width/2 * lg(width) *
// (lg(width)+1)/2 compare-exchanges per row: 105 substages at width 16384.
// The card's limit is the rate of those compare-exchanges (integer or
// float compares and selects, and warp shuffles), so the schedule keeps
// them in registers, keeps barriers out of them and spends as few
// instructions on each as the key type allows.
//
// Schedule. Each thread holds E = 32 keys (and values) of its row in
// registers. In layout A thread t holds indices t*32 .. t*32+31, so index
// bits 0-4 are register bits, bits 5-9 lane bits and the rest warp bits:
// - a substage with stride j < 32 is a compare-exchange of two registers of
//   one thread, fully unrolled (no shared memory, no barrier);
// - a substage with 32 <= j < 1024 pairs lane l with lane l ^ (j/32):
//   __shfl_xor_sync of each register, no barrier;
// - widths up to 1024 therefore sort in one warp per row or less
//   (sort_rows_warp: 8192 keys, 8192/width rows, per CTA);
// - wider rows (sort_rows_cta: one CTA of width/32 threads per row) meet
//   strides j >= 1024 in the stages k >= 2048. For each such stage the row
//   goes once through shared memory into layout B, where register r of
//   thread t holds index r << (lg(width)-5) | t: the index's top five bits
//   are register bits, so the stage's strides >= 1024 are register
//   compare-exchanges again; then back to layout A for the rest of the
//   stage. Two barriers a stage: ten a row at width 16384, loads and stores
//   included, instead of 105.
// - Device memory is read and written through shared memory in an order in
//   which a warp touches 32 consecutive words. Shared memory holds index i
//   at word i + i/32, so the accesses of every layout are free of bank
//   conflicts and are a base register plus a constant (the CTA kernel is
//   built for each width for that).
// - Within a stage both elements of a pair have the direction of their
//   index bit k. Keys are held flipped where it is descending (~x for
//   integer keys, -x for float keys: each reverses the order exactly, NaNs
//   and signed zeros included), so every compare-exchange is an ascending
//   one. Integer keys take min and max (one predicated min/max per
//   shuffled key), and a value moves when its key changed; float keys take
//   the predicate and selects. uint32 keys are held as x ^ 2^31 (int32 in
//   the same order) and bfloat16 keys as the float they widen to.
//
// Why the bytes equal the TPU network's: the kernels run the same
// substages (k, j) in the same order, on the same pairs (i, i ^ j) with the
// same direction (i & k) == 0 and the same predicate swap = ascending ?
// lt(b, a) : lt(a, b), where a is the element at the lower index. Only
// which thread holds which element changes; the compare-exchanges of one
// substage are independent, so any such schedule gives the network's
// bytes, also for keys that compare equal but differ in their bits
// (-0.0/+0.0), for NaNs (which never move) and, for K4, for the order of
// equal keys' values. No min/max touches float keys; for integer keys
// min/max is the predicate and selects (equal integers are the same bits,
// so a key changes exactly when its pair swaps). Both lanes of a shuffle
// evaluate the one predicate on the same (lower, higher) pair, so a NaN or
// a signed zero cannot be duplicated. The network is not stable, and K4
// keeps it so.
#include <stdint.h>

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxWidth = 16384;
constexpr int kMinWidth = 128;
constexpr int kLogE = 5;  // registers a thread holds: index bits 0-4
constexpr int kE = 1 << kLogE;
constexpr int kWarpLog = kLogE + 5;  // index bits 5-9 are lane bits in layout A
constexpr int kChunkThreads = 256;   // sort_rows_warp: 256 threads, 8192 keys a CTA
constexpr int kChunk = kChunkThreads * kE;
constexpr int kCtaThreads = kMaxWidth / kE;

// Shared memory holds row index i at word i + i/32.
__host__ __device__ constexpr size_t padded(int words) {
  return static_cast<size_t>(words + words / 32);
}

// How keys are stored in device memory (T) and held in registers (C);
// flip is an XOR with kFlip or 0, and kFlip reverses C's order exactly.
struct CodecInt {  // int32 keys; uint32 keys with bias 2^31
  using T = uint32_t;
  using C = int32_t;
  static constexpr bool kInt = true;
  static constexpr uint32_t kFlip = 0xffffffffu;
  static __device__ __forceinline__ C load(T x, uint32_t bias) { return static_cast<C>(x ^ bias); }
  static __device__ __forceinline__ T store(C c, uint32_t bias) { return static_cast<T>(c) ^ bias; }
  static __device__ __forceinline__ C flip(C c, uint32_t m) { return c ^ static_cast<C>(m); }
};

struct CodecF32 {
  using T = float;
  using C = float;
  static constexpr bool kInt = false;
  static constexpr uint32_t kFlip = 0x80000000u;
  static __device__ __forceinline__ C load(T x, uint32_t) { return x; }
  static __device__ __forceinline__ T store(C c, uint32_t) { return c; }
  static __device__ __forceinline__ C flip(C c, uint32_t m) {
    return __uint_as_float(__float_as_uint(c) ^ m);
  }
};

// bfloat16 held as its 16 bits; widened to float (exact), narrowed back.
struct CodecBF16 {
  using T = uint16_t;
  using C = float;
  static constexpr bool kInt = false;
  static constexpr uint32_t kFlip = 0x80000000u;
  static __device__ __forceinline__ C load(T x, uint32_t) {
    return __uint_as_float(static_cast<uint32_t>(x) << 16);
  }
  static __device__ __forceinline__ T store(C c, uint32_t) {
    return static_cast<T>(__float_as_uint(c) >> 16);
  }
  static __device__ __forceinline__ C flip(C c, uint32_t m) {
    return __uint_as_float(__float_as_uint(c) ^ m);
  }
};

// K1's stand-in for values: nothing is loaded, moved or stored.
struct NoValue {};
template <class V>
constexpr bool kHasValues = !std::is_same<V, NoValue>::value;
// values in registers and shared memory: 2- and 4-byte words as 32 bits
template <class V>
using Reg = typename std::conditional<
    !kHasValues<V>, NoValue,
    typename std::conditional<sizeof(V) == 8, unsigned long long, uint32_t>::type>::type;
template <class V>
constexpr size_t kRegBytes = kHasValues<V> ? sizeof(Reg<V>) : 0;
// K1 fits two rows of 512 threads on an SM (64 registers a thread); K4 one
template <class V>
constexpr int kMinCtas = kHasValues<V> ? 1 : 2;

template <typename U>
__device__ __forceinline__ U shfl_xor(U x, int mask) {
  return __shfl_xor_sync(0xffffffffu, x, mask);
}

// Ascending compare-exchange of the pair (a at the lower index, b):
// swap = lt(b, a). Integer keys take min and max, and a value moves when
// its key changed: equal integers are the same bits, so a key changes
// exactly when the pair swaps.
template <class Codec, class VR>
__device__ __forceinline__ void cx(typename Codec::C& a, typename Codec::C& b, VR& va, VR& vb) {
  using C = typename Codec::C;
  if constexpr (Codec::kInt) {
    const C lo = min(a, b);
    b = max(a, b);
    if constexpr (kHasValues<VR>) {
      const bool swap = lo != a;
      const VR v = va;
      va = swap ? vb : va;
      vb = swap ? v : vb;
    }
    a = lo;
  } else {
    const bool swap = b < a;
    const C ka = a;
    a = swap ? b : a;
    b = swap ? ka : b;
    if constexpr (kHasValues<VR>) {
      const VR v = va;
      va = swap ? vb : va;
      vb = swap ? v : vb;
    }
  }
}

template <class Codec, class VR>
struct Regs {
  typename Codec::C k[kE];
  VR v[kE];
};

// Stages k = 2 .. 16, inside one thread's 32 keys in layout A: the
// direction (i & k) == 0 is a bit of the register index. A descending
// pair (a, b) is the ascending pair (b, a).
template <class Codec, class VR>
__device__ __forceinline__ void sort_registers(Regs<Codec, VR>& x) {
#pragma unroll
  for (int s = 1; s < kLogE; ++s) {
#pragma unroll
    for (int b = s - 1; b >= 0; --b) {
#pragma unroll
      for (int r = 0; r < kE; ++r) {
        const int q = r | (1 << b);
        if (r & (1 << b)) continue;
        if (r & (1 << s)) cx<Codec, VR>(x.k[q], x.k[r], x.v[q], x.v[r]);
        else cx<Codec, VR>(x.k[r], x.k[q], x.v[r], x.v[q]);
      }
    }
  }
}

// Register bits hi .. lo, high first, of (flipped, ascending) registers.
template <class Codec, class VR>
__device__ __forceinline__ void merge_registers(Regs<Codec, VR>& x, int lo, int hi) {
#pragma unroll
  for (int b = kLogE - 1; b >= 0; --b) {
    if (b < lo || b > hi) continue;
#pragma unroll
    for (int r = 0; r < kE; ++r) {
      if (!(r & (1 << b))) cx<Codec, VR>(x.k[r], x.k[r | (1 << b)], x.v[r], x.v[r | (1 << b)]);
    }
  }
}

// One substage with 32 <= j < 1024 in layout A: lane mask m = j / 32. The
// lower lane (a = mine, b = partner) swaps on lt(partner, mine), the upper
// (a = partner, b = mine) on lt(mine, partner): one predicate, one pair.
template <class Codec, class VR>
__device__ __forceinline__ void merge_lanes(Regs<Codec, VR>& x, int m, bool lower) {
  using C = typename Codec::C;
#pragma unroll
  for (int r = 0; r < kE; ++r) {
    const C p = shfl_xor(x.k[r], m);
    const C mine = x.k[r];
    [[maybe_unused]] bool swap;
    if constexpr (Codec::kInt) {  // as in cx: min or max, the value moves if the key changed
      x.k[r] = lower ? min(mine, p) : max(mine, p);
      swap = x.k[r] != mine;
    } else {
      swap = lower ? p < mine : mine < p;
      x.k[r] = swap ? p : mine;
    }
    if constexpr (kHasValues<VR>) {
      const VR pv = shfl_xor(x.v[r], m);
      x.v[r] = swap ? pv : x.v[r];
    }
  }
}

template <class Codec, class VR>
__device__ __forceinline__ void flip_all(Regs<Codec, VR>& x, uint32_t m) {
#pragma unroll
  for (int r = 0; r < kE; ++r) x.k[r] = Codec::flip(x.k[r], m);
}

template <class Codec, class VR>
__device__ __forceinline__ void put(typename Codec::C* sk, VR* sv, const Regs<Codec, VR>& x,
                                    int w, int r) {
  sk[w] = x.k[r];
  if constexpr (kHasValues<VR>) sv[w] = x.v[r];
}

template <class Codec, class VR>
__device__ __forceinline__ void get(const typename Codec::C* sk, const VR* sv,
                                    Regs<Codec, VR>& x, int w, int r) {
  x.k[r] = sk[w];
  if constexpr (kHasValues<VR>) x.v[r] = sv[w];
}

// Shared-memory words of register r. Layout A: index t*32 + r at word
// t*33 + r. Layout B of a row of 2^kN: index r << hb | t (hb = kN - 5) at
// word (r << hb) + (r << (hb - 5)) + t + t/32. Both are a per-thread base
// (a_base = 33t, b_base = t + t/32) plus a constant.
__device__ __forceinline__ int word_a(int a_base, int r) { return a_base + r; }
template <int kN>
__device__ __forceinline__ int word_b(int b_base, int r) {
  return b_base + (r << (kN - kLogE)) + (r << (kN - 2 * kLogE));
}

// Stages k = 32 .. 2^n in layout A, from raw keys to raw keys; each stage
// holds its descending keys flipped. kN > 10 (one CTA per row of 2^kN): a
// stage's substages j >= 1024 run first, in layout B. A thread reads back
// in a layout exactly the words it wrote in that layout, so two barriers a
// wide stage suffice.
template <class Codec, class VR, int kN>
__device__ __forceinline__ void merge_stages(Regs<Codec, VR>& x, int t, int n,
                                             typename Codec::C* sk, VR* sv) {
  uint32_t held = 0;  // the flip the registers hold
  for (int s = kLogE; s <= n; ++s) {
    const uint32_t f = ((t << kLogE) >> s) & 1 ? Codec::kFlip : 0u;
    flip_all(x, f ^ held);
    held = f;
    if constexpr (kN > kWarpLog) {
      if (s - 1 >= kWarpLog) {
        const int a_base = t * (kE + 1), b_base = t + (t >> kLogE);
#pragma unroll
        for (int r = 0; r < kE; ++r) put(sk, sv, x, word_a(a_base, r), r);
        __syncthreads();
#pragma unroll
        for (int r = 0; r < kE; ++r) get(sk, sv, x, word_b<kN>(b_base, r), r);
        // register bit c is index bit c + kN - 5: the bits in [10, s - 1]
        merge_registers(x, kWarpLog - (kN - kLogE), s - 1 - (kN - kLogE));
#pragma unroll
        for (int r = 0; r < kE; ++r) put(sk, sv, x, word_b<kN>(b_base, r), r);
        __syncthreads();
#pragma unroll
        for (int r = 0; r < kE; ++r) get(sk, sv, x, word_a(a_base, r), r);
      }
    }
    for (int b = min(s - 1, kWarpLog - 1); b >= kLogE; --b) {
      const int m = 1 << (b - kLogE);
      merge_lanes(x, m, !(t & m));
    }
    merge_registers(x, 0, kLogE - 1);
  }
  flip_all(x, held);
}

// Widths 128 .. 1024: width/32 lanes per row, 8192 keys (8192 / width rows)
// per CTA of 256 threads.
template <class Codec, class V>
__global__ void __launch_bounds__(kChunkThreads)
    sort_rows_warp(const typename Codec::T* __restrict__ kin, const V* __restrict__ vin,
                   typename Codec::T* __restrict__ kout, V* __restrict__ vout, int64_t rows, int n,
                   uint32_t bias) {
  using C = typename Codec::C;
  using VR = Reg<V>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  VR* sv = reinterpret_cast<VR*>(smem_raw);  // values first: 8-byte aligned
  C* sk = reinterpret_cast<C*>(smem_raw + kRegBytes<V> * padded(kChunk));
  const int tid = threadIdx.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kChunk;
  const int64_t left = (rows << n) - first;  // keys from `first` to the end
  // coalesced: chunk index q*256 + tid at word q*264 + tid + tid/32
  const int c_base = tid + (tid >> kLogE);
#pragma unroll
  for (int q = 0; q < kE; ++q) {
    const int i = q * kChunkThreads + tid;
    const int w = c_base + q * (kChunkThreads + kChunkThreads / 32);
    if (i < left) {
      sk[w] = Codec::load(kin[first + i], bias);
      if constexpr (kHasValues<V>) sv[w] = static_cast<VR>(vin[first + i]);
    }
  }
  __syncthreads();
  Regs<Codec, VR> x;
  const int a_base = tid * (kE + 1);
#pragma unroll
  for (int r = 0; r < kE; ++r) get(sk, sv, x, word_a(a_base, r), r);
  // rows are aligned groups of width/32 lanes; rows past the end sort
  // whatever the shared memory holds and are not stored
  const int t = tid & ((1 << (n - kLogE)) - 1);
  sort_registers(x);
  merge_stages<Codec, VR, kWarpLog>(x, t, n, nullptr, nullptr);
#pragma unroll
  for (int r = 0; r < kE; ++r) put(sk, sv, x, word_a(a_base, r), r);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kE; ++q) {
    const int i = q * kChunkThreads + tid;
    const int w = c_base + q * (kChunkThreads + kChunkThreads / 32);
    if (i < left) {
      kout[first + i] = Codec::store(sk[w], bias);
      if constexpr (kHasValues<V>) vout[first + i] = static_cast<V>(sv[w]);
    }
  }
}

// Widths 2048 .. 16384 (2^kN): one CTA of width/32 threads per row.
template <class Codec, class V, int kN>
__global__ void __launch_bounds__(kCtaThreads, kMinCtas<V>)
    sort_rows_cta(const typename Codec::T* __restrict__ kin, const V* __restrict__ vin,
                  typename Codec::T* __restrict__ kout, V* __restrict__ vout, uint32_t bias) {
  using C = typename Codec::C;
  using VR = Reg<V>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  VR* sv = reinterpret_cast<VR*>(smem_raw);  // values first: 8-byte aligned
  C* sk = reinterpret_cast<C*>(smem_raw + kRegBytes<V> * padded(1 << kN));
  const int t = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) << kN;
  const int a_base = t * (kE + 1), b_base = t + (t >> kLogE);
  // coalesced loads in layout B (a warp reads 32 consecutive words)
#pragma unroll
  for (int r = 0; r < kE; ++r) {
    const int i = (r << (kN - kLogE)) + t;
    sk[word_b<kN>(b_base, r)] = Codec::load(kin[base + i], bias);
    if constexpr (kHasValues<V>) sv[word_b<kN>(b_base, r)] = static_cast<VR>(vin[base + i]);
  }
  __syncthreads();
  Regs<Codec, VR> x;
#pragma unroll
  for (int r = 0; r < kE; ++r) get(sk, sv, x, word_a(a_base, r), r);
  sort_registers(x);
  merge_stages<Codec, VR, kN>(x, t, kN, sk, sv);
#pragma unroll
  for (int r = 0; r < kE; ++r) put(sk, sv, x, word_a(a_base, r), r);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kE; ++r) {
    const int i = (r << (kN - kLogE)) + t;
    kout[base + i] = Codec::store(sk[word_b<kN>(b_base, r)], bias);
    if constexpr (kHasValues<V>) vout[base + i] = static_cast<V>(sv[word_b<kN>(b_base, r)]);
  }
}

// Each launcher raises its kernel's shared-memory limit once (a static).
template <class Codec, class V, int kN>
cudaError_t launch_cta(const typename Codec::T* ki, const V* vi, typename Codec::T* ko, V* vo,
                       int64_t rows, uint32_t bias, cudaStream_t stream) {
  constexpr size_t smem = padded(1 << kN) * (sizeof(typename Codec::C) + kRegBytes<V>);
  static const cudaError_t attr = cudaFuncSetAttribute(
      sort_rows_cta<Codec, V, kN>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  sort_rows_cta<Codec, V, kN><<<static_cast<unsigned>(rows), (1 << kN) / kE, smem, stream>>>(
      ki, vi, ko, vo, bias);
  return cudaGetLastError();
}

template <class Codec, class V>
cudaError_t launch_warp(const typename Codec::T* ki, const V* vi, typename Codec::T* ko, V* vo,
                        int64_t rows, int n, uint32_t bias, cudaStream_t stream) {
  constexpr size_t smem = padded(kChunk) * (sizeof(typename Codec::C) + kRegBytes<V>);
  static const cudaError_t attr = cudaFuncSetAttribute(
      sort_rows_warp<Codec, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const unsigned grid = static_cast<unsigned>(((rows << n) + kChunk - 1) / kChunk);
  sort_rows_warp<Codec, V><<<grid, kChunkThreads, smem, stream>>>(ki, vi, ko, vo, rows, n, bias);
  return cudaGetLastError();
}

template <class Codec, class V>
cudaError_t launch(const void* kin, const void* vin, void* kout, void* vout, int64_t rows,
                   int width, uint32_t bias, cudaStream_t stream) {
  using T = typename Codec::T;
  int n = 0;
  while ((1 << n) < width) ++n;
  const T* ki = static_cast<const T*>(kin);
  const V* vi = static_cast<const V*>(vin);
  T* ko = static_cast<T*>(kout);
  V* vo = static_cast<V*>(vout);
  switch (n) {
    case 11: return launch_cta<Codec, V, 11>(ki, vi, ko, vo, rows, bias, stream);
    case 12: return launch_cta<Codec, V, 12>(ki, vi, ko, vo, rows, bias, stream);
    case 13: return launch_cta<Codec, V, 13>(ki, vi, ko, vo, rows, bias, stream);
    case 14: return launch_cta<Codec, V, 14>(ki, vi, ko, vo, rows, bias, stream);
    default: return launch_warp<Codec, V>(ki, vi, ko, vo, rows, n, bias, stream);
  }
}

// dtype: 0 int32, 1 float32, 2 uint32, 3 bfloat16
template <class V>
cudaError_t launch_dtype(const void* kin, const void* vin, void* kout, void* vout, int64_t rows,
                         int width, int dtype, cudaStream_t s) {
  switch (dtype) {
    case 0: return launch<CodecInt, V>(kin, vin, kout, vout, rows, width, 0u, s);
    case 1: return launch<CodecF32, V>(kin, vin, kout, vout, rows, width, 0u, s);
    case 2: return launch<CodecInt, V>(kin, vin, kout, vout, rows, width, 0x80000000u, s);
    case 3: return launch<CodecBF16, V>(kin, vin, kout, vout, rows, width, 0u, s);
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
  return static_cast<int>(launch_dtype<NoValue>(in, nullptr, out, nullptr, rows, width, dtype,
                                                static_cast<cudaStream_t>(stream)));
}

// Keys as for repro_bitonic_sort_rows; values (rows, width) of words of
// value_bytes (2, 4 or 8). Returns a cudaError_t.
extern "C" int repro_bitonic_sort_kv_rows(const void* kin, const void* vin, void* kout,
                                          void* vout, int64_t rows, int width, int dtype,
                                          int value_bytes, void* stream) {
  if (bad_shape(rows, width)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (value_bytes) {
    case 2: return static_cast<int>(launch_dtype<uint16_t>(kin, vin, kout, vout, rows, width, dtype, s));
    case 4: return static_cast<int>(launch_dtype<uint32_t>(kin, vin, kout, vout, rows, width, dtype, s));
    case 8: return static_cast<int>(launch_dtype<unsigned long long>(kin, vin, kout, vout, rows, width, dtype, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
