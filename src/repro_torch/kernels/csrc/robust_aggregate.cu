// Coordinate-wise robust server aggregation for Hopper (sm_90a):
//
//     out = w_t + A ⊙ agg,   agg_j = mean of ranks [lo, hi) of the sorted
//                                    valid values of column j
//
// where the window is the trimmed mean's (lo = ⌊f32(trim)·f32(m)⌋,
// hi = m − lo) or the median's (lo = (m−1)/2, hi = m/2 + 1) over the m
// valid rows of the (K, d) delta stack, and m = 0 makes no update (agg = 0).
// Replaces the TPU kernel kernels/robust_aggregate.py:robust_aggregate of
// the reference package, which sorted (K, 128) column blocks in VMEM with
// the invalid rows set to +inf.  Here no column is sorted.  Two launches:
//
//   1. robust_compact_kernel: one block scans `valid` once and writes the
//      m valid row indices in order (valid is shared by every column, so
//      the invalid rows are never read again) and m itself;
//   2. robust_select_kernel: each block owns C consecutive columns.  It
//      reads their m valid values from HBM once into shared memory as
//      order-preserving 32-bit keys and finds, for every column, the key
//      at rank lo and the key at rank hi − 1 by a radix select over up to
//      4 digits of 8 bits from the top.  A pass counts the digit of every
//      key that matches an edge's prefix so far (both edges share the
//      passes: while their prefixes agree one histogram serves both, and
//      once they differ a key matches at most one); one warp a column then
//      scans the 256 counts for the bin holding each edge's remaining
//      rank.  The first pass counts during the load, from registers; the
//      others sweep the keys in shared memory, 4 a thread at a time (16-B
//      loads).  Once every column's two edges are each alone in their
//      bins, the passes stop (on N(0, σ²) deltas mostly after 3 digits:
//      the keys left to tell apart are then the edges themselves).  A last
//      sweep sums the window exactly:
//
//        e_lo = e_hi:  (hi − lo)·v(e)
//        otherwise:    Σ v(k) over e_lo < k < e_hi
//                      + (#{k ≤ e_lo} − lo)·v(e_lo) + (hi − #{k < e_hi})·v(e_hi)
//
//      in f32, each thread over its keys in a fixed order and then a fixed
//      tree (shuffles, then the warps in order): no float atomics, the
//      same bits from call to call.  The tails are never subtracted from
//      a total (under ×100 scale faults that cancels).
//
// Histograms: the deltas are ≈ N(0, σ²), so the first digit (the sign and
// the top 7 exponent bits) puts almost every key in 2–4 bins, and one
// shared counter a bin would serialise every warp's atomics.  The counts
// live in hist[bin][lane]: 32 copies of the 256 bins, lane q of every warp
// adding to copy q only.  A warp's 32 atomics then hit 32 distinct words
// in 32 distinct banks whatever the digits (a C-column block maps lane q
// to column q mod C, so copy q belongs to one column), the two edges share
// a word as its low and high 16 bits (a column's count is at most
// m ≤ 32,768), and the reduction over the copies is a conflict-free read
// and a few shuffles a bin.  32 KB a block.
//
// Order: the key of a float is its bits with the sign bit set (positive)
// or all bits flipped (negative), and every NaN gets the largest key, so
// NaN sorts after +inf as in jnp.sort.  The reference sorts the invalid
// rows' +inf between a valid row's +inf and its NaNs; with n_nan NaNs in a
// column, rank r ≥ m − n_nan is +inf if r < K − n_nan and NaN after.  So
// the select runs on ranks [lo, min(hi, m − n_nan)) and the ranks past it
// add +inf or NaN directly (the engine never passes such rows: it drops
// non-finite rows from `valid` first).
//
// Bound: the m valid rows are read once, m·d·4 + K + 3·d·4 bytes: 0.0937 ms
// at m = 3,922 and 0.2389 ms at m = K = 10,000 (d = 20,002, 3.35 TB/s).
// What holds the kernel above it (PERF.md, NVIDIA H100 80GB HBM3, 700 W):
// the load reaches ≈ 1 TB/s, as a block reads only a 16–32 B segment of
// each of m rows: each request an SM keeps in flight carries that little
// (the loads ask L2 for the 256 B around them, so neighbouring blocks find
// the rest of the line there), and the passes, a sweep, a scan and three
// barriers each, come next.
//
// Columns a block (C) and blocks an SM.  A block of C columns holds
// C·m keys (4 B each, rows padded to a multiple of 32 plus 32/C so a
// warp's reads of C columns × 32/C rows fall in distinct banks), the
// 32 KB histogram and C·265 totals.  Coalescing wants C·4 B ≥ 32 B (one
// sector: C = 8); residency wants two blocks an SM (≤ 112 KB each), so
// that one block's HBM load overlaps the other's passes:
//
//   m = 3,922:   C = 8 → 168 KB, one block an SM, 2,501 blocks (19 waves);
//                C = 4 → 101 KB, two an SM, 5,001 blocks (19 waves of
//                pairs), 16-B row segments (the neighbour block reads the
//                other half of each sector, mostly from L2).
//   m = 10,000:  C = 8 → 353 KB: does not fit.  C = 4 → 198 KB, one an
//                SM, 5,001 blocks (38 waves); two an SM only at C = 1
//                (4-B segments).
//   m = 32,768:  C = 1 → 166 KB, one an SM (the capacity; ≈ 49,600 rows
//                would still fit one column).
//
// Measured (PERF.md): at m = 3,922, C = 4 with two blocks an SM takes
// 0.545 ms where C = 8 alone takes 0.600.  Two an SM at m = K would leave
// one column a block, 4 B of each 32-B sector.  So a block takes two an
// SM while that leaves C ≥ 4, else the most columns that fit alone.
#include <atomic>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int COMPACT_THREADS = 1024;
constexpr int THREADS = 512;               // the select's block
constexpr int WARPS = THREADS / 32;
constexpr int MAX_COLS = 8;
constexpr int DIGIT_BITS = 8;
constexpr int BINS = 1 << DIGIT_BITS;
constexpr int PASSES = 32 / DIGIT_BITS;
constexpr int TOT_STRIDE = BINS + BINS / 32 + 1;  // a column's totals
constexpr int MAX_VALID = 32768;           // the wrapper's MAX_VALID
constexpr int MIN_SHARED_COLS = 4;         // the fewest columns two blocks an SM may have
constexpr int SM_SMEM = 233472;            // shared memory an SM (228 KB)
constexpr int BLOCK_SMEM_MAX = 232448;     // the most one block may use
constexpr int BLOCK_RESERVED = 1024;       // the driver's share a block
constexpr int STATIC_SMEM = 1024;          // the kernel's own (704 B), rounded
constexpr uint32_t NAN_KEY = 0xFFFFFFFFu;
constexpr unsigned FULL = 0xffffffffu;

// A read-only load that asks L2 to fetch the 256 B around it: the blocks
// of neighbouring columns read the rest of those lines at about the same
// time, so HBM sees whole lines instead of one sector a block
__device__ __forceinline__ float load_row(const float* p) {
  float v;
  asm("ld.global.nc.L2::256B.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float load_row(const __nv_bfloat16* p) {
  unsigned short v;
  asm("ld.global.nc.L2::256B.b16 %0, [%1];" : "=h"(v) : "l"(p));
  return __bfloat162float(__ushort_as_bfloat16(v));
}

__device__ __forceinline__ uint32_t to_key(float x) {
  if (isnan(x)) return NAN_KEY;
  const uint32_t b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_key(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// a column's keys: m rows padded to a multiple of 32, plus 32/C words so
// that column c starts at bank 32/C·c
constexpr int key_stride(int cols, int m) {
  return (m + 31) / 32 * 32 + 32 / cols;
}

// the totals' words, rounded up so that the keys start 16-B aligned
__host__ __device__ constexpr int tot_words(int cols) {
  return (cols * TOT_STRIDE + 3) / 4 * 4;
}

constexpr size_t smem_bytes(int cols, int m) {
  return sizeof(uint32_t) * (static_cast<size_t>(BINS) * 32 + tot_words(cols) +
                             static_cast<size_t>(cols) * key_stride(cols, m));
}

// The columns a block for m valid rows: two blocks an SM while that
// leaves C ≥ MIN_SHARED_COLS, else the most (≤ 8) that fit one block; 0
// if not even one column fits.
int pick_cols(int m) {
  constexpr size_t most = BLOCK_SMEM_MAX - STATIC_SMEM;
  constexpr size_t half = SM_SMEM / 2 - BLOCK_RESERVED - STATIC_SMEM;
  for (int cols = MAX_COLS; cols >= MIN_SHARED_COLS; cols >>= 1)
    if (smem_bytes(cols, m) <= half) return cols;
  for (int cols = MAX_COLS; cols >= 1; cols >>= 1)
    if (smem_bytes(cols, m) <= most) return cols;
  return 0;
}

// One block: indices of the nonzero entries of valid, in order, and their
// count.  Each thread scans a contiguous run; a block-wide exclusive scan
// of the runs' counts gives each run its first output slot.
__global__ void __launch_bounds__(COMPACT_THREADS)
robust_compact_kernel(const uint8_t* __restrict__ valid, int K,
                      int* __restrict__ idx, int* __restrict__ m_out) {
  __shared__ int warp_total[COMPACT_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (K + COMPACT_THREADS - 1) / COMPACT_THREADS;
  const int begin = min(tid * per, K), end = min(begin + per, K);
  int count = 0;
  for (int i = begin; i < end; ++i) count += valid[i] != 0;
  int incl = count;  // inclusive scan within the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int t = warp_total[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, t, o);
      if (lane >= o) t += y;
    }
    warp_total[lane] = t;  // inclusive over warps
  }
  __syncthreads();
  int slot = incl - count + (warp > 0 ? warp_total[warp - 1] : 0);
  for (int i = begin; i < end; ++i)
    if (valid[i] != 0) idx[slot++] = i;
  if (tid == COMPACT_THREADS - 1) *m_out = slot;
}

// a bin's slot among a column's totals: a word of padding every 32 bins, so
// that lane l reading bins 8l … 8l + 7 hits distinct banks
__device__ __forceinline__ int tot_slot(int b) { return b + (b >> 5); }

// the copies of every bin summed per column into tot (two edges in the
// halves of a word) and zeroed for the next pass; four bins at a time a warp
template <int COLS>
__device__ __forceinline__ void reduce_copies(uint32_t* hist, uint32_t* tot,
                                              int warp, int lane) {
  static_assert(BINS % (4 * WARPS) == 0, "four bins a warp at a time");
  for (int b0 = warp; b0 < BINS; b0 += 4 * WARPS) {
    uint32_t v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v[u] = hist[(b0 + u * WARPS) * 32 + lane];
      hist[(b0 + u * WARPS) * 32 + lane] = 0;
    }
#pragma unroll
    for (int o = 16; o >= COLS; o >>= 1)
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] += __shfl_xor_sync(FULL, v[u], o);
    if (lane < COLS)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        tot[lane * TOT_STRIDE + tot_slot(b0 + u * WARPS)] = v[u];
  }
}

// One warp a column: the bin that holds each edge's remaining rank, from
// the column's totals (lane l sums bins 8l … 8l + 7, one warp scan, then
// the lane whose run holds the rank walks its 8 bins).  The edge's prefix
// gains the bin as its next digit, its rank drops by the keys before, and
// eq gets the bin's count.  True if each edge is alone in its bin.
__device__ __forceinline__ bool find_bins(const uint32_t* col_tot,
                                          uint32_t* prefix, int* rank,
                                          int* eq, int lane) {
  static_assert(BINS == 8 * 32, "eight bins a lane");
  const uint32_t pl = prefix[0], ph = prefix[1];
  const int r0 = rank[0], r1 = rank[1];
  const bool split = pl != ph;  // else both edges count in the low half
  __syncwarp();
  uint32_t t[8], run = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    t[j] = col_tot[tot_slot(8 * lane + j)];
    run += t[j];
  }
  uint32_t incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  uint32_t at = incl - run;  // keys in the bins before this lane's, packed
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t next = at + t[j];
    const int b = 8 * lane + j;
    const int lb = at & 0xFFFF, la = next & 0xFFFF;
    if (lb <= r0 && r0 < la) {
      prefix[0] = (pl << DIGIT_BITS) | b;
      rank[0] = r0 - lb;
      eq[0] = la - lb;
    }
    const int hb = split ? static_cast<int>(at >> 16) : lb;
    const int ha = split ? static_cast<int>(next >> 16) : la;
    if (hb <= r1 && r1 < ha) {
      prefix[1] = (ph << DIGIT_BITS) | b;
      rank[1] = r1 - hb;
      eq[1] = ha - hb;
    }
    at = next;
  }
  __syncwarp();
  return eq[0] == 1 && eq[1] == 1;
}

// Thread t owns column c = t mod C; its lane q = t mod 32 names its
// histogram copy.  It loads the rows t/C + j·(THREADS/C) and sweeps the
// row quads 4(t/C + j·(THREADS/C)) … + 3.  The window's edges per
// column: prefix[c][e] (the digits found so far; after the last pass the
// edge's key), rank[c][e] (its rank among the keys that share the prefix).
// Once every column's two edges are each alone in their bins, the passes
// stop: the sum's sweep picks each edge out by its prefix.
template <typename T, int COLS>
__global__ void __launch_bounds__(THREADS, 2)
robust_select_kernel(const float* __restrict__ w_t, const T* __restrict__ deltas,
                     const float* __restrict__ a, const int* __restrict__ idx,
                     int m, int K, long long d, int lo, int hi, int stride,
                     float* __restrict__ out) {
  constexpr int G = THREADS / COLS;        // threads a column
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* hist = smem;                   // [BINS][32]
  uint32_t* tot = hist + BINS * 32;        // [COLS][TOT_STRIDE]
  uint32_t* keys = tot + tot_words(COLS);  // [COLS][stride], 16-B aligned
  __shared__ uint32_t prefix[MAX_COLS][2];
  __shared__ int rank[MAX_COLS][2];
  __shared__ int eq[MAX_COLS][2], nan_count[MAX_COLS];
  __shared__ uint32_t edge[MAX_COLS][2];
  __shared__ float part[WARPS][MAX_COLS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid % COLS, g = tid / COLS;
  const long long c0 = static_cast<long long>(blockIdx.x) * COLS;
  const long long col = c0 + c;
  uint32_t* ck = keys + c * stride;

  if (m == 0) {  // no valid row: no update
    if (tid < COLS && c0 + tid < d)
      out[c0 + tid] = __fadd_rn(w_t[c0 + tid], __fmul_rn(a[c0 + tid], 0.0f));
    return;
  }
  for (int i = tid; i < BINS * 32; i += THREADS) hist[i] = 0;
  if (tid < COLS) nan_count[tid] = 0;
  __syncthreads();

  // load: a warp reads 32/C rows × C consecutive columns, 8 rows in flight;
  // the first pass counts each key's top digit on the way
  {
    const T* src = deltas + (col < d ? col : 0);
    int nans = 0;
    for (int i0 = g; i0 < m; i0 += 8 * G) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * G;
        v[u] = (i < m && col < d)
                   ? load_row(src + static_cast<long long>(idx[i]) * d) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * G;
        if (i < m) {
          const uint32_t k = to_key(v[u]);
          nans += k == NAN_KEY;
          ck[i] = k;
          atomicAdd(&hist[(k >> (32 - DIGIT_BITS)) * 32 + lane], 1u);
        }
      }
    }
    if (nans) atomicAdd(&nan_count[c], nans);
  }
  __syncthreads();
  if (tid < COLS) {  // the finite ranks [lo, min(hi, m − n_nan)) to select
    const int hf = min(hi, m - nan_count[tid]);
    prefix[tid][0] = prefix[tid][1] = 0;
    rank[tid][0] = hf > lo ? lo : 0;
    rank[tid][1] = hf > lo ? hf - 1 : 0;
  }

  // the digits: the first was counted by the load; each later one counts
  // the digit of the keys matching either edge's prefix
  int digits = 1;
  for (;;) {
    reduce_copies<COLS>(hist, tot, warp, lane);
    __syncthreads();
    bool alone = true;
    if (warp < COLS)
      alone = find_bins(tot + warp * TOT_STRIDE, prefix[warp], rank[warp],
                        eq[warp], lane);
    if (__syncthreads_and(alone) || digits == PASSES) break;
    const int shift = 32 - DIGIT_BITS * digits, low = shift - DIGIT_BITS;
    const uint32_t pl = prefix[c][0], ph = prefix[c][1];
#pragma unroll 2
    for (int i = 4 * g; i < m; i += 4 * G) {
      const uint4 q = *reinterpret_cast<const uint4*>(ck + i);
      const uint32_t k4[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t k = k4[u], high = k >> shift;
        const uint32_t inc = i + u >= m ? 0u
                             : high == pl ? 1u
                             : high == ph ? 0x10000u : 0u;
        if (inc) atomicAdd(&hist[((k >> low) & (BINS - 1)) * 32 + lane], inc);
      }
    }
    ++digits;
    __syncthreads();
  }

  // the keys strictly between the edges' prefixes (after all 4 digits: the
  // edges), then a fixed tree over the column; before the last digit each
  // edge is the one key with its prefix
  const int shift = 32 - DIGIT_BITS * digits;
  const uint32_t pl = prefix[c][0], ph = prefix[c][1];
  float s = 0.0f;
#pragma unroll 2
  for (int i = 4 * g; i < m; i += 4 * G) {
    const uint4 q = *reinterpret_cast<const uint4*>(ck + i);
    const uint32_t k4[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (i + u >= m) continue;
      const uint32_t high = k4[u] >> shift;
      if (high > pl && high < ph) s += from_key(k4[u]);
      if (digits < PASSES && high == pl) edge[c][0] = k4[u];
      if (digits < PASSES && high == ph) edge[c][1] = k4[u];
    }
  }
#pragma unroll
  for (int o = 16; o >= COLS; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  if (lane < COLS) part[warp][lane] = s;
  __syncthreads();
  if (tid < COLS && col < d) {
    const uint32_t el = digits < PASSES ? edge[tid][0] : pl;
    const uint32_t eh = digits < PASSES ? edge[tid][1] : ph;
    float between = 0.0f;
    for (int w = 0; w < WARPS; ++w) between += part[w][tid];
    const int n_nan = nan_count[tid];
    const int hf = min(hi, m - n_nan);
    float sum = 0.0f;
    if (hf > lo) {
      if (el == eh) {
        sum = __fmul_rn(static_cast<float>(hf - lo), from_key(el));
      } else {
        const int le_lo = lo - rank[tid][0] + eq[tid][0];  // #{k ≤ e_lo}
        const int lt_hi = hf - 1 - rank[tid][1];           // #{k < e_hi}
        sum = __fadd_rn(
            __fadd_rn(between, __fmul_rn(static_cast<float>(le_lo - lo),
                                         from_key(el))),
            __fmul_rn(static_cast<float>(hf - lt_hi), from_key(eh)));
      }
    }
    if (hi > hf)  // ranks past the valid finite keys: +inf, then NaN
      sum = __fadd_rn(sum, hi > K - n_nan ? __int_as_float(0x7FC00000)
                                          : __int_as_float(0x7F800000));
    const float agg = __fdiv_rn(sum, static_cast<float>(hi - lo));
    out[col] = __fadd_rn(w_t[col], __fmul_rn(a[col], agg));
  }
}

// the dynamic shared memory above 48 KB and the largest carveout: set once
// a card (the first 64), dtype and column count
template <typename T, int COLS>
cudaError_t prepare() {
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (ready.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(robust_select_kernel<T, COLS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             BLOCK_SMEM_MAX - STATIC_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(robust_select_kernel<T, COLS>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) ready.fetch_or(bit);
  return err;
}

template <typename T, int COLS>
cudaError_t launch(const float* w_t, const void* deltas, const float* a,
                   const int* idx, int m, int K, long long d, int lo, int hi,
                   float* out, cudaStream_t st) {
  cudaError_t err = prepare<T, COLS>();
  if (err != cudaSuccess) return err;
  const long long blocks = (d + COLS - 1) / COLS;
  robust_select_kernel<T, COLS>
      <<<static_cast<unsigned>(blocks), THREADS, smem_bytes(COLS, m), st>>>(
          w_t, static_cast<const T*>(deltas), a, idx, m, K, d, lo, hi,
          key_stride(COLS, m), out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cols(int cols, const float* w_t, const void* deltas,
                        const float* a, const int* idx, int m, int K,
                        long long d, int lo, int hi, float* out,
                        cudaStream_t st) {
  switch (cols) {
    case 8: return launch<T, 8>(w_t, deltas, a, idx, m, K, d, lo, hi, out, st);
    case 4: return launch<T, 4>(w_t, deltas, a, idx, m, K, d, lo, hi, out, st);
    case 2: return launch<T, 2>(w_t, deltas, a, idx, m, K, d, lo, hi, out, st);
    case 1: return launch<T, 1>(w_t, deltas, a, idx, m, K, d, lo, hi, out, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int COLS>
cudaError_t occupancy(int m, int* blocks, int* regs, int* smem) {
  cudaError_t err = prepare<T, COLS>();
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, robust_select_kernel<T, COLS>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, robust_select_kernel<T, COLS>, THREADS, smem_bytes(COLS, m));
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *smem = static_cast<int>(smem_bytes(COLS, m) + attr.sharedSizeBytes);
  return cudaSuccess;
}

template <typename T>
cudaError_t occupancy_cols(int cols, int m, int* blocks, int* regs,
                           int* smem) {
  switch (cols) {
    case 8: return occupancy<T, 8>(m, blocks, regs, smem);
    case 4: return occupancy<T, 4>(m, blocks, regs, smem);
    case 2: return occupancy<T, 2>(m, blocks, regs, smem);
    case 1: return occupancy<T, 1>(m, blocks, regs, smem);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Launch 1: idx (K,) int32 and m_out (1,) int32 on the device.
extern "C" int robust_compact_launch(const void* valid, int K, void* idx,
                                     void* m_out, void* stream) {
  if (K < 1) return static_cast<int>(cudaErrorInvalidValue);
  robust_compact_kernel<<<1, COMPACT_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(valid), K, static_cast<int*>(idx),
      static_cast<int*>(m_out));
  return static_cast<int>(cudaGetLastError());
}

// Launch 2: dtype 0 = float32, 1 = bfloat16 deltas; m ≤ 32,768 valid rows
// listed in idx; [lo, hi) the rank window (0 ≤ lo < hi ≤ m when m > 0).
extern "C" int robust_select_launch(const float* w_t, const void* deltas,
                                    int dtype, const float* a,
                                    const void* idx, int m, int K,
                                    long long d, int lo, int hi, float* out,
                                    void* stream) {
  if (m < 0 || m > MAX_VALID || m > K || d < 1 ||
      (m > 0 && !(0 <= lo && lo < hi && hi <= m)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cols = pick_cols(m);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  if (dtype == 0)
    return static_cast<int>(launch_cols<float>(cols, w_t, deltas, a, ix, m, K,
                                               d, lo, hi, out, st));
  if (dtype == 1)
    return static_cast<int>(launch_cols<__nv_bfloat16>(
        cols, w_t, deltas, a, ix, m, K, d, lo, hi, out, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The select kernel's resources for dtype (0 f32, 1 bf16) at m valid rows:
// the columns a block, resident blocks an SM (the CUDA occupancy
// calculator at its dynamic shared memory), registers a thread, and shared
// memory a block in bytes.
extern "C" int robust_select_occupancy(int dtype, int m, int* cols,
                                       int* blocks, int* regs, int* smem) {
  if (m < 0 || m > MAX_VALID) return static_cast<int>(cudaErrorInvalidValue);
  *cols = pick_cols(m);
  if (dtype == 0)
    return static_cast<int>(occupancy_cols<float>(*cols, m, blocks, regs, smem));
  if (dtype == 1)
    return static_cast<int>(
        occupancy_cols<__nv_bfloat16>(*cols, m, blocks, regs, smem));
  return static_cast<int>(cudaErrorInvalidValue);
}
