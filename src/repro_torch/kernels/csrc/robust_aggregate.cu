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
// the invalid rows set to +inf.  Here, in two launches:
//
//   1. robust_compact_kernel: one block scans `valid` once and writes the
//      m valid row indices in order (valid is shared by every column, so
//      the invalid rows are never read again) and m itself;
//   2. robust_sort_kernel: each block owns C consecutive columns.  It loads
//      their m valid values into shared memory as order-preserving 32-bit
//      keys (a warp reads C consecutive columns of 32/C rows, so a row's
//      segment is one contiguous read), pads each column with +inf keys to
//      the next power of two P, bitonic-sorts every column, and sums the
//      rank window in f32.  C·P ≤ 32,768 keys (128 KB of dynamic shared
//      memory): C = 8 columns up to P = 4,096, down to one column at
//      P = 32,768, the largest m the kernel takes (the wrapper raises
//      beyond it; the m and the window come from the wrapper, which reads
//      m back after launch 1).
//
// Order: the key of a float is its bits with the sign bit set (positive)
// or all bits flipped (negative), and every NaN gets the largest key, so
// NaN sorts after +inf as in jnp.sort.  The reference sorts the invalid
// rows' +inf between a valid row's +inf and its NaNs; with n_nan NaNs in a
// column, rank r ≥ m − n_nan is +inf if r < K − n_nan and NaN after, which
// the sum applies directly (the engine never passes such rows: it drops
// non-finite rows from `valid` first).
//
// Bound: the stack is read once, (K·d·4 + K + 3·d·4) bytes at K = 10,000,
// d = 20,002 is 0.239 ms at 3.35 TB/s.  This simple kernel is bound by the
// sort instead: log2(P)(log2(P)+1)/2 compare-exchange stages of C·P/2 pairs
// in shared memory a block.  A radix select of the two window edges would
// do O(m) work a column.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int MAX_COLS = 8;
constexpr int MAX_KEYS = 32768;          // C·P, the keys a block sorts
constexpr uint32_t PAD_KEY = 0xFF800000u;  // the key of +inf
constexpr uint32_t NAN_KEY = 0xFFFFFFFFu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint32_t to_key(float x) {
  if (isnan(x)) return NAN_KEY;
  const uint32_t b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_key(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// One block: indices of the nonzero entries of valid, in order, and their
// count.  Each thread scans a contiguous run; a block-wide exclusive scan
// of the runs' counts gives each run its first output slot.
__global__ void __launch_bounds__(THREADS)
robust_compact_kernel(const uint8_t* __restrict__ valid, int K,
                      int* __restrict__ idx, int* __restrict__ m_out) {
  __shared__ int warp_total[THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (K + THREADS - 1) / THREADS;
  const int begin = min(tid * per, K), end = min(begin + per, K);
  int count = 0;
  for (int i = begin; i < end; ++i) count += valid[i] != 0;
  int incl = count;  // inclusive scan within the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int t = warp_total[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    warp_total[lane] = t;  // inclusive over warps
  }
  __syncthreads();
  int slot = incl - count + (warp > 0 ? warp_total[warp - 1] : 0);
  for (int i = begin; i < end; ++i)
    if (valid[i] != 0) idx[slot++] = i;
  if (tid == THREADS - 1) *m_out = slot;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
robust_sort_kernel(const float* __restrict__ w_t, const T* __restrict__ deltas,
                   const float* __restrict__ a, const int* __restrict__ idx,
                   int m, int K, long long d, int log_p, int cols, int lo,
                   int hi, float* __restrict__ out) {
  extern __shared__ uint32_t keys[];      // column c at keys + c·(P + 1)
  __shared__ int nan_count[MAX_COLS];
  __shared__ float partial[THREADS / 32];
  const int P = 1 << log_p, stride = P + 1;  // odd stride: no bank conflicts
  const long long c0 = static_cast<long long>(blockIdx.x) * cols;
  const int tid = threadIdx.x;
  if (tid < cols) nan_count[tid] = 0;
  __syncthreads();

  // load: thread tid takes column tid % cols of rows tid / cols + k·(THREADS / cols)
  {
    const int c = tid % cols;
    const long long col = c0 + c;
    uint32_t* ck = keys + c * stride;
    for (int i = tid / cols; i < P; i += THREADS / cols) {
      uint32_t k = PAD_KEY;
      if (i < m && col < d) {
        k = to_key(to_f32(deltas[static_cast<long long>(idx[i]) * d + col]));
        if (k == NAN_KEY) atomicAdd(&nan_count[c], 1);
      }
      ck[i] = k;
    }
  }
  __syncthreads();

  // bitonic sort of every column, ascending
  const int half = P >> 1;
  const int pairs = cols * half;
  for (int size = 2; size <= P; size <<= 1) {
    for (int s = size >> 1; s > 0; s >>= 1) {
      for (int t = tid; t < pairs; t += THREADS) {
        const int c = t >> (log_p - 1);
        const int j = t & (half - 1);
        const int i = ((j & ~(s - 1)) << 1) | (j & (s - 1));
        uint32_t* ck = keys + c * stride;
        const uint32_t x = ck[i], y = ck[i + s];
        if ((x > y) == ((i & size) == 0)) {
          ck[i] = y;
          ck[i + s] = x;
        }
      }
      __syncthreads();
    }
  }

  // the window's sum, THREADS / cols threads (whole warps) a column
  const int per_col = THREADS / cols;
  const int c = tid / per_col;
  const int n_nan = nan_count[c];
  const uint32_t* ck = keys + c * stride;
  float sum = 0.0f;
  for (int r = lo + tid % per_col; r < hi; r += per_col) {
    float v;
    if (r >= m - n_nan) v = r < K - n_nan ? __int_as_float(0x7F800000) : __int_as_float(0x7FC00000);
    else v = from_key(ck[r]);
    sum += v;
  }
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, o);
  if ((tid & 31) == 0) partial[tid >> 5] = sum;
  __syncthreads();
  if (tid < cols && c0 + tid < d) {
    const int warps = per_col / 32;
    float s = 0.0f;
    for (int k = 0; k < warps; ++k) s += partial[tid * warps + k];
    const float agg = m > 0 ? __fdiv_rn(s, static_cast<float>(max(hi - lo, 1))) : 0.0f;
    const long long col = c0 + tid;
    out[col] = __fadd_rn(w_t[col], __fmul_rn(a[col], agg));
  }
}

template <typename T>
int launch_sort(const float* w_t, const void* deltas, const float* a,
                const int* idx, int m, int K, long long d, int log_p,
                int lo, int hi, float* out, cudaStream_t st) {
  const int P = 1 << log_p;
  int cols = MAX_KEYS / P;
  cols = cols > MAX_COLS ? MAX_COLS : (cols < 1 ? 1 : cols);
  const size_t smem = static_cast<size_t>(cols) * (P + 1) * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      robust_sort_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (d + cols - 1) / cols;
  robust_sort_kernel<T><<<static_cast<unsigned>(blocks), THREADS, smem, st>>>(
      w_t, static_cast<const T*>(deltas), a, idx, m, K, d, log_p, cols, lo, hi,
      out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch 1: idx (K,) int32 and m_out (1,) int32 on the device.
extern "C" int robust_compact_launch(const void* valid, int K, void* idx,
                                     void* m_out, void* stream) {
  if (K < 1) return static_cast<int>(cudaErrorInvalidValue);
  robust_compact_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(valid), K, static_cast<int*>(idx),
      static_cast<int*>(m_out));
  return static_cast<int>(cudaGetLastError());
}

// Launch 2: dtype 0 = float32, 1 = bfloat16 deltas; m valid rows listed in
// idx; P = 2^log_p ≥ m, at most 32,768; [lo, hi) the rank window.
extern "C" int robust_sort_launch(const float* w_t, const void* deltas,
                                  int dtype, const float* a, const void* idx,
                                  int m, int K, long long d, int log_p, int lo,
                                  int hi, float* out, void* stream) {
  if (log_p < 0 || (1 << log_p) > MAX_KEYS || m > (1 << log_p) || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  if (dtype == 0)
    return launch_sort<float>(w_t, deltas, a, ix, m, K, d, log_p, lo, hi, out, st);
  if (dtype == 1)
    return launch_sort<__nv_bfloat16>(w_t, deltas, a, ix, m, K, d, log_p, lo, hi, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
