// Delta-native fused server aggregation (Alg. 4 line 11) for Hopper (sm_90a):
//
//     out = w^t + A ⊙ (s · Σ_k weights_k · δ_k),    δ: (K, d) f32 or bf16
//
// Replaces the TPU kernel kernels/scaled_aggregate.py:fused_aggregate of the
// reference package.  There the K loop ran in order on one core with the
// output tile resident in VMEM.  Here blocks run in parallel, so the sum
// over K is cut into splits whose partial sums are added in a fixed order,
// with no floating-point atomics: the result is bit-equal from call to call.
//
// Bound: the function reads the K·d deltas once (800 MB in f32 at the
// paper's K = 10,000, d = 20,002), so it is bound by HBM bandwidth.  The
// design keeps every resident warp streaming until the end:
//
//   * the unit of work is one warp on a strip of 32·VEC neighbouring columns
//     and one split of K rows; VEC = 2 when every row starts 8-byte aligned
//     (d even: the paper's 80,008-byte rows are 8- but not 16-byte aligned),
//     so each lane loads a float2 (bf16: a bf16x2) a row, UNROLL rows ahead;
//   * the caller sizes the splits from the card's SM count and this
//     kernel's occupancy so that all units fit in one wave of resident
//     warps and each gets an equal share of rows (313 strips × 26 splits of
//     385 rows = 8,138 units for 8,448 warp slots at the paper's shape);
//     the old grid of 1,106 blocks for 1,056 slots left a tail wave;
//   * a second small launch adds the partials in split order 0..splits-1
//     and applies the epilogue (one split writes the output directly).  A
//     finish folded into the first launch by a last-arrival counter a strip
//     measured no faster at the paper's shape on the H100, and its counters
//     would be state carried across calls that a faulted launch corrupts.
//
// fused_epilogue_launch is the epilogue alone, w^t + A ⊙ (s · acc), one
// thread per column: one launch, no scratch.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;            // 8 warps, 8 units a block
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;               // rows loaded ahead by each lane

template <typename T, int VEC> struct Loader;

template <> struct Loader<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* x) {
    x[0] = __ldcs(p);
  }
};
template <> struct Loader<float, 2> {
  static __device__ __forceinline__ void load(const float* p, float* x) {
    const float2 v = __ldcs(reinterpret_cast<const float2*>(p));
    x[0] = v.x;
    x[1] = v.y;
  }
};
template <> struct Loader<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* x) {
    x[0] = __bfloat162float(__ldcs(p));
  }
};
template <> struct Loader<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* x) {
    const __nv_bfloat162 v = __ldcs(reinterpret_cast<const __nv_bfloat162*>(p));
    x[0] = __low2float(v);
    x[1] = __high2float(v);
  }
};

// a == nullptr: the identity epilogue w^t + acc (fused_accumulate)
__device__ __forceinline__ float epilogue(const float* w_t, const float* a,
                                          float scale, int64_t c, float acc) {
  return a == nullptr ? w_t[c] + acc : w_t[c] + a[c] * (scale * acc);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
aggregate_kernel(const T* __restrict__ deltas, const float* __restrict__ weights,
                 const float* __restrict__ w_t, const float* __restrict__ a,
                 const float* __restrict__ scale_ptr, float scale_value,
                 float* __restrict__ partial, float* __restrict__ out,
                 int64_t K, int64_t d, int64_t strips,
                 int64_t splits, int64_t rows_per_split) {
  const int lane = threadIdx.x & 31;
  const int64_t unit = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (unit >= strips * splits) return;               // the whole warp
  const int64_t strip = unit % strips;               // neighbouring warps of a
  const int64_t split = unit / strips;               // block: neighbouring strips
  const int64_t col = (strip * 32 + lane) * VEC;     // VEC = 2: d is even
  const bool active = col < d;
  const int64_t k0 = split * rows_per_split;
  const int64_t k1 = k0 + rows_per_split < K ? k0 + rows_per_split : K;

  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
  if (active) {
    const T* p = deltas + k0 * d + col;
    int64_t k = k0;
    for (; k + UNROLL <= k1; k += UNROLL) {
      float x[UNROLL][VEC];
      float wk[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        Loader<T, VEC>::load(p + u * d, x[u]);
        wk[u] = __ldg(weights + k + u);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] = fmaf(wk[u], x[u][v], acc[v]);
      p += UNROLL * d;
    }
    for (; k < k1; ++k) {
      float x[VEC];
      Loader<T, VEC>::load(p, x);
      const float wk = __ldg(weights + k);
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = fmaf(wk, x[v], acc[v]);
      p += d;
    }
  }
  const float scale = scale_ptr != nullptr ? scale_ptr[0] : scale_value;
  if (splits == 1) {
    if (active) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) out[col + v] = epilogue(w_t, a, scale, col + v, acc[v]);
    }
    return;
  }
  if (active) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) partial[split * d + col + v] = acc[v];
  }
}

// the second launch: the splits' partial sums added in split order
__global__ void __launch_bounds__(THREADS)
finish_kernel(const float* __restrict__ partial, int64_t splits,
              const float* __restrict__ w_t, const float* __restrict__ a,
              const float* __restrict__ scale_ptr, float scale_value,
              float* __restrict__ out, int64_t d) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (col >= d) return;
  float sum = 0.0f;
  for (int64_t s = 0; s < splits; ++s) sum += partial[s * d + col];
  const float scale = scale_ptr != nullptr ? scale_ptr[0] : scale_value;
  out[col] = epilogue(w_t, a, scale, col, sum);
}

__global__ void __launch_bounds__(THREADS)
epilogue_kernel(const float* __restrict__ w_t, const float* __restrict__ acc,
                const float* __restrict__ a, const float* __restrict__ scale_ptr,
                float scale_value, float* __restrict__ out, int64_t d) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (col >= d) return;
  const float scale = scale_ptr != nullptr ? scale_ptr[0] : scale_value;
  out[col] = w_t[col] + a[col] * (scale * acc[col]);
}

template <typename T, int VEC>
cudaError_t launch(const void* deltas, const float* weights, const float* w_t,
                   const float* a, const float* scale_ptr, float scale_value,
                   float* partial, float* out, long long K, long long d,
                   long long strips, long long splits, long long rows_per_split,
                   cudaStream_t s) {
  const long long blocks = (strips * splits + WARPS - 1) / WARPS;
  aggregate_kernel<T, VEC><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
      static_cast<const T*>(deltas), weights, w_t, a, scale_ptr, scale_value,
      partial, out, K, d, strips, splits, rows_per_split);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t occupancy(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, aggregate_kernel<T, VEC>, THREADS, 0);
}

}  // namespace

// dtype: 0 = float32 deltas, 1 = bfloat16; vec: 1 or 2 columns a lane (2
// needs d even and an aligned base).  a == null: the identity epilogue.
// scale_ptr may be null, and then scale_value is used.  partial: a
// (splits, d) f32 scratch.  Returns the cudaError_t of the launches.
extern "C" int fused_aggregate_launch(const void* deltas, int dtype, int vec,
                                      const float* weights, const float* w_t,
                                      const float* a, const float* scale_ptr,
                                      float scale_value, float* partial,
                                      float* out, long long K, long long d,
                                      long long strips, long long splits,
                                      long long rows_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0 && vec == 1) {
    err = launch<float, 1>(deltas, weights, w_t, a, scale_ptr, scale_value,
                           partial, out, K, d, strips, splits, rows_per_split, s);
  } else if (dtype == 0 && vec == 2) {
    err = launch<float, 2>(deltas, weights, w_t, a, scale_ptr, scale_value,
                           partial, out, K, d, strips, splits, rows_per_split, s);
  } else if (dtype == 1 && vec == 1) {
    err = launch<__nv_bfloat16, 1>(deltas, weights, w_t, a, scale_ptr,
                                   scale_value, partial, out, K, d, strips,
                                   splits, rows_per_split, s);
  } else if (dtype == 1 && vec == 2) {
    err = launch<__nv_bfloat16, 2>(deltas, weights, w_t, a, scale_ptr,
                                   scale_value, partial, out, K, d, strips,
                                   splits, rows_per_split, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  finish_kernel<<<static_cast<unsigned>((d + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      partial, splits, w_t, a, scale_ptr, scale_value, out, d);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks of the aggregation kernel on one SM, for the wrapper's
// grid rule.  Returns the cudaError_t.
extern "C" int fused_aggregate_occupancy(int dtype, int vec, int* blocks) {
  cudaError_t err;
  if (dtype == 0 && vec == 1) err = occupancy<float, 1>(blocks);
  else if (dtype == 0 && vec == 2) err = occupancy<float, 2>(blocks);
  else if (dtype == 1 && vec == 1) err = occupancy<__nv_bfloat16, 1>(blocks);
  else if (dtype == 1 && vec == 2) err = occupancy<__nv_bfloat16, 2>(blocks);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

extern "C" int fused_epilogue_launch(const float* w_t, const float* acc,
                                     const float* a, const float* scale_ptr,
                                     float scale_value, float* out, long long d,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  epilogue_kernel<<<static_cast<unsigned>((d + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      w_t, acc, a, scale_ptr, scale_value, out, d);
  return static_cast<int>(cudaGetLastError());
}
