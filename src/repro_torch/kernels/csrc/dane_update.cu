// Fused DANE local step (one GD step on the subproblem, eq. 10) for Hopper
// (sm_90a):
//
//     out = (1 − lr(λ+µ)) · w − lr · g + lr · a + lr·µ · w^t
//
// over an (R, d) batch of client iterates, computed in f32 and stored in
// w's type (f32 or bf16).  Replaces the TPU kernel
// kernels/dane_update.py:dane_update of the reference package, which took one
// (d,) vector.  Here:
//
//   * w^t may be one (d,) row shared by all R rows (row stride 0): every
//     client of a bucket starts from the same server iterate, so it costs no
//     HBM traffic beyond L2;
//   * the coefficients 1 − lr(λ+µ) and lr·µ are rounded as the reference
//     rounds them (f32 operations in its order);
//   * out may be w itself (the client pass updates its iterates in place).
//
// Bound: one elementwise pass, bound by HBM bandwidth — 16 bytes per element
// in f32 (read w, g and a, write out).  Grid: x walks the columns of a row
// (coalesced), y walks the rows.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// w and out are not __restrict__: the client pass passes the same buffer.
template <typename T>
__global__ void __launch_bounds__(THREADS)
dane_update_kernel(const T* w, const T* __restrict__ g, const T* __restrict__ a,
                   const T* __restrict__ w_t, float lr, float lam, float mu,
                   T* out, int64_t R, int64_t d, int64_t w_t_stride) {
  const float keep = __fsub_rn(1.0f, __fmul_rn(lr, __fadd_rn(lam, mu)));
  const float lr_mu = __fmul_rn(lr, mu);
  for (int64_t r = blockIdx.y; r < R; r += gridDim.y) {
    const int64_t row = r * d;
    const T* wt = w_t + r * w_t_stride;
    for (int64_t c = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
         c < d; c += static_cast<int64_t>(gridDim.x) * THREADS) {
      const float v = keep * to_f32(w[row + c]) - lr * to_f32(g[row + c])
                      + lr * to_f32(a[row + c]) + lr_mu * to_f32(wt[c]);
      out[row + c] = from_f32<T>(v);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (w, g, a, w_t and out share it).
// w_t_stride is d (one row of w^t per row of w) or 0 (one shared row).
// Returns the cudaError_t of the launch.
extern "C" int dane_update_launch(const void* w, const void* g, const void* a,
                                  const void* w_t, int dtype, float lr,
                                  float lam, float mu, void* out, long long R,
                                  long long d, long long w_t_stride,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = R < MAX_GRID_Y ? R : MAX_GRID_Y;
  const dim3 grid(static_cast<unsigned>((d + THREADS - 1) / THREADS),
                  static_cast<unsigned>(rows));
  if (dtype == 0) {
    dane_update_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(w), static_cast<const float*>(g),
        static_cast<const float*>(a), static_cast<const float*>(w_t), lr, lam,
        mu, static_cast<float*>(out), R, d, w_t_stride);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    dane_update_kernel<bf><<<grid, THREADS, 0, st>>>(
        static_cast<const bf*>(w), static_cast<const bf*>(g),
        static_cast<const bf*>(a), static_cast<const bf*>(w_t), lr, lam, mu,
        static_cast<bf*>(out), R, d, w_t_stride);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
