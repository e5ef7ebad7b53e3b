// Fused FedAvg local step (one regularized SGD step) for Hopper (sm_90a):
//
//     out = (1 − h·λ) · w − h · g
//
// over an (R, d) batch of client iterates, computed in f32 and stored in
// w's type (f32 or bf16).  Replaces the TPU kernel
// kernels/fedavg_update.py:fedavg_update of the reference package, which took
// one (d,) vector and a scalar h.  Here:
//
//   * h is one scalar or one value per row; h = 0 leaves a row exactly as it
//     was (1 − 0·λ = 1 and 0·g = 0), which is how padded permutation slots
//     are masked;
//   * the row coefficient 1 − h·λ is rounded as the reference rounds it (an
//     f32 product, then an f32 difference), once per row;
//   * out may be w itself (the client pass updates its iterates in place).
//
// Bound: one elementwise pass, bound by HBM bandwidth — 12 bytes per element
// in f32 (read w and g, write out).  Grid: x walks the columns of a row
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
fedavg_update_kernel(const T* w, const T* __restrict__ g,
                     const float* __restrict__ h, float h_value, float lam,
                     T* out, int64_t R, int64_t d, int64_t h_stride) {
  for (int64_t r = blockIdx.y; r < R; r += gridDim.y) {
    const float hr = h != nullptr ? h[r * h_stride] : h_value;
    const float keep = __fsub_rn(1.0f, __fmul_rn(hr, lam));
    const int64_t row = r * d;
    for (int64_t c = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
         c < d; c += static_cast<int64_t>(gridDim.x) * THREADS) {
      out[row + c] = from_f32<T>(keep * to_f32(w[row + c]) - hr * to_f32(g[row + c]));
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (w, g and out share it).  h may be null,
// and then h_value is used for every row; h_stride is 1 (one h per row) or
// 0.  Returns the cudaError_t of the launch.
extern "C" int fedavg_update_launch(const void* w, const void* g, int dtype,
                                    const float* h, float h_value, float lam,
                                    void* out, long long R, long long d,
                                    long long h_stride, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = R < MAX_GRID_Y ? R : MAX_GRID_Y;
  const dim3 grid(static_cast<unsigned>((d + THREADS - 1) / THREADS),
                  static_cast<unsigned>(rows));
  if (dtype == 0) {
    fedavg_update_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(w), static_cast<const float*>(g), h, h_value,
        lam, static_cast<float*>(out), R, d, h_stride);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    fedavg_update_kernel<bf><<<grid, THREADS, 0, st>>>(
        static_cast<const bf*>(w), static_cast<const bf*>(g), h, h_value, lam,
        static_cast<bf*>(out), R, d, h_stride);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
