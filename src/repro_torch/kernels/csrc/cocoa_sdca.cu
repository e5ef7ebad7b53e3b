// CoCoA+ local-SDCA dual-coordinate update (eq. 15) for Hopper (sm_90a).
//
// For logistic loss with y ∈ {−1, 1} the dual coordinate is β = y·α ∈ (0, 1)
// and each coordinate solves
//
//     min_β  m (β − β₀) + c (β − β₀)² + β log β + (1 − β) log(1 − β)
//
// by a fixed number of clipped Newton steps from β = clip(sigmoid(−m)), every
// iterate clipped to [1e-6, 1 − 1e-6].  Replaces the TPU kernel
// kernels/cocoa_sdca.py:cocoa_sdca_update of the reference package, which
// padded the vector to (rows, 128) tiles with β₀ = ½, m = c = 0.  Here one
// thread owns one coordinate and runs the whole Newton recursion in
// registers, so nothing needs padding: the grid masks the ragged end.
//
// Numerics: logf and the divisions are the accurate ones (no fast-math): the
// clip at 1e-6 and the 1/(β(1−β)) curvature term make the approximate
// __logf / __fdividef drift visibly from the plain version.
//
// Bound: at the main path's N = Kb ≤ 6,478 coordinates the inputs are
// ≈ 100 KB and the work ≈ 40 operations × 12 steps a coordinate, far below a
// launch's own cost: the call is launch-bound, not bytes- or operation-bound.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 1 << 20;
constexpr float EPS = 1e-6f;
constexpr float ONE_MINUS_EPS = 0.999999f;  // f32(1 − 1e-6), as the plain version rounds it

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float clip(float x) {
  return fminf(fmaxf(x, EPS), ONE_MINUS_EPS);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
cocoa_sdca_kernel(const T* __restrict__ beta0, const T* __restrict__ mcoef,
                  const T* __restrict__ ccoef, T* __restrict__ out, int64_t n,
                  int newton_iters) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * THREADS) {
    const float b0 = to_f32(beta0[i]);
    const float m = to_f32(mcoef[i]);
    const float c = to_f32(ccoef[i]);
    float b = clip(1.0f / (1.0f + expf(m)));  // sigmoid(−m)
    for (int k = 0; k < newton_iters; ++k) {
      const float gb = m + 2.0f * c * (b - b0) + logf(b / (1.0f - b));
      const float hb = 2.0f * c + 1.0f / (b * (1.0f - b));
      b = clip(b - gb / hb);
    }
    out[i] = from_f32<T>(b);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (all three inputs and out share it).
// Returns the cudaError_t of the launch.
extern "C" int cocoa_sdca_launch(const void* beta0, const void* mcoef,
                                 const void* ccoef, int dtype, void* out,
                                 long long n, int newton_iters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (dtype == 0) {
    cocoa_sdca_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(beta0), static_cast<const float*>(mcoef),
        static_cast<const float*>(ccoef), static_cast<float*>(out), n,
        newton_iters);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    cocoa_sdca_kernel<bf><<<grid, THREADS, 0, st>>>(
        static_cast<const bf*>(beta0), static_cast<const bf*>(mcoef),
        static_cast<const bf*>(ccoef), static_cast<bf*>(out), n, newton_iters);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
