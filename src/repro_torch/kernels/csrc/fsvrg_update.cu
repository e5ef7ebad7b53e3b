// Fused FSVRG local step (Alg. 4 line 8) for Hopper (sm_90a):
//
//     out = w − h · (S ⊙ (g_new − g_old) + ḡ)
//
// over an (R, d) batch of client iterates, computed in f32 and stored in
// w's type (f32 or bf16).  Replaces the TPU kernel
// kernels/fsvrg_update.py:fsvrg_update of the reference package, which took
// one (d,) vector and a scalar h.  Here:
//
//   * S, g_old and ḡ may be one (d,) row shared by all R rows (row stride
//     0), so the main path's zero g_old and the shared full gradient cost
//     no HBM traffic beyond L2;
//   * h is one scalar or one value per row (h = 0 leaves a row exactly as
//     it was, the masking of padded permutation slots);
//   * out may be w itself (the client pass updates its iterates in place).
//
// Bound: one elementwise pass, bound by HBM bandwidth — about 16 bytes per
// element in f32 (read w, S, g_new; write out).  Grid: x walks the columns
// of a row (coalesced), y walks the rows.
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
fsvrg_update_kernel(const T* w, const T* __restrict__ s,
                    const T* __restrict__ g_new, const T* __restrict__ g_old,
                    const T* __restrict__ g_bar, const float* __restrict__ h,
                    float h_value, T* out, int64_t R, int64_t d,
                    int64_t s_stride, int64_t g_old_stride,
                    int64_t g_bar_stride, int64_t h_stride) {
  for (int64_t r = blockIdx.y; r < R; r += gridDim.y) {
    const float hr = h != nullptr ? h[r * h_stride] : h_value;
    const int64_t row = r * d;
    const T* sr = s + r * s_stride;
    const T* go = g_old + r * g_old_stride;
    const T* gb = g_bar + r * g_bar_stride;
    for (int64_t c = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
         c < d; c += static_cast<int64_t>(gridDim.x) * THREADS) {
      const float diff = to_f32(g_new[row + c]) - to_f32(go[c]);
      const float upd = to_f32(sr[c]) * diff + to_f32(gb[c]);
      out[row + c] = from_f32<T>(to_f32(w[row + c]) - hr * upd);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (all five vectors and out share it).
// h may be null, and then h_value is used for every row.  Strides are in
// elements: s_stride, g_old_stride and g_bar_stride are d or 0 (one shared
// row), h_stride is 1 or 0.  Returns the cudaError_t of the launch.
extern "C" int fsvrg_update_launch(const void* w, const void* s,
                                   const void* g_new, const void* g_old,
                                   const void* g_bar, int dtype,
                                   const float* h, float h_value, void* out,
                                   long long R, long long d,
                                   long long s_stride, long long g_old_stride,
                                   long long g_bar_stride, long long h_stride,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = R < MAX_GRID_Y ? R : MAX_GRID_Y;
  const dim3 grid(static_cast<unsigned>((d + THREADS - 1) / THREADS),
                  static_cast<unsigned>(rows));
  if (dtype == 0) {
    fsvrg_update_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(w), static_cast<const float*>(s),
        static_cast<const float*>(g_new), static_cast<const float*>(g_old),
        static_cast<const float*>(g_bar), h, h_value, static_cast<float*>(out),
        R, d, s_stride, g_old_stride, g_bar_stride, h_stride);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    fsvrg_update_kernel<bf><<<grid, THREADS, 0, st>>>(
        static_cast<const bf*>(w), static_cast<const bf*>(s),
        static_cast<const bf*>(g_new), static_cast<const bf*>(g_old),
        static_cast<const bf*>(g_bar), h, h_value, static_cast<bf*>(out), R, d,
        s_stride, g_old_stride, g_bar_stride, h_stride);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
