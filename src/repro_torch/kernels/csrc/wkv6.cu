// RWKV-6 chunk-parallel WKV for Hopper (sm_90a).  Replaces the TPU kernel
// kernels/wkv6.py:wkv6 of the reference package (same chunk math as its
// models/rwkv._wkv_chunked).  Per (batch·head) pair, per chunk of length
// L, in f32, with the (D, D) state S carried across the pair's chunks from
// a given start state or zeros:
//
//     c     = cumprod(w)                     (along the chunk)
//     r_t   = r ⊙ c_prev,   k_t = k / max(c, 1e-30)
//     out   = [(r_t k_tᵀ) ⊙ strict-lower] v + rowsum(r ⊙ u ⊙ k) v + r_t S
//     S    ← diag(c_L) (S + k_tᵀ v)
//
// r, k, v, w: (BH, S, D) f32 or bf16; u: (BH, D) f32; state0: the start
// S, (BH, D, D) f32, or null for zeros; out: (BH, S, D) in r's type;
// state: the final S, (BH, D, D) f32.
//
// Bound: at the serving shape (BH = 320, S = 2,048, D = 64, f32) HBM bytes
// (r, k, v, w read once, out written once: 0.84 GB, 0.25 ms) and the f32
// work (≈ 0.7 MFLOP a chunk, 0.21 ms) are close.  Design:
//
//   * the TPU kernel walked the chunks of a pair in grid order with S in
//     VMEM; here one block walks them in a loop and keeps its part of S in
//     shared memory for the whole sequence;
//   * the output and state columns e are independent once the scores
//     r_t k_tᵀ exist, so a block owns COLS = 16 columns of S (a grid of
//     D/16 × BH blocks: 1,280 at the serving shape, ≈ 10 waves' worth for
//     132 SMs) and recomputes the chunk's scores itself; the D/16 blocks of
//     a pair are neighbours in launch order, so their repeated reads of r,
//     k and w hit L2;
//   * the (L, D) tiles have a row stride of D + 1 floats, so the lanes of
//     a warp reading one column of several rows hit distinct banks; static
//     shared memory is 36 KB, under the 48 KB static limit;
//   * the TPU kernel's order of operations is kept where it matters for
//     parity: the cumulative product is taken one step at a time in f32,
//     k is divided by max(c, 1e-30), and only the strict lower triangle of
//     the scores is formed before the product with v.
//
// Plain CUDA-core FMAs from shared memory: no tensor cores, no TMA.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_L = 32;        // longest chunk
constexpr int MAX_D = 64;        // largest head dimension
constexpr int COLS = 16;         // state and output columns per block
constexpr int PAD = MAX_D + 1;   // row stride of the (L, D) tiles
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ state0,
            T* __restrict__ out, float* __restrict__ state, int BH, int S,
            int D, int L) {
  __shared__ float rs[MAX_L][PAD];           // r, then r_t = r ⊙ c_prev
  __shared__ float ks[MAX_L][PAD];           // k, then k_t = k / max(c, 1e-30)
  __shared__ float ws[MAX_L][PAD];           // w
  __shared__ float vs[MAX_L][COLS];          // the block's columns of v
  __shared__ float sc[MAX_L][MAX_L + 1];     // scores, strict lower triangle
  __shared__ float st[MAX_D][COLS];          // the block's columns of S
  __shared__ float us[MAX_D];
  __shared__ float cl[MAX_D];                // c_L
  __shared__ float bonus[MAX_L];             // rowsum(r ⊙ u ⊙ k)

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int e0 = blockIdx.x * COLS;
  const int E = min(COLS, D - e0);

  for (int bh = blockIdx.y; bh < BH; bh += gridDim.y) {
    const int64_t base = static_cast<int64_t>(bh) * S * D;
    for (int i = tid; i < D; i += THREADS) us[i] = u[static_cast<int64_t>(bh) * D + i];
    for (int i = tid; i < D * COLS; i += THREADS) {
      const int d = i / COLS, e = i % COLS;
      st[d][e] = state0 && e < E
                     ? state0[(static_cast<int64_t>(bh) * D + d) * D + e0 + e]
                     : 0.f;
    }

    for (int c0 = 0; c0 < S; c0 += L) {
      const int64_t off = base + static_cast<int64_t>(c0) * D;
      for (int i = tid; i < L * D; i += THREADS) {
        const int t = i / D, d = i % D;
        rs[t][d] = to_f32(r[off + i]);
        ks[t][d] = to_f32(k[off + i]);
        ws[t][d] = to_f32(w[off + i]);
      }
      for (int i = tid; i < L * E; i += THREADS) {
        const int t = i / E, e = i % E;
        vs[t][e] = to_f32(v[off + static_cast<int64_t>(t) * D + e0 + e]);
      }
      __syncthreads();

      // bonus_t = Σ_d (r u) k, one warp a row
      for (int t = warp; t < L; t += WARPS) {
        float acc = 0.f;
        for (int d = lane; d < D; d += 32) acc += rs[t][d] * us[d] * ks[t][d];
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (lane == 0) bonus[t] = acc;
      }
      __syncthreads();

      // the cumulative decay, one thread a channel, one step at a time
      for (int d = tid; d < D; d += THREADS) {
        float c = 1.f;
        for (int t = 0; t < L; ++t) {
          rs[t][d] *= c;
          c *= ws[t][d];
          ks[t][d] /= fmaxf(c, 1e-30f);
        }
        cl[d] = c;
      }
      __syncthreads();

      for (int i = tid; i < L * L; i += THREADS) {
        const int t = i / L, s = i % L;
        float acc = 0.f;
        if (s < t) {
          for (int d = 0; d < D; ++d) acc += rs[t][d] * ks[s][d];
        }
        sc[t][s] = acc;
      }
      __syncthreads();

      // out = intra + bonus + inter, with the state before this chunk
      for (int i = tid; i < L * E; i += THREADS) {
        const int t = i / E, e = i % E;
        float intra = 0.f;
        for (int s = 0; s < t; ++s) intra += sc[t][s] * vs[s][e];
        float inter = 0.f;
        for (int d = 0; d < D; ++d) inter += rs[t][d] * st[d][e];
        out[off + static_cast<int64_t>(t) * D + e0 + e] =
            from_f32<T>(intra + bonus[t] * vs[t][e] + inter);
      }
      __syncthreads();

      // S ← diag(c_L) (S + k_tᵀ v)
      for (int i = tid; i < D * E; i += THREADS) {
        const int d = i / E, e = i % E;
        float acc = 0.f;
        for (int s = 0; s < L; ++s) acc += ks[s][d] * vs[s][e];
        st[d][e] = cl[d] * (st[d][e] + acc);
      }
      __syncthreads();
    }

    for (int i = tid; i < D * E; i += THREADS) {
      const int d = i / E, e = i % E;
      state[(static_cast<int64_t>(bh) * D + d) * D + e0 + e] = st[d][e];
    }
    __syncthreads();
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w and out share it; u,
// state0 and state are float32; state0 may be null).  S must be a positive
// multiple of L, L ≤ 32, D ≤ 64.  Returns the cudaError_t of the launch.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const float* u, const float* state0,
                           int dtype, void* out, float* state, int BH, int S,
                           int D, int L, void* stream) {
  if (BH < 1 || D < 1 || D > MAX_D || L < 1 || L > MAX_L || S < L || S % L)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((D + COLS - 1) / COLS),
                  static_cast<unsigned>(BH < MAX_GRID_Y ? BH : MAX_GRID_Y));
  if (dtype == 0) {
    wkv6_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(r), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(w), u,
        state0, static_cast<float*>(out), state, BH, S, D, L);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    wkv6_kernel<bf><<<grid, THREADS, 0, st>>>(
        static_cast<const bf*>(r), static_cast<const bf*>(k),
        static_cast<const bf*>(v), static_cast<const bf*>(w), u,
        state0, static_cast<bf*>(out), state, BH, S, D, L);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
