// CoCoA+ local SDCA (eq. 15) for Hopper (sm_90a): the dual-coordinate solve,
// and the whole local pass of a bucket of clients in one launch.
//
// For logistic loss with y ∈ {−1, 1} the dual coordinate is β = y·α ∈ (0, 1)
// and each coordinate solves
//
//     min_β  m (β − β₀) + c (β − β₀)² + β log β + (1 − β) log(1 − β)
//
// by a fixed number of clipped Newton steps from β = clip(sigmoid(−m)), every
// iterate clipped to [1e-6, 1 − 1e-6] (sdca_newton, shared by both entries).
// Replaces the TPU kernel kernels/cocoa_sdca.py:cocoa_sdca_update of the
// reference package, which the reference launches once per step of its
// lax.scan over a bucket's m_pad steps (core/cocoa.py:_sdca_local_pass_keyed).
//
// Numerics: logf and the divisions are the accurate ones (no fast-math): the
// clip at 1e-6 and the 1/(β(1−β)) curvature term make the approximate
// __logf / __fdividef drift visibly from the plain version; and no operation
// of the solve or of the step's coefficients is contracted into an FMA.
//
// cocoa_sdca_launch — the coordinate entry, the TPU kernel's own function:
// one thread a coordinate over (β₀, m, c) vectors.  At N ≤ 6,478 it is far
// below a launch's own cost.
//
// cocoa_sdca_pass_launch — one permutation pass of SDCA for every client of
// a bucket.  A bucket's clients are independent; each client's m_pad steps
// are a dependent chain (step t gathers r, which step t−1 scattered into).
// A launch per step, as on the TPU, made the pass host-bound (≈ 15 host
// launches a step, 14,848 steps a round at the paper's width).  Here the
// step loop runs inside the kernel, one warp a client:
//
//   * a step: the lanes hold the row's nnz entries (EPL a lane), gather
//     w[x] and r[x], reduce v·w, v·r and ‖v‖² across the warp (butterfly:
//     every lane gets the same bits), run the Newton solve redundantly in
//     every lane, and scatter du·v into r with global atomics — a row's
//     features may repeat, and every entry must add, as scatter_add_ does.
//     __syncwarp() orders the adds before the next step's gather, which
//     reads r through L2 (__ldcg), where the atomics land;
//   * the chain is latency-bound (≈ 1–2 µs a step: an L2 gather, a warp
//     reduction, 12 Newton steps of logf and two divisions, the scatter), so
//     what does not depend on r is loaded ahead: step t+1's row (x, v, y, α)
//     and its w[x] gather, and perms[t+2];
//   * the client's r row stays in device memory (it is the output; the
//     ≤ n_k·nnz entries a client touches stay in L1/L2).  Holding it in
//     shared memory (80,008 bytes at d = 20,002) would allow 2 clients an SM
//     and take ≈ 25 waves for the largest bucket (6,478 clients); a warp a
//     client in 64-thread blocks keeps up to 64 clients an SM in flight;
//   * the kernel zeroes its r and u rows itself.
//
// Bound of the pass: its bytes — idx (8 B) and val (4 B) of every padded
// row, y, α, perms, u, and r written once (10,000 × 20,002 × 4 B a round at
// the paper's width): ≈ 2.6 GB, ≈ 0.8 ms a round at 3.35 TB/s.  Its pace is
// set by the longest chain (11 clients × 6,750 steps), not by the bytes.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 1 << 20;
constexpr int PASS_WARPS = 2;           // clients a block of the pass
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

// The clipped Newton solve of one coordinate, in f32, each operation
// rounded as the plain version (one PyTorch operation each) rounds it: no
// contraction into FMAs.  β is a number near ½ whose change u = β − β₀ is
// often 10⁻⁵ or less, so an ulp of β is visible in u.
__device__ __forceinline__ float sdca_newton(float b0, float m, float c,
                                             int newton_iters) {
  float b = clip(__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(m))));  // sigmoid(−m)
  const float c2 = __fmul_rn(2.0f, c);
  for (int k = 0; k < newton_iters; ++k) {
    const float one_minus_b = __fsub_rn(1.0f, b);
    const float gb = __fadd_rn(__fadd_rn(m, __fmul_rn(c2, __fsub_rn(b, b0))),
                               logf(__fdiv_rn(b, one_minus_b)));
    const float hb = __fadd_rn(c2, __fdiv_rn(1.0f, __fmul_rn(b, one_minus_b)));
    b = clip(__fsub_rn(b, __fdiv_rn(gb, hb)));
  }
  return b;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
cocoa_sdca_kernel(const T* __restrict__ beta0, const T* __restrict__ mcoef,
                  const T* __restrict__ ccoef, T* __restrict__ out, int64_t n,
                  int newton_iters) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * THREADS) {
    out[i] = from_f32<T>(sdca_newton(to_f32(beta0[i]), to_f32(mcoef[i]),
                                     to_f32(ccoef[i]), newton_iters));
  }
}

// One step's row of a client: coordinate i, its label and dual value, and
// the lane's EPL entries (feature x, value v; 0 past nnz, like padding).
template <int EPL>
struct Row {
  int i;
  float y, alpha;
  int x[EPL];
  float v[EPL];
};

template <int EPL>
__device__ __forceinline__ Row<EPL> load_row(int i, const float* y,
                                             const float* alpha,
                                             const int64_t* idx,
                                             const float* val, int nnz,
                                             int lane) {
  Row<EPL> row;
  row.i = i;
  row.y = __ldg(y + i);
  row.alpha = __ldg(alpha + i);
  const int64_t base = static_cast<int64_t>(i) * nnz;
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    const int j = lane + 32 * e;
    row.x[e] = j < nnz ? static_cast<int>(__ldg(idx + base + j)) : 0;
    row.v[e] = j < nnz ? __ldg(val + base + j) : 0.0f;
  }
  return row;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int EPL>
__global__ void __launch_bounds__(PASS_WARPS * 32)
sdca_pass_kernel(const float* __restrict__ w, const float* __restrict__ alpha,
                 const int64_t* __restrict__ idx, const float* __restrict__ val,
                 const float* __restrict__ y, const int64_t* __restrict__ n_k,
                 const int64_t* __restrict__ perms, float* __restrict__ u,
                 float* __restrict__ r, int64_t Kb, int m_pad, int nnz,
                 int64_t d, float sigma, float shift, float denom,
                 int newton_iters) {
  const int lane = threadIdx.x & 31;
  const int64_t k = static_cast<int64_t>(blockIdx.x) * PASS_WARPS + (threadIdx.x >> 5);
  if (k >= Kb) return;                               // the whole warp
  float* rk = r + k * d;
  float* uk = u + k * m_pad;
  for (int64_t j = lane; j < d; j += 32) rk[j] = 0.0f;
  for (int j = lane; j < m_pad; j += 32) uk[j] = 0.0f;
  const int64_t nk = n_k[k];
  const int64_t* pk = perms + k * m_pad;
  const float* yk = y + k * m_pad;
  const float* ak = alpha + k * m_pad;
  const int64_t* ik = idx + k * m_pad * nnz;
  const float* vk = val + k * m_pad * nnz;
  const int last = m_pad - 1;

  // the pipeline: cur (step t) with its w[x]; nxt (step t+1); i2 = perms[t+2]
  Row<EPL> cur = load_row<EPL>(static_cast<int>(__ldg(pk)), yk, ak, ik, vk, nnz, lane);
  Row<EPL> nxt = load_row<EPL>(static_cast<int>(__ldg(pk + (1 < last ? 1 : last))),
                               yk, ak, ik, vk, nnz, lane);
  int i2 = static_cast<int>(__ldg(pk + (2 < last ? 2 : last)));
  float wx[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) wx[e] = __ldg(w + cur.x[e]);
  __syncwarp();                                      // the zeroes before any gather

  for (int t = 0; t < m_pad; ++t) {
    // loads that do not depend on this step's r: the next step's w[x], the
    // step after next's row, and the perms entry after that
    float wx_next[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) wx_next[e] = __ldg(w + nxt.x[e]);
    const Row<EPL> nn = load_row<EPL>(i2, yk, ak, ik, vk, nnz, lane);
    i2 = static_cast<int>(__ldg(pk + (t + 3 < last ? t + 3 : last)));

    float zw = 0.0f, rr = 0.0f, xn2 = 0.0f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {               // products, then sums
      zw = __fadd_rn(zw, __fmul_rn(cur.v[e], wx[e]));
      rr = __fadd_rn(rr, __fmul_rn(cur.v[e], __ldcg(rk + cur.x[e])));
      xn2 = __fadd_rn(xn2, __fmul_rn(cur.v[e], cur.v[e]));
    }
    zw = warp_sum(zw);
    rr = warp_sum(rr);
    xn2 = warp_sum(xn2);
    // the coefficients rounded as the plain version rounds them
    const float b_old = clip(cur.y * cur.alpha);
    const float m = __fmul_rn(cur.y, __fadd_rn(zw, __fmul_rn(shift, rr)));
    const float c = __fdiv_rn(__fmul_rn(sigma, xn2), denom);
    const float beta = sdca_newton(b_old, m, c, newton_iters);
    const float valid = cur.i < nk ? 1.0f : 0.0f;
    const float du = __fmul_rn(__fmul_rn(valid, cur.y), beta - b_old);
    if (lane == 0) uk[cur.i] += du;
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      if (lane + 32 * e < nnz) atomicAdd(rk + cur.x[e], __fmul_rn(du, cur.v[e]));
    __syncwarp();                                    // the adds before the next gather

    cur = nxt;
    nxt = nn;
#pragma unroll
    for (int e = 0; e < EPL; ++e) wx[e] = wx_next[e];
  }
}

template <int EPL>
cudaError_t launch_pass(const float* w, const float* alpha, const int64_t* idx,
                        const float* val, const float* y, const int64_t* n_k,
                        const int64_t* perms, float* u, float* r, long long Kb,
                        int m_pad, int nnz, long long d, float sigma,
                        float shift, float denom, int newton_iters,
                        cudaStream_t s) {
  const long long blocks = (Kb + PASS_WARPS - 1) / PASS_WARPS;
  sdca_pass_kernel<EPL><<<static_cast<unsigned>(blocks), PASS_WARPS * 32, 0, s>>>(
      w, alpha, idx, val, y, n_k, perms, u, r, Kb, m_pad, nnz, d, sigma, shift,
      denom, newton_iters);
  return cudaGetLastError();
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

// The pass over a bucket: w (d,), alpha / y / perms (Kb, m_pad), idx / val
// (Kb, m_pad, nnz), n_k (Kb,); writes u (Kb, m_pad) and r (Kb, d).  idx,
// n_k and perms are int64.  epl: entries a lane, 1, 2, 4 or 8 (nnz ≤ 32·epl).
// sigma = σ′, shift = σ′/(λn), denom = 2λn, each rounded to f32.  Returns the
// cudaError_t of the launch.
extern "C" int cocoa_sdca_pass_launch(const float* w, const float* alpha,
                                      const int64_t* idx, const float* val,
                                      const float* y, const int64_t* n_k,
                                      const int64_t* perms, float* u, float* r,
                                      long long Kb, int m_pad, int nnz,
                                      long long d, float sigma, float shift,
                                      float denom, int newton_iters, int epl,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (epl) {
    case 1: err = launch_pass<1>(w, alpha, idx, val, y, n_k, perms, u, r, Kb, m_pad, nnz, d,
                                 sigma, shift, denom, newton_iters, s); break;
    case 2: err = launch_pass<2>(w, alpha, idx, val, y, n_k, perms, u, r, Kb, m_pad, nnz, d,
                                 sigma, shift, denom, newton_iters, s); break;
    case 4: err = launch_pass<4>(w, alpha, idx, val, y, n_k, perms, u, r, Kb, m_pad, nnz, d,
                                 sigma, shift, denom, newton_iters, s); break;
    case 8: err = launch_pass<8>(w, alpha, idx, val, y, n_k, perms, u, r, Kb, m_pad, nnz, d,
                                 sigma, shift, denom, newton_iters, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
