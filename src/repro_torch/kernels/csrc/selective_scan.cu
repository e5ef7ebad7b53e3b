// Mamba's selective scan (S6) for Hopper (sm_90a).  It replaces no TPU
// kernel: the reference computes the scan in plain JAX
// (src/repro/models/mamba.py:46-109), where the discretized a = exp(dt·A)
// and b = (dt·B)·x are (B, S, di, N) f32 tensors and a chunked associative
// scan writes every state h of the same shape.  At Jamba's width (di =
// 8,192, N = 16) and 8 × 2,048 prompt tokens each of those is 8.59 GB, so
// this kernel forms a and b on the fly and keeps the states in registers:
// only y (B, S, di) and the last state leave the card's registers.
//
// Per sequence b, channel c and state n, from h0 (or zeros), in f32:
//
//     dt = softplus(dt_pre[b, t] + dt_bias[c]),   A = −exp(a_log[c, n])
//     h  = exp(dt·A)·h + (dt·B[b, t, n])·x[b, t, c]
//     y[b, t, c] = Σ_n h·C[b, t, n] + x[b, t, c]·d_skip[c]
//
// softplus is the reference's jax.nn.softplus, max(v, 0) + log1p(exp(−|v|)).
// x: (B, S, di) f32 or bf16 with the channel contiguous and batch and token
// strides in elements; dt_pre: (B, S) f32, any strides; B and C: (B, S, N)
// f32 with N contiguous and one pair of batch and token strides (the two
// halves of one (B, S, 2N) tensor); dt_bias, d_skip: (di) f32; a_log:
// (di, N) f32; h0: (B, di, N) f32 or null; y: a new contiguous (B, S, di)
// f32; h_last: (B, di, N) f32.
//
// Bound, at the prefill's (8, 2,048, 8,192, 16) with bf16 x: x read once
// and y written once are 0.81 GB, 0.24 ms at 3.35 TB/s; the f32 work,
// 7N + 9 operations a (t, c) (dt·x formed once), is 16.2 GFLOP, also
// 0.24 ms at 67 TFLOP/s; but the 2.15 × 10⁹ exponentials, one an (t, c,
// n), need the special-function units, 16 an SM a clock: ≈ 0.51 ms at
// 1.98 GHz, the floor in practice.  Design (simple first; the chunked
// parallel scan, wgmma and TMA are later work):
//
//   * a thread owns one (sequence, channel): its N = 16 states and the
//     channel's −exp(a_log) live in registers for the whole sequence, so
//     the scan over t is a plain loop with 16 independent chains;
//   * a block is 128 channels of one sequence (grid: di / 128 × B); every
//     channel of a sequence shares dt_pre, B and C, so each tile of 64
//     timesteps' values is staged once in shared memory and read as a
//     broadcast; each thread stages its own channel's 64 x values too
//     (coalesced across the warp), so the loads of a tile are all in
//     flight before its scan starts;
//   * y is written as it is formed, one coalesced row a step; the last
//     state as four 16-byte stores a thread;
//   * no fast-math intrinsics: expf and log1pf as the plain version's
//     PyTorch calls take them; sums in a fixed order, so two calls give
//     the same bits.  The plain version differs only where the compiler
//     fuses a multiply and an add.
//
// The same kernel serves a decode step (S = 1): one launch a Mamba layer.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;   // channels a block
constexpr int NS = 16;         // the state size N the kernel takes
constexpr int TT = 64;         // timesteps a staged tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// jax.nn.softplus: logaddexp(v, 0)
__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
selective_scan_kernel(const T* __restrict__ x, long long x_bs, long long x_ts,
                      const float* __restrict__ dt_pre, long long dt_bs,
                      long long dt_ts, const float* __restrict__ dt_bias,
                      const float* __restrict__ a_log,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm, long long bc_bs,
                      long long bc_ts, const float* __restrict__ d_skip,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_last, int S, int di) {
  __shared__ float s_x[TT][THREADS];
  __shared__ float s_dt[TT];
  __shared__ float s_b[TT][NS];
  __shared__ float s_c[TT][NS];

  const int tid = threadIdx.x;
  const long long bb = blockIdx.y;
  const int c = blockIdx.x * THREADS + tid;
  const bool live = c < di;

  float A[NS], h[NS];
  float bias = 0.0f, dsk = 0.0f;
  if (live) {
    const float* al = a_log + static_cast<long long>(c) * NS;
#pragma unroll
    for (int n = 0; n < NS; ++n) A[n] = -expf(al[n]);
    if (h0 != nullptr) {
      const float4* hp = reinterpret_cast<const float4*>(
          h0 + (bb * di + c) * NS);
#pragma unroll
      for (int q = 0; q < NS / 4; ++q) {
        const float4 v = hp[q];
        h[4 * q] = v.x; h[4 * q + 1] = v.y; h[4 * q + 2] = v.z;
        h[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int n = 0; n < NS; ++n) h[n] = 0.0f;
    }
    bias = dt_bias[c];
    dsk = d_skip[c];
  }
  const T* xb = x + bb * x_bs + c;
  const float* dtb = dt_pre + bb * dt_bs;
  const float* bmb = bm + bb * bc_bs;
  const float* cmb = cm + bb * bc_bs;
  float* yb = y + bb * S * di + c;

  for (int t0 = 0; t0 < S; t0 += TT) {
    const int nt = min(TT, S - t0);
    __syncthreads();             // the last tile's reads are done
    if (live) {
      for (int tt = 0; tt < nt; ++tt) {
        s_x[tt][tid] = to_f32(xb[(t0 + tt) * x_ts]);
      }
    }
    for (int i = tid; i < nt; i += THREADS) s_dt[i] = dtb[(t0 + i) * dt_ts];
    for (int i = tid; i < nt * NS; i += THREADS) {
      const int tt = i / NS, n = i % NS;
      const long long off = (t0 + tt) * bc_ts + n;
      s_b[tt][n] = bmb[off];
      s_c[tt][n] = cmb[off];
    }
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < nt; ++tt) {
      const float xv = s_x[tt][tid];
      const float dt = softplus(s_dt[tt] + bias);
      float acc = 0.0f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float a = expf(dt * A[n]);
        const float b = (dt * s_b[tt][n]) * xv;
        h[n] = a * h[n] + b;
        acc += h[n] * s_c[tt][n];
      }
      yb[static_cast<long long>(t0 + tt) * di] = acc + xv * dsk;
    }
  }
  if (live) {
    float4* hp = reinterpret_cast<float4*>(h_last + (bb * di + c) * NS);
#pragma unroll
    for (int q = 0; q < NS / 4; ++q) {
      hp[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, long long x_bs, long long x_ts,
                   const float* dt_pre, long long dt_bs, long long dt_ts,
                   const float* dt_bias, const float* a_log, const float* bm,
                   const float* cm, long long bc_bs, long long bc_ts,
                   const float* d_skip, const float* h0, float* y,
                   float* h_last, int batch, int S, int di,
                   cudaStream_t stream) {
  const dim3 grid((di + THREADS - 1) / THREADS, batch);
  selective_scan_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), x_bs, x_ts, dt_pre, dt_bs, dt_ts, dt_bias,
      a_log, bm, cm, bc_bs, bc_ts, d_skip, h0, y, h_last, S, di);
  return cudaGetLastError();
}

}  // namespace

// x_dtype: 0 f32, 1 bf16.  Strides in elements.  Returns a cudaError_t.
extern "C" int selective_scan_launch(
    const void* x, int x_dtype, long long x_bs, long long x_ts,
    const void* dt_pre, long long dt_bs, long long dt_ts,
    const void* dt_bias, const void* a_log, const void* bm, const void* cm,
    long long bc_bs, long long bc_ts, const void* d_skip, const void* h0,
    void* y, void* h_last, int batch, int S, int di, int n_state,
    void* stream) {
  if (n_state != NS || batch < 1 || batch > 65535 || S < 1 || di < 1 ||
      (x_dtype != 0 && x_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_dtype == 0
          ? launch<float>(x, x_bs, x_ts, f(dt_pre), dt_bs, dt_ts, f(dt_bias),
                          f(a_log), f(bm), f(cm), bc_bs, bc_ts, f(d_skip),
                          f(h0), static_cast<float*>(y),
                          static_cast<float*>(h_last), batch, S, di, s)
          : launch<__nv_bfloat16>(x, x_bs, x_ts, f(dt_pre), dt_bs, dt_ts,
                                  f(dt_bias), f(a_log), f(bm), f(cm), bc_bs,
                                  bc_ts, f(d_skip), f(h0),
                                  static_cast<float*>(y),
                                  static_cast<float*>(h_last), batch, S, di,
                                  s);
  return static_cast<int>(err);
}

// The kernel's resources for x of dtype x_dtype: resident blocks an SM
// (the CUDA occupancy calculator), threads a block, registers a thread,
// shared memory a block and local memory a thread (spills), in bytes.
extern "C" int selective_scan_occupancy(int x_dtype, int* blocks,
                                        int* threads, int* regs, int* smem,
                                        int* local) {
  const void* fn =
      x_dtype == 0
          ? reinterpret_cast<const void*>(selective_scan_kernel<float>)
          : reinterpret_cast<const void*>(
                selective_scan_kernel<__nv_bfloat16>);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, THREADS,
                                                        0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *threads = THREADS;
  *regs = attr.numRegs;
  *smem = static_cast<int>(attr.sharedSizeBytes);
  *local = static_cast<int>(attr.localSizeBytes);
  return 0;
}
