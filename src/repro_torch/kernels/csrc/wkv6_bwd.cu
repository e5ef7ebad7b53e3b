// The backward of the RWKV-6 chunk-parallel WKV for Hopper (sm_90a): the
// VJP of the chunk math of wkv6.cu (and of the reference's
// models/rwkv._wkv_chunked, which the reference differentiates with
// jax.grad; its TPU kernel kernels/wkv6.py:wkv6 has no backward).  The
// plain version is ref.wkv6_bwd_ref.
//
// Per (batch, head) pair, with the chunk of length L, its start state S0
// and the cotangent dS of its end state, c = cumprod(w), r_t = r ⊙ c_prev,
// k_t = k / max(c, 1e-30), A the strict-lower scores r_t k_tᵀ, β_t =
// r_t·(u ⊙ k_t), dβ_t = dout_t·v_t, dA the strict-lower dout vᵀ and
// Y = v dSᵀ:
//
//     dv    = Aᵀ dout + β ⊙ dout + k_t (diag(c_L) dS)
//     dr_t  = dA k_t + dout S0ᵀ,     dk_t = dAᵀ r_t + Y ⊙ c_L
//     dc_L  = rowsum(dS ⊙ S0) + colsum(k_t ⊙ Y)
//     dr    = dr_t ⊙ c_prev + dβ u ⊙ k,   dk = dk_t / max(c, 1e-30) + dβ u ⊙ r
//     du   += Σ_t dβ_t r_t ⊙ k_t
//
// The decay: c gets dr_t ⊙ r through c_prev, −(dk_t ⊙ k_t) / max(c, 1e-30)
// through k_t where c > 1e-30 (half at c = 1e-30, as torch.maximum splits
// a tie; nothing below it, where the clamp gives c no gradient) and dc_L
// at the chunk's end; then dw_i = c_prev_i · q_i with the suffix sum
// q_i = dc_i + w_{i+1} q_{i+1}: no w_i is divided by, since it may be 0.
// The product (dk_t ⊙ k_t) is formed before the division, so a clamped
// chunk stays finite (autograd through the plain forward forms
// k/max(c, 1e-30)² first, which overflows, and its gradient of w is then
// NaN there).
//
// S0 and dS of every chunk come from two linear recurrences over the
// chunks of a pair, elementwise in each (i, j) of the (D, D) state once a
// chunk's increment and c_L are known:
//
//     S0_{n+1} = diag(c_L,n) (S0_n + k_t,nᵀ v_n)       from state0 or 0
//     dS_{n−1} = diag(c_L,n) dS_n + r_t,nᵀ dout_n      from d_final or 0
//
// so the backward is three launches:
//
//   1. terms (a block a (pair, chunk)): c_L and the two increments
//      k_tᵀ v and r_tᵀ dout into the scratch;
//   2. scan (a thread a (pair, i, j)): the increments turned in place into
//      each chunk's S0 (forward, the forward kernel's arithmetic
//      c_L · (S + Σ) with Σ taken in token order, so the same bits) and
//      its end cotangent dS (in reverse, c_L · dS + Σ as one FMA), and
//      d_state0 when a start state was given;
//   3. chunk backward (a block a (pair, chunk)): dv, dr, dk and dw of the
//      chunk from its S0 and dS, and one du row a (pair, chunk), which
//      the wrapper sums in a fixed order.  No float atomics anywhere, so
//      two calls give the same bits.
//
// Inside launches 1 and 3 every product runs in f32 FMAs from registers,
// as in wkv6.cu: a thread loads float4 rows of both operands from shared
// memory and does 8 to 10.7 FMAs for every load.  A product over a
// tile's own rows (an "outer" product: k_tᵀ v, r_tᵀ dout, A, Aᵀ dout,
// k_t G) has its operands stored with the summed index as the row: lanes
// of a quarter warp read consecutive 16-byte words of one row, or one
// word (a broadcast).  A product over both operands' columns (dA, Y,
// dout S0ᵀ, dA k_t, dAᵀ r_t) gives each lane of a quarter warp its own
// row of one operand, with a row stride of 17 or 9 16-byte words, so the
// eight rows start in eight different bank groups.  r_t and k_t are kept
// transposed, (D, L), for the products that need them so.  The decay,
// r_t, k_t and, in launch 3, the suffix sums run in all 256 threads: a
// thread a channel and a quarter of the chunk, which recomputes the decay
// of the rows before its quarter (the same bits); the suffix sum of a
// quarter is carried into the quarter before it through smem as
// q_first + (Π w) · carry.  Launch 3's eight warps split the products in
// pairs: k_t G then Aᵀ dout (dv), dout S0ᵀ then dA k_t (dr_t), Y then
// dAᵀ r_t (dk_t), and A, dA and rowsum(dS ⊙ S0) (then dc_L), with one
// barrier between the two halves.  110,336 B of shared memory and ≤ 128
// registers a thread keep 2 blocks an SM resident.  Tiles are padded to
// L = 32 rows and D = 64 channels with zeros (w: ones), so a short chunk
// or a narrow head runs the same code and stores only its own elements.
//
// r, k, v, w: (B, S, Hn, D) f32 with D contiguous and the forward's batch,
// token and head strides; d_out, dr, dk, dv, dw: contiguous (B, S, Hn, D);
// u: row b·u_bstride + h·D; state0, d_final, d_state0: (B, Hn, D, D) or
// null.  The (BH, S, D) entry is Hn = 1 with u_bstride = D.  Rows are
// 16-byte cp.async copies where D, the strides and the base addresses
// allow it (D % 4 == 0), else element loads.
//
// Bound: at the training shape (2, 128, 40, 64) the bytes (r, k, v, w,
// dout read, dr, dk, dv, dw written: 9 × 2.6 MB, 0.007 ms) and the f32
// work (0.545 GFLOP, 0.008 ms) are both a few µs; 320 blocks of (pair,
// chunk) are 1.2 waves at 2 blocks an SM.  At (8, 2,048, 40, 64): 1.5 GB
// (0.45 ms) and 35 GFLOP (0.52 ms at 67 TFLOP/s), 20,480 blocks, plus the
// scratch's 2 × 335.5 MB written, read and written by the scan, and read
// again (≈ 1.3 GB, 0.4 ms).
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SCAN_THREADS = 256;
constexpr int LC = 32;            // longest chunk
constexpr int DC = 64;            // largest head dimension
constexpr int RS = DC;            // row stride of r, k, w, dout, dr_t, dk_t
constexpr int VS = DC + 4;        // row stride of v and the states: 17 words
constexpr int TS = LC + 4;        // row stride of r_tᵀ and k_tᵀ: 9 words
constexpr int PS = LC;            // row stride of A, dA and dAᵀ
static_assert(THREADS == 4 * DC && LC == 32, "the decay maps a thread to a "
              "channel and a quarter of the chunk");

// shared memory of the chunk backward, in floats
constexpr int OFF_R = 0;                       // r      (LC, RS)
constexpr int OFF_K = OFF_R + LC * RS;         // k      (LC, RS)
constexpr int OFF_W = OFF_K + LC * RS;         // w      (LC, RS)
constexpr int OFF_G = OFF_W + LC * RS;         // dout   (LC, RS)
constexpr int OFF_V = OFF_G + LC * RS;         // v      (LC, VS)
constexpr int OFF_RTT = OFF_V + LC * VS;       // r_tᵀ   (DC, TS)
constexpr int OFF_KTT = OFF_RTT + DC * TS;     // k_tᵀ   (DC, TS)
constexpr int OFF_A = OFF_KTT + DC * TS;       // A      (LC, PS); later the
                                               // suffix sums' carries
constexpr int OFF_DA = OFF_A + LC * PS;        // dA     (LC, PS)
constexpr int OFF_DAT = OFF_DA + LC * PS;      // dAᵀ    (LC, PS)
constexpr int OFF_S0 = OFF_DAT + LC * PS;      // S0     (DC, VS); later dr_t
constexpr int OFF_DS = OFF_S0 + DC * VS;       // dS     (DC, VS); later dk_t
constexpr int OFF_U = OFF_DS + DC * VS;        // u      (DC)
constexpr int OFF_CL = OFF_U + DC;             // c_L    (DC)
constexpr int OFF_DCL = OFF_CL + DC;           // dc_L   (DC)
constexpr int OFF_RSUM = OFF_DCL + DC;         // rowsum(dS ⊙ S0) (DC)
constexpr int OFF_BETA = OFF_RSUM + DC;        // β      (LC)
constexpr int OFF_DBETA = OFF_BETA + LC;       // dβ     (LC)
constexpr int OFF_CSUM = OFF_DBETA + LC;       // colsum(k_t ⊙ Y) by 4-row
                                               // group (8, DC)
constexpr size_t SMEM_BYTES = (OFF_CSUM + 8 * DC) * sizeof(float);
static_assert(OFF_V % 4 == 0 && OFF_RTT % 4 == 0 && OFF_S0 % 4 == 0 &&
              OFF_A % 4 == 0, "float4 tiles must be 16-byte aligned");
static_assert(SMEM_BYTES <= 113 * 1024, "2 blocks an SM");

// shared memory of the terms: r/r_t, k/k_t, v, w and dout, (LC, RS) each
enum TermTile { T_R, T_K, T_V, T_W, T_G, N_TERM_TILES };
constexpr size_t TERMS_SMEM_BYTES = N_TERM_TILES * LC * RS * sizeof(float);

__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void store4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
// the barrier between the two halves of the products, which every thread
// reaches once from its own branch
__device__ __forceinline__ void bar_halves() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy `rows` rows of D floats (row stride src_stride in global memory)
// into a tile of row stride dst_stride: 16-byte cp.async copies when vec,
// else element loads (complete after cp_async_wait_all and a barrier).
__device__ __forceinline__ void load_rows(float* dst, int dst_stride,
                                          const float* src, int64_t src_stride,
                                          int rows, int D, bool vec, int tid) {
  if (vec) {
    const int seg = D / 4;
    for (int i = tid; i < rows * seg; i += THREADS) {
      const int t = i / seg, j = i - t * seg;
      cp_async16(dst + t * dst_stride + 4 * j, src + t * src_stride + 4 * j);
    }
  } else {
    for (int i = tid; i < rows * D; i += THREADS) {
      const int t = i / D, d = i - t * D;
      dst[t * dst_stride + d] = src[t * src_stride + d];
    }
  }
}

// fill [0, n) floats of p with x
__device__ __forceinline__ void fill(float* p, int n, float x, int tid) {
  for (int i = tid; i < n; i += THREADS) p[i] = x;
}

// For channel d = tid % 64 and rows 8q..8q+7 (q = tid / 64): the
// cumulative decay one step at a time from row 0 (the rows before 8q
// recomputed, to the same bits), c_prev and c of each row into cp and c8;
// returns c after the quarter's last row.
__device__ __forceinline__ float decay_rows(const float* ww, int d, int q,
                                            float* cp, float* c8) {
  float c = 1.f;
#pragma unroll 8
  for (int t = 0; t < 8 * q; ++t) c *= ww[t * RS + d];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    cp[i] = c;
    c *= ww[(8 * q + i) * RS + d];
    c8[i] = c;
  }
  return c;
}

// 1. c_L and the increments k_tᵀ v and r_tᵀ dout of chunk n of a pair
__global__ void __launch_bounds__(THREADS, 2)
wkv6_bwd_terms_kernel(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ d_out, float* __restrict__ kv,
                      float* __restrict__ rg, float* __restrict__ decay,
                      int Hn, int S, int D, int L, int64_t sb, int64_t ts,
                      int64_t sh, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* rr = smem + T_R * LC * RS;    // r, then r_t
  float* kk = smem + T_K * LC * RS;    // k, then k_t
  float* vv = smem + T_V * LC * RS;
  float* ww = smem + T_W * LC * RS;
  float* gg = smem + T_G * LC * RS;

  const int tid = threadIdx.x;
  const int n_chunks = S / L;
  const int pair = blockIdx.x / n_chunks, n = blockIdx.x - pair * n_chunks;
  const int b = pair / Hn, h = pair - b * Hn;
  const int c0 = n * L;
  const int64_t base = b * sb + h * sh + static_cast<int64_t>(c0) * ts;
  const int64_t gbase = ((static_cast<int64_t>(b) * S + c0) * Hn + h) * D;
  const int64_t slot = static_cast<int64_t>(pair) * n_chunks + n;

  if (L < LC || D < DC) {     // padding: r, k, v, dout zero and w one
    fill(smem, N_TERM_TILES * LC * RS, 0.f, tid);
    __syncthreads();
    fill(ww, LC * RS, 1.f, tid);
    __syncthreads();
  }
  load_rows(rr, RS, r + base, ts, L, D, vec, tid);
  load_rows(kk, RS, k + base, ts, L, D, vec, tid);
  load_rows(vv, RS, v + base, ts, L, D, vec, tid);
  load_rows(ww, RS, w + base, ts, L, D, vec, tid);
  load_rows(gg, RS, d_out + gbase, static_cast<int64_t>(Hn) * D, L, D, vec, tid);
  cp_async_wait_all();
  __syncthreads();

  {   // r_t and k_t in place, a thread a channel and a quarter of the chunk
    const int d = tid % DC, q = tid / DC;
    float cp[8], c8[8];
    const float c = decay_rows(ww, d, q, cp, c8);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = 8 * q + i;
      rr[t * RS + d] *= cp[i];
      kk[t * RS + d] = kk[t * RS + d] / fmaxf(c8[i], 1e-30f);
    }
    if (q == 3 && d < D) decay[slot * D + d] = c;
  }
  __syncthreads();

  // warps 0-3 k_tᵀ v, warps 4-7 r_tᵀ dout: rows 4dg..4dg+3, columns
  // 4eg..4eg+3 and 32+4eg.., each summed over the chunk's rows in order
  // (the forward kernel's state update, so the same bits)
  const int half = tid / 128, q = tid % 128;
  const int dg = q / 8, eg = q % 8;
  const float* xa = half ? rr : kk;
  const float* xb = half ? gg : vv;
  float* out = (half ? rg : kv) + slot * D * D;
  float acc[4][8] = {};
#pragma unroll 8
  for (int s = 0; s < LC; ++s) {
    float a[4], b0[4], b1[4];
    load4(xa + s * RS + 4 * dg, a);
    load4(xb + s * RS + 4 * eg, b0);
    load4(xb + s * RS + 32 + 4 * eg, b1);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][e] = fmaf(a[i], b0[e], acc[i][e]);
        acc[i][4 + e] = fmaf(a[i], b1[e], acc[i][4 + e]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = 4 * dg + i;
    if (d >= D) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int e0 = 32 * hf + 4 * eg;
      if (vec) {
        if (e0 < D) store4(out + d * D + e0, acc[i] + 4 * hf);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (e0 + e < D) out[d * D + e0 + e] = acc[i][4 * hf + e];
      }
    }
  }
}

// 2. a thread a (pair, i, j): the increments in place into S0 (forward)
//    and the end cotangent dS (reverse) of every chunk; d_state0.  SCAN_BATCH
//    chunks' increments and c_L are loaded before any is stored, so the
//    loads of a batch are in flight together
constexpr int SCAN_BATCH = 8;

__global__ void __launch_bounds__(SCAN_THREADS)
wkv6_bwd_scan_kernel(float* __restrict__ kv, float* __restrict__ rg,
                     const float* __restrict__ decay,
                     const float* __restrict__ state0,
                     const float* __restrict__ d_final,
                     float* __restrict__ d_state0, int64_t pairs,
                     int n_chunks, int D) {
  const int64_t DD = static_cast<int64_t>(D) * D;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * SCAN_THREADS + threadIdx.x;
  if (idx >= pairs * DD) return;
  const int64_t pair = idx / DD, ij = idx - pair * DD;
  const int d = static_cast<int>(ij / D);
  float* kvp = kv + pair * n_chunks * DD + ij;
  float* rgp = rg + pair * n_chunks * DD + ij;
  const float* cl = decay + pair * n_chunks * D + d;
  float s = state0 ? state0[idx] : 0.f;
  float ds = d_final ? d_final[idx] : 0.f;
  for (int j0 = 0; j0 < n_chunks; j0 += SCAN_BATCH) {
    float x[SCAN_BATCH], y[SCAN_BATCH], cf[SCAN_BATCH], cr[SCAN_BATCH];
#pragma unroll
    for (int i = 0; i < SCAN_BATCH; ++i) {
      const int f = j0 + i, rv = n_chunks - 1 - f;
      if (f < n_chunks) {
        x[i] = kvp[f * DD];
        y[i] = rgp[rv * DD];
        cf[i] = cl[static_cast<int64_t>(f) * D];
        cr[i] = cl[static_cast<int64_t>(rv) * D];
      }
    }
#pragma unroll
    for (int i = 0; i < SCAN_BATCH; ++i) {
      const int f = j0 + i, rv = n_chunks - 1 - f;
      if (f < n_chunks) {
        kvp[f * DD] = s;
        rgp[rv * DD] = ds;
        s = cf[i] * (s + x[i]);
        ds = fmaf(cr[i], ds, y[i]);
      }
    }
  }
  if (d_state0) d_state0[idx] = ds;
}

// 3. the chunk backward: chunk n of a pair from its S0 and dS
__global__ void __launch_bounds__(THREADS, 2)
wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, int64_t u_bstride,
                const float* __restrict__ d_out,
                const float* __restrict__ starts,
                const float* __restrict__ d_ends, float* __restrict__ dr,
                float* __restrict__ dk, float* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ du, int Hn,
                int S, int D, int L, int64_t sb, int64_t ts, int64_t sh,
                bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* rr = smem + OFF_R;
  float* kk = smem + OFF_K;
  float* ww = smem + OFF_W;
  float* gg = smem + OFF_G;
  float* vv = smem + OFF_V;
  float* rtt = smem + OFF_RTT;
  float* ktt = smem + OFF_KTT;
  float* aa = smem + OFF_A;
  float* dda = smem + OFF_DA;
  float* dat = smem + OFF_DAT;
  float* s0 = smem + OFF_S0;
  float* ds = smem + OFF_DS;
  float* drt = smem + OFF_S0;          // after the first half's barrier
  float* dkt = smem + OFF_DS;
  float* us = smem + OFF_U;
  float* cl = smem + OFF_CL;
  float* dcl = smem + OFF_DCL;
  float* rsum = smem + OFF_RSUM;
  float* beta = smem + OFF_BETA;
  float* dbeta = smem + OFF_DBETA;
  float* csum = smem + OFF_CSUM;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int n_chunks = S / L;
  const int pair = blockIdx.x / n_chunks, n = blockIdx.x - pair * n_chunks;
  const int b = pair / Hn, h = pair - b * Hn;
  const int c0 = n * L;
  const int64_t base = b * sb + h * sh + static_cast<int64_t>(c0) * ts;
  const int64_t row_stride = static_cast<int64_t>(Hn) * D;   // of d_out, dr..
  const int64_t gbase = ((static_cast<int64_t>(b) * S + c0) * Hn + h) * D;
  const int64_t slot = static_cast<int64_t>(pair) * n_chunks + n;

  // 0. the chunk's rows, u, S0 and dS; padding zero (w one)
  if (L < LC || D < DC) {
    fill(smem, OFF_U, 0.f, tid);
    __syncthreads();
    fill(ww, LC * RS, 1.f, tid);
    __syncthreads();
  }
  load_rows(rr, RS, r + base, ts, L, D, vec, tid);
  load_rows(kk, RS, k + base, ts, L, D, vec, tid);
  load_rows(ww, RS, w + base, ts, L, D, vec, tid);
  load_rows(vv, VS, v + base, ts, L, D, vec, tid);
  load_rows(gg, RS, d_out + gbase, row_stride, L, D, vec, tid);
  load_rows(s0, VS, starts + slot * D * D, D, D, D, vec, tid);
  load_rows(ds, VS, d_ends + slot * D * D, D, D, D, vec, tid);
  for (int i = tid; i < DC; i += THREADS)
    us[i] = i < D ? u[b * u_bstride + static_cast<int64_t>(h) * D + i] : 0.f;
  cp_async_wait_all();
  __syncthreads();

  // 1. for channel d and rows 8q..8q+7: r_tᵀ and k_tᵀ (two float4 each);
  //    c_L; β and dβ of rows 4·warp..4·warp+3 by warp sums
  {
    const int d = tid % DC, q = tid / DC;
    float cp[8], c8[8], x[8], y[8];
    const float c = decay_rows(ww, d, q, cp, c8);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = 8 * q + i;
      x[i] = rr[t * RS + d] * cp[i];
      y[i] = kk[t * RS + d] / fmaxf(c8[i], 1e-30f);
    }
    store4(rtt + d * TS + 8 * q, x);
    store4(rtt + d * TS + 8 * q + 4, x + 4);
    store4(ktt + d * TS + 8 * q, y);
    store4(ktt + d * TS + 8 * q + 4, y + 4);
    if (q == 3) cl[d] = c;
#pragma unroll
    for (int t = 4 * warp; t < 4 * warp + 4; ++t) {
      float bt = 0.f, dbt = 0.f;
#pragma unroll
      for (int e = lane; e < DC; e += 32) {
        bt = fmaf(rr[t * RS + e] * us[e], kk[t * RS + e], bt);
        dbt = fmaf(gg[t * RS + e], vv[t * VS + e], dbt);
      }
      for (int o = 16; o > 0; o >>= 1) {
        bt += __shfl_xor_sync(0xffffffffu, bt, o);
        dbt += __shfl_xor_sync(0xffffffffu, dbt, o);
      }
      if (lane == 0) {
        beta[t] = bt;
        dbeta[t] = dbt;
      }
    }
  }
  __syncthreads();

  // 2-3. the products, a pair of warps each; 4 × 8 tiles a thread
  const int pw = warp / 2, q = tid % 64;
  const int hi = q / 8, lo = q % 8;
  float acc[4][8] = {};
  if (pw == 0) {
    // dv, rows s = 4hi..4hi+3, columns e = 4lo.. and 32+4lo..: first
    // k_t G with G = diag(c_L) dS, summed over the channels
    const int sg = hi, eg = lo;
#pragma unroll 4
    for (int d = 0; d < DC; ++d) {
      float a[4], b0[4], b1[4];
      load4(ktt + d * TS + 4 * sg, a);
      load4(ds + d * VS + 4 * eg, b0);
      load4(ds + d * VS + 32 + 4 * eg, b1);
      const float c = cl[d];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        b0[e] *= c;
        b1[e] *= c;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][e] = fmaf(a[i], b0[e], acc[i][e]);
          acc[i][4 + e] = fmaf(a[i], b1[e], acc[i][4 + e]);
        }
    }
    bar_halves();
    // then Aᵀ dout over the rows t > s, and β ⊙ dout, onto k_t G
#pragma unroll 4
    for (int t = 4 * sg + 1; t < LC; ++t) {
      float a[4], b0[4], b1[4];
      load4(aa + t * PS + 4 * sg, a);
      load4(gg + t * RS + 4 * eg, b0);
      load4(gg + t * RS + 32 + 4 * eg, b1);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][e] = fmaf(a[i], b0[e], acc[i][e]);
          acc[i][4 + e] = fmaf(a[i], b1[e], acc[i][4 + e]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = 4 * sg + i;
      if (s >= L) continue;
      const float bt = beta[s];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int e0 = 32 * hf + 4 * eg;
        float gv[4], o[4];
        load4(gg + s * RS + e0, gv);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[e] = fmaf(bt, gv[e], acc[i][4 * hf + e]);
        float* dst = dv + gbase + s * row_stride + e0;
        if (vec) {
          if (e0 < D) store4(dst, o);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (e0 + e < D) dst[e] = o[e];
        }
      }
    }
  } else if (pw == 1) {
    // dr_t, rows t = 4hi..4hi+3, columns d = lo + 8j: first dout S0ᵀ,
    // summed over the columns in order
    const int tg = hi, dg = lo;
#pragma unroll 2
    for (int e = 0; e < DC; e += 4) {
      float a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load4(gg + (4 * tg + i) * RS + e, a[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float bs[4];
        load4(s0 + (dg + 8 * j) * VS + e, bs);
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i][x], bs[x], acc[i][j]);
      }
    }
    bar_halves();
    // then dA k_t over the columns s < t, onto dout S0ᵀ
    for (int s = 0; s < 4 * tg + 4; s += 4) {
      float a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load4(dda + (4 * tg + i) * PS + s, a[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float bk[4];
        load4(ktt + (dg + 8 * j) * TS + s, bk);
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i][x], bk[x], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) drt[(4 * tg + i) * RS + dg + 8 * j] = acc[i][j];
  } else if (pw == 2) {
    // dk_t, rows s = 4hi..4hi+3, columns d = lo + 8j: first Y = v dSᵀ and
    // the rows' share of colsum(k_t ⊙ Y)
    const int sg = hi, dg = lo;
#pragma unroll 2
    for (int e = 0; e < DC; e += 4) {
      float a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load4(vv + (4 * sg + i) * VS + e, a[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float bs[4];
        load4(ds + (dg + 8 * j) * VS + e, bs);
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i][x], bs[x], acc[i][j]);
      }
    }
    // colsum(k_t ⊙ Y) of the 4 rows, then c_L ⊙ Y
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float kt4[4];
      load4(ktt + (dg + 8 * j) * TS + 4 * sg, kt4);
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) p = fmaf(kt4[i], acc[i][j], p);
      csum[sg * DC + dg + 8 * j] = p;
      const float c = cl[dg + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] *= c;
    }
    bar_halves();
    // then dAᵀ r_t over the rows t > s, onto c_L ⊙ Y
    for (int t = 4 * sg; t < LC; t += 4) {
      float a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load4(dat + (4 * sg + i) * PS + t, a[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float br[4];
        load4(rtt + (dg + 8 * j) * TS + t, br);
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i][x], br[x], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dkt[(4 * sg + i) * RS + dg + 8 * j] = acc[i][j];
  } else {
    // A (rows t = 4hi.., columns s = 4lo..) from r_tᵀ and k_tᵀ over the
    // channels; dA (rows t = 4hi.., columns s = lo + 8j) over v's columns;
    // both zero on and above the diagonal; dA also transposed
    const int tg = hi;
    {
      const int sg = lo;
      float p[4][4] = {};
#pragma unroll 8
      for (int d = 0; d < DC; ++d) {
        float a[4], bk[4];
        load4(rtt + d * TS + 4 * tg, a);
        load4(ktt + d * TS + 4 * sg, bk);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) p[i][j] = fmaf(a[i], bk[j], p[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * tg + i;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (4 * sg + j >= t) p[i][j] = 0.f;
        store4(aa + t * PS + 4 * sg, p[i]);
      }
    }
    {
      const int sj = lo;
      float p[4][4] = {};
#pragma unroll 4
      for (int e = 0; e < DC; e += 4) {
        float a[4][4], bv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) load4(gg + (4 * tg + i) * RS + e, a[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) load4(vv + (sj + 8 * j) * VS + e, bv[j]);
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) p[i][j] = fmaf(a[i][x], bv[j][x], p[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = 4 * tg + i, s = sj + 8 * j;
          const float x = s < t ? p[i][j] : 0.f;
          dda[t * PS + s] = x;
          dat[s * PS + t] = x;
        }
    }
    {   // rowsum(dS ⊙ S0), a thread a channel, in column order
      const int d = q;
      float acc2 = 0.f;
#pragma unroll 4
      for (int e = 0; e < DC; e += 4) {
        float a[4], bs[4];
        load4(ds + d * VS + e, a);
        load4(s0 + d * VS + e, bs);
#pragma unroll
        for (int x = 0; x < 4; ++x) acc2 = fmaf(a[x], bs[x], acc2);
      }
      rsum[d] = acc2;
    }
    bar_halves();
    {   // dc_L = rowsum(dS ⊙ S0) + colsum(k_t ⊙ Y)
      const int d = q;
      float cs = 0.f;
#pragma unroll
      for (int g = 0; g < 8; ++g) cs += csum[g * DC + d];
      dcl[d] = rsum[d] + cs;
    }
  }
  __syncthreads();

  // 4. for channel d and rows 8q..8q+7: dr and dk (to memory), the
  //    decay's cotangent dc, the suffix sums into dw, and du
  {
    const int d = tid % DC, qq = tid / DC;
    float* qloc = aa;                 // (4, DC): a quarter's q at its first row
    float* pprod = aa + 4 * DC;       // (4, DC): Π w carrying the next into it
    float* dup = aa + 8 * DC;         // (4, DC): a quarter's share of du
    float cp[8], c8[8], dc[8];
    decay_rows(ww, d, qq, cp, c8);
    const float ud = us[d];
    float du_acc = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = 8 * qq + i;
      const float cm = fmaxf(c8[i], 1e-30f);
      const float kt = kk[t * RS + d] / cm;
      const float dkt_t = dkt[t * RS + d];
      const float bu = dbeta[t] * ud;
      if (t < L && d < D) {
        dr[gbase + t * row_stride + d] = fmaf(bu, kk[t * RS + d], drt[t * RS + d] * cp[i]);
        dk[gbase + t * row_stride + d] = fmaf(bu, rr[t * RS + d], dkt_t / cm);
      }
      float x = 0.f;
      if (c8[i] > 1e-30f)
        x = -(dkt_t * kt) / cm;
      else if (c8[i] == 1e-30f)
        x = -(dkt_t * kt) / cm * 0.5f;
      if (t + 1 < L)
        x += drt[(t + 1) * RS + d] * rr[(t + 1) * RS + d];
      else if (t + 1 == L)
        x += dcl[d];
      dc[i] = x;
      du_acc = fmaf(dbeta[t] * rr[t * RS + d], kk[t * RS + d], du_acc);
    }
    // the quarter's suffix sums from a zero carry, and the product of w
    // that carries q of the next quarter's first row into each row
    float ql[8], pl[8];
    float qn = 0.f, pn = 1.f;
#pragma unroll
    for (int i = 7; i >= 0; --i) {
      const int t = 8 * qq + i;
      const float wn = t + 1 < LC ? ww[(t + 1) * RS + d] : 0.f;
      qn = fmaf(wn, qn, dc[i]);
      pn *= wn;
      ql[i] = qn;
      pl[i] = pn;
    }
    qloc[qq * DC + d] = ql[0];
    pprod[qq * DC + d] = pl[0];
    dup[qq * DC + d] = du_acc;
    __syncthreads();
    float carry = 0.f;
    for (int j = 3; j > qq; --j) carry = fmaf(pprod[j * DC + d], carry, qloc[j * DC + d]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = 8 * qq + i;
      if (t < L && d < D)
        dw[gbase + t * row_stride + d] = cp[i] * fmaf(pl[i], carry, ql[i]);
    }
    if (qq == 0 && d < D)
      du[slot * D + d] = ((dup[d] + dup[DC + d]) + dup[2 * DC + d]) + dup[3 * DC + d];
  }
}

// the dynamic shared memory above 48 KB, and the largest carveout so that
// 2 blocks fit: set once a card (the first 64)
cudaError_t prepare() {
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (ready.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(wkv6_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM_BYTES));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wkv6_bwd_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wkv6_bwd_terms_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(TERMS_SMEM_BYTES));
  if (err == cudaSuccess) ready.fetch_or(bit);
  return err;
}

bool bad_shape(int B, int Hn, int S, int D, int L) {
  return B < 1 || Hn < 1 || static_cast<long long>(B) * Hn > 0x7fffffffLL ||
         D < 1 || D > DC || L < 1 || L > LC || S < L || S % L ||
         static_cast<long long>(B) * Hn * (S / L) > 0x7fffffffLL;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The launches named in `parts` (bit 0 the chunk terms, bit 1 the state
// scan, bit 2 the chunk backward; 7 for the whole backward), in that
// order.  r, k, v, w share the strides sb (batch), ts (token) and sh
// (head), in elements, with D contiguous; d_out, dr, dk, dv, dw are
// contiguous (B, S, Hn, D); u: row b·u_bstride + h·D; state0, d_final and
// d_state0 (B, Hn, D, D) or null (zero start state; zero cotangent of the
// final state; no cotangent of the start state wanted).  scratch: f32,
// with P = B·Hn pairs and N = S/L chunks a pair, the start states
// (P, N, D, D), then the end cotangents (P, N, D, D), c_L (P, N, D) and
// the du rows (P·N, D), a row a (pair, chunk).  The grids must be
// blocks = P·N (the terms and the chunk backward) and scan_blocks =
// ⌈P·D² / 256⌉.  S a
// positive multiple of L, L ≤ 32, D ≤ 64.  Returns the cudaError_t of the
// first launch that failed.
extern "C" int wkv6_bwd_launch(const float* r, const float* k, const float* v,
                               const float* w, const float* u,
                               long long u_bstride, const float* state0,
                               const float* d_out, const float* d_final,
                               float* dr, float* dk, float* dv, float* dw,
                               float* d_state0, float* scratch, int B, int Hn,
                               int S, int D, int L, long long sb, long long ts,
                               long long sh, int blocks, int scan_blocks,
                               int parts, void* stream) {
  if (bad_shape(B, Hn, S, D, L) || parts < 1 || parts > 7)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long P = static_cast<long long>(B) * Hn, N = S / L;
  if (blocks != P * N ||
      scan_blocks != (P * D * D + SCAN_THREADS - 1) / SCAN_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = D % 4 == 0 && sb % 4 == 0 && ts % 4 == 0 && sh % 4 == 0 &&
                   aligned16(r) && aligned16(k) && aligned16(v) &&
                   aligned16(w) && aligned16(d_out) && aligned16(dv) &&
                   aligned16(scratch);
  float* starts = scratch;
  float* d_ends = starts + P * N * D * D;
  float* decay = d_ends + P * N * D * D;
  float* du = decay + P * N * D;
  if (parts & 1) {
    wkv6_bwd_terms_kernel<<<blocks, THREADS, TERMS_SMEM_BYTES, st>>>(
        r, k, v, w, d_out, starts, d_ends, decay, Hn, S, D, L, sb, ts, sh, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (parts & 2) {
    wkv6_bwd_scan_kernel<<<scan_blocks, SCAN_THREADS, 0, st>>>(
        starts, d_ends, decay, state0, d_final, d_state0, P, S / L, D);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (parts & 4) {
    wkv6_bwd_kernel<<<blocks, THREADS, SMEM_BYTES, st>>>(
        r, k, v, w, u, u_bstride, d_out, starts, d_ends, dr, dk, dv, dw, du,
        Hn, S, D, L, sb, ts, sh, vec);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

// The resources of launch `which` (0 terms, 1 scan, 2 chunk backward):
// resident blocks an SM (the CUDA occupancy calculator at its dynamic
// shared memory), registers a thread, shared memory a block and local
// memory a thread (spills), in bytes.
extern "C" int wkv6_bwd_occupancy(int which, int* blocks, int* regs,
                                  int* smem, int* local) {
  cudaError_t err = prepare();
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* fn;
  int threads;
  size_t bytes;
  if (which == 0) {
    fn = reinterpret_cast<const void*>(wkv6_bwd_terms_kernel);
    threads = THREADS;
    bytes = TERMS_SMEM_BYTES;
  } else if (which == 1) {
    fn = reinterpret_cast<const void*>(wkv6_bwd_scan_kernel);
    threads = SCAN_THREADS;
    bytes = 0;
  } else if (which == 2) {
    fn = reinterpret_cast<const void*>(wkv6_bwd_kernel);
    threads = THREADS;
    bytes = SMEM_BYTES;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, threads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *smem = static_cast<int>(bytes + attr.sharedSizeBytes);
  *local = static_cast<int>(attr.localSizeBytes);
  return 0;
}
