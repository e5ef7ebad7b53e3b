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
//     dS   ← diag(c_L) dS + r_tᵀ dout                (the chunk before's)
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
// r, k, v, w: (B, S, Hn, D) f32 with D contiguous and the forward's batch,
// token and head strides; d_out, dr, dk, dv, dw: contiguous (B, S, Hn, D);
// u: row b·u_bstride + h·D; state0, d_final, d_state0: (B, Hn, D, D) or
// null; du: (B·Hn, D) partials, one row a pair (summed over the batch by
// the wrapper: no float atomics, so the result is the same every call);
// states: a (B·Hn, S/L, D, D) scratch.  The (BH, S, D) entry is Hn = 1
// with u_bstride = D.
//
// Design, simple first: one block of 256 threads a pair.  A forward sweep
// recomputes each chunk's start state into the scratch (the forward
// kernel's arithmetic, so the same bits), then the chunks are walked in
// reverse with dS in shared memory.  A chunk's tiles (r, k, v, w, dout, c,
// r_t, k_t, dr_t, dk_t, Y: row stride 65 floats, so a warp reading a
// column hits 32 banks), A and dA and the two (D, D) states live in
// 134,272 B of shared memory, one block an SM.  Every product is an f32
// FMA loop over shared memory, a thread an output element; the sequential
// parts (the decay a channel, β a row, the suffix sums) run a thread each.
//
// Bound: at the training shape (2, 128, 40, 64) the bytes (r, k, v, w,
// dout read, dr, dk, dv, dw written: 9 × 2.6 MB) and the ≈ 1.7 MFLOP of
// f32 work a chunk are both a few µs of the card; one wave of 80 blocks
// walks 4 chunks each, so the chunk's dependent phases and their barriers
// set the time.  At (8, 2,048, 40, 64): 1.5 GB (0.45 ms) and 35 GFLOP
// (0.52 ms at 67 TFLOP/s), three waves of 64 chunks.
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int LC = 32;            // longest chunk
constexpr int DC = 64;            // largest head dimension
constexpr int RS = DC + 1;        // row stride of the (L, D) tiles
constexpr int PS = LC + 1;        // row stride of A and dA
constexpr int SS = DC + 1;        // row stride of the (D, D) states
constexpr int NDS = DC * DC / THREADS;   // dS entries a thread
static_assert(DC + LC <= THREADS, "β and dβ run beside the decay");

// shared memory, in floats
enum Tile { R, K, V, W, G, C, RT, KT, DRT, DKT, Y, N_TILES };
constexpr int OFF_A = N_TILES * LC * RS;        // A      (L, L)
constexpr int OFF_DA = OFF_A + LC * PS;         // dA     (L, L)
constexpr int OFF_S0 = OFF_DA + LC * PS;        // S0     (D, D)
constexpr int OFF_DS = OFF_S0 + DC * SS;        // dS     (D, D)
constexpr int OFF_U = OFF_DS + DC * SS;         // u      (D)
constexpr int OFF_CL = OFF_U + DC;              // c_L    (D)
constexpr int OFF_DCL = OFF_CL + DC;            // dc_L   (D)
constexpr int OFF_BETA = OFF_DCL + DC;          // β      (L)
constexpr int OFF_DBETA = OFF_BETA + LC;        // dβ     (L)
constexpr size_t SMEM_BYTES = (OFF_DBETA + LC) * sizeof(float);

__global__ void __launch_bounds__(THREADS, 1)
wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, int64_t u_bstride,
                const float* __restrict__ state0,
                const float* __restrict__ d_out,
                const float* __restrict__ d_final, float* __restrict__ dr,
                float* __restrict__ dk, float* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ du,
                float* __restrict__ d_state0, float* __restrict__ states,
                int Hn, int S, int D, int L, int64_t sb, int64_t ts,
                int64_t sh) {
  extern __shared__ float smem[];
  float* rr = smem + R * LC * RS;
  float* kk = smem + K * LC * RS;
  float* vv = smem + V * LC * RS;
  float* ww = smem + W * LC * RS;
  float* gg = smem + G * LC * RS;
  float* cc = smem + C * LC * RS;
  float* rt = smem + RT * LC * RS;
  float* kt = smem + KT * LC * RS;
  float* drt = smem + DRT * LC * RS;
  float* dkt = smem + DKT * LC * RS;
  float* yy = smem + Y * LC * RS;      // Y, then the decay's cotangent dc
  float* aa = smem + OFF_A;
  float* dda = smem + OFF_DA;
  float* s0 = smem + OFF_S0;
  float* ds = smem + OFF_DS;
  float* us = smem + OFF_U;
  float* cl = smem + OFF_CL;
  float* dcl = smem + OFF_DCL;
  float* beta = smem + OFF_BETA;
  float* dbeta = smem + OFF_DBETA;

  const int tid = threadIdx.x;
  const int pair = blockIdx.x;
  const int b = pair / Hn, h = pair - b * Hn;
  const int64_t in_base = b * sb + h * sh;
  const int n_chunks = S / L;
  const int LD = L * D, DD = D * D;
  float* my_states = states + static_cast<int64_t>(pair) * n_chunks * DD;
  // element (token t of the pair, channel d) of a contiguous (B, S, Hn, D)
  auto at = [&](int t, int d) {
    return (static_cast<int64_t>(b) * S + t) * Hn * D +
           static_cast<int64_t>(h) * D + d;
  };

  for (int i = tid; i < D; i += THREADS)
    us[i] = u[b * u_bstride + static_cast<int64_t>(h) * D + i];
  for (int i = tid; i < DD; i += THREADS) {
    const int d = i / D, e = i - d * D;
    s0[d * SS + e] = state0 ? state0[static_cast<int64_t>(pair) * DD + i] : 0.f;
  }
  __syncthreads();

  // 1. forward sweep: each chunk's start state into the scratch
  for (int n = 0; n < n_chunks; ++n) {
    const int64_t base = in_base + static_cast<int64_t>(n) * L * ts;
    for (int i = tid; i < DD; i += THREADS) {
      const int d = i / D, e = i - d * D;
      my_states[static_cast<int64_t>(n) * DD + i] = s0[d * SS + e];
    }
    for (int i = tid; i < LD; i += THREADS) {
      const int t = i / D, d = i - t * D;
      const int64_t gi = base + t * ts + d;
      kk[t * RS + d] = k[gi];
      vv[t * RS + d] = v[gi];
      ww[t * RS + d] = w[gi];
    }
    __syncthreads();
    if (tid < D) {
      const int d = tid;
      float c = 1.f;
      for (int t = 0; t < L; ++t) {
        c *= ww[t * RS + d];
        kt[t * RS + d] = kk[t * RS + d] / fmaxf(c, 1e-30f);
      }
      cl[d] = c;
    }
    __syncthreads();
    for (int i = tid; i < DD; i += THREADS) {
      const int d = i / D, e = i - d * D;
      float acc = 0.f;
      for (int s = 0; s < L; ++s) acc = fmaf(kt[s * RS + d], vv[s * RS + e], acc);
      s0[d * SS + e] = cl[d] * (s0[d * SS + e] + acc);
    }
    __syncthreads();
  }

  // 2. the chunks in reverse, dS carried in shared memory
  for (int i = tid; i < DD; i += THREADS) {
    const int d = i / D, e = i - d * D;
    ds[d * SS + e] = d_final ? d_final[static_cast<int64_t>(pair) * DD + i] : 0.f;
  }
  float du_acc = 0.f;                  // thread d < D: du[d]
  for (int n = n_chunks - 1; n >= 0; --n) {
    const int c0 = n * L;
    const int64_t base = in_base + static_cast<int64_t>(c0) * ts;
    for (int i = tid; i < DD; i += THREADS) {
      const int d = i / D, e = i - d * D;
      s0[d * SS + e] = my_states[static_cast<int64_t>(n) * DD + i];
    }
    for (int i = tid; i < LD; i += THREADS) {
      const int t = i / D, d = i - t * D;
      const int64_t gi = base + t * ts + d;
      rr[t * RS + d] = r[gi];
      kk[t * RS + d] = k[gi];
      vv[t * RS + d] = v[gi];
      ww[t * RS + d] = w[gi];
      gg[t * RS + d] = d_out[at(c0 + t, d)];
    }
    __syncthreads();

    // a. the decay, r_t and k_t, a thread a channel; β and dβ a thread a row
    if (tid < D) {
      const int d = tid;
      float c = 1.f;
      for (int t = 0; t < L; ++t) {
        const float cp = c;
        c *= ww[t * RS + d];
        cc[t * RS + d] = c;
        rt[t * RS + d] = rr[t * RS + d] * cp;
        kt[t * RS + d] = kk[t * RS + d] / fmaxf(c, 1e-30f);
      }
      cl[d] = c;
    } else if (tid >= DC && tid < DC + L) {
      const int t = tid - DC;
      float bt = 0.f, dbt = 0.f;
      for (int d = 0; d < D; ++d) {
        bt = fmaf(rr[t * RS + d] * us[d], kk[t * RS + d], bt);
        dbt = fmaf(gg[t * RS + d], vv[t * RS + d], dbt);
      }
      beta[t] = bt;
      dbeta[t] = dbt;
    }
    __syncthreads();

    // b. A and dA (zero on and above the diagonal), Y = v dSᵀ
    for (int i = tid; i < L * L; i += THREADS) {
      const int t = i / L, s = i - t * L;
      float a = 0.f, da = 0.f;
      if (s < t) {
        for (int d = 0; d < D; ++d) {
          a = fmaf(rt[t * RS + d], kt[s * RS + d], a);
          da = fmaf(gg[t * RS + d], vv[s * RS + d], da);
        }
      }
      aa[t * PS + s] = a;
      dda[t * PS + s] = da;
    }
    for (int i = tid; i < LD; i += THREADS) {
      const int s = i / D, d = i - s * D;
      float y = 0.f;
      for (int e = 0; e < D; ++e) y = fmaf(vv[s * RS + e], ds[d * SS + e], y);
      yy[s * RS + d] = y;
    }
    __syncthreads();

    // c. dv (to memory), dr_t, dk_t and dc_L
    for (int i = tid; i < LD; i += THREADS) {
      const int s = i / D, e = i - s * D;
      float acc = 0.f;
      for (int t = s + 1; t < L; ++t) acc = fmaf(aa[t * PS + s], gg[t * RS + e], acc);
      acc = fmaf(beta[s], gg[s * RS + e], acc);
      float kg = 0.f;
      for (int d = 0; d < D; ++d)
        kg = fmaf(kt[s * RS + d], cl[d] * ds[d * SS + e], kg);
      dv[at(c0 + s, e)] = acc + kg;
    }
    for (int i = tid; i < LD; i += THREADS) {
      const int t = i / D, d = i - t * D;
      float acc = 0.f;
      for (int s = 0; s < t; ++s) acc = fmaf(dda[t * PS + s], kt[s * RS + d], acc);
      float gs = 0.f;
      for (int e = 0; e < D; ++e) gs = fmaf(gg[t * RS + e], s0[d * SS + e], gs);
      drt[t * RS + d] = acc + gs;
      float acc2 = 0.f;
      for (int q = t + 1; q < L; ++q) acc2 = fmaf(dda[q * PS + t], rt[q * RS + d], acc2);
      dkt[t * RS + d] = fmaf(cl[d], yy[t * RS + d], acc2);
    }
    for (int d = tid; d < D; d += THREADS) {
      float acc = 0.f;
      for (int e = 0; e < D; ++e) acc = fmaf(ds[d * SS + e], s0[d * SS + e], acc);
      float acc2 = 0.f;
      for (int s = 0; s < L; ++s) acc2 = fmaf(kt[s * RS + d], yy[s * RS + d], acc2);
      dcl[d] = acc + acc2;
    }
    __syncthreads();

    // d. the chunk before's dS, held in registers until every read of dS
    //    is done; dr, dk (to memory) and the decay's cotangent dc (into Y)
    float nds[NDS];
#pragma unroll
    for (int j = 0; j < NDS; ++j) {
      const int i = tid + j * THREADS;
      nds[j] = 0.f;
      if (i < DD) {
        const int d = i / D, e = i - d * D;
        float acc = 0.f;
        for (int t = 0; t < L; ++t) acc = fmaf(rt[t * RS + d], gg[t * RS + e], acc);
        nds[j] = fmaf(cl[d], ds[d * SS + e], acc);
      }
    }
    for (int i = tid; i < LD; i += THREADS) {
      const int t = i / D, d = i - t * D;
      const float c = cc[t * RS + d];
      const float cp = t ? cc[(t - 1) * RS + d] : 1.f;
      const float cm = fmaxf(c, 1e-30f);
      const float bu = dbeta[t] * us[d];
      dr[at(c0 + t, d)] = fmaf(bu, kk[t * RS + d], drt[t * RS + d] * cp);
      dk[at(c0 + t, d)] = fmaf(bu, rr[t * RS + d], dkt[t * RS + d] / cm);
      float dc = 0.f;
      if (c > 1e-30f)
        dc = -(dkt[t * RS + d] * kt[t * RS + d]) / cm;
      else if (c == 1e-30f)
        dc = -(dkt[t * RS + d] * kt[t * RS + d]) / cm * 0.5f;
      dc += t + 1 < L ? drt[(t + 1) * RS + d] * rr[(t + 1) * RS + d] : dcl[d];
      yy[t * RS + d] = dc;
    }
    __syncthreads();

    // e. dS stored; a thread a channel: the suffix sums into dw, and du
#pragma unroll
    for (int j = 0; j < NDS; ++j) {
      const int i = tid + j * THREADS;
      if (i < DD) {
        const int d = i / D, e = i - d * D;
        ds[d * SS + e] = nds[j];
      }
    }
    if (tid < D) {
      const int d = tid;
      float q = yy[(L - 1) * RS + d];
      dw[at(c0 + L - 1, d)] = (L > 1 ? cc[(L - 2) * RS + d] : 1.f) * q;
      for (int t = L - 2; t >= 0; --t) {
        q = fmaf(ww[(t + 1) * RS + d], q, yy[t * RS + d]);
        dw[at(c0 + t, d)] = (t ? cc[(t - 1) * RS + d] : 1.f) * q;
      }
      float acc = 0.f;
      for (int t = 0; t < L; ++t)
        acc = fmaf(dbeta[t] * rr[t * RS + d], kk[t * RS + d], acc);
      du_acc += acc;
    }
    __syncthreads();
  }

  if (tid < D) du[static_cast<int64_t>(pair) * D + tid] = du_acc;
  if (d_state0) {
    for (int i = tid; i < DD; i += THREADS) {
      const int d = i / D, e = i - d * D;
      d_state0[static_cast<int64_t>(pair) * DD + i] = ds[d * SS + e];
    }
  }
}

// the dynamic shared memory above 48 KB: set once a card (the first 64)
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
  if (err == cudaSuccess) ready.fetch_or(bit);
  return err;
}

}  // namespace

// All tensors f32.  r, k, v, w share the strides sb (batch), ts (token)
// and sh (head), in elements, with D contiguous; d_out, dr, dk, dv, dw are
// contiguous (B, S, Hn, D); state0, d_final and d_state0 (B, Hn, D, D) or
// null (zero start state; zero cotangent of the final state; no
// cotangent of the start state wanted); du (B·Hn, D); states a scratch of
// B·Hn·(S/L)·D·D floats.  S must be a positive multiple of L, L ≤ 32,
// D ≤ 64, B·Hn < 2^31.  Returns the cudaError_t of the launch.
extern "C" int wkv6_bwd_launch(const float* r, const float* k, const float* v,
                               const float* w, const float* u,
                               long long u_bstride, const float* state0,
                               const float* d_out, const float* d_final,
                               float* dr, float* dk, float* dv, float* dw,
                               float* du, float* d_state0, float* states,
                               int B, int Hn, int S, int D, int L,
                               long long sb, long long ts, long long sh,
                               void* stream) {
  if (B < 1 || Hn < 1 || static_cast<long long>(B) * Hn > 0x7fffffffLL ||
      D < 1 || D > DC || L < 1 || L > LC || S < L || S % L)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_kernel<<<B * Hn, THREADS, SMEM_BYTES,
                    static_cast<cudaStream_t>(stream)>>>(
      r, k, v, w, u, u_bstride, state0, d_out, d_final, dr, dk, dv, dw, du,
      d_state0, states, Hn, S, D, L, sb, ts, sh);
  return static_cast<int>(cudaGetLastError());
}
