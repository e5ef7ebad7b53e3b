// RWKV-6 chunk-parallel WKV for Hopper (sm_90a).  Replaces the TPU kernel
// kernels/wkv6.py:wkv6 of the reference package (same chunk math as its
// models/rwkv._wkv_chunked).  Per (batch, head) pair, per chunk of length
// L, in f32, with the (D, D) state S carried across the pair's chunks from
// a given start state or zeros:
//
//     c     = cumprod(w)                     (along the chunk)
//     r_t   = r ⊙ c_prev,   k_t = k / max(c, 1e-30)
//     out   = [(r_t k_tᵀ) ⊙ strict-lower] v + rowsum(r ⊙ u ⊙ k) v + r_t S
//     S    ← diag(c_L) (S + k_tᵀ v)
//
// r, k, v, w: (B, S, Hn, D) f32 or bf16, D contiguous, with batch, token
// and head strides given in elements (a slice t[:, :n] of a longer prompt
// is a strided view); u: f32, row b·u_bstride + h·D; state0: the start S,
// (B, Hn, D, D) f32, or null for zeros; out: a contiguous (B, S, Hn, D) in
// r's type; state: the final S, (B, Hn, D, D) f32.  The (BH, S, D) entry
// is the case Hn = 1 with u_bstride = D.
//
// Bound: at the serving shape (B·Hn = 320, S = 2,048, D = 64, f32) HBM
// bytes (r, k, v, w read once, out written once: 0.84 GB, 0.25 ms) and the
// f32 work (≈ 0.7 MFLOP a chunk, 0.21 ms at 67 TFLOP/s) are close.
// Design:
//
//   * one block of 256 threads a pair owns all D columns, so each chunk's
//     scores are computed once (320 blocks; 71,808 B of shared memory and
//     ≤ 80 registers a thread keep 3 blocks an SM resident, one wave on
//     132 SMs);
//   * the two halves of the block split the four products: warps 0-3 own
//     out (a 4 × 4 tile a thread: r_t S over D, then the masked scores
//     times v plus the bonus, summed apart and added last), warps 4-7 the
//     scores (a 2 × 4 tile a thread) and the state update (a 4 × 8 tile of
//     k_tᵀ v a thread).  Two named barriers order them: the scores are
//     ready for the output warps, and the output warps are done reading S
//     before it is overwritten;
//   * every product runs in f32 FMAs from registers: a thread loads float4
//     rows of both operands from shared memory and does 5 to 11 FMAs for
//     every load; row strides of 68 and 36 floats and the thread tiles are
//     laid out so a warp's float4 loads hit distinct banks or broadcast;
//   * the cumulative decay, r_t and k_t run in all 256 threads: a thread
//     a channel and a quarter of the chunk, which recomputes the decay of
//     the rows before its quarter (at most 24 more multiplies, the same
//     bits) and so needs no barrier between the decay and the divisions;
//   * the raw r, k, w of the next chunk are copied by cp.async while this
//     chunk's products run; v's copy follows once the products are done
//     with the current v, from L2, where a prefetch put it earlier;
//   * rows are 16-byte cp.async copies where D, the strides and the base
//     addresses allow it (D % 4 == 0 in f32, % 8 in bf16), else element
//     loads;
//   * the reference's order of operations is kept where it matters for
//     parity: the cumulative product is taken one step at a time in f32,
//     k is divided by max(c, 1e-30), only the strict lower triangle of the
//     scores enters the product with v, every sum over channels or tokens
//     runs in order, and out is (intra + bonus) + inter.
//
// No tensor cores: the products are plain f32, as the plain version's.
#include <atomic>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;     // warps 0-3: out; warps 4-7: scores, S
constexpr int HALF = THREADS / 2;
constexpr int LC = 32;           // longest chunk
constexpr int DC = 64;           // largest head dimension
constexpr int RS = DC + 4;       // row stride of r_t and k_t (floats)
constexpr int PS = LC + 4;       // row stride of the scores, (s, t)
constexpr int BAR_SCORES = 1;    // named barriers (0 is __syncthreads)
constexpr int BAR_S_READ = 2;
constexpr int MIN_BLOCKS = 3;    // resident blocks an SM
static_assert(THREADS == 4 * DC && LC == 32, "phase 1 maps a thread to a "
              "channel and a quarter of the chunk");

// shared memory, in floats from the start, then the staging tiles of T
constexpr int OFF_RT = 0;                    // r_t                (LC, RS)
constexpr int OFF_KT = OFF_RT + LC * RS;     // k_t                (LC, RS)
constexpr int OFF_ST = OFF_KT + LC * RS;     // S                  (DC, DC)
constexpr int OFF_SC = OFF_ST + DC * DC;     // scores, transposed (LC, PS)
constexpr int OFF_U = OFF_SC + LC * PS;      // u                  (DC)
constexpr int OFF_CL = OFF_U + DC;           // c_L                (DC)
constexpr int OFF_BONUS = OFF_CL + DC;       // rowsum(r⊙u⊙k)      (LC)
constexpr int OFF_STAGE = OFF_BONUS + LC;    // raw r, k, v, w     (4, LC, DC)
static_assert(OFF_STAGE % 4 == 0, "the staging tiles must be 16-byte aligned");

template <typename T>
constexpr size_t smem_bytes() {
  return OFF_STAGE * sizeof(float) + 4 * LC * DC * sizeof(T);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// four consecutive values from shared memory, as f32
__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* x) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

// four consecutive values to global memory (16 bytes in f32, 8 in bf16)
__device__ __forceinline__ void store4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned*>(&a);
  raw.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(THREADS) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(THREADS) : "memory");
}

// Copy L rows of D values (row stride ts elements in global memory) into a
// (LC, DC) staging tile: 16-byte cp.async copies when vec, else element
// loads (complete when the caller's barrier passes).
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int64_t ts,
                                          int L, int D, bool vec, int tid) {
  if (vec) {
    constexpr int PER = 16 / sizeof(T);
    const int seg = D / PER;
    for (int i = tid; i < L * seg; i += THREADS) {
      const int t = i / seg, j = i - t * seg;
      cp_async16(dst + t * DC + j * PER, src + t * ts + j * PER);
    }
  } else {
    for (int i = tid; i < L * D; i += THREADS) {
      const int t = i / D, d = i - t * D;
      dst[t * DC + d] = src[t * ts + d];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const float* __restrict__ u, int64_t u_bstride,
            const float* __restrict__ state0, T* __restrict__ out,
            float* __restrict__ state, int Hn, int S, int D, int L,
            int64_t sb, int64_t ts, int64_t sh, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* rt = smem + OFF_RT;
  float* kt = smem + OFF_KT;
  float* st = smem + OFF_ST;
  float* sc = smem + OFF_SC;
  float* us = smem + OFF_U;
  float* cl = smem + OFF_CL;
  float* bonus = smem + OFF_BONUS;
  T* stage = reinterpret_cast<T*>(smem + OFF_STAGE);
  T* rs = stage;
  T* ks = stage + LC * DC;
  T* vs = stage + 2 * LC * DC;
  T* ws = stage + 3 * LC * DC;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int pair = blockIdx.x;
  const int b = pair / Hn, h = pair - b * Hn;
  const int64_t in_base = b * sb + h * sh;
  const int n_chunks = S / L;

  // padding outside the L × D tile: r, k, v zero and w one, so it adds
  // nothing and leaves c_L = c[L - 1]; the copies never overwrite it
  for (int i = tid; i < LC * DC; i += THREADS) {
    rs[i] = ks[i] = vs[i] = from_f32<T>(0.f);
    ws[i] = from_f32<T>(1.f);
  }
  for (int i = tid; i < DC; i += THREADS)
    us[i] = i < D ? u[b * u_bstride + static_cast<int64_t>(h) * D + i] : 0.f;
  for (int i = tid; i < DC * DC; i += THREADS) {
    const int d = i / DC, e = i % DC;
    st[i] = state0 && d < D && e < D
                ? state0[(static_cast<int64_t>(pair) * D + d) * D + e]
                : 0.f;
  }
  __syncthreads();
  load_rows(rs, r + in_base, ts, L, D, vec, tid);
  load_rows(ks, k + in_base, ts, L, D, vec, tid);
  load_rows(ws, w + in_base, ts, L, D, vec, tid);
  load_rows(vs, v + in_base, ts, L, D, vec, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  for (int n = 0; n < n_chunks; ++n) {
    const int c0 = n * L;
    const bool more = n + 1 < n_chunks;
    const int64_t next = in_base + static_cast<int64_t>(c0 + L) * ts;

    // 1. for channel d = tid % 64 and rows 8q..8q+7 (q = tid / 64): the
    //    cumulative decay, taken one step at a time from row 0 (rows before
    //    8q recomputed, to the same bits), r_t = r ⊙ c_prev and
    //    k_t = k / max(c, 1e-30); then the bonus of rows 4·warp..4·warp+3
    {
      const int d = tid % DC, q = tid / DC;
      float c = 1.f;
#pragma unroll 8
      for (int t = 0; t < 8 * q; ++t) c *= to_f32(ws[t * DC + d]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = 8 * q + i;
        const float c_prev = c;
        c *= to_f32(ws[t * DC + d]);
        rt[t * RS + d] = to_f32(rs[t * DC + d]) * c_prev;
        kt[t * RS + d] = to_f32(ks[t * DC + d]) / fmaxf(c, 1e-30f);
      }
      if (q == LC / 8 - 1) cl[d] = c;
#pragma unroll
      for (int t = 4 * warp; t < 4 * warp + 4; ++t) {
        float acc = 0.f;
#pragma unroll
        for (int dd = lane; dd < DC; dd += 32)
          acc += to_f32(rs[t * DC + dd]) * us[dd] * to_f32(ks[t * DC + dd]);
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (lane == 0) bonus[t] = acc;
      }
    }
    cp_async_wait_all();              // this chunk's v
    __syncthreads();
    // the raw r, k, w are free: the next chunk's copies run under the
    // products; its v rows go to L2 now and to shared memory after them
    if (more) {
      load_rows(rs, r + next, ts, L, D, vec, tid);
      load_rows(ks, k + next, ts, L, D, vec, tid);
      load_rows(ws, w + next, ts, L, D, vec, tid);
      const int row = tid / 8, sector = tid % 8;
      if (row < L && sector * 32 < D * static_cast<int>(sizeof(T)))
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
            reinterpret_cast<const char*>(v + next + row * ts) + sector * 32));
    }
    cp_async_commit();

    // 2. the products
    if (tid < HALF) {
      // out rows 4tg..4tg+3, columns 4eg..4eg+3
      const int tg = tid / 16, eg = tid % 16;
      float acc[4][4] = {};
      // r_t S: the state before this chunk
#pragma unroll 4
      for (int d = 0; d < DC; d += 4) {
        float a[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) load4(rt + (4 * tg + i) * RS + d, a[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float bv[4];
          load4(st + (d + j) * DC + 4 * eg, bv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(a[i][j], bv[e], acc[i][e]);
        }
      }
      bar_arrive(BAR_S_READ);
      bar_sync(BAR_SCORES);
      // the scores (zero on and above the diagonal) times v, up to the
      // warp's last row, and the bonus: summed apart from r_t S and added
      // to it last, as the plain version does, so the small terms are not
      // rounded at the scale of |out|
      float in[4][4] = {};
      const int s_end = 8 * warp + 8;
#pragma unroll 4
      for (int s = 0; s < s_end; ++s) {
        float p[4], bv[4];
        load4(sc + s * PS + 4 * tg, p);
        load4(vs + s * DC + 4 * eg, bv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) in[i][e] = fmaf(p[i], bv[e], in[i][e]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * tg + i;
        float bv[4];
        load4(vs + t * DC + 4 * eg, bv);
        const float bt = bonus[t];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] += fmaf(bt, bv[e], in[i][e]);
        if (t < L) {
          T* o = out + ((static_cast<int64_t>(b) * S + c0 + t) * Hn + h) * D;
          if (D % 4 == 0) {
            if (4 * eg < D) store4(o + 4 * eg, acc[i]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (4 * eg + e < D) o[4 * eg + e] = from_f32<T>(acc[i][e]);
          }
        }
      }
    } else {
      const int q = tid - HALF, qw = q / 32;
      {
        // scores of rows 4ti + 2hf + {0, 1} × columns si + 8j, each summed
        // over the channels in order
        const int hf = lane / 16, tile = qw * 16 + lane % 16;
        const int ti = tile / 8, si = tile % 8, t0 = 4 * ti + 2 * hf;
        float p[2][4] = {};
#pragma unroll 4
        for (int d = 0; d < DC; d += 4) {
          float a[2][4], bk[4][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) load4(rt + (t0 + i) * RS + d, a[i]);
#pragma unroll
          for (int j = 0; j < 4; ++j) load4(kt + (si + 8 * j) * RS + d, bk[j]);
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) p[i][j] = fmaf(a[i][x], bk[j][x], p[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t = t0 + i, s = si + 8 * j;
            sc[s * PS + t] = s < t ? p[i][j] : 0.f;
          }
      }
      bar_arrive(BAR_SCORES);
      // k_tᵀ v for S rows 4dg..4dg+3, columns 4eg..4eg+3 and 32+4eg..
      const int dg = qw * 4 + lane / 8, eg = lane % 8;
      float acc[4][8] = {};
#pragma unroll 8
      for (int s = 0; s < LC; ++s) {
        float kk[4], v0[4], v1[4];
        load4(kt + s * RS + 4 * dg, kk);
        load4(vs + s * DC + 4 * eg, v0);
        load4(vs + s * DC + 32 + 4 * eg, v1);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][e] = fmaf(kk[i], v0[e], acc[i][e]);
            acc[i][4 + e] = fmaf(kk[i], v1[e], acc[i][4 + e]);
          }
      }
      bar_sync(BAR_S_READ);           // the output warps are done with S
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = 4 * dg + i;
        const float c = cl[d];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float* row = st + d * DC + 32 * half + 4 * eg;
          float old[4];
          load4(row, old);
          float4 nw;
          nw.x = c * (old[0] + acc[i][4 * half + 0]);
          nw.y = c * (old[1] + acc[i][4 * half + 1]);
          nw.z = c * (old[2] + acc[i][4 * half + 2]);
          nw.w = c * (old[3] + acc[i][4 * half + 3]);
          *reinterpret_cast<float4*>(row) = nw;
        }
      }
    }
    cp_async_wait_all();              // the next chunk's r, k, w
    __syncthreads();
    if (more) load_rows(vs, v + next, ts, L, D, vec, tid);
    cp_async_commit();
  }

  for (int i = tid; i < D * D; i += THREADS) {
    const int d = i / D, e = i % D;
    state[static_cast<int64_t>(pair) * D * D + i] = st[d * DC + e];
  }
}

// the dynamic shared memory above 48 KB, and the largest carveout so that
// MIN_BLOCKS blocks fit: set once a card (the first 64) and dtype
template <typename T>
cudaError_t prepare() {
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (ready.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(wkv6_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes<T>()));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wkv6_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) ready.fetch_or(bit);
  return err;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const float* u, long long u_bstride, const float* state0,
                   void* out, float* state, int B, int Hn, int S, int D, int L,
                   long long sb, long long ts, long long sh, cudaStream_t st) {
  cudaError_t err = prepare<T>();
  if (err != cudaSuccess) return err;
  constexpr long long PER = 16 / sizeof(T);
  const bool vec = D % PER == 0 && sb % PER == 0 && ts % PER == 0 &&
                   sh % PER == 0 && aligned16(r) && aligned16(k) &&
                   aligned16(v) && aligned16(w);
  wkv6_kernel<T><<<B * Hn, THREADS, smem_bytes<T>(), st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, u_bstride,
      state0, static_cast<T*>(out), state, Hn, S, D, L, sb, ts, sh, vec);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w and out share it; u,
// state0 and state are float32; state0 may be null).  r, k, v, w share the
// strides sb (batch), ts (token) and sh (head), in elements, with D
// contiguous; out is a contiguous (B, S, Hn, D).  S must be a positive
// multiple of L, L ≤ 32, D ≤ 64, B·Hn < 2^31.  Returns the cudaError_t of
// the launch.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const float* u, long long u_bstride,
                           const float* state0, int dtype, void* out,
                           float* state, int B, int Hn, int S, int D, int L,
                           long long sb, long long ts, long long sh,
                           void* stream) {
  if (B < 1 || Hn < 1 || static_cast<long long>(B) * Hn > 0x7fffffffLL ||
      D < 1 || D > DC || L < 1 || L > LC || S < L || S % L)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(r, k, v, w, u, u_bstride, state0,
                                          out, state, B, Hn, S, D, L, sb, ts,
                                          sh, st));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(r, k, v, w, u, u_bstride,
                                                  state0, out, state, B, Hn, S,
                                                  D, L, sb, ts, sh, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The kernel's resources for dtype (0 f32, 1 bf16): resident blocks an SM
// (the CUDA occupancy calculator at its dynamic shared memory), registers
// a thread, and shared memory a block in bytes.
extern "C" int wkv6_occupancy(int dtype, int* blocks, int* regs, int* smem) {
  cudaError_t err;
  cudaFuncAttributes attr;
  size_t bytes;
  if (dtype == 0) {
    err = prepare<float>();
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, wkv6_kernel<float>);
    bytes = smem_bytes<float>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, wkv6_kernel<float>,
                                                          THREADS, bytes);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    err = prepare<bf>();
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, wkv6_kernel<bf>);
    bytes = smem_bytes<bf>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, wkv6_kernel<bf>,
                                                          THREADS, bytes);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *smem = static_cast<int>(bytes + attr.sharedSizeBytes);
  return 0;
}
