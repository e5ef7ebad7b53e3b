// Fixed-order segment sum for Hopper (sm_90a):
//
//     out[slot_r] = Σ_{j in run r} a[t_j / group] · b[t_j],   t_j = order[j]
//
// and out[s] = 0 for every slot s that no run names.  The runs come from a
// plan built once per input layout (kernels/segment_sum.py: the terms'
// slots sorted stably, run r = order[run_start[r] .. run_start[r+1]), all
// of slot run_slot[r], the runs in ascending slot order; terms known to be
// zero may be left out of every run).
//
// It replaces no TPU kernel.  DANE's local gradient (core/dane.py
// data_grad: X_kᵀ s for every client of a bucket, 26 calls a bucket and
// round) summed its terms into (client, feature) slots with CUDA's atomic
// scatter_add_, whose order changes from run to run, so two runs of one DANE
// round differed in the last bits (ROADMAP C6).  Here each sum has one
// order, fixed by the plan and the same whoever computes it: lane l of 32
// adds the run's terms l, l + 32, l + 64, ... in turn from +0 (a product
// rounded, then an add: no contraction into a fused multiply-add, so the
// plain version in ref.py gets the same bits), then the lanes combine in a
// fixed butterfly (offsets 16, 8, 4, 2, 1).
//
// Bound: bytes — each kept term's slot index and its factor b read once,
// a read once and out written once.  Out is most of them: in DANE's
// buckets 96 % of the (client, feature) slots hold no run, and two runs in
// three have one term, while a client's common features make runs of
// thousands of terms next to each other.  The design (one launch):
//
//   - The plan cuts the runs into units, a block each: a unit spans at
//     most TILE contiguous slots, and its runs start within CAP terms of
//     its first (or it is one run of more).  Its terms are contiguous in
//     order, so the block gathers them with every thread busy: each index
//     load, then each factor load, goes out at once, and each product,
//     rounded and added to +0 (a lane's first partial), lands in shared
//     memory.  A long run is not left to one warp's chain of loads, and a
//     client's cluster of long runs is spread over many units.
//   - The block zeroes its slots in shared memory and places each run's
//     sum there: a thread sums a run of at most 32 terms (its lanes'
//     products are lanes 0..n-1 of the butterfly, +0 the rest, the tree in
//     registers), a warp each longer run (lane l adds products l, l + 32,
//     ... in turn from shared memory, then the butterfly in shuffles).  A
//     run of more than BUF terms takes several windows, warp 0 carrying
//     its lanes' partials from one to the next.
//   - Then it writes its slots to out once, in 16-byte stores (single
//     slots at the unit's ends where out + slot is not 16-byte aligned).
//   - t / group is a multiply-high and a shift with the wrapper's constants
//     (exact for t < 2^31): no integer division a term.
//
// No atomics: each slot of out is written by exactly one block, once.
// What holds it back on the H100 (PERF.md): the gathers of b, one 32-byte
// sector a 4-byte term, and a unit's three waits on memory (its bounds,
// the indices, the factors).  Shared memory stays at 24.6 KB a block
// (TILE = 4,096 slots): larger units left less of the SM to L1 and were
// slower.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SHORT = 32;        // the most terms a thread sums alone
constexpr int CAP = 1024;        // a unit's runs start within CAP terms
constexpr int BUF = 2 * CAP;     // products a window holds
constexpr int TILE = 4096;       // the most slots a unit spans
constexpr int THREADS = 256;
constexpr int PER_THREAD = BUF / THREADS;
constexpr unsigned FULL = 0xffffffffu;

// t / group for 0 <= t < 2^31, with magic = floor(2^32 (2^shift - group) /
// group) + 1 and shift = ceil(log2 group) (kernels/segment_sum.py
// divisor).
__device__ __forceinline__ int group_of(int t, unsigned magic, int shift) {
  const unsigned u = static_cast<unsigned>(t);
  return static_cast<int>((__umulhi(u, magic) + u) >> shift);
}

__device__ __forceinline__ float butterfly(float acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_xor_sync(FULL, acc, off));
  }
  return acc;
}

// p[l] = p[l] + p[l + OFF] for l < OFF, then OFF / 2, ... 1: the
// butterfly's levels, lane 0's sums.
template <int OFF>
__device__ __forceinline__ void fold(float* p) {
#pragma unroll
  for (int l = 0; l < OFF; ++l) p[l] = __fadd_rn(p[l], p[l + OFF]);
  if constexpr (OFF > 1) fold<OFF / 2>(p);
}

// The sum of a run of 1..SHORT terms whose lane sums (+0 + product) are
// p[0..n): lanes n..31 hold +0, and the first level folds lane l + 16 into
// lane l only where it holds a term (x + +0 == x for a sum that is never
// −0).
__device__ __forceinline__ float short_sum(const float* p, int n) {
  float q[16];
#pragma unroll
  for (int l = 0; l < 16; ++l) q[l] = l < n ? p[l] : 0.0f;
#pragma unroll
  for (int l = 0; l < 16; ++l) {
    if (l + 16 < n) q[l] = __fadd_rn(q[l], p[l + 16]);
  }
  fold<8>(q);
  return q[0];
}

// Gather window [w0, w0 + wn) of a unit's terms (order[j0 + w0 ..]) as
// far as the index loads: thread k's slots k, k + THREADS, ... (-1 past
// the window).
__device__ __forceinline__ void load_terms(int* t, const int* __restrict__ order,
                                           int j, int wn) {
#pragma unroll
  for (int v = 0; v < PER_THREAD; ++v) {
    const int k = threadIdx.x + THREADS * v;
    t[v] = k < wn ? __ldg(order + j + k) : -1;
  }
}

// The factors of the terms load_terms named.
__device__ __forceinline__ void load_factors(float* x, float* y, const int* t,
                                             const float* __restrict__ a,
                                             const float* __restrict__ b,
                                             unsigned magic, int shift) {
#pragma unroll
  for (int v = 0; v < PER_THREAD; ++v) {
    x[v] = 0.0f;
    y[v] = 0.0f;
    if (t[v] >= 0) {
      x[v] = __ldg(a + group_of(t[v], magic, shift));
      y[v] = __ldg(b + t[v]);
    }
  }
}

// Each product rounded, then added to +0 (a lane's first partial), into
// prod[0 .. wn).
__device__ __forceinline__ void store_products(float* prod, const float* x,
                                               const float* y, int wn) {
#pragma unroll
  for (int v = 0; v < PER_THREAD; ++v) {
    const int k = threadIdx.x + THREADS * v;
    if (k < wn) prod[k] = __fadd_rn(0.0f, __fmul_rn(x[v], y[v]));
  }
}

// A block a unit of the plan (see the top of the file): the slots lo ..
// hi, the runs rb .. re that lie there and their terms j0 .. j0 + K.  The
// runs' bounds and slots load with the terms' indices, so a unit waits on
// memory three times: its bounds, the indices, the factors.
__global__ void __launch_bounds__(THREADS)
segment_sum_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   unsigned magic, int shift, const int* __restrict__ order,
                   const int* __restrict__ run_start,
                   const int* __restrict__ run_slot,
                   const int* __restrict__ units, int n_units,
                   float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* prod = reinterpret_cast<float*>(smem4);
  float4* staged4 = smem4 + BUF / 4;
  float* staged = prod + BUF;
  const int u = blockIdx.x;
  const int lo = units[u], hi = units[u + 1];
  const int rb = units[n_units + 1 + u], re = units[n_units + 2 + u];
  const int j0 = units[2 * (n_units + 1) + u];
  const int K = units[2 * (n_units + 1) + u + 1] - j0;
  const int lane = threadIdx.x & 31;
  int t[PER_THREAD];
  load_terms(t, order, j0, min(BUF, K));
  // the bounds and slot of run rb + threadIdx.x, the thread's first
  int r_start = 0, r_end = 0, r_slot = 0;
  if (rb + static_cast<int>(threadIdx.x) < re) {
    r_start = __ldg(run_start + rb + threadIdx.x);
    r_end = __ldg(run_start + rb + threadIdx.x + 1);
    r_slot = __ldg(run_slot + rb + threadIdx.x);
  }
  // slot lo + i is staged at mis + i, so that staged4[q] lands on out's
  // 16-byte word q of the unit
  const int mis = static_cast<int>(
      ((reinterpret_cast<uintptr_t>(out) >> 2) + static_cast<unsigned>(lo)) &
      3);
  const int end = mis + hi - lo;
  const int words = (end + 3) >> 2;
  for (int q = threadIdx.x; q < words; q += THREADS) {
    staged4[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float x[PER_THREAD], y[PER_THREAD];
  load_factors(x, y, t, a, b, magic, shift);
  if (K > BUF) {
    float carried = 0.0f;          // warp 0's lane partials of the run
    for (int w0 = 0; w0 < K; w0 += BUF) {
      const int wn = min(BUF, K - w0);
      if (w0 > 0) {
        load_terms(t, order, j0 + w0, wn);
        load_factors(x, y, t, a, b, magic, shift);
        __syncthreads();           // warp 0 is done with the last window
      }
      store_products(prod, x, y, wn);
      __syncthreads();
      if (threadIdx.x < 32) {
        for (int i = lane; i < wn; i += 32) carried = __fadd_rn(carried, prod[i]);
      }
    }
    if (threadIdx.x < 32) {
      carried = butterfly(carried);
      if (lane == 0) staged[mis + r_slot - lo] = carried;
    }
  } else {
    store_products(prod, x, y, K);
    __syncthreads();
    // a warp takes 32 runs at a time: a lane each short one, the whole
    // warp each long one
    for (int r = rb + static_cast<int>(threadIdx.x); r - lane < re;
         r += THREADS) {
      int e = 0, n = 0, at = 0;
      if (r < re) {
        if (r >= rb + THREADS) {
          r_start = __ldg(run_start + r);
          r_end = __ldg(run_start + r + 1);
          r_slot = __ldg(run_slot + r);
        }
        e = r_start - j0;
        n = r_end - r_start;
        at = mis + r_slot - lo;
      }
      if (n > 0 && n <= SHORT) staged[at] = short_sum(prod + e, n);
      for (unsigned longs = __ballot_sync(FULL, n > SHORT); longs;
           longs &= longs - 1) {
        const int src = __ffs(longs) - 1;
        const int le = __shfl_sync(FULL, e, src);
        const int ln = __shfl_sync(FULL, n, src);
        float acc = 0.0f;
        for (int i = lane; i < ln; i += 32) acc = __fadd_rn(acc, prod[le + i]);
        acc = butterfly(acc);
        if (lane == src) staged[at] = acc;
      }
    }
  }
  __syncthreads();
  float* line = out + (static_cast<long long>(lo) - mis);
  for (int q = threadIdx.x; q < words; q += THREADS) {
    const int i = 4 * q;
    if (i >= mis && i + 4 <= end) {
      reinterpret_cast<float4*>(line)[q] = staged4[q];
    } else {
      for (int e = max(i, mis); e < min(i + 4, end); ++e) line[e] = staged[e];
    }
  }
}

// the products and the staged slots (4 more: the first word's head)
constexpr size_t SMEM_BYTES = (BUF + TILE + 4) * sizeof(float);

}  // namespace

// a: the per-group factor (n_terms / group values), b: the per-term factor
// (n_terms values), both float32; magic and shift: t / group as group_of
// computes it; order (the summed terms), run_start (n_runs + 1), run_slot
// (n_runs) and units (3 × (n_units + 1): each unit's first slot, first
// run and first term, then n_slots, n_runs and the kept terms) int32 from
// a plan built for cap and tile (CAP and TILE here); out: n_slots
// float32.  Returns the cudaError_t of the launch.
extern "C" int segment_sum_launch(const void* a, const void* b,
                                  unsigned magic, int shift,
                                  const void* order, const void* run_start,
                                  const void* run_slot, const void* units,
                                  int n_units, int cap, int tile, void* out,
                                  void* stream) {
  if (shift < 0 || shift > 31 || cap != CAP || tile != TILE || n_units < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  segment_sum_kernel<<<n_units, THREADS, SMEM_BYTES,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), magic,
      shift, static_cast<const int*>(order),
      static_cast<const int*>(run_start), static_cast<const int*>(run_slot),
      static_cast<const int*>(units), n_units, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The kernel's resources: resident blocks an SM (the CUDA occupancy
// calculator), threads a block, registers a thread, shared memory a block
// and local memory a thread (spills), in bytes.
extern "C" int segment_sum_occupancy(int* blocks, int* threads, int* regs,
                                     int* smem, int* local) {
  const void* fn = reinterpret_cast<const void*>(segment_sum_kernel);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, THREADS,
                                                        SMEM_BYTES);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *threads = THREADS;
  *regs = attr.numRegs;
  *smem = static_cast<int>(attr.sharedSizeBytes + SMEM_BYTES);
  *local = static_cast<int>(attr.localSizeBytes);
  return 0;
}
