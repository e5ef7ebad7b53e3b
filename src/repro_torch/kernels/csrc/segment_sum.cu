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
// order, fixed by the plan: one warp a run, lane l adds the run's terms
// l, l + 32, l + 64, ... in turn (a product rounded, then an add: no
// contraction into a fused multiply-add, so the plain version in ref.py
// gets the same bits), then the lanes combine in a fixed butterfly
// (offsets 16, 8, 4, 2, 1).  The warp of run r also zeroes the slots
// between its slot and the next run's (warp 0 those before the first run),
// so every slot of out is written once and out needs no memset.
//
// Bound: bytes — each term's index and its two factors read once, the run
// arrays, and out written once.  The terms of a run lie scattered in the
// inputs (sorted by slot, not by position), so the factor loads are
// gathers; most runs are short (a client's feature in one or two rows), so
// most lanes of a warp idle on them, while the bias feature's run is as long
// as its client's rows.  A warp a run keeps the order simple
// and fixed; packing short runs is later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
segment_sum_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   int group, const int* __restrict__ order,
                   const int* __restrict__ run_start,
                   const int* __restrict__ run_slot, long long n_runs,
                   float* __restrict__ out, long long n_slots) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (n_runs == 0) {                      // no terms: every slot is zero
    if (warp == 0) {
      for (long long s = lane; s < n_slots; s += 32) out[s] = 0.0f;
    }
    return;
  }
  if (warp >= n_runs) return;
  const int j0 = run_start[warp], j1 = run_start[warp + 1];
  float acc = 0.0f;
  for (int j = j0 + lane; j < j1; j += 32) {
    const int t = order[j];
    acc = __fadd_rn(acc, __fmul_rn(a[t / group], b[t]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_xor_sync(FULL, acc, off));
  }
  const long long slot = run_slot[warp];
  if (lane == 0) out[slot] = acc;
  const long long next = warp + 1 < n_runs ? run_slot[warp + 1] : n_slots;
  for (long long s = slot + 1 + lane; s < next; s += 32) out[s] = 0.0f;
  if (warp == 0) {
    for (long long s = lane; s < slot; s += 32) out[s] = 0.0f;
  }
}

}  // namespace

// a: the per-group factor (n_terms / group values), b: the per-term factor
// (n_terms values), both float32; order (the summed terms), run_start
// (n_runs + 1) and run_slot (n_runs) int32 from the plan; out: n_slots
// float32.
// Returns the cudaError_t of the launch.
extern "C" int segment_sum_launch(const void* a, const void* b, int group,
                                  const void* order, const void* run_start,
                                  const void* run_slot, long long n_runs,
                                  void* out, long long n_slots,
                                  void* stream) {
  if (group < 1 || n_runs < 0 || n_slots < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long warps = n_runs > 0 ? n_runs : 1;
  const unsigned blocks = static_cast<unsigned>((warps + WARPS - 1) / WARPS);
  segment_sum_kernel<<<blocks, THREADS, 0, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), group,
      static_cast<const int*>(order), static_cast<const int*>(run_start),
      static_cast<const int*>(run_slot), n_runs, static_cast<float*>(out),
      n_slots);
  return static_cast<int>(cudaGetLastError());
}
