// sparse_gather_mix: one synchronous Eq. 5 sweep over padded-neighbor
// tables (the CSR counterpart of graph_mix),
//
//     out[i, :] = b[i] * sol[i, :] + sum_s w[i, s] * table[idx[i, s], :]
//
// with the k slots summed in slot order in a float32 accumulator.
// Replaces the Pallas TPU kernel repro/kernels/sparse_mix.py::
// sparse_gather_mix (_kernel), which keeps the whole table resident in
// VMEM and gathers rows with dynamic slices.
//
// Bound on an H100: memory.  2 k p operations per row against one read
// of table, sol, idx, w and b and one write of out — at the main path's
// n = 1M agents, p = 32 about 0.1 operation per byte, far below the
// card's balance point.  The gathers revisit each table row about k
// times.  The table (128 MB at n = 1M) does not fit the 50 MB L2, so in
// the order the rows are numbered — which for a random geometric graph
// carries no locality — most revisits come from HBM.
//
// Design: one warp per output row, lanes over the p features (p = 32
// fills the warp exactly; wider rows loop), so every slot's gather is one
// coalesced 128-byte row read.
//   - Row order: warp w computes row order[w] when the caller passes a
//     permutation (sparse_sync_mp passes the topology's reverse Cuthill-
//     McKee order), else row w.  In that order the rows in flight at once
//     have their neighbors within a few thousand positions, so the rows
//     they gather stay in L2 between their k visits.  It is a schedule,
//     not a relabelling: each row's sum is the same.
//   - Memory-level parallelism: lane s loads slot s's idx and w (one
//     coalesced load of the row's k slots, in chunks of 32), passes them
//     by shuffle, and all of a chunk's row gathers are issued before any
//     is summed.
//   - Few instructions a row: k <= 32 is a template argument (one kernel
//     for each k, chosen at launch), so the slot loop unrolls without
//     predicates and a lane needs k + a few registers.  With k known only
//     at run time the kernel was bound by instruction issue, not memory,
//     and ran as slowly in RCM order as in identity order (PERF.md).
//     What the RCM schedule leaves on the table is the scattered per-row
//     reads of idx, w, b and sol and writes of out.
// The sum then runs in slot order with explicitly rounded multiplies and
// adds (no FMA contraction), so the kernel reproduces the plain PyTorch
// slot loop (kernels/ref.py::sparse_gather_mix) bit for bit in any row
// order.  The table may hold more rows than are mixed (N >= n); pad slots
// carry w = 0 and gather a real row.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;        // 8 rows per block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int row_of(const int* __restrict__ order,
                                      int wid) {
  return order ? order[wid] : wid;
}

// k == K <= 32 slots, known when compiled: no slot predicates, K gathers
// in flight per lane, few registers.  PW == 32 fixes p = 32 as well (one
// feature a lane, no column loop); PW == 0 loops over p.  Offsets are
// 32-bit: the launcher takes this kernel only when N p and n k fit.  (The
// main path's k = 18, p = 32 then takes 32 registers, so an SM holds its
// full 64 warps.)
template <int K, int PW>
__global__ void __launch_bounds__(THREADS)
gather_mix_fixed_k(const float* __restrict__ table,
                   const int* __restrict__ idx, const float* __restrict__ w,
                   const float* __restrict__ b, const float* __restrict__ sol,
                   const int* __restrict__ order, float* __restrict__ out,
                   int n, int p_run) {
  const int p = PW ? PW : p_run;
  const int wid = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (wid >= n) return;             // warp-uniform
  const int row = row_of(order, wid);
  int my_i = 0;
  float my_w = 0.f;
  if (lane < K) {                   // one coalesced load of the row's slots
    my_i = idx[row * K + lane];
    my_w = w[row * K + lane];
  }
  for (int d0 = 0; d0 < p; d0 += 32) {
    const int d = d0 + lane;
    const bool on = PW == 32 || d < p;
    float v[K];
#pragma unroll
    for (int t = 0; t < K; ++t) {     // every gather issued before any sum
      const int src = __shfl_sync(FULL, my_i, t);
      v[t] = on ? table[src * p + d] : 0.f;
    }
    float acc = on ? __fmul_rn(b[row], sol[row * p + d]) : 0.f;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      acc = __fadd_rn(acc, __fmul_rn(__shfl_sync(FULL, my_w, t), v[t]));
    }
    if (on) out[row * p + d] = acc;
  }
}

// any k (k > 32, or sizes past 32-bit offsets): 64-bit offsets, the
// slots in chunks of 32.
__global__ void __launch_bounds__(THREADS)
gather_mix_any_k(const float* __restrict__ table, const int* __restrict__ idx,
                 const float* __restrict__ w, const float* __restrict__ b,
                 const float* __restrict__ sol,
                 const int* __restrict__ order, float* __restrict__ out,
                 int n, int k, int p) {
  const int wid = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (wid >= n) return;
  const size_t row = row_of(order, wid);
  const int* ir = idx + row * k;
  const float* wr = w + row * k;
  const float br = b[row];
  for (int d0 = 0; d0 < p; d0 += 32) {
    const int d = d0 + lane;
    const bool on = d < p;
    float acc = on ? __fmul_rn(br, sol[row * p + d]) : 0.f;
    for (int s0 = 0; s0 < k; s0 += 32) {
      int my_i = 0;
      float my_w = 0.f;
      if (s0 + lane < k) {
        my_i = ir[s0 + lane];
        my_w = wr[s0 + lane];
      }
      float v[32];
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const int src = __shfl_sync(FULL, my_i, t);
        v[t] = (on && s0 + t < k) ? table[(size_t)src * p + d] : 0.f;
      }
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const float wt = __shfl_sync(FULL, my_w, t);
        if (s0 + t < k) acc = __fadd_rn(acc, __fmul_rn(wt, v[t]));
      }
    }
    if (on) out[row * p + d] = acc;
  }
}

}  // namespace

// table (N, p), idx (n, k) int32, w (n, k), b (n,), sol (n, p),
// order (n,) int32 permutation of the rows or NULL, out (n, p):
// contiguous on the device.  Returns cudaGetLastError().
extern "C" int repro_sparse_gather_mix(const float* table, const int* idx,
                                       const float* w, const float* b,
                                       const float* sol, const int* order,
                                       float* out, int N, int n, int k,
                                       int p, cudaStream_t stream) {
  if (n > 0 && p > 0) {
    const int blocks = (n + THREADS / 32 - 1) / (THREADS / 32);
    const long long lim = 0x7fffffffLL;
    const bool narrow = k >= 1 && k <= 32 && (long long)N * p <= lim &&
                        (long long)n * p <= lim && (long long)n * k <= lim;
    if (!narrow) {
      gather_mix_any_k<<<blocks, THREADS, 0, stream>>>(
          table, idx, w, b, sol, order, out, n, k, p);
      return (int)cudaGetLastError();
    }
#define REPRO_FIXED_K(K)                                                   \
  case K:                                                                  \
    if (p == 32)                                                           \
      gather_mix_fixed_k<K, 32><<<blocks, THREADS, 0, stream>>>(           \
          table, idx, w, b, sol, order, out, n, p);                        \
    else                                                                   \
      gather_mix_fixed_k<K, 0><<<blocks, THREADS, 0, stream>>>(            \
          table, idx, w, b, sol, order, out, n, p);                        \
    break;
    switch (k) {
      REPRO_FIXED_K(1) REPRO_FIXED_K(2) REPRO_FIXED_K(3) REPRO_FIXED_K(4)
      REPRO_FIXED_K(5) REPRO_FIXED_K(6) REPRO_FIXED_K(7) REPRO_FIXED_K(8)
      REPRO_FIXED_K(9) REPRO_FIXED_K(10) REPRO_FIXED_K(11) REPRO_FIXED_K(12)
      REPRO_FIXED_K(13) REPRO_FIXED_K(14) REPRO_FIXED_K(15) REPRO_FIXED_K(16)
      REPRO_FIXED_K(17) REPRO_FIXED_K(18) REPRO_FIXED_K(19) REPRO_FIXED_K(20)
      REPRO_FIXED_K(21) REPRO_FIXED_K(22) REPRO_FIXED_K(23) REPRO_FIXED_K(24)
      REPRO_FIXED_K(25) REPRO_FIXED_K(26) REPRO_FIXED_K(27) REPRO_FIXED_K(28)
      REPRO_FIXED_K(29) REPRO_FIXED_K(30) REPRO_FIXED_K(31) REPRO_FIXED_K(32)
    }
#undef REPRO_FIXED_K
  }
  return (int)cudaGetLastError();
}
