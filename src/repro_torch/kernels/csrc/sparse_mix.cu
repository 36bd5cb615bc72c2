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
// times; with a table larger than the 50 MB L2 most of those revisits
// come from HBM, so the kernel runs above the bytes-counted-once bound.
//
// Design: one warp per output row, lanes over the p features (p = 32
// fills the warp exactly; wider rows loop), so every slot's gather is one
// coalesced 128-byte row read.  idx and w of the row are read by all
// lanes at once (a broadcast).  The table may hold more rows than are
// mixed (N >= n); pad slots carry w = 0 and gather a real row.  The
// arithmetic uses explicitly rounded multiplies and adds (no FMA
// contraction), so the kernel reproduces the plain PyTorch slot loop
// (kernels/ref.py::sparse_gather_mix) bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;        // 8 rows per block

__global__ void __launch_bounds__(THREADS)
sparse_gather_mix_kernel(const float* __restrict__ table,
                         const int* __restrict__ idx,
                         const float* __restrict__ w,
                         const float* __restrict__ b,
                         const float* __restrict__ sol,
                         float* __restrict__ out, int n, int k, int p) {
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;
  const int* ir = idx + (size_t)row * k;
  const float* wr = w + (size_t)row * k;
  const float br = b[row];
  for (int d = lane; d < p; d += 32) {
    float acc = __fmul_rn(br, sol[(size_t)row * p + d]);
    for (int s = 0; s < k; ++s) {
      const float v = table[(size_t)ir[s] * p + d];
      acc = __fadd_rn(acc, __fmul_rn(wr[s], v));
    }
    out[(size_t)row * p + d] = acc;
  }
}

}  // namespace

// table (N, p), idx (n, k) int32, w (n, k), b (n,), sol (n, p),
// out (n, p): contiguous on the device.  Returns cudaGetLastError().
extern "C" int repro_sparse_gather_mix(const float* table, const int* idx,
                                       const float* w, const float* b,
                                       const float* sol, float* out, int n,
                                       int k, int p, cudaStream_t stream) {
  if (n > 0 && p > 0) {
    const int rows_per_block = THREADS / 32;
    const int blocks = (n + rows_per_block - 1) / rows_per_block;
    sparse_gather_mix_kernel<<<blocks, THREADS, 0, stream>>>(
        table, idx, w, b, sol, out, n, k, p);
  }
  return (int)cudaGetLastError();
}
