// graph_mix: the dense model-propagation step (paper Eq. 5),
//
//     out = A @ theta + b[:, None] * theta_sol        (all float32)
//
// Replaces the Pallas TPU kernel repro/kernels/graph_mix.py::graph_mix
// (_kernel), which keeps A resident in VMEM and feeds (n x n) @ (n x 512)
// tiles to the MXU.
//
// Bound on an H100: 2 n^2 D floating-point operations on (2 n D + n^2 + n)
// floats moved.  At the main path's n = 2048, D = 4096 that is 34.4 GFLOP
// on 84 MB — compute bound, against the 67 TFLOP/s float32 rate outside
// the tensor cores (no TF32: the port's parity bar is 1e-5, which TF32's
// 10-bit mantissa cannot meet).
//
// Design: a classic shared-memory SGEMM.  Each block computes a 128 x 128
// output tile with 256 threads, 8 x 8 outputs per thread held in
// registers; A and theta are staged through shared memory 8 columns of
// the reduction at a time.  A thread's outputs are strided by 16 rows and
// 16 columns, so a warp's shared-memory reads hit distinct banks (or
// broadcast).  Ragged n and D are masked on load (zero fill) and on store:
// nothing is padded.  The anchor term b[i] * sol[i, d] is fused into the
// epilogue, so theta_sol is read once and out written once.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;             // output rows per block
constexpr int BN = 128;             // output columns per block
constexpr int BK = 8;               // reduction depth per shared tile
constexpr int TM = 8;               // rows per thread
constexpr int TN = 8;               // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256

__global__ void __launch_bounds__(THREADS)
graph_mix_kernel(const float* __restrict__ A, const float* __restrict__ X,
                 const float* __restrict__ S, const float* __restrict__ b,
                 float* __restrict__ out, int n, int D) {
  __shared__ float As[BK][BM];      // A tile, reduction-major
  __shared__ float Xs[BK][BN];      // theta tile

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tr = tid / (BN / TN);   // 0..15: rows tr, tr + 16, ...
  const int tc = tid % (BN / TN);   // 0..15: cols tc, tc + 16, ...

  // load assignment: A tile (BM x BK) 4 consecutive k per thread,
  // theta tile (BK x BN) 4 consecutive columns per thread
  const int a_r = tid / 2;
  const int a_c = (tid % 2) * 4;
  const int x_r = tid / 32;
  const int x_c = (tid % 32) * 4;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < n; k0 += BK) {
    const int ar = row0 + a_r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ak = k0 + a_c + q;
      As[a_c + q][a_r] =
          (ar < n && ak < n) ? A[(size_t)ar * n + ak] : 0.0f;
    }
    const int xk = k0 + x_r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int xc = col0 + x_c + q;
      Xs[x_r][x_c + q] =
          (xk < n && xc < D) ? X[(size_t)xk * D + xc] : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float af[TM], xf[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) af[i] = As[kk][tr + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) xf[j] = Xs[kk][tc + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(af[i], xf[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + tr + 16 * i;
    if (r >= n) continue;
    const float br = b[r];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tc + 16 * j;
      if (c < D) {
        const size_t o = (size_t)r * D + c;
        out[o] = acc[i][j] + br * S[o];
      }
    }
  }
}

}  // namespace

// A (n, n), theta (n, D), sol (n, D), b (n,), out (n, D): contiguous f32
// on the device.  Returns cudaGetLastError() after the launch.
extern "C" int repro_graph_mix(const float* A, const float* theta,
                               const float* sol, const float* b, float* out,
                               int n, int D, cudaStream_t stream) {
  if (n > 0 && D > 0) {
    dim3 grid((D + BN - 1) / BN, (n + BM - 1) / BM);
    graph_mix_kernel<<<grid, THREADS, 0, stream>>>(A, theta, sol, b, out,
                                                   n, D);
  }
  return (int)cudaGetLastError();
}
