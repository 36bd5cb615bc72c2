// graph_mix: the dense model-propagation step (paper Eq. 5),
//
//     out = A @ theta + b[:, None] * theta_sol        (all float32)
//
// for T independent trials (T = 1 for one problem): A (T, n, n), theta and
// theta_sol (T, n, D), b (T, n).
//
// Replaces the Pallas TPU kernel repro/kernels/graph_mix.py::graph_mix
// (_kernel), which keeps A resident in VMEM and feeds (n x n) @ (n x 512)
// tiles to the MXU; under the sweeps' vmap it gains a batch grid
// dimension, as this kernel does (blockIdx.z is the trial).
//
// Bound on an H100: 2 n^2 D floating-point operations on (2 n D + n^2 + n)
// floats moved: compute bound.  At the main path's n = 2048, D = 4096 that
// is 34.4 GFLOP on 84 MB (0.033 ms of bytes at 3.35 TB/s).  The port's bar
// is 1e-5 against float32, which one TF32 pass (10-bit mantissa) misses by
// far; three TF32 passes meet it (3xTF32: x = hi + lo with hi = tf32(x),
// lo = x - hi read as TF32, and a . b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi;
// the dropped a_lo b_lo is below 2^-22 |a b|).  So the least time at that bar is
// three TF32 passes at 495 TFLOP/s, 3 * 2 n^2 D / 495e12 = 0.208 ms; the
// float32 FFMA floor (67 TFLOP/s) is 0.513 ms.
//
// Design: 3xTF32 on the tensor cores with mma.sync.m16n8k8 (not wgmma:
// TF32 wgmma reads shared-memory operands only K-major, and theta's tile,
// (k, D) with the reduction on its rows, is MN-major; mma.sync fragments
// are loaded by the threads in any layout, and the split happens on that
// load).
//   - Each block computes a 128 x 128 output tile with 256 threads, 8 warps
//     as 2 x 4, each warp 64 x 32 (4 x 4 mma tiles, 64 accumulators a
//     thread), over k-steps of 32; two blocks share an SM (at most 128
//     registers a thread), so four warps of each scheduler hide latency.
//   - A 3-stage cp.async pipeline brings A (128 x 32) and theta (32 x 128)
//     tiles into shared memory, padded (rows of 36 and 136 floats) so that
//     the fragment loads of a warp hit 32 distinct banks.  Rows whose
//     global address is 16-byte aligned (n, D % 4 == 0) take 16-byte
//     copies, others 4-byte ones; ragged edges are zero-filled by the
//     copies (source size 0), so nothing is padded in device memory.
//   - Each fragment element is split into TF32 hi and lo in registers as it
//     is read from shared memory (A's by ldmatrix), hi rounded to nearest
//     by two integer instructions and lo = x - hi (hopper::split_tf32).
//   - The tensor core adds into its float32 accumulator with truncation,
//     not IEEE rounding, so a sum it carries across the whole row has an
//     error with a sign; ``synchronous`` feeds each output back in, and near
//     its fixed point such a bias adds up about 1 / (1 - alpha) times.  So
//     each 8-deep step of each 16 x 8 tile starts from zero: a_hi b_hi
//     into one fragment, a_lo b_hi + a_hi b_lo into another, and the two
//     reach the float32 accumulator by IEEE adds (hh + sm, then acc +=).
//     A step's a_hi b_hi products are exact (11-bit by 11-bit), so for a
//     sparse row (a step with one or two products) nothing is truncated
//     that matters; the small terms are 2^-11 of it.  Summing all three
//     products in one zeroed fragment leaves the small terms' low bits to
//     the truncation, a smaller bias that still adds up.  The two adds
//     per accumulator and step cost about a quarter of the kernel's time.
//   - The anchor b[i] * sol[i, d] is added in the epilogue, so theta_sol is
//     read once and out written once.
//   - No atomics: a replay is bit-identical.
//   - Trials: blockIdx.z picks the trial, whose A, theta, theta_sol, b and
//     out start n*n, n*D, n*D, n and n*D floats after the previous one's.
//     A trial's blocks compute exactly what the same problem alone does.
//   - mma.sync issues TF32 well below wgmma's rate on Hopper, and the split
//     sits on each fragment's path from shared memory to the tensor core,
//     so the kernel is bound by mma.sync latency and issue, not by the
//     495 TFLOP/s above.  Next steps: wgmma with theta's tile transposed
//     to K-major (and split) in shared memory, or more independent work per
//     warp to hide the split's latency.
//
// Narrow models (D <= SMALL_D, the sweeps' scalar models at D = 1) take a
// second kernel, graph_mix_rows_kernel, in FFMA with IEEE adds: at D = 1 a
// 128-column tile would be 127 columns of zero fill.  Its work is A's T n^2
// floats read once (108 MB at the sweeps' T = 300, n = 300, more than the
// 50 MB L2), so it is bound by bytes, and the design keeps enough of A in
// flight to stream at the HBM rate:
//   - 16 lanes a row (two rows a warp), 16 rows a block; a block's rows
//     belong to one trial (grid.x row blocks, grid.y = the trial).
//   - A row is cut in 4-float chunks, chunk c to lane c % 16; each lane
//     issues CHUNKS = 5 loads of its chunks (16 bytes each when every row
//     starts 16-byte aligned, else four 4-byte loads) before any of their
//     FMAs, so a row of up to 320 floats is one round of loads, 80 bytes
//     a lane in flight; longer rows loop over rounds.  The chunk loads are
//     streaming (__ldcs): A is read once.
//   - theta[z] (n D floats) is staged once a block in shared memory, as
//     chunks of 4 D floats read by 16-byte loads, while the first round of
//     A is in flight; past 48 KB it is read through __ldg instead.
//   - A lane adds its products in chunk and element order, then the row's
//     16 lanes meet in a butterfly (xor 8, 4, 2, 1).  The order depends
//     only on n and D: not on T, the block, the load width or the staging,
//     so a trial's result equals its own launch bit for bit.
//   - D is a template parameter (1 .. 8): the FMAs of a chunk are D wide.
//
// Few agents, wide models (n <= 32, D > 8: the LM coupling's shape, one
// launch a parameter leaf, n the agent count and D the leaf's size per
// agent, up to 525,336,576 at Llama-3-8B's embedding) take a third kernel,
// graph_mix_agents_kernel, the shape the Pallas kernel was written for (A
// resident, D streamed).  The tile kernel would zero-fill all but n of its
// 128 rows and 32 - n of each 32-deep step there.  The work is 2 n^2 D
// FMA operations on (3 n D) elements moved, n / 6 operations a byte in
// float32: bound by bytes at every n <= 32 (at n = 32, 18 TFLOP/s of FFMA
// at the HBM rate, a quarter of the card's 67).  So the design streams:
//   - A (converted to float32, transposed: row j holds column j of A,
//     zero past n) and b sit in shared memory, read as broadcasts.
//   - Each thread owns COLS adjacent columns (a 16-byte load of theta's
//     dtype, or 8 bytes where 16 would need more than 128 accumulators)
//     and computes all n output rows of them: for j ascending it loads
//     theta[j, cols] once and adds A[i, j] * theta[j, col] into acc[i][col]
//     with fmaf for every i; then out = fmaf(b[i], sol[i, col], acc).  So
//     each element is read once and written once, and an output's sum
//     order depends only on n: a replay, any D tiling and a slice of D
//     give the same bits.
//   - Blocks walk D's column groups on grid.x with a grid stride (indices
//     in size_t); grid.y is the trial.
//   - float32 or bf16 theta, sol, A and out (the coupling's mix_dtype), b
//     float32, float32 accumulation, the result rounded to the element
//     type once.  NMAX (4, 8, 16, 32) is n rounded up: the unrolled
//     accumulators of rows past n are never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;             // output rows per block
constexpr int BN = 128;             // output columns per block
constexpr int BK = 32;              // reduction depth per stage
constexpr int STAGES = 3;
constexpr int THREADS = 256;        // 8 warps: 2 (rows) x 4 (columns)
constexpr int WM = 64, WN = 32;     // warp tile
constexpr int MT = WM / 16, NT = WN / 8;   // mma tiles per warp tile
constexpr int A_LD = BK + 4;        // padded row of the A tile (floats)
constexpr int X_LD = BN + 8;        // padded row of the theta tile
constexpr int A_STAGE = BM * A_LD, X_STAGE = BK * X_LD;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + X_STAGE) * 4;

// A[row0.., k0..] and theta[k0.., col0..] into stage buffers; zero fill
// outside (n, n) and (n, D)
__device__ __forceinline__ void load_stage(float* As, float* Xs,
                                           const float* __restrict__ A,
                                           const float* __restrict__ X,
                                           int n, int D, int row0, int col0,
                                           int k0, bool a_vec, bool x_vec) {
  const int tid = threadIdx.x;
  if (a_vec) {
#pragma unroll
    for (int i = 0; i < BM * BK / 4 / THREADS; ++i) {
      const int c = tid + i * THREADS, r = c / (BK / 4), kc = (c % (BK / 4)) * 4;
      const bool ok = row0 + r < n && k0 + kc < n;
      hopper::cp_async16(As + r * A_LD + kc,
                         ok ? A + (size_t)(row0 + r) * n + k0 + kc : A,
                         ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < BM * BK / THREADS; ++i) {
      const int e = tid + i * THREADS, r = e / BK, kc = e % BK;
      const bool ok = row0 + r < n && k0 + kc < n;
      hopper::cp_async4(As + r * A_LD + kc,
                        ok ? A + (size_t)(row0 + r) * n + k0 + kc : A,
                        ok ? 4 : 0);
    }
  }
  if (x_vec) {
#pragma unroll
    for (int i = 0; i < BK * BN / 4 / THREADS; ++i) {
      const int c = tid + i * THREADS, r = c / (BN / 4), dc = (c % (BN / 4)) * 4;
      const bool ok = k0 + r < n && col0 + dc < D;
      hopper::cp_async16(Xs + r * X_LD + dc,
                         ok ? X + (size_t)(k0 + r) * D + col0 + dc : X,
                         ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < BK * BN / THREADS; ++i) {
      const int e = tid + i * THREADS, r = e / BN, dc = e % BN;
      const bool ok = k0 + r < n && col0 + dc < D;
      hopper::cp_async4(Xs + r * X_LD + dc,
                        ok ? X + (size_t)(k0 + r) * D + col0 + dc : X,
                        ok ? 4 : 0);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
graph_mix_kernel(const float* __restrict__ A, const float* __restrict__ X,
                 const float* __restrict__ S, const float* __restrict__ b,
                 float* __restrict__ out, int n, int D, int a_vec, int x_vec,
                 int out_vec) {
  {  // this block's trial
    const size_t z = blockIdx.z, nn = (size_t)n * n, nd = (size_t)n * D;
    A += z * nn;
    X += z * nd;
    S += z * nd;
    b += z * n;
    out += z * nd;
  }
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);   // STAGES x [BM][A_LD]
  float* Xs = As + STAGES * A_STAGE;             // STAGES x [BK][X_LD]

  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp / (BN / WN)) * WM;        // warp's rows in the tile
  const int wn = (warp % (BN / WN)) * WN;        // and columns
  const int g = lane >> 2, t = lane & 3;         // mma fragment coordinates

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int k_tiles = (n + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles)
      load_stage(As + s * A_STAGE, Xs + s * X_STAGE, A, X, n, D, row0, col0,
                 s * BK, a_vec, x_vec);
    hopper::cp_async_commit();
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    hopper::cp_async_wait<STAGES - 2>();   // tile kt has landed
    __syncthreads();                       // and tile kt - 1 is consumed
    const int next = kt + STAGES - 1;
    if (next < k_tiles) {
      const int s = next % STAGES;
      load_stage(As + s * A_STAGE, Xs + s * X_STAGE, A, X, n, D, row0, col0,
                 next * BK, a_vec, x_vec);
    }
    hopper::cp_async_commit();             // possibly empty: keeps the count

    const float* as = As + (kt % STAGES) * A_STAGE + wm * A_LD;
    const float* xs = Xs + (kt % STAGES) * X_STAGE + wn;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* p = xs + (kk + t) * X_LD + j * 8 + g;
        hopper::split_tf32(p[0], bh[j][0], bl[j][0]);
        hopper::split_tf32(p[4 * X_LD], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        // the A fragment's four 8 x 4 blocks in its register order: rows
        // 16 i .. +7 and +8 .. +15 of columns kk .. +3, then of kk + 4 .. +7
        const int ar = i * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
        uint32_t a[4], ah[4], al[4];
        hopper::ldmatrix_x4(a, as + ar * A_LD + kk + 4 * (lane >> 4));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hopper::split_tf32(__uint_as_float(a[e]), ah[e], al[e]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          // this 8-deep step's partial sums start from zero, hi . hi apart
          // from the small terms, and reach acc by IEEE adds
          float hh[4] = {0.f, 0.f, 0.f, 0.f}, sm[4] = {0.f, 0.f, 0.f, 0.f};
          hopper::mma_tf32(sm, al, bh[j]);
          hopper::mma_tf32(sm, ah, bl[j]);
          hopper::mma_tf32(hh, ah, bh[j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += hh[e] + sm[e];
        }
      }
    }
  }

  // epilogue: acc[i][j] holds rows wm + 16 i + g (+ 8 for e >= 2) and
  // columns wn + 8 j + 2 t (+ 1 for odd e)
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm + 16 * i + g + 8 * h;
      if (r >= n) continue;
      const float br = b[r];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = col0 + wn + 8 * j + 2 * t;
        const size_t o = (size_t)r * D + c;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (out_vec && c + 1 < D) {
          const float2 s2 = *reinterpret_cast<const float2*>(S + o);
          *reinterpret_cast<float2*>(out + o) =
              make_float2(v0 + br * s2.x, v1 + br * s2.y);
        } else {
          if (c < D) out[o] = v0 + br * S[o];
          if (c + 1 < D) out[o + 1] = v1 + br * S[o + 1];
        }
      }
    }
}

constexpr int SMALL_D = 8;          // widest D the rows kernel takes
constexpr int ROWS_THREADS = 256;
constexpr int ROW_LANES = 16;       // lanes of a row: two rows a warp
constexpr int ROW_BLOCK = ROWS_THREADS / ROW_LANES;   // rows of a block
constexpr int CHUNKS = 5;           // 4-float chunks a lane loads at once
constexpr int STAGE_MAX = 48 * 1024;   // bytes of theta a block may stage

// out[z, i, :] = A[z, i, :] @ theta[z] + b[z, i] * sol[z, i, :] for the
// rows i of block (blockIdx.x, z = blockIdx.y), ROW_LANES lanes a row.
// A row is cut in 4-float chunks, chunk c to lane c % ROW_LANES; a lane
// loads CHUNKS of its chunks (16-byte loads when ``vec``, else 4-byte
// ones), then adds their products in chunk and element order with FFMA,
// then the row's lanes meet in a butterfly.  So a row's sum order depends
// only on n and D.  theta[z] sits in shared memory when ``staged`` (as
// chunks of 4 D floats, zero past row n), else it is read through __ldg.
template <int D>
__global__ void __launch_bounds__(ROWS_THREADS)
graph_mix_rows_kernel(const float* __restrict__ A,
                      const float* __restrict__ X,
                      const float* __restrict__ S,
                      const float* __restrict__ b, float* __restrict__ out,
                      int n, int vec, int staged) {
  extern __shared__ float4 xs4[];
  const size_t z = blockIdx.y;
  const int g = threadIdx.x % ROW_LANES;
  const int i = blockIdx.x * ROW_BLOCK + threadIdx.x / ROW_LANES;
  const bool live = i < n;          // dead rows still stage and shuffle
  const int nc = (n + 3) / 4;       // chunks of a row
  const float* a = A + (z * n + (live ? i : 0)) * n;
  const float* x = X + z * n * D;

  float4 av[CHUNKS];
  auto load = [&](int q0) {         // this lane's chunks q0 .. q0 + CHUNKS
#pragma unroll
    for (int s = 0; s < CHUNKS; ++s) {
      const int c = g + ROW_LANES * (q0 + s), k = 4 * c;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live && c < nc) {
        if (vec) {
          v = __ldcs(reinterpret_cast<const float4*>(a) + c);
        } else {
          v.x = __ldcs(a + k);
          if (k + 1 < n) v.y = __ldcs(a + k + 1);
          if (k + 2 < n) v.z = __ldcs(a + k + 2);
          if (k + 3 < n) v.w = __ldcs(a + k + 3);
        }
      }
      av[s] = v;
    }
  };
  load(0);                          // A in flight while theta is staged

  if (staged) {                     // uniform over the grid
    float* xs = reinterpret_cast<float*>(xs4);
    for (int t = threadIdx.x; t < nc * 4 * D; t += ROWS_THREADS)
      xs[t] = t < n * D ? x[t] : 0.f;
    __syncthreads();
  }

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  const int rounds = (nc + ROW_LANES * CHUNKS - 1) / (ROW_LANES * CHUNKS);
  for (int r = 0; r < rounds; ++r) {
    if (r > 0) load(r * CHUNKS);
#pragma unroll
    for (int s = 0; s < CHUNKS; ++s) {
      const int c = g + ROW_LANES * (r * CHUNKS + s), k = 4 * c;
      if (!live || c >= nc) continue;
      float xv[4 * D];              // theta rows k .. k + 3
      if (staged) {
#pragma unroll
        for (int q = 0; q < D; ++q) {
          const float4 t = xs4[c * D + q];
          xv[4 * q] = t.x, xv[4 * q + 1] = t.y;
          xv[4 * q + 2] = t.z, xv[4 * q + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4 * D; ++j)
          xv[j] = k + j / D < n ? __ldg(x + (size_t)k * D + j) : 0.f;
      }
      const float ae[4] = {av[s].x, av[s].y, av[s].z, av[s].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k + e < n) {
#pragma unroll
          for (int d = 0; d < D; ++d)
            acc[d] = fmaf(ae[e], xv[e * D + d], acc[d]);
        }
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int off = ROW_LANES / 2; off > 0; off >>= 1)
      acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], off);
  if (live && g < D) {              // lane g writes column g
    float v = acc[0];
#pragma unroll
    for (int d = 1; d < D; ++d)
      if (g == d) v = acc[d];
    const size_t row = z * n + i, o = row * D + g;
    out[o] = v + b[row] * S[o];
  }
}

// whether every trial's base, p + z * stride floats for z < T, is
// aligned to ``bytes``
bool aligned(const void* p, size_t stride, int T, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0 &&
         (T == 1 || stride * sizeof(float) % bytes == 0);
}

template <int D>
void launch_rows(const float* A, const float* theta, const float* sol,
                 const float* b, float* out, int T, int n,
                 cudaStream_t stream) {
  const size_t stage = (size_t)(n + 3) / 4 * 4 * D * sizeof(float);
  const int staged = stage <= STAGE_MAX;
  const int vec = n % 4 == 0 && aligned(A, (size_t)n * n, T, 16);
  dim3 grid((n + ROW_BLOCK - 1) / ROW_BLOCK, T);
  graph_mix_rows_kernel<D><<<grid, ROWS_THREADS, staged ? stage : 0,
                             stream>>>(A, theta, sol, b, out, n, vec, staged);
}


// ---------------------------------------------------------------------------
// agent axis: n <= 32, D > SMALL_D
// ---------------------------------------------------------------------------

constexpr int AGENT_MAX = 32;       // widest n the agents kernel takes
constexpr int AGENT_THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// COLS elements of E at p (16- or 8-byte aligned when vec) as floats;
// past ``left`` elements they read as zero
template <typename E, int COLS>
__device__ __forceinline__ void load_cols(const E* __restrict__ p, bool vec,
                                          size_t left, float (&v)[COLS]) {
  if (vec) {
    constexpr int WORDS = COLS * sizeof(E) / 4;   // 32-bit words: 2 or 4
    uint32_t w[WORDS];
    if constexpr (WORDS == 4) {
      const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
      w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
    } else {
      const uint2 q = __ldcs(reinterpret_cast<const uint2*>(p));
      w[0] = q.x, w[1] = q.y;
    }
    const E* e = reinterpret_cast<const E*>(w);
#pragma unroll
    for (int c = 0; c < COLS; ++c) v[c] = to_f32(e[c]);
  } else {
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      v[c] = (size_t)c < left ? to_f32(p[c]) : 0.f;
  }
}

// COLS floats to p as E (one 16- or 8-byte store when vec), the first
// ``left`` of them otherwise
template <typename E, int COLS>
__device__ __forceinline__ void store_cols(E* __restrict__ p, bool vec,
                                           size_t left,
                                           const float (&v)[COLS]) {
  if (vec) {
    constexpr int WORDS = COLS * sizeof(E) / 4;
    uint32_t w[WORDS];
    E* e = reinterpret_cast<E*>(w);
#pragma unroll
    for (int c = 0; c < COLS; ++c) from_f32(v[c], e + c);
    if constexpr (WORDS == 4)
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    else
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      if ((size_t)c < left) from_f32(v[c], p + c);
  }
}

template <typename E, int NMAX, int COLS>
__global__ void __launch_bounds__(AGENT_THREADS)
graph_mix_agents_kernel(const E* __restrict__ A, const E* __restrict__ X,
                        const E* __restrict__ S, const float* __restrict__ b,
                        E* __restrict__ out, int n, size_t D, int vec) {
  __shared__ float at[NMAX * NMAX];   // at[j * NMAX + i] = A[i, j]
  __shared__ float bs[NMAX];
  const size_t z = blockIdx.y, nd = (size_t)n * D;
  A += z * n * n;
  X += z * nd;
  S += z * nd;
  b += z * n;
  out += z * nd;
  for (int t = threadIdx.x; t < NMAX * NMAX; t += AGENT_THREADS) {
    const int j = t / NMAX, i = t % NMAX;
    at[t] = i < n && j < n ? to_f32(A[i * n + j]) : 0.f;
  }
  for (int t = threadIdx.x; t < NMAX; t += AGENT_THREADS)
    bs[t] = t < n ? b[t] : 0.f;
  __syncthreads();

  const size_t groups = (D + COLS - 1) / COLS;
  for (size_t gi = (size_t)blockIdx.x * AGENT_THREADS + threadIdx.x;
       gi < groups; gi += (size_t)gridDim.x * AGENT_THREADS) {
    const size_t c0 = gi * COLS, left = D - c0;
    float acc[NMAX][COLS];
#pragma unroll
    for (int i = 0; i < NMAX; ++i)
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[i][c] = 0.f;
#pragma unroll
    for (int j = 0; j < NMAX; ++j) {
      if (j >= n) break;
      float x[COLS];
      load_cols<E, COLS>(X + (size_t)j * D + c0, vec, left, x);
#pragma unroll
      for (int i = 0; i < NMAX; ++i) {
        const float a = at[j * NMAX + i];
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[i][c] = fmaf(a, x[c], acc[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < NMAX; ++i) {
      if (i >= n) break;
      float s[COLS];
      load_cols<E, COLS>(S + (size_t)i * D + c0, vec, left, s);
      float v[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c) v[c] = fmaf(bs[i], s[c], acc[i][c]);
      store_cols<E, COLS>(out + (size_t)i * D + c0, vec, left, v);
    }
  }
}

template <typename E, int NMAX>
int launch_agents(const E* A, const E* theta, const E* sol, const float* b,
                  E* out, int T, int n, size_t D, cudaStream_t stream) {
  // 16 bytes of E a thread, unless that needs more than 128 accumulators
  constexpr int COLS16 = 16 / sizeof(E);
  constexpr int COLS = NMAX * COLS16 <= 128 ? COLS16 : 128 / NMAX;
  const size_t bytes = COLS * sizeof(E), trial = (size_t)n * D * sizeof(E);
  auto ok = [&](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0 &&
           (T == 1 || trial % bytes == 0);
  };
  const int vec = D % COLS == 0 && ok(theta) && ok(sol) && ok(out);
  const size_t groups = (D + COLS - 1) / COLS;
  const size_t want = (groups + AGENT_THREADS - 1) / AGENT_THREADS;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t cap = (size_t)sms * 16;       // a grid stride past that
  dim3 grid((unsigned)(want < cap ? want : cap), T);
  graph_mix_agents_kernel<E, NMAX, COLS><<<grid, AGENT_THREADS, 0, stream>>>(
      A, theta, sol, b, out, n, D, vec);
  return (int)cudaGetLastError();
}

template <typename E>
int graph_mix_agents(const E* A, const E* theta, const E* sol,
                     const float* b, E* out, int T, int n, size_t D,
                     cudaStream_t stream) {
  if (n <= 4) return launch_agents<E, 4>(A, theta, sol, b, out, T, n, D,
                                         stream);
  if (n <= 8) return launch_agents<E, 8>(A, theta, sol, b, out, T, n, D,
                                         stream);
  if (n <= 16) return launch_agents<E, 16>(A, theta, sol, b, out, T, n, D,
                                           stream);
  return launch_agents<E, 32>(A, theta, sol, b, out, T, n, D, stream);
}

}  // namespace

// The agent-axis form alone, in float32 (is_bf16 = 0) or bf16 (1): A
// (T, n, n), theta, sol and out (T, n, D) of that type, b (T, n) float32;
// 1 <= n <= 32.  Returns cudaGetLastError() after the launch.
extern "C" int repro_graph_mix_agents(const void* A, const void* theta,
                                      const void* sol, const float* b,
                                      void* out, int T, int n, long long D,
                                      int is_bf16, cudaStream_t stream) {
  if (T < 1 || n < 1 || n > AGENT_MAX || D < 1)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return graph_mix_agents(static_cast<const __nv_bfloat16*>(A),
                            static_cast<const __nv_bfloat16*>(theta),
                            static_cast<const __nv_bfloat16*>(sol), b,
                            static_cast<__nv_bfloat16*>(out), T, n,
                            (size_t)D, stream);
  return graph_mix_agents(static_cast<const float*>(A),
                          static_cast<const float*>(theta),
                          static_cast<const float*>(sol), b,
                          static_cast<float*>(out), T, n, (size_t)D, stream);
}

// A (T, n, n), theta (T, n, D), sol (T, n, D), b (T, n), out (T, n, D):
// contiguous f32 on the device, T <= 65535.  D <= 8 takes the rows
// kernel, n <= 32 the agents kernel, the rest the tile kernel.  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_graph_mix(const float* A, const float* theta,
                               const float* sol, const float* b, float* out,
                               int T, int n, int D, cudaStream_t stream) {
  if (T > 0 && n > 0 && D > 0 && D <= SMALL_D) {
    void (*const rows[SMALL_D])(const float*, const float*, const float*,
                                const float*, float*, int, int,
                                cudaStream_t) = {
        launch_rows<1>, launch_rows<2>, launch_rows<3>, launch_rows<4>,
        launch_rows<5>, launch_rows<6>, launch_rows<7>, launch_rows<8>};
    rows[D - 1](A, theta, sol, b, out, T, n, stream);
  } else if (T > 0 && n > 0 && D > 0 && n <= AGENT_MAX) {
    return graph_mix_agents(A, theta, sol, b, out, T, n, (size_t)D, stream);
  } else if (T > 0 && n > 0 && D > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        graph_mix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const size_t nn = (size_t)n * n, nd = (size_t)n * D;
    const int a_vec = n % 4 == 0 && aligned(A, nn, T, 16);
    const int x_vec = D % 4 == 0 && aligned(theta, nd, T, 16);
    const int out_vec = D % 2 == 0 && aligned(sol, nd, T, 8) &&
                        aligned(out, nd, T, 8);
    dim3 grid((D + BN - 1) / BN, (n + BM - 1) / BM, T);
    graph_mix_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
        A, theta, sol, b, out, n, D, a_vec, x_vec, out_vec);
  }
  return (int)cudaGetLastError();
}
