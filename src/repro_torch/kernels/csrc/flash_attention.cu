// flash_attention: causal, optionally sliding-window attention with an
// online softmax, GQA read in place.
//   q (B, S, H, hd), k and v (B, S, KH, hd) with KH | H, o like q; query
//   head h reads kv head h / (H / KH).  Per query row, over the keys with
//   kpos <= qpos (and kpos > qpos - window when window > 0):
//   o = softmax(scale * q . k) @ v, logits, softmax and the weighted sum
//   in float32, the output rounded to the input type.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (_kernel).  There the kv blocks are the sequential last
// grid axis and carry m, l and the accumulator in VMEM scratch from one
// grid step to the next.  Hopper blocks run in no order, so one block owns
// one (batch * head, 64-query tile) and walks its kv tiles in a loop:
//   - the loop runs from the first tile the window reaches to the tile of
//     the tile's last query (the causal limit); fully masked tiles are
//     never loaded, as the TPU kernel skips them;
//   - q, k and v are read as 16-byte vectors (8 bf16 or 4 float) and kept
//     in shared memory as float32 (q and k transposed, so a thread reads
//     four rows or four keys as one float4);
//   - 256 threads as a 16 x 16 grid: thread (ty, tx) owns queries
//     4 ty .. 4 ty + 3 and, of the 64 x 64 logit tile, keys 4 tx .. +3;
//     the row max and row sum are reduced over the 16 threads of a row by
//     warp shuffles; m, l and the thread's 4 x (hd / 16) accumulator
//     (columns 64 g + 4 tx .. +3, so a quarter-warp reads 8 neighbouring
//     float4 of a V row) stay in registers for the whole loop;
//   - the weights go through shared memory (transposed) for P @ V;
//   - the heaviest causal tiles (the last queries) are scheduled first.
// A masked logit is -1e30, as in the TPU kernel: a row with no live key in
// an early tile accumulates garbage with m = -1e30 and is wiped (alpha =
// exp(-1e30 - m) = 0) by its first live tile, which always comes (the
// diagonal key).  The output is acc / max(l, 1e-20).
//
// Bound on an H100: operations.  The causal work is 4 B H hd sum_q n(q)
// (n(q) = min(q + 1, window) live keys; 2 B H S^2 hd without a window),
// against 989 TFLOP/s dense bf16; the bytes (q, o and the un-expanded k
// and v) take far less.  This kernel is plain FMA on float32 tiles
// (67 TFLOP/s at most), so it cannot come near that bound: tensor-core
// tiles (mma / wgmma) are a later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BK = 64;        // keys per kv tile
constexpr int THREADS = 256;  // 16 x 16
constexpr float NEG_INF = -1e30f;

// 16 bytes of T from global memory, as floats (4 float or 8 bf16)
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int KH, int window, float scale) {
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int CHUNKS = HD / VEC;      // 16-byte loads per row
  constexpr int DC = HD / 16;           // accumulator columns per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [HD][BQ]
  float* Kt = Qt + HD * BQ;                     // [HD][BK]
  float* Vs = Kt + HD * BK;                     // [BK][HD]
  float* Ps = Vs + BK * HD;                     // [BK][BQ]

  const int qi = gridDim.x - 1 - blockIdx.x;    // heaviest tiles first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kh = h / (H / KH);
  const int q0 = qi * BQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t q_stride = (size_t)H * HD;       // between positions
  const size_t kv_stride = (size_t)KH * HD;
  const T* qb = q + (size_t)b * S * q_stride + (size_t)h * HD;
  const T* kb = k + (size_t)b * S * kv_stride + (size_t)kh * HD;
  const T* vb = v + (size_t)b * S * kv_stride + (size_t)kh * HD;
  T* ob = o + (size_t)b * S * q_stride + (size_t)h * HD;

  // transposed stores: neighbouring lanes take neighbouring rows, so the
  // scalar stores to [d][row] hit 32 different banks
  for (int c = tid; c < BQ * CHUNKS; c += THREADS) {
    const int r = c % BQ, d0 = (c / BQ) * VEC;
    float f[VEC];
    load16(qb + (size_t)(q0 + r) * q_stride + d0, f);
#pragma unroll
    for (int j = 0; j < VEC; ++j) Qt[(d0 + j) * BQ + r] = f[j];
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int q_last = q0 + BQ - 1;
  const int kt_end = q_last / BK;               // causal limit, inclusive
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the last tile's reads of Kt, Vs and Ps are done
    for (int c = tid; c < BK * CHUNKS; c += THREADS) {
      const int r = c % BK, d0 = (c / BK) * VEC;
      float f[VEC];
      load16(kb + (size_t)(k0 + r) * kv_stride + d0, f);
#pragma unroll
      for (int j = 0; j < VEC; ++j) Kt[(d0 + j) * BK + r] = f[j];
    }
    for (int c = tid; c < BK * CHUNKS; c += THREADS) {
      const int r = c / CHUNKS, d0 = (c % CHUNKS) * VEC;
      float f[VEC];
      load16(vb + (size_t)(k0 + r) * kv_stride + d0, f);
#pragma unroll
      for (int j = 0; j < VEC; j += 4)
        *reinterpret_cast<float4*>(&Vs[r * HD + d0 + j]) =
            make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * BQ + ty * 4]);
      const float4 bb = *reinterpret_cast<const float4*>(&Kt[d * BK + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        const bool live = kp <= qp && (window <= 0 || kp > qp - window);
        s[i][j] = live ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Ps[(tx * 4 + j) * BQ + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(&Ps[kk * BQ + ty * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      float vv[DC];
#pragma unroll
      for (int g = 0; g < DC / 4; ++g) {
        const float4 x =
            *reinterpret_cast<const float4*>(&Vs[kk * HD + g * 64 + tx * 4]);
        vv[4 * g] = x.x;
        vv[4 * g + 1] = x.y;
        vv[4 * g + 2] = x.z;
        vv[4 * g + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = fmaxf(l[i], 1e-20f);
    T* orow = ob + (size_t)(q0 + ty * 4 + i) * q_stride + tx * 4;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store(orow + (c / 4) * 64 + c % 4, acc[i][c] / li);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KH, int window, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * HD * BQ + BK * HD + BK * BQ);
  auto kernel = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(S / BQ, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KH, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o (B, S, H, hd) and k, v (B, S, KH, hd), contiguous, all float32
// (is_bf16 = 0) or all bfloat16 (is_bf16 = 1); hd in {64, 128},
// S % 64 == 0, KH | H; window <= 0 means none; scale multiplies q . k.
// Returns 1 (cudaErrorInvalidValue) for a shape outside that contract.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int S,
                                     int H, int KH, int hd, int window,
                                     int is_bf16, float scale,
                                     cudaStream_t stream) {
  if (S <= 0 || S % BQ || KH <= 0 || H % KH || B <= 0) return 1;
  if (hd == 128)
    return is_bf16 ? launch<__nv_bfloat16, 128>(q, k, v, o, B, S, H, KH,
                                                window, scale, stream)
                   : launch<float, 128>(q, k, v, o, B, S, H, KH, window,
                                        scale, stream);
  if (hd == 64)
    return is_bf16 ? launch<__nv_bfloat16, 64>(q, k, v, o, B, S, H, KH,
                                               window, scale, stream)
                   : launch<float, 64>(q, k, v, o, B, S, H, KH, window,
                                       scale, stream);
  return 1;
}
