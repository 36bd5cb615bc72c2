// flash_attention: causal, optionally sliding-window attention with an
// online softmax, GQA read in place.
//   q (B, S, H, hd), k and v (B, S, KH, hd) with KH | H, o like q; query
//   head h reads kv head h / (H / KH).  Per query row, over the keys with
//   kpos <= qpos (and kpos > qpos - window when window > 0):
//   o = softmax(scale * q . k) @ v, logits and softmax in float32, the
//   output rounded to the input type.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (_kernel).  There the kv blocks are the sequential last
// grid axis and carry m, l and the accumulator in VMEM scratch from one
// grid step to the next.  Hopper blocks run in no order, so a block owns
// one (batch * head, query tile) and walks its kv tiles in a loop, from the
// first tile the window reaches to the tile of the tile's last query (the
// causal limit): fully masked tiles are never loaded, as the TPU kernel
// skips them.  The heaviest causal tiles (the last queries) go first.
//
// Bound on an H100.  The causal work is 4 B H hd sum_q n(q) operations
// (n(q) = min(q + 1, window) live keys; 2 B H S^2 hd without a window)
// against 989 TFLOP/s dense bf16 (in float32 three times that against 495
// TFLOP/s TF32: below); the bytes are q, o and the un-expanded k and v,
// read and written once.  At the served shapes:
//   - hd 128 and 256 (Llama-3-8B's prefill, RecurrentGemma-2B's 2048
//     window at S 4096): operations, by several times the bytes;
//   - hd 64 (MusicGen-medium: S 1024, 24 heads, MHA): bytes and operations
//     are both about 3.5 us, so the time is set by fixed costs (the
//     launch, the first copies' latency, the epilogue) and by how evenly
//     the blocks fill the 132 SMs.
// So bf16 runs on the tensor cores, in one of two designs:
//
// bf16, hd 128: wgmma + TMA (flash_fwd_wgmma).  One block of two
//   warpgroups per (batch * head, 128-query tile); each warpgroup owns 64
//   query rows, wgmma's M.  kv tiles are BK = 128 keys.
//   - Copies by TMA, with 4-D tensor maps (hd, heads, S, B) built on the
//     host per call, 64-element (128-byte) boxes and 128-byte swizzle, so
//     tiles land in the layout the wgmma descriptors read.  Q is loaded
//     once; K and V run through a 2-stage ring whose stages complete on
//     mbarriers.  The last of the 8 warps to finish with tile i (a counter
//     per stage) issues tile i + 2 into its stage, so no warp waits for
//     another and the next tile is in flight while a tile is computed.
//     The maps address kv head h / (H / KH) in place; reads past S are
//     zero-filled (S % 64 == 0, so a 128-query tile may be half full; its
//     rows >= S are never stored).
//   - The grid is (B * H, query tiles) with the heaviest causal tiles (the
//     last queries) of every head launched first, so the short tiles fill
//     the end of the run.
//   - Shared memory: Q 32 KB, K and V 2 x 32 KB each: 160 KB, above 48 KB
//     by cudaFuncSetAttribute (once per device).
//   - S = Q K^T: hd / 16 wgmma.m64n128k16, A and B from shared memory,
//     both K-major (hd is contiguous in q and k).
//   - Online softmax in registers, in the log2 domain (scale * log2 e is
//     folded into one multiply, exp2): masks only on the diagonal tiles and
//     the window's edge tiles; m and l in float32, a row's max over the 4
//     threads that share it in the accumulator layout (l is summed per
//     thread and reduced once at the end).  A masked logit is -1e30, as in
//     the TPU kernel: a row with no live key in an early tile accumulates
//     garbage with m = -1e30 and is wiped (alpha = exp2(-1e30 - m) = 0) by
//     its first live tile, which always comes (the diagonal key).
//   - O += P V: P is rounded to bf16 once, in registers, and fed as
//     wgmma's A operand from registers (for 16-bit types the accumulator
//     layout of S is the A-fragment layout, so no shuffle is needed); V is
//     read from shared memory as an MN-major B (the transposed-B form); O
//     accumulates in float32.  The output is O / max(l, 1e-20), l summed
//     from the unrounded weights, rounded to bf16 and stored from
//     registers (rows < S only).
//   - Rounding P to bf16 per kv tile against the running max is what the
//     JAX oracle repro.kernels.ref.flash_attention does too (it rounds the
//     weights to v's dtype before P V).  Emulated on the CPU against the
//     float32-weight plain version it stays within one bf16 ulp of the
//     output, inside the 1e-2 abs/rel bar (tests/test_torch_tc_numerics.py).
//   - A warpgroup's softmax does not overlap its own products and the two
//     warpgroups are not scheduled against each other; flash_fwd_ws below
//     is the design that does both.
//
// bf16, hd 256 and 64: warp-specialised wgmma + TMA (flash_fwd_ws).  The
//   algorithm is flash_fwd_wgmma's (the same maps and descriptors, masks,
//   online softmax, P rounded to bf16 per kv tile, epilogue); what changes
//   is who does what and when, the tiles, and the instructions a weight.
//   - Two consumer warpgroups.  K and V come through separate rings of kv
//     tiles.  Each stage has a full mbarrier (its copy landed) and an
//     empty one (its reader warps released it): K is released as soon as
//     S has read it and V once P V has, so a stage's refill starts a tile
//     before one barrier for both would let it.
//   - Softmax under the tensor cores, inside a warpgroup: S_i = Q K_i^T is
//     issued with O += P_{i-1} V_{i-1} behind it; wgmma.wait_group 1 waits
//     for S_i alone, its softmax runs while P V is on the tensor cores,
//     then wait_group 0, O is rescaled and P_i rounded.  O sees the same
//     operations in the same order as in flash_fwd_wgmma (O *= alpha_i,
//     then O += P_i V_i).  Fewer instructions a weight: 2^x is one
//     ex2.approx.ftz (exp2f adds a range check for results below 2^-126);
//     in a tile with no masked key the max is taken on the raw logits and
//     a weight is 2^fma(s, scale, -m); the wgmma descriptors are a base
//     plus a constant.
//   - hd 256 (operations): 128-query blocks, the consumer warpgroups on
//     rows 0..63 and 64..127, and a producer warpgroup whose one thread
//     issues every copy; 384 threads, one block an SM.  setmaxnreg hands
//     the producer's registers to the consumers (24 and 240: 128 x 24 +
//     256 x 240 = 64,512 of 65,536), whose 64 x 256 float32 O takes 128 a
//     thread beside an S tile (40) and P (20).  Named barriers (bar.sync
//     1 + w, 256) let the two warpgroups issue their products in turn, so
//     one's softmax runs under the other's products (ping-pong).  kv tiles
//     are 80 keys: Q 64 KB + K and V 2 x 40 KB each = 224 KB.  S reads
//     its Q operand from shared memory again for every kv tile, as many
//     bytes as of K at 64 keys; 80 keys cut that share.  The products
//     alone (no softmax) run at under 60 % of the tensor-core peak; that
//     operand traffic is the suspect, unmeasured without a profiler.
//   - hd 64 (bytes, fixed costs, fill): the time is the heaviest query
//     tile's walk (16 kv tiles of 64 keys at S 1024) plus each block's
//     start and end.  64-query blocks, the two consumer warpgroups on the
//     same 64 rows, the block's kv tiles dealt to them in turn (tile i in
//     stage i % 4, so each warpgroup reads two of the four), each with its
//     own m, l and O; warpgroup 1 hands its state to warpgroup 0 through
//     shared memory at the end, which merges them (m = max, O and l scaled
//     by 2^(m_w - m) and summed) and stores: the longest walk is halved.
//     No producer: one thread loads Q and the first four tiles, then each
//     warpgroup refills its own stages (one thread of it, once its four
//     warps have released the stage), because a ninth warp would cap two
//     blocks an SM at 96 registers a thread (five warps on a scheduler).
//     256 threads at most 128 registers, Q 8 KB + K and V 4 x 8 KB each +
//     18 KB for the merge: two blocks an SM.
//   - Next steps: a persistent grid walking an LPT-ordered tile list (hd
//     256: 320 blocks whose work runs from 2 to 28 kv tiles, about 2.4
//     waves; hd 64: 384 blocks on 264 slots, each block's start and end
//     paid twice on most SMs), prefetching the next tile's Q and first kv
//     tiles under the current one; Q in registers for S at hd 64 (16 a
//     thread), so S reads only K from shared memory; a TMA-store epilogue.
//
// float32 at hd 64 and 128: 3xTF32 on wgmma (flash_fwd_3xtf32).  The bar
//   is 1e-5 against the float32 plain version, which one TF32 pass
//   (10-bit mantissa) misses; three meet it: each operand is x =
//   hi + lo, hi = x rounded to the nearest TF32 (hopper::split_tf32), lo
//   = x - hi read as TF32, and a . b ~ a_hi b_hi + (a_lo b_hi + a_hi b_lo)
//   (tests/test_torch_tc_numerics.py emulates it at the kernel's tiles).
//   So the bound is three TF32 passes at 495 TFLOP/s: 0.833 ms at
//   Llama-3-8B's prefill shape in float32, whose FFMA floor is 2.05 ms.
//   FFMA cannot come near it: at a small shape one SM's FFMA rate makes
//   the heaviest query tile alone take twice the whole FFMA bound.
//   - The tensor core adds into its accumulator with truncation, so each
//     kv tile's products start from zeroed fragments: Q_hi K_hi^T in one,
//     Q_lo K_hi^T + Q_hi K_lo^T in another, summed in IEEE float32; P V
//     the same way, and O = alpha O + (P V)_tile by IEEE FMAs.  No
//     truncating add carries across tiles (a row's P V sums S keys).
//   - TF32 wgmma reads shared-memory operands K-major only.  S's are as
//     stored (hd contiguous in q and k).  P V's A is P from registers and
//     its B is V^T, keys contiguous, transposed on its way in.  Within
//     each 8-key step V^T holds keys 0, 2, 4, 6, 1, 3, 5, 7: a thread's
//     accumulator columns 2t and 2t + 1 are A's k-slots t and t + 4, so
//     the weights computed in S's fragment are P's A fragment as they
//     stand, with no shuffle.
//   - One block per (batch * head, 64-query tile), heaviest first, two
//     warpgroups.  The producer loads Q, K and V with 16-byte loads,
//     splits each float into hi and lo (and transposes V) and stores them
//     as 128-byte-swizzled K-major tiles (the layout TMA writes and the
//     wgmma descriptors read); a quarter-warp's stores fill eight distinct
//     chunks of a row.  The consumer (64 rows, wgmma's M) runs S, the
//     online softmax (log2 domain, float32, masks only on the diagonal
//     and window-edge tiles) and P V in 32-column parts of O.  K and V
//     have rings of their own with full and empty mbarriers, and the
//     producer issues a tile's loads before it waits for a stage: K_{i+1}
//     lands under tile i's softmax and P V, V_{i+1} under S_{i+1}.
//   - kv tiles are 64 keys, S's wgmma N.  Every operand is held twice (hi
//     and lo): at hd 128 Q, K and V^T take 64 KB each, 192 KB with one
//     stage a ring; at hd 64 16 KB each, two stages, 160 KB.  One block an
//     SM; no spills (255 registers at hd 128, 191 at hd 64).
//   - What bounds it: shared memory and the consumer's one stream of work.
//     A 64-key tile at hd 128 reads 288 KB of operands (S re-reads Q for
//     every tile) and the producer writes 128 KB: about as long at 128
//     bytes a clock as the three passes at the TF32 peak.  The consumer's
//     softmax and the parts' adds do not overlap its products.
//   - Tried and dropped: 32-key tiles through one 2-stage ring of K and V
//     (two stages fit at hd 128 only at 32 keys; S's wgmma N = 32 reads
//     Q's 2 KB for every 1 KB of K); two P V parts in flight with S_{i+1}
//     issued under the last (255 registers and spills); 2^x by one
//     ex2.approx with the scale folded into an FMA on unmasked tiles.
//   - Next steps: overlap the softmax with the products (a second
//     consumer warpgroup has no shared memory left at hd 128); Q in
//     registers for S at hd 64.
//
// float32 at hd 256: 3xTF32 on wgmma, the head dim in 32-column pieces
//   (flash_fwd_3xtf32_pieces).  The arithmetic is flash_fwd_3xtf32's; S's
//   32 eight-deep steps are chained in hd order in one accumulator a tile.
//   Two things bound the design: shared memory (Q, K and V^T held whole in
//   hi and lo at 64 queries and 64 keys would take 384 KB of a block's
//   227) and the consumer's registers (O alone is 128 of a thread's 255).
//   - Q's hi and lo stay resident (128 KB).  K and V^T stream through one
//     ring of five 16 KB stages, each a piece of 64 keys x 32 hd in hi and
//     lo, with full and empty mbarriers a stage.  A kv tile is K's eight
//     pieces, then V^T's eight.  S issues piece c + 1's products before it
//     waits for piece c's and releases that stage; P V takes one V^T piece
//     a part (32 columns of O).
//   - P's hi stays in registers as P V's A fragments.  P's lo, which only
//     P_lo V_hi reads, goes to shared memory (16 KB, in V^T's key order)
//     and that product takes its A from there.  The consumer holds O
//     (128 registers), S's two accumulators (64) until the softmax, then
//     P's hi (32) and a part's two sums (32): no local memory at 255
//     registers.  With P's lo in registers too (64-hd pieces through three
//     32 KB stages) ptxas spilled 56 to 88 bytes at every P V part width
//     tried (8, 16 and 32 columns).
//   - One producer warpgroup loads each piece by 16-byte LDGs one piece
//     ahead of the one it splits and stores, into fragments picked at
//     compile time (indexed arrays of them went to local memory).
//   - ptxas serialized every wgmma (C7520) while a stage was released by
//     lane 0 alone and the wait before a batch relied on ptxas's own
//     wgmma.fence: every consumer thread arrives, and each wait ends in a
//     wgmma.fence.
//   - Heaviest query tiles first: at RecurrentGemma-2B's float32 prefill
//     shape (S 4096, H 10, K 1, window 2048) 640 blocks walk 1 to 33 kv
//     tiles, 15,840 tile steps, 120 an SM on average (how evenly the
//     SMs end was not measured for this design).
//   - Measured (NVIDIA H100 80GB HBM3, 700.00 W; tools/
//     probe_flash_attention.py, two calls): 1.0390-1.0475 device ms at
//     that shape against the parent's FFMA kernel's 2.6499-2.7438 in the
//     same calls, a 0.3905 ms bound (three TF32 passes at the TF32 peak:
//     37-38 % of it) and SDPA's float32 call's 4.64-4.70 ms; 0.0314-0.0316
//     ms at B 1, S 512, H 4, K 2, window 128 (the parent 0.0707-0.0717).
//   - What holds it there, by count (not measured): a tile step moves
//     about 960 KB through shared memory (S's operands 384 KB, P V's 320
//     KB, the producer's hi and lo stores 256 KB), some 7,500 clocks at
//     128 bytes a clock, against about 6,100 clocks of tensor work; and
//     S's m64n64k8 products read as many operand bytes a clock as the
//     shared memory delivers.  Wider S tiles would cut the Q re-reads but
//     need registers the consumer does not have.
//   - Tried and dropped: P's lo in registers (above: spills; 1.03-1.06
//     ms); the producer loading two or three pieces ahead, and two P V
//     parts in flight: no faster; all of P through shared memory: spills
//     and slower; every wgmma serialized by ptxas (C7520), 1.61-1.64 ms.
//   - Next steps: fewer shared-memory bytes a tile step (Q's hi and lo
//     read once for two kv tiles, or the split moved into the consumer's
//     idle slots), then a second producer warpgroup.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// a kernel's dynamic shared memory limit (above the default 48 KB), and
// for a kernel meant to share an SM with others of its blocks the largest
// shared-memory carveout of the SM's 256 KB, so its occupancy does not
// rest on the carveout CUDA would pick
cudaError_t configure(const void* kernel, int bytes, bool max_carveout) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && max_carveout)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

// configure() once per kernel and device, not on every launch: `done` is
// the calling launch's own static flags (a second thread racing past them
// only configures the kernel twice)
constexpr int MAX_DEVICES = 64;

cudaError_t configure_once(const void* kernel, int bytes, bool max_carveout,
                           bool (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = configure(kernel, bytes, max_carveout);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

// ---- bf16: wgmma + TMA ------------------------------------------------------

namespace tc {

using hopper::desc_sw128;

constexpr int BQ = 128;                 // queries per block: 2 x wgmma M
constexpr int THREADS = 256;            // two warpgroups
constexpr int BOX = 64;                 // bf16 per 128-byte swizzle row
constexpr uint32_t ATOM_ROWS_BYTES = 1024;   // 8 rows x 128 bytes

// keys per kv tile (wgmma N of S) of flash_fwd_wgmma: 128.  The template
// also compiles at hd = 256 with 64-key tiles (128-key stages would take
// 320 KB of shared memory), but launch() sends hd 256 and 64 to
// flash_fwd_ws and instantiates this kernel at 128 only
template <int HD>
constexpr int kv_tile() { return HD > 128 ? 64 : 128; }

template <int HD>
struct Smem {
  static constexpr int BK = kv_tile<HD>();
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;      // one stage of K or V
  static constexpr int BARS = 4;           // q, full x 2, 2 warp counters
  static constexpr int BYTES = Q_BYTES + 4 * KV_BYTES + 8 * BARS
                               + 1024;              // 1024-byte alignment
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// A tile of R rows x HD bf16 lands as HD / 64 column blocks, each R rows
// of 128 bytes (swizzled), the block c at c * R * 128 bytes.
template <int HD>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int rows, int head,
                                          int pos, int b) {
#pragma unroll
  for (int c = 0; c < HD / BOX; ++c)
    hopper::tma_load_4d(dst + c * rows * 128, map, bar, c * BOX, head, pos,
                        b);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, int S, int H, int KH,
                int window, float scale_log2) {
  using L = Smem<HD>;
  constexpr int BK = L::BK;
  // O accumulator, HD / 2 floats a thread, as NPART wgmma accumulators of
  // at most 128 columns (NP floats) each
  constexpr int NPART = HD > 128 ? HD / 128 : 1;
  constexpr int NP = HD / 2 / NPART;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sK = sQ + L::Q_BYTES;        // 2 stages
  uint8_t* sV = sK + 2 * L::KV_BYTES;   // 2 stages
  uint64_t* bars = reinterpret_cast<uint64_t*>(sV + 2 * L::KV_BYTES);
  uint64_t* bar_q = bars;
  uint64_t* full = bars + 1;            // K and V of a stage landed
  int* done = reinterpret_cast<int*>(bars + 3);   // warps done, per stage

  const int qi = gridDim.y - 1 - blockIdx.y;    // heaviest tiles first
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kh = h / (H / KH);
  const int q0 = qi * BQ;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, quad = lane & 3;

  const int kt_end = (q0 + BQ - 1) / BK;        // causal limit, inclusive
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;
  const int n_tiles = kt_end - kt_begin + 1;

  auto load_kv = [&](int stage, int kt) {
    hopper::mbar_expect_tx(&full[stage], 2 * L::KV_BYTES);
    load_tile<HD>(sK + stage * L::KV_BYTES, &tm_k, &full[stage], BK, kh,
                  kt * BK, b);
    load_tile<HD>(sV + stage * L::KV_BYTES, &tm_v, &full[stage], BK, kh,
                  kt * BK, b);
  };
  if (tid == 0) {
    hopper::mbar_init(bar_q, 1);
    hopper::mbar_init(&full[0], 1);
    hopper::mbar_init(&full[1], 1);
    done[0] = done[1] = 0;
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(bar_q, L::Q_BYTES);
    load_tile<HD>(sQ, &tm_q, bar_q, BQ, h, q0, b);
    load_kv(0, kt_begin);
    if (n_tiles > 1) load_kv(1, kt_begin + 1);
  }
  __syncwarp();

  // this thread's two query rows (of the block's 128) in the accumulator
  // layout: warpgroup wg rows 64 wg .. +63, warp rows 16 warp .. +15
  const int r0 = 64 * wg + 16 * warp + (lane >> 2);
  const int row0 = q0 + r0, row1 = row0 + 8;
  float o_acc[NPART][NP];
#pragma unroll
  for (int p = 0; p < NPART; ++p)
#pragma unroll
    for (int i = 0; i < NP; ++i) o_acc[p][i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  const uint32_t q_addr = hopper::smem_addr(sQ) + wg * 64 * 128;
  hopper::mbar_wait(bar_q, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i & 1;
    const uint32_t parity = (i >> 1) & 1;
    const int kt = kt_begin + i, k0 = kt * BK;
    hopper::mbar_wait(&full[stage], parity);
    __syncwarp();          // wgmma is .aligned: the warp must be converged

    // S = Q K^T (64 x BK per warpgroup), K-major operands; a k-step of
    // 16 bf16 is 32 bytes inside a 128-byte swizzle row
    const uint32_t k_addr = hopper::smem_addr(sK + stage * L::KV_BYTES);
    float s[BK / 2];
    hopper::fence_regs(s);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      const uint64_t da = desc_sw128(
          q_addr + (kk / 4) * BQ * 128 + off, 0, ATOM_ROWS_BYTES);
      const uint64_t db = desc_sw128(
          k_addr + (kk / 4) * BK * 128 + off, 0, ATOM_ROWS_BYTES);
      if constexpr (BK == 128)
        hopper::wgmma_m64n128k16_ss(s, da, db, kk > 0);
      else
        hopper::wgmma_m64n64k16_ss(s, da, db, kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);

    // online softmax, log2 domain.  s[4j + e]: row row0 (e < 2) or row1,
    // key k0 + 8 j + 2 quad + (e & 1).  A tile is masked where a key lies
    // past the block's first query (the diagonal: the last tile, and at
    // BK = 64 the one before it) or at the window's edge
    const bool masked = k0 + BK - 1 > q0 ||
                        (window > 0 && k0 <= q0 + BQ - 1 - window);
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale_log2;
        if (masked) {
          const int kp = k0 + 8 * j + 2 * quad + (e & 1);
          const int qp = e < 2 ? row0 : row1;
          const bool live = kp <= qp && (window <= 0 || kp > qp - window);
          x = live ? x : NEG_INF;
        }
        s[4 * j + e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[4 * j + e] - (e < 2 ? mn0 : mn1));
        s[4 * j + e] = p;
        if (e < 2) rs0 += p;
        else rs1 += p;
      }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int p = 0; p < NPART; ++p)
#pragma unroll
      for (int j = 0; j < NP / 4; ++j) {
        o_acc[p][4 * j] *= alpha0;
        o_acc[p][4 * j + 1] *= alpha0;
        o_acc[p][4 * j + 2] *= alpha1;
        o_acc[p][4 * j + 3] *= alpha1;
      }

    // P in bf16 as wgmma A fragments: keys 16 kk .. +15 are the
    // accumulator's column blocks 2 kk and 2 kk + 1
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // O += P V: V MN-major (hd contiguous), 16 keys = 2 x 8 rows of
    // 128 bytes per k-step; the next 64-column block of V lies BK * 128
    // bytes further (the descriptor's leading offset), and at hd = 256 the
    // second 128 columns (part 1) start two blocks on
    const uint32_t v_addr = hopper::smem_addr(sV + stage * L::KV_BYTES);
#pragma unroll
    for (int p = 0; p < NPART; ++p) hopper::fence_regs(o_acc[p]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int p = 0; p < NPART; ++p) {
        const uint64_t db = desc_sw128(
            v_addr + p * 2 * BK * 128 + kk * 16 * 128, BK * 128,
            ATOM_ROWS_BYTES);
        if constexpr (NP == 64)
          hopper::wgmma_m64n128k16_rs_tb(o_acc[p], pa[kk], db);
        else
          hopper::wgmma_m64n64k16_rs_tb(o_acc[p], pa[kk], db);
      }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < NPART; ++p) hopper::fence_regs(o_acc[p]);

    // release the stage: the warp that finishes it last refills it with
    // tile i + 2 (its wgmma reads are complete: wait_group 0 above)
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(&done[stage], 1) == THREADS / 32 - 1) {
        done[stage] = 0;
        __threadfence_block();
        if (i + 2 < n_tiles) load_kv(stage, kt + 2);
      }
    }
    __syncwarp();
  }

  // epilogue: reduce l over the row's 4 threads, normalise, store bf16
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-20f), inv1 = 1.f / fmaxf(l1, 1e-20f);
  const size_t q_stride = (size_t)H * HD;
  __nv_bfloat16* ob = o + (size_t)b * S * q_stride + (size_t)h * HD +
                      2 * quad;
#pragma unroll
  for (int p = 0; p < NPART; ++p)
#pragma unroll
    for (int j = 0; j < NP / 4; ++j) {
      const int col = p * 128 + 8 * j;
      if (row0 < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + row0 * q_stride + col) =
            __floats2bfloat162_rn(o_acc[p][4 * j] * inv0,
                                  o_acc[p][4 * j + 1] * inv0);
      if (row1 < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + row1 * q_stride + col) =
            __floats2bfloat162_rn(o_acc[p][4 * j + 2] * inv1,
                                  o_acc[p][4 * j + 3] * inv1);
    }
}

// ---- bf16 at hd 256 and 64: warp-specialised (flash_fwd_ws) ---------------

// Two consumer warpgroups, in one of two layouts:
//   hd 256 (rows): the warpgroups own query rows 0..63 and 64..127 of a
//   128-query block and walk every kv tile, taking turns on the tensor
//   cores; a producer warpgroup issues the copies and hands its registers
//   to them; 2-stage K and V rings.
//   hd 64 (split): both warpgroups own the block's 64 queries and split
//   its kv tiles, even and odd, each with its own m, l and O, merged at
//   the end; 4-stage rings, each warpgroup's tiles in two of the stages,
//   which it refills itself (one thread of it issues the copies); two
//   blocks an SM.
template <int HD>
struct Ws {
  static constexpr bool SPLIT = HD <= 64;
  static constexpr int BQ = SPLIT ? 64 : 128;
  static constexpr int STAGES = SPLIT ? 4 : 2;
  // keys per kv tile: 80 at hd 256 (224 KB of shared memory), where the
  // wider S reads fewer Q bytes a key; 64 at hd 64
  static constexpr int BK = SPLIT ? 64 : 80;
  static constexpr int CONSUMER_THREADS = 256;
  static constexpr int THREADS = CONSUMER_THREADS + (SPLIT ? 0 : 128);
  static constexpr int BLOCKS_PER_SM = SPLIT ? 2 : 1;
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;      // one stage of K or V
  // split: warpgroup 1's O (HD / 2 floats a thread), m and l (2 each)
  static constexpr int MERGE_BYTES = SPLIT ? 128 * (HD / 2 + 4) * 4 : 0;
  static constexpr int BARS = 1 + 4 * STAGES;       // q; full, empty x K, V
  static constexpr int BYTES = Q_BYTES + 2 * STAGES * KV_BYTES + MERGE_BYTES
                               + 8 * BARS + 1024;   // 1024-byte alignment
};

// rows, setmaxnreg: 128 x 24 + 256 x 240 = 64,512 of the 65,536 registers
// (the launch gives each of the 384 threads 168)
constexpr int WS_PRODUCER_REGS = 24, WS_CONSUMER_REGS = 240;

// 2^x in one MUFU.EX2 (exp2f adds a range check and two predicated
// multiplies for results below 2^-126, which this flushes to 0: a weight
// under 2^-126 moves no float32 sum of weights of order 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the descriptor of the address `bytes` past d's: the start address is its
// low 14 bits (16-byte units), and no tile reaches past 256 KB, so the add
// never carries out of them
__device__ __forceinline__ uint64_t desc_add(uint64_t d, uint32_t bytes) {
  return (d & 0xFFFFFFFF00000000ull) | (uint32_t)((uint32_t)d + (bytes >> 4));
}

template <int HD>
__global__ void __launch_bounds__(Ws<HD>::THREADS, Ws<HD>::BLOCKS_PER_SM)
flash_fwd_ws(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             __nv_bfloat16* __restrict__ o, int S, int H, int KH, int window,
             float scale_log2) {
  using L = Ws<HD>;
  constexpr bool SPLIT = L::SPLIT;
  constexpr int BK = L::BK, BQ = L::BQ, ST = L::STAGES;
  // O accumulator, HD / 2 floats a thread, as NPART wgmma accumulators of
  // at most 128 columns (NP floats) each
  constexpr int NPART = HD > 128 ? HD / 128 : 1;
  constexpr int NP = HD / 2 / NPART;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sK = sQ + L::Q_BYTES;         // ST stages
  uint8_t* sV = sK + ST * L::KV_BYTES;   // ST stages
  float* sMerge = reinterpret_cast<float*>(sV + ST * L::KV_BYTES);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(sMerge) + L::MERGE_BYTES);
  uint64_t* full_k = bar_q + 1;          // a stage's tile landed
  uint64_t* full_v = full_k + ST;
  uint64_t* empty_k = full_v + ST;       // its consumer warps are done
  uint64_t* empty_v = empty_k + ST;

  const int qi = gridDim.y - 1 - blockIdx.y;    // heaviest tiles first
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kh = h / (H / KH);
  const int q0 = qi * BQ;
  const int tid = threadIdx.x;
  // kv tiles from the window's first to the causal limit of the block's
  // last query below S (rows >= S are never stored)
  const int kt_end = (min(q0 + BQ, S) - 1) / BK;
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;
  const int n_tiles = kt_end - kt_begin + 1;

  if (tid == 0) {
    // a stage is released by the warps that read it: both warpgroups'
    // (rows) or one's (split)
    constexpr int READERS = SPLIT ? 4 : 8;
    hopper::mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full_k[s], 1);
      hopper::mbar_init(&full_v[s], 1);
      hopper::mbar_init(&empty_k[s], READERS);
      hopper::mbar_init(&empty_v[s], READERS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // K_i and V_i of the block's tile i into stage i % ST
  auto load_k = [&](int i) {
    const int st = i % ST;
    hopper::mbar_expect_tx(&full_k[st], L::KV_BYTES);
    load_tile<HD>(sK + st * L::KV_BYTES, &tm_k, &full_k[st], BK, kh,
                  (kt_begin + i) * BK, b);
  };
  auto load_v = [&](int i) {
    const int st = i % ST;
    hopper::mbar_expect_tx(&full_v[st], L::KV_BYTES);
    load_tile<HD>(sV + st * L::KV_BYTES, &tm_v, &full_v[st], BK, kh,
                  (kt_begin + i) * BK, b);
  };
  if constexpr (SPLIT) {
    // Q and the first ST tiles; each warpgroup refills its own stages
    if (tid == 0) {
      hopper::mbar_expect_tx(bar_q, L::Q_BYTES);
      load_tile<HD>(sQ, &tm_q, bar_q, BQ, h, q0, b);
      for (int i = 0; i < min(n_tiles, ST); ++i) {
        load_k(i);
        load_v(i);
      }
    }
  } else if (tid >= L::CONSUMER_THREADS) {
    // ---- producer: one thread issues every copy ----
    hopper::setmaxnreg_dec<WS_PRODUCER_REGS>();
    if (tid == L::CONSUMER_THREADS) {
      hopper::mbar_expect_tx(bar_q, L::Q_BYTES);
      load_tile<HD>(sQ, &tm_q, bar_q, BQ, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        // use i / ST of the stage waits for the consumers' release of use
        // i / ST - 1
        const uint32_t parity = (i / ST + 1) & 1;
        if (i >= ST) hopper::mbar_wait(&empty_k[i % ST], parity);
        load_k(i);
        if (i >= ST) hopper::mbar_wait(&empty_v[i % ST], parity);
        load_v(i);
      }
    }
    return;
  }

  // ---- consumers ----
  if constexpr (!SPLIT) hopper::setmaxnreg_inc<WS_CONSUMER_REGS>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const bool leader = (tid & 127) == 0;         // split: issues the refills
  const int lane = tid & 31, quad = lane & 3;
  const int qw0 = SPLIT ? q0 : q0 + 64 * wg;    // the warpgroup's first query
  const int row0 = qw0 + 16 * warp + (lane >> 2), row1 = row0 + 8;
  // the warpgroup's kv tiles: i0, i0 + STEP, ... below n_tiles
  constexpr int STEP = SPLIT ? 2 : 1;
  const int i0 = SPLIT ? wg : 0;

  // Rows: ping-pong.  Warpgroup w issues its wgmma only on named barrier
  // 1 + w, which the other warpgroup passes (arrives on) once it has
  // issued its own, so one warpgroup's softmax runs under the other's
  // products.  Warpgroup 0 goes first; each takes n_tiles + 1 turns, and
  // warpgroup 1 skips its last pass so that every arrival is waited for.
  auto turn_begin = [&]() {
    if constexpr (!SPLIT) hopper::named_sync(1 + wg, 256);
  };
  auto turn_end = [&](bool last) {
    if constexpr (!SPLIT)
      if (!(last && wg == 1)) hopper::named_arrive(2 - wg, 256);
  };
  if constexpr (!SPLIT)
    if (wg == 1) hopper::named_arrive(1, 256);

  float o_acc[NPART][NP];
#pragma unroll
  for (int p = 0; p < NPART; ++p)
#pragma unroll
    for (int i = 0; i < NP; ++i) o_acc[p][i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float s[BK / 2];              // one S tile (64 x BK) of the warpgroup
  uint32_t pa[BK / 16][4];      // P in bf16 as wgmma A fragments
  const uint32_t q_addr = hopper::smem_addr(sQ) + (SPLIT ? 0 : wg * 64 * 128);

  // S = Q K^T on stage st, K-major operands; a k-step of 16 bf16 is 32
  // bytes inside a 128-byte swizzle row
  const uint64_t dq = desc_sw128(q_addr, 0, ATOM_ROWS_BYTES);
  auto issue_s = [&](float (&acc)[BK / 2], int st) {
    const uint64_t dk = desc_sw128(
        hopper::smem_addr(sK + st * L::KV_BYTES), 0, ATOM_ROWS_BYTES);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      const uint64_t da = desc_add(dq, (kk / 4) * BQ * 128 + off);
      const uint64_t db = desc_add(dk, (kk / 4) * BK * 128 + off);
      if constexpr (BK == 80)
        hopper::wgmma_m64n80k16_ss(acc, da, db, kk > 0);
      else
        hopper::wgmma_m64n64k16_ss(acc, da, db, kk > 0);
    }
    hopper::wgmma_commit();
  };
  // O += P V on stage st: V MN-major (hd contiguous), 16 keys = 2 x 8 rows
  // of 128 bytes a k-step; the next 64-column block of V lies BK * 128
  // bytes further (the descriptor's leading offset), and at hd = 256 the
  // second 128 columns (part 1) start two blocks on
  auto issue_pv = [&](int st) {
    const uint64_t dv = desc_sw128(hopper::smem_addr(sV + st * L::KV_BYTES),
                                   BK * 128, ATOM_ROWS_BYTES);
#pragma unroll
    for (int p = 0; p < NPART; ++p) hopper::fence_regs(o_acc[p]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int p = 0; p < NPART; ++p) {
        const uint64_t db = desc_add(dv, p * 2 * BK * 128 + kk * 16 * 128);
        if constexpr (NP == 64)
          hopper::wgmma_m64n128k16_rs_tb(o_acc[p], pa[kk], db);
        else
          hopper::wgmma_m64n64k16_rs_tb(o_acc[p], pa[kk], db);
      }
    hopper::wgmma_commit();
  };
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(bar);
  };
  // online softmax of kv tile kt in x, log2 domain: x becomes the weights
  // against the new running max; returns the factors that rescale O.
  // x[4j + e]: row row0 (e < 2) or row1, key k0 + 8 j + 2 quad + (e & 1).
  // Masks only where a key lies past the warpgroup's first query (the
  // diagonal) or at the window's edge.  A tile with no masked key takes
  // the row max on the raw logits and scales it once (rounding is
  // monotonic, so it is the max of the scaled logits) and each weight as
  // 2^fma(s, scale, -m); a row's max is two chains (max is exact in any
  // order)
  auto softmax = [&](float (&x)[BK / 2], int kt, float& alpha0,
                     float& alpha1) {
    const int k0 = kt * BK;
    const bool masked = k0 + BK - 1 > qw0 ||
                        (window > 0 && k0 <= qw0 + 63 - window);
    float mx[4] = {NEG_INF, NEG_INF, NEG_INF, NEG_INF};
    if (masked) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float y = x[4 * j + e] * scale_log2;
          const int kp = k0 + 8 * j + 2 * quad + (e & 1);
          const int qp = e < 2 ? row0 : row1;
          const bool live = kp <= qp && (window <= 0 || kp > qp - window);
          y = live ? y : NEG_INF;
          x[4 * j + e] = y;
          mx[e] = fmaxf(mx[e], y);
        }
    } else {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e] = fmaxf(mx[e], x[4 * j + e]);
    }
    float mx0 = fmaxf(mx[0], mx[1]), mx1 = fmaxf(mx[2], mx[3]);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    if (!masked) {
      mx0 *= scale_log2;
      mx1 *= scale_log2;
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    alpha0 = ex2(m0 - mn0);
    alpha1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
    if (masked) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(x[4 * j + e] - (e < 2 ? mn0 : mn1));
          x[4 * j + e] = p;
          if (e < 2) rs0 += p;
          else rs1 += p;
        }
    } else {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(x[4 * j + e], scale_log2,
                                   -(e < 2 ? mn0 : mn1)));
          x[4 * j + e] = p;
          if (e < 2) rs0 += p;
          else rs1 += p;
        }
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
  };
  auto rescale = [&](float alpha0, float alpha1) {
#pragma unroll
    for (int p = 0; p < NPART; ++p)
#pragma unroll
      for (int j = 0; j < NP / 4; ++j) {
        o_acc[p][4 * j] *= alpha0;
        o_acc[p][4 * j + 1] *= alpha0;
        o_acc[p][4 * j + 2] *= alpha1;
        o_acc[p][4 * j + 3] *= alpha1;
      }
  };
  // P rounded to bf16 once: keys 16 kk .. +15 are the accumulator's column
  // blocks 2 kk and 2 kk + 1 (for 16-bit types the accumulator layout of S
  // is the A-fragment layout)
  auto pack_p = [&](const float (&x)[BK / 2]) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
      pa[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
      pa[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
      pa[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
    }
  };
  auto fence_o_p = [&]() {
#pragma unroll
    for (int p = 0; p < NPART; ++p) hopper::fence_regs(o_acc[p]);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) hopper::fence_regs(pa[kk]);
  };
  // split: once the warpgroup's four warps have released tile i's stage,
  // its leader loads tile i + ST there (the warpgroup's tile after next)
  auto refill = [&](uint64_t* empty, int i, auto load) {
    if constexpr (SPLIT) {
      if (leader && i + ST < n_tiles) {
        hopper::mbar_wait(&empty[i % ST], (i / ST) & 1);
        load(i + ST);
      }
      __syncwarp();
    }
  };
  auto wait_full = [&](uint64_t* full, int i) {
    hopper::mbar_wait(&full[i % ST], (i / ST) & 1);
    __syncwarp();          // wgmma is .aligned: the warp must be converged
  };

  hopper::mbar_wait(bar_q, 0);
  // (split: warpgroup 1 has no tile when the block has one)
  if (i0 < n_tiles) {
    float alpha0, alpha1;
    // the first tile: S alone
    wait_full(full_k, i0);
    turn_begin();
    issue_s(s, i0 % ST);
    turn_end(false);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    release(&empty_k[i0 % ST]);
    refill(empty_k, i0, load_k);
    softmax(s, kt_begin + i0, alpha0, alpha1);   // O is still 0
    pack_p(s);

    // tile i: S_i is issued with the previous tile's O += P V behind it;
    // S_i's softmax runs while P V is on the tensor cores, and O is
    // rescaled once P V has landed
    int i = i0 + STEP;
    for (; i < n_tiles; i += STEP) {
      const int prev = i - STEP;
      wait_full(full_k, i);
      wait_full(full_v, prev);
      turn_begin();
      issue_s(s, i % ST);
      issue_pv(prev % ST);
      turn_end(false);
      hopper::wgmma_wait<1>();           // S_i done, P V may still run
      hopper::fence_regs(s);
      release(&empty_k[i % ST]);
      refill(empty_k, i, load_k);
      softmax(s, kt_begin + i, alpha0, alpha1);
      hopper::wgmma_wait<0>();
      fence_o_p();
      release(&empty_v[prev % ST]);
      refill(empty_v, prev, load_v);
      rescale(alpha0, alpha1);
      pack_p(s);
    }

    // the last tile's P V
    wait_full(full_v, i - STEP);
    turn_begin();
    issue_pv((i - STEP) % ST);
    turn_end(true);
    hopper::wgmma_wait<0>();
    fence_o_p();
  }

  // epilogue: reduce l over the row's 4 threads
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if constexpr (SPLIT) {
    // warpgroup 1 hands its O, m and l to the thread of warpgroup 0 that
    // holds the same rows and columns, which merges the two:
    // m = max(m_0, m_1), O = O_0 2^(m_0 - m) + O_1 2^(m_1 - m), l alike
    float* mine = sMerge + (tid & 127);          // stride 128: no conflicts
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < NP; ++i) mine[128 * i] = o_acc[0][i];
      mine[128 * NP] = m0;
      mine[128 * (NP + 1)] = m1;
      mine[128 * (NP + 2)] = l0;
      mine[128 * (NP + 3)] = l1;
    }
    hopper::named_sync(1, 256);
    if (wg == 1) return;
    const float n0 = fmaxf(m0, mine[128 * NP]);
    const float n1 = fmaxf(m1, mine[128 * (NP + 1)]);
    const float a0 = ex2(m0 - n0), b0 = ex2(mine[128 * NP] - n0);
    const float a1 = ex2(m1 - n1), b1 = ex2(mine[128 * (NP + 1)] - n1);
    l0 = l0 * a0 + mine[128 * (NP + 2)] * b0;
    l1 = l1 * a1 + mine[128 * (NP + 3)] * b1;
#pragma unroll
    for (int j = 0; j < NP / 4; ++j) {
      o_acc[0][4 * j] = o_acc[0][4 * j] * a0 + mine[128 * (4 * j)] * b0;
      o_acc[0][4 * j + 1] =
          o_acc[0][4 * j + 1] * a0 + mine[128 * (4 * j + 1)] * b0;
      o_acc[0][4 * j + 2] =
          o_acc[0][4 * j + 2] * a1 + mine[128 * (4 * j + 2)] * b1;
      o_acc[0][4 * j + 3] =
          o_acc[0][4 * j + 3] * a1 + mine[128 * (4 * j + 3)] * b1;
    }
  }

  // normalise, store bf16 from registers (rows < S only)
  const float inv0 = 1.f / fmaxf(l0, 1e-20f), inv1 = 1.f / fmaxf(l1, 1e-20f);
  const size_t q_stride = (size_t)H * HD;
  __nv_bfloat16* ob = o + (size_t)b * S * q_stride + (size_t)h * HD +
                      2 * quad;
#pragma unroll
  for (int p = 0; p < NPART; ++p)
#pragma unroll
    for (int j = 0; j < NP / 4; ++j) {
      const int col = p * 128 + 8 * j;
      if (row0 < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + row0 * q_stride + col) =
            __floats2bfloat162_rn(o_acc[p][4 * j] * inv0,
                                  o_acc[p][4 * j + 1] * inv0);
      if (row1 < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + row1 * q_stride + col) =
            __floats2bfloat162_rn(o_acc[p][4 * j + 2] * inv1,
                                  o_acc[p][4 * j + 3] * inv1);
    }
}

// cuTensorMapEncodeTiled, a driver function, reached through the runtime
// so that the library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found =
        cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// a (B, S, heads, hd) bf16 tensor as a 4-D map (hd, heads, S, B), boxes of
// 64 x 1 x rows x 1 with 128-byte swizzle; reads past S are zero-filled
CUresult make_map(CUtensorMap* map, EncodeTiled encode, const void* base,
                  int B, int S, int heads, int hd, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)BOX, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// error codes past the runtime's: no driver entry point, or the driver's
// CUresult (added to the base) for a map it refused
constexpr int ERR_NO_ENCODE = 10000;

// how the bf16 kernel for head dim HD is launched: flash_fwd_wgmma at 128,
// the warp-specialised flash_fwd_ws at 256 and 64
struct Shape {
  void (*kernel)(CUtensorMap, CUtensorMap, CUtensorMap, __nv_bfloat16*, int,
                 int, int, int, float);
  int q_rows, kv_rows, threads, smem, blocks_per_sm;
};

template <int HD>
Shape shape_for() {
  if constexpr (HD == 128)
    return {flash_fwd_wgmma<HD>, BQ, Smem<HD>::BK, THREADS, Smem<HD>::BYTES,
            1};
  else
    return {flash_fwd_ws<HD>, Ws<HD>::BQ, Ws<HD>::BK, Ws<HD>::THREADS,
            Ws<HD>::BYTES, Ws<HD>::BLOCKS_PER_SM};
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KH, int window, float scale, cudaStream_t stream) {
  const Shape L = shape_for<HD>();
  const EncodeTiled encode = encode_tiled();
  if (!encode) return ERR_NO_ENCODE;
  // the maps hold this call's pointers, so they are built per call
  CUtensorMap tq, tk, tv;
  CUresult r = make_map(&tq, encode, q, B, S, H, HD, L.q_rows);
  if (r == CUDA_SUCCESS) r = make_map(&tk, encode, k, B, S, KH, HD, L.kv_rows);
  if (r == CUDA_SUCCESS) r = make_map(&tv, encode, v, B, S, KH, HD, L.kv_rows);
  if (r != CUDA_SUCCESS) return ERR_NO_ENCODE + (int)r;
  static bool configured[MAX_DEVICES];
  const cudaError_t err = configure_once((const void*)L.kernel, L.smem,
                                         L.blocks_per_sm > 1, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + L.q_rows - 1) / L.q_rows);
  L.kernel<<<grid, L.threads, L.smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, H, KH, window,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---- float32 at hd 64 and 128: 3xTF32 on wgmma (flash_fwd_3xtf32) --------

namespace f32tc {

using hopper::desc_sw128;
using tc::ATOM_ROWS_BYTES;

constexpr int BQ = 64;          // queries a block: one wgmma M
constexpr int THREADS = 256;    // warpgroup 0 computes, warpgroup 1 loads

// Shared memory: Q_hi and Q_lo, then a ring of STAGES stages of K_hi and
// K_lo, a ring of V^T_hi and V^T_lo, then the barriers.  Every tile is
// K-major with 128-byte swizzle in column blocks of 32 floats (one
// 128-byte row each): Q's rows are queries and K's keys (hd contiguous),
// V^T's rows are hd indices (keys contiguous, in P V's operand order, as
// VTrans stores them).  kv tiles are 64 keys; at hd 128 each ring has one
// stage (Q, K and V^T take 64 KB each), at hd 64 two.
constexpr int BK = 64;          // keys a kv tile: S's wgmma N
constexpr int PV_N = 32;        // columns of O a P V part: m64n32k8's N

template <int HD>
struct Tf32 {
  static constexpr int STAGES = HD == 128 ? 1 : 2;
  static constexpr int Q_BYTES = BQ * HD * 4;       // Q_hi or Q_lo
  static constexpr int KV_BYTES = BK * HD * 4;      // K_hi, K_lo, V^T_*
  static constexpr int BARS = 1 + 4 * STAGES;       // q; full, empty x K, V
  static constexpr int BYTES = 2 * Q_BYTES + 4 * STAGES * KV_BYTES +
                               8 * BARS + 1024;     // 1024-byte alignment
  static_assert(BYTES <= 232448, "more than a block's shared memory");
};

// the byte offset of 16-byte chunk `chunk` (0..7) of row r in a K-major
// tile whose column blocks hold `rows` rows of 128 bytes (block `blk` at
// blk * rows * 128); the 128-byte swizzle XORs the chunk with r % 8, as
// TMA's SWIZZLE_128B writes and the wgmma descriptor (layout 1) reads
__device__ __forceinline__ uint32_t sw128(int rows, int blk, int r,
                                          int chunk) {
  return (uint32_t)(blk * rows * 128 + r * 128 + ((chunk ^ (r & 7)) << 4));
}

__device__ __forceinline__ void split4(const float4 x, float4& hi,
                                       float4& lo) {
  uint32_t h, l;
  hopper::split_tf32(x.x, h, l);
  hi.x = __uint_as_float(h);
  lo.x = __uint_as_float(l);
  hopper::split_tf32(x.y, h, l);
  hi.y = __uint_as_float(h);
  lo.y = __uint_as_float(l);
  hopper::split_tf32(x.z, h, l);
  hi.z = __uint_as_float(h);
  lo.z = __uint_as_float(l);
  hopper::split_tf32(x.w, h, l);
  hi.w = __uint_as_float(h);
  lo.w = __uint_as_float(l);
}

__device__ __forceinline__ void st4(uint8_t* base, uint32_t off, float4 x) {
  *reinterpret_cast<float4*>(base + off) = x;
}

// R rows x HD floats of a K-major tile (row r at src + r * stride),
// fetched into registers, then split and stored as hi and lo: float4
// number it of the tile is row it / (HD / 4), so a warp's loads read whole
// rows and each quarter-warp's 16-byte stores fill the eight chunks of one
// swizzled row
template <int R, int HD>
struct KMajor {
  static constexpr int C4 = HD / 4, N = R * C4 / 128;
  float4 x[N];

  __device__ __forceinline__ void fetch(const float* __restrict__ src,
                                        size_t stride, int pt) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int it = pt + 128 * n;
      x[n] = __ldg(reinterpret_cast<const float4*>(
          src + (size_t)(it / C4) * stride + 4 * (it % C4)));
    }
  }

  __device__ __forceinline__ void put(uint8_t* hi, uint8_t* lo, int pt) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int it = pt + 128 * n, r = it / C4, c4 = it % C4;
      float4 h, l;
      split4(x[n], h, l);
      const uint32_t off = sw128(R, c4 / 8, r, c4 % 8);
      st4(hi, off, h);
      st4(lo, off, l);
    }
  }
};

// P V's operand order.  P is wgmma's A from registers, made from S's
// accumulator without a shuffle: a thread holds S's columns 8 j + 2 t and
// + 1 (t = lane % 4) of its rows, and A's fragment wants columns t and t +
// 4 of each 8-deep step, so A's k-slot t of step j is key 8 j + 2 t and
// slot t + 4 is key 8 j + 2 t + 1.  V^T stores its keys in that order:
// slot 8 j + 4 par + i holds key 8 j + 2 i + par.  The producer moves V in
// "key quads": quad kq (0 .. BK / 4 - 1) is keys 8 (kq / 2) + 2 i + kq % 2,
// i = 0..3, which land in slots 4 kq .. 4 kq + 3 of every row: chunk kq % 8
// of column block kq / 8.
template <int BK, int HD>
struct VTrans {
  static constexpr int C4 = HD / 4, N = (BK / 4) * C4 / 128;
  float4 x[N][4];

  // item it: quad it % 8 + 8 (it / 8 / C4), hd chunk it / 8 % C4; a
  // quarter-warp's eight lanes take eight quads of one hd chunk, so their
  // 16-byte stores hit eight distinct chunks of each row
  __device__ __forceinline__ static int quad(int it) {
    return it % 8 + 8 * (it / 8 / C4);
  }
  __device__ __forceinline__ static int col(int it) {
    return 4 * (it / 8 % C4);
  }

  __device__ __forceinline__ void fetch(const float* __restrict__ src,
                                        size_t stride, int pt) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int it = pt + 128 * n, kq = quad(it);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[n][i] = __ldg(reinterpret_cast<const float4*>(
            src + (size_t)(8 * (kq / 2) + 2 * i + kq % 2) * stride +
            col(it)));
    }
  }

  // row d0 + e of V^T takes element e of the quad's four keys
  __device__ __forceinline__ void put(uint8_t* hi, uint8_t* lo, int pt) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int it = pt + 128 * n, kq = quad(it), d0 = col(it);
      float4 h[4], l[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split4(x[n][i], h[i], l[i]);
      uint32_t off = sw128(HD, kq / 8, d0, kq % 8);
      st4(hi, off, make_float4(h[0].x, h[1].x, h[2].x, h[3].x));
      st4(lo, off, make_float4(l[0].x, l[1].x, l[2].x, l[3].x));
      off = sw128(HD, kq / 8, d0 + 1, kq % 8);
      st4(hi, off, make_float4(h[0].y, h[1].y, h[2].y, h[3].y));
      st4(lo, off, make_float4(l[0].y, l[1].y, l[2].y, l[3].y));
      off = sw128(HD, kq / 8, d0 + 2, kq % 8);
      st4(hi, off, make_float4(h[0].z, h[1].z, h[2].z, h[3].z));
      st4(lo, off, make_float4(l[0].z, l[1].z, l[2].z, l[3].z));
      off = sw128(HD, kq / 8, d0 + 3, kq % 8);
      st4(hi, off, make_float4(h[0].w, h[1].w, h[2].w, h[3].w));
      st4(lo, off, make_float4(l[0].w, l[1].w, l[2].w, l[3].w));
    }
  }
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_3xtf32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int H, int KH, int window, float scale_log2) {
  using L = Tf32<HD>;
  constexpr int ST = L::STAGES;
  constexpr int NP = HD / PV_N;         // P V in parts of PV_N columns
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQh = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQl = sQh + L::Q_BYTES;
  uint8_t* sK = sQl + L::Q_BYTES;       // stage st: hi, lo at 2 st KV_BYTES
  uint8_t* sV = sK + 2 * ST * L::KV_BYTES;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sV + 2 * ST * L::KV_BYTES);
  uint64_t* full_k = bar_q + 1;         // a stage's tiles are stored
  uint64_t* full_v = full_k + ST;
  uint64_t* empty_k = full_v + ST;      // its products are done
  uint64_t* empty_v = empty_k + ST;

  const int qi = gridDim.y - 1 - blockIdx.y;    // heaviest tiles first
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kh = h / (H / KH);
  const int q0 = qi * BQ;
  const int tid = threadIdx.x;
  const size_t q_stride = (size_t)H * HD, kv_stride = (size_t)KH * HD;
  const int kt_end = (q0 + BQ - 1) / BK;        // causal limit, inclusive
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;
  const int n_tiles = kt_end - kt_begin + 1;

  if (tid == 0) {
    hopper::mbar_init(bar_q, 128);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full_k[s], 128);       // every producer thread
      hopper::mbar_init(&full_v[s], 128);
      hopper::mbar_init(&empty_k[s], 4);        // every consumer warp
      hopper::mbar_init(&empty_v[s], 4);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128) {
    // ---- producer: load, split (and transpose V), store ----
    const int pt = tid - 128;
    {
      KMajor<BQ, HD> qt;
      qt.fetch(q + ((size_t)b * S + q0) * q_stride + (size_t)h * HD,
               q_stride, pt);
      qt.put(sQh, sQl, pt);
    }
    hopper::fence_proxy_async_shared();
    hopper::mbar_arrive(bar_q);
    const float* kb = k + (size_t)b * S * kv_stride + (size_t)kh * HD;
    const float* vb = v + (size_t)b * S * kv_stride + (size_t)kh * HD;
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % ST;
      const size_t k0 = (size_t)(kt_begin + i) * BK;
      // use i / ST of a stage waits for the consumers' release of use
      // i / ST - 1, with the tile's loads already in flight: K_i once
      // S_{i - ST} is done, V_i once P_{i - ST} V_{i - ST} is
      {
        KMajor<BK, HD> kt;
        kt.fetch(kb + k0 * kv_stride, kv_stride, pt);
        if (i >= ST) hopper::mbar_wait(&empty_k[st], (i / ST + 1) & 1);
        kt.put(sK + 2 * st * L::KV_BYTES, sK + (2 * st + 1) * L::KV_BYTES,
               pt);
        hopper::fence_proxy_async_shared();
        hopper::mbar_arrive(&full_k[st]);
      }
      {
        VTrans<BK, HD> vt;
        vt.fetch(vb + k0 * kv_stride, kv_stride, pt);
        if (i >= ST) hopper::mbar_wait(&empty_v[st], (i / ST + 1) & 1);
        vt.put(sV + 2 * st * L::KV_BYTES, sV + (2 * st + 1) * L::KV_BYTES,
               pt);
        hopper::fence_proxy_async_shared();
        hopper::mbar_arrive(&full_v[st]);
      }
    }
    return;
  }

  // ---- consumer warpgroup: 64 query rows ----
  const int warp = tid >> 5, lane = tid & 31, quad = lane & 3;
  const int row0 = q0 + 16 * warp + (lane >> 2), row1 = row0 + 8;
  float o_acc[NP][PV_N / 2];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < PV_N / 2; ++i) o_acc[p][i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const uint64_t dqh = desc_sw128(hopper::smem_addr(sQh), 0,
                                  ATOM_ROWS_BYTES);
  const uint64_t dql = desc_sw128(hopper::smem_addr(sQl), 0,
                                  ATOM_ROWS_BYTES);
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(bar);
  };
  hopper::mbar_wait(bar_q, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % ST, k0 = (kt_begin + i) * BK;
    const uint32_t parity = (i / ST) & 1;
    const uint64_t dkh = desc_sw128(
        hopper::smem_addr(sK + 2 * st * L::KV_BYTES), 0, ATOM_ROWS_BYTES);
    const uint64_t dkl = tc::desc_add(dkh, L::KV_BYTES);
    hopper::mbar_wait(&full_k[st], parity);
    __syncwarp();          // wgmma is .aligned: the warp must be converged

    // S = Q_hi K_hi^T into one fragment, Q_lo K_hi^T + Q_hi K_lo^T into
    // another, each from zero; a k-step of 8 floats is 32 bytes inside a
    // 128-byte swizzle row
    float shh[BK / 2], ssm[BK / 2];
    hopper::fence_regs(shh);
    hopper::fence_regs(ssm);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const uint32_t qo = (kk / 4) * BQ * 128 + (kk % 4) * 32;
      const uint32_t ko = (kk / 4) * BK * 128 + (kk % 4) * 32;
      hopper::wgmma_m64n64k8_tf32_ss(shh, tc::desc_add(dqh, qo),
                                     tc::desc_add(dkh, ko), kk > 0);
      hopper::wgmma_m64n64k8_tf32_ss(ssm, tc::desc_add(dql, qo),
                                     tc::desc_add(dkh, ko), kk > 0);
      hopper::wgmma_m64n64k8_tf32_ss(ssm, tc::desc_add(dqh, qo),
                                     tc::desc_add(dkl, ko), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(shh);
    hopper::fence_regs(ssm);
    release(&empty_k[st]);         // K_{i + ST} may land under the rest

    // online softmax, log2 domain, in IEEE float32: s = hh + sm.
    // shh[4j + e]: row row0 (e < 2) or row1, key k0 + 8 j + 2 quad +
    // (e & 1).  Masks only where a key lies past the block's first query
    // or at the window's edge.
    const bool masked = k0 + BK - 1 > q0 ||
                        (window > 0 && k0 <= q0 + BQ - 1 - window);
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = (shh[4 * j + e] + ssm[4 * j + e]) * scale_log2;
        if (masked) {
          const int kp = k0 + 8 * j + 2 * quad + (e & 1);
          const int qp = e < 2 ? row0 : row1;
          const bool live = kp <= qp && (window <= 0 || kp > qp - window);
          x = live ? x : NEG_INF;
        }
        shh[4 * j + e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
    // P split into TF32 hi and lo as A fragments (VTrans' order):
    // slots t and t + 4 of step j are columns 8 j + 2 t and + 1, rows
    // row0 (a[0], a[2]) and row1 (a[1], a[3])
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(shh[4 * j + e] - (e < 2 ? mn0 : mn1));
        if (e < 2) rs0 += p[e];
        else rs1 += p[e];
      }
      hopper::split_tf32(p[0], ph[j][0], pl[j][0]);
      hopper::split_tf32(p[2], ph[j][1], pl[j][1]);
      hopper::split_tf32(p[1], ph[j][2], pl[j][2]);
      hopper::split_tf32(p[3], ph[j][3], pl[j][3]);
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;

    // (P V)_tile = P_hi V_hi + (P_lo V_hi + P_hi V_lo), each from zero, in
    // PV_N-column parts of O; O = alpha O + (hh + sm) by IEEE FMAs
    const uint64_t dvh = desc_sw128(
        hopper::smem_addr(sV + 2 * st * L::KV_BYTES), 0, ATOM_ROWS_BYTES);
    const uint64_t dvl = tc::desc_add(dvh, L::KV_BYTES);
    hopper::mbar_wait(&full_v[st], parity);
    __syncwarp();
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      float hh[PV_N / 2], sm[PV_N / 2];
      hopper::fence_regs(hh);
      hopper::fence_regs(sm);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const uint32_t vo = (kk / 4) * HD * 128 + p * PV_N * 128 +
                            (kk % 4) * 32;
        hopper::wgmma_m64n32k8_tf32_rs(hh, ph[kk], tc::desc_add(dvh, vo),
                                       kk > 0);
        hopper::wgmma_m64n32k8_tf32_rs(sm, pl[kk], tc::desc_add(dvh, vo),
                                       kk > 0);
        hopper::wgmma_m64n32k8_tf32_rs(sm, ph[kk], tc::desc_add(dvl, vo),
                                       1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(hh);
      hopper::fence_regs(sm);
#pragma unroll
      for (int e = 0; e < PV_N / 2; ++e)
        o_acc[p][e] = fmaf((e & 2) ? alpha1 : alpha0, o_acc[p][e],
                           hh[e] + sm[e]);
    }
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      hopper::fence_regs(ph[kk]);
      hopper::fence_regs(pl[kk]);
    }
    release(&empty_v[st]);
  }

  // epilogue: reduce l over the row's 4 threads, normalise, store
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-20f), inv1 = 1.f / fmaxf(l1, 1e-20f);
  float* ob = o + (size_t)b * S * q_stride + (size_t)h * HD + 2 * quad;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < PV_N / 8; ++j) {
      const int col = p * PV_N + 8 * j;
      *reinterpret_cast<float2*>(ob + (size_t)row0 * q_stride + col) =
          make_float2(o_acc[p][4 * j] * inv0, o_acc[p][4 * j + 1] * inv0);
      *reinterpret_cast<float2*>(ob + (size_t)row1 * q_stride + col) =
          make_float2(o_acc[p][4 * j + 2] * inv1, o_acc[p][4 * j + 3] * inv1);
    }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KH, int window, float scale, cudaStream_t stream) {
  constexpr int smem = Tf32<HD>::BYTES;
  auto kernel = flash_fwd_3xtf32<HD>;
  static bool configured[MAX_DEVICES];
  const cudaError_t err =
      configure_once((const void*)kernel, smem, false, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, S / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, KH, window,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// ---- float32 at hd 256: 3xTF32 on wgmma, hd in 32-column pieces ----------

// Shared memory: Q_hi and Q_lo whole (64 KB each), P_lo (16 KB), then one
// ring of Pieces::STAGES stages, each a piece's hi and lo (8 KB each), then
// the barriers.  A piece is 64 keys x 32 hd of K (K-major, rows keys: one
// column block) or 32 hd x 64 keys of V^T (rows hd, keys in VTrans' order:
// two column blocks); a kv tile is K's eight pieces (hd 0..31, ..,
// 224..255) and then V^T's eight.  Q is eight K pieces side by side, and
// P_lo is 64 queries x 64 keys in V^T's key order (two column blocks).
struct Pieces {
  static constexpr int HD = 256, PD = 32, NC = HD / PD;
  static constexpr int STAGES = 5;
  static constexpr int Q_BYTES = BQ * HD * 4;         // Q_hi or Q_lo
  static constexpr int P_BYTES = BQ * BK * 4;         // P_lo
  static constexpr int PIECE = BK * PD * 4;           // a piece's hi or lo
  static constexpr int BARS = 1 + 2 * STAGES;         // q; full, empty
  static constexpr int BYTES = 2 * Q_BYTES + P_BYTES + 2 * STAGES * PIECE +
                               8 * BARS + 1024;       // 1024-byte alignment
  static_assert(BQ * PD * 4 == PIECE, "a Q piece is a K piece");
  static_assert(BYTES <= 232448, "more than a block's shared memory");
};

// a piece's index in its kv tile, as a type, so that the producer picks
// each piece's fragments at compile time
template <int J>
using PieceIx = std::integral_constant<int, J>;

// f(PieceIx<0>{}), .., f(PieceIx<N - 1>{})
template <class F, int... J>
__device__ __forceinline__ void each_piece(F&& f,
                                           std::integer_sequence<int, J...>) {
  (f(PieceIx<J>{}), ...);
}

__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_3xtf32_pieces(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        int S, int H, int KH, int window, float scale_log2) {
  using L = Pieces;
  constexpr int HD = L::HD, PD = L::PD, NC = L::NC, ST = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQh = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQl = sQh + L::Q_BYTES;
  uint8_t* sP = sQl + L::Q_BYTES;       // P_lo
  uint8_t* sR = sP + L::P_BYTES;        // stage st: hi, lo at 2 st PIECE
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sR + 2 * ST * L::PIECE);
  uint64_t* full = bar_q + 1;           // a stage's piece is stored
  uint64_t* empty = full + ST;          // its products are done

  const int qi = gridDim.y - 1 - blockIdx.y;    // heaviest tiles first
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kh = h / (H / KH);
  const int q0 = qi * BQ;
  const int tid = threadIdx.x;
  const size_t q_stride = (size_t)H * HD, kv_stride = (size_t)KH * HD;
  const int kt_end = (q0 + BQ - 1) / BK;        // causal limit, inclusive
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;
  const int n_tiles = kt_end - kt_begin + 1;

  if (tid == 0) {
    hopper::mbar_init(bar_q, 128);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 128);         // every producer thread
      hopper::mbar_init(&empty[s], 128);        // every consumer thread
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128) {
    // ---- producer: load, split (and transpose V), store, piece by piece
    const int pt = tid - 128;
    const float* qb = q + ((size_t)b * S + q0) * q_stride + (size_t)h * HD;
    const float* kb = k + (size_t)b * S * kv_stride + (size_t)kh * HD;
    const float* vb = v + (size_t)b * S * kv_stride + (size_t)kh * HD;
    // Each piece's loads are issued one piece before it is stored (while
    // the producer waits for a stage and stores the piece before), into
    // fragments named by the piece's kind and parity, chosen at compile
    // time: K's even pieces in k0, odd ones in k1, V^T's likewise in v0
    // and v1 (Q's in qa and qc).  Indexed arrays of fragments went to
    // local memory.
    {
      KMajor<BQ, PD> qa, qc;
      qa.fetch(qb, q_stride, pt);
#pragma unroll
      for (int c = 0; c < NC; c += 2) {
        qc.fetch(qb + (c + 1) * PD, q_stride, pt);
        qa.put(sQh + c * L::PIECE, sQl + c * L::PIECE, pt);
        if (c + 2 < NC) qa.fetch(qb + (c + 2) * PD, q_stride, pt);
        qc.put(sQh + (c + 1) * L::PIECE, sQl + (c + 1) * L::PIECE, pt);
      }
    }
    hopper::fence_proxy_async_shared();
    hopper::mbar_arrive(bar_q);
    KMajor<BK, PD> k0, k1;
    VTrans<BK, PD> v0, v1;
    // piece j of tile i: K's eight (hd 0..31, .., 224..255), then V^T's
    const auto src = [&](int i, int j) {
      return (j < NC ? kb : vb) + (size_t)(kt_begin + i) * BK * kv_stride +
             (j % NC) * PD;
    };
    const auto fetch = [&](auto jc, int i) {
      constexpr int j = decltype(jc)::value;
      if constexpr (j < NC && j % 2 == 0) k0.fetch(src(i, j), kv_stride, pt);
      else if constexpr (j < NC) k1.fetch(src(i, j), kv_stride, pt);
      else if constexpr (j % 2 == 0) v0.fetch(src(i, j), kv_stride, pt);
      else v1.fetch(src(i, j), kv_stride, pt);
    };
    // piece g = 2 NC i + j of the block's walk sits in stage g % ST; its
    // use g / ST waits for the consumers' release of use g / ST - 1
    const auto step = [&](auto jc, int i) {
      constexpr int j = decltype(jc)::value, jn = (j + 1) % (2 * NC);
      const int in = i + (j + 1) / (2 * NC), g = 2 * NC * i + j;
      if (in < n_tiles) fetch(PieceIx<jn>{}, in);
      const int st = g % ST;
      uint8_t* hi = sR + 2 * st * L::PIECE;
      if (g >= ST) hopper::mbar_wait(&empty[st], (g / ST + 1) & 1);
      if constexpr (j < NC && j % 2 == 0) k0.put(hi, hi + L::PIECE, pt);
      else if constexpr (j < NC) k1.put(hi, hi + L::PIECE, pt);
      else if constexpr (j % 2 == 0) v0.put(hi, hi + L::PIECE, pt);
      else v1.put(hi, hi + L::PIECE, pt);
      hopper::fence_proxy_async_shared();
      hopper::mbar_arrive(&full[st]);
    };
    fetch(PieceIx<0>{}, 0);
    for (int i = 0; i < n_tiles; ++i)
      each_piece([&](auto jc) { step(jc, i); },
                 std::make_integer_sequence<int, 2 * NC>{});
    return;
  }

  // ---- consumer warpgroup: 64 query rows ----
  const int warp = tid >> 5, lane = tid & 31, quad = lane & 3;
  const int r0 = 16 * warp + (lane >> 2);       // rows r0 and r0 + 8
  const int row0 = q0 + r0, row1 = row0 + 8;
  float o_acc[NC][PD / 2];              // P V's part c: O's columns of piece c
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < PD / 2; ++i) o_acc[c][i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  // one descriptor, Q_hi's, is live across the walk: Q_lo's, P_lo's and
  // the ring's are offsets from it, formed at their use
  const uint64_t dq = desc_sw128(hopper::smem_addr(sQh), 0,
                                 ATOM_ROWS_BYTES);
  const auto ring = [&](int g) {
    return tc::desc_add(dq, 2 * L::Q_BYTES + L::P_BYTES +
                                2 * (g % ST) * L::PIECE);
  };
  // every consumer thread arrives (no branch on the lane: a divergent path
  // between a wgmma and its wait makes ptxas serialize every wgmma, C7520)
  auto release = [&](int g) { hopper::mbar_arrive(&empty[g % ST]); };
  // the stage's piece is stored; then wgmma.fence, so that ptxas inserts
  // none of its own after the (divergent) wait loop
  auto wait_full = [&](int g) {
    hopper::mbar_wait(&full[g % ST], (g / ST) & 1);
    __syncwarp();          // wgmma is .aligned: the warp must be converged
    hopper::wgmma_fence();
  };
  hopper::mbar_wait(bar_q, 0);

  int g = 0;                            // the tile's first piece
  for (int i = 0; i < n_tiles; ++i, g += 2 * NC) {
    const int k0 = (kt_begin + i) * BK;

    // S = Q_hi K_hi^T into one fragment, Q_lo K_hi^T + Q_hi K_lo^T into
    // another, each from zero, over K's eight pieces in one chain (the 32
    // 8-deep steps in hd order); piece c's products are a commit group,
    // and its stage is released once the next piece's are issued and its
    // own are done
    float shh[BK / 2], ssm[BK / 2];
    hopper::fence_regs(shh);
    hopper::fence_regs(ssm);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      wait_full(g + c);
      const uint64_t dqh = dq, dql = tc::desc_add(dqh, L::Q_BYTES);
      const uint64_t dkh = ring(g + c), dkl = tc::desc_add(dkh, L::PIECE);
#pragma unroll
      for (int kk = 0; kk < PD / 8; ++kk) {
        const uint32_t qo = c * L::PIECE + kk * 32, ko = kk * 32;
        const int acc = c > 0 || kk > 0;
        hopper::wgmma_m64n64k8_tf32_ss(shh, tc::desc_add(dqh, qo),
                                       tc::desc_add(dkh, ko), acc);
        hopper::wgmma_m64n64k8_tf32_ss(ssm, tc::desc_add(dql, qo),
                                       tc::desc_add(dkh, ko), acc);
        hopper::wgmma_m64n64k8_tf32_ss(ssm, tc::desc_add(dqh, qo),
                                       tc::desc_add(dkl, ko), 1);
      }
      hopper::wgmma_commit();
      if (c > 0) {
        hopper::wgmma_wait<1>();
        release(g + c - 1);
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(shh);
    hopper::fence_regs(ssm);
    release(g + NC - 1);

    // online softmax, log2 domain, in IEEE float32 (flash_fwd_3xtf32's)
    const bool masked = k0 + BK - 1 > q0 ||
                        (window > 0 && k0 <= q0 + BQ - 1 - window);
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = (shh[4 * j + e] + ssm[4 * j + e]) * scale_log2;
        if (masked) {
          const int kp = k0 + 8 * j + 2 * quad + (e & 1);
          const int qp = e < 2 ? row0 : row1;
          const bool live = kp <= qp && (window <= 0 || kp > qp - window);
          x = live ? x : NEG_INF;
        }
        shh[4 * j + e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // P split into TF32 hi and lo: P_hi as A fragments in registers
    // (flash_fwd_3xtf32's), P_lo stored to shared memory in the same key
    // order (slot t of step j in chunk 2 (j % 4), slot t + 4 in the next),
    // for P V's one product that reads it.  Keeping P_lo in registers too
    // left the consumer short of registers (256 with O's 128) and ptxas
    // spilled.
    float rs0 = 0.f, rs1 = 0.f;
    uint32_t ph[BK / 8][4];
    const auto put_lo = [&](int j, int r, int half, uint32_t lo) {
      *reinterpret_cast<uint32_t*>(
          sP + sw128(BQ, j / 4, r, 2 * (j % 4) + half) + 4 * quad) = lo;
    };
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(shh[4 * j + e] - (e < 2 ? mn0 : mn1));
        if (e < 2) rs0 += p[e];
        else rs1 += p[e];
      }
      uint32_t lo;
      hopper::split_tf32(p[0], ph[j][0], lo);
      put_lo(j, r0, 0, lo);
      hopper::split_tf32(p[2], ph[j][1], lo);
      put_lo(j, r0 + 8, 0, lo);
      hopper::split_tf32(p[1], ph[j][2], lo);
      put_lo(j, r0, 1, lo);
      hopper::split_tf32(p[3], ph[j][3], lo);
      put_lo(j, r0 + 8, 1, lo);
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
    // P_lo visible to wgmma, from all four warps.  It is rewritten only
    // after the next tile's S, which no warp finishes before every warp
    // has issued it, past its wait for this tile's P V.
    hopper::fence_proxy_async_shared();
    hopper::named_sync(1, 128);

    // (P V)_tile over V^T's eight pieces, a part of 32 columns of O each:
    // P_hi V_hi + (P_lo V_hi + P_hi V_lo), each from zero; O = alpha O +
    // (hh + sm) by IEEE FMAs
    const uint64_t dp = tc::desc_add(dq, 2 * L::Q_BYTES);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      wait_full(g + NC + c);
      const uint64_t dvh = ring(g + NC + c), dvl = tc::desc_add(dvh, L::PIECE);
      float hh[PD / 2], sm[PD / 2];
      hopper::fence_regs(hh);
      hopper::fence_regs(sm);
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const uint32_t vo = (kk / 4) * PD * 128 + (kk % 4) * 32;
        const uint32_t po = (kk / 4) * BQ * 128 + (kk % 4) * 32;
        const uint64_t bh = tc::desc_add(dvh, vo);
        hopper::wgmma_m64n32k8_tf32_rs(hh, ph[kk], bh, kk > 0);
        hopper::wgmma_m64n32k8_tf32_ss(sm, tc::desc_add(dp, po), bh, kk > 0);
        hopper::wgmma_m64n32k8_tf32_rs(sm, ph[kk], tc::desc_add(dvl, vo), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(hh);
      hopper::fence_regs(sm);
      release(g + NC + c);
#pragma unroll
      for (int e = 0; e < PD / 2; ++e)
        o_acc[c][e] = fmaf((e & 2) ? alpha1 : alpha0, o_acc[c][e],
                           hh[e] + sm[e]);
    }
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) hopper::fence_regs(ph[kk]);
  }

  // epilogue: reduce l over the row's 4 threads, normalise, store
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-20f), inv1 = 1.f / fmaxf(l1, 1e-20f);
  float* ob = o + (size_t)b * S * q_stride + (size_t)h * HD + 2 * quad;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < PD / 8; ++j) {
      const int col = c * PD + 8 * j;
      *reinterpret_cast<float2*>(ob + (size_t)row0 * q_stride + col) =
          make_float2(o_acc[c][4 * j] * inv0, o_acc[c][4 * j + 1] * inv0);
      *reinterpret_cast<float2*>(ob + (size_t)row1 * q_stride + col) =
          make_float2(o_acc[c][4 * j + 2] * inv1, o_acc[c][4 * j + 3] * inv1);
    }
}

int launch_pieces(const void* q, const void* k, const void* v, void* o,
                  int B, int S, int H, int KH, int window, float scale,
                  cudaStream_t stream) {
  constexpr int smem = Pieces::BYTES;
  static bool configured[MAX_DEVICES];
  const cudaError_t err = configure_once((const void*)flash_fwd_3xtf32_pieces,
                                         smem, false, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, S / BQ);
  flash_fwd_3xtf32_pieces<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, KH, window,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace f32tc

}  // namespace

// q, o (B, S, H, hd) and k, v (B, S, KH, hd), contiguous and 16-byte
// aligned, all float32 (is_bf16 = 0: the 3xTF32 wgmma kernels) or all
// bfloat16 (is_bf16 = 1, the wgmma kernels); hd in {64, 128, 256}, S % 64
// == 0, KH | H;
// window <= 0 means none; scale multiplies q . k.  Returns 1
// (cudaErrorInvalidValue) for a shape outside that contract, 10000 when the
// driver has no cuTensorMapEncodeTiled and 10000 + its CUresult when it
// refuses a tensor map, else cudaGetLastError() after the launch.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int S,
                                     int H, int KH, int hd, int window,
                                     int is_bf16, float scale,
                                     cudaStream_t stream) {
  if (S <= 0 || S % f32tc::BQ || KH <= 0 || H % KH || B <= 0) return 1;
  if (hd == 256)
    return is_bf16 ? tc::launch<256>(q, k, v, o, B, S, H, KH, window, scale,
                                     stream)
                   : f32tc::launch_pieces(q, k, v, o, B, S, H, KH, window,
                                          scale, stream);
  if (hd == 128)
    return is_bf16 ? tc::launch<128>(q, k, v, o, B, S, H, KH, window, scale,
                                     stream)
                   : f32tc::launch<128>(q, k, v, o, B, S, H, KH, window,
                                        scale, stream);
  if (hd == 64)
    return is_bf16 ? tc::launch<64>(q, k, v, o, B, S, H, KH, window, scale,
                                    stream)
                   : f32tc::launch<64>(q, k, v, o, B, S, H, KH, window,
                                       scale, stream);
  return 1;
}

// The kernel that repro_flash_attention runs for (hd, is_bf16): registers
// and local memory bytes (spills included) a thread, as
// cudaFuncGetAttributes reports them, and the blocks an SM holds at its
// launch shape (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into
// out[0..2]; 1 for an hd outside the contract.
extern "C" int repro_flash_attention_attrs(int hd, int is_bf16, int* out) {
  const void* fn = nullptr;
  // the float32 kernels all run 256 threads
  int threads = f32tc::THREADS, smem = 0;
  bool max_carveout = false;
  auto bf16 = [&](tc::Shape s) {
    fn = (const void*)s.kernel;
    threads = s.threads;
    smem = s.smem;
    max_carveout = s.blocks_per_sm > 1;
  };
  auto f32 = [&](const void* kernel, int bytes) {
    fn = kernel;
    smem = bytes;
  };
  if (hd == 256) {
    if (is_bf16) bf16(tc::shape_for<256>());
    else f32((const void*)f32tc::flash_fwd_3xtf32_pieces,
             f32tc::Pieces::BYTES);
  } else if (hd == 128) {
    if (is_bf16) bf16(tc::shape_for<128>());
    else f32((const void*)f32tc::flash_fwd_3xtf32<128>,
             f32tc::Tf32<128>::BYTES);
  } else if (hd == 64) {
    if (is_bf16) bf16(tc::shape_for<64>());
    else f32((const void*)f32tc::flash_fwd_3xtf32<64>,
             f32tc::Tf32<64>::BYTES);
  }
  if (!fn) return 1;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess) err = configure(fn, smem, max_carveout);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  return 0;
}
