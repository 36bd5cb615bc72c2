// round_step: one fused MP gossip round (paper Eq. 6, scenario-engine
// semantics) over the flat slot table Ke (n*k, p+1), whose column p
// records the id of the event that last wrote each slot.
//
// Replaces the Pallas TPU megakernel repro/kernels/round_fuse.py::
// round_step_pallas (_mp_round_kernel).  That kernel walks the events in
// order on a sequential (2, blocks) grid with the whole state in VMEM: a
// phase that lands every [msg | id], then a phase that reads the ids back
// and updates rows.  A Hopper grid has no order and no grid-wide barrier
// short of a second launch, so the round is two launches over state in
// HBM, updated in place, with an election between them:
//
//   1. elect: one thread per event.  Every landed event (enc < n*k,
//      tgt_row < n) posts (tag << 24) | e into its slot's 64-bit election
//      word with an integer atomicMax.  The winner of a slot is its
//      highest event index -- the "last event of each duplicate run" rule
//      of the oracle (ref.gossip_round_step) and of XLA's scatter order --
//      so keep equals the oracle's keep exactly.  The id column of Ke is
//      not consulted: it holds earlier rounds' ids.
//   2. apply: a group of lanes per event (8 lanes in the fixed kernels
//      below, a warp in the generic one).  The group loads, in one go, its
//      row's k election words across its lanes, got_ever, its slot's gain
//      a_w and its own msg and k_old rows; a ballot over "word carries
//      this call's tag" gives the row's winner mask, and a shuffle from
//      the lane holding its slot's word tells the event whether it won.
//      A winner lands [msg | id] in its slot.  The winner in the row's
//      lowest slot is the leader (lowest set bit): it adds its own
//      a_w (msg - k_old) to theta_base[r] (first receipt) or theta[r],
//      then every other winner's in slot order, their words and rows
//      loaded two winners at a time before their adds, writes the row and
//      sets got_ever.  No float atomics: the row sum has one fixed order,
//      so same-seed replays are bit-identical, and the explicitly rounded
//      arithmetic reproduces the plain PyTorch version (kernels/ref.py)
//      bit for bit.
//
// Election words with no per-call fill.  The words are one (n*k + 2,)
// 64-bit buffer per (n*k, device), made zero once by the wrapper
// (round_fuse.round_words).  A word is (tag << 24) | e: events are below
// 2^24 (round_fuse.MAX_EVENTS) and the tag takes the other 40 bits.  Each
// call's tag is one more than the last, so a word left by an earlier call
// carries a smaller tag: it loses every atomicMax of this call and never
// matches this call's tag, and no word is ever reset.  The tag lives on
// the device, not in a host argument: words[n*k] holds the tag of the last
// call, the elect launch posts with one more and writes it to
// words[n*k + 1], and the apply launch reads it there and copies it back
// to words[n*k].  Neither launch reads the word it writes, so no
// done-counter or fence is needed, and both launches take the same
// arguments every round (a CUDA graph of the round stays correct).  40
// bits last 2^40 - 1 calls (35 years of 1 ms rounds).  The 64-bit words
// were chosen over 32-bit ones with a 7-bit tag: those would need a fill
// every 127 calls, a host count to know when, and a launch argument or
// a graph node that changes with it; the 8 bytes a word cost only at the
// slots a round touches.
//
// k and p: the main path's p = 32 and every k <= 32 are fixed when
// compiled (round_apply_k<K, 8>: a lane owns 4 columns and at most 4 of
// the row's slots and the loops unroll; at k = 18 it takes 32 registers
// and no local memory, so an SM holds 64 warps).  Any other (k, p) takes
// round_apply_any, the same algorithm with a warp per event, the row's
// slots in chunks of 32 (a ballot each) and p in chunks of 32 columns.
//
// Bound on an H100: memory.  Counted once, for m events of which W win,
// touching R rows of which F are first receipts (chip_smoke.py counts
// these from the run's own inputs):
//   9 B per event (enc, tgt_row, keep);
//   per winner its msg and k_old rows, its a_w and its Ke row written
//     (4 (2p + 1 + p + 1) B);
//   per touched row theta read (R - F rows) or theta_base read (F rows),
//     theta written, got_ever read and written (4p (2R) + 2R B);
// about 114 MB at the main path's m = 200k, p = 32 -- about 34 us at
// 3.35 TB/s.  The election words (8 B posted per landed event, k words
// read per landed event) are the design's overhead and are not in the
// bound.  That count assumes streaming; every access here but msg and
// k_old lands on a random row, and the Ke rows (33 floats, the op's
// layout) start off 32-byte sectors, so each landed row's write is two
// partial sectors and three whole ones.  On the card the apply launch is
// bound by that random traffic, not by latency or registers (PERF.md):
// without the Ke write a round takes a third less time; 4, 8, 16
// or 32 lanes an event move it by 14 % at most (8 is the fastest), and
// reading only the event's own word instead of the row's k words saves
// 4 % (tools/probe_round_step.py).  A first version that kept every
// winner's rows in K-sized register arrays held too few warps an SM and
// was slower than the kernel it replaced.

#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <utility>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int ID_BITS = 24;                  // event ids < 2^24
constexpr unsigned long long ID_MASK = (1ull << ID_BITS) - 1;
constexpr int GROUP = 8;                     // lanes an event, fixed kernels

using u64 = unsigned long long;

__global__ void __launch_bounds__(THREADS)
round_elect_kernel(u64* __restrict__ words, const int* __restrict__ enc,
                   const int* __restrict__ tgt_row, int m, int n, int nk) {
  const u64 tag = words[nk] + 1;             // one more than the last call
  if (blockIdx.x == 0 && threadIdx.x == 0) words[nk + 1] = tag;
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= m) return;
  const int s = enc[e];
  if (s >= 0 && s < nk && tgt_row[e] < n)
    atomicMax(&words[s], tag << ID_BITS | (u64)e);
}

// The apply launch's signature, shared by every instantiation (the fixed
// ones ignore k and p) so that one pointer picks the kernel.
using ApplyFn = void (*)(float*, float*, uint8_t*, const float*,
                         const float*, const int*, const int*, const float*,
                         const float*, u64*, uint8_t*, int, int, int, int);

// k == K <= 32 and p == 32, known when compiled.  A group of G lanes takes
// one event, 32 / G events a warp: lane j of the group owns columns j,
// j + G, ... of every row (each load a coalesced run of G floats) and the
// row's slots j, j + G, ... of the election words.
template <int K, int G>
__global__ void __launch_bounds__(THREADS)
round_apply_k(float* __restrict__ theta, float* __restrict__ Ke,
              uint8_t* __restrict__ got_ever, const float* __restrict__ msg,
              const float* __restrict__ k_old,
              const int* __restrict__ tgt_row, const int* __restrict__ enc,
              const float* __restrict__ theta_base,
              const float* __restrict__ a_w, u64* __restrict__ words,
              uint8_t* __restrict__ keep, int m, int n, int, int) {
  constexpr int P = 32, F = P / G, W = (K + G - 1) / G;
  constexpr unsigned GMASK = G == 32 ? FULL : (1u << G) - 1;
  const int nk = n * K;
  const u64 tag = words[nk + 1];
  if (blockIdx.x == 0 && threadIdx.x == 0) words[nk] = tag;
  const int lane = threadIdx.x % 32, j = lane % G, g0 = lane - j;
  const int e = (blockIdx.x * THREADS + threadIdx.x) / G;
  // every lane runs the ballots and the shuffle: none leaves before them
  const int s = e < m ? enc[e] : -1;
  const bool landed = s >= 0 && s < nk && tgt_row[e] < n;
  const int r = landed ? s / K : 0, s0 = r * K, mine = landed ? s - s0 : 0;
  // all of the event's loads at once: the row's words (slot q on lane
  // q % G), got_ever, this slot's gain and the event's own rows
  u64 w[W];
  float mv[F], kv[F];
  bool first = false;
  float my_aw = 0.f;
#pragma unroll
  for (int i = 0; i < W; ++i)
    w[i] = landed && i * G + j < K ? words[s0 + i * G + j] : 0;
  if (landed) {
    first = got_ever[r] == 0;
    my_aw = a_w[s];
#pragma unroll
    for (int i = 0; i < F; ++i) {
      mv[i] = msg[(size_t)e * P + i * G + j];
      kv[i] = k_old[(size_t)e * P + i * G + j];
    }
  }
  // the row's winner mask (the slots whose word carries this call's tag),
  // a ballot a chunk of G slots, and this slot's winner, from the lane
  // that holds its word
  unsigned hits = 0, mine_e = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const unsigned b = __ballot_sync(FULL, (w[i] >> ID_BITS) == tag);
    hits |= (b >> g0 & GMASK) << (i * G);
    mine_e |= i * G + j == mine ? (unsigned)(w[i] & ID_MASK) : 0u;
  }
  mine_e = __shfl_sync(FULL, mine_e, g0 + mine % G);
  const bool is_win = landed && mine_e == (unsigned)e;
  if (e < m && j == 0) keep[e] = is_win ? 1 : 0;
  if (!is_win) return;

  // land [msg | id] in the winner's slot
#pragma unroll
  for (int i = 0; i < F; ++i) Ke[(size_t)s * (P + 1) + i * G + j] = mv[i];
  if (j == 0) Ke[(size_t)s * (P + 1) + P] = (float)e;   // exact: e < 2^24
  if (__ffs(hits) - 1 != mine) return;       // a lower slot's winner leads

  // the leader: its own delta on the start row, then the other winners in
  // slot order, two at a time, their words and rows loaded before the adds
  float acc[F];
#pragma unroll
  for (int i = 0; i < F; ++i) {
    const size_t d = (size_t)r * P + i * G + j;
    acc[i] = __fadd_rn(first ? theta_base[d] : theta[d],
                       __fmul_rn(my_aw, __fsub_rn(mv[i], kv[i])));
  }
  unsigned rest = hits & (hits - 1);         // the leader's bit cleared
  while (rest) {
    const int t0 = __ffs(rest) - 1;
    rest &= rest - 1;
    const int t1 = rest ? __ffs(rest) - 1 : -1;
    if (t1 >= 0) rest &= rest - 1;
    const int e0 = (int)(words[s0 + t0] & ID_MASK);
    const int e1 = t1 >= 0 ? (int)(words[s0 + t1] & ID_MASK) : e0;
    const float a0 = a_w[s0 + t0], a1 = t1 >= 0 ? a_w[s0 + t1] : 0.f;
    float m0[F], k0[F], m1[F], k1[F];
#pragma unroll
    for (int i = 0; i < F; ++i) {
      m0[i] = msg[(size_t)e0 * P + i * G + j];
      k0[i] = k_old[(size_t)e0 * P + i * G + j];
      m1[i] = msg[(size_t)e1 * P + i * G + j];
      k1[i] = k_old[(size_t)e1 * P + i * G + j];
    }
#pragma unroll
    for (int i = 0; i < F; ++i) {
      acc[i] = __fadd_rn(acc[i], __fmul_rn(a0, __fsub_rn(m0[i], k0[i])));
      if (t1 >= 0)
        acc[i] = __fadd_rn(acc[i], __fmul_rn(a1, __fsub_rn(m1[i], k1[i])));
    }
  }
#pragma unroll
  for (int i = 0; i < F; ++i) theta[(size_t)r * P + i * G + j] = acc[i];
  if (j == 0) got_ever[r] = 1;
}

// any k and p: the same algorithm with the row's slots in chunks of 32
// (one ballot a chunk) and the features in chunks of 32.
__global__ void __launch_bounds__(THREADS)
round_apply_any(float* __restrict__ theta, float* __restrict__ Ke,
                uint8_t* __restrict__ got_ever,
                const float* __restrict__ msg,
                const float* __restrict__ k_old,
                const int* __restrict__ tgt_row, const int* __restrict__ enc,
                const float* __restrict__ theta_base,
                const float* __restrict__ a_w, u64* __restrict__ words,
                uint8_t* __restrict__ keep, int m, int n, int k, int p) {
  const int nk = n * k;
  const u64 tag = words[nk + 1];
  if (blockIdx.x == 0 && threadIdx.x == 0) words[nk] = tag;
  const int e = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (e >= m) return;                        // warp-uniform from here on
  const int s = enc[e];
  if (!(s >= 0 && s < nk && tgt_row[e] < n)) {
    if (lane == 0) keep[e] = 0;
    return;
  }
  const int r = s / k, mine = s - r * k;
  const size_t s0 = (size_t)r * k;
  // this slot's winner, and whether a lower slot of the row has one
  int win_mine = -1;
  bool lower = false;
  for (int c0 = 0; c0 <= mine; c0 += 32) {
    const int q = c0 + lane;
    const u64 w = q < k ? words[s0 + q] : 0;
    const unsigned hits = __ballot_sync(FULL, q < k && (w >> ID_BITS) == tag);
    const int win_e = (int)(w & ID_MASK);
    if (mine < c0 + 32) {
      win_mine = __shfl_sync(FULL, win_e, mine - c0);
      lower = lower || (hits & ((1u << (mine - c0)) - 1u)) != 0;
    } else {
      lower = lower || hits != 0;
    }
  }
  const bool is_win = win_mine == e;
  if (lane == 0) keep[e] = is_win ? 1 : 0;
  if (!is_win) return;

  const size_t p1 = (size_t)p + 1;
  const float* me = msg + (size_t)e * p;
  for (int d = lane; d < p; d += 32) Ke[(size_t)s * p1 + d] = me[d];
  if (lane == 0) Ke[(size_t)s * p1 + p] = (float)e;
  if (lower) return;

  const bool first = got_ever[r] == 0;
  for (int d0 = 0; d0 < p; d0 += 32) {
    const int d = d0 + lane;
    const bool on = d < p;
    float acc = 0.f;
    if (on) acc = first ? theta_base[(size_t)r * p + d]
                        : theta[(size_t)r * p + d];
    for (int c0 = mine - mine % 32; c0 < k; c0 += 32) {
      const int q = c0 + lane;
      u64 w = 0;
      float aw = 0.f;
      if (q < k) {
        w = words[s0 + q];
        aw = a_w[s0 + q];
      }
      unsigned hits = __ballot_sync(FULL, q < k && q >= mine &&
                                              (w >> ID_BITS) == tag);
      const int win_e = (int)(w & ID_MASK);
      while (hits) {                         // the chunk's winners in order
        const int t = __ffs(hits) - 1;
        hits &= hits - 1;
        const int we = __shfl_sync(FULL, win_e, t);
        const float a = __shfl_sync(FULL, aw, t);
        if (on) {
          const float diff = __fsub_rn(msg[(size_t)we * p + d],
                                       k_old[(size_t)we * p + d]);
          acc = __fadd_rn(acc, __fmul_rn(a, diff));
        }
      }
    }
    if (on) theta[(size_t)r * p + d] = acc;
  }
  if (lane == 0) got_ever[r] = 1;
}

template <int... Ks>
std::array<ApplyFn, sizeof...(Ks)> fixed_kernels(
    std::integer_sequence<int, Ks...>) {
  return {&round_apply_k<Ks + 1, GROUP>...};
}

bool fixed_shape(int k, int p) { return p == 32 && k >= 1 && k <= 32; }

ApplyFn apply_kernel(int k, int p) {
  static const std::array<ApplyFn, 32> fixed =
      fixed_kernels(std::make_integer_sequence<int, 32>{});
  return fixed_shape(k, p) ? fixed[k - 1] : &round_apply_any;
}

}  // namespace

// theta (n, p), Ke (n*k, p+1), got_ever (n,) bool -- updated in place;
// msg, k_old (m, p); tgt_row, enc (m,) int32, m < 2^24; theta_base (n, p);
// a_w (n*k,); words (n*k + 2,) 64-bit election words, zero when made and
// then only touched by this function, calls in stream order; keep (m,)
// bool out.  Two launches: elect, then apply.
extern "C" int repro_round_step(float* theta, float* Ke, uint8_t* got_ever,
                                const float* msg, const float* k_old,
                                const int* tgt_row, const int* enc,
                                const float* theta_base, const float* a_w,
                                unsigned long long* words, uint8_t* keep,
                                int m, int n, int k, int p,
                                cudaStream_t stream) {
  if (m > 0) {
    round_elect_kernel<<<(m + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        words, enc, tgt_row, m, n, n * k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long lanes = (long long)m * (fixed_shape(k, p) ? GROUP : 32);
    const ApplyFn apply = apply_kernel(k, p);
    apply<<<(unsigned)((lanes + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
        theta, Ke, got_ever, msg, k_old, tgt_row, enc, theta_base, a_w,
        words, keep, m, n, k, p);
  }
  return (int)cudaGetLastError();
}

// out[0] registers a thread, out[1] local memory bytes a thread (spills
// included) of the apply kernel that repro_round_step launches for (k, p).
extern "C" int repro_round_step_attrs(int k, int p, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, (const void*)apply_kernel(k, p));
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  return 0;
}
