// round_step: one fused MP gossip round (paper Eq. 6, scenario-engine
// semantics) over the flat slot table Ke (n*k, p+1), whose column p
// records the id of the event that last wrote each slot.
//
// Replaces the Pallas TPU megakernel repro/kernels/round_fuse.py::
// round_step_pallas (_mp_round_kernel).  That kernel walks the events in
// order on a sequential (2, blocks) grid with the whole state in VMEM: a
// phase that lands every [msg | id], then a phase that reads the ids back
// and updates rows.  A Hopper grid has no order, so the round is two
// launches over state in HBM, updated in place:
//
//   1. elect: every landed event (enc < n*k) posts its index with an
//      integer atomicMax into a scratch array win (n*k,), filled with -1
//      by the wrapper.  The winner of a slot is its highest event index —
//      the "last event of each duplicate run" rule of the oracle
//      (ref.gossip_round_step) and of XLA's scatter order — so keep
//      equals the oracle's keep exactly.  The id column of Ke is not
//      consulted: it holds earlier rounds' ids.
//   2. apply: one warp per event.  A winner lands [msg | id] in its slot.
//      The winner in the lowest landed slot of its row is the row's
//      leader: it starts from theta_base[r] on the row's first receipt
//      (got_ever) or theta[r] otherwise, adds every winner's
//      a_w (msg - k_old) in slot order, writes the row and sets got_ever.
//      No float atomics: the row sum has one fixed order, so same-seed
//      replays are bit-identical, and the explicitly rounded arithmetic
//      reproduces the plain PyTorch version (kernels/ref.py) bit
//      for bit.
//
// All writes to one slot in one round carry the same payload (staleness
// is drawn per sender per round), so which duplicate wins does not change
// the result; it only fixes the id recorded in the slot.
//
// Bound on an H100: memory.  Counted once, for m events of which W win,
// touching R rows of which F are first receipts (chip_smoke.py counts
// these from the run's own inputs):
//   9 B per event (enc, tgt_row, keep);
//   per winner its msg and k_old rows, its a_w and its Ke row written
//     (4 (2p + 1 + p + 1) B);
//   per touched row theta read (R - F rows) or theta_base read (F rows),
//     theta written, got_ever read and written (4p (2R) + 2R B);
// about 114 MB at the main path's m = 200k, p = 32 — about 34 us at
// 3.35 TB/s.  The wrapper's fill of the (n*k,) scratch is extra traffic
// on top of that bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
round_elect_kernel(int* __restrict__ win, const int* __restrict__ enc,
                   const int* __restrict__ tgt_row, int m, int n, int nk) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= m) return;
  const int s = enc[e];
  if (s >= 0 && s < nk && tgt_row[e] < n) atomicMax(&win[s], e);
}

__global__ void __launch_bounds__(THREADS)
round_apply_kernel(float* __restrict__ theta, float* __restrict__ Ke,
                   uint8_t* __restrict__ got_ever,
                   const float* __restrict__ msg,
                   const float* __restrict__ k_old,
                   const int* __restrict__ tgt_row,
                   const int* __restrict__ enc,
                   const float* __restrict__ theta_base,
                   const float* __restrict__ a_w,
                   const int* __restrict__ win, uint8_t* __restrict__ keep,
                   int m, int n, int k, int p) {
  const int e = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (e >= m) return;                       // warp-uniform from here on
  const int nk = n * k;
  const int s = enc[e];
  const bool landed = s >= 0 && s < nk && tgt_row[e] < n;
  const bool is_win = landed && win[s] == e;
  if (lane == 0) keep[e] = is_win ? 1 : 0;
  if (!is_win) return;

  // land [msg | id] in the winner's slot
  const size_t p1 = (size_t)p + 1;
  const float* me = msg + (size_t)e * p;
  for (int d = lane; d < p; d += 32) Ke[(size_t)s * p1 + d] = me[d];
  if (lane == 0) Ke[(size_t)s * p1 + p] = (float)e;   // exact: m < 2^24

  // the winner in the row's lowest landed slot updates the row
  const int r = s / k;
  const int s0 = r * k;
  for (int q = s0; q < s; ++q)
    if (win[q] >= 0) return;
  const bool first = got_ever[r] == 0;
  __syncwarp();                             // every lane read got_ever
  for (int d = lane; d < p; d += 32) {
    float acc = first ? theta_base[(size_t)r * p + d]
                      : theta[(size_t)r * p + d];
    for (int q = s; q < s0 + k; ++q) {
      const int we = win[q];
      if (we < 0) continue;
      const float diff = __fsub_rn(msg[(size_t)we * p + d],
                                   k_old[(size_t)we * p + d]);
      acc = __fadd_rn(acc, __fmul_rn(a_w[q], diff));
    }
    theta[(size_t)r * p + d] = acc;
  }
  if (lane == 0) got_ever[r] = 1;
}

}  // namespace

// win (n*k,) int32 filled with -1; enc, tgt_row (m,) int32.
extern "C" int repro_round_elect(int* win, const int* enc, const int* tgt_row,
                                 int m, int n, int k, cudaStream_t stream) {
  if (m > 0) {
    round_elect_kernel<<<(m + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        win, enc, tgt_row, m, n, n * k);
  }
  return (int)cudaGetLastError();
}

// theta (n, p), Ke (n*k, p+1), got_ever (n,) bool — updated in place;
// msg, k_old (m, p); tgt_row, enc (m,) int32; theta_base (n, p);
// a_w (n*k,); win (n*k,) from repro_round_elect; keep (m,) bool out.
extern "C" int repro_round_apply(float* theta, float* Ke, uint8_t* got_ever,
                                 const float* msg, const float* k_old,
                                 const int* tgt_row, const int* enc,
                                 const float* theta_base, const float* a_w,
                                 const int* win, uint8_t* keep, int m, int n,
                                 int k, int p, cudaStream_t stream) {
  if (m > 0) {
    const int per_block = THREADS / 32;
    round_apply_kernel<<<(m + per_block - 1) / per_block, THREADS, 0,
                         stream>>>(theta, Ke, got_ever, msg, k_old, tgt_row,
                                   enc, theta_base, a_w, win, keep, m, n, k,
                                   p);
  }
  return (int)cudaGetLastError();
}
