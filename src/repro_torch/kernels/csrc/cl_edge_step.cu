// cl_edge_step: the CL-ADMM edge phase of one scenario round (paper §4.2
// steps 2-3, scenario-engine semantics).
//
// Replaces the Pallas TPU kernel repro/kernels/round_fuse.py::
// cl_edge_step_pallas (_cl_edge_kernel).  That kernel walks the event
// sides in order on a sequential (2, blocks) grid with the whole state in
// VMEM: phase 0 computes every side's four results into scratch from the
// round-start state, phase 1 lands them.  A Hopper grid has no order
// between blocks and the state lives in HBM, updated in place, so here the
// work unit is the event and the phase barrier becomes an election.
//
// The E = 2B sides come in event pairs: side b (agent i = upd[b] in slot
// s = own_s[b], partner j = oth_a[b] in slot r = oth_s[b]) and side b + B,
// its mirror (j in slot r, partner i in slot s), as the engine lays them
// out.  The cells (i, s) and (j, r) are the two ends of one edge.  Side b's
// fresh payload (theta[j] and cell (j, r) of K, L_own, L_nbr) is side
// b + B's own cells and the other way round; a stale side reads its
// prefetched rows pay_*[e] instead.  From its own cells and the payload a
// side computes
//     z_own = 0.5 ((l_own + ln_pay) / rho + theta_own + k_pay)
//     z_nbr = 0.5 ((lo_pay + l_nbr) / rho + th_pay + k_own)
//     l_own' = l_own + rho (theta_own - z_own)
//     l_nbr' = l_nbr + rho (k_own - z_nbr)
// and, where got[e], writes them to its own cell of Z_own, Z_nbr, L_own
// and L_nbr.
//
// Two launches:
//
//   1. claim: one thread per event with a delivered side ORs its delivered
//      bits into flags[c], c the edge's canonical cell (the lower flat
//      index of (i, s) and (j, r), i.e. the lower agent's end), bit 0 for
//      the canonical end and bit 1 for the other.
//   2. apply: one warp per such event, lanes over p.  Lane 0 swaps
//      flags[c] for 0; exactly one event of the edge gets the OR of the
//      edge's delivered bits back, the others get 0 and stop.  The winner
//      reads both cells and both theta rows once, computes both sides in
//      registers and writes the ends whose bit is set.
//
// Why the election is exact.  Events repeat on an edge within a round (an
// agent can wake twice and pick the same slot; i->j and j->i can both
// fire), and one launch over sides could not land in place: a side reads,
// fresh, the cells its mirror or a twin writes.  With one writer per edge,
// only the winner writes that edge's two cells, and it reads them before
// it writes them, so every read is round-start.  Staleness is drawn per
// sender per round and the stale payload is gathered per (partner, slot),
// so all events of an edge compute bit-identical values; the union of
// their delivered bits is what the plain version lands.  flags is zero on
// entry and, since every claimer also swaps, zero on exit.  No float
// atomics: the arithmetic uses explicitly rounded intrinsics in the order
// of the plain version (kernels/ref.py::admm_edge_halfstep), so nvcc
// contracts nothing into an FMA and the two agree bit for bit.
//
// Bound on an H100: memory.  Counted once (chip_smoke.py counts the same
// from the run's own inputs): each distinct theta row and each distinct
// (agent, slot) cell of K, L_own and L_nbr that a delivered side needs,
// each distinct delivered stale target's four payload rows, each distinct
// target written in four arrays, plus the indices, byte flags and election
// words.  At round 10 of the n = 1M run (p = 32, B = 100k) that is about
// 0.2 GB, about 0.06 ms at 3.35 TB/s.  The design reads each cell once
// (not once per side that needs it) and keeps all eight of an event's
// fresh rows in flight at once, with the election's swap beside them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
cl_edge_claim_kernel(int* __restrict__ flags, const int* __restrict__ upd,
                     const int* __restrict__ own_s,
                     const int* __restrict__ oth_a,
                     const int* __restrict__ oth_s,
                     const uint8_t* __restrict__ got, int B, int k) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  const int ga = got[b] != 0, gb = got[b + B] != 0;
  if (!(ga | gb)) return;
  const size_t ca = (size_t)upd[b] * k + own_s[b];
  const size_t cb = (size_t)oth_a[b] * k + oth_s[b];
  atomicOr(flags + (ca <= cb ? ca : cb),
           ca <= cb ? (ga | gb << 1) : (gb | ga << 1));
}

__device__ __forceinline__ void halfstep(float theta_own, float k_own,
                                         float l_own, float l_nbr,
                                         float th_pay, float k_pay,
                                         float lo_pay, float ln_pay,
                                         float rho, float* out) {
  const float z_own = __fmul_rn(
      0.5f, __fadd_rn(__fadd_rn(__fdiv_rn(__fadd_rn(l_own, ln_pay), rho),
                                theta_own),
                      k_pay));
  const float z_nbr = __fmul_rn(
      0.5f, __fadd_rn(__fadd_rn(__fdiv_rn(__fadd_rn(lo_pay, l_nbr), rho),
                                th_pay),
                      k_own));
  out[0] = z_own;
  out[1] = z_nbr;
  out[2] = __fadd_rn(l_own, __fmul_rn(rho, __fsub_rn(theta_own, z_own)));
  out[3] = __fadd_rn(l_nbr, __fmul_rn(rho, __fsub_rn(k_own, z_nbr)));
}

__global__ void __launch_bounds__(THREADS)
cl_edge_apply_kernel(const float* __restrict__ theta,
                     const float* __restrict__ K, float* __restrict__ Z_own,
                     float* __restrict__ Z_nbr, float* __restrict__ L_own,
                     float* __restrict__ L_nbr,
                     const float* __restrict__ pay_th,
                     const float* __restrict__ pay_K,
                     const float* __restrict__ pay_Lo,
                     const float* __restrict__ pay_Ln,
                     const int* __restrict__ upd,
                     const int* __restrict__ own_s,
                     const int* __restrict__ oth_a,
                     const int* __restrict__ oth_s,
                     const uint8_t* __restrict__ stale,
                     const uint8_t* __restrict__ got,
                     int* __restrict__ flags, int B, int k, int p,
                     float rho) {
  const int b = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (b >= B) return;                       // warp-uniform from here on
  const int i = upd[b], s = own_s[b], j = oth_a[b], r = oth_s[b];
  const bool ga = got[b] != 0, gb = got[b + B] != 0;
  const bool sa = stale[b] != 0, sb = stale[b + B] != 0;
  if (!(ga || gb)) return;
  const size_t ca = (size_t)i * k + s, cb = (size_t)j * k + r;
  int bits = 0;
  if (lane == 0) bits = atomicExch(flags + (ca <= cb ? ca : cb), 0);
  const float* th_i = theta + (size_t)i * p;
  const float* th_j = theta + (size_t)j * p;
  const size_t oa = ca * p, ob = cb * p;
  const size_t pa = (size_t)b * p, pb = (size_t)(b + B) * p;
  bool wa = false, wb = false;
  for (int d0 = 0; d0 < p; d0 += 32) {
    const int d = d0 + lane;
    const bool on = d < p;
    // the event's eight fresh reads, issued before the election's answer
    // is waited for (a loser discards them)
    float ti = 0.f, tj = 0.f, Ka = 0.f, Loa = 0.f, Lna = 0.f, Kb = 0.f,
          Lob = 0.f, Lnb = 0.f;
    if (on) {
      ti = th_i[d];
      tj = th_j[d];
      Ka = K[oa + d];
      Loa = L_own[oa + d];
      Lna = L_nbr[oa + d];
      Kb = K[ob + d];
      Lob = L_own[ob + d];
      Lnb = L_nbr[ob + d];
    }
    if (d0 == 0) {
      bits = __shfl_sync(FULL, bits, 0);
      if (bits == 0) return;                // a twin of this edge won
      wa = (bits & (ca <= cb ? 1 : 2)) != 0;
      wb = (bits & (ca <= cb ? 2 : 1)) != 0;
    }
    if (!on) continue;
    float ra[4], rb[4];
    if (wa) {
      halfstep(ti, Ka, Loa, Lna, sa ? pay_th[pa + d] : tj,
               sa ? pay_K[pa + d] : Kb, sa ? pay_Lo[pa + d] : Lob,
               sa ? pay_Ln[pa + d] : Lnb, rho, ra);
    }
    if (wb) {
      halfstep(tj, Kb, Lob, Lnb, sb ? pay_th[pb + d] : ti,
               sb ? pay_K[pb + d] : Ka, sb ? pay_Lo[pb + d] : Loa,
               sb ? pay_Ln[pb + d] : Lna, rho, rb);
    }
    // every read of this lane's column is done: the writes may follow
    if (wa) {
      Z_own[oa + d] = ra[0];
      Z_nbr[oa + d] = ra[1];
      L_own[oa + d] = ra[2];
      L_nbr[oa + d] = ra[3];
    }
    if (wb) {
      Z_own[ob + d] = rb[0];
      Z_nbr[ob + d] = rb[1];
      L_own[ob + d] = rb[2];
      L_nbr[ob + d] = rb[3];
    }
  }
}

}  // namespace

// theta (n, p), K (n, k, p) post-primal; Z_own, Z_nbr, L_own, L_nbr
// (n, k, p) round-start, updated in place; pay_* (E, p); upd, own_s,
// oth_a, oth_s (E,) int32; stale, got (E,) bool, E = 2B sides in event
// pairs (side b + B mirrors side b); flags (n*k,) int32, zero on entry and
// on a clean exit.
extern "C" int repro_cl_edge_step(const float* theta, const float* K,
                                  float* Z_own, float* Z_nbr, float* L_own,
                                  float* L_nbr, const float* pay_th,
                                  const float* pay_K, const float* pay_Lo,
                                  const float* pay_Ln, const int* upd,
                                  const int* own_s, const int* oth_a,
                                  const int* oth_s, const uint8_t* stale,
                                  const uint8_t* got, int* flags, int E,
                                  int k, int p, float rho,
                                  cudaStream_t stream) {
  const int B = E / 2;
  if (B > 0) {
    cl_edge_claim_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                           stream>>>(flags, upd, own_s, oth_a, oth_s, got,
                                     B, k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cl_edge_apply_kernel<<<(B + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
        theta, K, Z_own, Z_nbr, L_own, L_nbr, pay_th, pay_K, pay_Lo, pay_Ln,
        upd, own_s, oth_a, oth_s, stale, got, flags, B, k, p, rho);
  }
  return (int)cudaGetLastError();
}
