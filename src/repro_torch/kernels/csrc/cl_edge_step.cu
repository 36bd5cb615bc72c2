// cl_edge_step: the CL-ADMM edge phase of one scenario round (paper §4.2
// steps 2-3, scenario-engine semantics).
//
// Replaces the Pallas TPU kernel repro/kernels/round_fuse.py::
// cl_edge_step_pallas (_cl_edge_kernel).  That kernel walks the event
// sides in order on a sequential (2, blocks) grid with the whole state in
// VMEM: phase 0 computes every side's four results into scratch from the
// round-start state, phase 1 lands them.  A Hopper grid has no order
// between blocks, and the state lives in HBM, updated in place, so the
// phase barrier becomes two launches:
//
//   1. compute: one warp per event side e, lanes over p.  Side e's payload
//      is its partner's fresh cells (theta[oth_a], and slot oth_s of K,
//      L_own and L_nbr) or, where stale[e], the prefetched stale rows
//      pay_*[e].  With its own cells it gives
//        z_own = 0.5 ((l_own + ln_pay) / rho + theta_own + k_pay)
//        z_nbr = 0.5 ((lo_pay + l_nbr) / rho + th_pay + k_own)
//        l_own' = l_own + rho (theta_own - z_own)
//        l_nbr' = l_nbr + rho (k_own - z_nbr)
//      written to an (E, 4, p) scratch.  Sides with got[e] unset skip.
//   2. land: one warp per side with got[e] set copies its four rows into
//      slot own_s[e] of agent upd[e] in Z_own, Z_nbr, L_own, L_nbr.
//
// One launch cannot be right: side 2 of an event reads, fresh, the
// partner cells that side 1 writes, and a duplicate event reads the cells
// its twin writes.  Launch 1 reads only round-start cells because nothing
// is written before launch 2.
//
// No atomics.  Targets repeat within a round (an agent can wake twice and
// pick the same slot; i->j and j->i can both fire), but every side that
// writes (i, s) reads the same round-start Z/L cells and post-primal
// theta/K rows, and staleness is drawn per sender per round, so duplicate
// targets carry bit-identical values and the order of their writes does
// not matter.  The arithmetic uses explicitly rounded intrinsics in the
// order of the plain version (kernels/ref.py::admm_edge_halfstep), so nvcc
// contracts nothing into an FMA and the two agree bit for bit.
//
// Bound on an H100: memory.  Counted once (chip_smoke.py counts the same
// from the run's own inputs): per side with got set, 8p floats read (its
// own four cells, the payload's four) and 4p floats written; per side,
// 18 B of indices and flags (upd, own_s, oth_a, oth_s as int32, stale and
// got as bytes).  At E = 200k sides, p = 32 and about 90 % of the sides
// delivered that is about 0.28 GB, about 0.085 ms at 3.35 TB/s.  The
// scratch round trip (4p floats written and read again per got side) is
// extra traffic on top of that bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
cl_edge_compute_kernel(const float* __restrict__ theta,
                       const float* __restrict__ K,
                       const float* __restrict__ L_own,
                       const float* __restrict__ L_nbr,
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
                       float* __restrict__ out, int E, int k, int p,
                       float rho) {
  const int e = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (e >= E || !got[e]) return;            // warp-uniform
  const bool stl = stale[e] != 0;
  const size_t kp = (size_t)k * p;
  const size_t ep = (size_t)e * p;
  const float* th_o = theta + (size_t)upd[e] * p;
  const size_t own = (size_t)upd[e] * kp + (size_t)own_s[e] * p;
  const float* th_p = stl ? pay_th + ep : theta + (size_t)oth_a[e] * p;
  const size_t oth = (size_t)oth_a[e] * kp + (size_t)oth_s[e] * p;
  const float* k_p = stl ? pay_K + ep : K + oth;
  const float* lo_p = stl ? pay_Lo + ep : L_own + oth;
  const float* ln_p = stl ? pay_Ln + ep : L_nbr + oth;
  float* o = out + (size_t)e * 4 * p;
  for (int d = lane; d < p; d += 32) {
    const float theta_own = th_o[d];
    const float k_own = K[own + d];
    const float l_own = L_own[own + d];
    const float l_nbr = L_nbr[own + d];
    const float z_own = __fmul_rn(
        0.5f, __fadd_rn(__fadd_rn(__fdiv_rn(__fadd_rn(l_own, ln_p[d]), rho),
                                  theta_own),
                        k_p[d]));
    const float z_nbr = __fmul_rn(
        0.5f, __fadd_rn(__fadd_rn(__fdiv_rn(__fadd_rn(lo_p[d], l_nbr), rho),
                                  th_p[d]),
                        k_own));
    o[d] = z_own;
    o[p + d] = z_nbr;
    o[2 * p + d] = __fadd_rn(l_own, __fmul_rn(rho, __fsub_rn(theta_own,
                                                             z_own)));
    o[3 * p + d] = __fadd_rn(l_nbr, __fmul_rn(rho, __fsub_rn(k_own, z_nbr)));
  }
}

__global__ void __launch_bounds__(THREADS)
cl_edge_land_kernel(float* __restrict__ Z_own, float* __restrict__ Z_nbr,
                    float* __restrict__ L_own, float* __restrict__ L_nbr,
                    const int* __restrict__ upd,
                    const int* __restrict__ own_s,
                    const uint8_t* __restrict__ got,
                    const float* __restrict__ out, int E, int k, int p) {
  const int e = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (e >= E || !got[e]) return;
  const size_t own = (size_t)upd[e] * k * p + (size_t)own_s[e] * p;
  const float* o = out + (size_t)e * 4 * p;
  for (int d = lane; d < p; d += 32) {
    Z_own[own + d] = o[d];
    Z_nbr[own + d] = o[p + d];
    L_own[own + d] = o[2 * p + d];
    L_nbr[own + d] = o[3 * p + d];
  }
}

}  // namespace

// theta (n, p), K (n, k, p) post-primal; Z_own, Z_nbr, L_own, L_nbr
// (n, k, p) round-start, updated in place; pay_* (E, p); upd, own_s,
// oth_a, oth_s (E,) int32; stale, got (E,) bool; scratch (E, 4, p).
extern "C" int repro_cl_edge_step(const float* theta, const float* K,
                                  float* Z_own, float* Z_nbr, float* L_own,
                                  float* L_nbr, const float* pay_th,
                                  const float* pay_K, const float* pay_Lo,
                                  const float* pay_Ln, const int* upd,
                                  const int* own_s, const int* oth_a,
                                  const int* oth_s, const uint8_t* stale,
                                  const uint8_t* got, float* scratch, int E,
                                  int k, int p, float rho,
                                  cudaStream_t stream) {
  if (E > 0) {
    const int blocks = (E + WARPS - 1) / WARPS;
    cl_edge_compute_kernel<<<blocks, THREADS, 0, stream>>>(
        theta, K, L_own, L_nbr, pay_th, pay_K, pay_Lo, pay_Ln, upd, own_s,
        oth_a, oth_s, stale, got, scratch, E, k, p, rho);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cl_edge_land_kernel<<<blocks, THREADS, 0, stream>>>(
        Z_own, Z_nbr, L_own, L_nbr, upd, own_s, got, scratch, E, k, p);
  }
  return (int)cudaGetLastError();
}
