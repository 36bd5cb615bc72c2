// admm_edge: the fused CL-ADMM Z + dual update over a batch of edges
// (paper §4.2 steps 2-3).  For each edge e = (i, j) and coordinate d:
//   z_i = 0.5 ((l_own_i + l_nbr_i_of_j) / rho + t_ii + t_ji)
//   z_j = 0.5 ((l_own_j + l_nbr_j_of_i) / rho + t_jj + t_ij)
//   l_own_i'      = l_own_i + rho (t_ii - z_i)
//   l_nbr_j_of_i' = l_nbr_j_of_i + rho (t_ij - z_j)
//   l_own_j'      = l_own_j + rho (t_jj - z_j)
//   l_nbr_i_of_j' = l_nbr_i_of_j + rho (t_ji - z_i)
//
// Replaces the Pallas TPU kernel repro/kernels/admm_update.py::
// admm_edge_update (_kernel), which tiles the (E, p) slabs into VMEM
// blocks on an (edge, p) grid.  Here the slabs are flat: one grid-stride
// loop over the E*p elements, neighbouring threads on neighbouring
// addresses, so every load and store is coalesced.  It divides by rho (the
// TPU kernel multiplies by 1/rho) and rounds each operation explicitly in
// the order of the plain version (kernels/ref.py::admm_edge_update), so
// nvcc contracts nothing into an FMA and the two agree bit for bit.
//
// Bound on an H100: memory, 14 E p 4 bytes (eight inputs read once, six
// outputs written once, 1,792 B per edge at p = 32) against 16 operations
// per element; at 3.35 TB/s about 0.53 ms per million edges at p = 32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
admm_edge_kernel(const float* __restrict__ t_ii,
                 const float* __restrict__ t_ji,
                 const float* __restrict__ t_jj,
                 const float* __restrict__ t_ij,
                 const float* __restrict__ l_own_i,
                 const float* __restrict__ l_nbr_j_of_i,
                 const float* __restrict__ l_own_j,
                 const float* __restrict__ l_nbr_i_of_j,
                 float* __restrict__ z_i, float* __restrict__ z_j,
                 float* __restrict__ l_own_i_o,
                 float* __restrict__ l_nbr_j_of_i_o,
                 float* __restrict__ l_own_j_o,
                 float* __restrict__ l_nbr_i_of_j_o, size_t total,
                 float rho) {
  const size_t stride = (size_t)gridDim.x * THREADS;
  for (size_t x = (size_t)blockIdx.x * THREADS + threadIdx.x; x < total;
       x += stride) {
    const float tii = t_ii[x], tji = t_ji[x], tjj = t_jj[x], tij = t_ij[x];
    const float loi = l_own_i[x], lnj = l_nbr_j_of_i[x];
    const float loj = l_own_j[x], lni = l_nbr_i_of_j[x];
    const float zi = __fmul_rn(
        0.5f, __fadd_rn(__fadd_rn(__fdiv_rn(__fadd_rn(loi, lni), rho), tii),
                        tji));
    const float zj = __fmul_rn(
        0.5f, __fadd_rn(__fadd_rn(__fdiv_rn(__fadd_rn(loj, lnj), rho), tjj),
                        tij));
    z_i[x] = zi;
    z_j[x] = zj;
    l_own_i_o[x] = __fadd_rn(loi, __fmul_rn(rho, __fsub_rn(tii, zi)));
    l_nbr_j_of_i_o[x] = __fadd_rn(lnj, __fmul_rn(rho, __fsub_rn(tij, zj)));
    l_own_j_o[x] = __fadd_rn(loj, __fmul_rn(rho, __fsub_rn(tjj, zj)));
    l_nbr_i_of_j_o[x] = __fadd_rn(lni, __fmul_rn(rho, __fsub_rn(tji, zi)));
  }
}

}  // namespace

// Eight (E, p) inputs in the order of the plain version, six (E, p)
// outputs (z_i, z_j, then the four duals), all contiguous float32.
extern "C" int repro_admm_edge(const float* t_ii, const float* t_ji,
                               const float* t_jj, const float* t_ij,
                               const float* l_own_i, const float* l_nbr_j_of_i,
                               const float* l_own_j, const float* l_nbr_i_of_j,
                               float* z_i, float* z_j, float* l_own_i_o,
                               float* l_nbr_j_of_i_o, float* l_own_j_o,
                               float* l_nbr_i_of_j_o, int E, int p, float rho,
                               cudaStream_t stream) {
  const size_t total = (size_t)E * p;
  if (total > 0) {
    const size_t want = (total + THREADS - 1) / THREADS;
    const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
    admm_edge_kernel<<<blocks, THREADS, 0, stream>>>(
        t_ii, t_ji, t_jj, t_ij, l_own_i, l_nbr_j_of_i, l_own_j, l_nbr_i_of_j,
        z_i, z_j, l_own_i_o, l_nbr_j_of_i_o, l_own_j_o, l_nbr_i_of_j_o,
        total, rho);
  }
  return (int)cudaGetLastError();
}
