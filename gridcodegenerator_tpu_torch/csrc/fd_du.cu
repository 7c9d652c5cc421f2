// fd_du: the fused forward-dynamics gradient, one thread per lane.
//
// Replaces gridcodegenerator_tpu/ops/pallas/kernels.py:fd_du_pallas
// (with_extras=True). Per lane (dynamics.cuh:fd_du_lane, shared with
// csrc/fdsva_so.cu): joint transforms, Carpentier's Minv, the
// bias RNEA, qdd = Minv (u - c) (dynamics.cuh:fd_from_x, shared with
// csrc/fd.cu), RNEA at qdd, the analytical ID gradient
// dc/d[q, qd], and df/du = -Minv dc/du. The ID gradient
// (dynamics.cuh:id_du_columns, shared with csrc/id_du.cu) runs one
// forward-mode pass per gradient column (2 NJ of them), so a lane keeps
// 6-vectors per joint live instead of (6, NJ) column blocks.
//
// Layout: inputs (NJ, L), outputs df_du (NJ, 2 NJ, L), qdd (NJ, L),
// Minv (NJ, NJ, L); lane l reads and writes element l of each row, so a
// warp's accesses are contiguous.
#include "dynamics.cuh"

#ifdef __CUDACC__

template <typename T, int NJ>
__global__ void fd_du_kernel(const T* __restrict__ model,
                             const T* __restrict__ q,
                             const T* __restrict__ qd,
                             const T* __restrict__ u, T* __restrict__ dfdu,
                             T* __restrict__ qdd, T* __restrict__ Mi,
                             long long L, T gravity) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const gt::Robot<T, NJ> R(model);
  T ql[NJ], qdl[NJ], ul[NJ];
  gt::lane_load<T, NJ>(q, L, lane, ql);
  gt::lane_load<T, NJ>(qd, L, lane, qdl);
  gt::lane_load<T, NJ>(u, L, lane, ul);
  T d[NJ * 2 * NJ], a[NJ], m[NJ * NJ];
  gt::fd_du_lane<T, NJ>(R, ql, qdl, ul, gravity, d, a, m);
  gt::lane_store<T, NJ * 2 * NJ>(d, L, lane, dfdu);
  gt::lane_store<T, NJ>(a, L, lane, qdd);
  gt::lane_store<T, NJ * NJ>(m, L, lane, Mi);
}

template <typename T, int NJ>
static int launch_fd_du(const void* model, const void* q, const void* qd,
                        const void* u, void* dfdu, void* qdd, void* Mi,
                        long long L, double gravity, cudaStream_t stream) {
  if (L == 0) return 0;
  const int block = 128;
  fd_du_kernel<T, NJ><<<gt_grid(L, block), block, 0, stream>>>(
      (const T*)model, (const T*)q, (const T*)qd, (const T*)u, (T*)dfdu,
      (T*)qdd, (T*)Mi, L, (T)gravity);
  return (int)cudaGetLastError();
}

extern "C" int gridtorch_model_size(int nj) {
  return nj == GT_NJ ? gt::Layout<GT_NJ>::SIZE : -1;
}

extern "C" int gridtorch_fd_du(int dtype, int nj, const void* model,
                               const void* q, const void* qd, const void* u,
                               void* dfdu, void* qdd, void* Mi, long long L,
                               double gravity, void* stream) {
  GT_DISPATCH(dtype, nj,
              launch_fd_du<T, NJ>(model, q, qd, u, dfdu, qdd, Mi, L, gravity,
                                  (cudaStream_t)stream));
}

#endif
