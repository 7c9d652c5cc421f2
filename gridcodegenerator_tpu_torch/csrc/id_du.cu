// id_du: the analytical inverse-dynamics gradient dc/d[q, qd], one thread
// per lane.
//
// Replaces gridcodegenerator_tpu/ops/pallas/kernels.py:id_du_pallas. Per
// lane (dynamics.cuh:id_du_lane): the joint transforms, RNEA at qdd, whose
// backward pass accumulates each child's force into its parent in place,
// then one forward-mode pass per gradient column (2 NJ of them) on those
// accumulated forces. It is the second half of fd_du's lane without the
// -Minv product.
//
// What bounds it on the card: arithmetic (2 NJ column passes, each a forward
// and a backward sweep of 6x6 products) and per-thread local memory (the
// joint transforms plus three (NJ, 6) column buffers), not device memory: a
// 7-joint lane reads 21 values and writes 98. The design trades the
// (6, NJ) column blocks of the plain version for one column at a time, so
// a lane holds 6-vectors per joint; outputs (NJ, 2 NJ, L) are written along
// the lane axis, so a warp's stores are contiguous.
#include "dynamics.cuh"

#ifdef __CUDACC__

template <typename T, int NJ>
__global__ void id_du_kernel(const T* __restrict__ model,
                             const T* __restrict__ q,
                             const T* __restrict__ qd,
                             const T* __restrict__ qdd,
                             T* __restrict__ dcdu, long long L, T gravity) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const gt::Robot<T, NJ> R(model);
  T ql[NJ], qdl[NJ], qddl[NJ], d[NJ * 2 * NJ];
  gt::lane_load<T, NJ>(q, L, lane, ql);
  gt::lane_load<T, NJ>(qd, L, lane, qdl);
  gt::lane_load<T, NJ>(qdd, L, lane, qddl);
  gt::id_du_lane<T, NJ>(R, ql, qdl, qddl, gravity, d);
  gt::lane_store<T, NJ * 2 * NJ>(d, L, lane, dcdu);
}

template <typename T, int NJ>
static int launch_id_du(const void* model, const void* q, const void* qd,
                        const void* qdd, void* dcdu, long long L,
                        double gravity, cudaStream_t stream) {
  if (L == 0) return 0;
  const int block = 128;
  id_du_kernel<T, NJ><<<gt_grid(L, block), block, 0, stream>>>(
      (const T*)model, (const T*)q, (const T*)qd, (const T*)qdd, (T*)dcdu, L,
      (T)gravity);
  return (int)cudaGetLastError();
}

extern "C" int gridtorch_id_du(int dtype, int nj, const void* model,
                               const void* q, const void* qd, const void* qdd,
                               void* dcdu, long long L, double gravity,
                               void* stream) {
  GT_DISPATCH(dtype, nj,
              launch_id_du<T, NJ>(model, q, qd, qdd, dcdu, L, gravity,
                                  (cudaStream_t)stream));
}

#endif
