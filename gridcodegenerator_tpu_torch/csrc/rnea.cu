// rnea: inverse dynamics c = RNEA(q, qd[, qdd]), one thread per lane.
//
// Replaces gridcodegenerator_tpu/ops/pallas/kernels.py:rnea_pallas. Per
// lane: the joint transforms, the forward pass (velocities, accelerations,
// body forces; the bias form when qdd is null) and the backward pass that
// accumulates the forces into the parents and projects them onto the axes.
//
// What bounds it on the card: arithmetic and the per-thread local memory
// that holds the lane's joint transforms (36 NJ values) and per-joint
// 6-vectors, not device memory: a 7-joint lane reads at most 21 values and
// writes 7. The design keeps each lane in one thread, with no shared memory
// and no synchronisation; inputs (NJ, L) are read and c (NJ, L) written
// along the lane axis, so a warp's accesses are contiguous.
#include "dynamics.cuh"

#ifdef __CUDACC__

template <typename T, int NJ>
__global__ void rnea_kernel(const T* __restrict__ model,
                            const T* __restrict__ q,
                            const T* __restrict__ qd,
                            const T* __restrict__ qdd, T* __restrict__ c,
                            long long L, T gravity) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const gt::Robot<T, NJ> R(model);
  T ql[NJ], qdl[NJ], qddl[NJ], cl[NJ];
  gt::lane_load<T, NJ>(q, L, lane, ql);
  gt::lane_load<T, NJ>(qd, L, lane, qdl);
  if (qdd) gt::lane_load<T, NJ>(qdd, L, lane, qddl);
  gt::rnea_lane<T, NJ>(R, ql, qdl, qdd ? qddl : nullptr, gravity, cl);
  gt::lane_store<T, NJ>(cl, L, lane, c);
}

template <typename T, int NJ>
static int launch_rnea(const void* model, const void* q, const void* qd,
                       const void* qdd, void* c, long long L, double gravity,
                       cudaStream_t stream) {
  if (L == 0) return 0;
  const int block = 128;
  rnea_kernel<T, NJ><<<gt_grid(L, block), block, 0, stream>>>(
      (const T*)model, (const T*)q, (const T*)qd, (const T*)qdd, (T*)c, L,
      (T)gravity);
  return (int)cudaGetLastError();
}

// qdd may be null: c is then the bias force c(q, qd).
extern "C" int gridtorch_rnea(int dtype, int nj, const void* model,
                              const void* q, const void* qd, const void* qdd,
                              void* c, long long L, double gravity,
                              void* stream) {
  GT_DISPATCH(dtype, nj,
              launch_rnea<T, NJ>(model, q, qd, qdd, c, L, gravity,
                                 (cudaStream_t)stream));
}

#endif
