// aba: articulated-body forward dynamics qdd = ABA(q, qd, u), one thread
// per lane.
//
// Replaces gridcodegenerator_tpu/ops/pallas/kernels.py:aba_pallas. Per
// lane (dynamics.cuh:aba): the joint transforms, the velocity and bias
// pass, the backward reduction of the articulated inertias, and the
// forward recovery of the accelerations.
//
// What bounds it on the card: arithmetic (one X^T I X congruence per
// joint) and per-thread local memory (the joint transforms and the NJ
// articulated 6x6 inertias, 72 NJ values), not device memory: a 7-joint
// lane reads 21 values and writes 7. The design keeps each lane in one
// thread, with no shared memory and no synchronisation; inputs and qdd
// (NJ, L) go along the lane axis, so a warp's accesses are contiguous.
#include "dynamics.cuh"

#ifdef __CUDACC__

template <typename T, int NJ>
__global__ void aba_kernel(const T* __restrict__ model,
                           const T* __restrict__ q, const T* __restrict__ qd,
                           const T* __restrict__ u, T* __restrict__ qdd,
                           long long L, T gravity) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const gt::Robot<T, NJ> R(model);
  T ql[NJ], qdl[NJ], ul[NJ], a[NJ];
  gt::lane_load<T, NJ>(q, L, lane, ql);
  gt::lane_load<T, NJ>(qd, L, lane, qdl);
  gt::lane_load<T, NJ>(u, L, lane, ul);
  gt::aba<T, NJ>(R, ql, qdl, ul, gravity, a);
  gt::lane_store<T, NJ>(a, L, lane, qdd);
}

template <typename T, int NJ>
static int launch_aba(const void* model, const void* q, const void* qd,
                      const void* u, void* qdd, long long L, double gravity,
                      cudaStream_t stream) {
  if (L == 0) return 0;
  const int block = 128;
  aba_kernel<T, NJ><<<gt_grid(L, block), block, 0, stream>>>(
      (const T*)model, (const T*)q, (const T*)qd, (const T*)u, (T*)qdd, L,
      (T)gravity);
  return (int)cudaGetLastError();
}

extern "C" int gridtorch_aba(int dtype, int nj, const void* model,
                             const void* q, const void* qd, const void* u,
                             void* qdd, long long L, double gravity,
                             void* stream) {
  GT_DISPATCH(dtype, nj,
              launch_aba<T, NJ>(model, q, qd, u, qdd, L, gravity,
                                (cudaStream_t)stream));
}

#endif
