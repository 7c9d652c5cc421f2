// fd: forward dynamics via the Minv route, qdd = Minv (u - c), one thread
// per lane.
//
// Replaces gridcodegenerator_tpu/ops/pallas/kernels.py:fd_pallas. Per lane
// (dynamics.cuh:fd_lane): the joint transforms once, the bias RNEA (no qdd)
// and Carpentier's dense Minv on the same transforms, then the matvec: the
// first half of csrc/fd_du.cu, which shares dynamics.cuh:fd_from_x.
//
// What bounds it on the card: per-thread local memory more than arithmetic,
// as in csrc/minv.cu, whose passes dominate (the Minv factors, articulated
// inertias and joint transforms, ~800 values a lane at 7 joints). Device
// memory is small beside it: a lane reads 3 NJ values and writes NJ, along
// the lane axis, so a warp's accesses are contiguous.
#include "dynamics.cuh"

#ifdef __CUDACC__

template <typename T, int NJ>
__global__ void fd_kernel(const T* __restrict__ model,
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
  gt::fd_lane<T, NJ>(R, ql, qdl, ul, gravity, a);
  gt::lane_store<T, NJ>(a, L, lane, qdd);
}

template <typename T, int NJ>
static int launch_fd(const void* model, const void* q, const void* qd,
                     const void* u, void* qdd, long long L, double gravity,
                     cudaStream_t stream) {
  if (L == 0) return 0;
  const int block = 128;
  fd_kernel<T, NJ><<<gt_grid(L, block), block, 0, stream>>>(
      (const T*)model, (const T*)q, (const T*)qd, (const T*)u, (T*)qdd, L,
      (T)gravity);
  return (int)cudaGetLastError();
}

extern "C" int gridtorch_fd(int dtype, int nj, const void* model,
                            const void* q, const void* qd, const void* u,
                            void* qdd, long long L, double gravity,
                            void* stream) {
  GT_DISPATCH(dtype, nj,
              launch_fd<T, NJ>(model, q, qd, u, qdd, L, gravity,
                               (cudaStream_t)stream));
}

#endif
