// minv: Carpentier's direct M^-1(q), dense or the upper factor, one thread
// per lane.
//
// Replaces gridcodegenerator_tpu/ops/pallas/kernels.py:minv_pallas. Per
// lane (dynamics.cuh:minv_lane): the joint transforms, the backward pass
// over the articulated inertias with the (6, NJ) force columns F, and the
// forward pass over the upper triangle. `dense` mirrors the upper triangle
// below the diagonal; otherwise the lower part is exact zeros, as the JAX
// minv(dense=False) returns it.
//
// What bounds it on the card: per-thread local memory more than arithmetic:
// F (6 NJ^2), the articulated inertias (36 NJ) and the joint transforms
// (36 NJ) come to about 800 values a lane at 7 joints, far beyond the
// register file, so most of it lives in (L1-cached) local memory. Device
// memory is small beside it: a lane reads NJ values and writes NJ^2, along
// the lane axis, so a warp's accesses are contiguous.
#include "dynamics.cuh"

#ifdef __CUDACC__

template <typename T, int NJ>
__global__ void minv_kernel(const T* __restrict__ model,
                            const T* __restrict__ q, T* __restrict__ Mi,
                            long long L, int dense) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const gt::Robot<T, NJ> R(model);
  T ql[NJ], m[NJ * NJ];
  gt::lane_load<T, NJ>(q, L, lane, ql);
  gt::minv_lane<T, NJ>(R, ql, dense != 0, m);
  gt::lane_store<T, NJ * NJ>(m, L, lane, Mi);
}

template <typename T, int NJ>
static int launch_minv(const void* model, const void* q, void* Mi,
                       long long L, int dense, cudaStream_t stream) {
  if (L == 0) return 0;
  const int block = 128;
  minv_kernel<T, NJ><<<gt_grid(L, block), block, 0, stream>>>(
      (const T*)model, (const T*)q, (T*)Mi, L, dense);
  return (int)cudaGetLastError();
}

extern "C" int gridtorch_minv(int dtype, int nj, const void* model,
                              const void* q, void* Mi, long long L, int dense,
                              void* stream) {
  GT_DISPATCH(dtype, nj,
              launch_minv<T, NJ>(model, q, Mi, L, dense,
                                 (cudaStream_t)stream));
}

#endif
