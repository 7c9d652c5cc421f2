// crba: the mass matrix M(q), both triangles, one thread per lane.
//
// Replaces gridcodegenerator_tpu/ops/pallas/kernels.py:crba_pallas. Per
// lane (dynamics.cuh:crba_lane): the joint transforms, the composite
// inertias accumulated into the parents (descending ids), then one walk per
// column up the ancestor chain by parent[], which a branched robot (hyq)
// needs.
//
// What bounds it on the card: per-thread local memory: the joint
// transforms and the composite inertias are 72 NJ values (864 at 12
// joints), far beyond the register file, so they live in (L1-cached)
// local memory; the arithmetic is one 6x6 congruence a joint and a few
// 6x6 matvecs per ancestor. A lane reads NJ values and writes NJ^2, along
// the lane axis, so a warp's accesses are contiguous.
#include "dynamics.cuh"

#ifdef __CUDACC__

template <typename T, int NJ>
__global__ void crba_kernel(const T* __restrict__ model,
                            const T* __restrict__ q, T* __restrict__ M,
                            long long L) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const gt::Robot<T, NJ> R(model);
  T ql[NJ], m[NJ * NJ];
  gt::lane_load<T, NJ>(q, L, lane, ql);
  gt::crba_lane<T, NJ>(R, ql, m);
  gt::lane_store<T, NJ * NJ>(m, L, lane, M);
}

template <typename T, int NJ>
static int launch_crba(const void* model, const void* q, void* M, long long L,
                       cudaStream_t stream) {
  if (L == 0) return 0;
  const int block = 128;
  crba_kernel<T, NJ><<<gt_grid(L, block), block, 0, stream>>>(
      (const T*)model, (const T*)q, (T*)M, L);
  return (int)cudaGetLastError();
}

extern "C" int gridtorch_crba(int dtype, int nj, const void* model,
                              const void* q, void* M, long long L,
                              void* stream) {
  GT_DISPATCH(dtype, nj,
              launch_crba<T, NJ>(model, q, M, L, (cudaStream_t)stream));
}

#endif
