// d2eepos: the end-effector pose Hessian (6 ne, NJ, NJ), one thread per
// lane.
//
// Replaces gridcodegenerator_tpu/ops/pallas/kernels.py:d2eepos_pallas. EEs
// come from the packed EE buffer (ops/cuda/build.py:ee_buffer), looped at
// run time. Per EE (dynamics.cuh:ee_hess_lane), the chain form: the joint
// transforms, their first derivatives and the suffix products of the
// chain's k joints, then one sweep that carries the prefix product and
// takes the Jacobian's dT/dq_a and the diagonal prefix_a . d2T_a . suffix_a,
// then one sweep per chain joint a over the pairs a < b. Each pair goes
// through the closed-form second derivative of the pose extraction
// (dynamics.cuh:pose_hvp, exact atan2). The output is allocated
// uninitialised, so the lane writes every entry: zeros wherever the row or
// the column joint is off the chain, both triangles of the rest.
//
// What bounds it on the card: device memory. A lane reads NJ values and
// writes 6 ne NJ^2 (iiwa 294, dm_quadruped 6144), along the lane axis, so a
// warp's stores are contiguous; its arithmetic is four 4x4 products and one
// pose_hvp per pair, on 64 NJ values of per-thread memory.
#include "dynamics.cuh"

#ifdef __CUDACC__

template <typename T, int NJ>
__global__ void d2eepos_kernel(const T* __restrict__ model,
                               const T* __restrict__ ee, int ne,
                               const T* __restrict__ q, T* __restrict__ out,
                               long long L) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const gt::Robot<T, NJ> R(model);
  T ql[NJ];
  gt::lane_load<T, NJ>(q, L, lane, ql);
  gt::ee_hess_lane<T, NJ>(R, ee, ne, ql, out + lane, L);
}

template <typename T, int NJ>
static int launch_d2eepos(const void* model, const void* ee, int ne,
                          const void* q, void* out, long long L,
                          cudaStream_t stream) {
  if (L == 0 || ne == 0) return 0;
  const int block = 128;
  d2eepos_kernel<T, NJ><<<gt_grid(L, block), block, 0, stream>>>(
      (const T*)model, (const T*)ee, ne, (const T*)q, (T*)out, L);
  return (int)cudaGetLastError();
}

extern "C" int gridtorch_d2eepos(int dtype, int nj, const void* model,
                                 const void* ee, int ne, const void* q,
                                 void* out, long long L, void* stream) {
  GT_DISPATCH(dtype, nj,
              launch_d2eepos<T, NJ>(model, ee, ne, q, out, L,
                                    (cudaStream_t)stream));
}

#endif
