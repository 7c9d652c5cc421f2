// eepos: end-effector poses [x, y, z, roll, pitch, yaw], one thread per
// lane.
//
// Replaces gridcodegenerator_tpu/ops/pallas/kernels.py:eepos_pallas. The
// EEs come from the packed EE buffer (ops/cuda/build.py:ee_buffer), one row
// per EE (its fixed frame and chain mask), looped at run time, so one
// instance per joint count serves every choice of targets. Per EE
// (dynamics.cuh:ee_pose_lane): the chain product of the joint transforms,
// then the fixed frame, then the extraction with the hardware atan2 (the
// TPU kernel needed a polynomial one).
//
// What bounds it on the card: arithmetic (a 4x4 product and a sin/cos pair
// per chain joint, three atan2 per EE); a lane keeps two 4x4 transforms
// live, so it fits in registers. A lane reads NJ values and writes 6 ne,
// along the lane axis, so a warp's accesses are contiguous.
#include "dynamics.cuh"

#ifdef __CUDACC__

template <typename T, int NJ>
__global__ void eepos_kernel(const T* __restrict__ model,
                             const T* __restrict__ ee, int ne,
                             const T* __restrict__ q, T* __restrict__ out,
                             long long L) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const gt::Robot<T, NJ> R(model);
  T ql[NJ];
  gt::lane_load<T, NJ>(q, L, lane, ql);
  gt::ee_pose_lane<T, NJ>(R, ee, ne, ql, out + lane, L);
}

template <typename T, int NJ>
static int launch_eepos(const void* model, const void* ee, int ne,
                        const void* q, void* out, long long L,
                        cudaStream_t stream) {
  if (L == 0 || ne == 0) return 0;
  const int block = 128;
  eepos_kernel<T, NJ><<<gt_grid(L, block), block, 0, stream>>>(
      (const T*)model, (const T*)ee, ne, (const T*)q, (T*)out, L);
  return (int)cudaGetLastError();
}

extern "C" int gridtorch_eepos(int dtype, int nj, const void* model,
                               const void* ee, int ne, const void* q,
                               void* out, long long L, void* stream) {
  GT_DISPATCH(dtype, nj,
              launch_eepos<T, NJ>(model, ee, ne, q, out, L,
                                  (cudaStream_t)stream));
}

#endif
