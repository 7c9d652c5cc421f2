// deepos: the end-effector pose Jacobian (6 ne, NJ), one thread per lane.
//
// Replaces gridcodegenerator_tpu/ops/pallas/kernels.py:deepos_pallas. EEs
// come from the packed EE buffer (ops/cuda/build.py:ee_buffer), looped at
// run time. Per EE (dynamics.cuh:ee_jac_lane), the chain form: the suffix
// products T_a+1 ... T_k-1 Tfixed of the chain's k joints, then one sweep
// that carries the prefix product and takes dT/dq_a = prefix_a . dT_a .
// suffix_a through the pose JVP. The output is allocated uninitialised, so
// the lane writes every entry: zero columns for joints off the chain, and
// all-zero rows for an EE with an empty chain.
//
// What bounds it on the card: arithmetic, three 4x4 products per chain
// joint, and the suffix products and joint transforms (32 NJ values a lane)
// in local memory. A lane reads NJ values and writes 6 ne NJ, along the
// lane axis, so a warp's accesses are contiguous.
#include "dynamics.cuh"

#ifdef __CUDACC__

template <typename T, int NJ>
__global__ void deepos_kernel(const T* __restrict__ model,
                              const T* __restrict__ ee, int ne,
                              const T* __restrict__ q, T* __restrict__ out,
                              long long L) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const gt::Robot<T, NJ> R(model);
  T ql[NJ];
  gt::lane_load<T, NJ>(q, L, lane, ql);
  gt::ee_jac_lane<T, NJ>(R, ee, ne, ql, out + lane, L);
}

template <typename T, int NJ>
static int launch_deepos(const void* model, const void* ee, int ne,
                         const void* q, void* out, long long L,
                         cudaStream_t stream) {
  if (L == 0 || ne == 0) return 0;
  const int block = 128;
  deepos_kernel<T, NJ><<<gt_grid(L, block), block, 0, stream>>>(
      (const T*)model, (const T*)ee, ne, (const T*)q, (T*)out, L);
  return (int)cudaGetLastError();
}

extern "C" int gridtorch_deepos(int dtype, int nj, const void* model,
                                const void* ee, int ne, const void* q,
                                void* out, long long L, void* stream) {
  GT_DISPATCH(dtype, nj,
              launch_deepos<T, NJ>(model, ee, ne, q, out, L,
                                   (cudaStream_t)stream));
}

#endif
