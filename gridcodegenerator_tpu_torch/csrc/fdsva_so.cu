// fdsva_so: second-order forward dynamics (4, NJ, NJ, NJ) per lane,
// [d2qdd/dq2, d2qdd/dqd2, d2qdd/dqd dq, dMinv/dq]; one thread per lane.
//
// Replaces gridcodegenerator_tpu/ops/pallas/kernels.py:fdsva_so_pallas, the
// monolithic route the JAX package takes for nv <= 16 (2, 7 and 12 joints
// here). Per lane (so.cuh:fdsva_so_lane): the fd_du lane code (df/du, qdd
// and Minv, dynamics.cuh:fd_du_lane, shared with csrc/fd_du.cu), the
// idsva_so lane code at (q, qd, qdd) into a scratch the wrapper allocates
// (the output's size), then the implicit-function contractions of
// ops/so.py:fdsva_compose from the scratch into the output.
//
// What bounds it on the card: device-memory traffic, as in idsva_so, now
// twice over: the scratch is written and updated by the IDSVA-SO stages and
// read back by the contractions, which read the dM slice (NJ^3) once and
// update the output in place; their n^4 multiply-adds per tensor run on
// df/du and Minv held in per-thread memory. In the solver the lanes are
// the N B knots, knot-major, so a warp's accesses are contiguous.
//
// Layout: q, qd, u (NJ, L); out and scratch (4, NJ, NJ, NJ, L).
#include "so.cuh"

#ifdef __CUDACC__

template <typename T, int NJ>
__global__ void fdsva_so_kernel(const T* __restrict__ model,
                                const T* __restrict__ q,
                                const T* __restrict__ qd,
                                const T* __restrict__ u, T* __restrict__ out,
                                T* __restrict__ scratch, long long L,
                                T gravity) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const gt::Robot<T, NJ> R(model);
  T ql[NJ], qdl[NJ], ul[NJ];
  gt::lane_load<T, NJ>(q, L, lane, ql);
  gt::lane_load<T, NJ>(qd, L, lane, qdl);
  gt::lane_load<T, NJ>(u, L, lane, ul);
  gt::fdsva_so_lane<T, NJ>(R, ql, qdl, ul, gravity, out + lane,
                           scratch + lane, L);
}

template <typename T, int NJ>
static int launch_fdsva_so(const void* model, const void* q, const void* qd,
                           const void* u, void* out, void* scratch,
                           long long L, double gravity, cudaStream_t stream) {
  if (L == 0) return 0;
  const int block = 64;
  fdsva_so_kernel<T, NJ><<<gt_grid(L, block), block, 0, stream>>>(
      (const T*)model, (const T*)q, (const T*)qd, (const T*)u, (T*)out,
      (T*)scratch, L, (T)gravity);
  return (int)cudaGetLastError();
}

extern "C" int gridtorch_fdsva_so(int dtype, int nj, const void* model,
                                  const void* q, const void* qd,
                                  const void* u, void* out, void* scratch,
                                  long long L, double gravity, void* stream) {
  GT_DISPATCH(dtype, nj,
              launch_fdsva_so<T, NJ>(model, q, qd, u, out, scratch, L,
                                     gravity, (cudaStream_t)stream));
}

#endif
