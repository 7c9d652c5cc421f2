// idsva_so: second-order inverse dynamics (4, NJ, NJ, NJ) per lane,
// [d2tau/dq2, d2tau/dqd2, d2tau/dqd dq, dM/dq]; one thread per lane.
//
// Replaces gridcodegenerator_tpu/ops/pallas/kernels.py:idsva_so_pallas. The
// TPU kernel traced the analytical algorithm into one Pallas body per lane
// tile, its (joint, ancestor, subtree) loops unrolled at trace time into
// (8, 128) vector operations, and chunked large robots with lax.map to fit
// VMEM. Here each thread runs so.cuh:idsva_so_lane: the stage quantities in
// per-thread memory, then the nine stages and the p-corrections with
// ancestors and subtrees read at run time from the packed subtree mask.
//
// What bounds it on the card: device-memory traffic. A lane writes 4 NJ^3
// values (1372 at 7 joints, 6912 at 12) and updates many of them in place,
// far more than it reads (3 NJ); its arithmetic (about 100 6-vector
// products per (joint, ancestor, subtree) triple) runs on a per-thread
// stack of NJ 6x6 inertias and 6-vectors. The design keeps every access
// coalesced (lane-major, a warp's 32 lanes on 32 neighbouring addresses),
// forms the D1-D4 operators where they are used instead of storing four
// 6x6 matrices per joint, and keeps the stage loops rolled (one body,
// switch on the stage) so the code stays small.
//
// Layout: q, qd, qdd (NJ, L); out (4, NJ, NJ, NJ, L).
#include "so.cuh"

#ifdef __CUDACC__

template <typename T, int NJ>
__global__ void idsva_so_kernel(const T* __restrict__ model,
                                const T* __restrict__ q,
                                const T* __restrict__ qd,
                                const T* __restrict__ qdd,
                                T* __restrict__ out, long long L, T gravity) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const gt::Robot<T, NJ> R(model);
  T ql[NJ], qdl[NJ], qddl[NJ];
  gt::lane_load<T, NJ>(q, L, lane, ql);
  gt::lane_load<T, NJ>(qd, L, lane, qdl);
  gt::lane_load<T, NJ>(qdd, L, lane, qddl);
  gt::idsva_so_lane<T, NJ>(R, ql, qdl, qddl, gravity, out + lane, L);
}

template <typename T, int NJ>
static int launch_idsva_so(const void* model, const void* q, const void* qd,
                           const void* qdd, void* out, long long L,
                           double gravity, cudaStream_t stream) {
  if (L == 0) return 0;
  const int block = 64;
  idsva_so_kernel<T, NJ><<<gt_grid(L, block), block, 0, stream>>>(
      (const T*)model, (const T*)q, (const T*)qd, (const T*)qdd, (T*)out, L,
      (T)gravity);
  return (int)cudaGetLastError();
}

extern "C" int gridtorch_idsva_so(int dtype, int nj, const void* model,
                                  const void* q, const void* qd,
                                  const void* qdd, void* out, long long L,
                                  double gravity, void* stream) {
  GT_DISPATCH(dtype, nj,
              launch_idsva_so<T, NJ>(model, q, qd, qdd, out, L, gravity,
                                     (cudaStream_t)stream));
}

#endif
