// fd_du: the fused forward-dynamics gradient, one knot (lane) a warp.
//
// Replaces gridcodegenerator_tpu/ops/pallas/kernels.py:fd_du_pallas
// (with_extras=True): (q, qd, u) (NJ, L) -> df_du (NJ, 2 NJ, L), qdd (NJ, L),
// Minv (NJ, NJ, L).
//
// A block holds G knots (warp.cuh:fd_du_knot), a warp each (a half warp up
// to 8 joints; 2 or 4 times that where it puts more knots or warps on an
// SM, warp.cuh:BlockPlan): the joint transforms a joint a thread; the RNEA
// passes a level of the tree a phase, a row of each joint's 6-vectors a
// thread; Carpentier's Minv a level a phase, parallel over the NJ columns
// of F and M and the 36 entries of the IA update; qdd = Minv (u - c) a row
// a thread; the ID gradient a column a thread, the q columns then the qd
// ones, each walking only its column joint's subtree and root path; df/du
// = -Minv dc/du, a column a thread on CUDA cores. The robot constants are
// copied into shared memory once per block, and every knot's state lives
// there (warp.cuh:FDKnot), indexed by the run-time topology without local
// memory. The block reads its (NJ, G) input tiles and writes each output
// row as G consecutive lanes.
//
// What bounds it on the card: operations (20k a 7-joint lane, the bound's
// count); the design's limits are the serial phases' latency (the phases
// split by __syncwarp) and the knots shared memory holds on an SM. G puts
// the most knots on an SM (warp.cuh:BlockPlan); a knot holds about
// 21 NJ^2 + 65 NJ values, 1.5k at 7 joints (6 KB float32), 6.4k at 16
// (26 KB float32, 51 KB float64);
// G, the threads a knot, the bytes a block and cudaFuncGetAttributes of
// each instance: `gridtorch_fd_du_info`. The plans (G x threads a knot,
// bytes a block), float32 | float64:
//   2 joints   8 x 16, 11680  | 6 x 16, 18272
//   7 joints   8 x 16, 51968  | 8 x 32, 101936
//   8 joints   7 x 32, 56272  | 7 x 32, 111536
//   12 joints  7 x 32, 113200 | 7 x 64, 224928
//   16 joints  8 x 64, 213968 | 4 x 128, 221264
// Above 32 joints a knot takes 64 threads or more (a thread a column of a
// pass); from 47 joints in float32 (33 in float64) no knot fits a block,
// and the knot runs on the device-memory route (fd_du_ws_kernel).
#include "warp.cuh"

#ifdef __CUDACC__

extern __shared__ double gt_smem[];

template <typename T, int NJ>
__global__ void fd_du_kernel(const T* __restrict__ model,
                             const T* __restrict__ q,
                             const T* __restrict__ qd,
                             const T* __restrict__ u, T* __restrict__ dfdu,
                             T* __restrict__ qdd, T* __restrict__ Mi,
                             long long L, T gravity) {
  using O = gt::FDKnot<NJ>;
  using P = gt::FDPlan<T, NJ>;
  constexpr int N = P::LANES, S = P::STRIDE;
  auto& R = *reinterpret_cast<gt::RobotConst<T, NJ>*>(gt_smem);
  T* knots = reinterpret_cast<T*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  const int tid = threadIdx.x, nt = blockDim.x, G = nt / N;
  const long long l0 = (long long)blockIdx.x * G;
  R.load(model, tid, nt);
  gt::load_inputs<T, NJ, S>(q, qd, u, L, l0, G, knots, tid, nt);
  __syncthreads();
  gt::fd_du_knot<T, NJ>(gt::WarpPar<N>{tid % N, 1 + tid / N}, R,
                        knots + (long long)(tid / N) * S, gravity);
  __syncthreads();
  gt::store_rows<T, S>(knots + O::DFDU, 2 * NJ * NJ, dfdu, L, l0, G, tid, nt);
  gt::store_rows<T, S>(knots + O::QDD, NJ, qdd, L, l0, G, tid, nt);
  gt::store_rows<T, S>(knots + O::MI, NJ * NJ, Mi, L, l0, G, tid, nt);
}

// The device-memory route (warp.cuh:WsPlan; from 47 joints in float32, 33
// in float64): a knot a block at a time, the robot constants in shared
// memory, the knot's state in the workspace `ws` (a knot a block), the
// blocks striding over the lanes (warp.cuh:ws_lanes).
template <typename T, int NJ>
__global__ void fd_du_ws_kernel(const T* __restrict__ model,
                                const T* __restrict__ q,
                                const T* __restrict__ qd,
                                const T* __restrict__ u, T* __restrict__ dfdu,
                                T* __restrict__ qdd, T* __restrict__ Mi,
                                long long L, T gravity, T* ws) {
  using O = gt::FDKnot<NJ>;
  constexpr int N = gt::FDPlan<T, NJ>::LANES, S = O::SIZE;
  auto& R = *reinterpret_cast<gt::RobotConst<T, NJ>*>(gt_smem);
  T* k = ws + (long long)blockIdx.x * S;
  const int tid = threadIdx.x;
  R.load(model, tid, N);
  gt::ws_lanes(
      L,
      [&](long long l) {
        gt::load_inputs<T, NJ, S>(q, qd, u, L, l, 1, k, tid, N);
      },
      [&] { gt::fd_du_knot<T, NJ>(gt::WarpPar<N>{tid, 1}, R, k, gravity); },
      [&](long long l) {
        gt::store_rows<T, S>(k + O::DFDU, 2 * NJ * NJ, dfdu, L, l, 1, tid, N);
        gt::store_rows<T, S>(k + O::QDD, NJ, qdd, L, l, 1, tid, N);
        gt::store_rows<T, S>(k + O::MI, NJ * NJ, Mi, L, l, 1, tid, N);
      });
}

template <typename T, int NJ>
static int launch_fd_du(const void* model, const void* q, const void* qd,
                        const void* u, void* dfdu, void* qdd, void* Mi,
                        long long L, double gravity, cudaStream_t stream,
                        void* ws = nullptr, long long nws = 0) {
  using P = gt::FDPlan<T, NJ>;
  if constexpr (P::WS > 0) {
    return gt::launch_ws<P>(fd_du_ws_kernel<T, NJ>, L, ws, nws, stream,
                            (const T*)model, (const T*)q, (const T*)qd,
                            (const T*)u, (T*)dfdu, (T*)qdd, (T*)Mi, L,
                            (T)gravity, (T*)ws);
  } else {
    if (L == 0) return 0;
    static const cudaError_t attr = cudaFuncSetAttribute(
        fd_du_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)P::BYTES);
    if (attr != cudaSuccess) return (int)attr;
    fd_du_kernel<T, NJ><<<(unsigned)((L + P::G - 1) / P::G),
                          P::LANES * P::G, P::BYTES, stream>>>(
        (const T*)model, (const T*)q, (const T*)qd, (const T*)u, (T*)dfdu,
        (T*)qdd, (T*)Mi, L, (T)gravity);
    return (int)cudaGetLastError();
  }
}

template <typename T, int NJ>
static int fd_du_info(int* out) {
  using P = gt::FDPlan<T, NJ>;
  if constexpr (P::WS > 0)
    return gt::kernel_info<P>((const void*)fd_du_ws_kernel<T, NJ>, out);
  else
    return gt::kernel_info<P>((const void*)fd_du_kernel<T, NJ>, out);
}

extern "C" int gridtorch_model_size(int nj) {
  return nj == GT_NJ ? gt::Layout<GT_NJ>::SIZE : -1;
}

// ws: the workspace of the device-memory route, nws knots, problems or
// blocks (its plan's workspace_bytes each; ops/cuda/build.py:workspace);
// ignored where the plan keeps everything in shared memory.
extern "C" int gridtorch_fd_du(int dtype, int nj, const void* model,
                               const void* q, const void* qd, const void* u,
                               void* dfdu, void* qdd, void* Mi, long long L,
                               double gravity, void* stream,
                               void* ws, long long nws) {
  GT_DISPATCH(dtype, nj,
              launch_fd_du<T, NJ>(model, q, qd, u, dfdu, qdd, Mi, L, gravity,
                                  (cudaStream_t)stream, ws, nws));
}

// The block plan (G; threads a knot; bytes a block) and
// cudaFuncGetAttributes of the instance (warp.cuh:kernel_info), into
// out[10].
extern "C" int gridtorch_fd_du_info(int dtype, int nj, int* out) {
  GT_DISPATCH(dtype, nj, (fd_du_info<T, NJ>(out)));
}

#endif
