// fd: forward dynamics via the Minv route, qdd = Minv (u - c), a thread
// group per lane (knot) on fd_du's bias and Minv passes.
//
// Replaces gridcodegenerator_tpu/ops/pallas/kernels.py:fd_pallas:
// (q, qd, u) (NJ, L) -> qdd (NJ, L).
//
// A block holds G knots of LANES threads each (warp.cuh:FDPlanQ: a warp a
// knot; G the largest power of 2 up to 8 that fits), runs warp.cuh:fd_knot,
// the first half of fd_du's knot program (warp.cuh:fd_qdd_knot, which fd_du
// runs too): the joint transforms a joint a thread; the bias RNEA, a level
// of the tree a phase, a row of each joint's 6-vectors a thread;
// Carpentier's Minv, its backward and forward passes a level a phase, an
// entry of each joint's factor rows, U and F a thread; then qdd a joint a
// thread from the upper factor: 6 L phases for a tree of L levels (iiwa 42,
// hyq 18, atlas 54). The robot
// constants and the tree's lists are built in shared memory by all the
// block's threads (RobotConst::load_tree), and every knot's state lives
// there (warp.cuh:FDQKnot, 7 NJ^2 + 150 NJ values), indexed by the run-time
// topology without local memory. The block reads its three (NJ, G) input
// tiles and writes qdd as G consecutive lanes a row. dynamics.cuh:fd_lane
// is the serial function: csrc/opcount.cpp counts the bound from it, and
// the host tests hold the knot program to it.
//
// What bounds it on the card: operations by the bound's count at large
// batches (a 7-joint lane reads 21 values, writes 7, and needs 6.5k
// operations); the design's limits are the serial phases' latency at small
// batches and, at large ones, the knots an SM holds (5.6 KB of shared memory
// a 7-joint knot in float32).
// From 46 joints in float64 no knot fits a block: the knot runs a block at
// a time, its state in device memory (fd_ws_kernel, warp.cuh:WsPlan).
// G, the threads a knot, the bytes a block and cudaFuncGetAttributes of the
// instance: `gridtorch_fd_info`.
#include "warp.cuh"

#ifdef __CUDACC__

extern __shared__ double gt_smem[];

// P: the block's shape (FDPlanQ, or another KnotShape to compare)
template <typename T, int NJ, class P>
__global__ void fd_kernel(const T* __restrict__ model,
                          const T* __restrict__ q, const T* __restrict__ qd,
                          const T* __restrict__ u, T* __restrict__ qdd,
                          long long L, T gravity) {
  using O = gt::FDQKnot<NJ>;
  constexpr int N = P::LANES, S = P::STRIDE;
  auto& R = *reinterpret_cast<gt::RobotConst<T, NJ>*>(gt_smem);
  T* knots = reinterpret_cast<T*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  const int tid = threadIdx.x, nt = blockDim.x, G = nt / N;
  const long long l0 = (long long)blockIdx.x * G;
  R.load_tree(model, tid, nt);
  gt::load_inputs<T, NJ, S>(q, qd, u, L, l0, G, knots, tid, nt);
  __syncthreads();
  gt::fd_knot<T, NJ>(gt::WarpPar<N>{tid % N, 1 + tid / N}, R,
                     knots + (long long)(tid / N) * S, gravity);
  __syncthreads();
  gt::store_rows<T, S>(knots + O::QDD, NJ, qdd, L, l0, G, tid, nt);
}

// The device-memory route (warp.cuh:WsPlan; from 46 joints in float64): a
// knot a block at a time, the robot constants in shared memory, the knot's
// state in the workspace `ws` (a knot a block), the blocks striding over
// the lanes (warp.cuh:ws_lanes).
template <typename T, int NJ, class P>
__global__ void fd_ws_kernel(const T* __restrict__ model,
                             const T* __restrict__ q,
                             const T* __restrict__ qd,
                             const T* __restrict__ u, T* __restrict__ qdd,
                             long long L, T gravity, T* ws) {
  using O = gt::FDQKnot<NJ>;
  constexpr int N = P::LANES, S = O::SIZE;
  auto& R = *reinterpret_cast<gt::RobotConst<T, NJ>*>(gt_smem);
  T* k = ws + (long long)blockIdx.x * S;
  const int tid = threadIdx.x;
  R.load_tree(model, tid, N);
  gt::ws_lanes(
      L,
      [&](long long l) {
        gt::load_inputs<T, NJ, S>(q, qd, u, L, l, 1, k, tid, N);
      },
      [&] { gt::fd_knot<T, NJ>(gt::WarpPar<N>{tid, 1}, R, k, gravity); },
      [&](long long l) {
        gt::store_rows<T, S>(k + O::QDD, NJ, qdd, L, l, 1, tid, N);
      });
}

template <typename T, int NJ, class P = gt::FDPlanQ<T, NJ>>
static int launch_fd(const void* model, const void* q, const void* qd,
                     const void* u, void* qdd, long long L, double gravity,
                     cudaStream_t stream, void* ws = nullptr,
                     long long nws = 0) {
  if constexpr (gt::PlanWs<P>::value > 0) {
    return gt::launch_ws<P>(fd_ws_kernel<T, NJ, P>, L, ws, nws, stream,
                            (const T*)model, (const T*)q, (const T*)qd,
                            (const T*)u, (T*)qdd, L, (T)gravity, (T*)ws);
  } else {
    if (L == 0) return 0;
    static const cudaError_t attr = gt::smem_attrs(fd_kernel<T, NJ, P>,
                                                   P::BYTES);
    if (attr != cudaSuccess) return (int)attr;
    fd_kernel<T, NJ, P><<<(unsigned)((L + P::G - 1) / P::G),
                          P::LANES * P::G, P::BYTES, stream>>>(
        (const T*)model, (const T*)q, (const T*)qd, (const T*)u, (T*)qdd, L,
        (T)gravity);
    return (int)cudaGetLastError();
  }
}

// ws: the workspace of the device-memory route, nws knots, problems or
// blocks (its plan's workspace_bytes each; ops/cuda/build.py:workspace);
// ignored where the plan keeps everything in shared memory.
extern "C" int gridtorch_fd(int dtype, int nj, const void* model,
                            const void* q, const void* qd, const void* u,
                            void* qdd, long long L, double gravity,
                            void* stream, void* ws, long long nws) {
  GT_DISPATCH(dtype, nj,
              launch_fd<T, NJ>(model, q, qd, u, qdd, L, gravity,
                               (cudaStream_t)stream, ws, nws));
}

template <typename T, int NJ, class P = gt::FDPlanQ<T, NJ>>
static int fd_info(int* out) {
  if constexpr (P::WS > 0)
    return gt::kernel_info<P>((const void*)fd_ws_kernel<T, NJ, P>, out);
  else
    return gt::kernel_info<P>((const void*)fd_kernel<T, NJ, P>, out);
}

// The block plan (G; threads a knot; bytes a block) and
// cudaFuncGetAttributes of the instance (warp.cuh:kernel_info), into
// out[11].
extern "C" int gridtorch_fd_info(int dtype, int nj, int* out) {
  GT_DISPATCH(dtype, nj, (fd_info<T, NJ>(out)));
}

#endif
