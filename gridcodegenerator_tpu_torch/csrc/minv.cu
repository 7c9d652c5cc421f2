// minv: Carpentier's direct M^-1(q), dense or the upper factor, a thread
// group per lane (knot) on fd's Minv passes.
//
// Replaces gridcodegenerator_tpu/ops/pallas/kernels.py:minv_pallas:
// q (NJ, L) -> Minv (NJ, NJ, L), dense or the upper factor (exact zeros
// below the diagonal, as the JAX minv(dense=False) returns it).
//
// A block holds G knots of LANES threads each (warp.cuh:MinvPlan: a warp a
// knot; G the largest power of 2 up to 8 that fits), runs warp.cuh:
// minv_knot, the Minv passes of fd's and fd_du's knot program
// (minv_setup_knot, minv_backward_knot, minv_forward_knot, which
// fd_qdd_knot runs too): the joint transforms a joint a thread;
// Carpentier's backward and forward passes a level of the tree a phase, an
// entry of each joint's factor row, U and F a thread; then a phase over the
// entries below the diagonal: two instances, the launcher picks one by
// `dense`: the upper factor mirrored, or +0. A tree of L levels takes
// 4 L - 1 phases (iiwa 27, hyq 11). The robot constants and the tree's
// lists are built in shared memory by all the block's threads
// (RobotConst::load_tree), and every knot's state lives there
// (warp.cuh:MinvKnot, 7 NJ^2 + 122 NJ values), indexed by the run-time
// topology without local memory. The block reads its (NJ, G) tile of q and
// writes each of the NJ^2 output rows as G consecutive lanes.
// dynamics.cuh:minv_lane is the serial function: csrc/opcount.cpp counts
// the bound from it, and the host tests hold the knot program to it (within
// 1e-9: fd's passes distribute X^T over the backward sums) and to fd_du's
// Minv bit for bit.
//
// What bounds it on the card: operations by the bound's count at large
// batches (a 7-joint lane reads 7 values, writes 49, and needs 5.2k
// operations); the design's limits are the serial phases' latency at small
// batches and, at large ones, the knots an SM holds (4.8 KB of shared memory
// a 7-joint knot in float32).
// From 47 joints in float64 no knot fits a block: the knot runs a block at
// a time, its state in device memory (minv_ws_kernel, warp.cuh:WsPlan).
// G, the threads a knot, the bytes a block and cudaFuncGetAttributes of the
// instance: `gridtorch_minv_info`.
#include "warp.cuh"

#ifdef __CUDACC__

extern __shared__ double gt_smem[];

// P: the block's shape (MinvPlan, or another KnotShape to compare)
template <typename T, int NJ, bool DENSE, class P>
__global__ void minv_kernel(const T* __restrict__ model,
                            const T* __restrict__ q, T* __restrict__ Mi,
                            long long L) {
  using O = gt::MinvKnot<NJ>;
  constexpr int N = P::LANES, S = P::STRIDE;
  auto& R = *reinterpret_cast<gt::RobotConst<T, NJ>*>(gt_smem);
  T* knots = reinterpret_cast<T*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  const int tid = threadIdx.x, nt = blockDim.x, G = nt / N;
  const long long l0 = (long long)blockIdx.x * G;
  R.load_tree(model, tid, nt);
  gt::load_q<T, NJ, S>(q, L, l0, G, knots, tid, nt);
  __syncthreads();
  gt::minv_knot<DENSE, T, NJ>(gt::WarpPar<N>{tid % N, 1 + tid / N}, R,
                              knots + (long long)(tid / N) * S);
  __syncthreads();
  gt::store_rows<T, S>(knots + O::MI, NJ * NJ, Mi, L, l0, G, tid, nt);
}

// The device-memory route (warp.cuh:WsPlan; from 47 joints in float64): a
// knot a block at a time, the robot constants in shared memory, the knot's
// state in the workspace `ws` (a knot a block), the blocks striding over
// the lanes (warp.cuh:ws_lanes).
template <typename T, int NJ, bool DENSE, class P>
__global__ void minv_ws_kernel(const T* __restrict__ model,
                               const T* __restrict__ q, T* __restrict__ Mi,
                               long long L, T* ws) {
  using O = gt::MinvKnot<NJ>;
  constexpr int N = P::LANES, S = O::SIZE;
  auto& R = *reinterpret_cast<gt::RobotConst<T, NJ>*>(gt_smem);
  T* k = ws + (long long)blockIdx.x * S;
  const int tid = threadIdx.x;
  R.load_tree(model, tid, N);
  gt::ws_lanes(
      L, [&](long long l) { gt::load_q<T, NJ, S>(q, L, l, 1, k, tid, N); },
      [&] { gt::minv_knot<DENSE, T, NJ>(gt::WarpPar<N>{tid, 1}, R, k); },
      [&](long long l) {
        gt::store_rows<T, S>(k + O::MI, NJ * NJ, Mi, L, l, 1, tid, N);
      });
}

template <typename T, int NJ, bool DENSE, class P>
static int launch_minv_mode(const void* model, const void* q, void* Mi,
                            long long L, cudaStream_t stream, void* ws,
                            long long nws) {
  if constexpr (gt::PlanWs<P>::value > 0) {
    return gt::launch_ws<P>(minv_ws_kernel<T, NJ, DENSE, P>, L, ws, nws,
                            stream, (const T*)model, (const T*)q, (T*)Mi, L,
                            (T*)ws);
  } else {
    static const cudaError_t attr =
        gt::smem_attrs(minv_kernel<T, NJ, DENSE, P>, P::BYTES);
    if (attr != cudaSuccess) return (int)attr;
    minv_kernel<T, NJ, DENSE, P><<<(unsigned)((L + P::G - 1) / P::G),
                                   P::LANES * P::G, P::BYTES, stream>>>(
        (const T*)model, (const T*)q, (T*)Mi, L);
    return (int)cudaGetLastError();
  }
}

// dense != 0: Minv dense; else the upper factor, exact zeros below.
template <typename T, int NJ, class P = gt::MinvPlan<T, NJ>>
static int launch_minv(const void* model, const void* q, void* Mi,
                       long long L, int dense, cudaStream_t stream,
                       void* ws = nullptr, long long nws = 0) {
  if (L == 0) return 0;
  if (dense)
    return launch_minv_mode<T, NJ, true, P>(model, q, Mi, L, stream, ws,
                                            nws);
  return launch_minv_mode<T, NJ, false, P>(model, q, Mi, L, stream, ws, nws);
}

// ws: the workspace of the device-memory route, nws knots, problems or
// blocks (its plan's workspace_bytes each; ops/cuda/build.py:workspace);
// ignored where the plan keeps everything in shared memory.
extern "C" int gridtorch_minv(int dtype, int nj, const void* model,
                              const void* q, void* Mi, long long L, int dense,
                              void* stream, void* ws, long long nws) {
  GT_DISPATCH(dtype, nj,
              launch_minv<T, NJ>(model, q, Mi, L, dense,
                                 (cudaStream_t)stream, ws, nws));
}

template <typename T, int NJ, class P = gt::MinvPlan<T, NJ>>
static int minv_info(int* out) {
  if constexpr (P::WS > 0)
    return gt::kernel_info<P>((const void*)minv_ws_kernel<T, NJ, true, P>,
                              out);
  else
    return gt::kernel_info<P>((const void*)minv_kernel<T, NJ, true, P>, out);
}

// The block plan (G; threads a knot; bytes a block) and
// cudaFuncGetAttributes of the dense instance (warp.cuh:kernel_info; the
// upper one's plan is the same), into out[11].
extern "C" int gridtorch_minv_info(int dtype, int nj, int* out) {
  GT_DISPATCH(dtype, nj, (minv_info<T, NJ>(out)));
}

#endif
