// feedback_rollout: the closed-loop N-step rollout of one step size, a group
// of threads per rollout.
//
// Replaces gridcodegenerator_tpu/ops/pallas/sweeps.py:feedback_rollout_pallas.
// u_t = clamp(Uref_t + kff_t + K_t (x_t - Xref_t)), the step size folded
// into kff; then one semi-implicit Euler step on ABA.
//
// The kernel is the line search's block and step (csrc/sweep_warp.cuh:
// linesearch_block, linesearch_step) with the line search's control law at
// a step size of exactly 1 (FoldedStepLaw: no tensor of step sizes), no
// cost (NoCost) and one rollout a problem, as csrc/rollout.cu runs the
// open-loop rollout: G problems a block (FBPlan), a rollout a group of
// LANES threads, its state in shared memory; each step is 4 L - 1 phases
// for a tree of L levels. The block stages K_t, Xref_t, Uref_t and kff_t of
// its G problems (2 NJ^2 + 4 NJ values a problem) with cp.async (G lanes a
// row) into a second buffer while the step before runs, and writes X and
// U G lanes a row. With kff = alpha k (alpha a power of 2, so the fold is
// exact) the rollout is the line search's alpha row, bit for bit: the same
// code computes both. What bounds it on the card: the bytes of K (N 2 NJ^2
// values a problem) against N ABA steps; the design's limit is the step's
// serial phases, as the rollout's. Above 52 joints in float64 the block's
// tiles go to device memory (feedback_rollout_ws_kernel, sweep_warp.cuh:
// RollShape's TILES_WS). The plan: `gridtorch_feedback_rollout_info`.
// feedback_rollout_lane is the serial function: csrc/opcount.cpp counts
// the bound from it, and the host tests hold the block code to its bits.
//
// Layout: x0 (2 NJ, B), Uref/kff (N, NJ, B), Xref (N, 2 NJ, B),
// K (N, NJ, 2 NJ, B), bounds (NJ) or null; X (N, 2 NJ, B) holding the state
// after each step, U (N, NJ, B) the clamped controls.
#include "sweep_warp.cuh"

namespace gt {

template <typename T, int NJ>
GT_HD void feedback_rollout_lane(const Robot<T, NJ>& R, const T* x0,
                                 const T* Uref, const T* Xref, const T* kff,
                                 const T* K, const T* lo, const T* hi, T* X,
                                 T* U, int N, long long B, long long b, T dt,
                                 T gravity) {
  constexpr int NX = 2 * NJ;
  T x[NX];
  for (int i = 0; i < NX; ++i) x[i] = x0[i * B + b];
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int t = 0; t < N; ++t) {
    T u[NJ];
    feedback_u<T, NJ>(x, Uref, Xref, kff, K, T(1), lo, hi, t, B, b, u);
    euler_step(R, x, u, dt, gravity);
    for (int i = 0; i < NX; ++i) X[((long long)t * NX + i) * B + b] = x[i];
    for (int j = 0; j < NJ; ++j) U[((long long)t * NJ + j) * B + b] = u[j];
  }
}

}  // namespace gt

#ifdef __CUDACC__

extern __shared__ double gt_smem[];

// P: the block's shape (FBPlan, or another RollShape to compare)
template <typename T, int NJ, class P>
__global__ void feedback_rollout_kernel(
    const T* __restrict__ model, const T* __restrict__ x0,
    const T* __restrict__ Uref, const T* __restrict__ Xref,
    const T* __restrict__ kff, const T* __restrict__ K,
    const T* __restrict__ lo, const T* __restrict__ hi, T* __restrict__ X,
    T* __restrict__ U, int N, long long B, T dt, T gravity) {
  constexpr int W = P::LANES;
  auto& H = *reinterpret_cast<gt::LSHead<T, NJ>*>(gt_smem);
  T* tiles = reinterpret_cast<T*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  T* rolls = tiles + 2 * P::G * P::TILE;
  const int tid = threadIdx.x, nt = blockDim.x;
  H.load(model, nullptr, 0, lo, hi, tid, nt);
  __syncthreads();
  gt::linesearch_block<T, NJ, gt::NoCost<T, NJ>, P::G>(
      gt::WarpPar<W>{tid % W, 1 + tid / W}, tid, nt, tid / W, H, tiles,
      P::TILE, rolls, P::STRIDE, 1, (long long)blockIdx.x * P::G, 0, x0,
      gt::FoldedStepLaw<T, NJ>{{Uref, Xref, kff, K, nullptr}}, X, U, nullptr,
      N, B, 1, dt, gravity);
}

// The tiles in device memory (RollShape's TILES_WS; above 52 joints in
// float64): nws blocks, each with its two buffers of G tiles at its place
// in the workspace `ws`, striding over the groups of G problems.
template <typename T, int NJ, class P>
__global__ void feedback_rollout_ws_kernel(
    const T* __restrict__ model, const T* __restrict__ x0,
    const T* __restrict__ Uref, const T* __restrict__ Xref,
    const T* __restrict__ kff, const T* __restrict__ K,
    const T* __restrict__ lo, const T* __restrict__ hi, T* __restrict__ X,
    T* __restrict__ U, int N, long long B, T dt, T gravity, T* ws) {
  constexpr int W = P::LANES;
  auto& H = *reinterpret_cast<gt::LSHead<T, NJ>*>(gt_smem);
  T* rolls = reinterpret_cast<T*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  T* tiles = ws + (long long)blockIdx.x * 2 * P::G * P::TILE;
  const int tid = threadIdx.x, nt = blockDim.x;
  H.load(model, nullptr, 0, lo, hi, tid, nt);
  for (long long b0 = (long long)blockIdx.x * P::G; b0 < B;
       b0 += (long long)gridDim.x * P::G) {
    __syncthreads();   // the head has landed; the last group's rows are out
    gt::linesearch_block<T, NJ, gt::NoCost<T, NJ>, P::G, false>(
        gt::WarpPar<W>{tid % W, 1 + tid / W}, tid, nt, tid / W, H, tiles,
        P::TILE, rolls, P::STRIDE, 1, b0, 0, x0,
        gt::FoldedStepLaw<T, NJ>{{Uref, Xref, kff, K, nullptr}}, X, U,
        nullptr, N, B, 1, dt, gravity);
  }
}

template <typename T, int NJ, class P>
static int launch_feedback_rollout(const void* model, const void* x0,
                                   const void* Uref, const void* Xref,
                                   const void* kff, const void* K,
                                   const void* lo, const void* hi, void* X,
                                   void* U, int N, long long B, double dt,
                                   double gravity, cudaStream_t stream,
                                   void* ws = nullptr, long long nws = 0) {
  if (B == 0 || N == 0) return 0;
  const long long groups = (B + P::G - 1) / P::G;
  if constexpr (P::TILES_WS) {
    if (ws == nullptr || nws < 1) return (int)cudaErrorInvalidValue;
    static const cudaError_t attr =
        gt::smem_attrs(feedback_rollout_ws_kernel<T, NJ, P>, P::BYTES);
    if (attr != cudaSuccess) return (int)attr;
    feedback_rollout_ws_kernel<T, NJ, P>
        <<<(unsigned)(nws < groups ? nws : groups), P::G * P::LANES,
           P::BYTES, stream>>>(
            (const T*)model, (const T*)x0, (const T*)Uref, (const T*)Xref,
            (const T*)kff, (const T*)K, (const T*)lo, (const T*)hi, (T*)X,
            (T*)U, N, B, (T)dt, (T)gravity, (T*)ws);
  } else {
    static const cudaError_t attr =
        gt::smem_attrs(feedback_rollout_kernel<T, NJ, P>, P::BYTES);
    if (attr != cudaSuccess) return (int)attr;
    feedback_rollout_kernel<T, NJ, P><<<(unsigned)groups, P::G * P::LANES,
                                        P::BYTES, stream>>>(
        (const T*)model, (const T*)x0, (const T*)Uref, (const T*)Xref,
        (const T*)kff, (const T*)K, (const T*)lo, (const T*)hi, (T*)X,
        (T*)U, N, B, (T)dt, (T)gravity);
  }
  return (int)cudaGetLastError();
}

// ws: the workspace of the device-memory route, nws knots, problems or
// blocks (its plan's workspace_bytes each; ops/cuda/build.py:workspace);
// ignored where the plan keeps everything in shared memory.
extern "C" int gridtorch_feedback_rollout(
    int dtype, int nj, const void* model, const void* x0, const void* Uref,
    const void* Xref, const void* kff, const void* K, const void* lo,
    const void* hi, void* X, void* U, int N, long long B, double dt,
    double gravity, void* stream, void* ws, long long nws) {
  GT_DISPATCH(dtype, nj,
              (launch_feedback_rollout<T, NJ, gt::FBPlan<T, NJ>>(
                  model, x0, Uref, Xref, kff, K, lo, hi, X, U, N, B, dt,
                  gravity, (cudaStream_t)stream, ws, nws)));
}

template <typename T, int NJ, class P = gt::FBPlan<T, NJ>>
static int feedback_rollout_info(int* out) {
  if constexpr (P::TILES_WS)
    return gt::kernel_info<P>(
        (const void*)feedback_rollout_ws_kernel<T, NJ, P>, out);
  else
    return gt::kernel_info<P>((const void*)feedback_rollout_kernel<T, NJ, P>,
                              out);
}

// The block plan (problems a block; threads a rollout; bytes a block) and
// cudaFuncGetAttributes of the instance (warp.cuh:kernel_info), into
// out[10].
extern "C" int gridtorch_feedback_rollout_info(int dtype, int nj, int* out) {
  GT_DISPATCH(dtype, nj, (feedback_rollout_info<T, NJ>(out)));
}

#endif
