// rollout: open-loop N-step rollout with the control clamp, a group of
// threads per rollout.
//
// Replaces gridcodegenerator_tpu/ops/pallas/sweeps.py:rollout_pallas. The
// TPU kernel walked the horizon inside one grid step; here the horizon loop
// runs inside the block. Each step is u = clamp(U_t), then semi-implicit
// Euler on ABA: qd' = qd + dt qdd, q' = q + dt qd'.
//
// The kernel is the line search's block and step (csrc/sweep_warp.cuh:
// linesearch_block, linesearch_step) with the control law OpenLoop, no cost
// (NoCost) and one rollout a problem: G problems a block (RollPlan), a
// rollout a group of LANES threads, its state in shared memory; each step
// is 4 L - 1 phases for a tree of L levels (the control and the joint
// transforms a joint a thread, ABA's passes a level a phase). The block
// stages U_t of its G problems with cp.async (G lanes a row) into a second
// buffer while the step before runs, and writes X G lanes a row. What
// bounds it on the card: operations (N ABA steps a problem; bytes N 3 NJ
// values a problem); the design's limit is the step's serial phases (a
// chain of L joints is L levels), at 4-16 rollouts an SM on the main
// shapes. The plan (problems a block x threads a rollout, bytes a block):
// `gridtorch_rollout_info`. rollout_lane is the serial function:
// csrc/opcount.cpp counts the bound from it, and the host tests hold the
// block code to its bits.
//
// Layout: x0 (2 NJ, B), U (N, NJ, B), bounds (NJ) or null, X (N, 2 NJ, B)
// holding the state after each step (the caller prepends x0).
#include "sweep_warp.cuh"

namespace gt {

template <typename T, int NJ>
GT_HD void rollout_lane(const Robot<T, NJ>& R, const T* x0, const T* U,
                        const T* lo, const T* hi, T* X, int N, long long B,
                        long long b, T dt, T gravity) {
  constexpr int NX = 2 * NJ;
  T x[NX];
  for (int i = 0; i < NX; ++i) x[i] = x0[i * B + b];
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int t = 0; t < N; ++t) {
    T u[NJ];
    for (int i = 0; i < NJ; ++i)
      u[i] = clamp_bounds(U[((long long)t * NJ + i) * B + b], lo, hi, i);
    euler_step(R, x, u, dt, gravity);
    for (int i = 0; i < NX; ++i) X[((long long)t * NX + i) * B + b] = x[i];
  }
}

}  // namespace gt

#ifdef __CUDACC__

extern __shared__ double gt_smem[];

// P: the block's shape (RollPlan, or another RollShape to compare)
template <typename T, int NJ, class P>
__global__ void rollout_kernel(const T* __restrict__ model,
                               const T* __restrict__ x0,
                               const T* __restrict__ U,
                               const T* __restrict__ lo,
                               const T* __restrict__ hi, T* __restrict__ X,
                               int N, long long B, T dt, T gravity) {
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
      gt::OpenLoop<T, NJ>{U}, X, nullptr, nullptr, N, B, 1, dt, gravity);
}

template <typename T, int NJ, class P>
static int launch_rollout(const void* model, const void* x0, const void* U,
                          const void* lo, const void* hi, void* X, int N,
                          long long B, double dt, double gravity,
                          cudaStream_t stream) {
  static_assert(!P::TILES_WS, "the open-loop rollout's tiles fit a block");
  if (B == 0 || N == 0) return 0;
  static const cudaError_t attr =
      gt::smem_attrs(rollout_kernel<T, NJ, P>, P::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  rollout_kernel<T, NJ, P><<<(unsigned)((B + P::G - 1) / P::G),
                             P::G * P::LANES, P::BYTES, stream>>>(
      (const T*)model, (const T*)x0, (const T*)U, (const T*)lo,
      (const T*)hi, (T*)X, N, B, (T)dt, (T)gravity);
  return (int)cudaGetLastError();
}

extern "C" int gridtorch_rollout(int dtype, int nj, const void* model,
                                 const void* x0, const void* U,
                                 const void* lo, const void* hi, void* X,
                                 int N, long long B, double dt,
                                 double gravity, void* stream) {
  GT_DISPATCH(dtype, nj,
              (launch_rollout<T, NJ, gt::RollPlan<T, NJ>>(
                  model, x0, U, lo, hi, X, N, B, dt, gravity,
                  (cudaStream_t)stream)));
}

// The block plan (problems a block; threads a rollout; bytes a block) and
// cudaFuncGetAttributes of the instance (warp.cuh:kernel_info), into
// out[10].
extern "C" int gridtorch_rollout_info(int dtype, int nj, int* out) {
  GT_DISPATCH(dtype, nj,
              gt::kernel_info<gt::RollPlan<T, NJ>>(
                  (const void*)rollout_kernel<T, NJ, gt::RollPlan<T, NJ>>,
                  out));
}

#endif
