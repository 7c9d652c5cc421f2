// feedback_rollout: the closed-loop N-step rollout of one step size, one
// thread per problem.
//
// Replaces gridcodegenerator_tpu/ops/pallas/sweeps.py:feedback_rollout_pallas.
// u_t = clamp(Uref_t + kff_t + K_t (x_t - Xref_t)), the step size folded
// into kff; then one semi-implicit Euler step on ABA. The control law
// (dynamics.cuh:feedback_u) and the step (dynamics.cuh:euler_step) are the
// ones the line search (csrc/linesearch.cu) and the open-loop rollout
// (csrc/rollout.cu) run, so the three sweeps cannot drift: with kff = k this
// lane is the line search's alpha = 1 row. The horizon loop runs inside the
// thread and the state stays in per-thread memory, as in rollout.cu.
//
// What bounds it on the card: the serial horizon (N dependent ABA steps per
// thread) at low occupancy; a lane reads N (NJ + 2 NJ + NJ + 2 NJ^2) values
// and writes N (2 NJ + NJ), along the problem axis.
//
// Layout: x0 (2 NJ, B), Uref/kff (N, NJ, B), Xref (N, 2 NJ, B),
// K (N, NJ, 2 NJ, B), bounds (NJ) or null; X (N, 2 NJ, B) holding the state
// after each step, U (N, NJ, B) the clamped controls.
#include "dynamics.cuh"

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

template <typename T, int NJ>
__global__ void feedback_rollout_kernel(
    const T* __restrict__ model, const T* __restrict__ x0,
    const T* __restrict__ Uref, const T* __restrict__ Xref,
    const T* __restrict__ kff, const T* __restrict__ K,
    const T* __restrict__ lo, const T* __restrict__ hi, T* __restrict__ X,
    T* __restrict__ U, int N, long long B, T dt, T gravity) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const gt::Robot<T, NJ> R(model);
  gt::feedback_rollout_lane<T, NJ>(R, x0, Uref, Xref, kff, K, lo, hi, X, U,
                                   N, B, b, dt, gravity);
}

template <typename T, int NJ>
static int launch_feedback_rollout(const void* model, const void* x0,
                                   const void* Uref, const void* Xref,
                                   const void* kff, const void* K,
                                   const void* lo, const void* hi, void* X,
                                   void* U, int N, long long B, double dt,
                                   double gravity, cudaStream_t stream) {
  if (B == 0 || N == 0) return 0;
  const int block = 32;
  feedback_rollout_kernel<T, NJ><<<gt_grid(B, block), block, 0, stream>>>(
      (const T*)model, (const T*)x0, (const T*)Uref, (const T*)Xref,
      (const T*)kff, (const T*)K, (const T*)lo, (const T*)hi, (T*)X, (T*)U,
      N, B, (T)dt, (T)gravity);
  return (int)cudaGetLastError();
}

extern "C" int gridtorch_feedback_rollout(
    int dtype, int nj, const void* model, const void* x0, const void* Uref,
    const void* Xref, const void* kff, const void* K, const void* lo,
    const void* hi, void* X, void* U, int N, long long B, double dt,
    double gravity, void* stream) {
  GT_DISPATCH(dtype, nj,
              launch_feedback_rollout<T, NJ>(model, x0, Uref, Xref, kff, K,
                                             lo, hi, X, U, N, B, dt, gravity,
                                             (cudaStream_t)stream));
}

#endif
