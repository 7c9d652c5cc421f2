// linesearch: feedback rollouts for every step size at once, with the cost
// summed in the sweep or without a cost; a group of threads per (step size,
// problem).
//
// Replaces gridcodegenerator_tpu/ops/pallas/sweeps.py:
// linesearch_rollout_pallas and the in-kernel hooks of
// gridcodegenerator_tpu/trajopt/cost.py:EEReachCost.pallas_cost and
// QuadCost.pallas_cost: the program is a template on the cost (EECostW,
// QuadCostW in csrc/sweep_warp.cuh), whose constants come from a small
// packed buffer (ops/cuda/build.py:cost_buffer, cached per cost). Lane
// l = a B + b runs step-size row a for problem b (alpha-major, the order of
// the solver's widened lanes); the rows of a problem share its unwidened
// Uref/Xref/k/K, so the widened inputs never exist in device memory.
//
// u_t = clamp(Uref_t + alpha k_t + K_t (x_t - Xref_t)); the stage cost
// before each step, the terminal cost at the end:
// * EECost (kind 0; buffer goal (3) | w_pos | w_pos_f | w_vel | w_u):
//   stage 0.5 (w_pos |ee(q) - goal|^2 + w_vel |qd|^2 + w_u |u|^2), terminal
//   0.5 (w_pos_f |ee(q) - goal|^2 + w_vel |qd|^2), with ee() the
//   position-only FK of the packed EE chain;
// * QuadCostK (kind 1; buffer Q (2 NJ) | R (NJ) | Qf (2 NJ) | x_goal (2 NJ)):
//   stage 0.5 (sum Q (x - xg)^2 + sum R u^2), terminal 0.5 sum Qf (x - xg)^2;
// * NoCostK (kind 2; no buffer): no cost, X and U only. It replaces
//   linesearch_rollout_pallas called without cost_consts, which the JAX
//   solver runs for a cost that is not time-invariant (a per-problem goal,
//   a cost of the knot index) and then sums that cost over the rollouts
//   outside the kernel; the block runs the rollout's and feedback
//   rollout's NoCost policy (csrc/sweep_warp.cuh) under FeedbackLaw.
//
// The kernel (csrc/sweep_warp.cuh:linesearch_block with the control law
// FeedbackLaw) holds G problems and `rows` of their step-size rows a block
// (LSPlan), a rollout a group of LANES threads: each Euler step is 4 L - 1 phases for a tree of L levels
// (the control law and the joint transforms a joint a thread, ABA's passes a
// level a phase, a row or entry of each joint's quantities a thread), the
// state in shared memory. The block reads each knot's K, Xref, Uref and k
// once for all its rows, G lanes a row with cp.async into a second buffer
// while the step before runs, and writes X and U G lanes a row.
// What bounds it on the card: operations (the ABA steps; bytes: N (2 NJ^2 +
// 4 NJ) values a problem in, N 3 NJ a rollout out); the design's limits are
// the step's serial phases (a chain of L joints is L levels) and the
// rollouts shared memory holds on an SM. Above 52 joints in float64 a
// problem's two tiles and one rollout do not fit a block: the tiles go to
// device memory (linesearch_ws_kernel, sweep_warp.cuh:LSPlan's TILES_WS).
// The plans (problems a block x threads a rollout, rows a block, bytes a
// block): `gridtorch_linesearch_info`.
//
// Layout: x0 (2 NJ, B), Uref/k (N, NJ, B), Xref (N, 2 NJ, B),
// K (N, NJ, 2 NJ, B), alpha_rows (na, B), bounds (NJ) or null;
// X (N, 2 NJ, na B), U (N, NJ, na B), cost (na B; null for kind 2).
#include "sweep_warp.cuh"

namespace gt {

// (|ee(q) - goal|^2, |qd|^2) of state x
template <typename T, int NJ>
GT_HD void ee_squares(const Robot<T, NJ>& R, const T* x, const T* goal,
                      T* e2, T* v2) {
  T xyz[3];
  ee_xyz(R, x, xyz);
  T s = T(0);
  for (int i = 0; i < 3; ++i) {
    const T d = xyz[i] - goal[i];
    s += d * d;
  }
  *e2 = s;
  s = T(0);
  for (int i = 0; i < NJ; ++i) s += x[NJ + i] * x[NJ + i];
  *v2 = s;
}

template <typename T, int NJ>
struct EECost {
  static constexpr bool SUMS = true;
  const T* c;   // goal (3) | w_pos | w_pos_f | w_vel | w_u
  GT_HD T stage(const Robot<T, NJ>& R, const T* x, const T* u) const {
    T e2, v2, u2 = T(0);
    ee_squares(R, x, c, &e2, &v2);
    for (int j = 0; j < NJ; ++j) u2 += u[j] * u[j];
    return T(0.5) * (c[3] * e2 + c[5] * v2 + c[6] * u2);
  }
  GT_HD T terminal(const Robot<T, NJ>& R, const T* x) const {
    T e2, v2;
    ee_squares(R, x, c, &e2, &v2);
    return T(0.5) * (c[4] * e2 + c[5] * v2);
  }
};

template <typename T, int NJ>
struct QuadCostK {
  static constexpr bool SUMS = true;
  static constexpr int NX = 2 * NJ;
  const T* c;   // Q (NX) | R (NJ) | Qf (NX) | x_goal (NX)
  GT_HD T squares(const T* w, const T* x) const {
    const T* xg = c + 2 * NX + NJ;
    T acc = T(0);
    for (int i = 0; i < NX; ++i) {
      const T d = x[i] - xg[i];
      acc += w[i] * d * d;
    }
    return acc;
  }
  GT_HD T stage(const Robot<T, NJ>&, const T* x, const T* u) const {
    T acc = squares(c, x);
    for (int j = 0; j < NJ; ++j) acc += c[NX + j] * u[j] * u[j];
    return T(0.5) * acc;
  }
  GT_HD T terminal(const Robot<T, NJ>&, const T* x) const {
    return T(0.5) * squares(c + NX + NJ, x);
  }
};

template <typename T, int NJ>
struct NoCostK {
  static constexpr bool SUMS = false;
  const T* c;   // unused
  GT_HD T stage(const Robot<T, NJ>&, const T*, const T*) const { return T(0); }
  GT_HD T terminal(const Robot<T, NJ>&, const T*) const { return T(0); }
};

// One rollout serially: the arithmetic the function needs (csrc/opcount.cpp
// counts it for the bound); a cost that does not sum writes no cost.
template <typename T, int NJ, class Cost>
GT_HD void linesearch_lane(const Robot<T, NJ>& R, const T* x0,
                           const T* Uref, const T* Xref, const T* k,
                           const T* K, const T* alpha_rows, const T* lo,
                           const T* hi, T* Xo, T* Uo, T* cost, int N,
                           long long B, int na, long long lane, T dt,
                           T gravity, const Cost& c) {
  constexpr int NX = 2 * NJ;
  const long long b = lane % B;
  const long long W = (long long)na * B;
  const T alpha = alpha_rows[lane];   // (na, B) row-major: a B + b == lane
  T x[NX];
  for (int i = 0; i < NX; ++i) x[i] = x0[i * B + b];
  T acc = T(0);
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int t = 0; t < N; ++t) {
    T u[NJ];
    feedback_u<T, NJ>(x, Uref, Xref, k, K, alpha, lo, hi, t, B, b, u);
    if constexpr (Cost::SUMS) acc += c.stage(R, x, u);
    euler_step(R, x, u, dt, gravity);
    for (int i = 0; i < NX; ++i) Xo[((long long)t * NX + i) * W + lane] = x[i];
    for (int j = 0; j < NJ; ++j) Uo[((long long)t * NJ + j) * W + lane] = u[j];
  }
  if constexpr (Cost::SUMS) cost[lane] = acc + c.terminal(R, x);
}

}  // namespace gt

#ifdef __CUDACC__

extern __shared__ double gt_smem[];

template <typename T, int NJ, class Cost>
__global__ void linesearch_kernel(
    const T* __restrict__ model, const T* __restrict__ x0,
    const T* __restrict__ Uref, const T* __restrict__ Xref,
    const T* __restrict__ k, const T* __restrict__ K,
    const T* __restrict__ alpha_rows, const T* __restrict__ lo,
    const T* __restrict__ hi, T* __restrict__ X, T* __restrict__ U,
    T* __restrict__ cost, int N, long long B, int na, int rows, T dt,
    T gravity, const T* __restrict__ cbuf, int ncost) {
  using P = gt::LSPlan<T, NJ>;
  constexpr int W = P::LANES;
  auto& H = *reinterpret_cast<gt::LSHead<T, NJ>*>(gt_smem);
  T* tiles = reinterpret_cast<T*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  T* rolls = tiles + 2 * P::G * P::TILE;
  const int tid = threadIdx.x, nt = blockDim.x;
  H.load(model, cbuf, ncost, lo, hi, tid, nt);
  __syncthreads();
  gt::linesearch_block<T, NJ, Cost, P::G>(
      gt::WarpPar<W>{tid % W, 1 + tid / W}, tid, nt, tid / W, H, tiles,
      P::TILE, rolls, P::STRIDE, rows, (long long)blockIdx.x * P::G,
      blockIdx.y * rows, x0,
      gt::FeedbackLaw<T, NJ>{Uref, Xref, k, K, alpha_rows}, X, U, cost, N, B,
      na, dt, gravity);
}

// The tiles in device memory (LSPlan's TILES_WS; above 52 joints in
// float64): nws blocks, each with its two buffers of G tiles at its place
// in the workspace `ws`, striding over the grid's blocks (problems, then
// step-size rows); the rollouts in shared memory, after the head.
template <typename T, int NJ, class Cost>
__global__ void linesearch_ws_kernel(
    const T* __restrict__ model, const T* __restrict__ x0,
    const T* __restrict__ Uref, const T* __restrict__ Xref,
    const T* __restrict__ k, const T* __restrict__ K,
    const T* __restrict__ alpha_rows, const T* __restrict__ lo,
    const T* __restrict__ hi, T* __restrict__ X, T* __restrict__ U,
    T* __restrict__ cost, int N, long long B, int na, int rows, T dt,
    T gravity, const T* __restrict__ cbuf, int ncost, T* ws) {
  using P = gt::LSPlan<T, NJ>;
  constexpr int W = P::LANES;
  auto& H = *reinterpret_cast<gt::LSHead<T, NJ>*>(gt_smem);
  T* rolls = reinterpret_cast<T*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  T* tiles = ws + (long long)blockIdx.x * 2 * P::G * P::TILE;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long bx = (B + P::G - 1) / P::G;
  const long long blocks = bx * ((na + rows - 1) / rows);
  H.load(model, cbuf, ncost, lo, hi, tid, nt);
  for (long long v = blockIdx.x; v < blocks; v += gridDim.x) {
    __syncthreads();   // the head has landed; the last block's rows are out
    gt::linesearch_block<T, NJ, Cost, P::G, false>(
        gt::WarpPar<W>{tid % W, 1 + tid / W}, tid, nt, tid / W, H, tiles,
        P::TILE, rolls, P::STRIDE, rows, v % bx * P::G, (int)(v / bx) * rows,
        x0, gt::FeedbackLaw<T, NJ>{Uref, Xref, k, K, alpha_rows}, X, U, cost,
        N, B, na, dt, gravity);
  }
}

// One cost's kernel over `grid` (problems, step-size rows) blocks: on the
// shared-memory route a block each; with the tiles in device memory (the
// args then end with the workspace) min(nws, blocks) blocks striding over
// them.
template <typename T, int NJ, class Cost, class... A>
static int launch_ls_cost(dim3 grid, int threads, int bytes,
                          cudaStream_t stream, void* ws, long long nws,
                          A... args) {
  using P = gt::LSPlan<T, NJ>;
  if constexpr (P::TILES_WS) {
    auto fn = linesearch_ws_kernel<T, NJ, Cost>;
    const long long blocks = (long long)grid.x * grid.y;
    if (ws == nullptr || nws < 1) return (int)cudaErrorInvalidValue;
    static const cudaError_t attr = gt::smem_attrs(fn, P::BYTES);
    if (attr != cudaSuccess) return (int)attr;
    fn<<<(unsigned)(nws < blocks ? nws : blocks), threads, bytes, stream>>>(
        args..., (T*)ws);
  } else {
    auto fn = linesearch_kernel<T, NJ, Cost>;
    static const cudaError_t attr = gt::smem_attrs(fn, P::BYTES);
    if (attr != cudaSuccess) return (int)attr;
    fn<<<grid, threads, bytes, stream>>>(args...);
  }
  return (int)cudaGetLastError();
}

template <typename T, int NJ>
static int launch_linesearch(const void* model, const void* x0,
                             const void* Uref, const void* Xref,
                             const void* k, const void* K,
                             const void* alpha_rows, const void* lo,
                             const void* hi, void* X, void* U, void* cost,
                             int N, long long B, int na, double dt,
                             double gravity, int kind, const void* cbuf,
                             cudaStream_t stream, void* ws = nullptr,
                             long long nws = 0) {
  using P = gt::LSPlan<T, NJ>;
  static_assert(P::ROWS >= 1, "one line-search rollout a problem must fit");
  if (na == 0 || B == 0 || N == 0) return 0;
  const int rows = P::rows_for(na);
  const dim3 grid((unsigned)((B + P::G - 1) / P::G),
                  (unsigned)((na + rows - 1) / rows));
  const int threads = P::G * rows * P::LANES;
  const int bytes = (int)P::bytes(rows);
#define GT_LS_ARGS                                                          \
  (const T*)model, (const T*)x0, (const T*)Uref, (const T*)Xref,            \
      (const T*)k, (const T*)K, (const T*)alpha_rows, (const T*)lo,         \
      (const T*)hi, (T*)X, (T*)U, (T*)cost, N, B, na, rows, (T)dt,          \
      (T)gravity, (const T*)cbuf
  int err = (int)cudaErrorInvalidValue;
  if (kind == 0)
    err = launch_ls_cost<T, NJ, gt::EECostW<T, NJ>>(
        grid, threads, bytes, stream, ws, nws, GT_LS_ARGS, 7);
  else if (kind == 1)
    err = launch_ls_cost<T, NJ, gt::QuadCostW<T, NJ>>(
        grid, threads, bytes, stream, ws, nws, GT_LS_ARGS, 7 * NJ);
  else if (kind == 2)
    err = launch_ls_cost<T, NJ, gt::NoCost<T, NJ>>(
        grid, threads, bytes, stream, ws, nws, GT_LS_ARGS, 0);
#undef GT_LS_ARGS
  return err;
}

// ws: the workspace of the device-memory route, nws knots, problems or
// blocks (its plan's workspace_bytes each; ops/cuda/build.py:workspace);
// ignored where the plan keeps everything in shared memory.
extern "C" int gridtorch_linesearch(
    int dtype, int nj, const void* model, const void* x0, const void* Uref,
    const void* Xref, const void* k, const void* K, const void* alpha_rows,
    const void* lo, const void* hi, void* X, void* U, void* cost, int N,
    long long B, int na, double dt, double gravity, int kind,
    const void* cbuf, void* stream, void* ws, long long nws) {
  GT_DISPATCH(dtype, nj,
              launch_linesearch<T, NJ>(model, x0, Uref, Xref, k, K,
                                       alpha_rows, lo, hi, X, U, cost, N, B,
                                       na, dt, gravity, kind, cbuf,
                                       (cudaStream_t)stream, ws, nws));
}

template <typename T, int NJ>
static int linesearch_info(int* out) {
  using P = gt::LSPlan<T, NJ>;
  using C = gt::EECostW<T, NJ>;
  if constexpr (P::TILES_WS)
    return gt::kernel_info<P>((const void*)linesearch_ws_kernel<T, NJ, C>,
                              out);
  else
    return gt::kernel_info<P>((const void*)linesearch_kernel<T, NJ, C>, out);
}

// The block plan (problems a block; threads a rollout; bytes a block at
// the most rows; rows a block at most) and cudaFuncGetAttributes of the EE
// instance (warp.cuh:kernel_info), into out[10].
extern "C" int gridtorch_linesearch_info(int dtype, int nj, int* out) {
  GT_DISPATCH(dtype, nj, (linesearch_info<T, NJ>(out)));
}

#endif
