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
// pass); from 29 joints (warp.cuh: CHIP_FROM; the two-warp knots in
// shared memory ran 1.9-2.0x slower at 34-46 joints in float32, and from
// 33 joints in float64 no knot fits a block beside others) one knot runs a
// block, or a cluster of 2 blocks, its state on chip (fd_du_chip_kernel, warp.cuh:FDChipPlan):
// the gradient's columns in chunks of C, C threads walking a column each
// while the block's other threads fold the chunk before into df/du =
// -Minv dc, a 4 x 4 register tile a thread, straight to the output. The
// on-chip plans (blocks a knot x threads a block, C, bytes a block),
// float32 | float64:
//   34 joints  1 x 256, C 36, 146432 | 1 x 256, C 24, 221728
//   52 joints  1 x 256, C 28, 201840 | 2 x 256, C 24, 199680
//   64 joints  1 x 256, C 20, 216656 | 2 x 256, C 20, 209808
// (a cluster of 2 from 44 joints in float64: rank 0 holds the robot
// constants and the knot's BASE and MSM regions, rank 1 its FMC.) C: the
// widest chunk (16 to 64 columns) that fits the fewest blocks, evened out
// over its chunks (each chunk is a phase as long as its longest column's
// walk). What bounds it on the card: one knot's state takes most of an
// SM's shared memory, so one knot runs an SM at a time and its serial
// phases' latency sets the rate.
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

// On chip (warp.cuh:FDChipPlan, fd_on_chip; from 29 joints): a knot a
// block or a cluster, the robot constants in rank 0's shared memory, the
// knot's regions in the cluster's, the clusters striding over the lanes
// (warp.cuh:fd_du_chip_lane). CLOCKED (the phase clock of a build with
// -DGT_CHIP_CLOCK, launched as one cluster): clk[0] the start, then
// clock64() after each phase, *count the phases.
template <typename T, int NJ, bool CLOCKED = false>
__global__ void __launch_bounds__(gt::FDChipPlan<T, NJ>::NT)
    fd_du_chip_kernel(const T* __restrict__ model, const T* __restrict__ q,
                      const T* __restrict__ qd, const T* __restrict__ u,
                      T* __restrict__ dfdu, T* __restrict__ qdd,
                      T* __restrict__ Mi, long long L, T gravity,
                      long long* clk, int* count) {
  using P = gt::FDChipPlan<T, NJ>;
  char* smem = reinterpret_cast<char*>(gt_smem);
  const int rank = gt::chip_rank<P::CL>(), tid = threadIdx.x;
  if (rank == 0)
    reinterpret_cast<gt::RobotConst<T, NJ>*>(smem)->load(model, tid, P::NT);
  auto base = [&](int r) {
    return reinterpret_cast<T*>(gt::chip_map<P::CL>(smem, r) +
                                (r == 0 ? P::HEAD : 0));
  };
  T* rg[3] = {base(P::RK_BASE) + P::OF_BASE, base(P::RK_MSM) + P::OF_MSM,
              base(P::RK_FMC) + P::OF_FMC};
  const auto& R =
      *reinterpret_cast<const gt::RobotConst<T, NJ>*>(gt::chip_map<P::CL>(
          smem, 0));
  gt::chip_sync<P::CL>();   // the constants have landed
  int n = 1;
  if (CLOCKED && rank == 0 && tid == 0) clk[0] = clock64();
  const long long nc = gridDim.x / P::CL;
  for (long long l = blockIdx.x / P::CL; l < L; l += nc)
    gt::fd_du_chip_lane<T, NJ, P>(
        gt::ChipPar<P::LANES, P::CL, CLOCKED>{rank * P::NT + tid, clk, &n}, R,
        rg, q, qd, u, dfdu, qdd, Mi, L, l, gravity);
  if (CLOCKED && rank == 0 && tid == 0) *count = n;
  gt::chip_sync<P::CL>();   // no block leaves while another reads it
}

#ifdef GT_CHIP_CLOCK
// The phase clock of the float32 instance on lane 0 of (n, 1) inputs.
extern "C" int gridtorch_fd_du_clock(const void* model, const void* q,
                                     const void* qd, const void* u,
                                     void* dfdu, void* qdd, void* Mi,
                                     void* clk, void* count) {
  using T = float;
  if constexpr (gt::fd_on_chip<T, GT_NJ>())
    return gt::launch_chip<gt::FDChipPlan<T, GT_NJ>>(
        fd_du_chip_kernel<T, GT_NJ, true>, 1, nullptr, (const T*)model,
        (const T*)q, (const T*)qd, (const T*)u, (T*)dfdu, (T*)qdd, (T*)Mi,
        1LL, (T)-9.81, (long long*)clk, (int*)count);
  else
    return (int)cudaErrorInvalidValue;
}

// The on-chip fd_du at this joint count whatever its route, to time it
// where the shared-memory route runs.
template <typename T>
static int fd_du_chip_forced(const void* model, const void* q,
                             const void* qd, const void* u, void* dfdu,
                             void* qdd, void* Mi, long long L, void* stream) {
  return gt::launch_chip<gt::FDChipPlan<T, GT_NJ>>(
      fd_du_chip_kernel<T, GT_NJ>, L, (cudaStream_t)stream, (const T*)model,
      (const T*)q, (const T*)qd, (const T*)u, (T*)dfdu, (T*)qdd, (T*)Mi, L,
      (T)-9.81, (long long*)nullptr, (int*)nullptr);
}

extern "C" int gridtorch_fd_du_chip_forced(int dtype, const void* model,
                                           const void* q, const void* qd,
                                           const void* u, void* dfdu,
                                           void* qdd, void* Mi, long long L,
                                           void* stream) {
  return (dtype == gt::kF32 ? fd_du_chip_forced<float>
                            : fd_du_chip_forced<double>)(
      model, q, qd, u, dfdu, qdd, Mi, L, stream);
}
#endif

template <typename T, int NJ>
static int launch_fd_du(const void* model, const void* q, const void* qd,
                        const void* u, void* dfdu, void* qdd, void* Mi,
                        long long L, double gravity, cudaStream_t stream) {
  using P = gt::FDPlan<T, NJ>;
  if constexpr (gt::fd_on_chip<T, NJ>()) {
    return gt::launch_chip<gt::FDChipPlan<T, NJ>>(
        fd_du_chip_kernel<T, NJ>, L, stream, (const T*)model, (const T*)q,
        (const T*)qd, (const T*)u, (T*)dfdu, (T*)qdd, (T*)Mi, L, (T)gravity,
        (long long*)nullptr, (int*)nullptr);
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
  if constexpr (gt::fd_on_chip<T, NJ>())
    return gt::kernel_info<gt::FDChipPlan<T, NJ>>(
        (const void*)fd_du_chip_kernel<T, NJ>, out);
  else
    return gt::kernel_info<gt::FDPlan<T, NJ>>(
        (const void*)fd_du_kernel<T, NJ>, out);
}

extern "C" int gridtorch_model_size(int nj) {
  return nj == GT_NJ ? gt::Layout<GT_NJ>::SIZE : -1;
}

// ws, nws: unused (every instance keeps its knots on chip), in the C
// interface that id_du and the other kernels with a device-memory route
// share.
extern "C" int gridtorch_fd_du(int dtype, int nj, const void* model,
                               const void* q, const void* qd, const void* u,
                               void* dfdu, void* qdd, void* Mi, long long L,
                               double gravity, void* stream,
                               void* ws, long long nws) {
  GT_DISPATCH(dtype, nj,
              launch_fd_du<T, NJ>(model, q, qd, u, dfdu, qdd, Mi, L, gravity,
                                  (cudaStream_t)stream));
}

// The block plan (G; threads a knot; bytes a block) and
// cudaFuncGetAttributes of the instance (warp.cuh:kernel_info), into
// out[10].
extern "C" int gridtorch_fd_du_info(int dtype, int nj, int* out) {
  GT_DISPATCH(dtype, nj, (fd_du_info<T, NJ>(out)));
}

#endif
