// id_du: the analytical inverse-dynamics gradient dc/d[q, qd], one knot
// (lane) a warp: fd_du's knot program without Minv.
//
// Replaces gridcodegenerator_tpu/ops/pallas/kernels.py:id_du_pallas:
// (q, qd, qdd) (NJ, L) -> dc_du (NJ, 2 NJ, L).
//
// A block holds G knots (warp.cuh:id_du_knot), a half warp each up to 8
// joints, a warp above (2 or 4 times that where it puts more knots or
// warps on an SM, warp.cuh:BlockPlan): the joint transforms a joint a
// thread; one RNEA forward at the given qdd (which also forms I v) and
// the backward accumulation, a level of the tree a phase, a row of each
// joint's 6-vectors a thread (warp.cuh:rnea_forward_knot,
// rnea_backward_knot, fd_du's passes); the ID gradient a column a thread,
// each walking only its column joint's subtree and root path
// (warp.cuh:id_grad_columns_knot, fd_du's), its dc stored into the knot's
// output block. The robot constants are copied into shared memory once a
// block and every knot's state lives there (warp.cuh:IDUKnot), indexed by
// the run-time topology without local memory. The block reads its (NJ, G)
// input tiles and writes each output row as G consecutive lanes.
// dynamics.cuh:id_du_lane is the serial function: csrc/opcount.cpp counts
// the bound from it, and the host tests hold the knot program to the
// plain version.
//
// What bounds it on the card: operations (12.8k a 7-joint lane, the
// bound's count; a lane reads 21 values and writes 98); the design's
// limits are the serial phases' latency and the knots shared memory holds
// on an SM (a knot: 38 NJ^2 + 63 NJ values with one pass of 2 NJ columns,
// 2303 at 7 joints, 9.2 KB float32). G, the threads a knot, the bytes a
// block and cudaFuncGetAttributes of each instance: `gridtorch_id_du_info`.
// From 29 joints (warp.cuh: CHIP_FROM, idu_on_chip; where the shared plan
// would give a knot 64 threads or more above 32 joints, and hold none
// from 48 | 34 joints, float32 | float64) one knot runs a block of 128
// threads with its state on chip (id_du_chip_kernel, warp.cuh:
// IDUChipPlan, id_du_chip_lane; a cluster of 2 or 4 blocks where one block
// cannot hold it): fd_du_chip_lane's program without Minv, the gradient's
// columns in chunks of C by subtree size, C threads walking a column each
// while the block's other threads store the chunk before straight to the
// output, 2 NJ^2 scattered stores a knot spread over the walks' phases.
// The on-chip plans (blocks a knot x threads a block, C, bytes a block),
// float32 | float64:
//   34 joints  1 x 128, C 36, 129824 | 1 x 128, C 24, 188512
//   52 joints  1 x 128, C 36, 206000 | 1 x 128, C 12, 199616
//   64 joints  1 x 128, C 28, 218704 | 1 x 128, C 8, 213904
// What bounds it on the card: one knot's state takes most of an SM's
// shared memory, so one knot runs an SM at a time and its serial phases'
// latency (the RNEA's levels, then the longest walk of each chunk) sets the
// rate.
#include "warp.cuh"

#ifdef __CUDACC__

extern __shared__ double gt_smem[];

template <typename T, int NJ, int PASSES>
__global__ void id_du_kernel(const T* __restrict__ model,
                             const T* __restrict__ q,
                             const T* __restrict__ qd,
                             const T* __restrict__ qdd,
                             T* __restrict__ dcdu, long long L, T gravity) {
  using O = gt::IDUKnot<NJ, PASSES>;
  using P = gt::IDUPlan<T, NJ, PASSES>;
  constexpr int N = P::LANES, S = P::STRIDE;
  auto& R = *reinterpret_cast<gt::RobotConst<T, NJ>*>(gt_smem);
  T* knots = reinterpret_cast<T*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  const int tid = threadIdx.x, nt = blockDim.x, G = nt / N;
  const long long l0 = (long long)blockIdx.x * G;
  R.load(model, tid, nt);
  gt::load_inputs<T, NJ, S>(q, qd, qdd, L, l0, G, knots, tid, nt);
  __syncthreads();
  gt::id_du_knot<T, NJ, PASSES>(gt::WarpPar<N>{tid % N, 1 + tid / N}, R,
                                knots + (long long)(tid / N) * S, gravity);
  __syncthreads();
  gt::store_rows<T, S>(knots + O::DC, 2 * NJ * NJ, dcdu, L, l0, G, tid, nt);
}

// On chip (warp.cuh:IDUChipPlan, idu_on_chip; from CHIP_FROM joints): a
// knot a block or a cluster, the robot constants in rank 0's shared
// memory, the knot's regions in the cluster's, the clusters striding over
// the lanes (warp.cuh:id_du_chip_lane). CLOCKED (the phase
// clock of a build with -DGT_CHIP_CLOCK, launched as one cluster): clk[0]
// the start, then clock64() after each phase, *count the phases.
template <typename T, int NJ, bool CLOCKED = false>
__global__ void __launch_bounds__(gt::IDUChipPlan<T, NJ>::NT)
    id_du_chip_kernel(const T* __restrict__ model, const T* __restrict__ q,
                      const T* __restrict__ qd, const T* __restrict__ qdd,
                      T* __restrict__ dcdu, long long L, T gravity,
                      long long* clk, int* count) {
  using P = gt::IDUChipPlan<T, NJ>;
  char* smem = reinterpret_cast<char*>(gt_smem);
  const int rank = gt::chip_rank<P::CL>(), tid = threadIdx.x;
  if (rank == 0)
    reinterpret_cast<gt::RobotConst<T, NJ>*>(smem)->load(model, tid, P::NT);
  auto base = [&](int r) {
    return reinterpret_cast<T*>(gt::chip_map<P::CL>(smem, r) +
                                (r == 0 ? P::HEAD : 0));
  };
  T* rg[2] = {base(P::RK_BASE) + P::OF_BASE, base(P::RK_COL) + P::OF_COL};
  const auto& R =
      *reinterpret_cast<const gt::RobotConst<T, NJ>*>(gt::chip_map<P::CL>(
          smem, 0));
  gt::chip_sync<P::CL>();   // the constants have landed
  int n = 1;
  if (CLOCKED && rank == 0 && tid == 0) clk[0] = clock64();
  const long long nc = gridDim.x / P::CL;
  for (long long l = blockIdx.x / P::CL; l < L; l += nc)
    gt::id_du_chip_lane<T, NJ, P>(
        gt::ChipPar<P::LANES, P::CL, CLOCKED>{rank * P::NT + tid, clk, &n}, R,
        rg, q, qd, qdd, dcdu, L, l, gravity);
  if (CLOCKED && rank == 0 && tid == 0) *count = n;
  gt::chip_sync<P::CL>();   // no block leaves while another reads it
}

// id_du's shared-memory plan (IDUPlan): G knots a block
template <typename T, int NJ, int PASSES = gt::idu_passes<NJ>()>
static int launch_id_du_shared(const void* model, const void* q,
                               const void* qd, const void* qdd, void* dcdu,
                               long long L, double gravity,
                               cudaStream_t stream) {
  using P = gt::IDUPlan<T, NJ, PASSES>;
  if constexpr (P::G < 1) {
    return (int)cudaErrorInvalidValue;   // no knot fits a block
  } else {
    if (L == 0) return 0;
    static const cudaError_t attr =
        gt::smem_attrs(id_du_kernel<T, NJ, PASSES>, P::BYTES);
    if (attr != cudaSuccess) return (int)attr;
    id_du_kernel<T, NJ, PASSES><<<(unsigned)((L + P::G - 1) / P::G),
                                  P::LANES * P::G, P::BYTES, stream>>>(
        (const T*)model, (const T*)q, (const T*)qd, (const T*)qdd, (T*)dcdu,
        L, (T)gravity);
    return (int)cudaGetLastError();
  }
}

template <typename T, int NJ>
static int launch_id_du_chip(const void* model, const void* q,
                             const void* qd, const void* qdd, void* dcdu,
                             long long L, double gravity,
                             cudaStream_t stream) {
  return gt::launch_chip<gt::IDUChipPlan<T, NJ>>(
      id_du_chip_kernel<T, NJ>, L, stream, (const T*)model, (const T*)q,
      (const T*)qd, (const T*)qdd, (T*)dcdu, L, (T)gravity,
      (long long*)nullptr, (int*)nullptr);
}

#ifdef GT_CHIP_CLOCK
// The phase clock of the float32 instance on lane 0 of (n, 1) inputs.
extern "C" int gridtorch_id_du_clock(const void* model, const void* q,
                                     const void* qd, const void* qdd,
                                     void* dcdu, void* clk, void* count) {
  using T = float;
  if constexpr (gt::idu_on_chip<T, GT_NJ>()) {
    return gt::launch_chip<gt::IDUChipPlan<T, GT_NJ>>(
        id_du_chip_kernel<T, GT_NJ, true>, 1, nullptr, (const T*)model,
        (const T*)q, (const T*)qd, (const T*)qdd, (T*)dcdu, 1LL, (T)-9.81,
        (long long*)clk, (int*)count);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

// id_du at this joint count on a route of choice, to time the routes where
// more than one exists: route 0 the shared-memory plan
// (cudaErrorInvalidValue where no knot fits a block), 1 on chip; gravity
// -9.81
template <typename T>
static int id_du_forced(int route, const void* model, const void* q,
                        const void* qd, const void* qdd, void* dcdu,
                        long long L, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (route == 0)
    return launch_id_du_shared<T, GT_NJ>(model, q, qd, qdd, dcdu, L, -9.81,
                                         st);
  return launch_id_du_chip<T, GT_NJ>(model, q, qd, qdd, dcdu, L, -9.81, st);
}

extern "C" int gridtorch_id_du_forced(int dtype, int route,
                                      const void* model, const void* q,
                                      const void* qd, const void* qdd,
                                      void* dcdu, long long L, void* stream) {
  return (dtype == gt::kF32 ? id_du_forced<float> : id_du_forced<double>)(
      route, model, q, qd, qdd, dcdu, L, stream);
}
#endif

// id_du: on chip from CHIP_FROM joints (idu_on_chip), else the
// shared-memory plan
template <typename T, int NJ>
static int launch_id_du(const void* model, const void* q, const void* qd,
                        const void* qdd, void* dcdu, long long L,
                        double gravity, cudaStream_t stream) {
  if constexpr (gt::idu_on_chip<T, NJ>())
    return launch_id_du_chip<T, NJ>(model, q, qd, qdd, dcdu, L, gravity,
                                    stream);
  else
    return launch_id_du_shared<T, NJ>(model, q, qd, qdd, dcdu, L, gravity,
                                      stream);
}

extern "C" int gridtorch_id_du(int dtype, int nj, const void* model,
                               const void* q, const void* qd, const void* qdd,
                               void* dcdu, long long L, double gravity,
                               void* stream) {
  GT_DISPATCH(dtype, nj,
              launch_id_du<T, NJ>(model, q, qd, qdd, dcdu, L, gravity,
                                  (cudaStream_t)stream));
}

template <typename T, int NJ, int PASSES = gt::idu_passes<NJ>()>
static int id_du_info(int* out) {
  if constexpr (gt::idu_on_chip<T, NJ>())
    return gt::kernel_info<gt::IDUChipPlan<T, NJ>>(
        (const void*)id_du_chip_kernel<T, NJ>, out);
  else
    return gt::kernel_info<gt::IDUPlan<T, NJ, PASSES>>(
        (const void*)id_du_kernel<T, NJ, PASSES>, out);
}

// The block plan (G; threads a knot; bytes a block) and
// cudaFuncGetAttributes of the instance (warp.cuh:kernel_info), into
// out[10].
extern "C" int gridtorch_id_du_info(int dtype, int nj, int* out) {
  GT_DISPATCH(dtype, nj, (id_du_info<T, NJ>(out)));
}

#endif
