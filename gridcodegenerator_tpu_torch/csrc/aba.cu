// aba: articulated-body forward dynamics qdd = ABA(q, qd, u), a thread
// group per lane (knot) on the rollouts' ABA phases.
//
// Replaces gridcodegenerator_tpu/ops/pallas/kernels.py:aba_pallas:
// (q, qd, u) (NJ, L) -> qdd (NJ, L).
//
// A block holds G knots of LANES threads each (sweep_warp.cuh:ABAPlan: the
// rollout's widths, 8 threads a knot on the chains of 2 and 7 joints, a
// warp otherwise; G the largest power of 2 up to 8 that fits), runs
// sweep_warp.cuh:aba_knot: the phases of ABA that the line search, the
// open-loop and the feedback rollouts run each step (aba_phases), in 4 L - 1
// phases for a tree of L levels (iiwa 27, hyq 11, gym_humanoid 27, atlas
// 35): the joint transforms a joint a thread, v and the bias terms a level
// a phase, the articulated inertias' backward reduction two phases a
// level, a column or row a thread, and the forward recovery of qdd a level
// a phase. The robot constants are copied into shared memory once a block
// and every knot's state lives there (sweep_warp.cuh:ABAKnot, 138 NJ
// values), indexed by the run-time topology without local memory. The
// block reads its (NJ, G) input tiles and writes qdd as G consecutive lanes
// a row. dynamics.cuh:aba is the serial function: csrc/opcount.cpp counts
// the bound from it, and the host tests hold the knot program to its bits.
//
// What bounds it on the card: operations (4.7k a 7-joint lane, the bound's
// count; a lane reads 21 values and writes 7); the design's limits are the
// serial phases' latency (a chain of L joints is L levels) and the knots
// shared memory holds on an SM (966 values a 7-joint knot, 3.9 KB float32).
// G, the threads a knot, the bytes a block and cudaFuncGetAttributes of
// each instance: `gridtorch_aba_info`.
#include "sweep_warp.cuh"

#ifdef __CUDACC__

extern __shared__ double gt_smem[];

// P: the block's shape (ABAPlan, or another KnotShape to compare)
template <typename T, int NJ, class P>
__global__ void aba_kernel(const T* __restrict__ model,
                           const T* __restrict__ q, const T* __restrict__ qd,
                           const T* __restrict__ u, T* __restrict__ qdd,
                           long long L, T gravity) {
  using O = gt::ABAKnot<NJ>;
  constexpr int N = P::LANES, S = P::STRIDE;
  auto& R = *reinterpret_cast<gt::RobotConst<T, NJ>*>(gt_smem);
  T* knots = reinterpret_cast<T*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  const int tid = threadIdx.x, nt = blockDim.x, G = nt / N;
  const long long l0 = (long long)blockIdx.x * G;
  R.load_tree(model, tid, nt);
  gt::load_inputs<T, NJ, S>(q, qd, u, L, l0, G, knots, tid, nt);
  __syncthreads();
  gt::aba_knot<T, NJ>(gt::WarpPar<N>{tid % N, 1 + tid / N}, R,
                      knots + (long long)(tid / N) * S, gravity);
  __syncthreads();
  gt::store_rows<T, S>(knots + O::QDD, NJ, qdd, L, l0, G, tid, nt);
}

template <typename T, int NJ, class P = gt::ABAPlan<T, NJ>>
static int launch_aba(const void* model, const void* q, const void* qd,
                      const void* u, void* qdd, long long L, double gravity,
                      cudaStream_t stream) {
  static_assert(P::G >= 1, "one aba knot must fit in shared memory");
  if (L == 0) return 0;
  static const cudaError_t attr =
      gt::smem_attrs(aba_kernel<T, NJ, P>, P::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  aba_kernel<T, NJ, P><<<(unsigned)((L + P::G - 1) / P::G),
                         P::LANES * P::G, P::BYTES, stream>>>(
      (const T*)model, (const T*)q, (const T*)qd, (const T*)u, (T*)qdd, L,
      (T)gravity);
  return (int)cudaGetLastError();
}

extern "C" int gridtorch_aba(int dtype, int nj, const void* model,
                             const void* q, const void* qd, const void* u,
                             void* qdd, long long L, double gravity,
                             void* stream) {
  GT_DISPATCH(dtype, nj,
              launch_aba<T, NJ>(model, q, qd, u, qdd, L, gravity,
                                (cudaStream_t)stream));
}

// The block plan (G; threads a knot; bytes a block) and
// cudaFuncGetAttributes of the instance (warp.cuh:kernel_info), into
// out[11].
extern "C" int gridtorch_aba_info(int dtype, int nj, int* out) {
  GT_DISPATCH(dtype, nj,
              (gt::kernel_info<gt::ABAPlan<T, NJ>>(
                  (const void*)aba_kernel<T, NJ, gt::ABAPlan<T, NJ>>, out)));
}

#endif
