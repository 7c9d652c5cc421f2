// crba: the mass matrix M(q), both triangles, a thread group per lane
// (knot), a level of the tree a phase.
//
// Replaces gridcodegenerator_tpu/ops/pallas/kernels.py:crba_pallas:
// q (NJ, L) -> M (NJ, NJ, L).
//
// A block holds G knots of LANES threads each (warp.cuh:CRBAPlan: 16
// threads a knot on the chains of 2 and 7 joints and at 12, a warp
// otherwise; G the largest power of 2 up to 8 that fits), runs
// warp.cuh:crba_knot: the
// joint transforms a joint a thread; then a phase a level of the tree,
// deepest first, that adds the level's composite inertias into their
// parents (a row of a parent a thread, its children in descending order)
// and steps every column of M whose walk up the ancestors (parent[], not
// i - 1: the tree may branch) is at that level to the level above (an entry
// of the column's force a thread); then the base's diagonal: L + 1 phases
// for a tree of L levels (iiwa 8, hyq 4). The robot constants and the
// tree's lists are built in shared memory by all the block's threads
// (RobotConst::load_tree), and every knot's state lives there
// (warp.cuh:CRBAKnot, NJ^2 + 87 NJ values), indexed by the run-time
// topology without local memory. The block reads its (NJ, G) tile of q and
// writes each of the NJ^2 output rows as G consecutive lanes.
// dynamics.cuh:crba_lane is the serial function: csrc/opcount.cpp counts
// the bound from it, and the host tests hold the knot program to its bits.
//
// What bounds it on the card: bytes at large batches (a 7-joint lane reads
// 7 values and writes 49; 3.4k operations the bound's count); the design's
// limits are the serial phases' latency and the block's head (the robot's
// constants and lists) at small batches.
// G, the threads a knot, the bytes a block and cudaFuncGetAttributes of the
// instance: `gridtorch_crba_info`.
#include "warp.cuh"

#ifdef __CUDACC__

extern __shared__ double gt_smem[];

// P: the block's shape (CRBAPlan, or another KnotShape to compare)
template <typename T, int NJ, class P>
__global__ void crba_kernel(const T* __restrict__ model,
                            const T* __restrict__ q, T* __restrict__ M,
                            long long L) {
  using O = gt::CRBAKnot<NJ>;
  constexpr int N = P::LANES, S = P::STRIDE;
  auto& R = *reinterpret_cast<gt::RobotConst<T, NJ>*>(gt_smem);
  T* knots = reinterpret_cast<T*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  const int tid = threadIdx.x, nt = blockDim.x, G = nt / N;
  const long long l0 = (long long)blockIdx.x * G;
  R.load_tree(model, tid, nt);
  gt::load_q<T, NJ, S>(q, L, l0, G, knots, tid, nt);
  __syncthreads();
  gt::crba_knot<T, NJ>(gt::WarpPar<N>{tid % N, 1 + tid / N}, R,
                       knots + (long long)(tid / N) * S);
  __syncthreads();
  gt::store_rows<T, S>(knots + O::M, NJ * NJ, M, L, l0, G, tid, nt);
}

template <typename T, int NJ, class P = gt::CRBAPlan<T, NJ>>
static int launch_crba(const void* model, const void* q, void* M, long long L,
                       cudaStream_t stream) {
  static_assert(P::G >= 1, "one crba knot must fit in shared memory");
  if (L == 0) return 0;
  static const cudaError_t attr = gt::smem_attrs(crba_kernel<T, NJ, P>,
                                                 P::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  crba_kernel<T, NJ, P><<<(unsigned)((L + P::G - 1) / P::G), P::LANES * P::G,
                          P::BYTES, stream>>>((const T*)model, (const T*)q,
                                              (T*)M, L);
  return (int)cudaGetLastError();
}

extern "C" int gridtorch_crba(int dtype, int nj, const void* model,
                              const void* q, void* M, long long L,
                              void* stream) {
  GT_DISPATCH(dtype, nj,
              launch_crba<T, NJ>(model, q, M, L, (cudaStream_t)stream));
}

// The block plan (G; threads a knot; bytes a block) and
// cudaFuncGetAttributes of the instance (warp.cuh:kernel_info), into
// out[11].
extern "C" int gridtorch_crba_info(int dtype, int nj, int* out) {
  GT_DISPATCH(dtype, nj,
              (gt::kernel_info<gt::CRBAPlan<T, NJ>>(
                  (const void*)crba_kernel<T, NJ, gt::CRBAPlan<T, NJ>>, out)));
}

#endif
