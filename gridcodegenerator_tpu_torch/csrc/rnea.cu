// rnea: inverse dynamics c = RNEA(q, qd[, qdd]), a thread group per lane
// (knot) on id_du's RNEA passes.
//
// Replaces gridcodegenerator_tpu/ops/pallas/kernels.py:rnea_pallas:
// (q, qd[, qdd]) (NJ, L) -> c (NJ, L); without qdd the bias force.
//
// A block holds G knots of LANES threads each (warp.cuh:RNEAPlan: 8
// threads a knot on the chains of 2 and 7 joints, a warp otherwise; G the
// largest power of 2 up to 8 that fits), runs warp.cuh:rnea_knot: the
// joint transforms a joint a thread; the RNEA forward pass (with qdd, or
// the bias form: two instances, the launcher picks one by qdd == null) and
// the backward accumulation, a level of the tree a phase, a row of each
// joint's 6-vectors a thread (warp.cuh:rnea_forward_knot,
// rnea_backward_knot, which id_du and fd_du run); then c a joint a thread:
// 2 L + 3 phases for a tree of L levels (iiwa 17, hyq 9, atlas 21). The
// robot constants are copied into shared memory once a block and every
// knot's state lives there (warp.cuh:RNEAKnot, 64 NJ values), indexed by
// the run-time topology without local memory. The block reads its (NJ, G)
// input tiles (two without qdd) and writes c as G consecutive lanes a row.
// dynamics.cuh:rnea_lane is the serial function: csrc/opcount.cpp counts
// the bound from it, and the host tests hold the knot program to its bits.
//
// What bounds it on the card: bytes at large batches (a 7-joint lane reads
// at most 21 values and writes 7; 1.4k operations the bound's count); the
// design's limits are the serial phases' latency and the block's head (the
// robot's constants and lists) at small batches.
// G, the threads a knot, the bytes a block and cudaFuncGetAttributes of
// each instance: `gridtorch_rnea_info`.
#include "warp.cuh"

#ifdef __CUDACC__

extern __shared__ double gt_smem[];

// P: the block's shape (RNEAPlan, or another KnotShape to compare)
template <typename T, int NJ, gt::RneaMode MODE, class P>
__global__ void rnea_kernel(const T* __restrict__ model,
                            const T* __restrict__ q,
                            const T* __restrict__ qd,
                            const T* __restrict__ qdd, T* __restrict__ c,
                            long long L, T gravity) {
  using O = gt::RNEAKnot<NJ>;
  constexpr int N = P::LANES, S = P::STRIDE;
  constexpr int INPUTS = MODE == gt::RNEA_BIAS ? 2 : 3;
  auto& R = *reinterpret_cast<gt::RobotConst<T, NJ>*>(gt_smem);
  T* knots = reinterpret_cast<T*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  const int tid = threadIdx.x, nt = blockDim.x, G = nt / N;
  const long long l0 = (long long)blockIdx.x * G;
  R.load_tree(model, tid, nt);
  gt::load_inputs<T, NJ, S, INPUTS>(q, qd, qdd, L, l0, G, knots, tid, nt);
  __syncthreads();
  gt::rnea_knot<MODE, T, NJ>(gt::WarpPar<N>{tid % N, 1 + tid / N}, R,
                             knots + (long long)(tid / N) * S, gravity);
  __syncthreads();
  gt::store_rows<T, S>(knots + O::C, NJ, c, L, l0, G, tid, nt);
}

template <typename T, int NJ, gt::RneaMode MODE, class P>
static int launch_rnea_mode(const void* model, const void* q, const void* qd,
                            const void* qdd, void* c, long long L,
                            double gravity, cudaStream_t stream) {
  static const cudaError_t attr =
      gt::smem_attrs(rnea_kernel<T, NJ, MODE, P>, P::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  rnea_kernel<T, NJ, MODE, P><<<(unsigned)((L + P::G - 1) / P::G),
                                P::LANES * P::G, P::BYTES, stream>>>(
      (const T*)model, (const T*)q, (const T*)qd, (const T*)qdd, (T*)c, L,
      (T)gravity);
  return (int)cudaGetLastError();
}

// qdd may be null: c is then the bias force c(q, qd).
template <typename T, int NJ, class P = gt::RNEAPlan<T, NJ>>
static int launch_rnea(const void* model, const void* q, const void* qd,
                       const void* qdd, void* c, long long L, double gravity,
                       cudaStream_t stream) {
  static_assert(P::G >= 1, "one rnea knot must fit in shared memory");
  if (L == 0) return 0;
  if (qdd == nullptr)
    return launch_rnea_mode<T, NJ, gt::RNEA_BIAS, P>(model, q, qd, qdd, c, L,
                                                     gravity, stream);
  return launch_rnea_mode<T, NJ, gt::RNEA_FULL, P>(model, q, qd, qdd, c, L,
                                                   gravity, stream);
}

extern "C" int gridtorch_rnea(int dtype, int nj, const void* model,
                              const void* q, const void* qd, const void* qdd,
                              void* c, long long L, double gravity,
                              void* stream) {
  GT_DISPATCH(dtype, nj,
              launch_rnea<T, NJ>(model, q, qd, qdd, c, L, gravity,
                                 (cudaStream_t)stream));
}

// The block plan (G; threads a knot; bytes a block) and
// cudaFuncGetAttributes of the instance with qdd (warp.cuh:kernel_info;
// the bias form's plan is the same), into out[11].
extern "C" int gridtorch_rnea_info(int dtype, int nj, int* out) {
  GT_DISPATCH(dtype, nj,
              (gt::kernel_info<gt::RNEAPlan<T, NJ>>(
                  (const void*)
                      rnea_kernel<T, NJ, gt::RNEA_FULL, gt::RNEAPlan<T, NJ>>,
                  out)));
}

#endif
