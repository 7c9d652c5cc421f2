// fdsva_so: second-order forward dynamics (4, NJ, NJ, NJ) per lane,
// [d2qdd/dq2, d2qdd/dqd2, d2qdd/dqd dq, dMinv/dq]; one knot (lane) a warp,
// or a few warps where a knot's shared memory is large.
//
// Replaces gridcodegenerator_tpu/ops/pallas/kernels.py:fdsva_so_pallas, the
// monolithic route the JAX package takes for nv <= 16 (every instance
// here). A block holds G knots (warp.cuh:fdsva_so_knot): fd_du's knot
// program (df/du, qdd and Minv stay in shared memory), IDSVA-SO at (q, qd,
// qdd) accumulating into the knot's whole 4 NJ^3 tensor in shared memory
// (warp.cuh:idsva_so_knot, the program csrc/idsva_so.cu runs alone: the
// stage quantities a row or entry a thread, a level of the tree a phase;
// the nine stages a (j, a, st) triple a thread; the corrections a (j, a)
// pair a thread), then the implicit-function contractions of
// ops/so.py:fdsva_compose, a (c, j, k) column a thread, in place. Each
// output value is written to device memory once, G consecutive lanes at a
// time; there is no device-memory scratch.
//
// What bounds it on the card: the output's bytes (4 NJ^3 values a lane);
// the design's limits are the serial phases and shared-memory bandwidth.
// A knot holds the tensor and the stage quantities over fd_du's work
// space, 4 NJ^3 + 3 NJ^2 + 130 NJ values: 19.2k at 16 joints (77 KB in
// float32, 154 KB in float64), so one or two knots fit an SM; a knot
// then takes 2 or 4 warps (warp.cuh:BlockPlan: the width that puts the
// most knots, then warps, on an SM), which meet at a named barrier after
// each phase. G, the threads a knot, the bytes a block and
// cudaFuncGetAttributes of each instance: `gridtorch_fdsva_so_info`. The
// plans (G x threads a knot, bytes a block), float32 | float64:
//   2 joints   2 x 16, 4688    | 4 x 16, 16912
//   7 joints   4 x 16, 43072   | 5 x 32, 104368
//   8 joints   8 x 32, 109600  | 8 x 32, 218368
//   12 joints  6 x 64, 222112  | 3 x 64, 227024
//   16 joints  2 x 128, 167008 | 1 x 128, 173984
//
// Layout: q, qd, u (NJ, L); out (4, NJ, NJ, NJ, L).
#include "warp.cuh"

#ifdef __CUDACC__

extern __shared__ double gt_smem[];

template <typename T, int NJ>
__global__ void fdsva_so_kernel(const T* __restrict__ model,
                                const T* __restrict__ q,
                                const T* __restrict__ qd,
                                const T* __restrict__ u, T* __restrict__ out,
                                long long L, T gravity) {
  using O = gt::SOKnot<NJ>;
  using P = gt::SOPlan<T, NJ>;
  constexpr int N = P::LANES, S = P::STRIDE;
  auto& H = *reinterpret_cast<gt::SOHead<T, NJ>*>(gt_smem);
  T* knots = reinterpret_cast<T*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  const int tid = threadIdx.x, nt = blockDim.x, G = nt / N;
  const long long l0 = (long long)blockIdx.x * G;
  H.R.load(model, tid, nt);
  gt::load_inputs<T, NJ, S>(q, qd, u, L, l0, G, knots, tid, nt);
  __syncthreads();
  if (tid == 0) H.lists.build(H.R);
  __syncthreads();
  gt::fdsva_so_knot<T, NJ>(gt::WarpPar<N>{tid % N, 1 + tid / N}, H.R,
                           H.lists, knots + (long long)(tid / N) * S, gravity);
  __syncthreads();
  gt::store_rows<T, S>(knots + O::TILE, 4 * O::N3, out, L, l0, G, tid, nt);
}

template <typename T, int NJ>
static int launch_fdsva_so(const void* model, const void* q, const void* qd,
                           const void* u, void* out, long long L,
                           double gravity, cudaStream_t stream) {
  using P = gt::SOPlan<T, NJ>;
  // where one knot does not fit a block the wrappers take the composed
  // route (fd_du, idsva_so, the contractions), and no kernel is built
  if constexpr (P::G < 1) {
    return (int)cudaErrorInvalidConfiguration;
  } else {
    if (L == 0) return 0;
    static const cudaError_t attr = cudaFuncSetAttribute(
        fdsva_so_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)P::BYTES);
    if (attr != cudaSuccess) return (int)attr;
    fdsva_so_kernel<T, NJ><<<(unsigned)((L + P::G - 1) / P::G),
                             P::LANES * P::G, P::BYTES, stream>>>(
        (const T*)model, (const T*)q, (const T*)qd, (const T*)u, (T*)out, L,
        (T)gravity);
    return (int)cudaGetLastError();
  }
}

template <typename T, int NJ>
static int fdsva_so_info(int* out) {
  if constexpr (gt::SOPlan<T, NJ>::G < 1)
    return gt::kernel_info<gt::SOPlan<T, NJ>>(nullptr, out);
  else
    return gt::kernel_info<gt::SOPlan<T, NJ>>(
        (const void*)fdsva_so_kernel<T, NJ>, out);
}

extern "C" int gridtorch_fdsva_so(int dtype, int nj, const void* model,
                                  const void* q, const void* qd,
                                  const void* u, void* out, long long L,
                                  double gravity, void* stream) {
  GT_DISPATCH(dtype, nj,
              launch_fdsva_so<T, NJ>(model, q, qd, u, out, L, gravity,
                                     (cudaStream_t)stream));
}

// The block plan (G, 0 if one knot does not fit; threads a knot; bytes a
// block, for one knot if G is 0) and cudaFuncGetAttributes of the instance
// (warp.cuh:kernel_info), into out[10].
extern "C" int gridtorch_fdsva_so_info(int dtype, int nj, int* out) {
  GT_DISPATCH(dtype, nj, (fdsva_so_info<T, NJ>(out)));
}

#endif
