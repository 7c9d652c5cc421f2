// deepos: the end-effector pose Jacobian (6 ne, NJ, L), a thread group a
// lane on d2eepos's twist phases.
//
// Replaces gridcodegenerator_tpu/ops/pallas/kernels.py:deepos_pallas. The
// EEs come from the packed EE buffer (ops/cuda/build.py:ee_buffer), one row
// per EE (its fixed frame and chain mask), so one instance per joint count
// serves every choice of targets.
//
// A block holds G lanes (knots) of LANES threads each (warp.cuh:DJPlan: 4
// threads a lane, G = 16, the knots 4 banks apart) at one EE (its
// blockIdx.y): a joint a thread places itself in the EE's chain
// and forms its constant twist (warp.cuh:EEHead), then each knot runs
// warp.cuh:deepos_knot: d2eepos's first phases (warp.cuh:ee_twist_knot: the
// chain joints' transforms a joint a thread, the prefix and suffix products
// an entry a thread a phase, the twists xi_a and the chain's full transform
// F = T_0 suf_0, then dF/dq_a = Xi_a F an entry a thread), then the pose
// JVP at F along each dF/dq_a, a (component, joint) a thread: k + 3 phases
// for a chain of k joints (iiwa 10). The serial function,
// dynamics.cuh:ee_jac_lane, takes two 4x4 products a chain joint (prefix_a
// dT_a suffix_a) where the knot takes a cross product an entry; it stays
// the reference that the host tests and csrc/opcount.cpp hold the knot
// program against. Every knot's state lives in shared memory (warp.cuh:
// DJKnot, 51 NJ + 12 values). The block writes each of its EE's 6 NJ rows
// as G consecutive lanes: a chain joint's from the knots' tiles, a joint
// off the chain's zeros, which read no lane's state. Resident blocks (as
// many as the card holds at once, a row of them an EE) take every
// gridDim.x-th group of G lanes, so each block builds its head once.
//
// What bounds it on the card: device memory (a lane reads NJ values and
// writes 6 ne NJ; a 7-joint lane needs 1.2k operations); the design's
// limit at small batches is its k + 3 phases' latency and the block's head.
// G, the threads a lane, the bytes a block and cudaFuncGetAttributes of
// the instance: `gridtorch_deepos_info`.
#include "warp.cuh"

#ifdef __CUDACC__

extern __shared__ double gt_smem[];

// P: the block's shape (DJPlan, or another KnotShape to compare)
template <typename T, int NJ, class P>
__global__ void deepos_kernel(const T* __restrict__ model,
                              const T* __restrict__ ee, int ne,
                              const T* __restrict__ q, T* __restrict__ out,
                              long long L) {
  constexpr int N = P::LANES, S = P::STRIDE, G = P::G;
  auto& H = *reinterpret_cast<gt::EEHead<T, NJ>*>(gt_smem);
  T* knots = reinterpret_cast<T*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  const int tid = threadIdx.x, nt = blockDim.x, e = blockIdx.y;
  T* oe = out + 6LL * e * NJ * L;
  H.load(model, tid, nt);
  H.select(ee + e * gt::EERow<NJ>::SIZE, tid, nt);
  // G lanes at a time, gridDim.x G apart: the head is built once a block
  for (long long l0 = (long long)blockIdx.x * G; l0 < L;
       l0 += (long long)gridDim.x * G) {
    gt::load_q<T, NJ, S>(q, L, l0, G, knots, tid, nt);
    __syncthreads();   // and the last group's store has read the tiles
    gt::deepos_knot<T, NJ>(gt::WarpPar<N>{tid % N, 1 + tid / N}, H,
                           knots + (long long)(tid / N) * S);
    __syncthreads();
    gt::deepos_store<T, NJ, S, G>(H, knots, oe, L, l0, tid, nt);
  }
}

// A row of blocks an EE (gridDim.y = ne), each row as many blocks as the
// card holds at once (at least one).
template <typename T, int NJ, class P = gt::DJPlan<T, NJ>>
static int launch_deepos(const void* model, const void* ee, int ne,
                         const void* q, void* out, long long L,
                         cudaStream_t stream) {
  static_assert(P::G >= 1, "one deepos knot must fit in shared memory");
  if (L == 0 || ne == 0) return 0;
  auto fn = deepos_kernel<T, NJ, P>;
  static const cudaError_t attr = gt::smem_attrs(fn, P::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  static int per_sm = 0;
  if (per_sm == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                  P::LANES * P::G, P::BYTES);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long groups = (L + P::G - 1) / P::G;
  long long most = (long long)(per_sm > 0 ? per_sm : 1) * sms / ne;
  if (most < 1) most = 1;
  fn<<<dim3((unsigned)(most < groups ? most : groups), (unsigned)ne),
       P::LANES * P::G, P::BYTES, stream>>>(
      (const T*)model, (const T*)ee, ne, (const T*)q, (T*)out, L);
  return (int)cudaGetLastError();
}

extern "C" int gridtorch_deepos(int dtype, int nj, const void* model,
                                const void* ee, int ne, const void* q,
                                void* out, long long L, void* stream) {
  GT_DISPATCH(dtype, nj,
              launch_deepos<T, NJ>(model, ee, ne, q, out, L,
                                   (cudaStream_t)stream));
}

// The block plan (G; threads a lane; bytes a block) and
// cudaFuncGetAttributes of the instance (warp.cuh:kernel_info), into
// out[11].
extern "C" int gridtorch_deepos_info(int dtype, int nj, int* out) {
  GT_DISPATCH(dtype, nj,
              (gt::kernel_info<gt::DJPlan<T, NJ>>(
                  (const void*)deepos_kernel<T, NJ, gt::DJPlan<T, NJ>>,
                  out)));
}

#endif
