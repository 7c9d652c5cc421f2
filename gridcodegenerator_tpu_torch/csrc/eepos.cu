// eepos: end-effector poses [x, y, z, roll, pitch, yaw], a thread group a
// lane on d2eepos's chain phases.
//
// Replaces gridcodegenerator_tpu/ops/pallas/kernels.py:eepos_pallas: q
// (NJ, L) -> (6 ne, L). The EEs come from the packed EE buffer
// (ops/cuda/build.py:ee_buffer), one row per EE (its fixed frame and chain
// mask), so one instance per joint count serves every choice of targets.
//
// A block holds G lanes (knots) of LANES threads each (warp.cuh:EEPlan: 8
// threads a lane, G the largest power of 2 up to 8 that fits) at one EE
// (its blockIdx.y): a joint a thread places itself in the EE's chain
// (warp.cuh:EEHead without the twists), then each knot runs
// warp.cuh:eepos_knot, the first phases of d2eepos's knot program: the
// chain joints' transforms a joint a thread, the prefix products
// pre_s+1 = pre_s T_s an entry a thread a phase, F = pre_k Tfix, then the
// pose (the hardware atan2; the TPU kernel needed a polynomial one) a
// component a thread: k + 2 phases for a chain of k joints (iiwa 9), in the
// order of the serial dynamics.cuh:ee_chain_T, so the knot program gives
// the bits of dynamics.cuh:ee_pose_lane, the serial function
// (csrc/opcount.cpp counts the bound from it). Every knot's state lives in
// shared memory (warp.cuh:EEKnot, 29 NJ + 18 values). The block writes each
// of its EE's 6 rows as G consecutive lanes. Resident blocks (as many as
// the card holds at once, a row of them an EE) take every gridDim.x-th
// group of G lanes, so each block builds its head once.
//
// What bounds it on the card: device memory (a lane reads NJ values and
// writes 6 ne; 312 operations a 7-joint lane needs); the design's limit at
// small batches is its k + 2 phases' latency and the block's head.
// G, the threads a lane, the bytes a block and cudaFuncGetAttributes of
// the instance: `gridtorch_eepos_info`.
#include "warp.cuh"

#ifdef __CUDACC__

extern __shared__ double gt_smem[];

// P: the block's shape (EEPlan, or another KnotShape to compare)
template <typename T, int NJ, class P>
__global__ void eepos_kernel(const T* __restrict__ model,
                             const T* __restrict__ ee, int ne,
                             const T* __restrict__ q, T* __restrict__ out,
                             long long L) {
  using O = gt::EEKnot<NJ>;
  constexpr int N = P::LANES, S = P::STRIDE, G = P::G;
  auto& H = *reinterpret_cast<gt::EEHead<T, NJ, false>*>(gt_smem);
  T* knots = reinterpret_cast<T*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  const int tid = threadIdx.x, nt = blockDim.x, e = blockIdx.y;
  T* oe = out + 6LL * e * L;
  H.load(model, tid, nt);
  H.select(ee + e * gt::EERow<NJ>::SIZE, tid, nt);
  // G lanes at a time, gridDim.x G apart: the head is built once a block
  for (long long l0 = (long long)blockIdx.x * G; l0 < L;
       l0 += (long long)gridDim.x * G) {
    gt::load_q<T, NJ, S>(q, L, l0, G, knots, tid, nt);
    __syncthreads();   // and the last group's store has read the poses
    gt::eepos_knot<T, NJ>(gt::WarpPar<N>{tid % N, 1 + tid / N}, H,
                          knots + (long long)(tid / N) * S);
    __syncthreads();
    gt::store_rows<T, S>(knots + O::POSE, 6, oe, L, l0, G, tid, nt);
  }
}

// A row of blocks an EE (gridDim.y = ne), each row as many blocks as the
// card holds at once (at least one).
template <typename T, int NJ, class P = gt::EEPlan<T, NJ>>
static int launch_eepos(const void* model, const void* ee, int ne,
                        const void* q, void* out, long long L,
                        cudaStream_t stream) {
  static_assert(P::G >= 1, "one eepos knot must fit in shared memory");
  if (L == 0 || ne == 0) return 0;
  auto fn = eepos_kernel<T, NJ, P>;
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

extern "C" int gridtorch_eepos(int dtype, int nj, const void* model,
                               const void* ee, int ne, const void* q,
                               void* out, long long L, void* stream) {
  GT_DISPATCH(dtype, nj,
              launch_eepos<T, NJ>(model, ee, ne, q, out, L,
                                  (cudaStream_t)stream));
}

// The block plan (G; threads a lane; bytes a block) and
// cudaFuncGetAttributes of the instance (warp.cuh:kernel_info), into
// out[11].
extern "C" int gridtorch_eepos_info(int dtype, int nj, int* out) {
  GT_DISPATCH(dtype, nj,
              (gt::kernel_info<gt::EEPlan<T, NJ>>(
                  (const void*)eepos_kernel<T, NJ, gt::EEPlan<T, NJ>>, out)));
}

#endif
