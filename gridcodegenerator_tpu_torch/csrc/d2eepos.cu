// d2eepos: the end-effector pose Hessian (6 ne, NJ, NJ), a thread group a
// lane.
//
// Replaces gridcodegenerator_tpu/ops/pallas/kernels.py:d2eepos_pallas. EEs
// come from the packed EE buffer (ops/cuda/build.py:ee_buffer). A block
// holds G lanes (knots), a group of threads each, at one EE (its
// blockIdx.y): a joint a thread places itself in the EE's chain
// (warp.cuh:EEHead, which also holds each joint's constant twist Ttree K
// Ttree^-1), then each knot runs
// warp.cuh:d2eepos_knot: the chain joints' transforms a joint a thread, the
// prefix products an entry a thread a phase, the twists Xi_a of dT/dq_a =
// Xi_a F (F the chain's full transform) a component a thread, dT/dq_a an
// entry a thread, then every pair a <= b of chain joints on its own thread:
// d2T/dq_a dq_b = Xi_a dT/dq_b, cross products of Xi_a's axis with the
// columns of dT/dq_b, through the closed-form second derivative of the
// pose extraction (dynamics.cuh:pose_hvp, exact atan2), into the knot's
// tile, or, where the plan stores directly (warp.cuh:d2_stages: up to 8
// joints, 8 threads a lane, and above 62 joints in float64, where the
// staged knot does not fit a block), straight to device memory. The block
// writes each staged output row as G consecutive lanes, and the zeros,
// wherever the row or the column joint is off the chain, in 128-byte runs
// shared with the neighbouring blocks. Every knot's state lives in shared memory,
// with no device-memory scratch. Resident blocks (as many as the card holds
// at once) take every gridDim.x-th group of G lanes. dynamics.cuh:
// ee_hess_lane is the serial function in the chain form: csrc/opcount.cpp
// counts the bound from it, and the host tests hold the knot program to it
// and to the plain version.
//
// What bounds it on the card: device memory. A lane reads NJ values and
// writes 6 ne NJ^2 (iiwa 294, dm_quadruped 6144), most of them zeros on
// the branched robots; G lanes a row make 32-byte runs. A knot holds
// 63 NJ + 6 NJ^2 + 12 values (warp.cuh:D2Knot; 747 at 7 joints, 3.0 KB
// float32). The plan (warp.cuh:D2Plan), the bytes a block and
// cudaFuncGetAttributes of each instance: `gridtorch_d2eepos_info`.
#include "warp.cuh"

#ifdef __CUDACC__

extern __shared__ double gt_smem[];

// P: the block's shape (D2Plan, or a KnotShape to compare)
template <typename T, int NJ, class P, bool STAGE>
__global__ void d2eepos_kernel(const T* __restrict__ model,
                               const T* __restrict__ ee, int ne,
                               const T* __restrict__ q, T* __restrict__ out,
                               long long L) {
  using E = gt::EERow<NJ>;
  constexpr int N = P::LANES, S = P::STRIDE, G = P::G;
  auto& H = *reinterpret_cast<gt::EEHead<T, NJ>*>(gt_smem);
  T* knots = reinterpret_cast<T*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  const int tid = threadIdx.x, nt = blockDim.x, e = blockIdx.y;
  T* oe = out + 6LL * e * NJ * NJ * L;
  H.load(model, tid, nt);
  H.select(ee + e * E::SIZE, tid, nt);
  // G lanes at a time, gridDim.x G apart: the head is built once a block
  for (long long l0 = (long long)blockIdx.x * G; l0 < L;
       l0 += (long long)gridDim.x * G) {
    gt::load_q<T, NJ, S>(q, L, l0, G, knots, tid, nt);
    __syncthreads();   // and the last group's store has read the tiles
    gt::d2eepos_knot<T, NJ, STAGE>(gt::WarpPar<N>{tid % N, 1 + tid / N}, H,
                                   knots + (long long)(tid / N) * S, oe, L,
                                   l0 + tid / N);
    __syncthreads();
    gt::d2eepos_store<T, NJ, S, G, STAGE>(H, knots, oe, L, l0, tid, nt);
  }
}

// A row of blocks an EE (gridDim.y = ne), each row as many blocks as the
// card holds at once: resident blocks build the head once. On hyq,
// gym_ant and dm_quadruped at 16384 lanes this ran 7-8% faster than one
// row taking the EEs in turn, and 17-32% faster than a block a group of
// lanes (PERF.md).
template <typename T, int NJ, class P = gt::D2Plan<T, NJ>,
          bool STAGE = gt::d2_stages<T, NJ>()>
static int launch_d2eepos(const void* model, const void* ee, int ne,
                          const void* q, void* out, long long L,
                          cudaStream_t stream) {
  static_assert(P::G >= 1, "one d2eepos knot must fit in shared memory");
  if (L == 0 || ne == 0) return 0;
  if (P::BYTES > gt::SMEM_LIMIT) return (int)cudaErrorInvalidConfiguration;
  auto fn = d2eepos_kernel<T, NJ, P, STAGE>;
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

extern "C" int gridtorch_d2eepos(int dtype, int nj, const void* model,
                                 const void* ee, int ne, const void* q,
                                 void* out, long long L, void* stream) {
  GT_DISPATCH(dtype, nj,
              launch_d2eepos<T, NJ>(model, ee, ne, q, out, L,
                                    (cudaStream_t)stream));
}

// The block plan (G; threads a lane; bytes a block) and
// cudaFuncGetAttributes of the instance (warp.cuh:kernel_info), into
// out[10].
extern "C" int gridtorch_d2eepos_info(int dtype, int nj, int* out) {
  GT_DISPATCH(dtype, nj,
              (gt::kernel_info<gt::D2Plan<T, NJ>>(
                  (const void*)d2eepos_kernel<T, NJ, gt::D2Plan<T, NJ>,
                                              gt::d2_stages<T, NJ>()>,
                  out)));
}

#endif
