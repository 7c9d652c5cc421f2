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
// Above 32 joints a knot takes 64 threads or more (a thread a joint and a
// column of a pass); from 48 joints in float32 (34 in float64) no knot
// fits a block, and the knot runs on the device-memory route
// (id_du_ws_kernel, warp.cuh:WsPlan).
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

// The device-memory route (warp.cuh:WsPlan; from 48 joints in float32, 34
// in float64): a knot a block at a time, the robot constants in shared
// memory, the knot's state in the workspace `ws` (a knot a block), the
// blocks striding over the lanes (warp.cuh:ws_lanes).
template <typename T, int NJ, int PASSES>
__global__ void id_du_ws_kernel(const T* __restrict__ model,
                                const T* __restrict__ q,
                                const T* __restrict__ qd,
                                const T* __restrict__ qdd,
                                T* __restrict__ dcdu, long long L, T gravity,
                                T* ws) {
  using O = gt::IDUKnot<NJ, PASSES>;
  constexpr int N = gt::IDUPlan<T, NJ, PASSES>::LANES, S = O::SIZE;
  auto& R = *reinterpret_cast<gt::RobotConst<T, NJ>*>(gt_smem);
  T* k = ws + (long long)blockIdx.x * S;
  const int tid = threadIdx.x;
  R.load(model, tid, N);
  gt::ws_lanes(
      L,
      [&](long long l) {
        gt::load_inputs<T, NJ, S>(q, qd, qdd, L, l, 1, k, tid, N);
      },
      [&] {
        gt::id_du_knot<T, NJ, PASSES>(gt::WarpPar<N>{tid, 1}, R, k, gravity);
      },
      [&](long long l) {
        gt::store_rows<T, S>(k + O::DC, 2 * NJ * NJ, dcdu, L, l, 1, tid, N);
      });
}

template <typename T, int NJ, int PASSES = gt::idu_passes<NJ>()>
static int launch_id_du(const void* model, const void* q, const void* qd,
                        const void* qdd, void* dcdu, long long L,
                        double gravity, cudaStream_t stream,
                        void* ws = nullptr, long long nws = 0) {
  using P = gt::IDUPlan<T, NJ, PASSES>;
  if constexpr (P::WS > 0) {
    return gt::launch_ws<P>(id_du_ws_kernel<T, NJ, PASSES>, L, ws, nws,
                            stream, (const T*)model, (const T*)q,
                            (const T*)qd, (const T*)qdd, (T*)dcdu, L,
                            (T)gravity, (T*)ws);
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

// ws: the workspace of the device-memory route, nws knots, problems or
// blocks (its plan's workspace_bytes each; ops/cuda/build.py:workspace);
// ignored where the plan keeps everything in shared memory.
extern "C" int gridtorch_id_du(int dtype, int nj, const void* model,
                               const void* q, const void* qd, const void* qdd,
                               void* dcdu, long long L, double gravity,
                               void* stream, void* ws, long long nws) {
  GT_DISPATCH(dtype, nj,
              launch_id_du<T, NJ>(model, q, qd, qdd, dcdu, L, gravity,
                                  (cudaStream_t)stream, ws, nws));
}

template <typename T, int NJ, int PASSES = gt::idu_passes<NJ>()>
static int id_du_info(int* out) {
  using P = gt::IDUPlan<T, NJ, PASSES>;
  if constexpr (P::WS > 0)
    return gt::kernel_info<P>((const void*)id_du_ws_kernel<T, NJ, PASSES>,
                              out);
  else
    return gt::kernel_info<P>((const void*)id_du_kernel<T, NJ, PASSES>, out);
}

// The block plan (G; threads a knot; bytes a block) and
// cudaFuncGetAttributes of the instance (warp.cuh:kernel_info), into
// out[10].
extern "C" int gridtorch_id_du_info(int dtype, int nj, int* out) {
  GT_DISPATCH(dtype, nj, (id_du_info<T, NJ>(out)));
}

#endif
