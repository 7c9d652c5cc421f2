// idsva_so: second-order inverse dynamics (4, NJ, NJ, NJ) per lane,
// [d2tau/dq2, d2tau/dqd2, d2tau/dqd dq, dM/dq]; one knot (lane) a warp,
// or a few warps where a knot's shared memory is large.
//
// Replaces gridcodegenerator_tpu/ops/pallas/kernels.py:idsva_so_pallas. The
// TPU kernel traced the analytical algorithm into one Pallas body per lane
// tile, its (joint, ancestor, subtree) loops unrolled at trace time into
// (8, 128) vector operations, and chunked large robots with lax.map to fit
// VMEM. Here a block holds G knots and runs fdsva_so's IDSVA-SO program on
// each (warp.cuh:idsva_so_knot, the program fdsva_so runs after fd_du): the
// stage quantities a row or entry a thread, a level of the tree a phase;
// the nine stages a (j, a, st) triple a thread; the corrections a (j, a)
// pair a thread; the knot's whole 4 NJ^3 tensor accumulating in shared
// memory. Each output value is written to device memory once, G
// consecutive lanes at a time; there is no device-memory scratch. A block
// builds its head (the robot's constants and the (j, a, st) lists: 22-68k
// cycles, mostly on one thread) once and then takes every gridDim.x-th
// group of G lanes; the grid is as many blocks as the card holds at once
// (launch_idsva_so: but for rows of G lanes under 16 bytes).
// so.cuh:idsva_so_lane is the serial function: csrc/opcount.cpp counts the
// bound from it, and the host tests hold the knot program to it.
//
// What bounds it on the card: the output's bytes (4 NJ^3 values a lane,
// 3 NJ read); the design's limits are the serial phases and, on wide trees,
// the knots an SM. A knot (warp.cuh:IDKnot) holds q, qd, qdd, the stage
// quantities and the tensor over their transforms, 3 NJ + 126 NJ + 4 NJ^3
// values: 2275 at 7 joints (9.1 KB in float32), 18448 at 16 (73.8 KB, 147.6
// KB in float64: 2 or 1 knots an SM). The plan (warp.cuh:IDSOPlan: threads
// a knot by joint count, G the largest power of 2 that fits), the bytes a
// block and cudaFuncGetAttributes of each instance:
// `gridtorch_idsva_so_info`.
//
// Where one knot's whole tile does not fit a block (above 23 joints in
// float32, 18 in float64: 91420 values at 28 joints, 366 KB in float32),
// the tile is cut into bands of rows (c, i) (warp.cuh:IDSOBandPlan: the
// fewest that fit; at 28 joints 2 in float32, 5 in float64), a band a
// block: each block runs the whole knot program, keeps the entries of its
// band and sends the others to a sink (so.cuh:SOBand), since no entry's
// update reads another row. The stage quantities and the triples are
// repeated in every band; the output is still written once.
//
// Layout: q, qd, qdd (NJ, L); out (4, NJ, NJ, NJ, L).
#include "warp.cuh"

#ifdef __CUDACC__

extern __shared__ double gt_smem[];

// P: the block's shape (IDSOPlan, or a KnotShape to compare)
template <typename T, int NJ, class P>
__global__ void idsva_so_kernel(const T* __restrict__ model,
                                const T* __restrict__ q,
                                const T* __restrict__ qd,
                                const T* __restrict__ qdd,
                                T* __restrict__ out, long long L, T gravity) {
  using O = gt::IDKnot<NJ>;
  constexpr int N = P::LANES, S = P::STRIDE;
  auto& H = *reinterpret_cast<gt::SOHead<T, NJ>*>(gt_smem);
  T* knots = reinterpret_cast<T*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  const int tid = threadIdx.x, nt = blockDim.x, G = nt / N;
  H.R.load(model, tid, nt);
  __syncthreads();
  if (tid == 0) H.lists.build(H.R);
  // G lanes at a time, gridDim.x G apart: the head above is built once a
  // block, not once a group of G lanes
  for (long long l0 = (long long)blockIdx.x * G; l0 < L;
       l0 += (long long)gridDim.x * G) {
    // the inputs sit below the tile: they load while the last group stores
    gt::load_inputs<T, NJ, S>(q, qd, qdd, L, l0, G, knots, tid, nt);
    __syncthreads();
    gt::idsva_so_knot<T, NJ, O>(gt::WarpPar<N>{tid % N, 1 + tid / N}, H.R,
                                H.lists, knots + (long long)(tid / N) * S,
                                gravity);
    __syncthreads();
    gt::store_rows<T, S>(knots + O::TILE, 4 * O::N3, out, L, l0, G, tid,
                         nt);
  }
}

// The banded kernel (IDSOPlan's G 0, warp.cuh:IDSOBandPlan): block (x, y)
// takes band y, its rows [y BAND_ROWS, (y + 1) BAND_ROWS) of each lane's
// tensor, and every gridDim.x-th group of G lanes; its knots hold that band
// of the tile only. Each output value is written once, by its band's block.
template <typename T, int NJ, class P>
__global__ void idsva_so_band_kernel(const T* __restrict__ model,
                                     const T* __restrict__ q,
                                     const T* __restrict__ qd,
                                     const T* __restrict__ qdd,
                                     T* __restrict__ out, long long L,
                                     T gravity) {
  using O = typename P::Knot;
  constexpr int N = P::LANES, S = P::STRIDE, ROWS = P::BAND_ROWS;
  auto& H = *reinterpret_cast<gt::SOHead<T, NJ>*>(gt_smem);
  T* knots = reinterpret_cast<T*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  const int tid = threadIdx.x, nt = blockDim.x, G = nt / N;
  const int r0 = blockIdx.y * ROWS;
  const int rows = 4 * NJ - r0 < ROWS ? 4 * NJ - r0 : ROWS;
  T* band_out = out + (long long)r0 * NJ * NJ * L;
  H.R.load(model, tid, nt);
  __syncthreads();
  if (tid == 0) H.lists.build(H.R);
  for (long long l0 = (long long)blockIdx.x * G; l0 < L;
       l0 += (long long)gridDim.x * G) {
    gt::load_inputs<T, NJ, S>(q, qd, qdd, L, l0, G, knots, tid, nt);
    __syncthreads();
    gt::idsva_so_knot<T, NJ, O, gt::DFormed, ROWS>(
        gt::WarpPar<N>{tid % N, 1 + tid / N}, H.R, H.lists,
        knots + (long long)(tid / N) * S, gravity, r0);
    __syncthreads();
    gt::store_rows<T, S>(knots + O::TILE, rows * NJ * NJ, band_out, L, l0,
                         G, tid, nt);
  }
}

// The banded launch: blocks resident (a band's head, built once a block, is
// the robot's constants and its (j, a, st) lists: at 28 joints as long as
// a knot's work), gridDim.x of them a band.
template <typename T, int NJ, class P>
static int launch_idsva_so_band(const void* model, const void* q,
                                const void* qd, const void* qdd, void* out,
                                long long L, double gravity,
                                cudaStream_t stream) {
  if (L == 0) return 0;
  if (P::G < 1) return (int)cudaErrorInvalidConfiguration;
  static const cudaError_t attr =
      gt::smem_attrs(idsva_so_band_kernel<T, NJ, P>, P::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  static int per_sm = 0;
  if (per_sm == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, idsva_so_band_kernel<T, NJ, P>, P::LANES * P::G, P::BYTES);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long groups = (L + P::G - 1) / P::G;
  long long most = (long long)(per_sm > 0 ? per_sm : 1) * sms / P::BANDS;
  if (most < 1) most = 1;
  const dim3 grid((unsigned)(most < groups ? most : groups), P::BANDS);
  idsva_so_band_kernel<T, NJ, P><<<grid, P::LANES * P::G, P::BYTES,
                                   stream>>>(
      (const T*)model, (const T*)q, (const T*)qd, (const T*)qdd, (T*)out, L,
      (T)gravity);
  return (int)cudaGetLastError();
}

// `resident`: as many blocks as the card holds at once (each takes every
// gridDim.x-th group), else a block a group. The plan's launch is resident
// where a block's run of a row is 16 bytes or more (G sizeof(T)): there
// the head, built once, saves 12-38%; shorter runs (16 joints in float32,
// 2 lanes) share 32-byte sectors with 3 other blocks' runs, and there a
// block a group (lanes in order) ran 21-70% faster on the large knots of
// hyq and dm_quadruped (compare_kernels.py's knot shapes; PERF.md).
template <typename T, int NJ, class P>
static int launch_idsva_so(const void* model, const void* q, const void* qd,
                           const void* qdd, void* out, long long L,
                           double gravity, cudaStream_t stream,
                           bool resident = P::G * sizeof(T) >= 16) {
  if (L == 0) return 0;
  if (P::G < 1) return (int)cudaErrorInvalidConfiguration;
  static const cudaError_t attr =
      gt::smem_attrs(idsva_so_kernel<T, NJ, P>, P::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  static int per_sm = 0;
  if (per_sm == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, idsva_so_kernel<T, NJ, P>, P::LANES * P::G, P::BYTES);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long groups = (L + P::G - 1) / P::G;
  const long long most = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const long long blocks = resident && most < groups ? most : groups;
  idsva_so_kernel<T, NJ, P><<<(unsigned)blocks, P::LANES * P::G, P::BYTES,
                              stream>>>(
      (const T*)model, (const T*)q, (const T*)qd, (const T*)qdd, (T*)out, L,
      (T)gravity);
  return (int)cudaGetLastError();
}

// the plan that runs: the whole tile where one knot's fits, else bands
template <typename T, int NJ>
static int launch_idsva_so_plan(const void* model, const void* q,
                                const void* qd, const void* qdd, void* out,
                                long long L, double gravity,
                                cudaStream_t stream) {
  if constexpr (NJ > gt::SO_MAX_NJ)   // the wrappers refuse it by name
    return (int)cudaErrorNotSupported;
  else if constexpr (gt::IDSOPlan<T, NJ>::G >= 1)
    return launch_idsva_so<T, NJ, gt::IDSOPlan<T, NJ>>(
        model, q, qd, qdd, out, L, gravity, stream);
  else
    return launch_idsva_so_band<T, NJ, gt::IDSOBandPlan<T, NJ>>(
        model, q, qd, qdd, out, L, gravity, stream);
}

template <typename T, int NJ>
static int idsva_so_info(int* out) {
  if constexpr (NJ > gt::SO_MAX_NJ)
    return gt::kernel_info<gt::IDSOBandPlan<T, NJ>>(nullptr, out);
  else if constexpr (gt::IDSOPlan<T, NJ>::G >= 1)
    return gt::kernel_info<gt::IDSOPlan<T, NJ>>(
        (const void*)idsva_so_kernel<T, NJ, gt::IDSOPlan<T, NJ>>, out);
  else
    return gt::kernel_info<gt::IDSOBandPlan<T, NJ>>(
        (const void*)idsva_so_band_kernel<T, NJ, gt::IDSOBandPlan<T, NJ>>,
        out);
}

extern "C" int gridtorch_idsva_so(int dtype, int nj, const void* model,
                                  const void* q, const void* qd,
                                  const void* qdd, void* out, long long L,
                                  double gravity, void* stream) {
  GT_DISPATCH(dtype, nj,
              (launch_idsva_so_plan<T, NJ>(model, q, qd, qdd, out, L,
                                           gravity, (cudaStream_t)stream)));
}

// The block plan that runs (G, 0 if not even one band of a knot fits;
// threads a knot; bytes a block, for one knot if G is 0; ...; the bands, 1
// for the whole tile) and cudaFuncGetAttributes of its instance
// (warp.cuh:kernel_info), into out[11].
extern "C" int gridtorch_idsva_so_info(int dtype, int nj, int* out) {
  GT_DISPATCH(dtype, nj, (idsva_so_info<T, NJ>(out)));
}

#endif
