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
// Above IDSO_BANDS_MAX_NJ = 28 joints (warp.cuh:idso_route; the bands and
// the band's head grow with the joints: at 52 joints 52 bands in float32
// and none in float64, whose knot of 4 rows does not fit), the tile goes
// to device memory (warp.cuh:IDSOTilePlan):
// a block holds the robot constants and G knots' inputs and stage
// quantities (225 NJ values a knot), each knot runs its program once, and
// its stages and corrections read-modify-write their entries in the
// output itself, lane stride L, G adjacent lanes a block; the launcher
// zeroes the output first (a memset: most of a knot's 4 NJ^3 entries are
// zero; the stages touch 35.7k of 562k at 52 joints, 14.0k of 157k at 34,
// counted by the host build's race check). The (j, a, st) lists are
// the robot's, built on the host by SOLists itself (gridtorch_so_lists:
// 2034 triples and 394 pairs at 52 joints, 9.7 KB, where the arrays sized
// for a chain take 110 KB), copied to the card once a model
// (ops/cuda/build.py:so_lists) and read from device memory. No workspace:
// the tile is the output. The library builds only the route idso_route
// picks at its joint count.
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

// The device-memory tile's kernel (warp.cuh:IDSOTilePlan): G knots a
// block, each knot's inputs and stage quantities in shared memory after the
// robot constants, each knot's tensor accumulated in place in `out` (zeroed
// by the launcher), knot g at lane l0 + g; the blocks resident, each taking
// every gridDim.x-th group of G lanes. The (j, a, st) lists are the robot's
// (`lists`: ntrip triples, then npair pairs, ops/cuda/build.py:so_lists),
// read from device memory through L1.
template <typename T, int NJ, class P>
__global__ void __launch_bounds__(P::LANES * gt::plan_g<P>())
    idsva_so_tile_kernel(const T* __restrict__ model,
                         const T* __restrict__ q, const T* __restrict__ qd,
                         const T* __restrict__ qdd, T* __restrict__ out,
                         long long L, T gravity,
                         const int* __restrict__ lists, int ntrip,
                         int npair) {
  constexpr int N = P::LANES, S = P::STRIDE;
  auto& R = *reinterpret_cast<gt::RobotConst<T, NJ>*>(gt_smem);
  T* knots = reinterpret_cast<T*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  const int tid = threadIdx.x, nt = blockDim.x, G = nt / N, g = tid / N;
  const gt::SOListView lv{ntrip, npair, lists, lists + ntrip};
  R.load_tree(model, tid, nt);
  for (long long l0 = (long long)blockIdx.x * G; l0 < L;
       l0 += (long long)gridDim.x * G) {
    __syncthreads();   // the head has landed; the last group's knots are done
    gt::load_inputs<T, NJ, S>(q, qd, qdd, L, l0, G, knots, tid, nt);
    __syncthreads();
    if (l0 + g < L)   // a knot's threads skip together
      gt::idsva_so_knot_to<T, NJ>(gt::WarpPar<N>{tid % N, 1 + g}, R, lv,
                                  knots + (long long)g * S, gravity,
                                  out + l0 + g, L);
  }
}

// The device-memory tile's launch: the output zeroed (one memset of 4 NJ^3
// L values), then as many blocks as the card holds at once.
template <typename T, int NJ, class P>
static int launch_idsva_so_tile(const void* model, const void* q,
                                const void* qd, const void* qdd, void* out,
                                long long L, double gravity,
                                cudaStream_t stream, const int* lists,
                                int ntrip, int npair) {
  if (L == 0) return 0;
  if (P::G < 1) return (int)cudaErrorInvalidConfiguration;
  if (lists == nullptr || ntrip < 1 || npair < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t zero = cudaMemsetAsync(
      out, 0, (size_t)L * 4 * NJ * NJ * NJ * sizeof(T), stream);
  if (zero != cudaSuccess) return (int)zero;
  static const cudaError_t attr =
      gt::smem_attrs(idsva_so_tile_kernel<T, NJ, P>, P::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  static int per_sm = 0;
  if (per_sm == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, idsva_so_tile_kernel<T, NJ, P>, P::LANES * P::G, P::BYTES);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long groups = (L + P::G - 1) / P::G;
  const long long most = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  idsva_so_tile_kernel<T, NJ, P><<<(unsigned)(most < groups ? most : groups),
                                   P::LANES * P::G, P::BYTES, stream>>>(
      (const T*)model, (const T*)q, (const T*)qd, (const T*)qdd, (T*)out, L,
      (T)gravity, lists, ntrip, npair);
  return (int)cudaGetLastError();
}

// The route warp.cuh:idso_route picks at NJ joints in T, the only one
// instantiated: the whole tile where it fits a block, else the bands up to
// IDSO_BANDS_MAX_NJ joints, else the device tile.
template <typename T, int NJ>
static int launch_idsva_so_route(const void* model, const void* q,
                                 const void* qd, const void* qdd, void* out,
                                 long long L, double gravity,
                                 cudaStream_t stream, const int* lists,
                                 int ntrip, int npair) {
  constexpr int route = gt::idso_route<T, NJ>();
  if constexpr (route == gt::IDSO_WHOLE)
    return launch_idsva_so<T, NJ, gt::IDSOPlan<T, NJ>>(
        model, q, qd, qdd, out, L, gravity, stream);
  else if constexpr (route == gt::IDSO_BANDS)
    return launch_idsva_so_band<T, NJ, gt::IDSOBandPlan<T, NJ>>(
        model, q, qd, qdd, out, L, gravity, stream);
  else
    return launch_idsva_so_tile<T, NJ, gt::IDSOTilePlan<T, NJ>>(
        model, q, qd, qdd, out, L, gravity, stream, lists, ntrip, npair);
}

template <typename T, int NJ>
static int idsva_so_info(int* out) {
  constexpr int route = gt::idso_route<T, NJ>();
  if constexpr (route == gt::IDSO_WHOLE)
    return gt::kernel_info<gt::IDSOPlan<T, NJ>>(
        (const void*)idsva_so_kernel<T, NJ, gt::IDSOPlan<T, NJ>>, out);
  else if constexpr (route == gt::IDSO_BANDS)
    return gt::kernel_info<gt::IDSOBandPlan<T, NJ>>(
        (const void*)idsva_so_band_kernel<T, NJ, gt::IDSOBandPlan<T, NJ>>,
        out);
  else
    return gt::kernel_info<gt::IDSOTilePlan<T, NJ>>(
        (const void*)idsva_so_tile_kernel<T, NJ, gt::IDSOTilePlan<T, NJ>>,
        out);
}

// lists, ntrip, npair: the robot's (j, a, st) triples and (j, a) pairs
// (gridtorch_so_lists, on the card), which the device tile reads (the
// other routes build theirs in shared memory).
extern "C" int gridtorch_idsva_so(int dtype, int nj, const void* model,
                                  const void* q, const void* qd,
                                  const void* qdd, void* out, long long L,
                                  double gravity, void* stream,
                                  const int* lists, int ntrip, int npair) {
  GT_DISPATCH(dtype, nj,
              (launch_idsva_so_route<T, NJ>(model, q, qd, qdd, out, L,
                                            gravity, (cudaStream_t)stream,
                                            lists, ntrip, npair)));
}

// The robot's (j, a, st) triples, then its (j, a) pairs, on the host
// (warp.cuh:so_lists_host, SOLists' order): `model` the packed model
// buffer in double on the host, `out` room for SOLists<NJ>'s MAX_TRIPLES +
// MAX_PAIRS ints, counts[0..1] = ntrip, npair.
extern "C" int gridtorch_so_lists(int nj, const double* model, int* out,
                                  int* counts) {
  constexpr int NJ = GT_NJ;
  if (nj != NJ) return (int)cudaErrorInvalidValue;
  std::vector<gt::RobotConst<double, NJ>> R(1);
  R[0].load(model, 0, 1);
  const std::vector<int> lists =
      gt::so_lists_host<NJ>(R[0], counts, counts + 1);
  for (size_t e = 0; e < lists.size(); ++e) out[e] = lists[e];
  return 0;
}

// The block plan of the route that runs (G; threads a knot; bytes a block;
// ...; the bands, 1 but in bands; 1 on the device tile) and
// cudaFuncGetAttributes of its instance (warp.cuh:kernel_info).
extern "C" int gridtorch_idsva_so_info(int dtype, int nj, int* out) {
  GT_DISPATCH(dtype, nj, (idsva_so_info<T, NJ>(out)));
}

#endif
