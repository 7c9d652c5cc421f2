// riccati_factored and riccati: the backward Riccati sweeps.
//
// riccati_factored replaces gridcodegenerator_tpu/ops/pallas/sweeps.py:
// riccati_pallas_factored (a Gauss-Newton-factored stage cost); riccati
// replaces sweeps.py:riccati_pallas (dense curvature blocks per knot, or one
// stationary block). The TPU kernels walked the knots as a sequential
// "arbitrary" grid axis in reverse and carried (Vx, Vxx) in VMEM scratch
// between grid steps. Blocks on the GPU run in no order, so the knot loop
// t = N-1 .. 0 runs inside the block.
//
// Per knot (riccati_knot): Qx = lx + A^T Vx, Qu = lu + B^T Vx,
// Qxx = lxx + A^T Vxx A, Qux = lux + B^T Vxx A, Quu = luu + B^T Vxx B, with
// the curvature (lxx, luu, lux) added by a policy: FactoredCurv forms
// blkdiag(Jw^T Jw, qd_diag I), u_diag I and 0 from the factor, DenseCurv
// adds the blocks it holds. Quu + reg I is inverted by pivot-free
// Gauss-Jordan; the value update is the full form (it cancels the
// regularization to O(reg^2)), then symmetrized.
//
// Both run a warp per problem (csrc/sweep_warp.cuh: riccati_knot_warp,
// 6 + NJ phases a knot, an entry of each product a thread), G problems a
// block, (Vx, Vxx) and the knot's Q blocks in shared memory; the block
// stages each knot's A, B, lx, lu and curvature for its G problems with
// cp.async into a second buffer while the knot before is computed (G lanes
// a row: whole sectors), and writes k and K G lanes a row. The curvature is
// the knot program's input policy: FactoredIn (the factor Jw in the tile),
// DenseIn (the dense blocks in the tile, or a stationary block staged once
// into each problem's state before the first knot; each its own layout and
// plan). What bounds them on the card: bytes and operations in equal
// measure (A and B are read once; O(NX^3) a knot); the design's limits are
// the knot's serial phases and shared-memory bandwidth. The plans (problems
// a block x threads a problem, bytes a block):
// `gridtorch_riccati_factored_info`, `gridtorch_riccati_info` (stationary),
// `gridtorch_riccati_stacked_info`. riccati_lane and riccati_dense_lane are
// the serial functions: csrc/opcount.cpp counts the bound from them, and
// the host tests hold the block code to their bits. Where not even one
// problem fits a block (from 30 to 48 joints, by curvature and dtype),
// riccati_factored runs a problem a block at a time with 128 threads, its
// state in device memory staged by plain copies (riccati_ws,
// sweep_warp.cuh:RicPlan). The dense sweep from 29 joints (warp.cuh:
// CHIP_FROM; stationary or a block per knot) keeps each problem
// on chip instead (riccati_chip_kernel, sweep_warp.cuh:RicChipPlan,
// riccati_chip_knot): a problem a block of 512 threads, or a
// thread-block cluster of 2 or 4 blocks of 256 whose shared memory holds
// the problem's regions between them (from 55 | 39 joints); the knot's
// products are 4 x 4 register tiles a thread over rows of shared memory,
// [Vxx A | Vxx B] a slab of columns at a time folded into Qxx, Qux and
// Quu, A and B of the next knot staged with cp.async once the slabs are
// folded. What bounds it on the card: operations (O(NX^3) a knot); float32
// stays on FP32 FMAs (TF32 keeps 3 digits) and float64 on FP64 FMAs (no
// tensor-core instruction), and one problem an SM sets how many tiles a
// phase has.
//
// Layouts: A (N, NX, NX, B), Bm (N, NX, NJ, B), Vx0 (NX, B),
// Vxx0 (NX, NX, B); outputs k (N, NJ, B), K (N, NJ, NX, B).
// riccati_factored: lx (NX, N B), lu (NJ, N B), Jw (r, NJ, N B) in the
// solver's knot-major lane layout, lane t B + b. riccati: lx (N, NX, B),
// lu (N, NJ, B); lxx (NX, NX, B), luu (NJ, NJ, B), lux (NJ, NX, B), each
// with a leading N axis unless stationary.
#include "sweep_warp.cuh"

namespace gt {

template <typename T, int NJ, class Curv>
GT_HD void riccati_knot(const T* At, const T* Bt, const T* lx, const T* lu,
                        const Curv& cv, T reg, T* Vx, T* Vxx, T* kt,
                        T* Kt) {
  constexpr int NX = 2 * NJ;
  // Qx = lx + A^T Vx, Qu = lu + B^T Vx
  T Qx[NX], Qu[NJ];
  for (int i = 0; i < NX; ++i) {
    T s = At[i] * Vx[0];
    for (int k = 1; k < NX; ++k) s += At[k * NX + i] * Vx[k];
    Qx[i] = lx[i] + s;
  }
  for (int i = 0; i < NJ; ++i) {
    T s = Bt[i] * Vx[0];
    for (int k = 1; k < NX; ++k) s += Bt[k * NJ + i] * Vx[k];
    Qu[i] = lu[i] + s;
  }
  // VA = Vxx A; Qxx = A^T VA + lxx
  T VA[NX * NX];
  for (int i = 0; i < NX; ++i)
    for (int j = 0; j < NX; ++j) {
      T s = Vxx[i * NX] * At[j];
      for (int k = 1; k < NX; ++k) s += Vxx[i * NX + k] * At[k * NX + j];
      VA[i * NX + j] = s;
    }
  T Qxx[NX * NX];
  for (int i = 0; i < NX; ++i)
    for (int j = 0; j < NX; ++j) {
      T s = At[i] * VA[j];
      for (int k = 1; k < NX; ++k) s += At[k * NX + i] * VA[k * NX + j];
      Qxx[i * NX + j] = s;
    }
  cv.add_xx(Qxx);
  // Qux = B^T VA + lux; Quu = B^T Vxx B + luu
  T Qux[NJ * NX];
  for (int i = 0; i < NJ; ++i)
    for (int j = 0; j < NX; ++j) {
      T s = Bt[i] * VA[j];
      for (int k = 1; k < NX; ++k) s += Bt[k * NJ + i] * VA[k * NX + j];
      Qux[i * NX + j] = s;
    }
  cv.add_ux(Qux);
  T VB[NX * NJ];
  for (int i = 0; i < NX; ++i)
    for (int j = 0; j < NJ; ++j) {
      T s = Vxx[i * NX] * Bt[j];
      for (int k = 1; k < NX; ++k) s += Vxx[i * NX + k] * Bt[k * NJ + j];
      VB[i * NJ + j] = s;
    }
  T Quu[NJ * NJ], Qreg[NJ * NJ], Qinv[NJ * NJ];
  for (int i = 0; i < NJ; ++i)
    for (int j = 0; j < NJ; ++j) {
      T s = Bt[i] * VB[j];
      for (int k = 1; k < NX; ++k) s += Bt[k * NJ + i] * VB[k * NJ + j];
      Quu[i * NJ + j] = s;
    }
  cv.add_uu(Quu);
  for (int i = 0; i < NJ * NJ; ++i) Qreg[i] = Quu[i];
  for (int i = 0; i < NJ; ++i) Qreg[i * NJ + i] = Quu[i * NJ + i] + reg;
  gj_inverse<T, NJ>(Qreg, Qinv);
  // k = -Quu^-1 Qu, K = -Quu^-1 Qux
  for (int i = 0; i < NJ; ++i) {
    T s = Qinv[i * NJ] * Qu[0];
    for (int j = 1; j < NJ; ++j) s += Qinv[i * NJ + j] * Qu[j];
    kt[i] = -s;
    for (int m = 0; m < NX; ++m) {
      T sm = Qinv[i * NJ] * Qux[m];
      for (int j = 1; j < NJ; ++j) sm += Qinv[i * NJ + j] * Qux[j * NX + m];
      Kt[i * NX + m] = -sm;
    }
  }
  // full value update
  T Quuk[NJ], QuuK[NJ * NX];
  for (int i = 0; i < NJ; ++i) {
    T s = Quu[i * NJ] * kt[0];
    for (int j = 1; j < NJ; ++j) s += Quu[i * NJ + j] * kt[j];
    Quuk[i] = s;
    for (int m = 0; m < NX; ++m) {
      T sm = Quu[i * NJ] * Kt[m];
      for (int j = 1; j < NJ; ++j) sm += Quu[i * NJ + j] * Kt[j * NX + m];
      QuuK[i * NX + m] = sm;
    }
  }
  for (int m = 0; m < NX; ++m) {
    T s1 = Kt[m] * Quuk[0], s2 = Kt[m] * Qu[0], s3 = Qux[m] * kt[0];
    for (int i = 1; i < NJ; ++i) {
      s1 += Kt[i * NX + m] * Quuk[i];
      s2 += Kt[i * NX + m] * Qu[i];
      s3 += Qux[i * NX + m] * kt[i];
    }
    Vx[m] = Qx[m] + s1 + s2 + s3;
  }
  for (int m = 0; m < NX; ++m)
    for (int l = 0; l < NX; ++l) {
      T s1 = Kt[m] * QuuK[l], s2 = Kt[m] * Qux[l], s3 = Qux[m] * Kt[l];
      for (int i = 1; i < NJ; ++i) {
        s1 += Kt[i * NX + m] * QuuK[i * NX + l];
        s2 += Kt[i * NX + m] * Qux[i * NX + l];
        s3 += Qux[i * NX + m] * Kt[i * NX + l];
      }
      VA[m * NX + l] = Qxx[m * NX + l] + s1 + s2 + s3;   // VA reused as Vxx'
    }
  for (int m = 0; m < NX; ++m)
    for (int l = 0; l < NX; ++l)
      Vxx[m * NX + l] = T(0.5) * (VA[m * NX + l] + VA[l * NX + m]);
}

// lxx = blkdiag(Jw^T Jw, qd_diag I), luu = u_diag I, lux = 0, from the
// factor Jw (r, NJ, N B) at knot-major lane ln.
template <typename T, int NJ>
struct FactoredCurv {
  const T* Jw;
  long long NB, ln;
  int r;
  T qd_diag, u_diag;
  GT_HD void add_xx(T* Qxx) const {
    constexpr int NX = 2 * NJ;
    for (int i = 0; i < NJ; ++i)
      for (int j = 0; j < NJ; ++j) {
        T s = Jw[(long long)i * NB + ln] * Jw[(long long)j * NB + ln];
        for (int rr = 1; rr < r; ++rr)
          s += Jw[((long long)rr * NJ + i) * NB + ln] *
               Jw[((long long)rr * NJ + j) * NB + ln];
        Qxx[i * NX + j] += s;
      }
    for (int i = NJ; i < NX; ++i) Qxx[i * NX + i] += qd_diag;
  }
  GT_HDI void add_ux(T*) const {}
  GT_HD void add_uu(T* Quu) const {
    for (int i = 0; i < NJ; ++i) Quu[i * NJ + i] += u_diag;
  }
};

// Dense curvature blocks held by the lane: load() reads one knot's (or the
// stationary) lxx, luu, lux of problem b at element offset `off` of each
// block's (..., B) layout.
template <typename T, int NJ>
struct DenseCurv {
  static constexpr int NX = 2 * NJ;
  T lxx[NX * NX], luu[NJ * NJ], lux[NJ * NX];
  GT_HD void load(const T* gxx, const T* guu, const T* gux, long long t,
                  long long B, long long b) {
    for (int i = 0; i < NX * NX; ++i)
      lxx[i] = gxx[(t * NX * NX + i) * B + b];
    for (int i = 0; i < NJ * NJ; ++i) luu[i] = guu[(t * NJ * NJ + i) * B + b];
    for (int i = 0; i < NJ * NX; ++i) lux[i] = gux[(t * NJ * NX + i) * B + b];
  }
  GT_HD void add_xx(T* Qxx) const {
    for (int i = 0; i < NX * NX; ++i) Qxx[i] += lxx[i];
  }
  GT_HD void add_ux(T* Qux) const {
    for (int i = 0; i < NJ * NX; ++i) Qux[i] += lux[i];
  }
  GT_HD void add_uu(T* Quu) const {
    for (int i = 0; i < NJ * NJ; ++i) Quu[i] += luu[i];
  }
};

// Knot t's A and B of problem b, and the terminal value function.
template <typename T, int NJ>
GT_HD void riccati_load_ab(const T* A, const T* Bm, int t, long long B,
                           long long b, T* At, T* Bt) {
  constexpr int NX = 2 * NJ;
  for (int i = 0; i < NX * NX; ++i)
    At[i] = A[((long long)t * NX * NX + i) * B + b];
  for (int i = 0; i < NX * NJ; ++i)
    Bt[i] = Bm[((long long)t * NX * NJ + i) * B + b];
}

template <typename T, int NJ>
GT_HD void riccati_store(T* ks, T* Ks, int t, long long B, long long b,
                         const T* kt, const T* Kt) {
  constexpr int NX = 2 * NJ;
  for (int i = 0; i < NJ; ++i) {
    ks[((long long)t * NJ + i) * B + b] = kt[i];
    for (int m = 0; m < NX; ++m)
      Ks[(((long long)t * NJ + i) * NX + m) * B + b] = Kt[i * NX + m];
  }
}

// One problem serially: the arithmetic the function needs
// (csrc/opcount.cpp counts it for the bound).
template <typename T, int NJ>
GT_HD void riccati_lane(const T* A, const T* Bm, const T* lx, const T* lu,
                        const T* Jw, const T* Vx0, const T* Vxx0, T* ks,
                        T* Ks, int N, long long B, int r, long long b, T reg,
                        T qd_diag, T u_diag) {
  constexpr int NX = 2 * NJ;
  const long long NB = (long long)N * B;
  T Vx[NX], Vxx[NX * NX];
  for (int i = 0; i < NX; ++i) Vx[i] = Vx0[i * B + b];
  for (int i = 0; i < NX * NX; ++i) Vxx[i] = Vxx0[i * B + b];
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int t = N - 1; t >= 0; --t) {
    T At[NX * NX], Bt[NX * NJ], lxt[NX], lut[NJ], kt[NJ], Kt[NJ * NX];
    riccati_load_ab<T, NJ>(A, Bm, t, B, b, At, Bt);
    const long long ln = (long long)t * B + b;
    for (int i = 0; i < NX; ++i) lxt[i] = lx[i * NB + ln];
    for (int i = 0; i < NJ; ++i) lut[i] = lu[i * NB + ln];
    const FactoredCurv<T, NJ> cv{Jw, NB, ln, r, qd_diag, u_diag};
    riccati_knot<T, NJ>(At, Bt, lxt, lut, cv, reg, Vx, Vxx, kt, Kt);
    riccati_store<T, NJ>(ks, Ks, t, B, b, kt, Kt);
  }
}

template <typename T, int NJ>
GT_HD void riccati_dense_lane(const T* A, const T* Bm, const T* lx,
                              const T* lu, const T* lxx, const T* luu,
                              const T* lux, bool stationary, const T* Vx0,
                              const T* Vxx0, T* ks, T* Ks, int N,
                              long long B, long long b, T reg) {
  constexpr int NX = 2 * NJ;
  T Vx[NX], Vxx[NX * NX];
  for (int i = 0; i < NX; ++i) Vx[i] = Vx0[i * B + b];
  for (int i = 0; i < NX * NX; ++i) Vxx[i] = Vxx0[i * B + b];
  DenseCurv<T, NJ> cv;
  if (stationary) cv.load(lxx, luu, lux, 0, B, b);
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int t = N - 1; t >= 0; --t) {
    T At[NX * NX], Bt[NX * NJ], lxt[NX], lut[NJ], kt[NJ], Kt[NJ * NX];
    riccati_load_ab<T, NJ>(A, Bm, t, B, b, At, Bt);
    for (int i = 0; i < NX; ++i) lxt[i] = lx[((long long)t * NX + i) * B + b];
    for (int i = 0; i < NJ; ++i) lut[i] = lu[((long long)t * NJ + i) * B + b];
    if (!stationary) cv.load(lxx, luu, lux, t, B, b);
    riccati_knot<T, NJ>(At, Bt, lxt, lut, cv, reg, Vx, Vxx, kt, Kt);
    riccati_store<T, NJ>(ks, Ks, t, B, b, kt, Kt);
  }
}

}  // namespace gt

#ifdef __CUDACC__

extern __shared__ double gt_smem[];

template <typename T, int NJ>
__global__ void riccati_factored_kernel(
    const T* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ lx, const T* __restrict__ lu,
    const T* __restrict__ Jw, const T* __restrict__ Vx0,
    const T* __restrict__ Vxx0, T* __restrict__ ks, T* __restrict__ Ks,
    int N, long long B, int r, T reg, T qd_diag, T u_diag) {
  using P = gt::RicPlan<T, NJ>;
  constexpr int W = P::LANES;
  T* knots = reinterpret_cast<T*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  const int tid = threadIdx.x, nt = blockDim.x;
  const gt::FactoredIn<T, NJ, P::BUFS> in{
      A, Bm, lx, lu, Jw, B, N, r, qd_diag, u_diag};
  gt::riccati_block<T, NJ, P::G>(gt::WarpPar<W>{tid % W, 1 + tid / W}, tid,
                                 nt, tid / W, knots, P::STRIDE,
                                 (long long)blockIdx.x * P::G, in, Vx0, Vxx0,
                                 ks, Ks, N, B, reg);
}

// The device-memory route (warp.cuh:WsPlan, RicPlan; from 30 to 48
// joints, by curvature and dtype): a problem a block at a time, its state
// in the workspace `ws` (a problem a block), staged by plain copies, the
// blocks striding over the problems.
template <typename T, int NJ, class P, class In>
__device__ __forceinline__ void riccati_ws(const In& in, const T* Vx0,
                                           const T* Vxx0, T* ks, T* Ks,
                                           int N, long long B, T reg, T* ws) {
  constexpr int W = P::LANES;
  T* k = ws + (long long)blockIdx.x * P::STRIDE;
  const int tid = threadIdx.x;
  for (long long b = blockIdx.x; b < B; b += gridDim.x) {
    __syncthreads();   // the last problem's gains are out
    gt::riccati_block<T, NJ, 1, false>(gt::WarpPar<W>{tid, 1}, tid, W, 0, k,
                                       P::STRIDE, b, in, Vx0, Vxx0, ks, Ks,
                                       N, B, reg);
  }
}

template <typename T, int NJ>
__global__ void riccati_factored_ws_kernel(
    const T* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ lx, const T* __restrict__ lu,
    const T* __restrict__ Jw, const T* __restrict__ Vx0,
    const T* __restrict__ Vxx0, T* __restrict__ ks, T* __restrict__ Ks,
    int N, long long B, int r, T reg, T qd_diag, T u_diag, T* ws) {
  using P = gt::RicPlan<T, NJ>;
  const gt::FactoredIn<T, NJ, P::BUFS> in{
      A, Bm, lx, lu, Jw, B, N, r, qd_diag, u_diag};
  riccati_ws<T, NJ, P>(in, Vx0, Vxx0, ks, Ks, N, B, reg, ws);
}

template <typename T, int NJ>
static int launch_riccati(const void* A, const void* Bm, const void* lx,
                          const void* lu, const void* Jw, const void* Vx0,
                          const void* Vxx0, void* ks, void* Ks, int N,
                          long long B, int r, double reg, double qd_diag,
                          double u_diag, cudaStream_t stream,
                          void* ws = nullptr, long long nws = 0) {
  using P = gt::RicPlan<T, NJ>;
  if (B == 0 || N == 0) return 0;
  if (r < 1 || r > gt::RicKnot<NJ>::RMAX) return (int)cudaErrorInvalidValue;
  if constexpr (P::WS > 0) {
    return gt::launch_ws<P>(riccati_factored_ws_kernel<T, NJ>, B, ws, nws,
                            stream, (const T*)A, (const T*)Bm, (const T*)lx,
                            (const T*)lu, (const T*)Jw, (const T*)Vx0,
                            (const T*)Vxx0, (T*)ks, (T*)Ks, N, B, r, (T)reg,
                            (T)qd_diag, (T)u_diag, (T*)ws);
  } else {
    static const cudaError_t attr =
        gt::smem_attrs(riccati_factored_kernel<T, NJ>, P::BYTES);
    if (attr != cudaSuccess) return (int)attr;
    riccati_factored_kernel<T, NJ><<<(unsigned)((B + P::G - 1) / P::G),
                                     P::LANES * P::G, P::BYTES, stream>>>(
        (const T*)A, (const T*)Bm, (const T*)lx, (const T*)lu, (const T*)Jw,
        (const T*)Vx0, (const T*)Vxx0, (T*)ks, (T*)Ks, N, B, r, (T)reg,
        (T)qd_diag, (T)u_diag);
    return (int)cudaGetLastError();
  }
}

// the dense sweep: STAT, a stationary curvature in each problem's state
template <typename T, int NJ, bool STAT>
using DensePlan =
    gt::RicPlan<T, NJ, STAT ? gt::RIC_STATIONARY : gt::RIC_DENSE>;
template <typename T, int NJ, bool STAT>
constexpr bool dense_on_chip() {
  return gt::ric_on_chip<T, NJ,
                         STAT ? gt::RIC_STATIONARY : gt::RIC_DENSE>();
}

template <typename T, int NJ, bool STAT>
__global__ void riccati_kernel(
    const T* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ lx, const T* __restrict__ lu,
    const T* __restrict__ lxx, const T* __restrict__ luu,
    const T* __restrict__ lux, const T* __restrict__ Vx0,
    const T* __restrict__ Vxx0, T* __restrict__ ks, T* __restrict__ Ks,
    int N, long long B, T reg) {
  using P = DensePlan<T, NJ, STAT>;
  constexpr int W = P::LANES;
  T* knots = reinterpret_cast<T*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  const int tid = threadIdx.x, nt = blockDim.x;
  const gt::DenseIn<T, NJ, STAT, P::BUFS> in{
      A, Bm, lx, lu, lxx, luu, lux, B};
  gt::riccati_block<T, NJ, P::G>(gt::WarpPar<W>{tid % W, 1 + tid / W}, tid,
                                 nt, tid / W, knots, P::STRIDE,
                                 (long long)blockIdx.x * P::G, in, Vx0, Vxx0,
                                 ks, Ks, N, B, reg);
}

// One lane-major input (R rows of B lanes) into the problem-major records
// (DS values a problem) of the on-chip sweep (sweep_warp.cuh:
// gather_rows' map: row r = (g, w, x) to value off + g GS + w WP + x): a
// 32 x 32 tile of rows and lanes a block, read along the lanes, written
// along the rows.
template <typename T>
__global__ void riccati_gather_kernel(const T* __restrict__ src, long long R,
                                      long long B, int W, int WP, int G,
                                      long long GS, long long off,
                                      T* __restrict__ dst, long long DS) {
  __shared__ T tile[32][33];
  const long long r0 = (long long)blockIdx.x * 32;
  const long long b0 = (long long)blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int i = ty; i < 32; i += 8) {
    const long long r = r0 + i, b = b0 + tx;
    if (r < R && b < B) tile[i][tx] = src[r * B + b];
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const long long b = b0 + i, r = r0 + tx;
    if (r < R && b < B) {
      const long long g = r / ((long long)W * G), w = (r / W) % G;
      dst[b * DS + off + g * GS + w * WP + r % W] = tile[tx][i];
    }
  }
}

// On chip (sweep_warp.cuh:RicChipPlan; where DensePlan would take device
// memory): a problem a block or a cluster, its state in the cluster's
// shared memory, its inputs from its record in the problem-major copy
// `rec` (DS values a problem), the clusters striding over the problems.
// CLOCKED (the phase clock of a build with -DGT_CHIP_CLOCK, launched as one
// cluster): clk[0] the start, then clock64() after each phase, *count the
// phases.
template <typename T, int NJ, bool STAT, bool CLOCKED = false>
__global__ void __launch_bounds__(gt::RicChipPlan<T, NJ>::NT)
    riccati_chip_kernel(const T* __restrict__ rec, long long DS,
                        const T* __restrict__ Vx0,
                        const T* __restrict__ Vxx0, T* __restrict__ ks,
                        T* __restrict__ Ks, int N, long long B, T reg,
                        long long* clk, int* count) {
  using P = gt::RicChipPlan<T, NJ>;
  char* smem = reinterpret_cast<char*>(gt_smem);
  const int rank = gt::chip_rank<P::CL>(), tid = threadIdx.x;
  T* rg[7];
  P::regions(
      [&](int r) { return reinterpret_cast<T*>(gt::chip_map<P::CL>(smem, r)); },
      rg);
  int n = 1;
  if (CLOCKED && rank == 0 && tid == 0) clk[0] = clock64();
  const long long nc = gridDim.x / P::CL;
  for (long long b = blockIdx.x / P::CL; b < B; b += nc)
    gt::riccati_chip_problem<T, NJ, P, STAT>(
        gt::ChipPar<P::LANES, P::CL, CLOCKED>{rank * P::NT + tid, clk, &n},
        rg, [&](int r) { return r == rank; }, tid, P::NT, rec + b * DS, Vx0,
        Vxx0, ks, Ks, N, B, b, reg);
  if (CLOCKED && rank == 0 && tid == 0) *count = n;
  gt::chip_sync<P::CL>();   // no block leaves while another reads it
}

// The problem-major copy of the inputs (the on-chip sweep's records: each
// tensor by riccati_gather_kernel) into `rec`, nrec values; then the sweep.
template <typename T, int NJ, bool STAT>
static int launch_chip_dense(const gt::DenseIn<T, NJ, STAT, 1>& in,
                             const T* Vx0, const T* Vxx0, T* ks, T* Ks,
                             int N, long long B, T reg, cudaStream_t stream,
                             T* rec, long long nrec) {
  using P = gt::RicChipPlan<T, NJ>;
  const long long DS = P::O::record(N, STAT);
  if (rec == nullptr || nrec < B * DS) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  gt::ric_chip_gathers<typename P::O>(
      in, N, STAT,
      [&](const T* src, long long R, int W, int WP, int G, long long GS,
          long long off) {
        if (err != cudaSuccess) return;
        riccati_gather_kernel<T>
            <<<dim3((unsigned)((R + 31) / 32), (unsigned)((B + 31) / 32)),
               dim3(32, 8), 0, stream>>>(src, R, B, W, WP, G, GS, off, rec,
                                         DS);
        err = cudaGetLastError();
      });
  if (err != cudaSuccess) return (int)err;
  return gt::launch_chip<P>(riccati_chip_kernel<T, NJ, STAT>, B, stream,
                            (const T*)rec, DS, Vx0, Vxx0, ks, Ks, N, B, reg,
                            (long long*)nullptr, (int*)nullptr);
}

#ifdef GT_CHIP_CLOCK
// The phase clock of the float32 stationary instance on problem 0 of
// (..., 1) value functions and outputs, from the problem-major record
// `rec` (of N knots) that a gridtorch_riccati call wrote.
extern "C" int gridtorch_riccati_clock(const void* rec, const void* Vx0,
                                       const void* Vxx0, void* ks, void* Ks,
                                       int N, void* clk, void* count) {
  using T = float;
  if constexpr (dense_on_chip<T, GT_NJ, true>())
    return gt::launch_chip<gt::RicChipPlan<T, GT_NJ>>(
        riccati_chip_kernel<T, GT_NJ, true, true>, 1, nullptr,
        (const T*)rec, gt::RicChipPlan<T, GT_NJ>::O::record(N, true),
        (const T*)Vx0, (const T*)Vxx0, (T*)ks, (T*)Ks, N, 1LL, (T)1e-6,
        (long long*)clk, (int*)count);
  else
    return (int)cudaErrorInvalidValue;
}

// The on-chip sweep (stationary) at this joint count whatever its route,
// to time it where the shared-memory route runs: rec null returns the
// values of B records; else the gathers and the sweep.
template <typename T>
static long long riccati_chip_forced(const void* A, const void* Bm,
                                     const void* lx, const void* lu,
                                     const void* lxx, const void* luu,
                                     const void* lux, const void* Vx0,
                                     const void* Vxx0, void* ks, void* Ks,
                                     int N, long long B, void* rec,
                                     long long nrec, void* stream) {
  if (rec == nullptr)
    return B * gt::RicChipPlan<T, GT_NJ>::O::record(N, true);
  const gt::DenseIn<T, GT_NJ, true, 1> in{
      (const T*)A,   (const T*)Bm,  (const T*)lx,  (const T*)lu,
      (const T*)lxx, (const T*)luu, (const T*)lux, B};
  return launch_chip_dense<T, GT_NJ, true>(
      in, (const T*)Vx0, (const T*)Vxx0, (T*)ks, (T*)Ks, N, B, (T)1e-6,
      (cudaStream_t)stream, (T*)rec, nrec);
}

extern "C" long long gridtorch_riccati_chip_forced(
    int dtype, const void* A, const void* Bm, const void* lx, const void* lu,
    const void* lxx, const void* luu, const void* lux, const void* Vx0,
    const void* Vxx0, void* ks, void* Ks, int N, long long B, void* rec,
    long long nrec, void* stream) {
  return (dtype == gt::kF32 ? riccati_chip_forced<float>
                            : riccati_chip_forced<double>)(
      A, Bm, lx, lu, lxx, luu, lux, Vx0, Vxx0, ks, Ks, N, B, rec, nrec,
      stream);
}
#endif

template <typename T, int NJ, bool STAT>
static int launch_dense(const void* A, const void* Bm, const void* lx,
                        const void* lu, const void* lxx, const void* luu,
                        const void* lux, const void* Vx0, const void* Vxx0,
                        void* ks, void* Ks, int N, long long B, double reg,
                        cudaStream_t stream, void* rec, long long nrec) {
  using P = DensePlan<T, NJ, STAT>;
  if (B == 0 || N == 0) return 0;
  if constexpr (dense_on_chip<T, NJ, STAT>()) {
    const gt::DenseIn<T, NJ, STAT, 1> in{(const T*)A,   (const T*)Bm,
                                         (const T*)lx,  (const T*)lu,
                                         (const T*)lxx, (const T*)luu,
                                         (const T*)lux, B};
    return launch_chip_dense<T, NJ, STAT>(in, (const T*)Vx0, (const T*)Vxx0,
                                          (T*)ks, (T*)Ks, N, B, (T)reg,
                                          stream, (T*)rec, nrec);
  } else {
    static const cudaError_t attr =
        gt::smem_attrs(riccati_kernel<T, NJ, STAT>, P::BYTES);
    if (attr != cudaSuccess) return (int)attr;
    riccati_kernel<T, NJ, STAT><<<(unsigned)((B + P::G - 1) / P::G),
                                  P::LANES * P::G, P::BYTES, stream>>>(
        (const T*)A, (const T*)Bm, (const T*)lx, (const T*)lu,
        (const T*)lxx, (const T*)luu, (const T*)lux, (const T*)Vx0,
        (const T*)Vxx0, (T*)ks, (T*)Ks, N, B, (T)reg);
    return (int)cudaGetLastError();
  }
}

// ws, nws: where the instance runs on chip (gridtorch_riccati_inputs > 0),
// the problem-major copy of the inputs, B of its records (nws values);
// else unused.
extern "C" int gridtorch_riccati(int dtype, int nj, const void* A,
                                 const void* Bm, const void* lx,
                                 const void* lu, const void* lxx,
                                 const void* luu, const void* lux,
                                 int stationary, const void* Vx0,
                                 const void* Vxx0, void* ks, void* Ks, int N,
                                 long long B, double reg, void* stream,
                                 void* ws, long long nws) {
  if (stationary)
    GT_DISPATCH(dtype, nj,
                launch_dense<T, NJ, true>(
                    A, Bm, lx, lu, lxx, luu, lux, Vx0, Vxx0, ks, Ks, N, B,
                    reg, (cudaStream_t)stream, ws, nws));
  GT_DISPATCH(dtype, nj,
              launch_dense<T, NJ, false>(
                  A, Bm, lx, lu, lxx, luu, lux, Vx0, Vxx0, ks, Ks, N, B, reg,
                  (cudaStream_t)stream, ws, nws));
}

// The values of one problem's record in the problem-major copy of the
// inputs that the dense sweep's on-chip instance takes (the wrapper
// allocates B of them); 0 where the instance keeps its problems in shared
// memory; -1 for another library's joint count or dtype.
template <typename T, int NJ, bool STAT>
static long long riccati_inputs(int N) {
  if constexpr (dense_on_chip<T, NJ, STAT>())
    return gt::RicChipPlan<T, NJ>::O::record(N, STAT);
  else
    return 0;
}

extern "C" long long gridtorch_riccati_inputs(int dtype, int nj, int N,
                                             int stationary) {
  if (nj != GT_NJ || (dtype != gt::kF32 && dtype != gt::kF64)) return -1;
  if (dtype == gt::kF32)
    return stationary ? riccati_inputs<float, GT_NJ, true>(N)
                      : riccati_inputs<float, GT_NJ, false>(N);
  return stationary ? riccati_inputs<double, GT_NJ, true>(N)
                    : riccati_inputs<double, GT_NJ, false>(N);
}

// ws: the workspace of the device-memory route, nws knots, problems or
// blocks (its plan's workspace_bytes each; ops/cuda/build.py:workspace);
// ignored where the plan keeps everything in shared memory.
extern "C" int gridtorch_riccati_factored(
    int dtype, int nj, const void* A, const void* Bm, const void* lx,
    const void* lu, const void* Jw, const void* Vx0, const void* Vxx0,
    void* ks, void* Ks, int N, long long B, int r, double reg,
    double qd_diag, double u_diag, void* stream, void* ws, long long nws) {
  GT_DISPATCH(dtype, nj,
              launch_riccati<T, NJ>(A, Bm, lx, lu, Jw, Vx0, Vxx0, ks, Ks, N,
                                    B, r, reg, qd_diag, u_diag,
                                    (cudaStream_t)stream, ws, nws));
}

template <typename T, int NJ>
static int riccati_factored_info(int* out) {
  using P = gt::RicPlan<T, NJ>;
  if constexpr (P::WS > 0)
    return gt::kernel_info<P>(
        (const void*)riccati_factored_ws_kernel<T, NJ>, out);
  else
    return gt::kernel_info<P>((const void*)riccati_factored_kernel<T, NJ>,
                              out);
}

template <typename T, int NJ, bool STAT>
static int riccati_info(int* out) {
  if constexpr (dense_on_chip<T, NJ, STAT>())
    return gt::kernel_info<gt::RicChipPlan<T, NJ>>(
        (const void*)riccati_chip_kernel<T, NJ, STAT>, out);
  else
    return gt::kernel_info<DensePlan<T, NJ, STAT>>(
        (const void*)riccati_kernel<T, NJ, STAT>, out);
}

// The block plan (problems a block; threads a problem; bytes a block) and
// cudaFuncGetAttributes of the instance (warp.cuh:kernel_info), into
// out[10]: riccati_factored, the dense sweep with a stationary curvature
// (riccati) and with a block per knot (riccati_stacked).
extern "C" int gridtorch_riccati_factored_info(int dtype, int nj, int* out) {
  GT_DISPATCH(dtype, nj, (riccati_factored_info<T, NJ>(out)));
}

extern "C" int gridtorch_riccati_info(int dtype, int nj, int* out) {
  GT_DISPATCH(dtype, nj, (riccati_info<T, NJ, true>(out)));
}

extern "C" int gridtorch_riccati_stacked_info(int dtype, int nj, int* out) {
  GT_DISPATCH(dtype, nj, (riccati_info<T, NJ, false>(out)));
}

#endif
