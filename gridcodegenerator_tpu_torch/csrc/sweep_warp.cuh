// Thread-group programs of the sweeps: the Riccati sweeps (a warp per
// problem: riccati_factored and the dense riccati) and the rollouts (a group
// of threads per rollout: the line search, the open-loop and the feedback
// rollout), and aba's group of threads a lane on the rollouts' ABA phases
// (aba_phases), written once for the card and for the host.
//
// All follow csrc/warp.cuh: a program is a sequence of phases, `par(f)`
// runs f(t) for the group's threads t (Par::LANES of them) and then
// synchronises them (WarpPar on the card, HostPar on the host); no thread of
// a phase reads what another thread of that phase writes. Each program's
// state sits in shared memory at the offsets of RicKnot / LSRoll, so no
// per-thread array is indexed at run time.
//
// A block holds G consecutive problems (LSPlan: also `rows` step-size rows
// of each) and walks the horizon in a loop. Each step the block stages the
// inputs of the next knot into a second buffer with cp.async (G
// consecutive lanes of a row at a time: whole 32-byte sectors at G = 8 in
// float32), while the current knot is computed; it writes its outputs the
// same way. The Riccati knot takes its curvature from an input policy
// (FactoredIn, DenseIn), the rollout step its control law (FeedbackLaw,
// OpenLoop) and its cost (EECostW, QuadCostW, NoCost) from policies, and
// hands each joint's qdd to the Euler update (aba_knot: to its output). Every
// value keeps the order of operations of the serial lane code
// (csrc/riccati.cu:riccati_knot, csrc/dynamics.cuh:aba; products with the
// exactly zero upper-right block of a joint transform are skipped), so the
// host build gives the same bits as that code; only the end-effector
// position of the line search's cost is formed in another order (from the
// leaf up).
#pragma once

#include "warp.cuh"

namespace gt {

// ---------------------------------------------------------------------------
// copies between device and shared memory
// ---------------------------------------------------------------------------

// One value from device memory into shared memory: cp.async on the card
// (completed by async_wait), a plain copy on the host. ASYNC false (a
// destination in device memory: the device-memory routes, where cp.async,
// which writes shared memory only, cannot stage): a plain copy.
template <bool ASYNC = true, typename T>
GT_HDI void async_copy(T* dst, const T* src) {
#ifdef __CUDA_ARCH__
  if (!ASYNC) {
    *dst = *src;
    return;
  }
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"((int)sizeof(T))
               : "memory");
#else
  *dst = *src;
#endif
}

// 16 bytes, V values of the plan's number type (V = 16 / sizeof(T) on the
// card), from device memory into shared memory: one cp.async of 16 bytes
// on the card (both addresses 16-byte aligned), a plain copy of V values on
// the host.
template <int V, typename T>
GT_HDI void async_copy16(T* dst, const T* src) {
#ifdef __CUDA_ARCH__
  static_assert(V * sizeof(T) == 16, "16 bytes");
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
#else
  for (int i = 0; i < V; ++i) dst[i] = src[i];
#endif
}

GT_HDI void async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// wait until at most N committed groups of this thread are in flight
template <int N>
GT_HDI void async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// rows x G values of a lane-major array into the buffers of G units (G a
// compile-time constant: the index arithmetic folds), S values apart:
// (row, g) at src[row * stride + g] goes to dst[g * S + row]; units
// g >= nvalid (past the last lane) get zeros; ASYNC: by cp.async
// (async_copy)
template <int G, bool ASYNC = true, typename T>
GT_HD void stage_runs(const T* src, long long stride, int rows, int nvalid,
                      T* dst, long long S, int tid, int nt) {
  for (int e = tid; e < rows * G; e += nt) {
    const int row = e / G, g = e % G;
    T* d = dst + g * S + row;
    if (g < nvalid) {
      async_copy<ASYNC>(d, src + row * stride + g);
    } else {
      *d = T(0);
    }
  }
}

// the reverse, for units g < nvalid (and, where only >= 0, unit `only`)
template <int G, typename T>
GT_HD void store_runs(const T* src, long long S, int rows, int nvalid, T* dst,
                      long long stride, int tid, int nt, int only = -1) {
  for (int e = tid; e < rows * G; e += nt) {
    const int row = e / G, g = e % G;
    if (g < nvalid && (only < 0 || g == only))
      dst[row * stride + g] = src[g * S + row];
  }
}

// ---------------------------------------------------------------------------
// the Riccati sweeps: a warp per problem
// ---------------------------------------------------------------------------

// Where a Riccati program's curvature sits: the factor Jw in the knot's
// tile (riccati_factored), dense blocks in the knot's tile (riccati, a block
// per knot), or dense blocks staged once into the problem's state (riccati,
// stationary).
enum { RIC_FACTORED, RIC_DENSE, RIC_STATIONARY };

// One problem's state (offsets into its buffer of T). BUFS tile buffers (A,
// B, lx, lu and the knot's curvature: the factor Jw, rank <= RMAX, or the
// dense lxx, luu, lux): with two, knot t - 1 arrives while knot t is
// computed; with one (where two do not fit a block), it is staged once knot
// t is done. Then the value function and the knot's Q blocks; the augmented
// matrix of Gauss-Jordan and its pivots' inverses; last a stationary
// curvature. The gains K and Quu K go over VA, dead after Q's assembly.
// CURV is the curvature's place, each its own layout.
template <int NJ, int CURV = RIC_FACTORED, int BUFS_ = 2>
struct RicKnot {
  static constexpr int BUFS = BUFS_;
  static constexpr int NX = 2 * NJ, RMAX = 6;
  // the dense blocks, from the curvature's base
  static constexpr int CXX = 0, CUU = CXX + NX * NX, CUX = CUU + NJ * NJ;
  static constexpr int DENSE = CUX + NJ * NX;
  static constexpr int AT = 0, BT = AT + NX * NX, LX = BT + NX * NJ;
  static constexpr int LU = LX + NX, JW = LU + NJ;
  static constexpr int TILE =
      JW + (CURV == RIC_FACTORED ? RMAX * NJ : CURV == RIC_DENSE ? DENSE : 0);
  static constexpr int VX = BUFS * TILE, VXX = VX + NX, QX = VXX + NX * NX;
  static constexpr int QU = QX + NX, QXX = QU + NJ, QUX = QXX + NX * NX;
  static constexpr int QUU = QUX + NJ * NX, KT = QUU + NJ * NJ;
  static constexpr int QUUK = KT + NJ, VA = QUUK + NJ;
  static constexpr int KK = VA, QUUKK = VA + NJ * NX;   // over VA
  static constexpr int VB = VA + NX * NX, AUG = VB + NX * NJ;
  static constexpr int PIV = AUG + 2 * NJ * NJ, CS = PIV + NJ;
  static constexpr int SIZE = CS + (CURV == RIC_STATIONARY ? DENSE : 0);
};

// The inputs of riccati_factored: A (N, NX, NX, B), Bm (N, NX, NJ, B); lx
// (NX, N B), lu (NJ, N B) and Jw (r, NJ, N B) at knot-major lanes t B + b.
// The curvature is a policy of the knot program: `curv` gives its base in
// the problem's buffer (a compile-time choice of tile or state), and xx,
// ux, uu the entry of lxx, lux, luu added to the product s, as FactoredCurv
// adds it: blkdiag(Jw^T Jw, qd_diag I), 0, u_diag I.
template <typename T, int NJ, int BUFS = 2>
struct FactoredIn {
  using O = RicKnot<NJ, RIC_FACTORED, BUFS>;
  static constexpr int NX = 2 * NJ;
  const T *A, *Bm, *lx, *lu, *Jw;
  long long B;
  int N, r;
  T qd_diag, u_diag;
  // knot t of problems b0 .. b0 + G - 1 into the tiles at `dst`
  template <int G>
  GT_HD void stage(int t, long long b0, int nvalid, T* dst, long long S,
                   int tid, int nt) const {
    const long long NB = (long long)N * B, ln = (long long)t * B + b0;
    stage_runs<G>(A + (long long)t * NX * NX * B + b0, B, NX * NX,
                  nvalid, dst + O::AT, S, tid, nt);
    stage_runs<G>(Bm + (long long)t * NX * NJ * B + b0, B, NX * NJ,
                  nvalid, dst + O::BT, S, tid, nt);
    stage_runs<G>(lx + ln, NB, NX, nvalid, dst + O::LX, S, tid, nt);
    stage_runs<G>(lu + ln, NB, NJ, nvalid, dst + O::LU, S, tid, nt);
    stage_runs<G>(Jw + ln, NB, r * NJ, nvalid, dst + O::JW, S, tid, nt);
  }
  template <int G>
  GT_HDI void stage_once(long long, int, T*, long long, int, int) const {}
  GT_HDI const T* curv(const T*, const T* tile) const { return tile + O::JW; }
  GT_HDI T xx(const T* J, int i, int j, T s) const {
    if (i < NJ && j < NJ) {
      T a = J[i] * J[j];
      for (int rr = 1; rr < r; ++rr) a += J[rr * NJ + i] * J[rr * NJ + j];
      return s + a;
    }
    return i == j && i >= NJ ? s + qd_diag : s;
  }
  GT_HDI T ux(const T*, int, int, T s) const { return s; }
  GT_HDI T uu(const T*, int i, int j, T s) const {
    return i == j ? s + u_diag : s;
  }
};

// The inputs of riccati: A, Bm as above; lx (N, NX, B), lu (N, NJ, B); lxx
// (NX, NX, B), luu (NJ, NJ, B), lux (NJ, NX, B), each with a leading N axis
// unless STATIONARY. A stationary curvature is staged once, into each
// problem's state beside its value function (stage_once); a per-knot one
// into the knot's tile with A and B. xx, ux, uu add the entry to the
// product as DenseCurv adds it (s + l).
template <typename T, int NJ, bool STATIONARY, int BUFS = 2>
struct DenseIn {
  using O = RicKnot<NJ, STATIONARY ? RIC_STATIONARY : RIC_DENSE, BUFS>;
  static constexpr int NX = 2 * NJ;
  const T *A, *Bm, *lx, *lu, *lxx, *luu, *lux;
  long long B;
  // knot t's blocks (block 0: the stationary ones) of problems b0 .. into
  // the dense blocks at `dst`
  template <int G>
  GT_HD void stage_curv(int t, long long b0, int nvalid, T* dst, long long S,
                        int tid, int nt) const {
    stage_runs<G>(lxx + (long long)t * NX * NX * B + b0, B, NX * NX,
                  nvalid, dst + O::CXX, S, tid, nt);
    stage_runs<G>(luu + (long long)t * NJ * NJ * B + b0, B, NJ * NJ,
                  nvalid, dst + O::CUU, S, tid, nt);
    stage_runs<G>(lux + (long long)t * NJ * NX * B + b0, B, NJ * NX,
                  nvalid, dst + O::CUX, S, tid, nt);
  }
  template <int G>
  GT_HD void stage(int t, long long b0, int nvalid, T* dst, long long S,
                   int tid, int nt) const {
    stage_runs<G>(A + (long long)t * NX * NX * B + b0, B, NX * NX,
                  nvalid, dst + O::AT, S, tid, nt);
    stage_runs<G>(Bm + (long long)t * NX * NJ * B + b0, B, NX * NJ,
                  nvalid, dst + O::BT, S, tid, nt);
    stage_runs<G>(lx + (long long)t * NX * B + b0, B, NX, nvalid,
                  dst + O::LX, S, tid, nt);
    stage_runs<G>(lu + (long long)t * NJ * B + b0, B, NJ, nvalid,
                  dst + O::LU, S, tid, nt);
    if (!STATIONARY)
      stage_curv<G>(t, b0, nvalid, dst + O::JW, S, tid, nt);
  }
  template <int G>
  GT_HD void stage_once(long long b0, int nvalid, T* knots, long long S,
                        int tid, int nt) const {
    if (STATIONARY)
      stage_curv<G>(0, b0, nvalid, knots + O::CS, S, tid, nt);
  }
  GT_HDI const T* curv(const T* k, const T* tile) const {
    return STATIONARY ? k + O::CS : tile + O::JW;
  }
  GT_HDI T xx(const T* c, int i, int j, T s) const {
    return s + c[O::CXX + i * NX + j];
  }
  GT_HDI T ux(const T* c, int i, int j, T s) const {
    return s + c[O::CUX + i * NX + j];
  }
  GT_HDI T uu(const T* c, int i, int j, T s) const {
    return s + c[O::CUU + i * NJ + j];
  }
};

// entry (i, j) of the inverse that the in-place Gauss-Jordan below leaves
// in the right half of `aug` (its last pivot row not yet scaled)
template <typename T, int NJ>
GT_HDI T gj_inv(const T* aug, const T* piv, int i, int j) {
  const T x = aug[i * 2 * NJ + NJ + j];
  return i == NJ - 1 ? x * piv[i] : x;
}

// Gauss-Jordan without pivoting on aug = [Quu + reg I | I] (NJ, 2 NJ, its
// first pivot's inverse in piv[0]), a pivot p a phase, an entry a thread,
// in place: rows i != p, the columns still read later (left j > p, right
// NJ + j for j <= p; the others keep their values exactly); the pivot row
// is scaled when the next pivot reads it, by the thread of each entry, as
// the serial code scales it; the thread of entry (p + 1, p + 1) stores that
// pivot's inverse. gj_inv reads the inverse.
template <typename T, int NJ, class Par>
GT_HDI void gj_phases(const Par& par, T* aug, T* piv) {
  constexpr int W = Par::LANES, M2 = 2 * NJ;
  for (int p = 0; p < NJ; ++p) {
    par([&](int t) {
      // rows i != p, columns j: left p + 1 .. NJ - 1, then right NJ .. NJ + p
      for (int e = t; e < (NJ - 1) * NJ; e += W) {
        const int i = e / NJ + (e / NJ >= p), c = e % NJ;
        const int j = c < NJ - 1 - p ? p + 1 + c : NJ + c - (NJ - 1 - p);
        const T rp = aug[p * M2 + j] * piv[p];
        T x = aug[i * M2 + j], ci = aug[i * M2 + p];
        if (i == p - 1) {   // the last pivot row, scaled as it is read
          x = x * piv[i];
          ci = ci * piv[i];
        }
        x = x - ci * rp;
        aug[i * M2 + j] = x;
        if (i == p + 1 && j == p + 1) piv[i] = T(1) / x;
      }
    });
  }
}

// gj_phases over W >= NJ threads with each thread on one column: thread t
// takes column (t % NJ) of the phase's NJ columns and a group (t / NJ) of
// its rows i != p, so the pivot row's entry of its column is read once
// for all of them; the same arithmetic, entry by entry. No entry a phase
// writes is read in it but by its own thread.
template <typename T, int NJ, class Par>
GT_HDI void gj_phases_cols(const Par& par, T* aug, T* piv) {
  constexpr int W = Par::LANES, M2 = 2 * NJ, GR = W / NJ;
  constexpr int ROWS = (NJ - 1 + GR - 1) / GR;   // rows a thread
  static_assert(GR >= 1, "a thread a column at least");
  for (int p = 0; p < NJ; ++p) {
    par([&](int t) {
      if (t >= GR * NJ) return;
      const int c = t % NJ, r0 = (t / NJ) * ROWS;
      const int j = c < NJ - 1 - p ? p + 1 + c : NJ + c - (NJ - 1 - p);
      const T rp = aug[p * M2 + j] * piv[p];
      for (int r = r0; r < r0 + ROWS && r < NJ - 1; ++r) {
        const int i = r + (r >= p);
        T x = aug[i * M2 + j], ci = aug[i * M2 + p];
        if (i == p - 1) {   // the last pivot row, scaled as it is read
          x = x * piv[i];
          ci = ci * piv[i];
        }
        x = x - ci * rp;
        aug[i * M2 + j] = x;
        if (i == p + 1 && j == p + 1) piv[i] = T(1) / x;
      }
    });
  }
}

// One backward knot of the problem whose state sits at `k`, from the tile
// at `tile` (the layout and the curvature: the policy In):
// riccati.cu:riccati_knot split over the warp, an entry of each
// product a thread (two neighbouring entries where they share an operand:
// fewer shared-memory loads), 6 + NJ phases:
// 1. Qx, Qu (A^T Vx, B^T Vx) and VA = Vxx A, VB = Vxx B;
// 2. Qxx = A^T VA + lxx, Qux = B^T VA + lux, Quu = B^T VB + luu, and the
//    augmented [Quu + reg I | I] with the first pivot's inverse;
// 3. Gauss-Jordan without pivoting, a pivot p a phase, an entry a thread,
//    in place: rows i != p, the columns still read later (left j > p, right
//    NJ + j for j <= p; the others keep their values exactly); the pivot
//    row is scaled when the next pivot reads it, by the thread of each
//    entry, as the serial code scales it; the thread of entry (p + 1, p +
//    1) stores that pivot's inverse;
// 4. k = -Quu^-1 Qu, K = -Quu^-1 Qux (the last pivot row scaled as read);
// 5. Quu k, Quu K;
// 6. the full value update (Vxx' over Qxx, each entry by its own thread);
// 7. Vxx = (Vxx' + Vxx'^T) / 2.
template <typename T, int NJ, class In, class Par>
GT_HD void riccati_knot_warp(const Par& par, T* k, const T* tile,
                             const In& cv, T reg) {
  using O = typename In::O;
  constexpr int NX = 2 * NJ, W = Par::LANES, M2 = 2 * NJ;
  const T* At = tile + O::AT;
  const T* Bt = tile + O::BT;
  const T* lx = tile + O::LX;
  const T* lu = tile + O::LU;
  T* Vx = k + O::VX;
  T* Vxx = k + O::VXX;
  T* Qx = k + O::QX;
  T* Qu = k + O::QU;
  T* Qxx = k + O::QXX;
  T* Qux = k + O::QUX;
  T* Quu = k + O::QUU;
  T* kt = k + O::KT;
  T* Quuk = k + O::QUUK;
  T* VA = k + O::VA;
  T* Kt = k + O::KK;
  T* QuuK = k + O::QUUKK;
  T* VB = k + O::VB;
  T* aug = k + O::AUG;
  T* piv = k + O::PIV;
  const T* cc = cv.curv(k, tile);   // no thread of the knot writes it

  par([&](int t) {
    Deal<W> d{t, 0};
    d(NX, [&](int i) {
      T s = At[i] * Vx[0];
      for (int m = 1; m < NX; ++m) s += At[m * NX + i] * Vx[m];
      Qx[i] = lx[i] + s;
    });
    d(NJ, [&](int i) {
      T s = Bt[i] * Vx[0];
      for (int m = 1; m < NX; ++m) s += Bt[m * NJ + i] * Vx[m];
      Qu[i] = lu[i] + s;
    });
    d(NX * NX / 2, [&](int e) {   // VA[i][j, j + 1]
      const int i = 2 * e / NX, j = 2 * e % NX;
      const T* v = Vxx + i * NX;
      T s0 = v[0] * At[j], s1 = v[0] * At[j + 1];
      for (int m = 1; m < NX; ++m) {
        s0 += v[m] * At[m * NX + j];
        s1 += v[m] * At[m * NX + j + 1];
      }
      VA[i * NX + j] = s0;
      VA[i * NX + j + 1] = s1;
    });
    d(NJ * NX / 2, [&](int e) {   // VB[i, i + 1][j]
      const int i = 2 * (e / NJ), j = e % NJ;
      const T* v = Vxx + i * NX;
      T s0 = v[0] * Bt[j], s1 = v[NX] * Bt[j];
      for (int m = 1; m < NX; ++m) {
        const T b = Bt[m * NJ + j];
        s0 += v[m] * b;
        s1 += v[NX + m] * b;
      }
      VB[i * NJ + j] = s0;
      VB[(i + 1) * NJ + j] = s1;
    });
  });
  par([&](int t) {
    Deal<W> d{t, 0};
    d(NX * NX / 2, [&](int e) {   // Qxx[i][j, j + 1]
      const int i = 2 * e / NX, j = 2 * e % NX;
      T s0 = At[i] * VA[j], s1 = At[i] * VA[j + 1];
      for (int m = 1; m < NX; ++m) {
        const T a = At[m * NX + i];
        s0 += a * VA[m * NX + j];
        s1 += a * VA[m * NX + j + 1];
      }
      Qxx[i * NX + j] = cv.xx(cc, i, j, s0);
      Qxx[i * NX + j + 1] = cv.xx(cc, i, j + 1, s1);
    });
    d(NJ * NX / 2, [&](int e) {   // Qux[i][j, j + 1]
      const int i = 2 * e / NX, j = 2 * e % NX;
      T s0 = Bt[i] * VA[j], s1 = Bt[i] * VA[j + 1];
      for (int m = 1; m < NX; ++m) {
        const T b = Bt[m * NJ + i];
        s0 += b * VA[m * NX + j];
        s1 += b * VA[m * NX + j + 1];
      }
      Qux[i * NX + j] = cv.ux(cc, i, j, s0);
      Qux[i * NX + j + 1] = cv.ux(cc, i, j + 1, s1);
    });
    d(NJ * NJ, [&](int e) {
      const int i = e / NJ, j = e % NJ;
      T s = Bt[i] * VB[j];
      for (int m = 1; m < NX; ++m) s += Bt[m * NJ + i] * VB[m * NJ + j];
      const T q = cv.uu(cc, i, j, s);
      Quu[e] = q;
      aug[i * M2 + j] = i == j ? q + reg : q;
      aug[i * M2 + NJ + j] = i == j ? T(1) : T(0);
      if (e == 0) piv[0] = T(1) / (q + reg);
    });
  });
  gj_phases<T, NJ>(par, aug, piv);
  par([&](int t) {
    Deal<W> d{t, 0};
    d(NJ, [&](int i) {
      T s = gj_inv<T, NJ>(aug, piv, i, 0) * Qu[0];
      for (int j = 1; j < NJ; ++j) s += gj_inv<T, NJ>(aug, piv, i, j) * Qu[j];
      kt[i] = -s;
    });
    d(NJ * NX, [&](int e) {
      const int i = e / NX, m = e % NX;
      T s = gj_inv<T, NJ>(aug, piv, i, 0) * Qux[m];
      for (int j = 1; j < NJ; ++j)
        s += gj_inv<T, NJ>(aug, piv, i, j) * Qux[j * NX + m];
      Kt[e] = -s;
    });
  });
  par([&](int t) {
    Deal<W> d{t, 0};
    d(NJ, [&](int i) {
      T s = Quu[i * NJ] * kt[0];
      for (int j = 1; j < NJ; ++j) s += Quu[i * NJ + j] * kt[j];
      Quuk[i] = s;
    });
    d(NJ * NX, [&](int e) {
      const int i = e / NX, m = e % NX;
      T s = Quu[i * NJ] * Kt[m];
      for (int j = 1; j < NJ; ++j) s += Quu[i * NJ + j] * Kt[j * NX + m];
      QuuK[e] = s;
    });
  });
  par([&](int t) {
    Deal<W> d{t, 0};
    d(NX, [&](int m) {
      T s1 = Kt[m] * Quuk[0], s2 = Kt[m] * Qu[0], s3 = Qux[m] * kt[0];
      for (int i = 1; i < NJ; ++i) {
        s1 += Kt[i * NX + m] * Quuk[i];
        s2 += Kt[i * NX + m] * Qu[i];
        s3 += Qux[i * NX + m] * kt[i];
      }
      Vx[m] = Qx[m] + s1 + s2 + s3;
    });
    d(NX * NX / 2, [&](int e) {   // Vxx'[m][l, l + 1]
      const int m = 2 * e / NX, l = 2 * e % NX;
      T a1 = Kt[m] * QuuK[l], a2 = Kt[m] * Qux[l], a3 = Qux[m] * Kt[l];
      T b1 = Kt[m] * QuuK[l + 1], b2 = Kt[m] * Qux[l + 1],
        b3 = Qux[m] * Kt[l + 1];
      for (int i = 1; i < NJ; ++i) {
        const T km = Kt[i * NX + m], qm = Qux[i * NX + m];
        const int o = i * NX + l;
        a1 += km * QuuK[o];
        a2 += km * Qux[o];
        a3 += qm * Kt[o];
        b1 += km * QuuK[o + 1];
        b2 += km * Qux[o + 1];
        b3 += qm * Kt[o + 1];
      }
      Qxx[m * NX + l] = Qxx[m * NX + l] + a1 + a2 + a3;
      Qxx[m * NX + l + 1] = Qxx[m * NX + l + 1] + b1 + b2 + b3;
    });
  });
  par([&](int t) {
    for (int e = t; e < NX * NX; e += W) {
      const int m = e / NX, l = e % NX;
      Vxx[e] = T(0.5) * (Qxx[m * NX + l] + Qxx[l * NX + m]);
    }
  });
}

// The block: G problems (units), unit `unit` runs its program with `par`.
// Knot N - 1 down to 0; with two tile buffers the tiles of knot t - 1 are
// staged while knot t is computed, with one once knot t + 1 is done (a
// stationary curvature once, with the value function, before the first
// knot); the gains of knot t are written (G lanes a row) at the start of
// the next step. `only` >= 0 (the host build) writes only that unit's
// lanes.
template <typename T, int NJ, int G, class In, class Par>
GT_HD void riccati_block(const Par& par, int tid, int nt, int unit, T* knots,
                         long long S, long long b0, const In& in,
                         const T* Vx0, const T* Vxx0, T* ks, T* Ks, int N,
                         long long B, T reg, int only = -1) {
  using O = typename In::O;
  constexpr int NX = 2 * NJ;
  constexpr bool TWO = O::BUFS == 2;
  const int nvalid = (int)(B - b0 < G ? B - b0 : G);
  T* k = knots + unit * S;
  // the offset of knot t's tiles in each problem's buffer
  auto tile = [&](int t) { return TWO ? (t & 1) * O::TILE : 0; };
  auto store = [&](int t) {
    store_runs<G>(knots + O::KT, S, NJ, nvalid,
                  ks + (long long)t * NJ * B + b0, B, tid, nt, only);
    store_runs<G>(knots + O::KK, S, NJ * NX, nvalid,
                  Ks + (long long)t * NJ * NX * B + b0, B, tid, nt, only);
  };
  stage_runs<G>(Vx0 + b0, B, NX, nvalid, knots + O::VX, S, tid, nt);
  stage_runs<G>(Vxx0 + b0, B, NX * NX, nvalid, knots + O::VXX, S, tid, nt);
  in.template stage_once<G>(b0, nvalid, knots, S, tid, nt);
  in.template stage<G>(N - 1, b0, nvalid, knots + tile(N - 1), S, tid, nt);
  async_commit();
  for (int t = N - 1; t >= 0; --t) {
    block_sync();   // knot t + 1 is done: its gains out, its tiles free
    if (t + 1 < N) store(t + 1);
    if (TWO && t > 0) {
      in.template stage<G>(t - 1, b0, nvalid, knots + tile(t - 1), S, tid,
                           nt);
      async_commit();
      async_wait<1>();
    } else {
      if (!TWO && t + 1 < N) {
        in.template stage<G>(t, b0, nvalid, knots + tile(t), S, tid, nt);
        async_commit();
      }
      async_wait<0>();
    }
    block_sync();   // knot t's tiles have landed
    riccati_knot_warp<T, NJ>(par, k, k + tile(t), in, reg);
  }
  block_sync();
  store(0);
}

struct NoHead {
  int unused;
};

// the registers a thread is planned with (ptxas reports 88-128 | 84-124 at
// 7-16 joints, 161 | 139 at 2, float32 | float64)
template <typename T>
GT_HDI constexpr int ric_regs() { return sizeof(T) == 4 ? 96 : 104; }

// The Riccati sweeps' plans: the threads a problem as BlockPlan picks them;
// G the most problems a block, up to 8, that fit (whole sectors; B = 2048
// problems then fill the card in one wave of blocks); two tile buffers where
// one problem fits with them, else one (the dense sweep at 28 joints in
// float64: 241.5 KB a problem with two, 203.2 KB with one). Each
// curvature's place has its own layout, so its own plan.
GT_HDI constexpr int ric_g(long long head, long long knot_bytes, int lanes) {
  int g = MAX_KNOTS;
  while (g > 0 && (head + g * knot_bytes > SMEM_LIMIT ||
                   g * lanes > MAX_BLOCK_THREADS))
    --g;
  return g;
}

template <typename T, int NJ, int CURV, int BUFS_>
struct RicShape {
  static constexpr int BUFS = BUFS_;
  using BP = BlockPlan<T, NoHead, RicKnot<NJ, CURV, BUFS>::SIZE, WARP,
                       ric_regs<T>()>;
  static constexpr int LANES = BP::LANES, STRIDE = BP::STRIDE, ROWS = 1;
  static constexpr long long HEAD = BP::HEAD;
  static constexpr int G = ric_g(HEAD, BP::KNOT_BYTES, LANES);
  static constexpr long long BYTES = HEAD + (G > 0 ? G : 1) * BP::KNOT_BYTES;
};

// Two tile buffers where a problem fits a block with them, else one; G 0
// where not even one buffer's problem fits (from 30 to 48 joints, by
// curvature and dtype): there, and from CHIP_FROM joints, every curvature
// runs on chip instead (RicChipPlan, ric_on_chip).
template <typename T, int NJ, int CURV>
GT_HDI constexpr int ric_bufs() {
  return RicShape<T, NJ, CURV, 2>::G >= 1 ? 2 : 1;
}

template <typename T, int NJ, int CURV = RIC_FACTORED>
struct RicPlan : RicShape<T, NJ, CURV, ric_bufs<T, NJ, CURV>()> {};

// ---------------------------------------------------------------------------
// the Riccati sweeps on chip: one problem a block or a cluster
// ---------------------------------------------------------------------------

// Above the block limit (from CHIP_FROM joints: ric_on_chip), one problem
// of either sweep (riccati_factored, or the dense one with a stationary
// curvature or a block per knot) a block or a cluster keeps it on chip
// (warp.cuh: ChipPack) for the whole sweep; a knot holds only what its
// products need at once. Its regions:
// AB, the knot's A (NX, NXP) and B (NX, NJP), lx, lu and, for the factored
// curvature (FACT), its factor Jw (RMAX, NJP: r rows used), staged with
// cp.async by the region's rank while the knot before finishes (once Vxx A
// and Vxx B are folded, A, B and Jw are free); VXX, the value function's Vxx (NX, NXP;
// its transpose for the first knot, Vxx0 as given, symmetric after),
// and over it once the products are folded the augmented [Quu + reg I | I]
// (NJ, 2 NJ), then W = Quu K + Qux (NJ, NXP), and K (NJ, NXP) in its second
// half; QXX, Qxx (NX, NXP), then Vxx' in place; QUX, Qux (NJ, NXP); QUU,
// Quu^T (NJ, NJP); SL, two slabs of SW columns of [Vxx A | Vxx B] (NX, SW);
// SMALL, Vx, Qx, Qu, k, Qu + Quu k and the pivots' inverses. NXP and NJP
// are NX and NJ rounded up to 4, so every row is 16-byte aligned; columns
// past NX or NJ are never written, and only outputs past them read them.
// The dense curvature blocks are read from device memory where they are
// added (the stationary ones stay in L2 across the knots); the factored
// one is formed from Jw where it is added (ChipFactoredCurv); the gains k,
// K are written to the outputs as they are formed.
template <int NJ, int SW_, bool FACT = false>
struct RicChipKnot {
  static constexpr int NX = 2 * NJ, NXP = (int)round4(NX);
  static constexpr int NJP = (int)round4(NJ), SW = SW_, RMAX = 6;
  // the columns of [A | B] (A's padded to NXP), SW a slab
  static constexpr int NCOL = NXP + NJP, NS = (NCOL + SW - 1) / SW;
  static constexpr int A = 0, BM = A + NX * NXP, LX = BM + NX * NJP;
  static constexpr int LU = LX + NXP, JW = LU + NJP;
  static constexpr int AB = JW + (FACT ? RMAX * NJP : 0);
  static constexpr int VXX = NX * NXP, KK = NJ * NXP;
  static constexpr int QXX = NX * NXP, QUX = NJ * NXP, QUU = NJ * NJP;
  static constexpr int SL = 2 * NX * SW;
  static constexpr int VX = 0, QX = VX + NXP, QU = QX + NXP, KT = QU + NJP;
  static constexpr int UP = KT + NJP, PIV = UP + NJP, SMALL = PIV + NJP;
  // the regions, in the order they are packed
  enum { R_AB, R_QXX, R_VXX, R_QUX, R_QUU, R_SL, R_SMALL, NREG };
  // A problem's record in the problem-major copy of the inputs
  // (riccati.cu: riccati_gather_kernel): its N knots' tiles as the AB
  // region holds them (AB values each), then the dense sweep's curvature,
  // one block or a block a knot (CURV values each): lxx (NX, NXP), luu
  // (NJ, NJP), lux (NJ, NXP); the factored curvature's Jw is in the tiles.
  static constexpr int CXX = 0, CUU = NX * NXP, CUX = CUU + NJ * NJP;
  static constexpr int CURV = CUX + NJ * NXP;
  static constexpr long long record(int N, bool stationary) {
    return (long long)N * AB +
           (FACT ? 0 : (long long)(stationary ? 1 : N) * CURV);
  }
};

// One lane-major input (R rows of B lanes) into problem b's record of the
// problem-major copy (riccati_gather_kernel, a problem at a time): row r =
// (g, w, x), g = r / (W G), w = (r / W) % G, x = r % W, goes to value
// off + g GS + w WP + x XS of the record.
template <typename T>
GT_HD void gather_rows(const T* src, long long R, long long B, int W,
                       int WP, int G, long long GS, long long off,
                       long long XS, T* rec, long long b) {
  for (long long r = 0; r < R; ++r) {
    const long long g = r / ((long long)W * G), w = (r / W) % G, x = r % W;
    rec[off + g * GS + w * WP + x * XS] = src[r * B + b];
  }
}

// The gathers of a sweep's inputs into the problem-major records of plan
// shape O, one call a tensor: g(src, rows, W, WP, G, GS, off, XS). The
// dense sweep's (DenseIn's pointers): each (N, ..., B) tensor's rows keep
// their order, the knot outermost.
template <class O, class In, class Gather>
GT_HD void ric_chip_gathers(const In& in, int N, bool stationary,
                            Gather&& g) {
  constexpr int NX = O::NX, NJ = NX / 2, NXP = O::NXP, NJP = O::NJP;
  const long long NC = stationary ? 1 : N, c0 = (long long)N * O::AB;
  g(in.A, (long long)N * NX * NX, NX, NXP, NX, O::AB, O::A, 1LL);
  g(in.Bm, (long long)N * NX * NJ, NJ, NJP, NX, O::AB, O::BM, 1LL);
  g(in.lx, (long long)N * NX, NX, NXP, 1, O::AB, O::LX, 1LL);
  g(in.lu, (long long)N * NJ, NJ, NJP, 1, O::AB, O::LU, 1LL);
  g(in.lxx, NC * NX * NX, NX, NXP, NX, O::CURV, c0 + O::CXX, 1LL);
  g(in.luu, NC * NJ * NJ, NJ, NJP, NJ, O::CURV, c0 + O::CUU, 1LL);
  g(in.lux, NC * NJ * NX, NX, NXP, NJ, O::CURV, c0 + O::CUX, 1LL);
}

// riccati_factored's (FactoredIn's pointers): A and B as the dense sweep's;
// lx (NX, N B), lu (NJ, N B) and Jw (r, NJ, N B) in the solver's knot-major
// lanes t B + b, so that seen as rows of B lanes the knot t is the row's
// innermost part: x = t, its value AB apart in the record (lx's row i =
// (i, t): g = i; Jw's (rr, i, t): g = rr, w = i).
template <class O, typename T, int NJ, int BUFS, class Gather>
GT_HD void ric_chip_gathers(const FactoredIn<T, NJ, BUFS>& in, int N, bool,
                            Gather&& g) {
  constexpr int NX = O::NX, NXP = O::NXP, NJP = O::NJP;
  g(in.A, (long long)N * NX * NX, NX, NXP, NX, O::AB, O::A, 1LL);
  g(in.Bm, (long long)N * NX * NJ, NJ, NJP, NX, O::AB, O::BM, 1LL);
  g(in.lx, (long long)NX * N, N, 0, 1, 1, O::LX, (long long)O::AB);
  g(in.lu, (long long)NJ * N, N, 0, 1, 1, O::LU, (long long)O::AB);
  g(in.Jw, (long long)in.r * NJ * N, N, 1, NJ, NJP, O::JW,
    (long long)O::AB);
}

template <typename T, int NJ, int SW, bool FACT = false>
GT_HDI constexpr ChipPack<7> ric_chip_pack(int cl) {
  using O = RicChipKnot<NJ, SW, FACT>;
  const long long size[7] = {O::AB,  O::QXX, O::VXX,  O::QUX,
                             O::QUU, O::SL,  O::SMALL};
  return chip_pack(size, (int)sizeof(T), 0, cl);
}

// The slab width: the widest (up to 64, at least RIC_CHIP_SWMIN) that fits
// the fewest blocks, then evened out over its slabs; each slab is a phase
// (at 52 joints in float32 three slabs of 52 columns: A's two halves, then
// B), and a narrower slab gives 512 threads too few tiles.
constexpr int RIC_CHIP_SWMIN = 24;
template <typename T, int NJ, int SW, bool FACT = false>
GT_HDI constexpr int ric_chip_swmax(int cl) {
  if constexpr (SW < RIC_CHIP_SWMIN) {
    return 0;
  } else {
    return ric_chip_pack<T, NJ, SW, FACT>(cl).cl
               ? SW
               : ric_chip_swmax<T, NJ, SW - 4, FACT>(cl);
  }
}
template <int NJ>
GT_HDI constexpr int ric_chip_top() {
  constexpr int ncol = (int)round4(2 * NJ) + (int)round4(NJ);
  return ncol < 64 ? ncol : 64;
}
template <typename T, int NJ, bool FACT = false>
GT_HDI constexpr int ric_chip_cl() {
  constexpr int top = ric_chip_top<NJ>();
  return ric_chip_swmax<T, NJ, top, FACT>(1)   ? 1
         : ric_chip_swmax<T, NJ, top, FACT>(2) ? 2
         : ric_chip_swmax<T, NJ, top, FACT>(4) ? 4
                                                : 0;
}
template <typename T, int NJ, bool FACT = false>
GT_HDI constexpr int ric_chip_sw() {
  constexpr int cl = ric_chip_cl<T, NJ, FACT>();
  constexpr int sw =
      cl ? ric_chip_swmax<T, NJ, ric_chip_top<NJ>(), FACT>(cl) : 8;
  constexpr int ncol = (int)round4(2 * NJ) + (int)round4(NJ);
  constexpr int ns = (ncol + sw - 1) / sw;
  return (int)round4((ncol + ns - 1) / ns);
}

// One problem a block of 2 CHIP_THREADS threads, or a cluster of CL blocks
// of CHIP_THREADS (at 52 joints: one block in float32, 229 KB; a cluster
// of 2 in float64; at 64 joints 2 | 4, float32 | float64). FACT: the
// factored curvature's plan (Jw in the tiles, no curvature block).
template <typename T, int NJ, bool FACT = false>
struct RicChipPlan {
  static constexpr int SW = ric_chip_sw<T, NJ, FACT>();
  using O = RicChipKnot<NJ, SW, FACT>;
  static constexpr ChipPack<7> PACK =
      ric_chip_pack<T, NJ, SW, FACT>(ric_chip_cl<T, NJ, FACT>());
  static constexpr int CL = PACK.cl;
  static constexpr int NT = CL == 1 ? 2 * CHIP_THREADS : CHIP_THREADS;
  static constexpr int LANES = CL * NT, G = 1, ROWS = 1;
  static constexpr int VEC = 16 / (int)sizeof(T);   // values a 16-byte copy
  static constexpr long long HEAD = 0;
  static constexpr long long RANK_VALUES = chip_rank_values(PACK);
  static constexpr long long BYTES = chip_bytes(PACK, (int)sizeof(T), 0);
  static constexpr int RK0 = PACK.rank[0], RK1 = PACK.rank[1];
  static constexpr int RK2 = PACK.rank[2], RK3 = PACK.rank[3];
  static constexpr int RK4 = PACK.rank[4], RK5 = PACK.rank[5];
  static constexpr int RK6 = PACK.rank[6];
  static constexpr long long OF0 = PACK.off[0], OF1 = PACK.off[1];
  static constexpr long long OF2 = PACK.off[2], OF3 = PACK.off[3];
  static constexpr long long OF4 = PACK.off[4], OF5 = PACK.off[5];
  static constexpr long long OF6 = PACK.off[6];
  // each region's pointer, from base(rank): that rank's state (of U: the
  // host runs a plan's program in another number type)
  template <class Base, typename U>
  GT_HDI static void regions(Base&& base, U** rg) {
    rg[0] = base(RK0) + OF0;
    rg[1] = base(RK1) + OF1;
    rg[2] = base(RK2) + OF2;
    rg[3] = base(RK3) + OF3;
    rg[4] = base(RK4) + OF4;
    rg[5] = base(RK5) + OF5;
    rg[6] = base(RK6) + OF6;
  }
};

// every curvature (factored, stationary or a block per knot) runs on chip
// from CHIP_FROM joints (warp.cuh: fd_on_chip)
template <typename T, int NJ, int CURV>
GT_HDI constexpr bool ric_on_chip() {
  return NJ >= CHIP_FROM;
}

// The curvature of the knot program on chip (riccati_chip_knot), rows
// i0 .. i0 + 3 and columns c0 .. c0 + 3 of lxx (x with xx) or lux (x
// without), or of luu (uu), into a 4 x 4 tile `cur`, added to the
// product's tile where it is folded. The dense blocks (NXP, NJP: their
// rows' lengths) from device memory at c, rows past M zeros:
template <typename T, int NJ, int NXP, int NJP, int CXX, int CUX, int CUU>
struct ChipDenseCurv {
  const T* c;
  GT_HDI static void rows(const T* p, int ld, int i0, int M,
                          T (&cur)[4][4]) {
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int a = 0; a < 4; ++a) {
      if (i0 + a < M) {
        ld4(p + (i0 + a) * ld, cur[a]);
      } else {
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int j = 0; j < 4; ++j) cur[a][j] = T(0);
      }
    }
  }
  GT_HDI void x(bool xx, int i0, int c0, T (&cur)[4][4]) const {
    rows(c + (xx ? CXX : CUX) + c0, NXP, i0, xx ? 2 * NJ : NJ, cur);
  }
  GT_HDI void uu(int i0, int c0, T (&cur)[4][4]) const {
    rows(c + CUU + c0, NJP, i0, NJ, cur);
  }
};

// the factored one (FactoredIn's): lxx = blkdiag(Jw^T Jw, qd_diag I), formed
// from the knot's factor J (r rows of NJP values, in its tile on chip) an
// entry a thread, each entry once a knot (each lies in one slab); luu =
// u_diag I; lux = 0
template <typename T, int NJ, int NJP>
struct ChipFactoredCurv {
  const T* J;
  int r;
  T qd_diag, u_diag;
  GT_HDI void x(bool xx, int i0, int c0, T (&cur)[4][4]) const {
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int a = 0; a < 4; ++a)
#ifdef __CUDACC__
#pragma unroll
#endif
      for (int j = 0; j < 4; ++j) {
        const int i = i0 + a, k = c0 + j;
        T v = T(0);
        if (xx && i < NJ && k < NJ) {
          v = J[i] * J[k];
          for (int rr = 1; rr < r; ++rr) v += J[rr * NJP + i] * J[rr * NJP + k];
        } else if (xx && i == k && i >= NJ) {
          v = qd_diag;
        }
        cur[a][j] = v;
      }
  }
  GT_HDI void uu(int i0, int c0, T (&cur)[4][4]) const {
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int a = 0; a < 4; ++a)
#ifdef __CUDACC__
#pragma unroll
#endif
      for (int j = 0; j < 4; ++j) cur[a][j] = i0 + a == c0 + j ? u_diag : T(0);
  }
};

// One backward knot tk of the problem on chip (RicChipPlan P; its
// regions at rg; the curvature lxx, luu, lux of the problem b of B, the
// policy cv: ChipDenseCurv, the stationary block or knot tk's, or
// ChipFactoredCurv), riccati.cu:riccati_knot's math in
// 5 + NS + NJ phases of the cluster's threads, every product a 4 x 4
// register tile a thread (warp.cuh: mma4) over rows of shared memory, the
// tiles dealt columns fastest (the threads of a warp read few rows of the
// left operand and neighbouring 16-byte runs of the right one):
// 1. Qx = lx + A^T Vx, Qu = lu + B^T Vx, and the first slab of
//    [Vxx A | Vxx B];
// 2. a phase a slab s: its columns folded into Qxx = A^T (Vxx A) + lxx and
//    Qux = B^T (Vxx A) + lux, or Quu = B^T (Vxx B) + luu (stored
//    transposed), while slab s + 1 is formed; then after() (the next
//    knot's A and B may be staged);
// 3. [Quu + reg I | I] with its first pivot's inverse; Gauss-Jordan
//    without pivoting, a pivot a phase (gj_phases_cols);
// 4. k = -Quu^-1 Qu, K = -Quu^-1 Qux, written to ks, Ks as well;
// 5. Qu + Quu k, W = Quu K + Qux;
// 6. Vx = Qx + K^T (Qu + Quu k) + Qux^T k, Vxx' = Qxx + K^T W + Qux^T K
//    (the full value update: K^T Quu K + K^T Qux + Qux^T K + Qxx), in
//    place over Qxx;
// 7. Vxx = (Vxx' + Vxx'^T) / 2.
template <typename T, int NJ, class P, class Par, class Curv, class After>
GT_HD void riccati_chip_knot(const Par& par, T* const* rg, const Curv& cv,
                             long long B, long long b, int tk, T mu, T* ks,
                             T* Ks, After&& after) {
  using O = typename P::O;
  constexpr int NX = O::NX, NXP = O::NXP, NJP = O::NJP, SW = O::SW;
  constexpr int NS = O::NS, NCOL = O::NCOL, W = Par::LANES, M2 = 2 * NJ;
  constexpr int XT = NXP / 4, JT = NJP / 4;   // row tiles
  const T* A = rg[O::R_AB] + O::A;
  const T* Bm = rg[O::R_AB] + O::BM;
  const T* lx = rg[O::R_AB] + O::LX;
  const T* lu = rg[O::R_AB] + O::LU;
  T* Vxx = rg[O::R_VXX];
  T* aug = Vxx;
  T* Wm = Vxx;
  T* Kk = Vxx + O::KK;
  T* Qxx = rg[O::R_QXX];
  T* Qux = rg[O::R_QUX];
  T* QuuT = rg[O::R_QUU];
  T* sm = rg[O::R_SMALL];
  T* Vx = sm + O::VX;
  T* Qx = sm + O::QX;
  T* Qu = sm + O::QU;
  T* kt = sm + O::KT;
  T* up = sm + O::UP;
  T* piv = sm + O::PIV;
  auto slab = [&](int s) { return rg[O::R_SL] + (s & 1) * NX * SW; };
  auto cols = [&](int s) { return NCOL - s * SW < SW ? NCOL - s * SW : SW; };
  // slab s of [Vxx A | Vxx B]: rows of Vxx^T times columns of A or B
  auto vab = [&](Deal<W>& d, int s) {
    const int c0 = s * SW;
    T* out = slab(s);
    d(XT * (cols(s) / 4), [&](int e) {
      const int i0 = 4 * (e / (cols(s) / 4)), cc = 4 * (e % (cols(s) / 4));
      const int c = c0 + cc;
      const T* R = c < NXP ? A + c : Bm + (c - NXP);
      const int ldr = c < NXP ? NXP : NJP;
      T acc[4][4] = {};
      mma4(acc, NX, [&](int k, T* l) { ld4(Vxx + k * NXP + i0, l); },
           [&](int k, T* r) { ld4(R + k * ldr, r); });
      for (int a = 0; a < 4; ++a)
        if (i0 + a < NX)
          for (int j = 0; j < 4; ++j) out[(i0 + a) * SW + cc + j] = acc[a][j];
    });
  };
  // slab s folded: A's columns into Qxx and Qux, B's into Quu^T
  auto fold = [&](Deal<W>& d, int s) {
    const int c0 = s * SW;
    const int na = c0 >= NXP ? 0 : (c0 + cols(s) < NXP ? cols(s) : NXP - c0);
    const T* in = slab(s);
    d((XT + JT) * (na / 4), [&](int e) {
      const int cc = 4 * (e % (na / 4)), rt = e / (na / 4), c = c0 + cc;
      const bool xx = rt < XT;
      const int i0 = 4 * (xx ? rt : rt - XT), M = xx ? NX : NJ;
      const int ldl = xx ? NXP : NJP;
      const T* Lm = xx ? A : Bm;
      T cur[4][4];
      cv.x(xx, i0, c, cur);
      T acc[4][4] = {};
      mma4(acc, NX, [&](int k, T* l) { ld4(Lm + k * ldl + i0, l); },
           [&](int k, T* r) { ld4(in + k * SW + cc, r); });
      T* out = xx ? Qxx : Qux;
      for (int a = 0; a < 4; ++a)
        for (int j = 0; j < 4; ++j)
          if (i0 + a < M && c + j < NX)
            out[(i0 + a) * NXP + c + j] = acc[a][j] + cur[a][j];
    });
    d(JT * ((cols(s) - na) / 4), [&](int e) {
      const int nb = (cols(s) - na) / 4;
      const int cc = na + 4 * (e % nb), i0 = 4 * (e / nb);
      const int j0 = c0 + cc - NXP;
      T cur[4][4];
      cv.uu(i0, j0, cur);
      T acc[4][4] = {};
      mma4(acc, NX, [&](int k, T* l) { ld4(Bm + k * NJP + i0, l); },
           [&](int k, T* r) { ld4(in + k * SW + cc, r); });
      for (int a = 0; a < 4; ++a)
        for (int j = 0; j < 4; ++j)
          if (i0 + a < NJ && j0 + j < NJ)
            QuuT[(j0 + j) * NJP + i0 + a] = acc[a][j] + cur[a][j];
    });
  };

  par([&](int t) {
    Deal<W> d{t, 0};
    d(NX, [&](int i) {
      T s = A[i] * Vx[0];
      for (int k = 1; k < NX; ++k) s += A[k * NXP + i] * Vx[k];
      Qx[i] = lx[i] + s;
    });
    d(NJ, [&](int i) {
      T s = Bm[i] * Vx[0];
      for (int k = 1; k < NX; ++k) s += Bm[k * NJP + i] * Vx[k];
      Qu[i] = lu[i] + s;
    });
    vab(d, 0);
  });
  for (int s = 0; s < NS; ++s) {
    par([&](int t) {
      Deal<W> d{t, 0};
      fold(d, s);
      if (s + 1 < NS) vab(d, s + 1);
    });
  }
  after();
  par([&](int t) {
    for (int e = t; e < NJ * NJ; e += W) {
      const int i = e / NJ, j = e % NJ;
      const T q = QuuT[j * NJP + i];
      aug[i * M2 + j] = i == j ? q + mu : q;
      aug[i * M2 + NJ + j] = i == j ? T(1) : T(0);
      if (e == 0) piv[0] = T(1) / (q + mu);
    }
  });
  gj_phases_cols<T, NJ>(par, aug, piv);
  par([&](int t) {
    Deal<W> d{t, 0};
    d(NJ, [&](int i) {
      T s = gj_inv<T, NJ>(aug, piv, i, 0) * Qu[0];
      for (int j = 1; j < NJ; ++j) s += gj_inv<T, NJ>(aug, piv, i, j) * Qu[j];
      kt[i] = -s;
      ks[((long long)tk * NJ + i) * B + b] = -s;
    });
    d(JT * XT, [&](int e) {
      const int i0 = 4 * (e / XT), m0 = 4 * (e % XT);
      T acc[4][4] = {};
      mma4(acc, NJ,
           [&](int j, T* l) {
             for (int a = 0; a < 4; ++a)
               l[a] = gj_inv<T, NJ>(aug, piv, i0 + a < NJ ? i0 + a : NJ - 1,
                                    j);
           },
           [&](int j, T* r) { ld4(Qux + j * NXP + m0, r); });
      for (int a = 0; a < 4; ++a)
        for (int c = 0; c < 4; ++c)
          if (i0 + a < NJ && m0 + c < NX) {
            Kk[(i0 + a) * NXP + m0 + c] = -acc[a][c];
            Ks[(((long long)tk * NJ + i0 + a) * NX + m0 + c) * B + b] =
                -acc[a][c];
          }
    });
  });
  par([&](int t) {
    Deal<W> d{t, 0};
    d(NJ, [&](int i) {
      T s = QuuT[i] * kt[0];
      for (int j = 1; j < NJ; ++j) s += QuuT[j * NJP + i] * kt[j];
      up[i] = Qu[i] + s;
    });
    d(JT * XT, [&](int e) {
      const int i0 = 4 * (e / XT), m0 = 4 * (e % XT);
      T acc[4][4] = {};
      mma4(acc, NJ, [&](int j, T* l) { ld4(QuuT + j * NJP + i0, l); },
           [&](int j, T* r) { ld4(Kk + j * NXP + m0, r); });
      for (int a = 0; a < 4; ++a)
        for (int c = 0; c < 4; ++c)
          if (i0 + a < NJ && m0 + c < NX) {
            const int o = (i0 + a) * NXP + m0 + c;
            Wm[o] = Qux[o] + acc[a][c];
          }
    });
  });
  par([&](int t) {
    Deal<W> d{t, 0};
    d(NX, [&](int m) {
      T s1 = Kk[m] * up[0], s2 = Qux[m] * kt[0];
      for (int i = 1; i < NJ; ++i) {
        s1 += Kk[i * NXP + m] * up[i];
        s2 += Qux[i * NXP + m] * kt[i];
      }
      Vx[m] = Qx[m] + s1 + s2;
    });
    d(XT * XT, [&](int e) {
      const int m0 = 4 * (e / XT), l0 = 4 * (e % XT);
      T acc[4][4] = {};
      mma4(acc, NJ, [&](int i, T* l) { ld4(Kk + i * NXP + m0, l); },
           [&](int i, T* r) { ld4(Wm + i * NXP + l0, r); });
      mma4(acc, NJ, [&](int i, T* l) { ld4(Qux + i * NXP + m0, l); },
           [&](int i, T* r) { ld4(Kk + i * NXP + l0, r); });
      for (int a = 0; a < 4; ++a)
        for (int c = 0; c < 4; ++c)
          if (m0 + a < NX && l0 + c < NX)
            Qxx[(m0 + a) * NXP + l0 + c] += acc[a][c];
    });
  });
  par([&](int t) {
    for (int e = t; e < NX * NX; e += W) {
      const int m = e / NX, l = e % NX;
      Vxx[m * NXP + l] = T(0.5) * (Qxx[m * NXP + l] + Qxx[l * NXP + m]);
    }
  });
}

// The sweep of problem b on chip, from its record `rec` in the
// problem-major copy of the inputs (RicChipKnot::record): the value
// function (Vxx0 transposed) and knot N - 1's tile staged by their
// regions' ranks (mine(rank): this thread's block holds the rank; thread
// tid of the block's nt), then knot N - 1 down to 0, each staging the knot
// after it (16-byte copies of its record's tile) once its products are
// folded, and reading its dense curvature from the record
// (RIC_STATIONARY: one block) or forming the factored one (RIC_FACTORED:
// rank r, qd_diag, u_diag) from the Jw of its tile.
template <typename T, int NJ, class P, int CURV, class Par, class Mine>
GT_HD void riccati_chip_problem(const Par& par, T* const* rg, Mine&& mine,
                                int tid, int nt, const T* rec, const T* Vx0,
                                const T* Vxx0, T* ks, T* Ks, int N,
                                long long B, long long b, T mu, int r,
                                T qd_diag, T u_diag) {
  using O = typename P::O;
  constexpr int NX = O::NX, NXP = O::NXP, V = P::VEC;
  static_assert(O::R_AB == 0 && O::R_VXX == 2 && O::R_SMALL == 6,
                "RK0, RK2, RK6: the AB, VXX and SMALL regions' ranks");
  auto stage = [&](int t) {
    if (!mine(P::RK0)) return;
    T* ab = rg[O::R_AB];
    const T* src = rec + (long long)t * O::AB;
    for (int e = tid * V; e < O::AB; e += nt * V)
      async_copy16<V>(ab + e, src + e);
  };
  if (mine(P::RK6))
    for (int e = tid; e < NX; e += nt)
      async_copy(rg[O::R_SMALL] + O::VX + e, Vx0 + (long long)e * B + b);
  if (mine(P::RK2))
    for (int e = tid; e < NX * NX; e += nt)
      async_copy(rg[O::R_VXX] + (e % NX) * NXP + e / NX,
                 Vxx0 + (long long)e * B + b);
  stage(N - 1);
  async_commit();
  const T* curv = rec + (long long)N * O::AB;
  for (int t = N - 1; t >= 0; --t) {
    async_wait<0>();
    par([](int) {});   // knot t's tiles have landed in every block
    auto after = [&] {
      if (t > 0) {
        stage(t - 1);
        async_commit();
      }
    };
    if constexpr (CURV == RIC_FACTORED) {
      const ChipFactoredCurv<T, NJ, O::NJP> cv{rg[O::R_AB] + O::JW, r,
                                               qd_diag, u_diag};
      riccati_chip_knot<T, NJ, P>(par, rg, cv, B, b, t, mu, ks, Ks, after);
    } else {
      const ChipDenseCurv<T, NJ, O::NXP, O::NJP, O::CXX, O::CUX, O::CUU> cv{
          curv + (CURV == RIC_STATIONARY ? 0 : t) * O::CURV};
      riccati_chip_knot<T, NJ, P>(par, rg, cv, B, b, t, mu, ks, Ks, after);
    }
  }
}

// ---------------------------------------------------------------------------
// the rollouts (linesearch_rollout, rollout): a thread group per rollout
// ---------------------------------------------------------------------------

// One rollout's state: the joint transforms X, the articulated inertias
// IA (of the joints with children; a leaf's is its I), the backward pass's
// X^T Ia (TMP; the EE cost's chain transforms over it, formed and read in
// the forward phases), velocities v (accelerations a over them: no joint
// reads v once the bias forces are formed), the bias terms c and pA, the
// backward pass's pa, each joint's 1 / D and u - tau_damp - pA[S] once its
// IA and pA are final, then the state x = [q; qd], the control u, the step
// size, the cost so far, and two copies of (x, u) after a step for the
// block to write out while the next step runs.
template <int NJ>
struct LSRoll {
  static constexpr int NX = 2 * NJ;
  static constexpr int X = 0, IA = X + 36 * NJ, TMP = IA + 36 * NJ;
  static constexpr int TJ = TMP;   // (NJ, 16)
  static constexpr int V = TMP + 36 * NJ, A = V;
  static constexpr int CB = V + 6 * NJ, PA = CB + 6 * NJ, PAC = PA + 6 * NJ;
  static constexpr int DINV = PAC + 6 * NJ, UU = DINV + NJ;
  static constexpr int XS = UU + NJ, U = XS + NX, ALPHA = U + NJ;
  static constexpr int COST = ALPHA + 1;
  static constexpr int OUT = COST + 1, SIZE = OUT + 2 * (NX + NJ);
};

// One problem's inputs at one knot, shared by its step-size rows: K (NJ,
// NX), Xref (NX), Uref (NJ), k (NJ).
template <int NJ>
struct LSTile {
  static constexpr int NX = 2 * NJ;
  static constexpr int KM = 0, XR = KM + NJ * NX, UR = XR + NX, KF = UR + NJ;
  static constexpr int SIZE = KF + NJ;
};

// The control laws of the step: `stage` reads knot t's inputs of problems
// b0 .. b0 + G - 1 into their tiles (TILE values each), `alpha` is the step
// size of lane a B + b, and `u` forms joint j's control from the tile and
// the state xs. STORES_U: the block writes u out too.
// The line search's: u = clamp(Uref + (alpha k + K (x - Xref))) on LSTile.
template <typename T, int NJ>
struct FeedbackLaw {
  using P = LSTile<NJ>;
  static constexpr int NX = 2 * NJ, TILE = P::SIZE;
  static constexpr bool STORES_U = true;
  const T *Uref, *Xref, *kf, *K, *alpha_rows;
  template <int G, bool ASYNC = true>
  GT_HD void stage(int t, long long b0, int nvalid, long long B, T* dst,
                   long long TS, int tid, int nt) const {
    stage_runs<G, ASYNC>(K + (long long)t * NJ * NX * B + b0, B, NJ * NX,
                         nvalid, dst + P::KM, TS, tid, nt);
    stage_runs<G, ASYNC>(Xref + (long long)t * NX * B + b0, B, NX, nvalid,
                         dst + P::XR, TS, tid, nt);
    stage_runs<G, ASYNC>(Uref + (long long)t * NJ * B + b0, B, NJ, nvalid,
                         dst + P::UR, TS, tid, nt);
    stage_runs<G, ASYNC>(kf + (long long)t * NJ * B + b0, B, NJ, nvalid,
                         dst + P::KF, TS, tid, nt);
  }
  GT_HDI T alpha(long long lane) const { return alpha_rows[lane]; }
  GT_HDI T u(const T* tile, const T* xs, T alpha, int j, const T* lo,
             const T* hi) const {
    const T* Kj = tile + P::KM + j * NX;
    const T* xr = tile + P::XR;
    T s = Kj[0] * (xs[0] - xr[0]);
    for (int m = 1; m < NX; ++m) s += Kj[m] * (xs[m] - xr[m]);
    return clamp_bounds(tile[P::UR + j] + (alpha * tile[P::KF + j] + s), lo,
                        hi, j);
  }
};

// The feedback rollout's: the line search's law with the step size exactly
// 1 (the caller folds it into kf), and no tensor of step sizes: alpha k + s
// is then k + s under any contraction into FMAs.
template <typename T, int NJ>
struct FoldedStepLaw : FeedbackLaw<T, NJ> {
  GT_HDI T alpha(long long) const { return T(1); }
};

// The open-loop rollout's: u = clamp(U_t), U (N, NJ, B); its tile is U_t.
template <typename T, int NJ>
struct OpenLoop {
  static constexpr int TILE = NJ;
  static constexpr bool STORES_U = false;
  const T* U;
  template <int G, bool ASYNC = true>
  GT_HD void stage(int t, long long b0, int nvalid, long long B, T* dst,
                   long long TS, int tid, int nt) const {
    stage_runs<G, ASYNC>(U + (long long)t * NJ * B + b0, B, NJ, nvalid, dst,
                         TS, tid, nt);
  }
  GT_HDI T alpha(long long) const { return T(0); }
  GT_HDI T u(const T* tile, const T*, T, int j, const T* lo,
             const T* hi) const {
    return clamp_bounds(tile[j], lo, hi, j);
  }
};

// The block's constants: the robot, the cost's (csrc/linesearch.cu: EE 7,
// quadratic 7 NJ values) and the control bounds.
template <typename T, int NJ>
struct LSHead {
  RobotConst<T, NJ> R;
  T cost[7 * NJ];
  T lo[NJ], hi[NJ];
  int has_lo, has_hi;
  GT_HD void load(const T* model, const T* cbuf, int ncost, const T* lo_,
                  const T* hi_, int tid, int nt) {
    R.load(model, tid, nt);
    for (int e = tid; e < ncost; e += nt) cost[e] = cbuf[e];
    for (int i = tid; i < NJ; i += nt) {
      if (lo_) lo[i] = lo_[i];
      if (hi_) hi[i] = hi_[i];
    }
    if (tid == 0) {
      has_lo = lo_ != nullptr;
      has_hi = hi_ != nullptr;
    }
  }
};

// The costs of the group program (the arithmetic of linesearch.cu's EECost
// and QuadCostK). `prep` runs a joint a thread in the step's first phase,
// with cos and sin of a revolute joint's q; stage and terminal run on one
// thread. EE: rows 0-2 of each chain joint's transform Ttree_i Tj(q_i)
// (joint_T's product, formed without its 4x4 temporaries) a joint a
// thread, then the EE position T_c0 ... T_ck Tfixed applied to the origin,
// from the leaf up (matrix-vector products).
template <typename T, int NJ>
struct EECostW {
  static constexpr bool FK = true, SUMS = true;
  template <class Rb>
  GT_HDI void prep(const Rb& R, int i, T qi, T c, T s, T* Tj) const {
    if (!R.in_ee_chain(i)) return;
    const T* TT = R.Ttree(i);
    T tt[12], m[12];
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int e = 0; e < 12; ++e) tt[e] = TT[e];
    if (R.jtype[i] == 0) {   // TT [R_axis(q), 0; 0, 1]
      const T o = T(1), z = T(0);
      const int ax = R.sind[i] % 3;
      const T r00 = ax == 0 ? o : c, r01 = ax == 2 ? -s : z,
              r02 = ax == 1 ? s : z;
      const T r10 = ax == 2 ? s : z, r11 = ax == 1 ? o : c,
              r12 = ax == 0 ? -s : z;
      const T r20 = ax == 1 ? -s : z, r21 = ax == 0 ? s : z,
              r22 = ax == 2 ? o : c;
#ifdef __CUDACC__
#pragma unroll
#endif
      for (int r = 0; r < 3; ++r) {
        const T a0 = tt[r * 4], a1 = tt[r * 4 + 1], a2 = tt[r * 4 + 2];
        m[r * 4] = a0 * r00 + a1 * r10 + a2 * r20;
        m[r * 4 + 1] = a0 * r01 + a1 * r11 + a2 * r21;
        m[r * 4 + 2] = a0 * r02 + a1 * r12 + a2 * r22;
        m[r * 4 + 3] = tt[r * 4 + 3];
      }
    } else {   // TT [I, q e_k; 0, 1]
      const int kk = R.sind[i] - 3;
#ifdef __CUDACC__
#pragma unroll
#endif
      for (int r = 0; r < 3; ++r) {
        for (int col = 0; col < 3; ++col) m[r * 4 + col] = tt[r * 4 + col];
        const T tk = kk == 0 ? tt[r * 4] : kk == 1 ? tt[r * 4 + 1]
                                                   : tt[r * 4 + 2];
        m[r * 4 + 3] = tk * qi + tt[r * 4 + 3];
      }
    }
    T* M = Tj + 16 * i;
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int e = 0; e < 12; ++e) M[e] = m[e];
  }
  // |ee(q) - goal|^2 and |qd|^2
  struct Squares {
    T e2, v2;
  };
  template <class Rb>
  GT_HDI Squares squares(const Rb& R, const T* c, const T* Tj,
                         const T* x) const {
    const T* Tf = R.Tfixed();
    T p0 = Tf[3], p1 = Tf[7], p2 = Tf[11];
    for (int i = NJ - 1; i >= 0; --i) {
      if (!R.in_ee_chain(i)) continue;
      const T* M = Tj + 16 * i;
      const T n0 = M[0] * p0 + M[1] * p1 + M[2] * p2 + M[3];
      const T n1 = M[4] * p0 + M[5] * p1 + M[6] * p2 + M[7];
      const T n2 = M[8] * p0 + M[9] * p1 + M[10] * p2 + M[11];
      p0 = n0;
      p1 = n1;
      p2 = n2;
    }
    const T d0 = p0 - c[0], d1 = p1 - c[1], d2 = p2 - c[2];
    T v2 = T(0);
    for (int i = 0; i < NJ; ++i) v2 += x[NJ + i] * x[NJ + i];
    T e2 = T(0);
    e2 += d0 * d0;
    e2 += d1 * d1;
    e2 += d2 * d2;
    return {e2, v2};
  }
  // c: goal (3) | w_pos | w_pos_f | w_vel | w_u
  template <class Rb>
  GT_HDI T stage(const Rb& R, const T* c, const T* Tj, const T* x,
                 const T* u) const {
    T u2 = T(0);
    const Squares q = squares(R, c, Tj, x);
    for (int j = 0; j < NJ; ++j) u2 += u[j] * u[j];
    return T(0.5) * (c[3] * q.e2 + c[5] * q.v2 + c[6] * u2);
  }
  template <class Rb>
  GT_HDI T terminal(const Rb& R, const T* c, const T* Tj, const T* x) const {
    const Squares q = squares(R, c, Tj, x);
    return T(0.5) * (c[4] * q.e2 + c[5] * q.v2);
  }
};

template <typename T, int NJ>
struct QuadCostW {
  static constexpr bool FK = false, SUMS = true;
  static constexpr int NX = 2 * NJ;
  template <class Rb>
  GT_HDI void prep(const Rb&, int, T, T, T, T*) const {}
  // c: Q (NX) | R (NJ) | Qf (NX) | x_goal (NX)
  GT_HDI T squares(const T* c, const T* w, const T* x) const {
    const T* xg = c + 2 * NX + NJ;
    T acc = T(0);
    for (int i = 0; i < NX; ++i) {
      const T d = x[i] - xg[i];
      acc += w[i] * d * d;
    }
    return acc;
  }
  template <class Rb>
  GT_HDI T stage(const Rb&, const T* c, const T*, const T* x,
                 const T* u) const {
    T acc = squares(c, c, x);
    for (int j = 0; j < NJ; ++j) acc += c[NX + j] * u[j] * u[j];
    return T(0.5) * acc;
  }
  template <class Rb>
  GT_HDI T terminal(const Rb&, const T* c, const T*, const T* x) const {
    return T(0.5) * squares(c, c + NX + NJ, x);
  }
};

// No cost (the open-loop rollout): its phases do no work and read nothing.
template <typename T, int NJ>
struct NoCost {
  static constexpr bool FK = false, SUMS = false;
  template <class Rb>
  GT_HDI void prep(const Rb&, int, T, T, T, T*) const {}
  template <class Rb>
  GT_HDI T stage(const Rb&, const T*, const T*, const T*, const T*) const {
    return T(0);
  }
  template <class Rb>
  GT_HDI T terminal(const Rb&, const T*, const T*, const T*) const {
    return T(0);
  }
};

// X_i(q_i) from cos and sin of a revolute q_i: dynamics.cuh:joint_xmat's
// arithmetic, with X_tree read into registers first and E formed by
// selects (no run-time index into a local array)
template <typename T>
GT_HDI void ls_xmat(const T* XT, int jtype, int sind, T qi, T c, T s,
                    T* X) {
  T xt[36], out[36], E[9];
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int e = 0; e < 36; ++e) xt[e] = XT[e];
  const T o = T(1), z = T(0);
  if (jtype == 0) {   // E = R_axis(q)^T on both 3x3 blocks
    const int ax = sind % 3;
    E[0] = ax == 0 ? o : c;
    E[1] = ax == 2 ? s : z;
    E[2] = ax == 1 ? -s : z;
    E[3] = ax == 2 ? -s : z;
    E[4] = ax == 1 ? o : c;
    E[5] = ax == 0 ? s : z;
    E[6] = ax == 1 ? s : z;
    E[7] = ax == 0 ? -s : z;
    E[8] = ax == 2 ? o : c;
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int r = 0; r < 3; ++r)
      for (int col = 0; col < 6; ++col) {
        out[r * 6 + col] = E[r * 3] * xt[col] + E[r * 3 + 1] * xt[6 + col] +
                           E[r * 3 + 2] * xt[12 + col];
        out[(r + 3) * 6 + col] = E[r * 3] * xt[18 + col] +
                                 E[r * 3 + 1] * xt[24 + col] +
                                 E[r * 3 + 2] * xt[30 + col];
      }
  } else {   // [[I, 0], [-skew(q e_k), I]] X_tree
    const int k = sind - 3;
    E[0] = z;
    E[1] = k == 2 ? -qi : z;
    E[2] = k == 1 ? qi : z;
    E[3] = k == 2 ? qi : z;
    E[4] = z;
    E[5] = k == 0 ? -qi : z;
    E[6] = k == 1 ? -qi : z;
    E[7] = k == 0 ? qi : z;
    E[8] = z;
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int r = 0; r < 3; ++r)
      for (int col = 0; col < 6; ++col) {
        out[r * 6 + col] = xt[r * 6 + col];
        out[(r + 3) * 6 + col] =
            xt[(r + 3) * 6 + col] -
            (E[r * 3] * xt[col] + E[r * 3 + 1] * xt[6 + col] +
             E[r * 3 + 2] * xt[12 + col]);
      }
  }
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int e = 0; e < 36; ++e) X[e] = out[e];
}

// row r of joint i's velocity v_i = X_i v_p + S_i qd_i
template <typename T, int NJ, class Rb>
GT_HDI void ls_v_row(const Rb& R, const T* X, T* v, const T* xs, int i,
                     int r) {
  const int p = R.parent[i];
  T x = p == -1 ? T(0) : xmrow(X + 36 * i, v + 6 * p, r);
  if (r == R.sind[i]) x = p == -1 ? xs[NJ + i] : x + xs[NJ + i];
  v[6 * i + r] = x;
}

// joint i's bias terms c_i = v_i x (S_i qd_i), pA_i = v_i x* I_i v_i; for a
// leaf (IA_i = I_i, pA_i final) also 1 / D_i and u_i - tau_damp - pA_i[S]
template <typename T, int NJ, class Rb>
GT_HDI void ls_bias(const Rb& R, const T* v, const T* xs, const T* u, T* cb,
                    T* pA, T* dinv, T* uu, int i) {
  const int s = R.sind[i];
  const T qd = xs[NJ + i];
  T vi[6], vJ[6], Iv[6], c[6], f[6];
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int m = 0; m < 6; ++m) {
    vi[m] = v[6 * i + m];
    vJ[m] = m == s ? qd : T(0);
  }
  cross_mv(vi, vJ, c);
  Xv(R.Imat(i), vi, Iv);
  cross_fv(vi, Iv, f);
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int m = 0; m < 6; ++m) {
    cb[6 * i + m] = c[m];
    pA[6 * i + m] = f[m];
  }
  if (R.cstart[i] == R.cstart[i + 1]) {
    dinv[i] = T(1) / R.Imat(i)[s * 6 + s];
    uu[i] = (u[i] - R.damping(i) * qd) - pick6(f, s);
  }
}

// joint i's articulated inertia: its I for a leaf
template <typename T, class Rb>
GT_HDI const T* ls_ia(const Rb& R, const T* IA, int i) {
  return R.cstart[i] == R.cstart[i + 1] ? R.Imat(i) : IA + 36 * i;
}

// Where ABA's quantities of one rollout (LSRoll) or knot (ABAKnot) sit in
// shared memory: the joint transforms X, the articulated inertias IA (of
// the joints with children; a leaf's is its I), X^T Ia (tmp), the
// velocities v (the accelerations over them), the bias terms c and pA, pa,
// 1 / D and u - tau_damp - pA[S], the state q then qd (xs) and the control
// u. The caller forms the pointers once, at the top of its program, in the
// order of its layout (formed in another order, the feedback rollout's
// registers moved).
template <typename T>
struct AbaView {
  T* X;
  T* IA;
  T* tmp;
  T* v;
  T* cb;
  T* pA;
  T* pac;
  T* dinv;
  T* uu;
  T* xs;
  T* u;
};

// ABA (dynamics.cuh:aba) on the view V, in 4 L - 1 phases for a tree of L
// levels, split over the group's threads, with four hooks for the caller's
// work in the same phases:
// 1. head(d): the caller's items first (the rollouts' control law, a
//    joint a thread, on the phase's Deal d); the joint transforms a joint
//    a thread, each followed by prep(i, q_i, cos q_i, sin q_i) (the EE
//    cost's chain transforms); v of level 0 a row a thread;
// 2. .. L + 1: v of level l a row a thread, and c = v x S qd and pA = v x*
//    I v of level l - 1 a joint a thread (a leaf's 1 / D and u - tau_damp -
//    pA[S] too); then stage(l, t) on every thread (the rollouts' stage
//    cost, at l = 1 on the group's last thread);
// then per level l = L - 1 .. 1, deepest first, two phases:
//    (a) for each joint i of level l, column c of X^T Ia a thread (Ia =
//        IA - U Dinv U^T, its column formed in registers) and row r of pa
//        a thread;
//    (b) for each parent of level l - 1, row r of IA_p (from I_p) and of
//        pA_p a thread, which adds in the children in descending order, as
//        the serial sweep does; the thread of row S_p then forms 1 / D_p
//        and u_p - tau_damp - pA_p[S];
// then per level l = 0 .. L - 1, a joint a thread: its qdd, handed to
// sink(i, qdd, put_a), which calls put_a() where joint i's acceleration
// a_i is to be written (the rollouts: between the loads and the stores of
// the Euler update of q_i and qd_i; aba: before it stores qdd).
// A thread reads its operands into registers before it writes: a store to
// shared memory keeps the loads after it from starting early.
// Force-inlined: the open-loop and feedback rollouts compile to the machine
// code of the step written out in one function; the line search's differs
// only in the order of its address arithmetic and registers, and runs as
// fast (compare_kernels.py --sass; PERF.md).
template <typename T, int NJ, class Rb, class Par, class Head, class Prep,
          class Stage, class Sink>
GT_HDI void aba_phases(const Par& par, const Rb& R, const AbaView<T>& V,
                       int nlev, T gravity, Head&& head, Prep&& prep,
                       Stage&& stage, Sink&& sink) {
  constexpr int W = Par::LANES;
  T* X = V.X;
  T* IA = V.IA;
  T* tmp = V.tmp;
  T* v = V.v;
  T* a = V.v;
  T* cb = V.cb;
  T* pA = V.pA;
  T* pac = V.pac;
  T* dinv = V.dinv;
  T* uu = V.uu;
  T* xs = V.xs;
  T* u = V.u;

  par([&](int t) {
    Deal<W> d{t, 0};
    head(d);
    d(NJ, [&](int i) {
      const T q = xs[i];
      const bool rev = R.jtype[i] == 0;
      const T c = rev ? gcos(q) : T(0), sn = rev ? gsin(q) : T(0);
      ls_xmat(R.Xtree(i), R.jtype[i], R.sind[i], q, c, sn, X + 36 * i);
      prep(i, q, c, sn);
    });
    level<6>(d, R, 0,
             [&](int i, int r) { ls_v_row<T, NJ>(R, X, v, xs, i, r); });
  });
  for (int l = 1; l <= nlev; ++l) {
    par([&](int t) {
      Deal<W> d{t, 0};
      level<1>(d, R, l - 1, [&](int i, int) {
        ls_bias<T, NJ>(R, v, xs, u, cb, pA, dinv, uu, i);
      });
      if (l < nlev)
        level<6>(d, R, l,
                 [&](int i, int r) { ls_v_row<T, NJ>(R, X, v, xs, i, r); });
      stage(l, t);
    });
  }
  for (int l = nlev - 1; l >= 1; --l) {
    par([&](int t) {
      Deal<W> d{t, 0};
      level<6>(d, R, l, [&](int i, int c) {
        const int s = R.sind[i];
        const T* Ii = ls_ia(R, IA, i);
        const T* Xi = X + 36 * i;
        const T di = dinv[i], usc = Ii[c * 6 + s];
        T col[6], xi[36], o[6];
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int e = 0; e < 36; ++e) xi[e] = Xi[e];
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int m = 0; m < 6; ++m)
          col[m] = Ii[m * 6 + c] - (Ii[m * 6 + s] * di) * usc;
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int r = 0; r < 6; ++r) {   // X's upper-right block is zero
          const int m0 = r < 3 ? 0 : 3;
          T acc = xi[m0 * 6 + r] * col[m0];
          for (int m = m0 + 1; m < 6; ++m) acc += xi[m * 6 + r] * col[m];
          o[r] = acc;
        }
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int r = 0; r < 6; ++r) tmp[36 * i + r * 6 + c] = o[r];
      });
      level<6>(d, R, l, [&](int i, int r) {
        const int s = R.sind[i];
        const T* Ii = ls_ia(R, IA, i);
        const T* c = cb + 6 * i;
        const T di = dinv[i];
        const T ur = Ii[r * 6 + s] * di;
        T tr = (Ii[r * 6] - ur * Ii[s]) * c[0];
        for (int m = 1; m < 6; ++m)
          tr += (Ii[r * 6 + m] - ur * Ii[m * 6 + s]) * c[m];
        pac[6 * i + r] = pA[6 * i + r] + tr + Ii[r * 6 + s] * (di * uu[i]);
      });
    });
    par([&](int t) {
      Deal<W> d{t, 0};
      level<6>(d, R, l - 1, [&](int p, int r) {
        if (R.cstart[p] == R.cstart[p + 1]) return;
        const T* Ip = R.Imat(p);
        T o[6];
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int c = 0; c < 6; ++c) o[c] = Ip[r * 6 + c];
        T pr = pA[6 * p + r];
        for (int n = R.cstart[p]; n < R.cstart[p + 1]; ++n) {
          const int ch = R.clist[n];
          const T* tc = tmp + 36 * ch + r * 6;
          const T* Xc = X + 36 * ch;
#ifdef __CUDACC__
#pragma unroll
#endif
          for (int c = 0; c < 6; ++c) {
            const int m0 = c < 3 ? 0 : 3;
            T acc = tc[m0] * Xc[m0 * 6 + c];
            for (int m = m0 + 1; m < 6; ++m) acc += tc[m] * Xc[m * 6 + c];
            o[c] += acc;
          }
          pr += xmcol(Xc, pac + 6 * ch, r);
        }
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int c = 0; c < 6; ++c) IA[36 * p + r * 6 + c] = o[c];
        pA[6 * p + r] = pr;
        if (r == R.sind[p]) {
          dinv[p] = T(1) / pick6(o, r);
          uu[p] = (u[p] - R.damping(p) * xs[NJ + p]) - pr;
        }
      });
    });
  }
  for (int l = 0; l < nlev; ++l) {
    par([&](int t) {
      Deal<W> d{t, 0};
      level<1>(d, R, l, [&](int i, int) {
        const int p = R.parent[i], s = R.sind[i];
        const T* Xi = X + 36 * i;
        const T* Ii = ls_ia(R, IA, i);
        T ap[6];
        if (p == -1) {
          const T g[6] = {0, 0, 0, 0, 0, -gravity};
          Xmv(Xi, g, ap);
        } else {
          Xmv(Xi, a + 6 * p, ap);
        }
        for (int m = 0; m < 6; ++m) ap[m] += cb[6 * i + m];
        T dot = Ii[s] * ap[0];
        for (int m = 1; m < 6; ++m) dot += Ii[m * 6 + s] * ap[m];
        const T qdd = dinv[i] * (uu[i] - dot);
        sink(i, qdd, [&] {
          for (int m = 0; m < 6; ++m)
            a[6 * i + m] = m == s ? ap[m] + qdd : ap[m];
        });
      });
    });
  }
}

// One step of the rollout whose state sits at `k`, from its problem's tile
// of the knot: the control law (Law), the stage cost, and a semi-implicit
// Euler step on ABA (dynamics.cuh:feedback_u, euler_step, aba): aba_phases,
// its head the control law u = clamp(Uref + (alpha k + K (x - Xref))) (or
// clamp(U_t)) a joint a thread, its prep the cost's chain transforms, its
// stage the stage cost (the first bias phase, on the group's last thread),
// its sink the Euler update of joint i's q and qd.
template <typename T, int NJ, class Cost, class Law, class Rb, class Par>
GT_HD void linesearch_step(const Par& par, const Rb& R, const Cost& cost,
                           const Law& law, const T* cc, T* k, const T* tile,
                           const T* lo, const T* hi, T dt, T gravity) {
  using O = LSRoll<NJ>;
  constexpr int W = Par::LANES;
  T* X = k + O::X;
  T* IA = k + O::IA;
  T* tmp = k + O::TMP;
  T* Tj = k + O::TJ;
  T* v = k + O::V;
  T* cb = k + O::CB;
  T* pA = k + O::PA;
  T* pac = k + O::PAC;
  T* dinv = k + O::DINV;
  T* uu = k + O::UU;
  T* xs = k + O::XS;
  T* u = k + O::U;
  const T alpha = k[O::ALPHA];
  const int nlev = R.nlev;
  const AbaView<T> V{X, IA, tmp, v, cb, pA, pac, dinv, uu, xs, u};
  aba_phases<T, NJ>(
      par, R, V, nlev, gravity,
      [&](Deal<W>& d) {
        d(NJ, [&](int j) { u[j] = law.u(tile, xs, alpha, j, lo, hi); });
      },
      [&](int i, T q, T c, T sn) { cost.prep(R, i, q, c, sn, Tj); },
      [&](int l, int t) {
        if (Cost::SUMS && l == 1 && t == W - 1)
          k[O::COST] = k[O::COST] + cost.stage(R, cc, Tj, xs, u);
      },
      [&](int i, T qdd, auto&& put_a) {
        const T qdn = xs[NJ + i] + dt * qdd;
        const T qn = xs[i] + dt * qdn;
        put_a();
        xs[i] = qn;
        xs[NJ + i] = qdn;
      });
}

// ---------------------------------------------------------------------------
// aba: a thread group per lane on the rollouts' ABA phases
// ---------------------------------------------------------------------------

// One lane's state: its inputs q and qd (the view's xs) and u, its output
// qdd, then the ABA quantities of LSRoll: X, IA and X^T Ia (NJ, 36), v (a
// over it), c, pA and pa (NJ, 6), 1 / D and u - tau_damp - pA[S] (NJ): 138
// NJ values (966 at 7 joints, 3864 at 28: 15.5 KB in float32, 31 KB in
// float64).
template <int NJ>
struct ABAKnot {
  static constexpr int Q = 0, QD = Q + NJ, U = QD + NJ, QDD = U + NJ;
  static constexpr int X = QDD + NJ, IA = X + 36 * NJ, TMP = IA + 36 * NJ;
  static constexpr int V = TMP + 36 * NJ, CB = V + 6 * NJ, PA = CB + 6 * NJ;
  static constexpr int PAC = PA + 6 * NJ, DINV = PAC + 6 * NJ;
  static constexpr int UU = DINV + NJ, SIZE = UU + NJ;
};

// qdd = ABA(q, qd, u) of the knot whose inputs sit at ABAKnot's offsets in
// `k`: the rollouts' aba_phases with no hooks but the sink, which stores
// joint i's qdd (the serial dynamics.cuh:aba's bits).
template <typename T, int NJ, class Rb, class Par>
GT_HD void aba_knot(const Par& par, const Rb& R, T* k, T gravity) {
  using O = ABAKnot<NJ>;
  T* qdd = k + O::QDD;
  const int nlev = R.nlev;
  const AbaView<T> V{k + O::X,  k + O::IA, k + O::TMP,  k + O::V,
                     k + O::CB, k + O::PA, k + O::PAC,  k + O::DINV,
                     k + O::UU, k + O::Q,  k + O::U};
  aba_phases<T, NJ>(
      par, R, V, nlev, gravity, [](auto&) {}, [](int, T, T, T) {},
      [](int, int) {},
      [&](int i, T x, auto&& put_a) {
        put_a();
        qdd[i] = x;
      });
}

// after the last step: cost = acc + terminal
template <typename T, int NJ, class Cost, class Rb, class Par>
GT_HD void linesearch_finish(const Par& par, const Rb& R, const Cost& cost,
                             const T* cc, T* k) {
  using O = LSRoll<NJ>;
  constexpr int W = Par::LANES;
  const T* xs = k + O::XS;
  T* Tj = k + O::TJ;
  if (Cost::FK) par([&](int t) {
    for (int i = t; i < NJ; i += W) {
      const T q = xs[i];
      const bool rev = R.jtype[i] == 0;
      cost.prep(R, i, q, rev ? gcos(q) : T(0), rev ? gsin(q) : T(0), Tj);
    }
  });
  if (Cost::SUMS) par([&](int t) {
    if (t == W - 1) k[O::COST] = k[O::COST] + cost.terminal(R, cc, Tj, xs);
  });
}

// The block: G problems x `rows` step-size rows of them (rows a0 ..), unit
// r G + g the rollout of row a0 + r, problem b0 + g. Each knot's tiles (the
// law's) are read once for all rows, the next knot's staged while this one
// is computed; each unit copies its (x, u) after a step into one of two
// slots, which the block writes to X and U (N, NX | NJ, na B),
// alpha-major lanes a B + b, G lanes a row, while the next step runs: one
// block barrier a step. U is written only under a law that STORES_U, cost
// only under a cost that SUMS (the open-loop rollout: one row, X only).
// `only` >= 0 (the host build) writes only that unit's lanes. ASYNC false:
// the tiles in device memory (TILES_WS of LSPlan and RollShape), staged by
// plain copies.
template <typename T, int NJ, class Cost, int G, bool ASYNC = true, class Law,
          class Par>
GT_HD void linesearch_block(const Par& par, int tid, int nt, int unit,
                            const LSHead<T, NJ>& H, T* tiles, long long TS,
                            T* rolls, long long S, int rows, long long b0,
                            int a0, const T* x0, const Law& law, T* Xo,
                            T* Uo, T* cost_out, int N, long long B, int na,
                            T dt, T gravity, int only = -1) {
  using O = LSRoll<NJ>;
  constexpr int NX = 2 * NJ, W = Par::LANES;
  constexpr int OUT = NX + (Law::STORES_U ? NJ : 0);
  const int nvalid = (int)(B - b0 < G ? B - b0 : G);
  const int nrow = na - a0 < rows ? na - a0 : rows;
  const long long WL = (long long)na * B;
  const Cost cost{};
  const T* lo = H.has_lo ? H.lo : nullptr;
  const T* hi = H.has_hi ? H.hi : nullptr;
  T* k = rolls + unit * S;
  const int g = unit % G;
  auto stage = [&](int t, int buf) {
    law.template stage<G, ASYNC>(t, b0, nvalid, B,
                                 tiles + (long long)buf * G * TS, TS, tid,
                                 nt);
  };
  // step t's (x, u) from the slots to X and U
  auto store = [&](int t) {
    const int slot = O::OUT + (t & 1) * (NX + NJ);
    for (int r = 0; r < nrow; ++r) {
      const int o = only < 0 ? -1 : (only / G == r ? only % G : G);
      const long long lane = (long long)(a0 + r) * B + b0;
      store_runs<G>(rolls + (long long)r * G * S + slot, S, NX, nvalid,
                    Xo + (long long)t * NX * WL + lane, WL, tid, nt, o);
      if (Law::STORES_U)
        store_runs<G>(rolls + (long long)r * G * S + slot + NX, S, NJ,
                      nvalid, Uo + (long long)t * NJ * WL + lane, WL, tid,
                      nt, o);
    }
  };
  for (int r = 0; r < rows; ++r)
    stage_runs<G>(x0 + b0, B, NX, nvalid,
                  rolls + (long long)r * G * S + O::XS, S, tid, nt);
  for (int e = tid; e < rows * G; e += nt) {
    const int r = e / G, gg = e % G;
    T* kk = rolls + e * S;
    kk[O::ALPHA] = r < nrow && gg < nvalid
                       ? law.alpha((long long)(a0 + r) * B + b0 + gg)
                       : T(0);
    kk[O::COST] = T(0);
  }
  stage(0, 0);
  async_commit();
  async_wait<0>();
  block_sync();
  for (int t = 0; t < N; ++t) {
    if (t + 1 < N) {   // its buffer's last reader, step t - 1, is done
      stage(t + 1, (t + 1) & 1);
      async_commit();
    }
    if (t > 0) store(t - 1);
    linesearch_step<T, NJ>(par, H.R, cost, law, H.cost, k,
                           tiles + ((long long)(t & 1) * G + g) * TS, lo, hi,
                           dt, gravity);
    par([&](int ln) {
      T* out = k + O::OUT + (t & 1) * (NX + NJ);
      for (int e = ln; e < OUT; e += W)
        out[e] = e < NX ? k[O::XS + e] : k[O::U + e - NX];
    });
    async_wait<0>();
    block_sync();   // step t done everywhere; knot t + 1's tiles landed
  }
  linesearch_finish<T, NJ>(par, H.R, cost, H.cost, k);
  block_sync();
  store(N - 1);
  if (Cost::SUMS)
    for (int e = tid; e < nrow * G; e += nt) {
      const int r = e / G, gg = e % G;
      if (gg < nvalid && (only < 0 || only == e))
        cost_out[(long long)(a0 + r) * B + b0 + gg] = rolls[e * S + O::COST];
    }
}

// The line search's block plan: G problems a block (ls_g), each of its
// step-size rows a rollout of LANES threads
// (ls_lanes), ROWS rows a block at most: the number that puts the most
// rollouts on an SM (shared memory, threads, registers), then the most
// rows a block (each tile read by more rollouts).
GT_HDI constexpr long long ls_block_bytes(long long head, long long tile_b,
                                          long long roll_b, int g, int rows) {
  return head + 2 * g * tile_b + (long long)g * rows * roll_b;
}

GT_HDI constexpr int ls_rollouts_sm(long long head, long long tile_b,
                                    long long roll_b, int lanes, int g,
                                    int rows, int regs) {
  const long long bytes = ls_block_bytes(head, tile_b, roll_b, g, rows);
  const long long threads = (long long)g * rows * lanes;
  if (bytes > SMEM_LIMIT || threads > MAX_BLOCK_THREADS) return 0;
  const long long warps = (threads + WARP - 1) / WARP;
  const long long warp_regs = (regs * WARP + 255) / 256 * 256;
  // a block's warps share the SM's four quarters of the register file
  if (warps > 4 * (SM_REGS / 4 / warp_regs)) return 0;
  long long b = SM_SMEM / (bytes + SMEM_PER_BLOCK);
  if (2048 / threads < b) b = 2048 / threads;
  if (SM_REGS / (warps * warp_regs) < b) b = SM_REGS / (warps * warp_regs);
  if (b > 32) b = 32;
  return g * rows * (int)b;
}

constexpr int LS_MAX_ROWS = 8;

// {lanes, rows} packed lanes | rows << 16
GT_HDI constexpr int ls_rows(long long head, long long tile_b,
                             long long roll_b, int lanes, int g, int regs) {
  int best = 0, most = 0;
  for (int rows = 1; rows <= LS_MAX_ROWS; ++rows) {
    const int n = ls_rollouts_sm(head, tile_b, roll_b, lanes, g, rows, regs);
    if (n > 0 && n >= most) {
      best = rows;
      most = n;
    }
  }
  return best;
}

// problems a block: 8 (whole sectors in float32; 4 in float64) where one
// row of them fits, else fewer
GT_HDI constexpr int ls_g(long long head, long long tile_b, long long roll_b,
                          int lanes) {
  int g = MAX_KNOTS;
  while (g > 1 && (ls_block_bytes(head, tile_b, roll_b, g, 1) > SMEM_LIMIT ||
                   g * lanes > MAX_BLOCK_THREADS))
    g /= 2;
  return g;
}

// the registers a thread is planned with (ptxas reports 76-92 | 130-172,
// float32 | float64)
template <typename T>
GT_HDI constexpr int ls_regs() { return sizeof(T) == 4 ? 80 : 184; }

// Threads a rollout, by joint count: each library is built for one of the
// zoo's robots, and the width is the one that ran fastest for it on the
// card (compare_kernels.py): the chain of 7 (iiwa) and the legs of 3
// (hyq, 12) at 8, four legs of 2 (gym_ant, 8) at 16, dm_quadruped (16) at
// 32. A step's phases are a tree level each, so a chain leaves most of a
// wide group idle; a narrow group runs 4 rollouts a warp.
template <int NJ>
GT_HDI constexpr int ls_lanes() { return NJ == 8 ? 16 : NJ == 16 ? 32 : 8; }

// knot strides padded as BlockPlan pads them
template <typename T>
GT_HDI constexpr int pad_stride(int n) {
  return n + ((16 / ((int)sizeof(T) / 4) - n % (32 / ((int)sizeof(T) / 4))) +
              32 / ((int)sizeof(T) / 4)) %
                 (32 / ((int)sizeof(T) / 4));
}

// Where one problem's two tiles and one rollout do not fit a block (above
// 52 joints in float64), the tiles go to device memory (TILES_WS): the
// block's two buffers of G tiles, WS bytes, in a workspace that the wrapper
// allocates, a block's buffers for each block in flight, the blocks
// striding over the blocks of the grid; the rollouts stay in shared memory.
template <typename T, int NJ>
struct LSPlan {
  static constexpr int STRIDE = pad_stride<T>(LSRoll<NJ>::SIZE);
  static constexpr int TILE = LSTile<NJ>::SIZE;
  static constexpr long long HEAD = (sizeof(LSHead<T, NJ>) + 15) / 16 * 16;
  static constexpr int LANES = ls_lanes<NJ>();
  static constexpr bool TILES_WS =
      ls_block_bytes(HEAD, (long long)TILE * sizeof(T),
                     (long long)STRIDE * sizeof(T), 1, 1) > SMEM_LIMIT;
  // a tile's bytes in shared memory
  static constexpr long long TILE_B =
      TILES_WS ? 0 : (long long)TILE * sizeof(T);
  static constexpr int G =
      ls_g(HEAD, TILE_B, (long long)STRIDE * sizeof(T), LANES);
  static constexpr int ROWS = ls_rows(HEAD, TILE_B,
                                      (long long)STRIDE * sizeof(T), LANES, G,
                                      ls_regs<T>());
  static constexpr long long WS =
      TILES_WS ? 2LL * G * TILE * (long long)sizeof(T) : 0;
  // rows a block for na step sizes: as even a split as ROWS allows
  static constexpr int rows_for(int na) {
    return (na + (na + ROWS - 1) / ROWS - 1) / ((na + ROWS - 1) / ROWS);
  }
  static constexpr long long bytes(int rows) {
    return HEAD + 2 * G * TILE_B + (long long)G * rows * STRIDE * sizeof(T);
  }
  static constexpr long long BYTES = bytes(ROWS);
};

// The shared bytes of a one-row rollout's block of g problems: the head,
// and a problem's two knots of its law's tile (tile values each; 0 where
// the tiles sit in device memory) and its rollout's state.
template <typename T, int NJ>
GT_HDI constexpr long long roll_bytes(int g, int tile) {
  return (sizeof(LSHead<T, NJ>) + 15) / 16 * 16 +
         (long long)g * (2 * tile + pad_stride<T>(LSRoll<NJ>::SIZE)) *
             sizeof(T);
}

// A one-row rollout's block (the open-loop and the feedback rollout): G
// problems, a rollout each, LANES threads a rollout (whole warps a block),
// its tile the law's (OpenLoop: U_t, NJ values a problem; FoldedStepLaw:
// LSTile, 2 NJ^2 + 4 NJ). Where the block's tiles and rollouts do not fit
// (the feedback rollout above 52 joints in float64), the tiles go to
// device memory as the line search's do (LSPlan: TILES_WS, WS).
template <typename T, int NJ, int LANES_, int G_, class Law = OpenLoop<T, NJ>>
struct RollShape {
  static constexpr int LANES = LANES_, G = G_, ROWS = 1;
  static constexpr int STRIDE = pad_stride<T>(LSRoll<NJ>::SIZE);
  static constexpr int TILE = Law::TILE;
  static constexpr long long HEAD = (sizeof(LSHead<T, NJ>) + 15) / 16 * 16;
  static constexpr bool TILES_WS = roll_bytes<T, NJ>(G, TILE) > SMEM_LIMIT;
  static constexpr long long BYTES = roll_bytes<T, NJ>(G, TILES_WS ? 0 : TILE);
  static constexpr long long WS =
      TILES_WS ? 2LL * G * TILE * (long long)sizeof(T) : 0;
  static_assert(G * LANES % WARP == 0 && G * LANES <= MAX_BLOCK_THREADS,
                "a rollout block is whole warps");
  static_assert(BYTES <= SMEM_LIMIT, "a rollout block fits an SM");
};

// The rollout's plan by joint count: the block shape that ran fastest for
// the zoo's robot of that count at its main shapes on the card
// (compare_kernels.py's block shapes; the table is in PERF.md). They hold
// 4-16 rollouts an SM (B = 512-2048), so a step's latency sets the time,
// not rollouts an SM: the trees (hyq 12, gym_ant 8, dm_quadruped 16 joints)
// run a level's joints in one round of 32 threads; the chain of 7 (iiwa)
// has a joint a level, and 8 threads (4 rollouts a warp) execute a quarter
// of the warp instructions of 32. 4 problems a block (2 at 8 joints),
// halved while the block does not fit (float64: 2 from 39 joints, 1 from
// 60).
template <int NJ>
GT_HDI constexpr int roll_lanes() { return NJ == 2 || NJ == 7 ? 8 : 32; }
template <typename T, int NJ>
GT_HDI constexpr int roll_g() {
  int g = NJ == 8 ? 2 : 4;
  while (g > 1 && roll_bytes<T, NJ>(g, NJ) > SMEM_LIMIT) g /= 2;
  return g;
}

template <typename T, int NJ>
using RollPlan = RollShape<T, NJ, roll_lanes<NJ>(), roll_g<T, NJ>()>;

// The feedback rollout's plan by joint count, chosen as the rollout's
// (compare_kernels.py's block shapes at its main shapes; PERF.md): the
// same step, with K, Xref, Uref and kf staged a knot; the rollout's
// widths, and its problems a block but 8 on the chain of 7 (and
// pendulum2), halved while two knots' tiles and the rollouts do not fit a
// block (28 joints in float64: 2 a block).
template <typename T, int NJ>
GT_HDI constexpr int fb_g() {
  int g = NJ == 2 || NJ == 7 ? 8 : roll_g<T, NJ>();
  while (g > 1 && roll_bytes<T, NJ>(g, LSTile<NJ>::SIZE) > SMEM_LIMIT) g /= 2;
  return g;
}

template <typename T, int NJ>
using FBPlan = RollShape<T, NJ, roll_lanes<NJ>(), fb_g<T, NJ>(),
                         FoldedStepLaw<T, NJ>>;

// aba's plan: the rollout's threads a lane (roll_lanes: 8 on the chains of
// 2 and 7 joints, a warp otherwise), G the largest power of 2 up to 8 that
// fits (its output rows are G consecutive lanes: 32-byte runs at G = 8 in
// float32; 4 knots at 28 joints in float64).
template <typename T, int NJ>
using ABAKnot1 = KnotShape<T, RobotConst<T, NJ>, ABAKnot<NJ>::SIZE,
                           roll_lanes<NJ>(), 1>;
template <typename T, int NJ>
using ABAPlan = KnotShape<
    T, RobotConst<T, NJ>, ABAKnot<NJ>::SIZE, roll_lanes<NJ>(),
    best_knots(ABAKnot1<T, NJ>::HEAD,
               ABAKnot1<T, NJ>::STRIDE * (long long)sizeof(T),
               roll_lanes<NJ>(), ls_regs<T>(), true)>;

}  // namespace gt

#ifndef __CUDACC__
#include <limits>
#include <vector>

namespace gt {

// Host entry points (the tests' g++ build, csrc/opcount.cpp): the block
// code of the kernels with the card's G and rows, one unit at a time over the
// valid units of each block (the block's shared memory filled with NaN
// first, so that a read of state no phase wrote shows), writing only that
// unit's lanes. A number type other than float (csrc/opcount.cpp's
// counting type) takes double's plan (warp.cuh: PlanType).
template <typename T>
void fill_nan(std::vector<T>& v) {
  for (auto& x : v) x = T(std::numeric_limits<double>::quiet_NaN());
}

// the block code of a Riccati sweep (the policy In) with the card's plan
template <typename T, int NJ, int CURV, class In>
void riccati_host(const In& in, const T* Vx0, const T* Vxx0, T* ks, T* Ks,
                  int N, long long B, T reg) {
  using O = typename In::O;
  using P = RicPlan<PlanType<T>, NJ, CURV>;
  constexpr int G = plan_g<P>();
  static_assert(O::BUFS == P::BUFS, "the layout is the plan's");
  std::vector<T> knots((long long)G * O::SIZE);
  for (long long b0 = 0; b0 < B; b0 += G)
    for (int g = 0; g < G && b0 + g < B; ++g) {
      fill_nan(knots);
#ifdef GT_RACE_CHECK
      gt_race_watch(knots.data() + g * O::SIZE, O::SIZE * (long)sizeof(T));
#endif
      riccati_block<T, NJ, G>(HostPar<P::LANES>{}, 0, 1, g, knots.data(),
                              O::SIZE, b0, in, Vx0, Vxx0, ks, Ks, N, B, reg,
                              g);
    }
#ifdef GT_RACE_CHECK
  gt_race_watch(nullptr, 0);
#endif
}

// a sweep on chip (RicChipPlan of PT's dtype; CURV: the input policy In's
// curvature): a problem at a time, the cluster's regions in one buffer
template <typename T, int NJ, int CURV, typename PT = PlanType<T>, class In>
void riccati_chip_host(const In& in, const T* Vx0, const T* Vxx0, T* ks,
                       T* Ks, int N, long long B, T reg, int r = 0,
                       T qd_diag = T(0), T u_diag = T(0)) {
  using P = RicChipPlan<PT, NJ, CURV == RIC_FACTORED>;
  constexpr bool STAT = CURV == RIC_STATIONARY;
  static_assert(P::CL >= 1, "one Riccati problem fits a cluster");
  std::vector<T> buf(P::CL * P::RANK_VALUES);
  std::vector<T> rec(P::O::record(N, STAT));
  T* rg[7];
  P::regions([&](int k) { return buf.data() + k * P::RANK_VALUES; }, rg);
  for (long long b = 0; b < B; ++b) {
    fill_nan(buf);
    fill_nan(rec);
    ric_chip_gathers<typename P::O>(
        in, N, STAT,
        [&](const T* src, long long R, int W, int WP, int G, long long GS,
            long long off, long long XS) {
          gather_rows(src, R, B, W, WP, G, GS, off, XS, rec.data(), 0LL + b);
        });
#ifdef GT_RACE_CHECK
    gt_race_watch(buf.data(), (long)(buf.size() * sizeof(T)));
#endif
    riccati_chip_problem<T, NJ, P, CURV>(
        HostPar<P::LANES>{}, rg, [](int) { return true; }, 0, 1, rec.data(),
        Vx0, Vxx0, ks, Ks, N, B, b, reg, r, qd_diag, u_diag);
  }
#ifdef GT_RACE_CHECK
  gt_race_watch(nullptr, 0);
#endif
}

// riccati_factored as the card runs it in PT's dtype: on chip from
// CHIP_FROM joints, else the shared-memory plan's block code
template <typename T, int NJ, typename PT = PlanType<T>>
void riccati_factored_host(const T* A, const T* Bm, const T* lx, const T* lu,
                           const T* Jw, const T* Vx0, const T* Vxx0, T* ks,
                           T* Ks, int N, long long B, int r, T reg, T qd_diag,
                           T u_diag) {
  if constexpr (ric_on_chip<PT, NJ, RIC_FACTORED>()) {
    const FactoredIn<T, NJ, 1> in{A, Bm, lx, lu, Jw, B, N, r, qd_diag,
                                  u_diag};
    riccati_chip_host<T, NJ, RIC_FACTORED, PT>(in, Vx0, Vxx0, ks, Ks, N, B,
                                               reg, r, qd_diag, u_diag);
  } else {
    constexpr int BUFS = RicPlan<PT, NJ>::BUFS;
    const FactoredIn<T, NJ, BUFS> in{A, Bm, lx, lu, Jw, B, N, r, qd_diag,
                                     u_diag};
    riccati_host<T, NJ, RIC_FACTORED>(in, Vx0, Vxx0, ks, Ks, N, B, reg);
  }
}

template <typename T, int NJ>
void riccati_dense_host(const T* A, const T* Bm, const T* lx, const T* lu,
                        const T* lxx, const T* luu, const T* lux,
                        bool stationary, const T* Vx0, const T* Vxx0, T* ks,
                        T* Ks, int N, long long B, T reg) {
  using PT = PlanType<T>;
  constexpr int SB = RicPlan<PT, NJ, RIC_STATIONARY>::BUFS;
  constexpr int DB = RicPlan<PT, NJ, RIC_DENSE>::BUFS;
  if (stationary) {
    const DenseIn<T, NJ, true, SB> in{A, Bm, lx, lu, lxx, luu, lux, B};
    if constexpr (ric_on_chip<PT, NJ, RIC_STATIONARY>())
      riccati_chip_host<T, NJ, RIC_STATIONARY>(in, Vx0, Vxx0, ks, Ks, N, B,
                                               reg);
    else
      riccati_host<T, NJ, RIC_STATIONARY>(in, Vx0, Vxx0, ks, Ks, N, B, reg);
  } else {
    const DenseIn<T, NJ, false, DB> in{A, Bm, lx, lu, lxx, luu, lux, B};
    if constexpr (ric_on_chip<PT, NJ, RIC_DENSE>())
      riccati_chip_host<T, NJ, RIC_DENSE>(in, Vx0, Vxx0, ks, Ks, N, B, reg);
    else
      riccati_host<T, NJ, RIC_DENSE>(in, Vx0, Vxx0, ks, Ks, N, B, reg);
  }
}

// the block code of the rollouts (the law and the cost) with the card's G
// and `rows` step-size rows a block, one unit at a time
template <typename T, int NJ, class Cost, int G, int LANES, class Law>
void rollouts_host(const Law& law, const T* model, const T* x0, const T* lo,
                   const T* hi, T* Xo, T* Uo, T* cost, int N, long long B,
                   int na, int rows, T dt, T gravity, const T* cbuf,
                   int ncost) {
  using O = LSRoll<NJ>;
  std::vector<LSHead<T, NJ>> H(1);
  H[0].load(model, cbuf, ncost, lo, hi, 0, 1);
  std::vector<T> tiles(2 * G * Law::TILE);
  std::vector<T> rolls((long long)G * rows * O::SIZE);
  for (int a0 = 0; a0 < na; a0 += rows)
    for (long long b0 = 0; b0 < B; b0 += G)
      for (int e = 0; e < rows * G; ++e) {
        if (a0 + e / G >= na || b0 + e % G >= B) continue;
        fill_nan(tiles);
        fill_nan(rolls);
#ifdef GT_RACE_CHECK
        gt_race_watch(rolls.data() + e * O::SIZE, O::SIZE * (long)sizeof(T));
#endif
        linesearch_block<T, NJ, Cost, G>(
            HostPar<LANES>{}, 0, 1, e, H[0], tiles.data(), Law::TILE,
            rolls.data(), O::SIZE, rows, b0, a0, x0, law, Xo, Uo, cost, N, B,
            na, dt, gravity, e);
      }
#ifdef GT_RACE_CHECK
  gt_race_watch(nullptr, 0);
#endif
}

template <typename T, int NJ, class Cost>
void linesearch_host(const T* model, const T* x0, const T* Uref,
                     const T* Xref, const T* kf, const T* K,
                     const T* alpha_rows, const T* lo, const T* hi, T* Xo,
                     T* Uo, T* cost, int N, long long B, int na, T dt,
                     T gravity, const T* cbuf, int ncost) {
  using P = LSPlan<PlanType<T>, NJ>;
  static_assert(P::ROWS >= 1, "one line-search rollout a problem must fit");
  static_assert(P::BYTES <= SMEM_LIMIT, "the block fits an SM");
  const FeedbackLaw<T, NJ> law{Uref, Xref, kf, K, alpha_rows};
  rollouts_host<T, NJ, Cost, P::G, P::LANES>(law, model, x0, lo, hi, Xo, Uo,
                                             cost, N, B, na, P::rows_for(na),
                                             dt, gravity, cbuf, ncost);
}

template <typename T, int NJ>
void rollout_host(const T* model, const T* x0, const T* U, const T* lo,
                  const T* hi, T* X, int N, long long B, T dt, T gravity) {
  using P = RollPlan<PlanType<T>, NJ>;
  const OpenLoop<T, NJ> law{U};
  rollouts_host<T, NJ, NoCost<T, NJ>, P::G, P::LANES>(
      law, model, x0, lo, hi, X, nullptr, nullptr, N, B, 1, 1, dt, gravity,
      nullptr, 0);
}

// aba's block code with the card's G, each block's valid knots in turn
template <typename T, int NJ>
void aba_host(const T* model, const T* q, const T* qd, const T* u, T* qdd,
              long long L, T gravity) {
  using O = ABAKnot<NJ>;
  using P = ABAPlan<PlanType<T>, NJ>;
  static_assert(P::G >= 1, "one aba knot must fit");
  std::vector<RobotConst<T, NJ>> R(1);
  R[0].load_tree(model, 0, 1);
  std::vector<T> k((long long)P::G * O::SIZE);
  for (long long l0 = 0; l0 < L; l0 += P::G) {
    fill_nan(k);
    load_inputs<T, NJ, O::SIZE>(q, qd, u, L, l0, P::G, k.data(), 0, 1);
    for (int g = 0; g < P::G && l0 + g < L; ++g) {
#ifdef GT_RACE_CHECK
      gt_race_watch(k.data() + (long long)g * O::SIZE,
                    O::SIZE * (long)sizeof(T));
#endif
      aba_knot<T, NJ>(HostPar<P::LANES>{}, R[0],
                      k.data() + (long long)g * O::SIZE, gravity);
    }
    store_rows<T, O::SIZE>(k.data() + O::QDD, NJ, qdd, L, l0, P::G, 0, 1);
  }
#ifdef GT_RACE_CHECK
  gt_race_watch(nullptr, 0);
#endif
}

template <typename T, int NJ>
void feedback_rollout_host(const T* model, const T* x0, const T* Uref,
                           const T* Xref, const T* kf, const T* K,
                           const T* lo, const T* hi, T* X, T* U, int N,
                           long long B, T dt, T gravity) {
  using P = FBPlan<PlanType<T>, NJ>;
  const FoldedStepLaw<T, NJ> law{{Uref, Xref, kf, K, nullptr}};
  rollouts_host<T, NJ, NoCost<T, NJ>, P::G, P::LANES>(
      law, model, x0, lo, hi, X, U, nullptr, N, B, 1, 1, dt, gravity,
      nullptr, 0);
}

}  // namespace gt
#endif
