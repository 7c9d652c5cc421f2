// opcount: the floating-point operations of one lane of each kernel, counted
// by running lane code on the host over a counting number type. Built with
// the host C++ compiler (never nvcc) by
// gridcodegenerator_tpu_torch/utils/opcount.py.
//
// Counted: every +, -, * and / on the number type, and each sin, cos,
// sqrt and atan2, one each (a fused multiply-add on the card is two).
// Negation, comparisons, loads, stores and index arithmetic are not
// counted. The lane code's work depends on the robot's topology and the
// shapes (joints, EEs, knots, factor rank), not on the values, so one lane
// counts what every lane of a launch does.
//
// Two counts per kernel:
// * executed: every operation the kernel's lane code does (fd_du, fdsva_so,
//   idsva_so, id_du, rnea, fd, minv, crba, eepos, deepos and d2eepos: every
//   thread of the knot's group, warp.cuh; the Riccati sweeps, the rollouts, open-loop,
//   feedback and line search, and aba: every thread of the problem's,
//   rollout's or knot's group, sweep_warp.cuh);
// * needed: the arithmetic of the function, the bound's numerator. Constants
//   fold: literals and the robot's constants (GRiD generates code per
//   robot) are known, the lane's inputs are not, and an operation whose
//   operands are all known, or that multiplies by a known 0 or +-1, divides
//   by a known +-1, or adds a known 0, costs nothing (the zero blocks of
//   spatial transforms and cross-product matrices). The second-order lanes
//   run with DStored: D1-D4 of each joint formed once and each product
//   D_fam[st] x computed once, as the reference algorithm does
//   (gridcodegenerator_tpu/ops/so.py:idsva_so_analytical), where the
//   kernels form D_st x at every use to save per-thread memory. d2eepos
//   and deepos count the cheaper of their two algorithms: the chain form
//   (dynamics.cuh:ee_hess_lane, ee_jac_lane) and the knot program's twists
//   (warp.cuh:d2eepos_knot, deepos_knot).
#include <cmath>
#include <vector>

namespace opc {

struct C {
  double v;
  bool known;   // a literal or a robot constant, not input data
  static long long n;
  static bool fold;
  C() : v(0), known(true) {}
  C(double x) : v(x), known(true) {}
  static C input(double x) {
    C c(x);
    c.known = false;
    return c;
  }
  explicit operator int() const { return (int)v; }
};
long long C::n = 0;
bool C::fold = false;

inline bool is(C a, double x) { return C::fold && a.known && a.v == x; }

// The result r of an operation on a and b, counted unless it folds.
inline C counted(double r) {
  ++C::n;
  return C::input(r);
}
inline C same(C a, double r) {   // r is +-a: free, a's kind
  C c(r);
  c.known = a.known;
  return c;
}

inline C operator+(C a, C b) {
  const double r = a.v + b.v;
  if (C::fold && a.known && b.known) return C(r);
  if (is(a, 0)) return same(b, r);
  if (is(b, 0)) return same(a, r);
  return counted(r);
}
inline C operator-(C a, C b) {
  const double r = a.v - b.v;
  if (C::fold && a.known && b.known) return C(r);
  if (is(b, 0)) return same(a, r);
  if (is(a, 0)) return same(b, r);
  return counted(r);
}
inline C operator*(C a, C b) {
  const double r = a.v * b.v;
  if (C::fold && a.known && b.known) return C(r);
  if (is(a, 0) || is(b, 0)) return C(0.0 * r);
  if (is(a, 1) || is(a, -1)) return same(b, r);
  if (is(b, 1) || is(b, -1)) return same(a, r);
  return counted(r);
}
inline C operator/(C a, C b) {
  const double r = a.v / b.v;
  if (C::fold && a.known && b.known) return C(r);
  if (is(a, 0)) return C(r);
  if (is(b, 1) || is(b, -1)) return same(a, r);
  return counted(r);
}
inline C operator-(C a) { return same(a, -a.v); }
inline C& operator+=(C& a, C b) { return a = a + b; }
inline C& operator-=(C& a, C b) { return a = a - b; }
inline C& operator*=(C& a, C b) { return a = a * b; }
inline bool operator<(C a, C b) { return a.v < b.v; }
inline bool operator>(C a, C b) { return a.v > b.v; }
inline bool operator<=(C a, C b) { return a.v <= b.v; }
inline bool operator>=(C a, C b) { return a.v >= b.v; }
inline bool operator==(C a, C b) { return a.v == b.v; }
inline bool operator!=(C a, C b) { return a.v != b.v; }
inline C fn(C a, double r) { return C::fold && a.known ? C(r) : counted(r); }
inline C gsin(C a) { return fn(a, std::sin(a.v)); }
inline C gcos(C a) { return fn(a, std::cos(a.v)); }
inline C gsqrt(C a) { return fn(a, std::sqrt(a.v)); }
inline C gatan2(C y, C x) {
  const double r = std::atan2(y.v, x.v);
  return C::fold && y.known && x.known ? C(r) : counted(r);
}

}  // namespace opc

#include "fd_du.cu"
#include "rollout.cu"
#include "linesearch.cu"
#include "riccati.cu"
#include "rnea.cu"
#include "id_du.cu"
#include "aba.cu"
#include "minv.cu"
#include "fd.cu"
#include "crba.cu"
#include "eepos.cu"
#include "deepos.cu"
#include "idsva_so.cu"
#include "fdsva_so.cu"
#include "d2eepos.cu"
#include "feedback_rollout.cu"

using opc::C;
using namespace gt;

namespace {

// The reference algorithm's D products: D1-D4 of every joint formed once as
// 6x6 matrices (gridcodegenerator_tpu/ops/so.py:_sva_so_stages), and each
// product D_fam[st] x, x the stage vector `vec` of joint k, computed at its
// first use and reused (so.py:idsva_so_analytical, its memoized Dv).
template <typename T, int NJ>
struct DStored {
  const SOStages<T, NJ>& s;
  std::vector<T> D;            // (4, NJ, 36)
  std::vector<T> psid_sd;      // (NJ, 6)
  mutable std::vector<T> memo;   // (4, NJ, 4, NJ, 6)
  mutable std::vector<char> have;

  explicit DStored(const SOStages<T, NJ>& st)
      : s(st), D(4 * NJ * 36), psid_sd(NJ * 6), memo(16 * NJ * NJ * 6),
        have(16 * NJ * NJ, 0) {
    for (int i = 0; i < NJ; ++i) {
      T cS[36], cP[36], fS[36], fP[36], A[36], B[36], C3[36], E[36], F[36];
      crm_mat(s.S[i], cS);
      crm_mat(s.psid[i], cP);
      for (int r = 0; r < 6; ++r)
        for (int c = 0; c < 6; ++c) {   // crf(x) = -crm(x)^T
          fS[r * 6 + c] = -cS[c * 6 + r];
          fP[r * 6 + c] = -cP[c * 6 + r];
        }
      T* D1 = &D[(0 * NJ + i) * 36];
      T* D2 = &D[(1 * NJ + i) * 36];
      T* D3 = &D[(2 * NJ + i) * 36];
      T* D4 = &D[(3 * NJ + i) * 36];
      mm6(fS, s.IC[i], A);                  // D1 = crf(S) IC - IC crm(S)
      mm6(s.IC[i], cS, B);
      for (int k = 0; k < 36; ++k) D1[k] = A[k] - B[k];
      mm6(fP, s.IC[i], A);                  // D2 = crf(psid) IC
      icrf_mat(s.ICpsid[i], B);             //   + icrf(IC psid)
      mm6(s.IC[i], cP, C3);                 //   - IC crm(psid)
      mm6(fS, s.BC[i], E);                  //   + crf(S) BC
      mm6(s.BC[i], cS, F);                  //   - BC crm(S)
      for (int k = 0; k < 36; ++k)
        D2[k] = A[k] + B[k] - C3[k] + E[k] - F[k];
      icrf_mat(s.T1[i], D4);                // D4 = icrf(IC S)
      for (int k = 0; k < 36; ++k) D3[k] = D1[k] + D4[k];
      for (int k = 0; k < 6; ++k)
        psid_sd[i * 6 + k] = s.psid[i][k] + s.Sd[i][k];
    }
  }

  void operator()(int fam, int st, int vec, int k, T* w) const {
    const int id = (((fam - 1) * NJ + st) * 4 + vec) * NJ + k;
    T* m = &memo[id * 6];
    if (!have[id]) {
      T x[6];
      if (vec == kPsidSd) {
        for (int i = 0; i < 6; ++i) x[i] = psid_sd[k * 6 + i];
      } else {
        so_vec(s, vec, k, x);
      }
      Xv(&D[((fam - 1) * NJ + st) * 36], x, m);
      have[id] = 1;
    }
    for (int i = 0; i < 6; ++i) w[i] = m[i];
  }
};

// fdsva_so's composed route after fd_du and idsva_so, one lane: the
// contractions of ops/so.py:fdsva_compose_lanes, in place on T (4, NJ, NJ,
// NJ; so.cuh's layout, lane stride 1), each a sum of NJ products; dfdu
// (NJ, 2 NJ) and Mi (NJ, NJ) row-major.
template <typename T, int NJ>
void fdsva_compose_lane(T* t, const T* dfdu, const T* Mi) {
  constexpr int N2 = NJ * NJ, N3 = NJ * N2;
  auto at = [&](int c, int i, int j, int k) -> T& {
    return t[c * N3 + i * N2 + j * NJ + k];
  };
  // (dM D)[i, a, b] = sum_m dM[i, m, a] D[m, b], dM = slice 3
  auto dm = [&](int col0, int stride, std::vector<T>& o) {
    for (int i = 0; i < NJ; ++i)
      for (int a = 0; a < NJ; ++a)
        for (int b = 0; b < NJ; ++b) {
          T acc = at(3, i, 0, a) * (col0 < 0 ? Mi[b] : dfdu[col0 + b]);
          for (int m = 1; m < NJ; ++m)
            acc += at(3, i, m, a) *
                   (col0 < 0 ? Mi[m * NJ + b] : dfdu[m * stride + col0 + b]);
          o[i * N2 + a * NJ + b] = acc;
        }
  };
  std::vector<T> cq(N3), cd(N3), ct(N3), inner(4 * N3);
  dm(0, 2 * NJ, cq);
  dm(NJ, 2 * NJ, cd);
  dm(-1, 0, ct);
  for (int i = 0; i < NJ; ++i)
    for (int j = 0; j < NJ; ++j)
      for (int k = 0; k < NJ; ++k) {
        const int e = i * N2 + j * NJ + k, f = i * N2 + k * NJ + j;
        inner[e] = at(0, i, j, k) + cq[e] + cq[f];
        inner[N3 + e] = at(1, i, j, k);
        inner[2 * N3 + e] = at(2, i, j, k) + cd[f];
        inner[3 * N3 + e] = ct[f];
      }
  for (int c = 0; c < 4; ++c)
    for (int i = 0; i < NJ; ++i)
      for (int j = 0; j < N2; ++j) {
        T acc = Mi[i * NJ] * inner[c * N3 + j];
        for (int m = 1; m < NJ; ++m)
          acc += Mi[i * NJ + m] * inner[c * N3 + m * N2 + j];
        t[c * N3 + i * N2 + j] = -acc;
      }
}

std::vector<C> constants(const double* src, long long n) {
  std::vector<C> out(n);
  for (long long i = 0; i < n; ++i) out[i] = C(src[i]);
  return out;
}

std::vector<C> inputs(long long n) {
  return std::vector<C>(n, C::input(0.0));
}

// Kernel ids, in the order of utils/opcount.py:KERNELS.
enum {
  RNEA, ID_DU, ABA, MINV, FD, CRBA, EEPOS, DEEPOS, FD_DU, ROLLOUT,
  LINESEARCH, RICCATI_FACTORED, RICCATI, IDSVA_SO, FDSVA_SO, D2EEPOS,
  FEEDBACK_ROLLOUT
};

// One lane (one problem for the sweeps) of kernel `kernel`; `flag` is the
// line search's cost kind or riccati's stationary flag. `needed` selects
// the count (see the top). The lane's inputs are zeros, or the first
// 3 NJ values of `in` as (q, qd, x) if given; its first `nout` outputs go
// to `out`.
template <int NJ>
long long count(int kernel, const double* model, const double* ee, int ne,
                const double* cost, int ncost, int N, int r, int flag,
                bool needed, const double* in, double* out, int nout) {
  constexpr int NX = 2 * NJ;
  C::fold = needed;
  std::vector<C> m = constants(model, Layout<NJ>::SIZE);
  std::vector<C> e = constants(ee, (long long)ne * EERow<NJ>::SIZE);
  std::vector<C> cb(ncost);
  for (int i = 0; i < ncost; ++i) cb[i] = C::input(cost[i]);
  const Robot<C, NJ> R(m.data());
  const long long big = (long long)(N > 0 ? N : 1) * NX * NX * 4 +
                        4LL * NJ * NJ * NJ + 6LL * ne * NJ * NJ + 64;
  std::vector<C> a = inputs(big), b = inputs(big), c = inputs(big),
                 d = inputs(big), x = inputs(big), y = inputs(big),
                 z = inputs(big), w = inputs(big);
  if (in)
    for (int i = 0; i < NJ; ++i) {
      a[i] = C::input(in[i]);
      b[i] = C::input(in[NJ + i]);
      c[i] = C::input(in[2 * NJ + i]);
    }
  const C g(-9.81), dt(0.01), reg(1e-6);
  C::n = 0;
  switch (kernel) {
    case RNEA:   // executed: the knot's threads, every phase
      if (needed)
        rnea_lane<C, NJ>(R, a.data(), b.data(), c.data(), g, x.data());
      else
        rnea_host<C, NJ>(m.data(), a.data(), b.data(), c.data(), x.data(), 1,
                         g);
      break;
    case ID_DU:   // executed: the knot's threads, every phase
      if (needed)
        id_du_lane<C, NJ>(R, a.data(), b.data(), c.data(), g, x.data());
      else
        id_du_host<C, NJ>(m.data(), a.data(), b.data(), c.data(), x.data(), 1,
                          g);
      break;
    case ABA:   // executed: the knot's threads, every phase
      if (needed)
        aba<C, NJ>(R, a.data(), b.data(), c.data(), g, x.data());
      else
        aba_host<C, NJ>(m.data(), a.data(), b.data(), c.data(), x.data(), 1,
                        g);
      break;
    case MINV:   // executed: the knot's threads, every phase (dense)
      if (needed)
        minv_lane<C, NJ>(R, a.data(), true, x.data());
      else
        minv_host<C, NJ>(m.data(), a.data(), x.data(), 1, true);
      break;
    case FD:   // executed: the knot's threads, every phase
      if (needed)
        fd_lane<C, NJ>(R, a.data(), b.data(), c.data(), g, x.data());
      else
        fd_host<C, NJ>(m.data(), a.data(), b.data(), c.data(), x.data(), 1, g);
      break;
    case CRBA:   // executed: the knot's threads, every phase
      if (needed)
        crba_lane<C, NJ>(R, a.data(), x.data());
      else
        crba_host<C, NJ>(m.data(), a.data(), x.data(), 1);
      break;
    case EEPOS:   // executed: the lane's group, every phase, every EE
      if (needed)
        ee_pose_lane<C, NJ>(R, e.data(), ne, a.data(), x.data(), 1);
      else
        eepos_host<C, NJ>(m.data(), e.data(), ne, a.data(), x.data(), 1);
      break;
    case DEEPOS:   // executed: the lane's group, every phase, every EE;
                   // needed: the fewer of the chain form's and the knot
                   // program's twist form's
      deepos_host<C, NJ>(m.data(), e.data(), ne, a.data(), x.data(), 1);
      if (needed) {
        const long long twist = C::n;
        C::n = 0;
        ee_jac_lane<C, NJ>(R, e.data(), ne, a.data(), x.data(), 1);
        if (twist < C::n) C::n = twist;
      }
      break;
    case D2EEPOS:   // executed: the lane's group, every phase, and its
                    // share of the block's store; needed: the fewer of the
                    // chain form's and the knot program's twist form's
      d2eepos_host<C, NJ>(m.data(), e.data(), ne, a.data(), x.data(), 1);
      if (needed) {
        const long long twist = C::n;
        C::n = 0;
        ee_hess_lane<C, NJ>(R, e.data(), ne, a.data(), x.data(), 1);
        if (twist < C::n) C::n = twist;
      }
      break;
    case FD_DU:   // the warp's 32 threads, every phase
      fd_du_host<C, NJ>(m.data(), a.data(), b.data(), c.data(), x.data(),
                        y.data(), z.data(), 1, g);
      break;
    case ROLLOUT:   // executed: the rollout's group, every phase
      if (needed)
        rollout_lane<C, NJ>(R, a.data(), b.data(), nullptr, nullptr,
                            x.data(), N, 1, 0, dt, g);
      else
        rollout_host<C, NJ>(m.data(), a.data(), b.data(), nullptr, nullptr,
                            x.data(), N, 1, dt, g);
      break;
    case FEEDBACK_ROLLOUT:   // executed: the rollout's group, every phase
      if (needed)
        feedback_rollout_lane<C, NJ>(R, a.data(), b.data(), c.data(),
                                     d.data(), y.data(), nullptr, nullptr,
                                     x.data(), w.data(), N, 1, 0, dt, g);
      else
        feedback_rollout_host<C, NJ>(m.data(), a.data(), b.data(), c.data(),
                                     d.data(), y.data(), nullptr, nullptr,
                                     x.data(), w.data(), N, 1, dt, g);
      break;
    case LINESEARCH:   // executed: the rollout's group, every phase
      if (needed && flag == 0) {
        const EECost<C, NJ> ec{cb.data()};
        linesearch_lane<C, NJ>(R, a.data(), b.data(), c.data(), d.data(),
                               y.data(), z.data(), nullptr, nullptr, x.data(),
                               w.data(), x.data() + big - 1, N, 1, 1, 0, dt,
                               g, ec);
      } else if (needed && flag == 1) {
        const QuadCostK<C, NJ> qc{cb.data()};
        linesearch_lane<C, NJ>(R, a.data(), b.data(), c.data(), d.data(),
                               y.data(), z.data(), nullptr, nullptr, x.data(),
                               w.data(), x.data() + big - 1, N, 1, 1, 0, dt,
                               g, qc);
      } else if (needed) {
        const NoCostK<C, NJ> nc{nullptr};
        linesearch_lane<C, NJ>(R, a.data(), b.data(), c.data(), d.data(),
                               y.data(), z.data(), nullptr, nullptr, x.data(),
                               w.data(), nullptr, N, 1, 1, 0, dt, g, nc);
      } else if (flag == 0) {
        linesearch_host<C, NJ, EECostW<C, NJ>>(
            m.data(), a.data(), b.data(), c.data(), d.data(), y.data(),
            z.data(), nullptr, nullptr, x.data(), w.data(),
            x.data() + big - 1, N, 1, 1, dt, g, cb.data(), ncost);
      } else if (flag == 1) {
        linesearch_host<C, NJ, QuadCostW<C, NJ>>(
            m.data(), a.data(), b.data(), c.data(), d.data(), y.data(),
            z.data(), nullptr, nullptr, x.data(), w.data(),
            x.data() + big - 1, N, 1, 1, dt, g, cb.data(), ncost);
      } else {
        linesearch_host<C, NJ, NoCost<C, NJ>>(
            m.data(), a.data(), b.data(), c.data(), d.data(), y.data(),
            z.data(), nullptr, nullptr, x.data(), w.data(), nullptr, N, 1, 1,
            dt, g, nullptr, 0);
      }
      break;
    case RICCATI_FACTORED:   // executed: the problem's warp, every phase
      if (needed)
        riccati_lane<C, NJ>(a.data(), b.data(), c.data(), d.data(), y.data(),
                            z.data(), w.data(), x.data(), x.data() + big / 2,
                            N, 1, r, 0, reg, C(1e-2), C(1e-4));
      else
        riccati_factored_host<C, NJ>(a.data(), b.data(), c.data(), d.data(),
                                     y.data(), z.data(), w.data(), x.data(),
                                     x.data() + big / 2, N, 1, r, reg,
                                     C(1e-2), C(1e-4));
      break;
    case RICCATI:   // executed: the problem's warp, every phase
      if (needed)
        riccati_dense_lane<C, NJ>(a.data(), b.data(), c.data(), d.data(),
                                  y.data(), z.data(), w.data(), flag != 0,
                                  c.data(), d.data(), x.data(),
                                  x.data() + big / 2, N, 1, 0, reg);
      else
        riccati_dense_host<C, NJ>(a.data(), b.data(), c.data(), d.data(),
                                  y.data(), z.data(), w.data(), flag != 0,
                                  c.data(), d.data(), x.data(),
                                  x.data() + big / 2, N, 1, reg);
      break;
    case IDSVA_SO:   // executed: the knot's threads, every phase, in
                     // every band on the banded route (flag: the float32
                     // plan's route, warp.cuh:idso_route)
      if (needed)
        idsva_so_lane<C, NJ, DStored>(R, a.data(), b.data(), c.data(), g,
                                      x.data(), 1);
      else if (flag)
        idsva_so_plan_host<C, NJ, DFormed, float>(m.data(), a.data(),
                                                  b.data(), c.data(),
                                                  x.data(), 1, g);
      else
        idsva_so_plan_host<C, NJ, DFormed, double>(m.data(), a.data(),
                                                   b.data(), c.data(),
                                                   x.data(), 1, g);
      break;
    case FDSVA_SO:   // executed: the fused kernel where its knot fits a
                     // block in the plan's dtype (flag: float32), else the
                     // composed route: fd_du, idsva_so at its qdd, then the
                     // contractions
      if (needed) {
        fdsva_so_host<C, NJ, DStored>(m.data(), a.data(), b.data(), c.data(),
                                      x.data(), 1, g);
      } else if (flag ? SOPlan<float, NJ>::G >= 1
                      : SOPlan<double, NJ>::G >= 1) {
        fdsva_so_host<C, NJ>(m.data(), a.data(), b.data(), c.data(),
                             x.data(), 1, g);
      } else {
        fd_du_host<C, NJ>(m.data(), a.data(), b.data(), c.data(), y.data(),
                          z.data(), d.data(), 1, g);
        if (flag)
          idsva_so_plan_host<C, NJ, DFormed, float>(
              m.data(), a.data(), b.data(), z.data(), w.data(), 1, g);
        else
          idsva_so_plan_host<C, NJ, DFormed, double>(
              m.data(), a.data(), b.data(), z.data(), w.data(), 1, g);
        fdsva_compose_lane<C, NJ>(w.data(), y.data(), d.data());
        for (int i = 0; i < 4 * NJ * NJ * NJ; ++i) x[i] = w[i];
      }
      break;
    default: return -1;
  }
  const long long ops = C::n;
  for (int i = 0; i < nout && i < big; ++i) out[i] = x[i].v;
  return ops;
}

}  // namespace

extern "C" long long gridtorch_opcount(int kernel, int nj, const double* model,
                                       const double* ee, int ne,
                                       const double* cost, int ncost, int N,
                                       int r, int flag, int needed,
                                       const double* in, double* out,
                                       int nout) {
#define GT_COUNT(NJ)                                                       \
  count<NJ>(kernel, model, ee, ne, cost, ncost, N, r, flag, needed != 0, \
            in, out, nout)
  switch (nj) {   // the zoo's counts, a 20-joint chain and atlas with
                  // grippers and with two hands (tests/torch_big_robots.py:
                  // 34 and 52 joints)
    case 2: return GT_COUNT(2);
    case 4: return GT_COUNT(4);
    case 5: return GT_COUNT(5);
    case 7: return GT_COUNT(7);
    case 8: return GT_COUNT(8);
    case 12: return GT_COUNT(12);
    case 16: return GT_COUNT(16);
    case 17: return GT_COUNT(17);
    case 20: return GT_COUNT(20);
    case 28: return GT_COUNT(28);
    case 34: return GT_COUNT(34);
    case 52: return GT_COUNT(52);
  }
#undef GT_COUNT
  return -1;
}
