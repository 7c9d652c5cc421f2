// Per-lane second-order dynamics: IDSVA-SO.
//
// The lane code of csrc/idsva_so.cu, whose stages (SOBody) and pair
// corrections csrc/warp.cuh's fdsva_so program shares, following
// gridcodegenerator_tpu_torch/ops/so.py step for step (the analytical,
// loop-unrolled form of gridcodegenerator_tpu/ops/so.py):
//
// * so_stages: world-frame S, v, a, psi-dot, psi-ddot, S-dot per joint, the
//   composite IC, body-Coriolis BC and force f accumulated along parent[],
//   and the T1-T4 vectors, in per-thread memory. The D1-D4 operators are
//   never stored: D_st w is formed where it is used, from S, psi-dot, IC
//   and BC of joint st (four 6x6 matrices a joint would otherwise cost).
//   The stages ask for the products D_fam[st] x (x a stage vector of joint
//   k) through a policy, DFormed in the kernels; csrc/opcount.cpp counts
//   the reference algorithm's arithmetic with one that stores D1-D4 and
//   each product.
// * idsva_so_lane: the nine outer-product stages and the p1-p6 corrections
//   over (joint j, ancestor a of j or j itself, subtree member st of j),
//   ancestors and subtrees read at run time from the packed subtree mask,
//   in the plain version's order: ancestors ascending then j, subtree
//   ascending. Several entries are written more than once (accumulated, or
//   overwritten by a later stage), so the statement order is the
//   algorithm's, and the output array itself is the accumulator:
//   read-modify-write in device memory. Every entry is zeroed first, since
//   entries no stage writes are zero and the output comes uninitialised.
//
// Output layout, lane-major: entry (c, i, j, k) of lane l at
// (((c NJ + i) NJ + j) NJ + k) L + l; the cross and dM tensors store the
// algorithm's entry (i, a, b) at (i, b, a).
#pragma once

#include "dynamics.cuh"

namespace gt {

template <typename T>
GT_HDI T dot6(const T* a, const T* b) {
  T s = a[0] * b[0];
  for (int k = 1; k < 6; ++k) s += a[k] * b[k];
  return s;
}

template <typename T>
GT_HD void mm6(const T* A, const T* B, T* O) {   // O = A B
  for (int r = 0; r < 6; ++r)
    for (int c = 0; c < 6; ++c) {
      T s = A[r * 6] * B[c];
      for (int k = 1; k < 6; ++k) s += A[r * 6 + k] * B[k * 6 + c];
      O[r * 6 + c] = s;
    }
}

// crm(v) as a matrix: rows [W, 0; V, W], W = skew(v[0:3]), V = skew(v[3:6])
template <typename T>
GT_HD void crm_mat(const T* v, T* M) {
  const T z = T(0);
  const T W[9] = {z, -v[2], v[1], v[2], z, -v[0], -v[1], v[0], z};
  const T V[9] = {z, -v[5], v[4], v[5], z, -v[3], -v[4], v[3], z};
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      M[r * 6 + c] = W[r * 3 + c];
      M[r * 6 + 3 + c] = z;
      M[(r + 3) * 6 + c] = V[r * 3 + c];
      M[(r + 3) * 6 + 3 + c] = W[r * 3 + c];
    }
}

// icrf(f), the matrix with icrf(f) w = crf(w) f: rows [-N, -H; -H, 0]
template <typename T>
GT_HD void icrf_mat(const T* f, T* M) {
  const T z = T(0);
  const T N[9] = {z, -f[2], f[1], f[2], z, -f[0], -f[1], f[0], z};
  const T H[9] = {z, -f[5], f[4], f[5], z, -f[3], -f[4], f[3], z};
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      M[r * 6 + c] = -N[r * 3 + c];
      M[r * 6 + 3 + c] = -H[r * 3 + c];
      M[(r + 3) * 6 + c] = -H[r * 3 + c];
      M[(r + 3) * 6 + 3 + c] = z;
    }
}

// Entry (r, c) of the inverse of the motion transform X = [[E, 0], [F, G]]:
// [[E^T, 0], [F^T, G^T]].
template <typename T>
GT_HDI T xinv_motion(const T* X, int r, int c) {
  if (r < 3 && c >= 3) return T(0);
  if (r >= 3 && c < 3) return X[(3 + c) * 6 + (r - 3)];
  return X[c * 6 + r];
}

template <typename T, int NJ>
struct SOStages {
  T S[NJ][6], psid[NJ][6], psidd[NJ][6], Sd[NJ][6];
  T IC[NJ][36], BC[NJ][36];
  T T1[NJ][6], T2[NJ][6], T3[NJ][6], T4[NJ][6], ICpsid[NJ][6];
};

template <typename T, int NJ>
GT_HD void so_stages(const Robot<T, NJ>& R, const T* q, const T* qd,
                     const T* qdd, T gravity, SOStages<T, NJ>& s) {
  const T g[6] = {0, 0, 0, 0, 0, -gravity};
  T v[NJ][6], a[NJ][6], f[NJ][6];
  {
    T Xup[NJ][36];
    for (int i = 0; i < NJ; ++i) {
      const int p = R.parent[i];
      T Xi[36];
      joint_xmat(R.Xtree(i), R.jtype[i], R.sind[i], q[i], Xi);
      if (p == -1) {
        for (int k = 0; k < 36; ++k) Xup[i][k] = Xi[k];
      } else {
        mm6(Xi, Xup[p], Xup[i]);
      }
      for (int r = 0; r < 6; ++r) s.S[i][r] = xinv_motion(Xup[i], r, R.sind[i]);
      for (int k = 0; k < 36; ++k) s.IC[i][k] = T(0);
      XTMX_add(Xup[i], R.Imat(i), s.IC[i]);
    }
  }
  for (int i = 0; i < NJ; ++i) {
    const int p = R.parent[i];
    const T* S = s.S[i];
    T vJ[6], aJ[6], t[6];
    for (int k = 0; k < 6; ++k) {
      vJ[k] = S[k] * qd[i];
      aJ[k] = S[k] * qdd[i];
    }
    if (p == -1) {
      for (int k = 0; k < 6; ++k) {
        v[i][k] = vJ[k];
        a[i][k] = g[k] + aJ[k];
        s.psid[i][k] = T(0);
      }
      cross_mv(g, S, s.psidd[i]);
    } else {
      cross_mv(v[p], vJ, t);
      for (int k = 0; k < 6; ++k) {
        v[i][k] = v[p][k] + vJ[k];
        a[i][k] = a[p][k] + (aJ[k] + t[k]);
      }
      cross_mv(v[p], S, s.psid[i]);
      T t2[6];
      cross_mv(a[p], S, t);
      cross_mv(v[p], s.psid[i], t2);
      for (int k = 0; k < 6; ++k) s.psidd[i][k] = t[k] + t2[k];
    }
    cross_mv(v[i], S, s.Sd[i]);
  }
  // BC = crf(v) IC + icrf(IC v) - IC crm(v); f = IC a + crf(v) IC v
  for (int i = 0; i < NJ; ++i) {
    T ICv[6], Cm[36], Cf[36], A1[36], A2[36], A3[36];
    Xv(s.IC[i], v[i], ICv);
    crm_mat(v[i], Cm);
    for (int r = 0; r < 6; ++r)
      for (int c = 0; c < 6; ++c) Cf[r * 6 + c] = -Cm[c * 6 + r];
    mm6(Cf, s.IC[i], A1);
    icrf_mat(ICv, A2);
    mm6(s.IC[i], Cm, A3);
    for (int k = 0; k < 36; ++k) s.BC[i][k] = A1[k] + A2[k] - A3[k];
    T Ia[6], c[6];
    Xv(s.IC[i], a[i], Ia);
    Xv(Cf, ICv, c);
    for (int k = 0; k < 6; ++k) f[i][k] = Ia[k] + c[k];
  }
  for (int i = NJ - 1; i >= 0; --i) {
    const int p = R.parent[i];
    if (p == -1) continue;
    for (int k = 0; k < 36; ++k) {
      s.IC[p][k] += s.IC[i][k];
      s.BC[p][k] += s.BC[i][k];
    }
    for (int k = 0; k < 6; ++k) f[p][k] += f[i][k];
  }
  for (int i = 0; i < NJ; ++i) {
    const T* S = s.S[i];
    T t1[6], t2[6], t3[6], ps[6];
    Xv(s.IC[i], S, s.T1[i]);
    Xv(s.IC[i], s.psid[i], s.ICpsid[i]);
    XTv(s.BC[i], S, t1);
    for (int k = 0; k < 6; ++k) s.T2[i][k] = -t1[k];
    Xv(s.BC[i], s.psid[i], t1);
    Xv(s.IC[i], s.psidd[i], t2);
    cross_fv(S, f[i], t3);   // icrf(f) S = crf(S) f
    for (int k = 0; k < 6; ++k) s.T3[i][k] = t1[k] + t2[k] + t3[k];
    for (int k = 0; k < 6; ++k) ps[k] = s.psid[i][k] + s.Sd[i][k];
    Xv(s.BC[i], S, t1);
    Xv(s.IC[i], ps, t2);
    for (int k = 0; k < 6; ++k) s.T4[i][k] = t1[k] + t2[k];
  }
}

// D1_st w = crf(S) IC w - IC crm(S) w
template <typename T, int NJ>
GT_HD void D1v(const SOStages<T, NJ>& s, int st, const T* w, T* o) {
  T t[6], c1[6], u[6], c2[6];
  Xv(s.IC[st], w, t);
  cross_fv(s.S[st], t, c1);
  cross_mv(s.S[st], w, u);
  Xv(s.IC[st], u, c2);
  for (int k = 0; k < 6; ++k) o[k] = c1[k] - c2[k];
}

// D2_st w = crf(psid) IC w + icrf(IC psid) w - IC crm(psid) w
//           + crf(S) BC w - BC crm(S) w
template <typename T, int NJ>
GT_HD void D2v(const SOStages<T, NJ>& s, int st, const T* w, T* o) {
  T t[6], c1[6], c2[6], u[6], c3[6], c4[6], c5[6];
  Xv(s.IC[st], w, t);
  cross_fv(s.psid[st], t, c1);
  cross_fv(w, s.ICpsid[st], c2);
  cross_mv(s.psid[st], w, u);
  Xv(s.IC[st], u, c3);
  Xv(s.BC[st], w, t);
  cross_fv(s.S[st], t, c4);
  cross_mv(s.S[st], w, u);
  Xv(s.BC[st], u, c5);
  for (int k = 0; k < 6; ++k) o[k] = c1[k] + c2[k] - c3[k] + c4[k] - c5[k];
}

// D4_st w = icrf(IC S) w = crf(w) IC S;  D3_st w = D1_st w + D4_st w
template <typename T, int NJ>
GT_HD void D4v(const SOStages<T, NJ>& s, int st, const T* w, T* o) {
  cross_fv(w, s.T1[st], o);
}

template <typename T, int NJ>
GT_HD void D3v(const SOStages<T, NJ>& s, int st, const T* w, T* o) {
  T d1[6], d4[6];
  D1v(s, st, w, d1);
  D4v(s, st, w, d4);
  for (int k = 0; k < 6; ++k) o[k] = d1[k] + d4[k];
}

// The vectors the stages apply D1-D4 to: S, psi-dot, psi-ddot and
// psi-dot + S-dot of a joint.
enum SOVec { kS = 0, kPsid = 1, kPsidd = 2, kPsidSd = 3 };

// Vector `vec` of joint k into x: a row of the stages, or psi-dot + S-dot.
// (Copied, not pointed at: a pointer that may address either the stages or
// a local array would take generic loads on the card.)
template <typename T, int NJ>
GT_HDI void so_vec(const SOStages<T, NJ>& s, int vec, int k, T* x) {
  for (int i = 0; i < 6; ++i)
    x[i] = vec == kS       ? s.S[k][i]
           : vec == kPsid  ? s.psid[k][i]
           : vec == kPsidd ? s.psidd[k][i]
                           : s.psid[k][i] + s.Sd[k][i];
}

// w = D_fam[st] x, x the vector `vec` of joint k, formed where it is used.
template <typename T, int NJ>
struct DFormed {
  const SOStages<T, NJ>& s;
  GT_HD void operator()(int fam, int st, int vec, int k, T* w) const {
    T x[6];
    so_vec(s, vec, k, x);
    if (fam == 1) D1v(s, st, x, w);
    else if (fam == 2) D2v(s, st, x, w);
    else if (fam == 3) D3v(s, st, x, w);
    else D4v(s, st, x, w);
  }
};

#ifdef GT_RACE_CHECK
void gt_race_touch(const void* p);
#endif

template <typename T, int NJ>
struct SOOut {
  T* o;          // the lane's entry (0, 0, 0, 0)
  long long L;   // lane stride
  GT_HDI T& at(int c, int i, int j, int k) const {
    T& r = o[((((long long)c * NJ + i) * NJ + j) * NJ + k) * L];
#ifdef GT_RACE_CHECK
    gt_race_touch(&r);   // host build: which thread of a phase touched it
#endif
    return r;
  }
  GT_HDI T& dq2(int i, int j, int k) const { return at(0, i, j, k); }
  GT_HDI T& dqd2(int i, int j, int k) const { return at(1, i, j, k); }
  GT_HDI T& dvdq(int i, int a, int b) const { return at(2, i, b, a); }
  GT_HDI T& dM(int i, int a, int b) const { return at(3, i, b, a); }
};

// One band of the (4, NJ, NJ, NJ) tensor: its rows (c, i), r = c NJ + i in
// [r0, r0 + ROWS), lane stride 1, the band's row r0 at `tile`. Every
// read-modify-write of SOBody and so_pair_corrections reads the entry it
// writes, of the same component c and first index i, so the bands do not
// read each other's rows: an entry outside the band goes to `sink`, a
// value of the thread's own, which nothing reads back but that statement.
template <typename T, int NJ, int ROWS>
struct SOBand {
  T* tile;
  T* sink;
  int r0;
  GT_HDI T& at(int c, int i, int j, int k) const {
    const int r = c * NJ + i - r0;
    T& x = (unsigned)r < (unsigned)ROWS ? tile[(r * NJ + j) * NJ + k] : *sink;
#ifdef GT_RACE_CHECK
    gt_race_touch(&x);
#endif
    return x;
  }
  GT_HDI T& dq2(int i, int j, int k) const { return at(0, i, j, k); }
  GT_HDI T& dqd2(int i, int j, int k) const { return at(1, i, j, k); }
  GT_HDI T& dvdq(int i, int a, int b) const { return at(2, i, b, a); }
  GT_HDI T& dM(int i, int a, int b) const { return at(3, i, b, a); }
};

// The (j, a, st) triples: j, then a over the ancestors of j ascending and j
// itself (subtree(a) holds j), then st over subtree(j) ascending.
template <typename T, int NJ, class F>
GT_HD void for_triples(const Robot<T, NJ>& R, F fn) {
  for (int j = 0; j < NJ; ++j)
    for (int a = 0; a <= j; ++a) {
      if (R.subtree(a, j) == T(0)) continue;
      for (int st = j; st < NJ; ++st)
        if (R.subtree(j, st) != T(0)) fn(j, a, st);
    }
}

// Out: SOOut (the whole tensor) or SOBand (one band of its rows)
template <typename T, int NJ, class DOp, class Out = SOOut<T, NJ>>
struct SOBody {
  const SOStages<T, NJ>& s;
  const Out& o;
  const DOp& D;
  int stage;

  GT_HD void operator()(int j, int a, int st) const {
    const T* Sj = s.S[j];
    const T* Sa = s.S[a];
    T w[6];
    switch (stage) {
      case 1: {   // t1 = outer(S_j, psid_a)
        D(3, st, kPsid, a, w);
        const T val3 = dot6(Sj, w);
        o.dvdq(st, a, j) = -val3;
        if (j != st) {
          D(2, st, kPsid, a, w);
          const T val2 = dot6(Sj, w);
          o.dq2(j, st, a) = val2;
          o.dq2(j, a, st) = val2;
          o.dvdq(j, a, st) = val3;
        }
        break;
      }
      case 2: {   // t2 = outer(S_j, S_a)
        D(3, st, kS, a, w);
        const T v3 = dot6(Sj, w);
        if (a < j) {
          o.dqd2(st, j, a) = -v3;
          o.dqd2(st, a, j) = -v3;
        } else {
          D(1, st, kS, j, w);
          o.dqd2(st, j, j) = -dot6(Sj, w);
        }
        if (j != st) {
          o.dqd2(j, st, a) = v3;
          o.dqd2(j, a, st) = v3;
          D(2, st, kS, a, w);
          o.dvdq(j, st, a) = dot6(Sj, w);
        }
        break;
      }
      case 3: {   // t3 = outer(psid_j, psid_a)
        D(3, st, kPsid, a, w);
        const T v3 = dot6(s.psid[j], w);
        o.dq2(st, a, j) = -v3;
        if (a < j) o.dq2(st, j, a) = -v3;
        break;
      }
      case 4: {   // t4 = outer(S_j, psidd_a)
        if (j != st) {
          D(1, st, kPsidd, a, w);
          const T v1 = dot6(Sj, w);
          o.dq2(j, st, a) = o.dq2(j, st, a) + v1;
          o.dq2(j, a, st) = o.dq2(j, a, st) + v1;
        }
        break;
      }
      case 5: {   // t5 = outer(S_j, (Sd + psid)_a)
        if (j != st) {
          D(1, st, kPsidSd, a, w);
          o.dvdq(j, st, a) = o.dvdq(j, st, a) + dot6(Sj, w);
        }
        break;
      }
      case 6: {   // t6 = outer(S_a, psid_j)
        if (a < j) {
          D(3, st, kPsid, j, w);
          const T v3 = dot6(Sa, w);
          o.dvdq(st, j, a) = -v3;
          D(2, st, kPsid, j, w);
          o.dq2(a, j, st) = dot6(Sa, w);
          o.dvdq(a, j, st) = v3;
        }
        break;
      }
      case 7: {   // t7 = outer(S_a, psidd_j)
        if (a < j) {
          D(1, st, kPsidd, j, w);
          o.dq2(a, j, st) = o.dq2(a, j, st) + dot6(Sa, w);
        }
        break;
      }
      case 8: {   // t8 = outer(S_a, S_j)
        if (a < j) {
          D(4, st, kS, j, w);
          const T v4 = dot6(Sa, w);
          o.dM(a, j, st) = v4;
          o.dM(st, j, a) = v4;
          if (st != j) {
            D(3, st, kS, j, w);
            const T v3 = dot6(Sa, w);
            o.dqd2(a, j, st) = v3;
            o.dqd2(a, st, j) = v3;
            D(2, st, kS, j, w);
            o.dvdq(a, st, j) = dot6(Sa, w);
          }
        }
        if (j != st) {
          D(1, st, kS, j, w);
          const T v1 = dot6(Sa, w);
          o.dM(a, st, j) = v1;
          o.dM(j, st, a) = v1;
        }
        break;
      }
      case 9: {   // t9 = outer(S_a, (Sd + psid)_j)
        if (a < j && st != j) {
          D(1, st, kPsidSd, j, w);
          o.dvdq(a, st, j) = o.dvdq(a, st, j) + dot6(Sa, w);
          o.dq2(a, st, j) = o.dq2(a, j, st);
        }
        break;
      }
    }
  }
};

// The p1..p6 corrections of the (j, a) pair (a an ancestor of j or j
// itself), over st in subtree(j) ascending.
template <typename T, int NJ, class Rb, class Out>
GT_HD void so_pair_corrections(const Rb& R, const SOStages<T, NJ>& s,
                               const Out& o, int j, int a) {
  const T* Sj = s.S[j];
  const T* Sa = s.S[a];
  T p1[6], p2[6], p3[6], p4[6], p5[6], ps[6], t[6];
  cross_mv(s.psid[a], Sj, p1);
  cross_mv(s.psidd[a], Sj, p2);
  cross_mv(Sa, Sj, p3);
  for (int k = 0; k < 6; ++k) ps[k] = s.psid[a][k] + s.Sd[a][k];
  cross_mv(ps, Sj, p4);
  cross_mv(s.psid[j], Sa, t);
  for (int k = 0; k < 6; ++k) p4[k] = p4[k] - T(2) * t[k];
  cross_mv(Sj, Sa, p5);
  for (int st = j; st < NJ; ++st) {
    if (R.subtree(j, st) == T(0)) continue;
    const T c12 = -dot6(p1, s.T2[st]) + dot6(p2, s.T1[st]);
    o.dq2(st, a, j) = o.dq2(st, a, j) + c12;
    if (a < j) {
      o.dq2(st, j, a) = o.dq2(st, j, a) + c12;
      o.dvdq(st, j, a) = o.dvdq(st, j, a) - dot6(p3, s.T2[st]) +
                         dot6(p4, s.T1[st]);
      const T c5 = dot6(p5, s.T3[st]);
      o.dq2(a, j, st) = o.dq2(a, j, st) - c5;
      if (st != j) o.dq2(a, st, j) = o.dq2(a, st, j) - c5;
      o.dvdq(a, j, st) = o.dvdq(a, j, st) - dot6(p5, s.T4[st]);
    }
  }
  if (a < j) {
    // p6 = crm(S_a)^T T1_j + (crf(S_j) IC_j)^T S_a
    //    = -crf(S_a) T1_j + IC_j^T (-crm(S_j) S_a)
    T p6[6], u[6], c[6];
    cross_fv(Sa, s.T1[j], c);
    cross_mv(Sj, Sa, u);
    for (int k = 0; k < 6; ++k) u[k] = -u[k];
    XTv(s.IC[j], u, t);
    for (int k = 0; k < 6; ++k) p6[k] = -c[k] + t[k];
    o.dqd2(a, j, j) = dot6(p6, Sj);
  }
}

// IDSVA-SO of one lane into `o` (the lane's entry 0, lane stride L).
template <typename T, int NJ, template <typename, int> class DOp = DFormed>
GT_HD void idsva_so_lane(const Robot<T, NJ>& R, const T* q, const T* qd,
                         const T* qdd, T gravity, T* out, long long L) {
  constexpr int N3 = NJ * NJ * NJ;
  for (int e = 0; e < 4 * N3; ++e) out[(long long)e * L] = T(0);
  SOStages<T, NJ> s;
  so_stages(R, q, qd, qdd, gravity, s);
  const SOOut<T, NJ> o{out, L};
  const DOp<T, NJ> D{s};
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int stage = 1; stage <= 9; ++stage)
    for_triples(R, SOBody<T, NJ, DOp<T, NJ>>{s, o, D, stage});
  for (int j = 0; j < NJ; ++j)
    for (int a = 0; a <= j; ++a)
      if (R.subtree(a, j) != T(0)) so_pair_corrections(R, s, o, j, a);
}

}  // namespace gt
