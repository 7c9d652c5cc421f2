// Per-lane rigid-body dynamics for the port's CUDA kernels.
//
// Every kernel of this library but the thread-group ones (csrc/warp.cuh:
// fd_du, fdsva_so, idsva_so, id_du, rnea, fd, minv, crba, eepos and
// d2eepos; csrc/sweep_warp.cuh: the Riccati sweeps, the rollouts and aba)
// runs one thread per problem lane (deepos); the
// functions here are that thread's algebra (and the thread-group kernels'
// serial reference), written for one lane in scalar
// code: spatial algebra, joint transforms, RNEA, the analytical ID gradient,
// Carpentier's direct Minv, forward dynamics, ABA, CRBA, end-effector pose
// and its Jacobian, and a pivot-free Gauss-Jordan inverse. They follow the
// plain PyTorch ops of the package (gridcodegenerator_tpu_torch/ops/*.py)
// step for step.
//
// Templates: T is float or double, NJ the joint count (fixed base, 1-dof
// joints, ids topologically ordered: parent < child, so ascending ids are a
// forward sweep and descending ids a backward one). Matrices are row-major.
// The functions are __host__ __device__, so a host compiler can also build
// them.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define GT_HD __host__ __device__
#define GT_HDI __host__ __device__ __forceinline__
#else
#define GT_HD inline
#define GT_HDI inline
#endif

namespace gt {

constexpr int kF32 = 0;
constexpr int kF64 = 1;

// Packed robot constants, one buffer of T (ops/cuda/build.py:model_buffer).
template <int NJ>
struct Layout {
  static constexpr int XTREE = 0;                   // (NJ, 6, 6)
  static constexpr int IMAT = XTREE + 36 * NJ;      // (NJ, 6, 6)
  static constexpr int DAMP = IMAT + 36 * NJ;       // (NJ)
  static constexpr int TTREE = DAMP + NJ;           // (NJ, 4, 4)
  static constexpr int TFIX = TTREE + 16 * NJ;      // (4, 4) EE fixed frame
  static constexpr int PARENT = TFIX + 16;          // (NJ) -1 = base
  static constexpr int SIND = PARENT + NJ;          // (NJ) axis 0..5
  static constexpr int JTYPE = SIND + NJ;           // (NJ) 0 rev, 1 prism
  static constexpr int EECHAIN = JTYPE + NJ;        // (NJ) 1 = on EE chain
  static constexpr int SUBTREE = EECHAIN + NJ;      // (NJ, NJ) subtree mask
  static constexpr int SIZE = SUBTREE + NJ * NJ;
};

// Packed end-effector rows, one buffer of T (ops/cuda/build.py:ee_buffer):
// per EE, its fixed frame Tfixed (4, 4; identity without one), then its
// chain mask (NJ; 1 = joint on the EE's chain).
template <int NJ>
struct EERow {
  static constexpr int TFIX = 0;
  static constexpr int CHAIN = 16;
  static constexpr int SIZE = CHAIN + NJ;
};

GT_HDI float gsin(float x) { return sinf(x); }
GT_HDI double gsin(double x) { return sin(x); }
GT_HDI float gcos(float x) { return cosf(x); }
GT_HDI double gcos(double x) { return cos(x); }
GT_HDI float gsqrt(float x) { return sqrtf(x); }
GT_HDI double gsqrt(double x) { return sqrt(x); }
GT_HDI float gatan2(float y, float x) { return atan2f(y, x); }
GT_HDI double gatan2(double y, double x) { return atan2(y, x); }

// Lane `lane` of a lane-major (K, L) array, to and from K values.
template <typename T, int K>
GT_HDI void lane_load(const T* src, long long L, long long lane, T* dst) {
  for (int k = 0; k < K; ++k) dst[k] = src[k * L + lane];
}

template <typename T, int K>
GT_HDI void lane_store(const T* src, long long L, long long lane, T* dst) {
  for (int k = 0; k < K; ++k) dst[k * L + lane] = src[k];
}

template <typename T, int NJ>
struct Robot {
  using L = Layout<NJ>;
  const T* c;
  int parent[NJ];
  int sind[NJ];
  int jtype[NJ];

  GT_HD explicit Robot(const T* buf) : c(buf) {
    for (int i = 0; i < NJ; ++i) {
      parent[i] = (int)c[L::PARENT + i];
      sind[i] = (int)c[L::SIND + i];
      jtype[i] = (int)c[L::JTYPE + i];
    }
  }
  GT_HDI const T* Xtree(int i) const { return c + L::XTREE + 36 * i; }
  GT_HDI const T* Imat(int i) const { return c + L::IMAT + 36 * i; }
  GT_HDI T damping(int i) const { return c[L::DAMP + i]; }
  GT_HDI const T* Ttree(int i) const { return c + L::TTREE + 16 * i; }
  GT_HDI const T* Tfixed() const { return c + L::TFIX; }
  GT_HDI bool in_ee_chain(int i) const { return c[L::EECHAIN + i] != T(0); }
  GT_HDI T subtree(int i, int col) const { return c[L::SUBTREE + i * NJ + col]; }
};

// ---------------------------------------------------------------------------
// spatial algebra on 6-vectors [angular; linear]; outputs never alias inputs
// ---------------------------------------------------------------------------

template <typename T>
GT_HDI void cross_mv(const T* a, const T* b, T* o) {   // crm(a) b
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
  o[3] = a[4] * b[2] - a[5] * b[1] + a[1] * b[5] - a[2] * b[4];
  o[4] = a[5] * b[0] - a[3] * b[2] + a[2] * b[3] - a[0] * b[5];
  o[5] = a[3] * b[1] - a[4] * b[0] + a[0] * b[4] - a[1] * b[3];
}

template <typename T>
GT_HDI void cross_fv(const T* a, const T* b, T* o) {   // crf(a) b
  o[0] = a[1] * b[2] - a[2] * b[1] + a[4] * b[5] - a[5] * b[4];
  o[1] = a[2] * b[0] - a[0] * b[2] + a[5] * b[3] - a[3] * b[5];
  o[2] = a[0] * b[1] - a[1] * b[0] + a[3] * b[4] - a[4] * b[3];
  o[3] = a[1] * b[5] - a[2] * b[4];
  o[4] = a[2] * b[3] - a[0] * b[5];
  o[5] = a[0] * b[4] - a[1] * b[3];
}

template <typename T>
GT_HDI void mxS(int s, const T* v, T* o) {   // crm(v) e_s
  T e[6] = {0, 0, 0, 0, 0, 0};
  e[s] = T(1);
  cross_mv(v, e, o);
}

template <typename T>
GT_HDI void crfS(int s, const T* f, T* o) {   // crf(e_s) f
  T e[6] = {0, 0, 0, 0, 0, 0};
  e[s] = T(1);
  cross_fv(e, f, o);
}

template <typename T>
GT_HDI void Xv(const T* X, const T* v, T* o) {   // X v
  for (int i = 0; i < 6; ++i) {
    T acc = X[i * 6] * v[0];
    for (int j = 1; j < 6; ++j) acc += X[i * 6 + j] * v[j];
    o[i] = acc;
  }
}

template <typename T>
GT_HDI void XTv(const T* X, const T* v, T* o) {   // X^T v
  for (int i = 0; i < 6; ++i) {
    T acc = X[i] * v[0];
    for (int j = 1; j < 6; ++j) acc += X[j * 6 + i] * v[j];
    o[i] = acc;
  }
}

template <typename T>
GT_HDI void XTMX_add(const T* X, const T* M, T* out) {   // out += X^T M X
  T tmp[36];
  for (int r = 0; r < 6; ++r)
    for (int c = 0; c < 6; ++c) {
      T acc = X[r] * M[c];
      for (int k = 1; k < 6; ++k) acc += X[k * 6 + r] * M[k * 6 + c];
      tmp[r * 6 + c] = acc;
    }
  for (int r = 0; r < 6; ++r)
    for (int c = 0; c < 6; ++c) {
      T acc = tmp[r * 6] * X[c];
      for (int k = 1; k < 6; ++k) acc += tmp[r * 6 + k] * X[k * 6 + c];
      out[r * 6 + c] += acc;
    }
}

// ---------------------------------------------------------------------------
// joint transforms X_i(q_i) = X_joint(q_i) X_tree
// ---------------------------------------------------------------------------

template <typename T>
GT_HD void joint_xmat(const T* XT, int jtype, int sind, T qi, T* X) {
  T E[9];
  if (jtype == 0) {   // revolute: E = R_axis(q)^T on both 3x3 blocks
    const T c = gcos(qi), s = gsin(qi);
    const int ax = sind % 3;
    const T o = T(1), z = T(0);
    if (ax == 0) {
      const T e[9] = {o, z, z, z, c, s, z, -s, c};
      for (int k = 0; k < 9; ++k) E[k] = e[k];
    } else if (ax == 1) {
      const T e[9] = {c, z, -s, z, o, z, s, z, c};
      for (int k = 0; k < 9; ++k) E[k] = e[k];
    } else {
      const T e[9] = {c, s, z, -s, c, z, z, z, o};
      for (int k = 0; k < 9; ++k) E[k] = e[k];
    }
    for (int r = 0; r < 3; ++r)
      for (int col = 0; col < 6; ++col) {
        X[r * 6 + col] = E[r * 3] * XT[col] + E[r * 3 + 1] * XT[6 + col] +
                         E[r * 3 + 2] * XT[12 + col];
        X[(r + 3) * 6 + col] = E[r * 3] * XT[18 + col] +
                               E[r * 3 + 1] * XT[24 + col] +
                               E[r * 3 + 2] * XT[30 + col];
      }
  } else {   // prismatic: X = [[I, 0], [-skew(q e_k), I]] X_tree
    const int k = sind - 3;
    const T z = T(0);
    if (k == 0) {
      const T e[9] = {z, z, z, z, z, -qi, z, qi, z};
      for (int m = 0; m < 9; ++m) E[m] = e[m];
    } else if (k == 1) {
      const T e[9] = {z, z, qi, z, z, z, -qi, z, z};
      for (int m = 0; m < 9; ++m) E[m] = e[m];
    } else {
      const T e[9] = {z, -qi, z, qi, z, z, z, z, z};
      for (int m = 0; m < 9; ++m) E[m] = e[m];
    }
    for (int r = 0; r < 3; ++r)
      for (int col = 0; col < 6; ++col) {
        X[r * 6 + col] = XT[r * 6 + col];
        X[(r + 3) * 6 + col] =
            XT[(r + 3) * 6 + col] -
            (E[r * 3] * XT[col] + E[r * 3 + 1] * XT[6 + col] +
             E[r * 3 + 2] * XT[12 + col]);
      }
  }
}

template <typename T, int NJ>
GT_HD void all_xmats(const Robot<T, NJ>& R, const T* q, T (*X)[36]) {
  for (int i = 0; i < NJ; ++i)
    joint_xmat(R.Xtree(i), R.jtype[i], R.sind[i], q[i], X[i]);
}

// ---------------------------------------------------------------------------
// RNEA
// ---------------------------------------------------------------------------

// Forward pass: v, a and body forces f per joint; qdd may be null.
template <typename T, int NJ>
GT_HD void rnea_fpass(const Robot<T, NJ>& R, const T (*X)[36], const T* qd,
                      const T* qdd, T gravity, T (*v)[6], T (*a)[6],
                      T (*f)[6]) {
  const T g[6] = {0, 0, 0, 0, 0, -gravity};
  for (int i = 0; i < NJ; ++i) {
    const int p = R.parent[i], s = R.sind[i];
    T vJ[6] = {0, 0, 0, 0, 0, 0};
    vJ[s] = qd[i];
    if (p == -1) {
      for (int k = 0; k < 6; ++k) v[i][k] = vJ[k];
      Xv(X[i], g, a[i]);
    } else {
      T t[6], c[6];
      Xv(X[i], v[p], t);
      for (int k = 0; k < 6; ++k) v[i][k] = t[k] + vJ[k];
      Xv(X[i], a[p], t);
      cross_mv(v[i], vJ, c);
      for (int k = 0; k < 6; ++k) a[i][k] = t[k] + c[k];
    }
    if (qdd) a[i][s] += qdd[i];
  }
  for (int i = 0; i < NJ; ++i) {
    T Ia[6], Iv[6], c[6];
    Xv(R.Imat(i), a[i], Ia);
    Xv(R.Imat(i), v[i], Iv);
    cross_fv(v[i], Iv, c);
    for (int k = 0; k < 6; ++k) f[i][k] = Ia[k] + c[k];
  }
}

// Backward pass: accumulates f into parents in place, writes c (NJ).
template <typename T, int NJ>
GT_HD void rnea_bpass(const Robot<T, NJ>& R, const T (*X)[36], const T* qd,
                      T (*f)[6], T* c) {
  for (int i = NJ - 1; i >= 0; --i) {
    const int p = R.parent[i];
    if (p != -1) {
      T t[6];
      XTv(X[i], f[i], t);
      for (int k = 0; k < 6; ++k) f[p][k] += t[k];
    }
  }
  for (int i = 0; i < NJ; ++i) c[i] = f[i][R.sind[i]] + R.damping(i) * qd[i];
}

// c = RNEA(q, qd[, qdd]) (NJ) from the joint transforms; qdd may be null.
template <typename T, int NJ>
GT_HD void rnea_from_x(const Robot<T, NJ>& R, const T (*X)[36], const T* qd,
                       const T* qdd, T gravity, T* c) {
  T v[NJ][6], a[NJ][6], f[NJ][6];
  rnea_fpass(R, X, qd, qdd, gravity, v, a, f);
  rnea_bpass(R, X, qd, f, c);
}

template <typename T, int NJ>
GT_HD void rnea_lane(const Robot<T, NJ>& R, const T* q, const T* qd,
                     const T* qdd, T gravity, T* c) {
  T X[NJ][36];
  all_xmats(R, q, X);
  rnea_from_x(R, X, qd, qdd, gravity, c);
}

// ---------------------------------------------------------------------------
// analytical ID gradient dc/d[q, qd]
// ---------------------------------------------------------------------------

// Column `col` of dc/d[q, qd] (col < NJ: dq_col, else dqd_{col-NJ}): one
// forward-mode pass, the column-at-a-time form of
// gridcodegenerator_tpu_torch/ops/id_grad.py:id_grad_inner, so a lane keeps
// 6-vectors per joint live instead of (6, NJ) column blocks. `f` must be the
// ACCUMULATED force of rnea_bpass (the crfS term reads it).
template <typename T, int NJ>
GT_HD void id_grad_column_pass(const Robot<T, NJ>& R, const T (*X)[36],
                               const T* qd, const T (*v)[6],
                               const T (*a)[6], const T (*f)[6],
                               const T (*Iv)[6], T gravity, int col,
                               T* dc) {
  const bool isq = col < NJ;
  const int j = isq ? col : col - NJ;
  const T g[6] = {0, 0, 0, 0, 0, -gravity};
  T dv[NJ][6], da[NJ][6], df[NJ][6];
  for (int i = 0; i < NJ; ++i) {
    const int p = R.parent[i], s = R.sind[i];
    T t[6], m[6];
    // dv_i = X dv_p + [i == j] (crm(X v_p) S | S)
    if (p == -1) {
      for (int k = 0; k < 6; ++k) dv[i][k] = T(0);
    } else {
      Xv(X[i], dv[p], dv[i]);
    }
    if (i == j) {
      if (isq) {
        if (p != -1) {
          Xv(X[i], v[p], t);
          mxS(s, t, m);
          for (int k = 0; k < 6; ++k) dv[i][k] += m[k];
        }
      } else {
        dv[i][s] += T(1);
      }
    }
    // da_i = crm(dv_i) S qd_i + [i == j] (crm(X a_p) S | crm(v_i) S) + X da_p
    mxS(s, dv[i], m);
    for (int k = 0; k < 6; ++k) da[i][k] = m[k] * qd[i];
    if (i == j) {
      if (isq) {
        Xv(X[i], p == -1 ? g : a[p], t);
        mxS(s, t, m);
      } else {
        mxS(s, v[i], m);
      }
      for (int k = 0; k < 6; ++k) da[i][k] += m[k];
    }
    if (p != -1) {
      Xv(X[i], da[p], t);
      for (int k = 0; k < 6; ++k) da[i][k] += t[k];
    }
    // df_i = crf(dv_i) I v_i + I da_i + crf(v_i) I dv_i
    T t1[6], t2[6], t3[6];
    cross_fv(dv[i], Iv[i], t1);
    Xv(R.Imat(i), da[i], t2);
    Xv(R.Imat(i), dv[i], t);
    cross_fv(v[i], t, t3);
    for (int k = 0; k < 6; ++k) df[i][k] = t1[k] + t2[k] + t3[k];
  }
  for (int i = NJ - 1; i >= 0; --i) {
    const int p = R.parent[i];
    if (p == -1) continue;
    T t[6];
    XTv(X[i], df[i], t);
    for (int k = 0; k < 6; ++k) df[p][k] += t[k];
    if (isq && i == j) {   // d(X^T)/dq f = X^T crf(S) f
      T m[6];
      crfS(R.sind[i], f[i], m);
      XTv(X[i], m, t);
      for (int k = 0; k < 6; ++k) df[p][k] += t[k];
    }
  }
  for (int i = 0; i < NJ; ++i)
    dc[i] = df[i][R.sind[i]] + ((!isq && i == j) ? R.damping(i) : T(0));
}

// The columns of dc/d[q, qd] at (q, qd, qdd), from the joint transforms:
// RNEA at qdd, whose backward pass accumulates f into the parents in place,
// then one column pass per gradient column on the accumulated f, handing
// each column dc (NJ) to sink(col, dc).
template <typename T, int NJ, class Sink>
GT_HD void id_du_columns(const Robot<T, NJ>& R, const T (*X)[36],
                         const T* qd, const T* qdd, T gravity, Sink sink) {
  T v[NJ][6], a[NJ][6], f[NJ][6], c[NJ], Iv[NJ][6];
  rnea_fpass(R, X, qd, qdd, gravity, v, a, f);
  rnea_bpass(R, X, qd, f, c);
  for (int i = 0; i < NJ; ++i) Xv(R.Imat(i), v[i], Iv[i]);
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int col = 0; col < 2 * NJ; ++col) {
    T dc[NJ];
    id_grad_column_pass(R, X, qd, v, a, f, Iv, gravity, col, dc);
    sink(col, dc);
  }
}

// Sink of id_du_columns that stores dc_du (NJ, 2 NJ), row-major.
template <typename T, int NJ>
struct StoreColumns {
  T* dcdu;
  GT_HDI void operator()(int col, const T* dc) const {
    for (int r = 0; r < NJ; ++r) dcdu[r * 2 * NJ + col] = dc[r];
  }
};

template <typename T, int NJ>
GT_HD void id_du_lane(const Robot<T, NJ>& R, const T* q, const T* qd,
                      const T* qdd, T gravity, T* dcdu) {
  T X[NJ][36];
  all_xmats(R, q, X);
  id_du_columns(R, X, qd, qdd, gravity, StoreColumns<T, NJ>{dcdu});
}

// ---------------------------------------------------------------------------
// Carpentier's direct Minv (NJ, NJ): the upper factor, or dense symmetric
// ---------------------------------------------------------------------------

// Writes M[r][c] for r <= c and exact zeros below the diagonal.
template <typename T, int NJ>
GT_HD void minv_upper(const Robot<T, NJ>& R, const T (*X)[36], T* Mi) {
  T IA[NJ][36];
  T F[NJ][6][NJ];
  T U[NJ][6];
  T Dinv[NJ];
  T M[NJ][NJ];
  for (int i = 0; i < NJ; ++i) {
    for (int k = 0; k < 36; ++k) IA[i][k] = R.Imat(i)[k];
    for (int r = 0; r < 6; ++r)
      for (int col = 0; col < NJ; ++col) F[i][r][col] = T(0);
    for (int col = 0; col < NJ; ++col) M[i][col] = T(0);
  }
  // backward pass (descending ids)
  for (int i = NJ - 1; i >= 0; --i) {
    const int p = R.parent[i], s = R.sind[i];
    for (int r = 0; r < 6; ++r) U[i][r] = IA[i][r * 6 + s];
    const T di = T(1) / U[i][s];
    Dinv[i] = di;
    for (int col = 0; col < NJ; ++col)
      M[i][col] = -di * F[i][s][col] * R.subtree(i, col);
    M[i][i] += di;
    if (p != -1) {
      for (int r = 0; r < 6; ++r)
        for (int col = 0; col < NJ; ++col)
          F[i][r][col] += U[i][r] * M[i][col] * R.subtree(i, col);
      for (int col = 0; col < NJ; ++col) {
        T fc[6], t[6];
        for (int r = 0; r < 6; ++r) fc[r] = F[i][r][col];
        XTv(X[i], fc, t);
        for (int r = 0; r < 6; ++r) F[p][r][col] += t[r];
      }
      T Ia[36];
      for (int r = 0; r < 6; ++r)
        for (int k = 0; k < 6; ++k)
          Ia[r * 6 + k] = IA[i][r * 6 + k] - (U[i][r] * di) * U[i][k];
      XTMX_add(X[i], Ia, IA[p]);
    }
  }
  // forward pass (ascending ids), columns col >= i only
  for (int i = 0; i < NJ; ++i) {
    const int p = R.parent[i], s = R.sind[i];
    T UX[6];
    if (p != -1) {
      XTv(X[i], U[i], UX);
      for (int col = i; col < NJ; ++col) {
        T contr = UX[0] * F[p][0][col];
        for (int j = 1; j < 6; ++j) contr += UX[j] * F[p][j][col];
        M[i][col] += -Dinv[i] * contr;
      }
    }
    for (int col = i; col < NJ; ++col) {
      T fn[6] = {0, 0, 0, 0, 0, 0};
      if (p != -1) {
        T fp[6];
        for (int r = 0; r < 6; ++r) fp[r] = F[p][r][col];
        Xv(X[i], fp, fn);
      }
      fn[s] += M[i][col];
      for (int r = 0; r < 6; ++r) F[i][r][col] = fn[r];
    }
  }
  for (int r = 0; r < NJ; ++r)
    for (int col = 0; col < NJ; ++col)
      Mi[r * NJ + col] = r <= col ? M[r][col] : T(0);
}

// The upper factor mirrored below the diagonal.
template <typename T, int NJ>
GT_HD void minv_dense(const Robot<T, NJ>& R, const T (*X)[36], T* Mi) {
  minv_upper(R, X, Mi);
  for (int r = 1; r < NJ; ++r)
    for (int col = 0; col < r; ++col) Mi[r * NJ + col] = Mi[col * NJ + r];
}

template <typename T, int NJ>
GT_HD void minv_lane(const Robot<T, NJ>& R, const T* q, bool dense, T* Mi) {
  T X[NJ][36];
  all_xmats(R, q, X);
  if (dense) {
    minv_dense(R, X, Mi);
  } else {
    minv_upper(R, X, Mi);
  }
}

// ---------------------------------------------------------------------------
// forward dynamics via the Minv route: qdd = Minv (u - c) (NJ)
// ---------------------------------------------------------------------------

// From the joint transforms: Minv dense, the bias RNEA (no qdd), then the
// matvec; also hands back Minv (NJ, NJ).
template <typename T, int NJ>
GT_HD void fd_from_x(const Robot<T, NJ>& R, const T (*X)[36], const T* qd,
                     const T* u, T gravity, T* qdd, T* Mi) {
  minv_dense(R, X, Mi);
  T c[NJ];
  rnea_from_x(R, X, qd, (const T*)nullptr, gravity, c);
  for (int i = 0; i < NJ; ++i) {
    T acc = Mi[i * NJ] * (u[0] - c[0]);
    for (int k = 1; k < NJ; ++k) acc += Mi[i * NJ + k] * (u[k] - c[k]);
    qdd[i] = acc;
  }
}

template <typename T, int NJ>
GT_HD void fd_lane(const Robot<T, NJ>& R, const T* q, const T* qd,
                   const T* u, T gravity, T* qdd) {
  T X[NJ][36], Mi[NJ * NJ];
  all_xmats(R, q, X);
  fd_from_x(R, X, qd, u, gravity, qdd, Mi);
}

// ---------------------------------------------------------------------------
// CRBA mass matrix M (NJ, NJ), both triangles
// ---------------------------------------------------------------------------

// Composite inertias accumulate into the parents (descending ids); column
// i's composite force is carried up the ancestor chain (parent[], not i-1:
// the tree may branch) and projected on each ancestor's axis.
template <typename T, int NJ>
GT_HD void crba_lane(const Robot<T, NJ>& R, const T* q, T* M) {
  T X[NJ][36], Ic[NJ][36];
  all_xmats(R, q, X);
  for (int i = 0; i < NJ; ++i)
    for (int k = 0; k < 36; ++k) Ic[i][k] = R.Imat(i)[k];
  for (int i = NJ - 1; i >= 0; --i)
    if (R.parent[i] != -1) XTMX_add(X[i], Ic[i], Ic[R.parent[i]]);
  for (int k = 0; k < NJ * NJ; ++k) M[k] = T(0);
  for (int i = 0; i < NJ; ++i) {
    const int s = R.sind[i];
    T fh[6], t[6];
    for (int r = 0; r < 6; ++r) fh[r] = Ic[i][r * 6 + s];
    M[i * NJ + i] = fh[s];
    for (int j = i; R.parent[j] != -1;) {
      XTv(X[j], fh, t);
      j = R.parent[j];
      for (int r = 0; r < 6; ++r) fh[r] = t[r];
      M[j * NJ + i] = fh[R.sind[j]];
      M[i * NJ + j] = fh[R.sind[j]];
    }
  }
}

// ---------------------------------------------------------------------------
// ABA forward dynamics: qdd (NJ)
// ---------------------------------------------------------------------------

template <typename T, int NJ>
GT_HD void aba(const Robot<T, NJ>& R, const T* q, const T* qd, const T* u,
               T gravity, T* qdd) {
  T X[NJ][36];
  all_xmats(R, q, X);
  T v[NJ][6], cb[NJ][6], pA[NJ][6], IA[NJ][36];
  for (int i = 0; i < NJ; ++i) {
    const int p = R.parent[i], s = R.sind[i];
    T vJ[6] = {0, 0, 0, 0, 0, 0};
    vJ[s] = qd[i];
    if (p == -1) {
      for (int k = 0; k < 6; ++k) v[i][k] = vJ[k];
    } else {
      T t[6];
      Xv(X[i], v[p], t);
      for (int k = 0; k < 6; ++k) v[i][k] = t[k] + vJ[k];
    }
    cross_mv(v[i], vJ, cb[i]);
    T Iv[6];
    Xv(R.Imat(i), v[i], Iv);
    cross_fv(v[i], Iv, pA[i]);
    for (int k = 0; k < 36; ++k) IA[i][k] = R.Imat(i)[k];
  }
  T U[NJ][6], Dinv[NJ], uu[NJ];
  for (int i = NJ - 1; i >= 0; --i) {
    const int p = R.parent[i], s = R.sind[i];
    for (int r = 0; r < 6; ++r) U[i][r] = IA[i][r * 6 + s];
    const T di = T(1) / U[i][s];
    Dinv[i] = di;
    uu[i] = (u[i] - R.damping(i) * qd[i]) - pA[i][s];
    if (p != -1) {
      T Ia[36];
      for (int r = 0; r < 6; ++r)
        for (int k = 0; k < 6; ++k)
          Ia[r * 6 + k] = IA[i][r * 6 + k] - (U[i][r] * di) * U[i][k];
      T t[6], pa[6];
      Xv(Ia, cb[i], t);
      for (int k = 0; k < 6; ++k) pa[k] = pA[i][k] + t[k] + U[i][k] * (di * uu[i]);
      XTMX_add(X[i], Ia, IA[p]);
      XTv(X[i], pa, t);
      for (int k = 0; k < 6; ++k) pA[p][k] += t[k];
    }
  }
  const T g[6] = {0, 0, 0, 0, 0, -gravity};
  T a[NJ][6];
  for (int i = 0; i < NJ; ++i) {
    const int p = R.parent[i], s = R.sind[i];
    T ap[6];
    Xv(X[i], p == -1 ? g : a[p], ap);
    for (int k = 0; k < 6; ++k) ap[k] += cb[i][k];
    T dot = U[i][0] * ap[0];
    for (int k = 1; k < 6; ++k) dot += U[i][k] * ap[k];
    qdd[i] = Dinv[i] * (uu[i] - dot);
    for (int k = 0; k < 6; ++k) a[i][k] = ap[k];
    a[i][s] += qdd[i];
  }
}

// Control box clamp of dof i; a null bound is no bound.
template <typename T>
GT_HDI T clamp_bounds(T u, const T* lo, const T* hi, int i) {
  if (lo && u < lo[i]) u = lo[i];
  if (hi && u > hi[i]) u = hi[i];
  return u;
}

// Semi-implicit Euler on x = [q; qd] (2 NJ), in place.
template <typename T, int NJ>
GT_HD void euler_step(const Robot<T, NJ>& R, T* x, const T* u, T dt,
                      T gravity) {
  T qdd[NJ];
  aba(R, x, x + NJ, u, gravity, qdd);
  for (int i = 0; i < NJ; ++i) {
    const T qdn = x[NJ + i] + dt * qdd[i];
    x[i] = x[i] + dt * qdn;
    x[NJ + i] = qdn;
  }
}

// The feedback control of problem b at knot t:
// u = clamp(Uref_t + (alpha k_t + K_t (x - Xref_t))), on Uref and k
// (N, NJ, B), Xref (N, 2 NJ, B) and K (N, NJ, 2 NJ, B). The line search
// (csrc/linesearch.cu) passes its step size; the feedback rollout
// (csrc/feedback_rollout.cu) alpha = 1, its step size folded into k.
template <typename T, int NJ>
GT_HD void feedback_u(const T* x, const T* Uref, const T* Xref, const T* k,
                      const T* K, T alpha, const T* lo, const T* hi, int t,
                      long long B, long long b, T* u) {
  constexpr int NX = 2 * NJ;
  T dx[NX];
  for (int m = 0; m < NX; ++m)
    dx[m] = x[m] - Xref[((long long)t * NX + m) * B + b];
  for (int j = 0; j < NJ; ++j) {
    const T* Kj = K + ((long long)t * NJ + j) * NX * B + b;
    T s = Kj[0] * dx[0];
    for (int m = 1; m < NX; ++m) s += Kj[m * B] * dx[m];
    const long long ij = ((long long)t * NJ + j) * B + b;
    u[j] = clamp_bounds(Uref[ij] + (alpha * k[ij] + s), lo, hi, j);
  }
}

// ---------------------------------------------------------------------------
// end-effector kinematics: T = T_c0 ... T_ck Tfixed over an EE chain
// ---------------------------------------------------------------------------

template <typename T>
GT_HDI void mm44(const T* A, const T* B, T* o) {
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      T acc = A[i * 4] * B[j];
      for (int k = 1; k < 4; ++k) acc += A[i * 4 + k] * B[k * 4 + j];
      o[i * 4 + j] = acc;
    }
}

template <typename T>
GT_HD void joint_T(const T* TT, int jtype, int sind, T qi, T* out) {
  const T o = T(1), z = T(0);
  T Tj[16];
  if (jtype == 0) {
    const T c = gcos(qi), s = gsin(qi);
    const int ax = sind % 3;
    if (ax == 0) {
      const T m[16] = {o, z, z, z, z, c, -s, z, z, s, c, z, z, z, z, o};
      for (int k = 0; k < 16; ++k) Tj[k] = m[k];
    } else if (ax == 1) {
      const T m[16] = {c, z, s, z, z, o, z, z, -s, z, c, z, z, z, z, o};
      for (int k = 0; k < 16; ++k) Tj[k] = m[k];
    } else {
      const T m[16] = {c, -s, z, z, s, c, z, z, z, z, o, z, z, z, z, o};
      for (int k = 0; k < 16; ++k) Tj[k] = m[k];
    }
  } else {
    const T m[16] = {o, z, z, z, z, o, z, z, z, z, o, z, z, z, z, o};
    for (int k = 0; k < 16; ++k) Tj[k] = m[k];
    Tj[(sind - 3) * 4 + 3] = qi;
  }
  mm44(TT, Tj, out);
}

// d/dq of joint_T: Ttree dTj/dq.
template <typename T>
GT_HD void joint_dT(const T* TT, int jtype, int sind, T qi, T* out) {
  const T o = T(1), z = T(0);
  T D[16];
  if (jtype == 0) {
    const T c = gcos(qi), s = gsin(qi);
    const int ax = sind % 3;
    if (ax == 0) {
      const T m[16] = {z, z, z, z, z, -s, -c, z, z, c, -s, z, z, z, z, z};
      for (int k = 0; k < 16; ++k) D[k] = m[k];
    } else if (ax == 1) {
      const T m[16] = {-s, z, c, z, z, z, z, z, -c, z, -s, z, z, z, z, z};
      for (int k = 0; k < 16; ++k) D[k] = m[k];
    } else {
      const T m[16] = {-s, -c, z, z, c, -s, z, z, z, z, z, z, z, z, z, z};
      for (int k = 0; k < 16; ++k) D[k] = m[k];
    }
  } else {   // prismatic: unit translation along axis sind - 3
    for (int k = 0; k < 16; ++k) D[k] = z;
    D[(sind - 3) * 4 + 3] = o;
  }
  mm44(TT, D, out);
}

// d2/dq2 of joint_T: Ttree d2Tj/dq2, -R on the rotating 2x2 block of a
// revolute joint; zero for a prismatic one.
template <typename T>
GT_HD void joint_d2T(const T* TT, int jtype, int sind, T qi, T* out) {
  T D[16];
  for (int k = 0; k < 16; ++k) D[k] = T(0);
  if (jtype == 0) {
    const T c = gcos(qi), s = gsin(qi);
    const int ax = sind % 3;
    if (ax == 0) {
      D[5] = -c; D[6] = s; D[9] = -s; D[10] = -c;
    } else if (ax == 1) {
      D[0] = -c; D[2] = -s; D[8] = s; D[10] = -c;
    } else {
      D[0] = -c; D[1] = s; D[4] = -s; D[5] = -c;
    }
  }
  mm44(TT, D, out);
}

// Chain product over the joints with chain[i] != 0 (ascending ids run root
// to leaf), times Tfix; Tfix alone for an empty chain.
template <typename T, int NJ>
GT_HD void ee_chain_T(const Robot<T, NJ>& R, const T* q, const T* chain,
                      const T* Tfix, T* Tc) {
  T Tj[16], tmp[16];
  bool first = true;
  for (int i = 0; i < NJ; ++i) {
    if (chain[i] == T(0)) continue;
    joint_T(R.Ttree(i), R.jtype[i], R.sind[i], q[i], Tj);
    if (first) {
      for (int k = 0; k < 16; ++k) Tc[k] = Tj[k];
      first = false;
    } else {
      mm44(Tc, Tj, tmp);
      for (int k = 0; k < 16; ++k) Tc[k] = tmp[k];
    }
  }
  if (first) {
    for (int k = 0; k < 16; ++k) Tc[k] = Tfix[k];
  } else {
    mm44(Tc, Tfix, tmp);
    for (int k = 0; k < 16; ++k) Tc[k] = tmp[k];
  }
}

// Position of the Layout's EE (the line-search cost's).
template <typename T, int NJ>
GT_HD void ee_xyz(const Robot<T, NJ>& R, const T* q, T* xyz) {
  T Tc[16];
  ee_chain_T(R, q, R.c + Layout<NJ>::EECHAIN, R.Tfixed(), Tc);
  xyz[0] = Tc[3];
  xyz[1] = Tc[7];
  xyz[2] = Tc[11];
}

// [x, y, z, roll, pitch, yaw] of a transform: roll = atan2(R21, R22),
// pitch = -atan2(R20, sqrt(R21^2 + R22^2)), yaw = atan2(R10, R00).
template <typename T>
GT_HDI void pose_from_T(const T* Tm, T* p) {
  p[0] = Tm[3];
  p[1] = Tm[7];
  p[2] = Tm[11];
  p[3] = gatan2(Tm[9], Tm[10]);
  p[4] = -gatan2(Tm[8], gsqrt(Tm[9] * Tm[9] + Tm[10] * Tm[10]));
  p[5] = gatan2(Tm[4], Tm[0]);
}

template <typename T>
GT_HDI T datan2(T y, T x, T dy, T dx) {
  return (x * dy - y * dx) / (x * x + y * y);
}

// Directional derivative of pose_from_T at Tm along dT.
template <typename T>
GT_HDI void pose_jvp(const T* Tm, const T* dT, T* p) {
  p[0] = dT[3];
  p[1] = dT[7];
  p[2] = dT[11];
  const T r = gsqrt(Tm[9] * Tm[9] + Tm[10] * Tm[10]);
  const T dr = (Tm[9] * dT[9] + Tm[10] * dT[10]) / r;
  p[3] = datan2(Tm[9], Tm[10], dT[9], dT[10]);
  p[4] = -datan2(Tm[8], r, dT[8], dr);
  p[5] = datan2(Tm[4], Tm[0], dT[4], dT[0]);
}

// Second derivative of atan2(y, x) along directions 1 and 2 with the
// second-order direction (y12, x12): f'[d12] + f''[d1, d2]; with
// r2 = x^2 + y^2, f_yy = -2xy/r2^2, f_xx = 2xy/r2^2, f_xy = (y^2-x^2)/r2^2.
template <typename T>
GT_HDI T hatan2(T y, T x, T y1, T x1, T y2, T x2, T y12, T x12) {
  const T inv = T(1) / (x * x + y * y);   // one division, not two
  return ((x * y12 - y * x12) +
          (T(2) * x * y * (x1 * x2 - y1 * y2) +
           (y * y - x * x) * (y1 * x2 + x1 * y2)) * inv) * inv;
}

// Second directional derivative of pose_from_T at Tm:
// f'(Tm)[d2] + f''(Tm)[d1, d2'] along d1 and d2' with the second-order
// direction h. Pitch nests r = sqrt(T21^2 + T22^2), whose second derivative
// on that pair is (d1 . d2' + T . h) / r - r1 r2 / r.
template <typename T>
GT_HDI void pose_hvp(const T* Tm, const T* d1, const T* d2, const T* h,
                     T* p) {
  p[0] = h[3];
  p[1] = h[7];
  p[2] = h[11];
  const T a = Tm[9], b = Tm[10];
  const T r = gsqrt(a * a + b * b), ir = T(1) / r;
  const T r1 = (a * d1[9] + b * d1[10]) * ir;
  const T r2 = (a * d2[9] + b * d2[10]) * ir;
  const T r12 =
      (a * h[9] + b * h[10] + d1[9] * d2[9] + d1[10] * d2[10] - r1 * r2) * ir;
  p[3] = hatan2(a, b, d1[9], d1[10], d2[9], d2[10], h[9], h[10]);
  p[4] = -hatan2(Tm[8], r, d1[8], r1, d2[8], r2, h[8], r12);
  p[5] = hatan2(Tm[4], Tm[0], d1[4], d1[0], d2[4], d2[0], h[4], h[0]);
}

// Poses of the `ne` rows of the EE buffer `ee`: EE e's [xyz, rpy] goes to
// out[(6 e + k) * stride], k < 6.
template <typename T, int NJ>
GT_HD void ee_pose_lane(const Robot<T, NJ>& R, const T* ee, int ne,
                        const T* q, T* out, long long stride) {
  using E = EERow<NJ>;
  for (int e = 0; e < ne; ++e) {
    const T* row = ee + e * E::SIZE;
    T Tc[16], p[6];
    ee_chain_T(R, q, row + E::CHAIN, row + E::TFIX, Tc);
    pose_from_T(Tc, p);
    for (int k = 0; k < 6; ++k) out[(6 * e + k) * stride] = p[k];
  }
}

// Pose Jacobians of the `ne` rows of `ee`, chain form: for the a-th joint
// of a chain of k, dT/dq_a = prefix_a . dT_a . suffix_a (prefix_a =
// T_0 ... T_a-1, suffix_a = T_a+1 ... T_k-1 Tfix), pushed through the pose
// JVP at T = T_0 suffix_0; joints off the chain get zero columns. EE e,
// joint column j -> out[((6 e + k) NJ + j) * stride].
template <typename T, int NJ>
GT_HD void ee_jac_lane(const Robot<T, NJ>& R, const T* ee, int ne,
                       const T* q, T* out, long long stride) {
  using E = EERow<NJ>;
  for (int e = 0; e < ne; ++e) {
    const T* row = ee + e * E::SIZE;
    const T* mask = row + E::CHAIN;
    T* oe = out + 6 * e * NJ * stride;
    int chain[NJ];
    int k = 0;
    for (int j = 0; j < NJ; ++j) {
      if (mask[j] != T(0)) {
        chain[k++] = j;
      } else {
        for (int r = 0; r < 6; ++r) oe[(r * NJ + j) * stride] = T(0);
      }
    }
    if (k == 0) continue;
    T Ts[NJ][16], suf[NJ][16], acc[16], tmp[16];
    for (int a = 0; a < k; ++a) {
      const int j = chain[a];
      joint_T(R.Ttree(j), R.jtype[j], R.sind[j], q[j], Ts[a]);
    }
    for (int m = 0; m < 16; ++m) acc[m] = row[E::TFIX + m];
    for (int a = k - 1; a >= 0; --a) {
      for (int m = 0; m < 16; ++m) suf[a][m] = acc[m];
      mm44(Ts[a], suf[a], acc);
    }
    // acc is now the full chain transform; tmp carries prefix_a
    for (int a = 0; a < k; ++a) {
      const int j = chain[a];
      T dT[16], d[16], p[6];
      joint_dT(R.Ttree(j), R.jtype[j], R.sind[j], q[j], dT);
      if (a == 0) {
        mm44(dT, suf[a], d);
      } else {
        T pd[16];
        mm44(tmp, dT, pd);
        mm44(pd, suf[a], d);
      }
      pose_jvp(acc, d, p);
      for (int r = 0; r < 6; ++r) oe[(r * NJ + j) * stride] = p[r];
      if (a == 0) {
        for (int m = 0; m < 16; ++m) tmp[m] = Ts[0][m];
      } else {
        T nx[16];
        mm44(tmp, Ts[a], nx);
        for (int m = 0; m < 16; ++m) tmp[m] = nx[m];
      }
    }
  }
}

// o = prefix B, 4x4; the first chain joint's prefix is the identity.
template <typename T>
GT_HDI void prefix_mul(const T* prefix, bool first, const T* B, T* o) {
  if (first) {
    for (int m = 0; m < 16; ++m) o[m] = B[m];
  } else {
    mm44(prefix, B, o);
  }
}

// The six pose entries p of joint pair (i, j) and (j, i) of one EE block.
template <typename T, int NJ>
GT_HDI void store_pair(T* oe, long long stride, int i, int j, const T* p) {
  for (int r = 0; r < 6; ++r) {
    oe[((r * NJ + i) * NJ + j) * stride] = p[r];
    oe[((r * NJ + j) * NJ + i) * stride] = p[r];
  }
}

// Pose Hessians of the `ne` rows of `ee`, chain form
// (gridcodegenerator_tpu_torch/ops/eepose.py:d2eepos): for chain joints
// a < b, d2T/dq_a dq_b = W_ab . dT_b . suffix_b with W_ab = prefix_a . dT_a
// . T_a+1 ... T_b-1 (one sweep per a), and d2T/dq_a^2 = prefix_a . d2T_a .
// suffix_a; each goes through pose_hvp at the full chain transform along
// dT/dq_a = prefix_a . dT_a . suffix_a (the Jacobian's, kept per chain
// joint). Entries whose row or column joint is off the chain are zero. EE
// e, joints (i, j) -> out[(((6 e + r) NJ + i) NJ + j) * stride], written
// symmetric.
template <typename T, int NJ>
GT_HD void ee_hess_lane(const Robot<T, NJ>& R, const T* ee, int ne,
                        const T* q, T* out, long long stride) {
  using E = EERow<NJ>;
  for (int e = 0; e < ne; ++e) {
    const T* row = ee + e * E::SIZE;
    const T* mask = row + E::CHAIN;
    T* oe = out + 6LL * e * NJ * NJ * stride;
    int chain[NJ];
    int k = 0;
    for (int j = 0; j < NJ; ++j)
      if (mask[j] != T(0)) chain[k++] = j;
    for (int i = 0; i < NJ; ++i)
      for (int j = 0; j < NJ; ++j)
        if (mask[i] == T(0) || mask[j] == T(0))
          for (int r = 0; r < 6; ++r)
            oe[((r * NJ + i) * NJ + j) * stride] = T(0);
    if (k == 0) continue;
    T Ts[NJ][16], dTs[NJ][16], suf[NJ][16], dTf[NJ][16], full[16];
    for (int a = 0; a < k; ++a) {
      const int j = chain[a];
      joint_T(R.Ttree(j), R.jtype[j], R.sind[j], q[j], Ts[a]);
      joint_dT(R.Ttree(j), R.jtype[j], R.sind[j], q[j], dTs[a]);
    }
    for (int m = 0; m < 16; ++m) full[m] = row[E::TFIX + m];
    for (int a = k - 1; a >= 0; --a) {
      for (int m = 0; m < 16; ++m) suf[a][m] = full[m];
      mm44(Ts[a], suf[a], full);
    }
    // pass 1: dT/dq_a and the diagonal, carrying prefix_a in pre
    T pre[16], t1[16], t2[16], p[6];
#ifdef __CUDACC__
#pragma unroll 1
#endif
    for (int a = 0; a < k; ++a) {
      const int j = chain[a];
      prefix_mul(pre, a == 0, dTs[a], t1);
      mm44(t1, suf[a], dTf[a]);
      joint_d2T(R.Ttree(j), R.jtype[j], R.sind[j], q[j], t2);
      prefix_mul(pre, a == 0, t2, t1);
      mm44(t1, suf[a], t2);
      pose_hvp(full, dTf[a], dTf[a], t2, p);
      store_pair<T, NJ>(oe, stride, j, j, p);
      prefix_mul(pre, a == 0, Ts[a], t1);
      for (int m = 0; m < 16; ++m) pre[m] = t1[m];
    }
    // pass 2: the pairs a < b, W = prefix_a . dT_a . T_a+1 ... T_b-1
#ifdef __CUDACC__
#pragma unroll 1
#endif
    for (int a = 0; a < k - 1; ++a) {
      T W[16];
      prefix_mul(pre, a == 0, dTs[a], W);
      for (int b = a + 1; b < k; ++b) {
        mm44(W, dTs[b], t1);
        mm44(t1, suf[b], t2);
        pose_hvp(full, dTf[a], dTf[b], t2, p);
        store_pair<T, NJ>(oe, stride, chain[a], chain[b], p);
        if (b + 1 < k) {
          mm44(W, Ts[b], t1);
          for (int m = 0; m < 16; ++m) W[m] = t1[m];
        }
      }
      prefix_mul(pre, a == 0, Ts[a], t1);
      for (int m = 0; m < 16; ++m) pre[m] = t1[m];
    }
  }
}

// ---------------------------------------------------------------------------
// pivot-free Gauss-Jordan inverse of an SPD (M, M) matrix
// ---------------------------------------------------------------------------

template <typename T, int M>
GT_HD void gj_inverse(const T* A, T* Ainv) {
  T aug[M][2 * M];
  for (int i = 0; i < M; ++i)
    for (int j = 0; j < M; ++j) {
      aug[i][j] = A[i * M + j];
      aug[i][M + j] = i == j ? T(1) : T(0);
    }
  for (int k = 0; k < M; ++k) {
    const T piv = T(1) / aug[k][k];
    T row[2 * M];
    for (int j = 0; j < 2 * M; ++j) row[j] = aug[k][j] * piv;
    for (int i = 0; i < M; ++i) {
      if (i == k) continue;
      const T ci = aug[i][k];
      for (int j = 0; j < 2 * M; ++j) aug[i][j] = aug[i][j] - ci * row[j];
    }
    for (int j = 0; j < 2 * M; ++j) aug[k][j] = row[j];
  }
  for (int i = 0; i < M; ++i)
    for (int j = 0; j < M; ++j) Ainv[i * M + j] = aug[i][M + j];
}

}  // namespace gt

#ifdef __CUDACC__
// Each library of the package holds one joint count, GT_NJ, given on the
// nvcc command line (ops/cuda/build.py: one library per SUPPORTED_JOINTS
// entry), in float and double (DTYPE_CODES). The trailing arguments are an
// expression in T and NJ that returns the error code.
#ifndef GT_NJ
#error "GT_NJ (the joint count of this library) must be defined"
#endif
#define GT_DISPATCH(dtype, nj, ...)                                         \
  do {                                                                      \
    constexpr int NJ = GT_NJ;                                               \
    if ((nj) == NJ && (dtype) == gt::kF32) {                                \
      using T = float;                                                      \
      return __VA_ARGS__;                                                   \
    }                                                                       \
    if ((nj) == NJ && (dtype) == gt::kF64) {                                \
      using T = double;                                                     \
      return __VA_ARGS__;                                                   \
    }                                                                       \
    return (int)cudaErrorInvalidValue;                                      \
  } while (0)

// Blocks of `block` threads covering `lanes` lanes; the kernels mask the
// ragged last block.
inline dim3 gt_grid(long long lanes, int block) {
  return dim3((unsigned)((lanes + block - 1) / block));
}
#endif
