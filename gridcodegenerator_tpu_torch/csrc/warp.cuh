// One warp per knot: the fd_du, fdsva_so, idsva_so and id_du programs of
// csrc/fd_du.cu, csrc/fdsva_so.cu, csrc/idsva_so.cu and csrc/id_du.cu, and
// the groups of threads a lane of d2eepos, rnea, fd, eepos, minv, crba and
// deepos (csrc/d2eepos.cu, csrc/rnea.cu, csrc/fd.cu, csrc/eepos.cu,
// csrc/minv.cu, csrc/crba.cu, csrc/deepos.cu), written once for the card
// and for the host.
//
// A block holds G knots, a warp each (a half warp up to 8 joints, where the
// 2 NJ gradient columns fit in 16 threads: two knots a warp; 2 or 4 times
// that where it puts more knots or warps on an SM: BlockPlan), and copies
// the robot constants into shared memory once (RobotConst). Each knot's
// state lives in shared memory in one buffer of T at the offsets of
// FDKnot / SOKnot, so arrays indexed by the run-time parent and S_ind never
// go to local memory. A program is a sequence of phases: `par(f)` runs f(t)
// for the knot's threads t (Par::LANES of them), then synchronises them.
// On the card (WarpPar) thread t is a lane and the phases are split by
// __syncwarp() (a named barrier for a knot of several warps); on the host
// (HostPar) f runs for t = 0, 1, ... in turn before the next phase starts,
// which is how the g++ host build of the tests and csrc/opcount.cpp drive
// the same code. Inside one phase no
// thread reads what another thread of that phase writes; each phase below
// says how its work is split.
//
// The design follows the reference GRiDCodeGenerator (a thread block per
// knot with its state in shared memory, GRiD paper, arXiv:2109.06976),
// carried to a warp per knot: 2 NJ <= 32 gradient columns for every
// instance up to 16 joints. Above 32 joints a knot takes two warps or more
// (knot_lanes), and where one knot does not fit a block's shared memory it
// runs a block at a time with its state in device memory (WsPlan,
// ws_lanes; id_du, minv, fd), or, fd_du, a block or a thread-block cluster
// at a time with its state on chip (FDChipPlan, fd_du_chip_lane): the
// programs take the knot's buffers as pointers, so the same code runs on
// either memory.
#pragma once

#include <type_traits>
#include <vector>

#include "so.cuh"

namespace gt {

constexpr int WARP = 32;
// the fewest threads a knot takes: a half warp where its 2 NJ gradient
// columns fit (two knots a warp), a warp up to 32 joints, else two warps
// (a thread for each of the NJ columns of a column pass, and for each
// joint: fd_du_knot, id_du_knot)
template <int NJ>
GT_HDI constexpr int knot_lanes() {
  return 2 * NJ <= 16 ? 16 : NJ <= WARP ? WARP : 2 * WARP;
}
// a set of joints, a bit a joint: 64 bits above 32 joints
template <bool WIDE>
struct JointBits {
  using type = unsigned;
};
template <>
struct JointBits<true> {
  using type = unsigned long long;
};
// a knot takes up to 4 such groups (BlockPlan)
constexpr int MAX_KNOT_GROUPS = 4;
constexpr int MIN_WARPS = 12;
// threads a block takes at most
constexpr int MAX_BLOCK_THREADS = 512;
// the register file of an SM, and the registers a thread of each kernel
// is planned with (ptxas reports fd_du 60-68 | 96-106 and fdsva_so 96-102
// | 168-188 in float32 | float64)
constexpr long long SM_REGS = 65536;
template <typename T>
GT_HDI constexpr int fd_regs() { return sizeof(T) == 4 ? 72 : 112; }
template <typename T>
GT_HDI constexpr int so_regs() { return sizeof(T) == 4 ? 104 : 192; }
// shared memory of an SM (228 KB), of which a block may use 227 KB, and
// what the card keeps back for each resident block
constexpr long long SM_SMEM = 233472;
constexpr long long SMEM_LIMIT = 232448;
constexpr long long SMEM_PER_BLOCK = 1024;
// knots a block holds at most: 8 gives full 32-byte sectors for the
// output rows in float32 (4 in float64)
constexpr int MAX_KNOTS = 8;

#ifdef __CUDACC__
// The knot's N threads on the card. N = 16 puts two knots in a warp, which
// run the same phases in step (the same robot), so the whole warp
// synchronises; a block holds an even number of such knots. N = 32: a
// warp. N = 64 or 128: the knot's warps meet at named barrier `bar` (1 +
// the knot's index in the block; 0 is __syncthreads').
template <int N>
struct WarpPar {
  static constexpr int LANES = N;
  int lane;
  int bar;
  template <class F>
  GT_HDI void operator()(F&& f) const {
#ifdef __CUDA_ARCH__
    f(lane);
    if (N <= WARP) {
      __syncwarp();
    } else {
      asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(N) : "memory");
    }
#endif
  }
};
#endif

#ifdef GT_RACE_CHECK
void gt_race_phase();
void gt_race_thread(int t);
void gt_race_done();
// a buffer whose entries each thread of a phase writes are recorded (the
// harness compares it before and after each thread); null: none
void gt_race_watch(const void* p, long bytes);
extern bool gt_race_reverse;
#endif

// The host's N threads: every thread of a phase in turn, then the next
// phase. The race check of the tests' host build can also run them in
// reverse order: a phase in which one thread reads what another writes
// then gives another result.
template <int N>
struct HostPar {
  static constexpr int LANES = N;
  template <class F>
  void operator()(F&& f) const {
#ifdef GT_RACE_CHECK
    gt_race_phase();
    for (int n = 0; n < N; ++n) {
      const int t = gt_race_reverse ? N - 1 - n : n;
      gt_race_thread(t);
      f(t);
    }
    gt_race_done();
#else
    for (int t = 0; t < N; ++t) f(t);
#endif
  }
};

// __syncthreads() on the card; nothing on the host, where one thread runs
GT_HDI void block_sync() {
#ifdef __CUDA_ARCH__
  __syncthreads();
#endif
}

// The packed robot constants (Layout<NJ>) and the topology as ints, in
// shared memory; the accessors of Robot. The joints are also listed by
// level (depth in the tree: 0 for a joint on the base), ascending ids
// within a level: the joints of level l are ljoint[lstart[l] ..
// lstart[l + 1]). Joints of one level depend on each other through no
// tree pass, so a pass takes one phase a level, not one a joint.
template <typename T, int NJ>
struct RobotConst {
  using L = Layout<NJ>;
  T c[L::SIZE];
  int parent[NJ];
  int sind[NJ];
  int jtype[NJ];
  int nlev;
  int lstart[NJ + 1];
  int ljoint[NJ];
  int cstart[NJ + 1];   // children of p: clist[cstart[p] .. cstart[p + 1]),
  int clist[NJ];        // descending
  // the joints related to j (its subtree, descending, rsub[j] of them, then
  // its ancestors, descending): rlist[rstart[j] .. rstart[j + 1])
  int rstart[NJ + 1];
  int rsub[NJ];
  int rlist[NJ * NJ];

  // Copy from the packed buffer `model`, thread `tid` of `nthreads`; thread
  // 0 also lists the levels.
  GT_HD void load(const T* model, int tid, int nthreads) {
    for (int e = tid; e < L::SIZE; e += nthreads) c[e] = model[e];
    for (int i = tid; i < NJ; i += nthreads) {
      parent[i] = (int)model[L::PARENT + i];
      sind[i] = (int)model[L::SIND + i];
      jtype[i] = (int)model[L::JTYPE + i];
    }
    if (tid != 0) return;
    int lev[NJ];
    nlev = 0;
    for (int i = 0; i < NJ; ++i) {
      const int p = (int)model[L::PARENT + i];
      lev[i] = p < 0 ? 0 : lev[p] + 1;
      if (lev[i] >= nlev) nlev = lev[i] + 1;
    }
    int n = 0;
    for (int l = 0; l < nlev; ++l) {
      lstart[l] = n;
      for (int i = 0; i < NJ; ++i)
        if (lev[i] == l) ljoint[n++] = i;
    }
    lstart[nlev] = n;
    n = 0;
    for (int p = 0; p < NJ; ++p) {
      cstart[p] = n;
      for (int i = NJ - 1; i > p; --i)
        if ((int)model[L::PARENT + i] == p) clist[n++] = i;
    }
    cstart[NJ] = n;
    n = 0;
    for (int j = 0; j < NJ; ++j) {
      rstart[j] = n;
      for (int i = NJ - 1; i >= j; --i)
        if (model[L::SUBTREE + j * NJ + i] != T(0)) rlist[n++] = i;
      rsub[j] = n - rstart[j];
      for (int i = j - 1; i >= 0; --i)
        if (model[L::SUBTREE + i * NJ + j] != T(0)) rlist[n++] = i;
    }
    rstart[NJ] = n;
  }
  // The constants and the tree's lists (levels and children: those of
  // load), built by all the block's threads together, thread `tid` of
  // `nthreads` (every thread of the block calls it: it meets the block at
  // two barriers), without the related lists, which only the ID-gradient
  // columns read; rsub holds each joint's level meanwhile. A joint's level
  // is the length of its root path; each list entry is a count over the
  // parents in shared memory: the joints on the levels above a level
  // (lstart), the children of the joints before a joint (cstart), a
  // joint's place in its level, ascending, and among its parent's
  // children, descending. (Where load's thread 0 walks them alone, the
  // block's head took 12k-60k cycles at 7-28 joints on an H100, most of an
  // RNEA or ABA knot's time at one lane.)
  GT_HD void load_tree(const T* model, int tid, int nthreads) {
    for (int e = tid; e < L::SIZE; e += nthreads) c[e] = model[e];
    for (int i = tid; i < NJ; i += nthreads) {
      parent[i] = (int)model[L::PARENT + i];
      sind[i] = (int)model[L::SIND + i];
      jtype[i] = (int)model[L::JTYPE + i];
    }
    block_sync();
    for (int i = tid; i < NJ; i += nthreads) {
      int l = 0;
      for (int p = parent[i]; p >= 0; p = parent[p]) ++l;
      rsub[i] = l;
    }
    block_sync();
    for (int i = tid; i <= NJ; i += nthreads) {
      int above = 0, kids = 0;
      for (int j = 0; j < NJ; ++j) {
        above += rsub[j] < i;
        kids += parent[j] >= 0 && parent[j] < i;
      }
      lstart[i] = above;
      cstart[i] = kids;
    }
    for (int i = tid; i < NJ; i += nthreads) {
      const int li = rsub[i], p = parent[i];
      int at = 0, sib = 0;
      for (int j = 0; j < NJ; ++j) {
        at += rsub[j] < li || (rsub[j] == li && j < i);
        sib += parent[j] >= 0 && (parent[j] < p || (parent[j] == p && j > i));
      }
      ljoint[at] = i;
      if (p >= 0) clist[sib] = i;
    }
    if (tid == 0) {
      int deepest = 0;
      for (int j = 0; j < NJ; ++j)
        if (rsub[j] > deepest) deepest = rsub[j];
      nlev = deepest + 1;
    }
  }
  GT_HDI const T* Xtree(int i) const { return c + L::XTREE + 36 * i; }
  GT_HDI const T* Imat(int i) const { return c + L::IMAT + 36 * i; }
  GT_HDI T damping(int i) const { return c[L::DAMP + i]; }
  GT_HDI T subtree(int i, int col) const {
    return c[L::SUBTREE + i * NJ + col];
  }
  GT_HDI const T* Ttree(int i) const { return c + L::TTREE + 16 * i; }
  GT_HDI const T* Tfixed() const { return c + L::TFIX; }
  GT_HDI bool in_ee_chain(int i) const { return c[L::EECHAIN + i] != T(0); }
};

// Deals the work items of one phase to the knot's W threads round robin:
// thread t takes the items e of a loop of n with (first + e) % W == t, and
// the next loop of the phase starts where this one ended, so that several
// small loops spread over the threads.
template <int W>
struct Deal {
  int t;
  int first;
  template <class F>
  GT_HDI void operator()(int n, F&& f) {
    for (int e = ((t - first) % W + W) % W; e < n; e += W) f(e);
    first += n;
  }
};

// f(i) for the joints i = t, t + W, ... < NJ of thread t of a knot of W
// threads: one test where the knot has a thread for every joint
template <int NJ, int W, class F>
GT_HDI void each_joint(int t, F&& f) {
  if (NJ <= W) {
    if (t < NJ) f(t);
  } else {
    for (int i = t; i < NJ; i += W) f(i);
  }
}

// f(i, e) for every joint i of level l and e < K
template <int K, int W, class Rb, class F>
GT_HDI void level(Deal<W>& d, const Rb& R, int l, F&& f) {
  const int b = R.lstart[l];
  d((R.lstart[l + 1] - b) * K,
    [&](int e) { f(R.ljoint[b + e / K], e % K); });
}

// f(p, e, c) for every joint p of level l - 1, e < K, and each child c of p
// (of level l) in descending order, the order of a serial backward sweep:
// the thread that owns entry e of p adds in all of p's children.
template <int K, int W, class Rb, class F>
GT_HDI void children(Deal<W>& d, const Rb& R, int l, F&& f) {
  level<K>(d, R, l - 1, [&](int p, int e) {
    for (int n = R.cstart[p]; n < R.cstart[p + 1]; ++n) f(p, e, R.clist[n]);
  });
}

// ---------------------------------------------------------------------------
// entries of the spatial products, for threads that each own one entry
// (the same arithmetic, in the same order, as dynamics.cuh's full forms)
// ---------------------------------------------------------------------------

// row r of X v (Xv), and of X^T v (XTv); v may be strided
template <typename T>
GT_HDI T xrow(const T* X, const T* v, int r, int vs = 1) {
  T acc = X[r * 6] * v[0];
  for (int j = 1; j < 6; ++j) acc += X[r * 6 + j] * v[j * vs];
  return acc;
}

template <typename T>
GT_HDI T xcol(const T* X, const T* v, int r, int vs = 1) {
  T acc = X[r] * v[0];
  for (int j = 1; j < 6; ++j) acc += X[j * 6 + r] * v[j * vs];
  return acc;
}

// Entry k of a 6-vector held in registers (compile-time indices), by
// selects: threads of a warp that want different entries take no branch.
template <typename T>
GT_HDI T pick6(const T* o, int k) {
  T r = o[0];
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int m = 1; m < 6; ++m) r = k == m ? o[m] : r;
  return r;
}

// Row r of X v and of X^T v, and X v, X^T v, for a motion transform X =
// [[E, 0], [F, E]] (joint_xmat): its upper-right block is exactly zero, so
// those products (exact zeros) drop out; where r is known at compile time
// (an unrolled loop) the test folds away.
template <typename T>
GT_HDI T xmrow(const T* X, const T* v, int r, int vs = 1) {
  T acc = X[r * 6] * v[0];
  for (int j = 1; j < 6; ++j)
    if (r >= 3 || j < 3) acc += X[r * 6 + j] * v[j * vs];
  return acc;
}

template <typename T>
GT_HDI T xmcol(const T* X, const T* v, int r, int vs = 1) {
  const int j0 = r < 3 ? 0 : 3;
  T acc = X[j0 * 6 + r] * v[j0 * vs];
  for (int j = j0 + 1; j < 6; ++j) acc += X[j * 6 + r] * v[j * vs];
  return acc;
}

template <typename T>
GT_HDI void Xmv(const T* X, const T* v, T* o) {
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int r = 0; r < 6; ++r) o[r] = xmrow(X, v, r);
}

template <typename T>
GT_HDI void XmTv(const T* X, const T* v, T* o) {
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int r = 0; r < 6; ++r) o[r] = xmcol(X, v, r);
}

// component k of cross_mv(a, b): the whole product, then the entry (a
// switch on a k that differs between the threads would run its six cases
// one after another)
template <typename T>
GT_HDI T crm_k(const T* a, const T* b, int k) {
  T o[6];
  cross_mv(a, b, o);
  return pick6(o, k);
}

// entry (r, c) of skew(w) = [[0, -w2, w1], [w2, 0, -w0], [-w1, w0, 0]] and
// of crm_mat(v) = [W, 0; V, W] (so.cuh), for indices known at compile time
template <typename T>
GT_HDI T skew_rc(const T* w, int r, int c) {
  switch (r * 3 + c) {
    case 1: return -w[2];
    case 2: return w[1];
    case 3: return w[2];
    case 5: return -w[0];
    case 6: return -w[1];
    case 7: return w[0];
    default: return T(0);
  }
}

template <typename T>
GT_HDI T crm_rc(const T* v, int r, int c) {
  if (r < 3) return c < 3 ? skew_rc(v, r, c) : T(0);
  return c < 3 ? skew_rc(v + 3, r - 3, c) : skew_rc(v, r - 3, c - 3);
}

// the unit vector e_s in registers (no run-time index into an array)
template <typename T>
GT_HDI void unit6(int s, T* e) {
  for (int k = 0; k < 6; ++k) e[k] = k == s ? T(1) : T(0);
}

// ---------------------------------------------------------------------------
// fd_du: one knot's state (offsets into its buffer of T)
// ---------------------------------------------------------------------------

template <int NJ>
struct FDKnot {
  static constexpr int NC = 2 * NJ;   // gradient columns
  static constexpr int Q = 0, QD = Q + NJ, U = QD + NJ;   // inputs
  // outputs: qdd, Minv (NJ, NJ) (the upper factor, then mirrored), df/du
  // (NJ, 2 NJ)
  static constexpr int QDD = U + NJ, MI = QDD + NJ, DFDU = MI + NJ * NJ;
  static constexpr int SCR = DFDU + NJ * NC;   // work space from here on
  static constexpr int X = SCR;                // (NJ, 36) joint transforms
  static constexpr int V = X + 36 * NJ;        // (NJ, 6) velocities,
  static constexpr int A = V + 6 * NJ;         // accelerations,
  static constexpr int F = A + 6 * NJ;         // forces,
  static constexpr int IV = F + 6 * NJ;        // I v
  static constexpr int C = IV + 6 * NJ;        // (NJ) bias forces
  // Minv's work space: IA (NJ, 36), F (NJ, 6, NJ), U (NJ, 6), Dinv (NJ),
  // (NJ, 36) temporaries, one a joint, and X^T U (NJ, 6)
  static constexpr int IA = C + NJ, FM = IA + 36 * NJ, UU = FM + 6 * NJ * NJ;
  static constexpr int DINV = UU + 6 * NJ, TMP = DINV + NJ;
  static constexpr int XU = TMP + 36 * NJ;
  // the gradient's per-column state (NJ, 18, NJ): dv, da, df of each joint
  // for each column of one pass (the q columns, then the qd ones), column
  // fastest. It aliases Minv's work space: Minv is done before the columns
  // start. (Two passes of NJ columns hold half the state of one pass of
  // 2 NJ: twice the knots fit on an SM, and the knots are bound by latency,
  // not by issue.)
  static constexpr int COL = IA;
  static constexpr int MINV_END = XU + 6 * NJ, COL_END = COL + 18 * NJ * NJ;
  static constexpr int SIZE = MINV_END > COL_END ? MINV_END : COL_END;
};

// ---------------------------------------------------------------------------
// the RNEA passes and the ID-gradient columns of one knot, shared by fd_du
// and id_du (rnea runs the passes alone): the knot's state sits at the
// offsets of O (FDKnot, IDUKnot):
// Q, QD, QDD, X (NJ, 36), V, A, F, IV (NJ, 6 each) and the columns' state
// COL. Force-inlined, and the RNEA passes take their pointers, gravity and
// level count from the caller (RneaView, nlev), formed once at the top of
// the knot's program: so fd_du_knot compiles to the machine code of the
// program written out in one function (a pointer formed or R.nlev read
// inside the passes moved its registers). The tree passes take a phase a
// level (RobotConst), a row or entry of each joint of the level a thread;
// a backward pass adds a level's joints into their parents, each entry of
// a parent owned by one thread, which adds the parent's children in
// descending order as the serial sweep does, so every value comes out as
// the serial code computes it.
// ---------------------------------------------------------------------------

// What a forward pass forms: RNEA_BIAS v, a without qdd, I v and f (fd_du's
// bias pass); RNEA_AT_QDD a with qdd and f, reading v and I v (fd_du's pass
// at its qdd); RNEA_FULL v, a with qdd, I v and f (id_du's one pass).
enum RneaMode { RNEA_BIAS, RNEA_AT_QDD, RNEA_FULL };

// The forward pass, a level a phase: row r of v_i and of a_i (a reads all
// of v_i, so a level's a comes a phase after its v: phase l + 1 holds a of
// level l and v of level l + 1); then I v_i and f_i = I a_i + crf(v_i)
// I v_i, a joint a thread.
template <typename T>
struct RneaView {
  const T* qd;
  const T* qdd;
  T* X;
  T* v;
  T* a;
  T* f;
  T* Iv;
  const T* g;   // gravity's spatial acceleration (6)
};

template <RneaMode MODE, typename T, int NJ, class Rb, class Par>
GT_HDI void rnea_forward_knot(const Par& par, const Rb& R,
                              const RneaView<T>& V, int nlev) {
  constexpr int W = Par::LANES;
  constexpr bool with_qdd = MODE != RNEA_BIAS, with_v = MODE != RNEA_AT_QDD;
  const T* qd = V.qd;
  const T* qdd = V.qdd;
  const T* X = V.X;
  T* v = V.v;
  T* a = V.a;
  T* f = V.f;
  T* Iv = V.Iv;
  const T* g = V.g;
  auto v_row = [&](int i, int r) {
    const int p = R.parent[i];
    T x = p == -1 ? T(0) : xrow(X + 36 * i, v + 6 * p, r);
    if (r == R.sind[i]) x = p == -1 ? qd[i] : x + qd[i];
    v[6 * i + r] = x;
  };
  auto a_row = [&](int i, int r) {
    const int p = R.parent[i], s = R.sind[i];
    T x;
    if (p == -1) {
      x = xrow(X + 36 * i, g, r);
    } else {
      T vJ[6];
      for (int m = 0; m < 6; ++m) vJ[m] = m == s ? qd[i] : T(0);
      x = xrow(X + 36 * i, a + 6 * p, r) + crm_k(v + 6 * i, vJ, r);
    }
    if (with_qdd && r == s) x += qdd[i];
    a[6 * i + r] = x;
  };
  if (with_v) {
    par([&](int t) {
      Deal<W> d{t, 0};
      level<6>(d, R, 0, v_row);
    });
  }
  for (int l = 0; l < nlev; ++l) {
    par([&](int t) {
      Deal<W> d{t, 0};
      level<6>(d, R, l, a_row);
      if (with_v && l + 1 < nlev) level<6>(d, R, l + 1, v_row);
    });
  }
  par([&](int t) {
    for (int i = t; i < NJ; i += W) {
      T iv[6], ia[6], c[6];
      if (!with_v) {
        for (int m = 0; m < 6; ++m) iv[m] = Iv[6 * i + m];
      } else {
        Xv(R.Imat(i), v + 6 * i, iv);
        for (int m = 0; m < 6; ++m) Iv[6 * i + m] = iv[m];
      }
      Xv(R.Imat(i), a + 6 * i, ia);
      cross_fv(v + 6 * i, iv, c);
      for (int m = 0; m < 6; ++m) f[6 * i + m] = ia[m] + c[m];
    }
  });
}

// The backward pass: f_p += X_c^T f_c, a level a phase.
template <typename T, class Rb, class Par>
GT_HDI void rnea_backward_knot(const Par& par, const Rb& R,
                               const RneaView<T>& V, int nlev) {
  constexpr int W = Par::LANES;
  const T* X = V.X;
  T* f = V.f;
  for (int l = nlev - 1; l >= 1; --l) {
    par([&](int t) {
      Deal<W> d{t, 0};
      children<6>(d, R, l, [&](int p, int r, int ch) {
        f[6 * p + r] += xcol(X + 36 * ch, f + 6 * ch, r);
      });
    });
  }
}

// One gradient column of id_grad_columns_knot, by its thread: column j,
// a q column (isq) or a qd one, over the accumulated forces f; st(i, m)
// is entry m of joint i's dv, da, df (18 values VS apart); out(i, x) takes
// dc's entry i. Force-inlined: fd_du's and id_du's column passes and fd_du's
// column chunks on chip (fd_du_chip_lane) run it.
template <typename T, int NJ, int VS, class Rb, class St, class Out>
GT_HDI void grad_column(const Rb& R, const T* qd, const T* X, const T* v,
                        const T* a, const T* f, const T* Iv, const T* g,
                        bool isq, int j, St&& st, Out&& out) {
  const int r0 = R.rstart[j], nsub = R.rsub[j];
  // forward over subtree(j), ascending: j first
  for (int n = r0 + nsub - 1; n >= r0; --n) {
    const int i = R.rlist[n], p = R.parent[i], s = R.sind[i];
    const bool at_j = i == j;
    const T* Xi = X + 36 * i;
    T e[6], dv[6], da[6], tv[6], mv[6];
    unit6(s, e);
    // dv_i = X dv_p + [i == j] (crm(X v_p) S | S)
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int m = 0; m < 6; ++m)
      dv[m] = at_j ? T(0) : xmrow(Xi, &st(p, 0), m, VS);
    if (at_j) {
      if (isq) {
        if (p != -1) {
          Xmv(Xi, v + 6 * p, tv);
          cross_mv(tv, e, mv);
          for (int m = 0; m < 6; ++m) dv[m] += mv[m];
        }
      } else {
        for (int m = 0; m < 6; ++m) dv[m] += e[m];
      }
    }
    // da_i = crm(dv_i) S qd_i + [i == j] (crm(X a_p) S | crm(v_i) S)
    //        + X da_p
    cross_mv(dv, e, mv);
    for (int m = 0; m < 6; ++m) da[m] = mv[m] * qd[i];
    if (at_j) {
      if (isq) {
        if (p == -1) {
          Xmv(Xi, g, tv);
        } else {
          Xmv(Xi, a + 6 * p, tv);
        }
        cross_mv(tv, e, mv);
      } else {
        cross_mv(v + 6 * i, e, mv);
      }
      for (int m = 0; m < 6; ++m) da[m] += mv[m];
    } else {
#ifdef __CUDACC__
#pragma unroll
#endif
      for (int m = 0; m < 6; ++m) da[m] += xmrow(Xi, &st(p, 6), m, VS);
    }
    // df_i = crf(dv_i) I v_i + I da_i + crf(v_i) I dv_i
    T t1[6], t2[6], t3[6];
    cross_fv(dv, Iv + 6 * i, t1);
    Xv(R.Imat(i), da, t2);
    Xv(R.Imat(i), dv, tv);
    cross_fv(v + 6 * i, tv, t3);
    for (int m = 0; m < 6; ++m) {
      st(i, m) = dv[m];
      st(i, 6 + m) = da[m];
      st(i, 12 + m) = t1[m] + t2[m] + t3[m];
    }
  }
  // the ancestors' df start at zero, but for j's parent in a q column,
  // which starts at d(X_j^T)/dq_j f_j = X_j^T crf(S_j) f_j; the backward
  // pass adds each related joint into its parent, descending
  T dxf[6] = {0, 0, 0, 0, 0, 0};
  if (isq) {
    T e[6], mv[6];
    unit6(R.sind[j], e);
    cross_fv(e, f + 6 * j, mv);
    XmTv(X + 36 * j, mv, dxf);
  }
  using Bits = typename JointBits<(NJ > WARP)>::type;
  Bits related = 0;
  for (int n = r0; n < R.rstart[j + 1]; ++n) {
    const int i = R.rlist[n];
    related |= Bits(1) << i;
    if (n >= r0 + nsub) {
      const bool jp = i == R.parent[j];
      for (int m = 0; m < 6; ++m) st(i, 12 + m) = jp ? dxf[m] : T(0);
    }
  }
  for (int n = r0; n < R.rstart[j + 1]; ++n) {
    const int i = R.rlist[n], p = R.parent[i];
    if (p == -1) continue;
    T tv[6];
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int m = 0; m < 6; ++m)
      tv[m] = xmcol(X + 36 * i, &st(i, 12), m, VS);
    for (int m = 0; m < 6; ++m) st(p, 12 + m) += tv[m];
  }
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int i = 0; i < NJ; ++i) {
    const T x = st(i, 12 + R.sind[i]);   // stale unless related
    out(i, ((related >> i) & Bits(1) ? x : T(0)) +
               ((!isq && i == j) ? R.damping(i) : T(0)));
  }
}

// The ID gradient dc/d[q, qd] on the accumulated forces of rnea_backward_knot,
// one column a thread, in PASSES phases of 2 NJ / PASSES columns (2: the q
// columns, then the qd ones; 1: all 2 NJ at once), each thread over its
// column's dv/da/df in COL (column fastest). For column j, dv_i and da_i
// are zero unless i lies in subtree(j), and df_i unless i lies in
// subtree(j) or on the path from the root to j (RobotConst: rlist), so each
// thread walks those joints only: step n of every thread is the n-th joint
// of its own list, so the threads run one path (walking all joints, the
// warp would run every joint some column needs). Each thread hands its
// column's dc (NJ) to sink(pass, t, dc): column pass * 2 NJ / PASSES + t
// in [q, qd] order.
template <typename T, int NJ, class O, int PASSES, class Rb, class Par,
          class Sink>
GT_HDI void id_grad_columns_knot(const Par& par, const Rb& R, T* k,
                                 T gravity, Sink&& sink) {
  constexpr int COLS = 2 * NJ / PASSES;
  static_assert(PASSES == 1 || PASSES == 2, "one or two column passes");
  static_assert(COLS <= Par::LANES, "a thread per gradient column");
  const T* qd = k + O::QD;
  const T* X = k + O::X;
  const T* v = k + O::V;
  const T* a = k + O::A;
  const T* f = k + O::F;
  const T* Iv = k + O::IV;
  T* col = k + O::COL;
  const T g[6] = {0, 0, 0, 0, 0, -gravity};
  for (int pass = 0; pass < PASSES; ++pass) par([&](int t) {
    if (t >= COLS) return;
    const bool isq = PASSES == 2 ? pass == 0 : t < NJ;
    const int j = PASSES == 2 || t < NJ ? t : t - NJ;
    T dc[NJ];
    grad_column<T, NJ, COLS>(
        R, qd, X, v, a, f, Iv, g, isq, j,
        [&](int i, int m) -> T& { return col[(i * 18 + m) * COLS + t]; },
        [&](int i, T x) { dc[i] = x; });
    sink(pass, t, dc);
  });
}

// The knot's state that fd_qdd_knot reads and writes: its inputs, qdd, the
// upper factor of Minv (NJ, NJ), the joint transforms, the forces, the bias
// forces c and Minv's work space (FDKnot's or FDQKnot's offsets).
template <typename T>
struct FDView {
  const T* q;
  const T* qd;
  const T* u;
  T* qdd;
  T* Mi;
  T* X;
  const T* f;
  T* c;
  T* IA;     // (NJ, 36) articulated inertias
  T* FM;     // (NJ, 6, NJ) Minv's F
  T* UU;     // (NJ, 6) U
  T* Dinv;   // (NJ)
  T* tmp;    // (NJ, 36) temporaries, one a joint
  T* XU;     // (NJ, 6) X^T U
};

// Carpentier's Minv of the knot at the caller's view `K` (its q, Mi, X and
// Minv's work space; the fields of the bias RNEA are not read), split into
// three force-inlined parts that fd_qdd_knot and minv_knot run alike:
// minv_setup_knot, one phase: the joint transforms, a joint a thread, and
// IA = I, F = 0; minv_backward_knot, two phases a level, deepest first,
// into every entry of the factor's rows (entries left of the diagonal, where
// subtree(i, cc) is 0, come out +-0); minv_forward_knot, two phases a level
// (one at the root, none for the last level's F), the entries cc >= i of
// the upper factor. The phases of a joint a thread loop over the knot's
// threads, so a knot may have fewer threads than joints. They read the
// constants and the tree's levels and children (RobotConst::load_tree),
// not the related lists.
template <typename T, int NJ, class Rb, class Par>
GT_HDI void minv_setup_knot(const Par& par, const Rb& R, const FDView<T>& K) {
  constexpr int W = Par::LANES;
  const T* q = K.q;
  T* X = K.X;
  T* IA = K.IA;
  T* FM = K.FM;

  // joint transforms (a joint a thread); Minv's IA and F set up
  par([&](int t) {
    each_joint<NJ, W>(t, [&](int i) {
      joint_xmat(R.Xtree(i), R.jtype[i], R.sind[i], q[i], X + 36 * i);
    });
    for (int e = t; e < 36 * NJ; e += W) IA[e] = R.Imat(0)[e];
    for (int e = t; e < 6 * NJ * NJ; e += W) FM[e] = T(0);
  });
}

// The backward pass; `first(d)` deals more items to the knot's threads in
// the pass's first phase (fd: the bias forces c; minv: none).
template <typename T, int NJ, class Rb, class Par, class First>
GT_HDI void minv_backward_knot(const Par& par, const Rb& R,
                               const FDView<T>& K, int nlev, First&& first) {
  constexpr int W = Par::LANES;
  T* Mi = K.Mi;
  T* X = K.X;
  T* IA = K.IA;
  T* FM = K.FM;
  T* UU = K.UU;
  T* Dinv = K.Dinv;
  T* tmp = K.tmp;
  T* XU = K.XU;

  // Minv, backward pass (deepest level first): (A) per joint i of the
  // level, row i of the factor M_i, U_i, Dinv_i, X_i^T U_i and tmp_i =
  // X_i^T IA_i (the first such phase also takes the caller's first items);
  // (B) over the children c of each parent p, IA_p += X_c^T (IA_c - U_c
  // Dinv_c U_c^T) X_c = tmp_c X_c - (X_c^T U_c) Dinv_c (X_c^T U_c)^T and
  // F_p += X_c^T (F_c + U_c M_c) = X_c^T F_c + (X_c^T U_c) M_c.
  for (int l = nlev - 1; l >= 0; --l) {
    par([&](int t) {
      Deal<W> d{t, 0};
      if (l == nlev - 1) first(d);
      level<NJ>(d, R, l, [&](int i, int cc) {
        const int s = R.sind[i];
        const T di = T(1) / IA[36 * i + s * 6 + s];
        T m = -di * FM[(i * 6 + s) * NJ + cc] * R.subtree(i, cc);
        if (cc == i) m += di;
        Mi[i * NJ + cc] = m;
      });
      level<6>(d, R, l, [&](int i, int r) {
        const int s = R.sind[i];
        UU[6 * i + r] = IA[36 * i + r * 6 + s];
        XU[6 * i + r] = xcol(X + 36 * i, IA + 36 * i + s, r, 6);
        if (r == 0) Dinv[i] = T(1) / IA[36 * i + s * 6 + s];
      });
      level<36>(d, R, l, [&](int i, int e) {
        if (R.parent[i] == -1) return;
        tmp[36 * i + e] = xcol(X + 36 * i, IA + 36 * i + e % 6, e / 6, 6);
      });
    });
    if (l == 0) break;
    par([&](int t) {
      Deal<W> d{t, 0};
      children<36>(d, R, l, [&](int p, int e, int ch) {
        const int r = e / 6, cc = e % 6;
        const T* tc = tmp + 36 * ch;
        const T* Xc = X + 36 * ch;
        T acc = tc[r * 6] * Xc[cc];
        for (int m = 1; m < 6; ++m) acc += tc[r * 6 + m] * Xc[m * 6 + cc];
        IA[36 * p + e] += acc - XU[6 * ch + r] * Dinv[ch] * XU[6 * ch + cc];
      });
      children<6 * NJ>(d, R, l, [&](int p, int e, int ch) {
        const int r = e / NJ, cc = e % NJ;
        FM[(p * 6 + r) * NJ + cc] +=
            xcol(X + 36 * ch, FM + (ch * 6) * NJ + cc, r, NJ) +
            XU[6 * ch + r] * Mi[ch * NJ + cc] * R.subtree(ch, cc);
      });
    });
  }
}

// The forward pass.
template <typename T, int NJ, class Rb, class Par>
GT_HDI void minv_forward_knot(const Par& par, const Rb& R, const FDView<T>& K,
                              int nlev) {
  constexpr int W = Par::LANES;
  T* Mi = K.Mi;
  T* X = K.X;
  T* FM = K.FM;
  T* Dinv = K.Dinv;
  T* XU = K.XU;

  // forward pass (level by level), columns cc >= i: M_i += -Dinv_i (X_i^T
  // U_i) . F_p, then F_i = X_i F_p + e_s M_i
  for (int l = 0; l < nlev; ++l) {
    if (l > 0) {
      par([&](int t) {
        Deal<W> d{t, 0};
        level<NJ>(d, R, l, [&](int i, int cc) {
          if (cc < i) return;
          const int p = R.parent[i];
          T contr = XU[6 * i] * FM[(p * 6) * NJ + cc];
          for (int m = 1; m < 6; ++m)
            contr += XU[6 * i + m] * FM[(p * 6 + m) * NJ + cc];
          Mi[i * NJ + cc] += -Dinv[i] * contr;
        });
      });
    }
    if (l + 1 == nlev) break;   // no joint reads the last level's F
    par([&](int t) {
      Deal<W> d{t, 0};
      level<6 * NJ>(d, R, l, [&](int i, int e) {
        const int r = e / NJ, cc = e % NJ;
        if (cc < i) return;
        const int p = R.parent[i];
        T fn = p == -1 ? T(0) : xrow(X + 36 * i, FM + (p * 6) * NJ + cc, r, NJ);
        if (r == R.sind[i]) fn += Mi[i * NJ + cc];
        FM[(i * 6 + r) * NJ + cc] = fn;
      });
    });
  }
}

// qdd = Minv (u - c) of the knot at the caller's view `K`: the first half of
// fd_du's program, which fd runs alone (dynamics.cuh:fd_from_x's
// arithmetic, split over the knot's threads). Carpentier's Minv set up
// (the joint transforms, a joint a thread); the bias RNEA on the caller's
// view `rv` and level count (rnea_forward_knot<RNEA_BIAS>,
// rnea_backward_knot); Minv's backward pass, whose first phase also forms
// the bias forces c, and its forward pass, into the upper factor; then qdd
// a joint a thread, reading the upper factor only (with MIRROR the same
// phase mirrors it into the dense Minv). Force-inlined, and its pointers
// come from the caller: fd_du_knot forms them at the top of its program,
// in the order of its machine code before the passes were shared (with the
// pointers formed here, fd_du's SASS moved at every joint count; PERF.md,
// Findings).
template <typename T, int NJ, bool MIRROR, class Rb, class Par>
GT_HDI void fd_qdd_knot(const Par& par, const Rb& R, const FDView<T>& K,
                        const RneaView<T>& rv, int nlev) {
  constexpr int W = Par::LANES;
  const T* qd = K.qd;
  const T* u = K.u;
  T* qdd = K.qdd;
  T* Mi = K.Mi;
  const T* f = K.f;
  T* c = K.c;

  minv_setup_knot<T, NJ>(par, R, K);
  rnea_forward_knot<RNEA_BIAS, T, NJ>(par, R, rv, nlev);
  rnea_backward_knot<T>(par, R, rv, nlev);
  minv_backward_knot<T, NJ>(par, R, K, nlev, [&](Deal<W>& d) {
    d(NJ, [&](int i) { c[i] = f[6 * i + R.sind[i]] + R.damping(i) * qd[i]; });
  });
  minv_forward_knot<T, NJ>(par, R, K, nlev);
  // qdd = Minv (u - c), a joint a thread, reading the upper factor only
  // (MIRROR: and Minv dense, the upper factor mirrored)
  par([&](int t) {
    if (MIRROR) {
      for (int e = t; e < NJ * NJ; e += W) {
        const int r = e / NJ, cc = e % NJ;
        if (r > cc) Mi[e] = Mi[cc * NJ + r];
      }
    }
    each_joint<NJ, W>(t, [&](int i) {
      T acc = Mi[i < 1 ? i * NJ : i] * (u[0] - c[0]);
      for (int m = 1; m < NJ; ++m)
        acc += Mi[i <= m ? i * NJ + m : m * NJ + i] * (u[m] - c[m]);
      qdd[i] = acc;
    });
  });
}

// df/du, qdd and Minv of the knot whose q, qd, u sit at FDKnot's offsets in
// `k` (fd_qdd_knot: the bias RNEA, Carpentier's Minv, qdd = Minv (u - c);
// then RNEA at qdd, the analytical ID gradient dc/d[q, qd] one column a
// thread, df/du = -Minv dc/du): the arithmetic of dynamics.cuh's fd_from_x
// and id_du_columns, split over the knot's threads.
template <typename T, int NJ, class Rb, class Par>
GT_HD void fd_du_knot(const Par& par, const Rb& R, T* k, T gravity) {
  using O = FDKnot<NJ>;
  constexpr int NC = O::NC;
  static_assert(NJ <= Par::LANES, "a thread per gradient column");
  const T* q = k + O::Q;
  const T* qd = k + O::QD;
  const T* u = k + O::U;
  T* qdd = k + O::QDD;
  T* Mi = k + O::MI;
  T* X = k + O::X;
  T* v = k + O::V;
  T* a = k + O::A;
  T* f = k + O::F;
  T* Iv = k + O::IV;
  T* c = k + O::C;
  T* IA = k + O::IA;
  T* FM = k + O::FM;
  T* UU = k + O::UU;
  T* Dinv = k + O::DINV;
  T* tmp = k + O::TMP;
  T* XU = k + O::XU;
  const T g[6] = {0, 0, 0, 0, 0, -gravity};
  const int nlev = R.nlev;
  const RneaView<T> rv{qd, qdd, X, v, a, f, Iv, g};
  fd_qdd_knot<T, NJ, true>(
      par, R, FDView<T>{q, qd, u, qdd, Mi, X, f, c, IA, FM, UU, Dinv, tmp, XU},
      rv, nlev);

  // RNEA at qdd (v and I v are unchanged); f accumulates into the parents
  rnea_forward_knot<RNEA_AT_QDD, T, NJ>(par, R, rv, nlev);
  rnea_backward_knot<T>(par, R, rv, nlev);

  // the ID gradient in two passes of NJ columns, then each column of
  // df/du = -Minv dc, by the column's thread
  id_grad_columns_knot<T, NJ, O, 2>(par, R, k, gravity,
                                    [&](int pass, int t, const T* dc) {
    for (int r = 0; r < NJ; ++r) {
      T acc = Mi[r * NJ] * dc[0];
#ifdef __CUDACC__
#pragma unroll
#endif
      for (int m = 1; m < NJ; ++m) acc += Mi[r * NJ + m] * dc[m];
      k[O::DFDU + r * NC + pass * NJ + t] = -acc;
    }
  });
}

// ---------------------------------------------------------------------------
// fd: one knot's state and program, fd_du's first half
// ---------------------------------------------------------------------------

// The knot's inputs q, qd, u, its output qdd, the upper factor of Minv
// (NJ, NJ), then fd_du's work space without the gradient's columns: the
// joint transforms, v, a, f, I v, the bias forces c and Minv's IA, F, U,
// Dinv, temporaries and X^T U: 7 NJ^2 + 150 NJ values (1393 at 7 joints,
// 5.6 KB in float32; 9688 at 28, 38.8 KB | 77.5 KB in float32 | float64).
template <int NJ>
struct FDQKnot {
  static constexpr int Q = 0, QD = Q + NJ, U = QD + NJ, QDD = U + NJ;
  static constexpr int MI = QDD + NJ;          // (NJ, NJ) the upper factor
  static constexpr int X = MI + NJ * NJ;       // (NJ, 36)
  static constexpr int V = X + 36 * NJ, A = V + 6 * NJ, F = A + 6 * NJ;
  static constexpr int IV = F + 6 * NJ, C = IV + 6 * NJ;
  static constexpr int IA = C + NJ, FM = IA + 36 * NJ, UU = FM + 6 * NJ * NJ;
  static constexpr int DINV = UU + 6 * NJ, TMP = DINV + NJ;
  static constexpr int XU = TMP + 36 * NJ;
  static constexpr int SIZE = XU + 6 * NJ;
};

// qdd = Minv (u - c) of the knot whose q, qd, u sit at FDQKnot's offsets in
// `k` (dynamics.cuh:fd_lane, split over the knot's threads): fd_qdd_knot,
// fd_du's first half. A tree of L levels takes 6 L phases (iiwa 42, hyq 18,
// atlas 54).
template <typename T, int NJ, class Rb, class Par>
GT_HD void fd_knot(const Par& par, const Rb& R, T* k, T gravity) {
  using O = FDQKnot<NJ>;
  const T g[6] = {0, 0, 0, 0, 0, -gravity};
  const RneaView<T> rv{k + O::QD, k + O::QDD, k + O::X,  k + O::V,
                       k + O::A,  k + O::F,   k + O::IV, g};
  const FDView<T> K{k + O::Q,  k + O::QD, k + O::U,    k + O::QDD,
                    k + O::MI, k + O::X,  k + O::F,    k + O::C,
                    k + O::IA, k + O::FM, k + O::UU,   k + O::DINV,
                    k + O::TMP, k + O::XU};
  fd_qdd_knot<T, NJ, false>(par, R, K, rv, R.nlev);
}

// ---------------------------------------------------------------------------
// minv: one knot's state and program, fd's Minv passes alone
// ---------------------------------------------------------------------------

// The knot's input q, its output Minv (NJ, NJ), the joint transforms and
// Minv's IA, F, U, Dinv, temporaries and X^T U: 7 NJ^2 + 122 NJ values
// (1197 at 7 joints, 4.8 KB in float32; 8904 at 28, 35.6 KB | 71.2 KB in
// float32 | float64).
template <int NJ>
struct MinvKnot {
  static constexpr int Q = 0;
  static constexpr int MI = Q + NJ;            // (NJ, NJ)
  static constexpr int X = MI + NJ * NJ;       // (NJ, 36)
  static constexpr int IA = X + 36 * NJ, FM = IA + 36 * NJ;
  static constexpr int UU = FM + 6 * NJ * NJ, DINV = UU + 6 * NJ;
  static constexpr int TMP = DINV + NJ, XU = TMP + 36 * NJ;
  static constexpr int SIZE = XU + 6 * NJ;
};

// Minv of the knot whose q sits at MinvKnot's offsets in `k`
// (dynamics.cuh:minv_lane, split over the knot's threads): the Minv passes
// of fd_qdd_knot (minv_setup_knot, minv_backward_knot, minv_forward_knot),
// then one phase over the entries below the diagonal: DENSE mirrors the
// upper factor there (fd_du's Minv bit for bit), else exact zeros (+0, as
// minv_upper and the JAX minv(dense=False) give; the backward pass leaves
// +-0 there). A tree of L levels takes 4 L phases (iiwa 28, hyq 12, atlas
// 36).
template <bool DENSE, typename T, int NJ, class Rb, class Par>
GT_HD void minv_knot(const Par& par, const Rb& R, T* k) {
  using O = MinvKnot<NJ>;
  constexpr int W = Par::LANES;
  T* Mi = k + O::MI;
  const FDView<T> K{k + O::Q,  nullptr,   nullptr,    nullptr,
                    Mi,        k + O::X,  nullptr,    nullptr,
                    k + O::IA, k + O::FM, k + O::UU,  k + O::DINV,
                    k + O::TMP, k + O::XU};
  const int nlev = R.nlev;
  minv_setup_knot<T, NJ>(par, R, K);
  minv_backward_knot<T, NJ>(par, R, K, nlev, [](Deal<W>&) {});
  minv_forward_knot<T, NJ>(par, R, K, nlev);
  par([&](int t) {
    for (int e = t; e < NJ * NJ; e += W) {
      const int r = e / NJ, cc = e % NJ;
      if (r > cc) Mi[e] = DENSE ? Mi[cc * NJ + r] : T(0);
    }
  });
}

// ---------------------------------------------------------------------------
// crba: one knot's state and program, a level of the tree a phase
// ---------------------------------------------------------------------------

// The knot's input q, its output M (NJ, NJ), the joint transforms, the
// composite inertias Ic (NJ, 36), and two buffers each of the columns'
// composite forces f (NJ, 6) and their current joints J (NJ; a joint id as
// T): NJ^2 + 87 NJ values (658 at 7 joints, 2.6 KB in float32; 3220 at 28,
// 12.9 KB | 25.8 KB in float32 | float64).
template <int NJ>
struct CRBAKnot {
  static constexpr int Q = 0;
  static constexpr int M = Q + NJ;             // (NJ, NJ)
  static constexpr int X = M + NJ * NJ;        // (NJ, 36)
  static constexpr int IC = X + 36 * NJ;       // (NJ, 36)
  static constexpr int F = IC + 36 * NJ;       // (2, NJ, 6)
  static constexpr int J = F + 12 * NJ;        // (2, NJ)
  static constexpr int SIZE = J + 2 * NJ;
};

// M of the knot whose q sits at CRBAKnot's offsets in `k`
// (dynamics.cuh:crba_lane, split over the knot's threads), the serial
// function's bits: every value is summed in crba_lane's order. A first
// phase forms the joint transforms (a joint a thread), Ic = I and M = 0.
// Then one phase a level l from the deepest up to 1 does two things at
// once: (1) each row r of each parent p on level l - 1 adds its children c
// of level l in descending order, Ic_p[r, :] += (X_c^T Ic_c)[r, :] X_c (the
// row of X_c^T Ic_c formed by the row's thread, as XTMX_add forms it); (2)
// every column i of M whose current joint j is on level l (the columns of
// the joints on levels >= l) steps to j's parent p, an entry of f a
// thread: f = X_j^T f, starting from f = Ic_i[:, s_i] at j = i (complete:
// the phase before added its children), then M[p, i] = M[i, p] = f[s_p]
// (and M[i, i] = f[s_i] where the column starts). The steps read one
// buffer of f and J and write the other. A last phase sets M[i, i] of the
// joints on the base. A tree of L levels takes L + 1 phases (iiwa 8, hyq
// 4, atlas 10); a branched tree walks its legs in the same phases.
template <typename T, int NJ, class Rb, class Par>
GT_HD void crba_knot(const Par& par, const Rb& R, T* k) {
  using O = CRBAKnot<NJ>;
  constexpr int W = Par::LANES;
  const T* q = k + O::Q;
  T* M = k + O::M;
  T* X = k + O::X;
  T* Ic = k + O::IC;
  const int nlev = R.nlev;
  par([&](int t) {
    each_joint<NJ, W>(t, [&](int i) {
      joint_xmat(R.Xtree(i), R.jtype[i], R.sind[i], q[i], X + 36 * i);
    });
    for (int e = t; e < 36 * NJ; e += W) Ic[e] = R.Imat(0)[e];
    for (int e = t; e < NJ * NJ; e += W) M[e] = T(0);
  });
  for (int l = nlev - 1; l >= 1; --l) {
    const int w = (nlev - 1 - l) & 1;   // the buffer this phase writes
    T* fw = k + O::F + 6 * NJ * w;
    const T* fr = k + O::F + 6 * NJ * (w ^ 1);
    T* jw = k + O::J + NJ * w;
    const T* jr = k + O::J + NJ * (w ^ 1);
    par([&](int t) {
      Deal<W> d{t, 0};
      children<6>(d, R, l, [&](int p, int r, int ch) {
        const T* Xc = X + 36 * ch;
        T tr[6];
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int m = 0; m < 6; ++m) tr[m] = xcol(Xc, Ic + 36 * ch + m, r, 6);
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int cc = 0; cc < 6; ++cc) {
          T acc = tr[0] * Xc[cc];
          for (int m = 1; m < 6; ++m) acc += tr[m] * Xc[m * 6 + cc];
          Ic[36 * p + r * 6 + cc] += acc;
        }
      });
      const int c0 = R.lstart[l], c1 = R.lstart[l + 1];
      d((NJ - c0) * 6, [&](int e) {
        const int n = c0 + e / 6, r = e % 6;
        const int i = R.ljoint[n];
        const bool start = n < c1;   // i on level l: its column starts
        const int j = start ? i : (int)jr[i];
        const int p = R.parent[j];
        const T x = start ? xcol(X + 36 * j, Ic + 36 * i + R.sind[i], r, 6)
                          : xcol(X + 36 * j, fr + 6 * i, r);
        fw[6 * i + r] = x;
        if (r == R.sind[p]) {
          M[p * NJ + i] = x;
          M[i * NJ + p] = x;
        }
        if (r == 0) {
          jw[i] = T(p);
          if (start) M[i * NJ + i] = Ic[36 * i + R.sind[i] * 7];
        }
      });
    });
  }
  par([&](int t) {
    for (int n = t; n < R.lstart[1]; n += W) {
      const int i = R.ljoint[n];
      M[i * NJ + i] = Ic[36 * i + R.sind[i] * 7];
    }
  });
}

// ---------------------------------------------------------------------------
// id_du: one knot's state and program, fd_du's without Minv
// ---------------------------------------------------------------------------

// The knot's inputs q, qd, qdd, its output dc/du (NJ, 2 NJ), the joint
// transforms, v, a, f, I v and the columns' state (NJ, 18, 2 NJ / PASSES):
// 20 NJ^2 + 63 NJ values with two passes (1421 at 7 joints, 6128 at 16),
// 38 NJ^2 + 63 NJ with one.
template <int NJ, int PASSES>
struct IDUKnot {
  static constexpr int NC = 2 * NJ, COLS = NC / PASSES;
  static constexpr int Q = 0, QD = Q + NJ, QDD = QD + NJ;
  static constexpr int DC = QDD + NJ;          // (NJ, 2 NJ) dc/d[q, qd]
  static constexpr int X = DC + NJ * NC;       // (NJ, 36)
  static constexpr int V = X + 36 * NJ, A = V + 6 * NJ, F = A + 6 * NJ;
  static constexpr int IV = F + 6 * NJ;
  static constexpr int COL = IV + 6 * NJ;      // (NJ, 18, COLS)
  static constexpr int SIZE = COL + 18 * NJ * COLS;
};

// The column passes of id_du: one pass of 2 NJ columns runs the q and qd
// columns side by side, where each of two passes leaves half the knot's
// column threads idle (compare_kernels.py times both; PERF.md). Above 16
// joints two passes: a one-pass knot of 28 joints (38 NJ^2 + 63 NJ values)
// does not fit a block's shared memory in float64, and two passes ran
// faster wherever knots an SM set the rate.
template <int NJ>
GT_HDI constexpr int idu_passes() { return NJ > 16 ? 2 : 1; }

// dc/d[q, qd] of the knot whose q, qd, qdd sit at IDUKnot's offsets in `k`
// (dynamics.cuh:id_du_lane, split over the knot's threads): the joint
// transforms a joint a thread, one RNEA forward at qdd that also forms
// I v, the backward accumulation, then the ID-gradient columns, each
// column's dc stored by its thread.
template <typename T, int NJ, int PASSES, class Rb, class Par>
GT_HD void id_du_knot(const Par& par, const Rb& R, T* k, T gravity) {
  using O = IDUKnot<NJ, PASSES>;
  static_assert(NJ <= Par::LANES, "a thread per joint");
  par([&](int t) {
    if (t < NJ)
      joint_xmat(R.Xtree(t), R.jtype[t], R.sind[t], k[O::Q + t],
                 k + O::X + 36 * t);
  });
  const int nlev = R.nlev;
  const T g[6] = {0, 0, 0, 0, 0, -gravity};
  const RneaView<T> rv{k + O::QD, k + O::QDD, k + O::X, k + O::V,
                       k + O::A,  k + O::F,   k + O::IV, g};
  rnea_forward_knot<RNEA_FULL, T, NJ>(par, R, rv, nlev);
  rnea_backward_knot<T>(par, R, rv, nlev);
  id_grad_columns_knot<T, NJ, O, PASSES>(par, R, k, gravity,
                                         [&](int pass, int t, const T* dc) {
    for (int r = 0; r < NJ; ++r)
      k[O::DC + r * O::NC + pass * O::COLS + t] = dc[r];
  });
}

// ---------------------------------------------------------------------------
// rnea: one knot's state and program, id_du's RNEA passes alone
// ---------------------------------------------------------------------------

// The knot's inputs q, qd, qdd (absent in the bias form), its output c, the
// joint transforms (NJ, 36), v, a, f and I v (NJ, 6 each): 64 NJ values
// (448 at 7 joints, 1.8 KB in float32).
template <int NJ>
struct RNEAKnot {
  static constexpr int Q = 0, QD = Q + NJ, QDD = QD + NJ, C = QDD + NJ;
  static constexpr int X = C + NJ, V = X + 36 * NJ, A = V + 6 * NJ;
  static constexpr int F = A + 6 * NJ, IV = F + 6 * NJ;
  static constexpr int SIZE = IV + 6 * NJ;
};

// c = RNEA(q, qd, qdd) (MODE RNEA_FULL) or the bias c(q, qd) (RNEA_BIAS)
// of the knot whose inputs sit at RNEAKnot's offsets in `k`
// (dynamics.cuh:rnea_lane, split over the knot's threads): the joint
// transforms a joint a thread; the forward pass, a level a phase, a row of
// each joint's v and a a thread, then I v and f a joint a thread; the
// backward accumulation of f into the parents, a level a phase; c_i =
// f_i[S_i] + damping_i qd_i a joint a thread. A tree of L levels takes
// 2 L + 3 phases (iiwa 17, hyq 9, atlas 21). Every value is the serial
// code's (rnea_forward_knot, rnea_backward_knot).
template <RneaMode MODE, typename T, int NJ, class Rb, class Par>
GT_HD void rnea_knot(const Par& par, const Rb& R, T* k, T gravity) {
  using O = RNEAKnot<NJ>;
  static_assert(MODE != RNEA_AT_QDD, "rnea forms v and I v itself");
  constexpr int W = Par::LANES;
  T* X = k + O::X;
  const T* qd = k + O::QD;
  const T* f = k + O::F;
  T* c = k + O::C;
  par([&](int t) {
    for (int i = t; i < NJ; i += W)
      joint_xmat(R.Xtree(i), R.jtype[i], R.sind[i], k[O::Q + i], X + 36 * i);
  });
  const int nlev = R.nlev;
  const T g[6] = {0, 0, 0, 0, 0, -gravity};
  const RneaView<T> rv{k + O::QD, k + O::QDD, X, k + O::V,
                       k + O::A,  k + O::F,   k + O::IV, g};
  rnea_forward_knot<MODE, T, NJ>(par, R, rv, nlev);
  rnea_backward_knot<T>(par, R, rv, nlev);
  par([&](int t) {
    for (int i = t; i < NJ; i += W)
      c[i] = f[6 * i + R.sind[i]] + R.damping(i) * qd[i];
  });
}

// ---------------------------------------------------------------------------
// fdsva_so: one knot's state. FDKnot's inputs and outputs stay; its work
// space is taken over, once fd_du is done, by the IDSVA-SO stage quantities
// and the knot's whole (4, NJ, NJ, NJ) tensor.
// ---------------------------------------------------------------------------

template <int NJ>
struct SOKnot {
  using FD = FDKnot<NJ>;
  static constexpr int N3 = NJ * NJ * NJ;
  // IDSVA-SO's inputs: q, qd and fd_du's qdd
  static constexpr int Q = FD::Q, QD = FD::QD, QDD = FD::QDD;
  static constexpr int STG = FD::SCR;          // SOStages<T, NJ>
  static constexpr int XJ = STG + 126 * NJ;    // (NJ, 36) joint transforms
  static constexpr int XUP = XJ + 36 * NJ;     // (NJ, 36) world transforms
  static constexpr int V = XUP + 36 * NJ, A = V + 6 * NJ, F = A + 6 * NJ;
  static constexpr int ICV = F + 6 * NJ;       // (NJ, 6) IC v
  // (4, NJ, NJ, NJ), so.cuh's layout: over XJ .. ICV, which only the stage
  // quantities' own phases use
  static constexpr int TILE = XJ;
  static constexpr int STAGES_END = ICV + 6 * NJ, TILE_END = TILE + 4 * N3;
  static constexpr int END = STAGES_END > TILE_END ? STAGES_END : TILE_END;
  static constexpr int SIZE = END > FD::SIZE ? END : FD::SIZE;
};

// idsva_so: one knot's state. Its inputs q, qd, qdd, then SOStages and the
// tile over XJ .. ICV, laid out as in SOKnot, with no fd_du work space:
// 3 NJ + 126 NJ + 4 NJ^3 values (2275 at 7 joints, 18448 at 16).
template <int NJ>
struct IDKnot {
  static constexpr int N3 = NJ * NJ * NJ;
  static constexpr int Q = 0, QD = Q + NJ, QDD = QD + NJ;
  static constexpr int STG = QDD + NJ;
  static constexpr int XJ = STG + 126 * NJ;
  static constexpr int XUP = XJ + 36 * NJ;
  static constexpr int V = XUP + 36 * NJ, A = V + 6 * NJ, F = A + 6 * NJ;
  static constexpr int ICV = F + 6 * NJ;
  static constexpr int TILE = XJ;
  static constexpr int STAGES_END = ICV + 6 * NJ, TILE_END = TILE + 4 * N3;
  static constexpr int SIZE = STAGES_END > TILE_END ? STAGES_END : TILE_END;
};

// idsva_so in bands: IDKnot's inputs and stage quantities, a tile of ROWS
// rows (c, i) of NJ^2 values over XJ .. ICV, then a sink for each of the
// knot's LANES threads (warp.cuh:idsva_so_knot).
template <int NJ>
GT_HDI constexpr int idband_size(int rows, int lanes) {
  using K = IDKnot<NJ>;
  const int tile_end = K::TILE + rows * NJ * NJ;
  return (K::STAGES_END > tile_end ? K::STAGES_END : tile_end) + lanes;
}
template <int NJ, int ROWS, int LANES>
struct IDBandKnot : IDKnot<NJ> {
  static constexpr int SINK = idband_size<NJ>(ROWS, 0);
  static constexpr int SIZE = SINK + LANES;
};

// The (j, a, st) triples of for_triples and the (j, a) pairs, packed
// j | a << 8 | st << 16, in for_triples' order, and the pairs x <= y of
// the contractions; built once per block, in arrays sized for a chain.
template <int NJ>
struct SOLists {
  static constexpr int MAX_TRIPLES = NJ * (NJ + 1) * (NJ + 2) / 6;
  static constexpr int MAX_PAIRS = NJ * (NJ + 1) / 2;
  int ntrip, npair;
  int trip[MAX_TRIPLES];
  int pair[MAX_PAIRS];
  int sym[MAX_PAIRS];   // x | y << 8, x <= y: the contractions' pairs

  template <class Rb>
  GT_HD void build(const Rb& R) {
    int n = 0;
    for (int y = 0; y < NJ; ++y)
      for (int x = 0; x <= y; ++x) sym[n++] = x | y << 8;
    ntrip = npair = 0;
    for (int j = 0; j < NJ; ++j)
      for (int a = 0; a <= j; ++a) {
        if (R.subtree(a, j) == 0) continue;
        pair[npair++] = j | a << 8;
        for (int st = j; st < NJ; ++st)
          if (R.subtree(j, st) != 0) trip[ntrip++] = j | a << 8 | st << 16;
      }
  }
};

// The same triples and pairs sized by the robot, read where they lie (the
// device-memory tile's kernel: a buffer built once per model on the host,
// so_lists_host, ntrip triples then npair pairs).
struct SOListView {
  int ntrip, npair;
  const int* trip;
  const int* pair;
};

// The robot's (j, a, st) triples, then its (j, a) pairs, as SOLists
// builds them, on the host: the device-memory tile's lists (the library
// exports them, csrc/idsva_so.cu:gridtorch_so_lists, and
// ops/cuda/build.py:so_lists copies them to the card; the host drivers
// build theirs here too)
template <int NJ, class Rb>
std::vector<int> so_lists_host(const Rb& R, int* ntrip, int* npair) {
  std::vector<SOLists<NJ>> lists(1);
  lists[0].build(R);
  *ntrip = lists[0].ntrip;
  *npair = lists[0].npair;
  std::vector<int> out(lists[0].trip, lists[0].trip + *ntrip);
  out.insert(out.end(), lists[0].pair, lists[0].pair + *npair);
  return out;
}

// so.cuh's so_stages, split over the knot's threads: a phase a level of the
// tree, parallel over the 6 or 36 entries of each joint's quantities. O is
// the knot's layout (SOKnot, IDKnot).
template <typename T, int NJ, class O, class Rb, class Par>
GT_HD void so_stages_knot(const Par& par, const Rb& R, T* k, T gravity) {
  constexpr int W = Par::LANES;
  const T* q = k + O::Q;
  const T* qd = k + O::QD;
  const T* qdd = k + O::QDD;
  SOStages<T, NJ>& s = *reinterpret_cast<SOStages<T, NJ>*>(k + O::STG);
  T* XJ = k + O::XJ;
  T* Xup = k + O::XUP;
  T* v = k + O::V;
  T* a = k + O::A;
  T* f = k + O::F;
  T* ICv = k + O::ICV;
  const T g[6] = {0, 0, 0, 0, 0, -gravity};

  par([&](int t) {
    if (t < NJ)
      joint_xmat(R.Xtree(t), R.jtype[t], R.sind[t], q[t], XJ + 36 * t);
  });
  for (int l = 0; l < R.nlev; ++l) {   // Xup_i = X_i Xup_p, a level a phase
    par([&](int t) {
      Deal<W> d{t, 0};
      level<36>(d, R, l, [&](int i, int e) {
        const int p = R.parent[i], r = e / 6, c = e % 6;
        const T* Xi = XJ + 36 * i;
        if (p == -1) {
          Xup[36 * i + e] = Xi[e];
        } else {
          const T* Xp = Xup + 36 * p;
          T acc = Xi[r * 6] * Xp[c];
          for (int m = 1; m < 6; ++m) acc += Xi[r * 6 + m] * Xp[m * 6 + c];
          Xup[36 * i + e] = acc;
        }
      });
    });
  }
  // S = column S_ind of Xup^-1; Xup^T I into XJ
  par([&](int t) {
    for (int e = t; e < 6 * NJ; e += W)
      s.S[e / 6][e % 6] = xinv_motion(Xup + 36 * (e / 6), e % 6,
                                      R.sind[e / 6]);
    for (int e = t; e < 36 * NJ; e += W) {
      const int i = e / 36, r = (e % 36) / 6, c = e % 6;
      const T* X = Xup + 36 * i;
      const T* I = R.Imat(i);
      T acc = X[r] * I[c];
      for (int m = 1; m < 6; ++m) acc += X[m * 6 + r] * I[m * 6 + c];
      XJ[e] = acc;
    }
  });
  par([&](int t) {   // IC = Xup^T I Xup
    for (int e = t; e < 36 * NJ; e += W) {
      const int i = e / 36, r = (e % 36) / 6, c = e % 6;
      const T* tm = XJ + 36 * i;
      const T* X = Xup + 36 * i;
      T acc = tm[r * 6] * X[c];
      for (int m = 1; m < 6; ++m) acc += tm[r * 6 + m] * X[m * 6 + c];
      s.IC[i][r * 6 + c] = acc;
    }
  });
  // From here on a joint a thread, its 6-vectors whole in registers:
  // split by row, every thread would form the whole cross product for its
  // one entry. v, a and psi-dot along the tree, a level a phase:
  for (int l = 0; l < R.nlev; ++l) {
    par([&](int t) {
      Deal<W> d{t, 0};
      level<1>(d, R, l, [&](int i, int) {
        const int p = R.parent[i];
        const T* S = s.S[i];
        T vJ[6], vi[6], ai[6], ps[6];
        for (int m = 0; m < 6; ++m) vJ[m] = S[m] * qd[i];
        if (p == -1) {
          for (int m = 0; m < 6; ++m) {
            vi[m] = vJ[m];
            ai[m] = g[m] + S[m] * qdd[i];
            ps[m] = T(0);
          }
        } else {
          T c[6];
          cross_mv(v + 6 * p, vJ, c);
          for (int m = 0; m < 6; ++m) {
            vi[m] = v[6 * p + m] + vJ[m];
            ai[m] = a[6 * p + m] + (S[m] * qdd[i] + c[m]);
          }
          cross_mv(v + 6 * p, S, ps);
        }
        for (int m = 0; m < 6; ++m) {
          v[6 * i + m] = vi[m];
          a[6 * i + m] = ai[m];
          s.psid[i][m] = ps[m];
        }
      });
    });
  }
  par([&](int t) {   // psi-ddot, S-dot, IC v
    for (int i = t; i < NJ; i += W) {
      const int p = R.parent[i];
      const T* S = s.S[i];
      T o[6], o2[6];
      if (p == -1) {
        cross_mv(g, S, o);
        for (int m = 0; m < 6; ++m) s.psidd[i][m] = o[m];
      } else {
        cross_mv(a + 6 * p, S, o);
        cross_mv(v + 6 * p, s.psid[i], o2);
        for (int m = 0; m < 6; ++m) s.psidd[i][m] = o[m] + o2[m];
      }
      cross_mv(v + 6 * i, S, o);
      for (int m = 0; m < 6; ++m) s.Sd[i][m] = o[m];
      Xv(s.IC[i], v + 6 * i, o);
      for (int m = 0; m < 6; ++m) ICv[6 * i + m] = o[m];
    }
  });
  // BC = crf(v) IC + icrf(IC v) - IC crm(v), a column c of a joint a
  // thread: column c of crm(v) is crm(v) e_c, of icrf(IC v) crf(e_c) IC v;
  // f = IC a + crf(v) IC v, a joint a thread
  par([&](int t) {
    for (int e = t; e < 6 * NJ; e += W) {
      const int i = e / 6, c = e % 6;
      const T* vi = v + 6 * i;
      const T* IC = s.IC[i];
      T ec[6], cm[6], ci[6];
      unit6(c, ec);
      cross_mv(vi, ec, cm);
      cross_fv(ec, ICv + 6 * i, ci);
#ifdef __CUDACC__
#pragma unroll
#endif
      for (int r = 0; r < 6; ++r) {
        T a1 = -crm_rc(vi, 0, r) * IC[c];
        for (int m = 1; m < 6; ++m) a1 += -crm_rc(vi, m, r) * IC[m * 6 + c];
        T a3 = IC[r * 6] * cm[0];
        for (int m = 1; m < 6; ++m) a3 += IC[r * 6 + m] * cm[m];
        s.BC[i][r * 6 + c] = a1 + ci[r] - a3;
      }
    }
    for (int i = t; i < NJ; i += W) {
      T Ia[6], c[6];
      Xv(s.IC[i], a + 6 * i, Ia);
      cross_fv(v + 6 * i, ICv + 6 * i, c);
      for (int m = 0; m < 6; ++m) f[6 * i + m] = Ia[m] + c[m];
    }
  });
  // composite IC, BC, f: each parent's entry adds in its children, a level
  // a phase
  for (int l = R.nlev - 1; l >= 1; --l) {
    par([&](int t) {
      Deal<W> d{t, 0};
      children<78>(d, R, l, [&](int p, int e, int c) {
        if (e < 36) s.IC[p][e] += s.IC[c][e];
        else if (e < 72) s.BC[p][e - 36] += s.BC[c][e - 36];
        else f[6 * p + e - 72] += f[6 * c + e - 72];
      });
    });
  }
  par([&](int t) {   // T1-T4 and IC psi-dot
    for (int i = t; i < NJ; i += W) {
      const T* S = s.S[i];
      T ps[6], t1[6], t2[6], t3[6];
      for (int n = 0; n < 6; ++n) ps[n] = s.psid[i][n] + s.Sd[i][n];
      Xv(s.IC[i], S, t1);
      for (int m = 0; m < 6; ++m) s.T1[i][m] = t1[m];
      Xv(s.IC[i], s.psid[i], t1);
      for (int m = 0; m < 6; ++m) s.ICpsid[i][m] = t1[m];
      XTv(s.BC[i], S, t1);
      for (int m = 0; m < 6; ++m) s.T2[i][m] = -t1[m];
      Xv(s.BC[i], s.psid[i], t1);
      Xv(s.IC[i], s.psidd[i], t2);
      cross_fv(S, f + 6 * i, t3);
      for (int m = 0; m < 6; ++m) s.T3[i][m] = t1[m] + t2[m] + t3[m];
      Xv(s.BC[i], S, t1);
      Xv(s.IC[i], ps, t2);
      for (int m = 0; m < 6; ++m) s.T4[i][m] = t1[m] + t2[m];
    }
  });
}

// IDSVA-SO of the knot whose q, qd, qdd sit at O's offsets in `k` (O:
// SOKnot, qdd from fd_du; IDKnot, qdd an input), into its tile (O::TILE,
// so.cuh's layout with lane stride 1): the stage quantities, then the nine
// stages of so.cuh's SOBody, each stage split over the (j, a, st) triples
// (a triple a thread), then the pair corrections (a (j, a) pair a thread,
// its st loop serial). No two triples of one stage, and no two pairs,
// touch the same entry: each stage writes entries indexed by the triple's
// own (j, a, st) with a <= j <= st, and the writes of two triples would
// coincide only where the stage's own conditions (a < j, j != st) exclude
// them. Entries written by more than one stage, or twice in one, keep the
// algorithm's order: the stages run in turn, and all of one triple's
// writes are one thread's, in program order. The host build checks this
// (GT_RACE_CHECK: no entry touched by two threads of one phase).
// Force-inlined: fdsva_so then compiles to the machine code of the program
// written out in fdsva_so_knot (a call boundary moved its registers).
template <typename T, int NJ, class DOp, class View, class Lists, class Rb,
          class Par>
GT_HDI void so_triples_knot(const Par& par, const Rb& R, const Lists& lists,
                            const SOStages<T, NJ>& s, const DOp& D,
                            View view) {
  constexpr int W = Par::LANES;
  using Out = decltype(view(0));
  for (int stage = 1; stage <= 9; ++stage) {
    par([&](int t) {
      const Out o = view(t);
      const SOBody<T, NJ, DOp, Out> body{s, o, D, stage};
      for (int n = t; n < lists.ntrip; n += W) {
        const int w = lists.trip[n];
        body(w & 255, (w >> 8) & 255, w >> 16);
      }
    });
  }
  par([&](int t) {
    const Out o = view(t);
    for (int n = t; n < lists.npair; n += W) {
      const int w = lists.pair[n];
      so_pair_corrections(R, s, o, w & 255, w >> 8);
    }
  });
}

// ROWS < 4 NJ: the tile holds one band of ROWS rows (c, i) from row r0
// (so.cuh:SOBand), and each thread t sends the writes outside it to its
// sink, k[O::SINK + t]. Every triple and pair runs in every band: a band's
// block repeats the stage quantities and the work whose writes fall in
// other bands (csrc/opcount.cpp counts it as executed).
template <typename T, int NJ, class O,
          template <typename, int> class DOp = DFormed, int ROWS = 4 * NJ,
          class Rb, class Par>
GT_HDI void idsva_so_knot(const Par& par, const Rb& R,
                          const SOLists<NJ>& lists, T* k, T gravity,
                          int r0 = 0) {
  constexpr int W = Par::LANES;
  so_stages_knot<T, NJ, O>(par, R, k, gravity);
  const SOStages<T, NJ>& s =
      *reinterpret_cast<const SOStages<T, NJ>*>(k + O::STG);
  T* tile = k + O::TILE;
  par([&](int t) {
    for (int e = t; e < ROWS * NJ * NJ; e += W) tile[e] = T(0);
  });
  const DOp<T, NJ> D{s};
  if constexpr (ROWS == 4 * NJ) {
    so_triples_knot<T, NJ>(par, R, lists, s, D, [=](int) {
      return SOOut<T, NJ>{tile, 1};
    });
  } else {
    T* sink = k + O::SINK;
    so_triples_knot<T, NJ>(par, R, lists, s, D, [=](int t) {
      return SOBand<T, NJ, ROWS>{tile, sink + t, r0};
    });
  }
}

// IDSVA-SO of the knot whose inputs and stage quantities sit in `k`
// (IDKnot's layout up to STAGES_END: no tile there) into `out`, the lane's
// entry (0, 0, 0, 0) of a lane-major output zeroed beforehand, lane stride
// L: the stage quantities in k, then the stages and the corrections
// read-modify-write their entries in device memory, as idsva_so_lane does.
// Each (j, a, st) triple and (j, a) pair runs once.
template <typename T, int NJ, class Lists, class Rb, class Par>
GT_HDI void idsva_so_knot_to(const Par& par, const Rb& R, const Lists& lists,
                             T* k, T gravity, T* out, long long L) {
  using O = IDKnot<NJ>;
  so_stages_knot<T, NJ, O>(par, R, k, gravity);
  const SOStages<T, NJ>& s =
      *reinterpret_cast<const SOStages<T, NJ>*>(k + O::STG);
  const DFormed<T, NJ> D{s};
  so_triples_knot<T, NJ>(par, R, lists, s, D,
                         [=](int) { return SOOut<T, NJ>{out, L}; });
}

// FDSVA-SO of the knot whose q, qd, u sit at FDKnot's offsets in `k`, into
// its tile (SOKnot::TILE, so.cuh's layout with lane stride 1):
// 1. fd_du_knot: df/du, qdd and Minv;
// 2. idsva_so_knot at (q, qd, qdd), over SOKnot's layout;
// 3. The contractions of ops/so.py:fdsva_compose, a (c, j, k) column a
//    thread: (a) inner_q and inner_cross in place from dM (slice 3, read
//    only); (b) -Minv inner_c for c < 3, and G = Minv dM[:, p, k] for
//    slice 3, each in place on its own column; (c) slice 3 = -G Minv, in
//    place on the (i, :, k) row of G a thread.
template <typename T, int NJ, template <typename, int> class DOp = DFormed,
          class Rb, class Par>
GT_HD void fdsva_so_knot(const Par& par, const Rb& R, const SOLists<NJ>& lists,
                         T* k, T gravity) {
  using O = SOKnot<NJ>;
  constexpr int W = Par::LANES;
  constexpr int N2 = NJ * NJ;
  constexpr int NC = 2 * NJ;
  fd_du_knot<T, NJ>(par, R, k, gravity);
  idsva_so_knot<T, NJ, O, DOp>(par, R, lists, k, gravity);
  T* tile = k + O::TILE;
  const T* Mi = k + O::FD::MI;
  const T* dfdu = k + O::FD::DFDU;
  const SOOut<T, NJ> o{tile, 1};
  // (a) slice 0: Ts + C[m,x,y] + C[m,y,x], a pair x <= y a thread, which
  //     forms C[m,x,y] and C[m,y,x] once for both entries; slice 2 at (m,
  //     x, y): Ts + D[m,y,x], an entry a thread; with (C, D)[m,j,k] =
  //     sum_p Ts(3,m,p,j) (dfdq, dfdqd)[p,k]
  // slice 3 is only read here, by every thread (not through o.at, which the
  // host build's race check watches)
  auto ts3 = [&](int m, int p, int j) -> T {
    return tile[((3 * NJ + m) * NJ + p) * NJ + j];
  };
  par([&](int t) {
    Deal<W> d{t, 0};
    d(SOLists<NJ>::MAX_PAIRS, [&](int n) {
      const int x = lists.sym[n] & 255, y = lists.sym[n] >> 8;
      for (int m = 0; m < NJ; ++m) {
        T c1 = ts3(m, 0, x) * dfdu[y], c2 = ts3(m, 0, y) * dfdu[x];
        for (int p = 1; p < NJ; ++p) {
          c1 += ts3(m, p, x) * dfdu[p * NC + y];
          c2 += ts3(m, p, y) * dfdu[p * NC + x];
        }
        o.at(0, m, x, y) = o.at(0, m, x, y) + c1 + c2;
        if (x != y) o.at(0, m, y, x) = o.at(0, m, y, x) + c2 + c1;
      }
    });
    d(N2, [&](int e) {
      const int x = e / NJ, y = e % NJ;
      for (int m = 0; m < NJ; ++m) {
        T cd = ts3(m, 0, y) * dfdu[NJ + x];
        for (int p = 1; p < NJ; ++p)
          cd += ts3(m, p, y) * dfdu[p * NC + NJ + x];
        o.at(2, m, x, y) += cd;
      }
    });
  });
  // (b) out_c[:, x, y] = -Minv inner_c[:, x, y] (c < 3); G[:, x, y] =
  //     Minv Ts(3, :, x, y)
  par([&](int t) {
    for (int e = t; e < 4 * N2; e += W) {
      const int c = e / N2, x = (e % N2) / NJ, y = e % NJ;
      T cv[NJ];
#ifdef __CUDACC__
#pragma unroll
#endif
      for (int m = 0; m < NJ; ++m) cv[m] = o.at(c, m, x, y);
      for (int i = 0; i < NJ; ++i) {
        T acc = Mi[i * NJ] * cv[0];
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int m = 1; m < NJ; ++m) acc += Mi[i * NJ + m] * cv[m];
        o.at(c, i, x, y) = c < 3 ? -acc : acc;
      }
    }
  });
  // (c) slice 3 at (i, J, K) = -sum_p G(i, p, K) Minv[p, J]
  par([&](int t) {
    for (int e = t; e < N2; e += W) {
      const int i = e / NJ, kk = e % NJ;
      T gv[NJ];
#ifdef __CUDACC__
#pragma unroll
#endif
      for (int p = 0; p < NJ; ++p) gv[p] = o.at(3, i, p, kk);
      for (int jj = 0; jj < NJ; ++jj) {
        T acc = gv[0] * Mi[jj];
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int p = 1; p < NJ; ++p) acc += gv[p] * Mi[p * NJ + jj];
        o.at(3, i, jj, kk) = -acc;
      }
    }
  });
}

// ---------------------------------------------------------------------------
// d2eepos: a group of threads a lane, its EE chain's state in shared memory
// ---------------------------------------------------------------------------

// The block's head: the joints' Ttree and type, and the EE the block is
// at: its fixed frame and its chain (joints ascending, root to leaf;
// pos[j] a joint's place in it, -1 off it). Every lane of a block is at
// the same EE. TWISTS: also each joint's constant twist (d2eepos; eepos
// reads none).
template <typename T, int NJ, bool TWISTS = true>
struct EEHead {
  T tt[16 * NJ];
  // each joint's twist (omega, v) Lambda = Ttree K Ttree^-1 of its
  // generator K: a revolute joint's axis e_ax (omega = R e_ax, v = p x
  // omega), a prismatic one's e_sind-3 (omega = 0, v = R e); Ttree = [R p;
  // 0 1]
  T lam[TWISTS ? 6 * NJ : 1];
  T tfix[16];
  int jtype[NJ];
  int sind[NJ];
  int k;
  int chain[NJ];
  int pos[NJ];

  GT_HD void load(const T* model, int tid, int nthreads) {
    using L = Layout<NJ>;
    for (int e = tid; e < 16 * NJ; e += nthreads) tt[e] = model[L::TTREE + e];
    for (int i = tid; i < NJ; i += nthreads) {
      jtype[i] = (int)model[L::JTYPE + i];
      sind[i] = (int)model[L::SIND + i];
      if (!TWISTS) continue;
      const T* TT = model + L::TTREE + 16 * i;
      const int ax = sind[i] % 3;
      T* o = lam + 6 * i;
      for (int r = 0; r < 3; ++r) {
        o[r] = jtype[i] == 0 ? TT[r * 4 + ax] : T(0);
        o[3 + r] = jtype[i] == 0 ? T(0) : TT[r * 4 + ax];
      }
      if (jtype[i] == 0)
        for (int r = 0; r < 3; ++r) {
          const int a = (r + 1) % 3, b = (r + 2) % 3;
          o[3 + r] = TT[a * 4 + 3] * o[b] - TT[b * 4 + 3] * o[a];
        }
    }
  }
  // the EE of row `row` (EERow<NJ>), a joint's place in its chain a thread
  GT_HD void select(const T* row, int tid, int nthreads) {
    using E = EERow<NJ>;
    for (int e = tid; e < 16; e += nthreads) tfix[e] = row[E::TFIX + e];
    for (int j = tid; j < NJ; j += nthreads) {
      int before = 0;
      for (int i = 0; i < j; ++i) before += row[E::CHAIN + i] != T(0) ? 1 : 0;
      const bool on = row[E::CHAIN + j] != T(0);
      pos[j] = on ? before : -1;
      if (on) chain[before] = j;
      if (j == NJ - 1) k = before + (on ? 1 : 0);
    }
  }
};

// Ttree J for J the joint's motion T_j(q), dT_j/dq or d2T_j/dq2 (`which`
// 0, 1, 2; dynamics.cuh's joint_T, joint_dT, joint_d2T), by columns of
// Ttree: a revolute joint turns the plane (p, r) = ((ax + 1) % 3, (ax + 2)
// % 3) of its axis ax, J[p][p] = J[r][r] = d^w cos, J[r][p] = -J[p][r] =
// d^w sin, J[ax][ax] = J[3][3] = [w == 0]; a prismatic one moves along
// sind - 3. Each entry is its two or one non-zero products, in registers.
template <typename T>
GT_HDI void joint_mat(const T* TT, int jtype, int sind, int which, T qi,
                      T* out) {
  const T one = which == 0 ? T(1) : T(0);
  if (jtype == 0) {
    const T co = gcos(qi), si = gsin(qi);
    const T cw = which == 0 ? co : which == 1 ? -si : -co;
    const T sw = which == 0 ? si : which == 1 ? co : -si;
    const int ax = sind % 3, p = (ax + 1) % 3, r = (ax + 2) % 3;
    for (int i = 0; i < 4; ++i) {
      const T tp = TT[i * 4 + p], tr = TT[i * 4 + r];
      out[i * 4 + ax] = TT[i * 4 + ax] * one;
      out[i * 4 + p] = tp * cw + tr * sw;
      out[i * 4 + r] = tr * cw - tp * sw;
      out[i * 4 + 3] = TT[i * 4 + 3] * one;
    }
  } else {
    const int tr = sind - 3;
    for (int i = 0; i < 4; ++i) {
      for (int c = 0; c < 3; ++c) out[i * 4 + c] = TT[i * 4 + c] * one;
      out[i * 4 + 3] = which == 0   ? TT[i * 4 + 3] + qi * TT[i * 4 + tr]
                       : which == 1 ? TT[i * 4 + tr]
                                    : T(0);
    }
  }
}

// One lane's state at one EE, by chain position a < k: q; the joint
// transforms T_a (4x4); the prefixes pre_a = T_0 ... T_a-1 (a = 2 .. k -
// 1; pre_1 is T_0), rows 0-2; the suffixes suf_a = T_a+1 ... T_k-1 Tfix
// (a <= k - 2; suf_k-1 is Tfix); the twists xi_a = Ad(pre_a) lambda_a
// (omega, v) of dT/dq_a = Xi_a F (Xi_a = [skew(omega) v; 0 0] = pre_a dT_a
// T_a^-1 pre_a^-1); rows 0-2 of dTf_a = Xi_a F; rows 0-2 of the chain's
// full transform F = T_0 suf_0; and the lane's (6, NJ, NJ) Hessian block
// of the EE by chain positions: 63 NJ + 6 NJ^2 + 12 values (747 at 7
// joints, 2556 at 16).
template <int NJ>
struct D2Knot {
  static constexpr int Q = 0;
  static constexpr int TS = Q + NJ, PRE = TS + 16 * NJ, SUF = PRE + 12 * NJ;
  static constexpr int XI = SUF + 16 * NJ, DTF = XI + 6 * NJ;
  static constexpr int FULL = DTF + 12 * NJ;
  static constexpr int TILE = FULL + 12;
  static constexpr int SIZE = TILE + 6 * NJ * NJ;
};

// entry (r, c) of A B, 4x4 (dynamics.cuh:mm44's arithmetic)
template <typename T>
GT_HDI T mm44_rc(const T* A, const T* B, int r, int c) {
  T acc = A[r * 4] * B[c];
  for (int m = 1; m < 4; ++m) acc += A[r * 4 + m] * B[m * 4 + c];
  return acc;
}

// component r of (a x b), 3-vectors at strides sa, sb
template <typename T>
GT_HDI T cross3_r(const T* a, int sa, const T* b, int sb, int r) {
  const int i = (r + 1) % 3, j = (r + 2) % 3;
  return a[i * sa] * b[j * sb] - a[j * sa] * b[i * sb];
}

// The state of one lane at one EE that ee_twist_knot reads and writes, by
// chain position (D2Knot's or DJKnot's offsets): q, the joint transforms,
// the prefixes, the suffixes, the twists xi_a, rows 0-2 of dTf_a = Xi_a F
// and rows 0-2 of F.
template <typename T>
struct EETwistView {
  const T* q;
  T* TS;
  T* PRE;
  T* SUF;
  T* XI;
  T* DTF;
  T* FULL;
};

// The pose's first derivatives of one lane at the block's EE (H.select, a
// chain of k >= 1 joints) in the twist form, at the caller's view V: the
// first k + 2 phases of d2eepos_knot and deepos_knot. F = T_0 ... T_k-1
// Tfix, the chain's full transform, is formed as the chain form forms it,
// T_0 suf_0 (formed as pre_k Tfix, F's float32 rounding moved the Hessian
// of a near-singular pose, where atan2's 1/r^3 terms amplify it, far from
// the plain version's). A joint's derivative is dT_a = Lambda_a T_a, with
// Lambda_a = Ttree K Ttree^-1 a constant twist of the joint (EEHead::lam;
// K its generator), so with Xi_a = pre_a Lambda_a pre_a^-1: dF/dq_a = Xi_a
// F (the chain form's pre_a dT_a suf_a). Split over the group's threads:
// 1. T_a, a chain joint's matrix a thread (joint_mat);
// 2. k - 1 phases of the prefix and suffix products, an entry a thread;
// 3. xi_a = Ad(pre_a) lambda_a, a component a thread, and F;
// 4. dTf_a = Xi_a F, rows 0-2, an entry a thread (omega_a x F's columns).
// Only rows 0-2 of a transform are formed (row 3 is [0 0 0 1]). The
// caller forms V, as fd_qdd_knot's callers form its view.
template <typename T, int NJ, class Par>
GT_HDI void ee_twist_knot(const Par& par, const EEHead<T, NJ>& H,
                          const EETwistView<T>& V) {
  constexpr int W = Par::LANES;
  const int kc = H.k;
  const T* q = V.q;
  T* TS = V.TS;
  T* PRE = V.PRE;
  T* XI = V.XI;
  T* DTF = V.DTF;
  T* FULL = V.FULL;
  T* SUF = V.SUF;
  // rows 0-2 of pre_s, s >= 1; suf_a
  auto pre = [&](int s) -> const T* {
    return s == 1 ? TS : PRE + 12 * s - 12;
  };
  auto suf = [&](int a) -> const T* {
    return a == kc - 1 ? H.tfix : SUF + 16 * a;
  };
  par([&](int t) {
    Deal<W> d{t, 0};
    d(kc, [&](int a) {
      const int j = H.chain[a];
      joint_mat(H.tt + 16 * j, H.jtype[j], H.sind[j], 0, q[j], TS + 16 * a);
    });
  });
  // step s: suf_k-1-s = T_k-s suf_k-s and pre_s+1 = pre_s T_s (s + 1 <
  // k); a suffix, a right factor, keeps its row 3
  for (int s = 1; s < kc; ++s) {
    par([&](int t) {
      Deal<W> d{t, 0};
      d(s + 1 < kc ? 24 : 12, [&](int x) {
        const int e = x % 12, r = e / 4, c = e % 4;
        if (x < 12) {
          T* o = SUF + 16 * (kc - 1 - s);
          o[e] = mm44_rc(TS + 16 * (kc - s), suf(kc - s), r, c);
          if (r == 2) o[12 + c] = c == 3 ? T(1) : T(0);
        } else {
          PRE[12 * s + e] = mm44_rc(pre(s), TS + 16 * s, r, c);
        }
      });
    });
  }
  par([&](int t) {   // xi_a = (R omega, R v + p x R omega) of pre_a; F
    Deal<W> d{t, 0};
    d(6 * kc + 12, [&](int x) {
      if (x < 6 * kc) {
        const int a = x / 6, m = x % 6;
        const T* lam = H.lam + 6 * H.chain[a];
        if (a == 0) {
          XI[m] = lam[m];
          return;
        }
        const T* P = pre(a);
        auto rot = [&](const T* w, int r) {
          return P[r * 4] * w[0] + P[r * 4 + 1] * w[1] + P[r * 4 + 2] * w[2];
        };
        if (m < 3) {
          XI[6 * a + m] = rot(lam, m);
        } else {
          const int r = m - 3, i = (r + 1) % 3, j = (r + 2) % 3;
          XI[6 * a + m] = rot(lam + 3, r) + (P[i * 4 + 3] * rot(lam, j) -
                                             P[j * 4 + 3] * rot(lam, i));
        }
      } else {
        const int e = x - 6 * kc;
        FULL[e] = mm44_rc(TS, suf(0), e / 4, e % 4);
      }
    });
  });
  par([&](int t) {   // dTf_a = Xi_a F: omega_a x F's column c (+ v_a, c = 3)
    Deal<W> d{t, 0};
    d(12 * kc, [&](int x) {
      const int a = x / 12, r = (x % 12) / 4, c = x % 4;
      const T* xi = XI + 6 * a;
      T y = cross3_r(xi, 1, FULL + c, 4, r);
      if (c == 3) y += xi[3 + r];
      DTF[x] = y;
    });
  });
}

// The (6, NJ, NJ) pose Hessian block of one lane at the block's EE
// (H.select): dynamics.cuh:ee_hess_lane's function, in the frame of F (see
// ee_twist_knot): for a <= b d2F/dq_a dq_b = Xi_a Xi_b F (the chain form's
// pre_a dT_a T_a+1 ... T_b-1 dT_b suf_b, and pre_a d2T_a suf_a on the
// diagonal). Split over the group's threads:
// 1-4. ee_twist_knot: T_a, the prefixes and suffixes, xi_a and F, dTf_a;
// 5. the pairs a <= b, a pair a thread: Xi_a dTf_b at the 8 entries
//    pose_hvp reads (omega_a x dTf_b's columns), then pose_hvp at F along
//    dTf_a and dTf_b. STAGE: into the knot's tile by chain positions, both
//    triangles (d2eepos_store writes them out); else straight to `out`
//    (the EE's block, entry (0, 0, 0) of lane 0) at lane `lane` < L.
template <typename T, int NJ, bool STAGE, class Par>
GT_HD void d2eepos_knot(const Par& par, const EEHead<T, NJ>& H, T* k, T* out,
                        long long L, long long lane) {
  using O = D2Knot<NJ>;
  constexpr int W = Par::LANES;
  const int kc = H.k;
  if (kc == 0) return;
  T* XI = k + O::XI;
  T* DTF = k + O::DTF;
  T* FULL = k + O::FULL;
  ee_twist_knot<T, NJ>(par, H,
                       EETwistView<T>{k + O::Q, k + O::TS, k + O::PRE,
                                      k + O::SUF, XI, DTF, FULL});
  par([&](int t) {
    Deal<W> d{t, 0};
    d(kc * (kc + 1) / 2, [&](int n) {   // pair n of the rows a <= b
      int a = 0;
      while (n >= kc - a) {
        n -= kc - a;
        ++a;
      }
      const int b = a + n;
      const T* xi = XI + 6 * a;
      const T* D = DTF + 12 * b;
      T h[12];
      for (int e = 0; e < 12; ++e) h[e] = T(0);
      h[0] = cross3_r(xi, 1, D, 4, 0);
      h[3] = cross3_r(xi, 1, D + 3, 4, 0);
      h[4] = cross3_r(xi, 1, D, 4, 1);
      h[7] = cross3_r(xi, 1, D + 3, 4, 1);
      for (int c = 0; c < 4; ++c) h[8 + c] = cross3_r(xi, 1, D + c, 4, 2);
      T p[6];
      pose_hvp(FULL, DTF + 12 * a, D, h, p);
      for (int r = 0; r < 6; ++r) {
        if (STAGE) {
          k[O::TILE + (r * NJ + a) * NJ + b] = p[r];
          k[O::TILE + (r * NJ + b) * NJ + a] = p[r];
        } else if (lane < L) {
          const int i = H.chain[a], j = H.chain[b];
          out[((long long)(r * NJ + i) * NJ + j) * L + lane] = p[r];
          out[((long long)(r * NJ + j) * NJ + i) * L + lane] = p[r];
        }
      }
    });
  });
}

// Zeros into the rows of `out` (the EE's block, lane-major) whose row or
// column joint is off the chain: rows first, first + STEP, ... of RUN
// lanes from lane z0.
template <typename T, int NJ, int RUN, int STEP>
GT_HD void d2eepos_zero_rows(const EEHead<T, NJ>& H, T* out, long long L,
                             long long z0, int first, int tid,
                             int nthreads) {
  constexpr int ROWS = 6 * NJ * NJ;
  const int n = (ROWS - first + STEP - 1) / STEP;
  for (int x = tid; x < n * RUN; x += nthreads) {
    const int row = first + x / RUN * STEP;
    const long long l = z0 + x % RUN;
    if (l < L && (H.pos[row / NJ % NJ] < 0 || H.pos[row % NJ] < 0))
      out[row * L + l] = T(0);
  }
}

// The block's (6, NJ, NJ) blocks of its G lanes at the block's EE to
// `out` (the EE's block, lane-major). The zeros, where the row or the
// column joint is off the chain, need no lane's state: the QUAD groups of
// G lanes that make a 128-byte run share them, group g writing the rows
// g, g + QUAD, ... of all QUAD G lanes (a ragged last quad: each group its
// own lanes). The chain's 6 k^2 rows come from each knot's tile (STAGE;
// else d2eepos_knot wrote them), G consecutive lanes a row.
template <typename T, int NJ, int S, int G, bool STAGE>
GT_HD void d2eepos_store(const EEHead<T, NJ>& H, const T* knots, T* out,
                         long long L, long long l0, int tid, int nthreads) {
  constexpr int RUN = 128 / (G * (int)sizeof(T));
  constexpr int QUAD = RUN > 1 ? RUN : 1;
  const int kc = H.k;
  if (kc < NJ) {
    const long long g = l0 / G, groups = (L + G - 1) / G;
    if ((g / QUAD + 1) * QUAD <= groups)
      d2eepos_zero_rows<T, NJ, QUAD * G, QUAD>(H, out, L, g / QUAD * QUAD * G,
                                               (int)(g % QUAD), tid,
                                               nthreads);
    else
      d2eepos_zero_rows<T, NJ, G, 1>(H, out, L, l0, 0, tid, nthreads);
  }
  if (!STAGE) return;
  const int k2 = kc * kc;
  for (int x = tid; x < 6 * k2 * G; x += nthreads) {
    const int e = x / G, g = x % G;
    const long long l = l0 + g;
    if (l >= L) continue;
    const int r = e / k2, a = e / kc % kc, b = e % kc;
    out[((r * NJ + H.chain[a]) * NJ + H.chain[b]) * L + l] =
        knots[(long long)g * S + D2Knot<NJ>::TILE + (r * NJ + a) * NJ + b];
  }
}

// The block reads the (NJ, G) tile of q (G consecutive lanes a row) into
// its knots; lanes past L read zeros.
template <typename T, int NJ, int KNOT>
GT_HD void load_q(const T* q, long long L, long long l0, int G, T* knots,
                  int tid, int nthreads) {
  for (int e = tid; e < NJ * G; e += nthreads) {
    const int r = e / G, g = e % G;
    const long long l = l0 + g;
    knots[(long long)g * KNOT + r] = l < L ? q[r * L + l] : T(0);
  }
}

// ---------------------------------------------------------------------------
// eepos: a group of threads a lane, d2eepos's chain phases
// ---------------------------------------------------------------------------

// One lane's state at one EE, by chain position a < k: q; the joint
// transforms T_a (4x4); the prefixes pre_s = T_0 ... T_s-1 (s = 2 .. k; pre_1
// is T_0), rows 0-2; rows 0-2 of the chain's full transform F = pre_k Tfix;
// the pose: 29 NJ + 18 values (221 at 7 joints, 0.9 KB in float32).
template <int NJ>
struct EEKnot {
  static constexpr int Q = 0, TS = Q + NJ, PRE = TS + 16 * NJ;
  static constexpr int FULL = PRE + 12 * NJ, POSE = FULL + 12;
  static constexpr int SIZE = POSE + 6;
};

// Component m of dynamics.cuh:pose_from_T at Tm, its arithmetic: x, y, z,
// then roll, pitch and yaw, each one atan2 on the same path (the threads
// that take the angles take no branch of their own around it).
template <typename T>
GT_HDI T pose_component(const T* Tm, int m) {
  if (m < 3) return Tm[4 * m + 3];
  const T y = m == 3 ? Tm[9] : m == 4 ? Tm[8] : Tm[4];
  const T x = m == 3   ? Tm[10]
              : m == 4 ? gsqrt(Tm[9] * Tm[9] + Tm[10] * Tm[10])
                       : Tm[0];
  const T a = gatan2(y, x);
  return m == 4 ? -a : a;
}

// The pose [x, y, z, roll, pitch, yaw] of one lane at the block's EE
// (H.select; a head with or without the twists): dynamics.cuh:ee_pose_lane's
// function and order of operations, so its bits, split over the group's
// threads in k + 2 phases for a chain of k joints (iiwa 9):
// 1. T_a, a chain joint's matrix a thread (joint_mat, joint_T's values);
// 2. k - 1 phases of the prefixes pre_s+1 = pre_s T_s, rows 0-2, an entry a
//    thread (mm44_rc, mm44's arithmetic): ee_chain_T's running product;
// 3. F = pre_k Tfix, rows 0-2, an entry a thread (an empty chain: Tfix);
// 4. the pose, a component a thread.
template <typename T, int NJ, class Head, class Par>
GT_HD void eepos_knot(const Par& par, const Head& H, T* k) {
  using O = EEKnot<NJ>;
  constexpr int W = Par::LANES;
  const int kc = H.k;
  const T* q = k + O::Q;
  T* TS = k + O::TS;
  T* PRE = k + O::PRE;
  T* FULL = k + O::FULL;
  T* pose = k + O::POSE;
  // rows 0-2 of pre_s, s >= 1
  auto pre = [&](int s) -> T* { return s == 1 ? TS : PRE + 12 * s - 24; };
  if (kc > 0) {
    par([&](int t) {
      Deal<W> d{t, 0};
      d(kc, [&](int a) {
        const int j = H.chain[a];
        joint_mat(H.tt + 16 * j, H.jtype[j], H.sind[j], 0, q[j], TS + 16 * a);
      });
    });
  }
  for (int s = 1; s < kc; ++s) {
    par([&](int t) {
      Deal<W> d{t, 0};
      d(12, [&](int e) {
        pre(s + 1)[e] = mm44_rc(pre(s), TS + 16 * s, e / 4, e % 4);
      });
    });
  }
  par([&](int t) {
    Deal<W> d{t, 0};
    d(12, [&](int e) {
      FULL[e] = kc == 0 ? H.tfix[e] : mm44_rc(pre(kc), H.tfix, e / 4, e % 4);
    });
  });
  par([&](int t) {
    Deal<W> d{t, 0};
    d(6, [&](int m) { pose[m] = pose_component(FULL, m); });
  });
}

// ---------------------------------------------------------------------------
// deepos: a group of threads a lane, d2eepos's twist phases
// ---------------------------------------------------------------------------

// One lane's state at one EE, by chain position a < k: d2eepos's (D2Knot)
// q, T_a, prefixes, suffixes, xi_a, dTf_a and F, and the lane's (6, NJ)
// Jacobian block by chain positions (row r, column a at r NJ + a). dTf_a
// takes the suffixes' place (the last phase that reads them forms F) and
// the block the prefixes' (read last by the twists' phase): 51 NJ + 12
// values (369 at 7 joints, 1.4 KB in float32).
template <int NJ>
struct DJKnot {
  static constexpr int Q = 0;
  static constexpr int TS = Q + NJ, PRE = TS + 16 * NJ, SUF = PRE + 12 * NJ;
  static constexpr int XI = SUF + 16 * NJ, FULL = XI + 6 * NJ;
  static constexpr int DTF = SUF, JAC = PRE;
  static constexpr int SIZE = FULL + 12;
};

// The (6, NJ) pose Jacobian block of one lane at the block's EE
// (H.select): dynamics.cuh:ee_jac_lane's function in the twist form, k + 3
// phases for a chain of k joints (iiwa 10):
// 1-4. ee_twist_knot: T_a, the prefixes and suffixes, xi_a and F = T_0
//    suf_0 (the serial lane's point of the JVP, in its order), dTf_a =
//    dF/dq_a = Xi_a F;
// 5. dynamics.cuh:pose_jvp at F along dTf_a, a (component, chain joint) a
//    thread, into the knot's tile (deepos_store writes it out). The
//    divisions depend on F only: each thread forms 1 / (x^2 + y^2) of the
//    three angles' atan2 and 1 / r of pitch's r = sqrt(F21^2 + F22^2)
//    once, then multiplies. An empty chain runs no phase: its block is
//    zeros.
template <typename T, int NJ, class Par>
GT_HD void deepos_knot(const Par& par, const EEHead<T, NJ>& H, T* k) {
  using O = DJKnot<NJ>;
  constexpr int W = Par::LANES;
  const int kc = H.k;
  if (kc == 0) return;
  const T* DTF = k + O::DTF;
  const T* FULL = k + O::FULL;
  T* JAC = k + O::JAC;
  ee_twist_knot<T, NJ>(par, H,
                       EETwistView<T>{k + O::Q, k + O::TS, k + O::PRE,
                                      k + O::SUF, k + O::XI, k + O::DTF,
                                      k + O::FULL});
  par([&](int t) {
    const T f0 = FULL[0], f4 = FULL[4], f8 = FULL[8], f9 = FULL[9];
    const T f10 = FULL[10];
    const T rr = f9 * f9 + f10 * f10, r = gsqrt(rr), ir = T(1) / r;
    const T iroll = T(1) / rr, ipitch = T(1) / (r * r + f8 * f8);
    const T iyaw = T(1) / (f0 * f0 + f4 * f4);
    Deal<W> d{t, 0};
    d(6 * kc, [&](int x) {   // one component of every joint, then the next
      const int m = x / kc, a = x % kc;
      const T* dT = DTF + 12 * a;
      T v;
      if (m < 3) {
        v = dT[4 * m + 3];
      } else if (m == 3) {   // roll = atan2(F21, F22)
        v = (f10 * dT[9] - f9 * dT[10]) * iroll;
      } else if (m == 4) {   // pitch = -atan2(F20, r)
        const T dr = (f9 * dT[9] + f10 * dT[10]) * ir;
        v = -((r * dT[8] - f8 * dr) * ipitch);
      } else {   // yaw = atan2(F10, F00)
        v = (f0 * dT[4] - f4 * dT[0]) * iyaw;
      }
      JAC[m * NJ + a] = v;
    });
  });
}

// The block's (6, NJ) Jacobian blocks of its G lanes at the block's EE to
// `out` (the EE's block, lane-major), each of the 6 NJ rows as G
// consecutive lanes: a chain joint's row from each knot's tile, a joint
// off the chain's zeros, which read no lane's state (an empty chain: every
// row zeros).
template <typename T, int NJ, int S, int G>
GT_HD void deepos_store(const EEHead<T, NJ>& H, const T* knots, T* out,
                        long long L, long long l0, int tid, int nthreads) {
  for (int x = tid; x < 6 * NJ * G; x += nthreads) {
    const int row = x / G, g = x % G;
    const long long l = l0 + g;
    if (l >= L) continue;
    const int a = H.pos[row % NJ];
    out[row * L + l] =
        a < 0 ? T(0)
              : knots[(long long)g * S + DJKnot<NJ>::JAC + row / NJ * NJ + a];
  }
}

// ---------------------------------------------------------------------------
// blocks: G knots after a head of block-wide constants
// ---------------------------------------------------------------------------

// Shared-memory plan of a block: `Head` (the constants), then G knots of
// KNOT values of T, each knot STRIDE values after the last. STRIDE pads
// KNOT to 16 banks past a multiple of 32, so that the two knots of a warp
// (LANES = 16) reading the same offset hit other banks. The knots an SM
// holds are bounded by its shared memory, its 2048 threads, 32 blocks
// and its registers (REGS a thread, allocated 256 a warp at a time).
GT_HDI constexpr int knots_per_sm(long long head, long long knot_bytes,
                                  int lanes, int g, int regs) {
  const long long bytes = head + g * knot_bytes;
  const long long threads = (long long)g * lanes;
  const long long warps = (threads + WARP - 1) / WARP;
  const long long warp_regs = (regs * WARP + 255) / 256 * 256;
  long long b = SM_SMEM / (bytes + SMEM_PER_BLOCK);
  if (2048 / threads < b) b = 2048 / threads;
  if (SM_REGS / (warps * warp_regs) < b) b = SM_REGS / (warps * warp_regs);
  if (b > 32) b = 32;
  if (bytes > SMEM_LIMIT || threads > MAX_BLOCK_THREADS) return 0;
  return g * (int)b;
}

// G, at most `cap` and a multiple of the knots a warp holds: the one that
// puts the most knots on an SM, the larger on a tie; with `pow2`, the
// largest power of 2 that fits (a block's run of a row then fills whole
// 32-byte sectors or an aligned part of one); 0 if one knot does not fit
GT_HDI constexpr int best_knots(long long head, long long knot_bytes,
                                int lanes, int regs, bool pow2 = false,
                                int cap = MAX_KNOTS) {
  const int step = lanes < WARP ? WARP / lanes : 1;
  int best = 0, most = 0;
  for (int g = step; g <= cap; g = pow2 ? 2 * g : g + step) {
    const int n = knots_per_sm(head, knot_bytes, lanes, g, regs);
    if (n > 0 && (pow2 || n >= most)) {
      best = g;
      most = n;
    }
  }
  return best;
}

// Threads a knot takes: `base` times 1, 2 or 4, the one that puts the most
// knots on an SM (they are bound by their phases' latency, so knots an SM
// set the rate), then, on a tie, the most warps up to MIN_WARPS, then the
// fewest threads.
GT_HDI constexpr int lanes_for(long long head, long long knot_bytes, int base,
                               int regs) {
  int best = base, best_knots_sm = -1, best_warps = -1;
  for (int lanes = base; lanes <= MAX_KNOT_GROUPS * base; lanes *= 2) {
    const int g = best_knots(head, knot_bytes, lanes, regs);
    if (g == 0) continue;
    const int n = knots_per_sm(head, knot_bytes, lanes, g, regs);
    int warps = n * lanes / WARP;
    if (warps > MIN_WARPS) warps = MIN_WARPS;
    if (n > best_knots_sm || (n == best_knots_sm && warps > best_warps)) {
      best = lanes;
      best_knots_sm = n;
      best_warps = warps;
    }
  }
  return best;
}

// A knot of KNOT values of T padded to 16 banks past a multiple of 32
// (BlockPlan).
template <typename T>
GT_HDI constexpr int knot_stride(int knot) {
  constexpr int WORDS = (int)sizeof(T) / 4;
  return knot + ((16 / WORDS - knot % (32 / WORDS)) + 32 / WORDS) %
                    (32 / WORDS);
}

template <typename T, class Head, int KNOT, int BASE, int REGS>
struct BlockPlan {
  static constexpr int STRIDE = knot_stride<T>(KNOT);
  static constexpr long long HEAD = (sizeof(Head) + 15) / 16 * 16;
  static constexpr long long KNOT_BYTES = (long long)STRIDE * sizeof(T);
  static constexpr int LANES = lanes_for(HEAD, KNOT_BYTES, BASE, REGS);
  static constexpr int G = best_knots(HEAD, KNOT_BYTES, LANES, REGS);
  static constexpr long long BYTES = HEAD + (G > 0 ? G : 1) * KNOT_BYTES;
  static constexpr int ROWS = 1;   // programs a block per problem
};

// A block of G knots of LANES threads each, its knots padded as BlockPlan
// pads them: another shape of a kernel than its plan's, which
// compare_kernels.py times beside the plan.
template <typename T, class Head, int KNOT, int LANES_, int G_>
struct KnotShape {
  static constexpr int STRIDE = knot_stride<T>(KNOT);
  static constexpr long long HEAD = (sizeof(Head) + 15) / 16 * 16;
  static constexpr int LANES = LANES_, G = G_, ROWS = 1;
  // one knot's where none fits (G = 0)
  static constexpr long long BYTES =
      HEAD + (long long)(G > 0 ? G : 1) * STRIDE * (long long)sizeof(T);
};

// A knot of KNOT values of T padded so that the knots of a warp, LANES
// threads each, start LANES banks apart (modulo 32): the 4 knots of 8
// threads that a warp holds then read a knot's same entry from 4 banks
// (knot_stride puts knots 16 banks apart: there knots 0 and 2 of a warp
// share every bank, a 2-way conflict on each access). A knot of a warp or
// more is padded as knot_stride pads it.
template <typename T>
GT_HDI constexpr int group_stride(int knot, int lanes) {
  constexpr int WORDS = (int)sizeof(T) / 4;
  const int row = 32 / WORDS;   // values in one row of the 32 banks
  const int want = (lanes < WARP ? lanes : 16) / WORDS;
  return knot + ((want - knot % row) + row) % row;
}

// A block of G knots of LANES threads each, padded by group_stride
template <typename T, class Head, int KNOT, int LANES_, int G_>
struct GroupShape {
  static constexpr int STRIDE = group_stride<T>(KNOT, LANES_);
  static constexpr long long HEAD = (sizeof(Head) + 15) / 16 * 16;
  static constexpr int LANES = LANES_, G = G_, ROWS = 1;
  static constexpr long long BYTES =
      HEAD + (long long)(G > 0 ? G : 1) * STRIDE * (long long)sizeof(T);
};

// The device-memory route of a thread-group kernel (id_du, minv, fd,
// riccati_factored; fd_du and the dense riccati keep their knot or problem
// on chip there instead: FDChipPlan, RicChipPlan): where its plan P holds
// no knot in a block's
// shared memory (G 0: from 30 to 48 joints, by kernel and dtype), a block
// runs one knot at a time with WS_LANES threads, its head (the robot
// constants) still in shared memory and the knot's KNOT values in device
// memory: a workspace that the wrapper allocates, one knot a block, sized
// by the blocks in flight, which stride over the lanes (ws_lanes). Where P
// holds a knot, P as it is (WS 0). The knot programs take the knot's
// buffer as a pointer, so the same program runs on either memory.
constexpr int WS_LANES = 128;
template <typename T, class P, int KNOT>
struct WsPlan : P {
  static constexpr bool IN_WS = P::G == 0;
  static constexpr int LANES = IN_WS ? WS_LANES : P::LANES;
  static constexpr int STRIDE = IN_WS ? KNOT : P::STRIDE;
  static constexpr long long BYTES = IN_WS ? P::HEAD : P::BYTES;
  // device memory a block takes (0: its knots sit in shared memory)
  static constexpr long long WS = IN_WS ? (long long)KNOT * sizeof(T) : 0;
};

// a plan's workspace bytes a block (PlanWs<P>::value; 0 for a plan without
// a device-memory route)
template <class P, class = void>
struct PlanWs {
  static constexpr long long value = 0;
};
template <class P>
struct PlanWs<P, std::void_t<decltype(P::WS)>> {
  static constexpr long long value = P::WS;
};

// the knots a block of plan P runs at a time: G, or one on the
// device-memory route
template <class P>
GT_HDI constexpr int plan_g() { return P::G > 0 ? P::G : 1; }

// ---------------------------------------------------------------------------
// on chip: one problem or knot a block, or a thread-block cluster
// ---------------------------------------------------------------------------

// Where one problem's (knot's) state does not fit a block's shared memory
// beside others, or above 28 joints (fd_du and the dense Riccati sweep from
// CHIP_FROM = 29 joints), a block, or a cluster of CL = 2 or 4 blocks on
// neighbouring SMs, holds that one problem's state on chip. The state is
// split in regions; each region sits whole in the shared memory of one
// block of the cluster (its rank), and every thread of the cluster reads
// and writes every region through its address in the cluster's distributed
// shared memory (chip_map: PTX mapa), so a knot program takes one
// pointer a region and runs unchanged on one block or on a cluster. Rank 0
// holds the kernel's head (the robot constants) first, the others none; the
// regions go to the ranks first fit, in the order the plan lists them. A
// phase of the program is all the cluster's threads (ChipPar), ended by the
// block's barrier or the cluster's. The host build runs the same program
// over one buffer (HostPar).
constexpr int CHIP_MAX_CLUSTER = 4;

GT_HDI constexpr long long round4(long long n) { return (n + 3) / 4 * 4; }

template <int NR>
struct ChipPack {
  int cl = 0;   // blocks a problem; 0: the regions do not fit CL blocks
  int rank[NR] = {};
  long long off[NR] = {};   // values of T from the rank's state
  long long used[CHIP_MAX_CLUSTER] = {};
};

// size[i] values of `bytes` each (rounded up to 4: 16-byte aligned rows in
// float32), in order, into cl blocks, rank 0 holding `head` bytes before
// its state
template <int NR>
GT_HDI constexpr ChipPack<NR> chip_pack(const long long (&size)[NR],
                                        int bytes, long long head, int cl) {
  ChipPack<NR> p{};
  for (int i = 0; i < NR; ++i) {
    int r = 0;
    for (; r < cl; ++r) {
      const long long cap = (SMEM_LIMIT - (r == 0 ? head : 0)) / bytes;
      if (p.used[r] + round4(size[i]) <= cap) break;
    }
    if (r == cl) return ChipPack<NR>{};
    p.rank[i] = r;
    p.off[i] = p.used[r];
    p.used[r] += round4(size[i]);
  }
  p.cl = cl;
  return p;
}

// the values a rank's state takes at most, and the bytes a block of the
// pack takes (rank 0: its head too)
template <int NR>
GT_HDI constexpr long long chip_rank_values(const ChipPack<NR>& p) {
  long long m = 0;
  for (int r = 0; r < CHIP_MAX_CLUSTER; ++r)
    if (p.used[r] > m) m = p.used[r];
  return m;
}
template <int NR>
GT_HDI constexpr long long chip_bytes(const ChipPack<NR>& p, int bytes,
                                      long long head) {
  long long m = head + p.used[0] * bytes;
  for (int r = 1; r < CHIP_MAX_CLUSTER; ++r)
    if (p.used[r] * bytes > m) m = p.used[r] * bytes;
  return m;
}

// Four consecutive values at p (16-byte aligned on the card: one 16-byte
// load in float32, two in float64) into v.
template <typename T>
GT_HDI void ld4(const T* p, T* v) {
#ifdef __CUDA_ARCH__
  if constexpr (sizeof(T) == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    const double2 x = *reinterpret_cast<const double2*>(p);
    const double2 y = *reinterpret_cast<const double2*>(p + 2);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = y.x;
    v[3] = y.y;
  }
#else
  for (int i = 0; i < 4; ++i) v[i] = p[i];
#endif
}

// A 4 x 4 register tile of a matrix product: acc[a][c] += sum over k < K
// of l_k[a] r_k[c], lrow(k, l) and rrow(k, r) loading the 4 values of step
// k. Float32 stays on FP32 FMAs (TF32 would keep 3 digits), float64 on
// FP64 FMAs.
template <typename T, class LF, class RF>
GT_HDI void mma4(T (&acc)[4][4], int K, LF&& lrow, RF&& rrow) {
#ifdef __CUDACC__
#pragma unroll 4
#endif
  for (int k = 0; k < K; ++k) {
    T l[4], r[4];
    lrow(k, l);
    rrow(k, r);
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int a = 0; a < 4; ++a)
#ifdef __CUDACC__
#pragma unroll
#endif
      for (int c = 0; c < 4; ++c) acc[a][c] += l[a] * r[c];
  }
}

// fd_du on chip: one knot a block or cluster (FDChipPlan), its state in
// three regions: BASE, the inputs, qdd, Minv (NJ, NJ), the joint
// transforms, v, a, f, I v and the bias forces, as FDKnot holds them, and
// the gradient's 2 NJ columns in the order the chunks take them; MSM,
// Minv's IA, U, Dinv, temporaries and X^T U; FMC, Minv's F (NJ, 6, NJ),
// and over it, once Minv is done, the gradient's column state of a chunk
// of C columns (NJ, 18, C) and two buffers of the chunk's dc (NJ, CP),
// CP = C rounded up to 4.
template <int NJ, int C>
struct FDChipKnot {
  static constexpr int CP = (int)round4(C);
  static constexpr int Q = 0, QD = Q + NJ, U = QD + NJ, QDD = U + NJ;
  static constexpr int MI = QDD + NJ, X = MI + NJ * NJ, V = X + 36 * NJ;
  static constexpr int A = V + 6 * NJ, F = A + 6 * NJ, IV = F + 6 * NJ;
  static constexpr int CC = IV + 6 * NJ, CO = CC + NJ, BASE = CO + 2 * NJ;
  static constexpr int IA = 0, UU = IA + 36 * NJ, DINV = UU + 6 * NJ;
  static constexpr int TMP = DINV + NJ, XU = TMP + 36 * NJ, MSM = XU + 6 * NJ;
  static constexpr int FM = 0, COL = 0;
  static constexpr int DC = (int)round4(18LL * NJ * C);
  static constexpr int FMC =
      6 * NJ * NJ > DC + 2 * NJ * CP ? 6 * NJ * NJ : DC + 2 * NJ * CP;
  enum { R_BASE, R_MSM, R_FMC, NREG };
};

template <typename T, int NJ>
GT_HDI constexpr long long fd_chip_head() {
  return (sizeof(RobotConst<T, NJ>) + 15) / 16 * 16;
}

template <typename T, int NJ, int C>
GT_HDI constexpr ChipPack<3> fd_chip_pack(int cl) {
  using O = FDChipKnot<NJ, C>;
  const long long size[3] = {O::BASE, O::MSM, O::FMC};
  return chip_pack(size, (int)sizeof(T), fd_chip_head<T, NJ>(), cl);
}

// The chunk width C: the widest (up to 64, at least FD_CHIP_CMIN) that
// fits the fewest blocks, then evened out over its chunks. Each chunk is a
// phase in which C threads walk a column each, so fewer, wider chunks take
// fewer phases; the chunks' memory sits over Minv's F, so at 52 joints in
// float32 the widest that fits is 32 (4 chunks, even at 28: 28, 28, 28,
// 20).
constexpr int FD_CHIP_CMIN = 16;
template <typename T, int NJ, int CMAX>
GT_HDI constexpr int fd_chip_cmax(int cl) {
  if constexpr (CMAX < FD_CHIP_CMIN) {
    return 0;
  } else {
    return fd_chip_pack<T, NJ, CMAX>(cl).cl ? CMAX
                                           : fd_chip_cmax<T, NJ, CMAX - 4>(cl);
  }
}
template <typename T, int NJ>
GT_HDI constexpr int fd_chip_cl() {
  constexpr int top = (int)round4(2 * NJ) < 64 ? (int)round4(2 * NJ) : 64;
  return fd_chip_cmax<T, NJ, top>(1) ? 1
         : fd_chip_cmax<T, NJ, top>(2) ? 2
         : fd_chip_cmax<T, NJ, top>(4) ? 4
                                        : 0;
}
template <typename T, int NJ>
GT_HDI constexpr int fd_chip_c() {
  constexpr int top = (int)round4(2 * NJ) < 64 ? (int)round4(2 * NJ) : 64;
  constexpr int cl = fd_chip_cl<T, NJ>();
  constexpr int cmax = cl ? fd_chip_cmax<T, NJ, top>(cl) : 4;
  constexpr int chunks = (2 * NJ + cmax - 1) / cmax;
  return (int)round4((2 * NJ + chunks - 1) / chunks);
}

// threads a block of an on-chip program
constexpr int CHIP_THREADS = 256;

template <typename T, int NJ>
struct FDChipPlan {
  static constexpr int C = fd_chip_c<T, NJ>();
  using O = FDChipKnot<NJ, C>;
  static constexpr ChipPack<3> PACK =
      fd_chip_pack<T, NJ, C>(fd_chip_cl<T, NJ>());
  static constexpr int CL = PACK.cl, NT = CHIP_THREADS, LANES = CL * NT;
  static constexpr int G = 1, ROWS = 1, CHUNKS = (2 * NJ + C - 1) / C;
  static constexpr long long HEAD = fd_chip_head<T, NJ>();
  static constexpr long long RANK_VALUES = chip_rank_values(PACK);
  static constexpr long long BYTES = chip_bytes(PACK, (int)sizeof(T), HEAD);
  static_assert(C <= NT / 2, "a thread a column of a chunk, the rest fold");
  static constexpr int RK_BASE = PACK.rank[0], RK_MSM = PACK.rank[1];
  static constexpr int RK_FMC = PACK.rank[2];
  static constexpr long long OF_BASE = PACK.off[0], OF_MSM = PACK.off[1];
  static constexpr long long OF_FMC = PACK.off[2];
};

// a plan's blocks a problem (1 but for an on-chip plan on a cluster)
template <class P, class = void>
struct PlanCluster {
  static constexpr int value = 1;
};
template <class P>
struct PlanCluster<P, std::void_t<decltype(P::PACK)>> {
  static constexpr int value = P::CL;
};

// One knot (lane l of L) of fd_du on chip (FDChipPlan P; its regions BASE,
// MSM, FMC at rg), by the cluster's threads: its inputs in; fd_qdd_knot
// (the bias RNEA, Carpentier's Minv, mirrored dense, qdd); the RNEA at qdd;
// then the ID gradient in P::CHUNKS chunks of C columns, a phase each:
// threads t < C walk column chunk C + t (grad_column, a column a thread,
// [q, qd] order) into the chunk's dc buffer, while the other threads fold
// the chunk before into df/du = -Minv dc, a 4 x 4 register tile of rows
// and columns a thread (mma4), straight to the lane's rows of dfdu, so
// that df/du never sits on chip whole; the last phase folds the last chunk
// while the other threads write qdd and Minv. Minv is symmetric
// (mirrored), so
// its rows are read as columns. A chunk's phase lasts as long as its
// longest column's walk (over the column joint's subtree, then its related
// joints), so the columns go to the chunks by subtree size, the largest
// first (the first phase ranks them): the long walks share one chunk.
template <typename T, int NJ, class P, class Rb, class Par>
GT_HD void fd_du_chip_lane(const Par& par, const Rb& R, T* const* rg,
                           const T* q, const T* qd, const T* u, T* dfdu,
                           T* qdd_o, T* Mi_o, long long L, long long l,
                           T gravity) {
  using O = typename P::O;
  constexpr int W = Par::LANES, C = P::C, CP = O::CP, NC = 2 * NJ;
  constexpr int RT = (NJ + 3) / 4, CT = CP / 4;   // tiles of a chunk
  static_assert(C + RT * CT < W, "walks, folds and stores of the last phase");
  T* b = rg[O::R_BASE];
  T* ms = rg[O::R_MSM];
  T* fm = rg[O::R_FMC];
  // column n of the chunks' order: an int in the n-th value of CO
  auto cols = [&](int n) -> int& {
    return *reinterpret_cast<int*>(b + O::CO + n);
  };
  par([&](int t) {
    for (int e = t; e < 3 * NJ; e += W) {
      const int w = e / NJ, i = e % NJ;
      b[O::Q + e] = (w == 0 ? q : w == 1 ? qd : u)[i * L + l];
    }
    for (int c = t; c < NC; c += W) {   // c's rank by subtree size
      const int sc = R.rsub[c % NJ];
      int rank = 0;
      for (int c2 = 0; c2 < NC; ++c2) {
        const int s2 = R.rsub[c2 % NJ];
        rank += s2 > sc || (s2 == sc && c2 < c);
      }
      cols(rank) = c;
    }
  });
  const T g[6] = {0, 0, 0, 0, 0, -gravity};
  const int nlev = R.nlev;
  const RneaView<T> rv{b + O::QD, b + O::QDD, b + O::X,  b + O::V,
                       b + O::A,  b + O::F,   b + O::IV, g};
  fd_qdd_knot<T, NJ, true>(
      par, R,
      FDView<T>{b + O::Q, b + O::QD, b + O::U, b + O::QDD, b + O::MI,
                b + O::X, b + O::F, b + O::CC, ms + O::IA, fm + O::FM,
                ms + O::UU, ms + O::DINV, ms + O::TMP, ms + O::XU},
      rv, nlev);
  rnea_forward_knot<RNEA_AT_QDD, T, NJ>(par, R, rv, nlev);
  rnea_backward_knot<T>(par, R, rv, nlev);
  const T* Mi = b + O::MI;
  T* col = fm + O::COL;
  for (int k = 0; k <= P::CHUNKS; ++k) par([&](int t) {
    if (t < C) {
      if (k < P::CHUNKS && k * C + t < NC) {
        const int c = cols(k * C + t);
        T* dc = fm + O::DC + (k & 1) * NJ * CP;
        grad_column<T, NJ, C>(
            R, b + O::QD, b + O::X, b + O::V, b + O::A, b + O::F, b + O::IV,
            g, c < NJ, c < NJ ? c : c - NJ,
            [&](int i, int m) -> T& { return col[(i * 18 + m) * C + t]; },
            [&](int i, T x) { dc[i * CP + t] = x; });
      }
    }
    // the last phase: the threads that neither walk nor fold write qdd and
    // Minv (scattered stores, which the walks' shared loads would queue
    // behind in an earlier phase)
    const int idle = t < C ? t : t - RT * CT;
    if (k == P::CHUNKS && (t < C || t - C >= RT * CT))
      for (int e = idle; e < NJ + NJ * NJ; e += W - RT * CT) {
        if (e < NJ)
          qdd_o[e * L + l] = b[O::QDD + e];
        else
          Mi_o[(e - NJ) * L + l] = Mi[e - NJ];
      }
    if (t < C || k == 0) return;
    const T* dc = fm + O::DC + ((k - 1) & 1) * NJ * CP;
    const int c0 = (k - 1) * C;
    for (int e = t - C; e < RT * CT; e += W - C) {
      const int r0 = 4 * (e / CT), j0 = 4 * (e % CT);
      T acc[4][4] = {};
      mma4(acc, NJ,
           [&](int m, T* lv) {
             for (int a = 0; a < 4; ++a)
               lv[a] = Mi[m * NJ + (r0 + a < NJ ? r0 + a : NJ - 1)];
           },
           [&](int m, T* rv) { ld4(dc + m * CP + j0, rv); });
      for (int j = 0; j < 4; ++j) {
        if (j0 + j >= C || c0 + j0 + j >= NC) continue;
        const long long c = cols(c0 + j0 + j);
        for (int a = 0; a < 4; ++a)
          if (r0 + a < NJ) dfdu[((r0 + a) * NC + c) * L + l] = -acc[a][j];
      }
    }
  });
}

// The kernels' plans: fd_du's head is the robot constants, fdsva_so's and
// idsva_so's also the (j, a, st) lists.
template <typename T, int NJ>
struct SOHead {
  RobotConst<T, NJ> R;
  SOLists<NJ> lists;
};

template <typename T, int NJ>
using FDPlan = WsPlan<T,
                      BlockPlan<T, RobotConst<T, NJ>, FDKnot<NJ>::SIZE,
                                knot_lanes<NJ>(), fd_regs<T>()>,
                      FDKnot<NJ>::SIZE>;
// fd_du and the dense riccati run on chip (FDChipPlan, RicChipPlan) from
// CHIP_FROM joints, above the 28 that their shared-memory plans were
// built for: at config 5's shapes the on-chip programs ran 1.9-2.0x
// (fd_du, 34-46 joints) and 2.4-4.0x (riccati, 30-42) faster than those
// plans in float32, and 1.2-2.4x at 28 joints in both dtypes (PERF.md,
// compare_kernels.py --hands52); every plan at or below 28 joints holds
// its knot or problem in shared memory.
constexpr int CHIP_FROM = 29;
template <typename T, int NJ>
GT_HDI constexpr bool fd_on_chip() {
  return NJ >= CHIP_FROM;
}
template <typename T, int NJ>
using SOPlan = BlockPlan<T, SOHead<T, NJ>, SOKnot<NJ>::SIZE,
                         knot_lanes<NJ>(), so_regs<T>()>;
// idsva_so's plan: fdsva_so's head, its own knot. Threads a knot by joint
// count, the width that ran fastest for the zoo's robot of that count at
// config 4's N B lanes (compare_kernels.py's knot shapes; PERF.md): a warp
// up to 8 joints (with no gradient columns to fill, the phases are the
// (j, a, st) triples: a half-warp knot runs a 7-joint chain's 84 in twice
// the rounds), 64 threads at 12 (hyq), 128 at 16 (dm_quadruped). The
// (4, NJ, NJ, NJ) tile is the kernel's output, G knots writing G
// consecutive lanes of each row, so G is the largest power of 2 that fits,
// not the one with the most knots an SM: a run of 6 lanes straddles
// sectors, and G = 6 and 2 ran 13% to 3.3x slower than 4 or 8 at the same
// width.
template <int NJ>
GT_HDI constexpr int idso_lanes() {
  return NJ == 12 ? 2 * WARP : NJ == 16 ? 4 * WARP : WARP;
}
template <typename T, int NJ>
using IDSOKnot = KnotShape<T, SOHead<T, NJ>, IDKnot<NJ>::SIZE,
                           idso_lanes<NJ>(), 1>;
template <typename T, int NJ>
using IDSOPlan = KnotShape<
    T, SOHead<T, NJ>, IDKnot<NJ>::SIZE, idso_lanes<NJ>(),
    best_knots(IDSOKnot<T, NJ>::HEAD,
               IDSOKnot<T, NJ>::STRIDE * (long long)sizeof(T),
               idso_lanes<NJ>(), so_regs<T>(), true)>;

// idsva_so where one knot's whole tile does not fit a block (IDSOPlan's G
// 0: above 23 joints in float32, 18 in float64): the tile in BANDS bands of
// BAND_ROWS rows (c, i) (the last may be shorter), a band a block
// (blockIdx.y), the fewest bands whose knot (IDBandKnot) and head fit;
// IDSO_BAND_LANES threads a knot (atlas: 442 (j, a, st) triples, two
// rounds a stage), G the largest power of 2 that fits.
constexpr int IDSO_BAND_LANES = 256;
template <typename T, int NJ>
GT_HDI constexpr int idso_band_rows() {
  constexpr long long head = (sizeof(SOHead<T, NJ>) + 15) / 16 * 16;
  for (int bands = 1; bands <= 4 * NJ; ++bands) {
    const int rows = (4 * NJ + bands - 1) / bands;
    const long long knot =
        knot_stride<T>(idband_size<NJ>(rows, IDSO_BAND_LANES)) *
        (long long)sizeof(T);
    if (knots_per_sm(head, knot, IDSO_BAND_LANES, 1, so_regs<T>()) > 0)
      return rows;
  }
  return 0;
}
template <typename T, int NJ>
struct IDSOBandPlan {
  static constexpr int LANES = IDSO_BAND_LANES;
  static constexpr int BAND_ROWS = idso_band_rows<T, NJ>();
  static constexpr int BANDS =
      BAND_ROWS > 0 ? (4 * NJ + BAND_ROWS - 1) / BAND_ROWS : 0;
  using Knot = IDBandKnot<NJ, BAND_ROWS, LANES>;
  static constexpr int STRIDE = knot_stride<T>(Knot::SIZE);
  static constexpr long long HEAD = (sizeof(SOHead<T, NJ>) + 15) / 16 * 16;
  static constexpr int G =
      BAND_ROWS > 0 ? best_knots(HEAD, STRIDE * (long long)sizeof(T), LANES,
                                 so_regs<T>(), true)
                    : 0;
  static constexpr long long BYTES =
      HEAD + (long long)(G > 0 ? G : 1) * STRIDE * (long long)sizeof(T);
  static constexpr int ROWS = 1;
};

// idsva_so with its tile in device memory (idsva_so_knot_to): each knot
// program runs once, as in the whole tile's plan, but the block holds only
// the robot constants (the head: the lists are read from device memory)
// and G knots of IDKnot's inputs and stage quantities (225 NJ values: 46.8
// KB at 52 joints in float32); each knot's (4, NJ, NJ, NJ) tensor
// accumulates in the output itself, lane l0 + g for knot g, zeroed before
// the launch: no workspace. Threads a knot: IDSO_TILE_LANES times 1, 2 or
// 4, the most knots an SM (lanes_for); G the largest power of 2 that fits,
// so that the G adjacent lanes of a row share sectors (at 52 joints: 4
// knots of 128 threads in float32, 1 of 256 in float64).
constexpr int IDSO_TILE_LANES = 128;
template <typename T, int NJ>
struct IDSOTilePlan {
  static constexpr int STRIDE = knot_stride<T>(IDKnot<NJ>::STAGES_END);
  static constexpr long long HEAD =
      (sizeof(RobotConst<T, NJ>) + 15) / 16 * 16;
  static constexpr long long KNOT_BYTES = (long long)STRIDE * sizeof(T);
  static constexpr int LANES =
      lanes_for(HEAD, KNOT_BYTES, IDSO_TILE_LANES, so_regs<T>());
  static constexpr int G =
      best_knots(HEAD, KNOT_BYTES, LANES, so_regs<T>(), true);
  static constexpr long long BYTES = HEAD + (G > 0 ? G : 1) * KNOT_BYTES;
  static constexpr int ROWS = 1;
  static constexpr bool DEVICE_TILE = true;
};

// idsva_so's routes (csrc/idsva_so.cu): a knot's whole tile in shared
// memory where it fits a block (IDSOPlan), else in bands of rows
// (IDSOBandPlan) up to IDSO_BANDS_MAX_NJ joints, else in device memory
// (IDSOTilePlan); the library builds only the route chosen here. A band
// repeats the knot's whole program, one knot a block; the device tile
// runs it once, 4 knots a block in float32, and pays a read-modify-write
// in device memory for each entry the stages touch. On an H100 the device
// tile ran 7.7-12.4x faster than the bands at 28 and 34 joints in both
// dtypes (PERF.md, Findings): it serves every count above 28; at 28 and below
// the bands stay as they were measured on atlas's paths (moving them is a
// separate change of those paths).
enum { IDSO_WHOLE = 0, IDSO_BANDS = 1, IDSO_DEVICE = 2 };
constexpr int IDSO_BANDS_MAX_NJ = 28;
template <typename T, int NJ>
GT_HDI constexpr int idso_route() {
  return IDSOPlan<T, NJ>::G >= 1 ? IDSO_WHOLE
         : NJ <= IDSO_BANDS_MAX_NJ && IDSOBandPlan<T, NJ>::G >= 1
             ? IDSO_BANDS
             : IDSO_DEVICE;
}

// id_du's plan: fd_du's head and threads a knot, its own knot (IDUKnot,
// PASSES column passes), G the knots that put the most on an SM.
template <typename T, int NJ, int PASSES = idu_passes<NJ>()>
using IDUPlan = WsPlan<T,
                       BlockPlan<T, RobotConst<T, NJ>,
                                 IDUKnot<NJ, PASSES>::SIZE, knot_lanes<NJ>(),
                                 fd_regs<T>()>,
                       IDUKnot<NJ, PASSES>::SIZE>;
// rnea's plan: threads a knot by joint count (rnea_lanes), the width that
// ran fastest for the zoo's robot of that count at its main shapes
// (compare_kernels.py's shapes; PERF.md): a phase has at most 6 items a
// joint of the widest level (6 on a chain, 24 on hyq, 30 on atlas), and
// fewer threads put more knots on an SM: 8 on the chains of 2 and 7 joints
// (at 131072 iiwa lanes 1.4x 16 threads and 2.5x 32), 16 on hyq (12%
// faster than 32 at 16384 lanes), a warp otherwise. G the largest power of
// 2 up to 8 that fits (its output rows are G consecutive lanes: 32-byte
// runs at G = 8 in float32).
template <int NJ>
GT_HDI constexpr int rnea_lanes() {
  return NJ == 2 || NJ == 7 ? 8 : NJ == 12 ? 16 : WARP;
}
template <typename T, int NJ>
using RNEAKnot1 = KnotShape<T, RobotConst<T, NJ>, RNEAKnot<NJ>::SIZE,
                            rnea_lanes<NJ>(), 1>;
template <typename T, int NJ>
using RNEAPlan = KnotShape<
    T, RobotConst<T, NJ>, RNEAKnot<NJ>::SIZE, rnea_lanes<NJ>(),
    best_knots(RNEAKnot1<T, NJ>::HEAD,
               RNEAKnot1<T, NJ>::STRIDE * (long long)sizeof(T),
               rnea_lanes<NJ>(), fd_regs<T>(), true)>;
// d2eepos's plan: threads a lane and the store route by joint count, the
// shape that ran fastest for the zoo's robots at their main shapes
// (compare_kernels.py's shapes; PERF.md): up to 8 joints (a chain) 8
// threads a lane, each pair's entries written straight out (four lanes a
// warp: at 131072 iiwa lanes 1.7x the staged warp a lane, and as fast at
// 1 and 1024); above, a warp a lane, its block staged (the wide trees'
// short chains, most of the block zeros). G the largest power of 2 that
// fits (its output rows are G consecutive lanes: 32-byte runs at G = 8 in
// float32, 4 in float64).
template <int NJ>
GT_HDI constexpr int d2_lanes() { return NJ <= 8 ? 8 : WARP; }
template <int NJ>
GT_HDI constexpr bool d2_stage() { return NJ > 8; }
// Above 8 joints the staged route where its knot fits a block, else (above
// 62 joints in float64) the direct one, whose knot holds no tile (D2Knot's
// first TILE values: d2eepos_knot without STAGE writes none of the tile).
template <typename T, int NJ>
using D2Staged1 = KnotShape<T, EEHead<T, NJ>, D2Knot<NJ>::SIZE,
                            d2_lanes<NJ>(), 1>;
template <typename T, int NJ>
GT_HDI constexpr bool d2_stages() {
  return d2_stage<NJ>() &&
         best_knots(D2Staged1<T, NJ>::HEAD,
                    D2Staged1<T, NJ>::STRIDE * (long long)sizeof(T),
                    d2_lanes<NJ>(), fd_regs<T>(), true) >= 1;
}
template <typename T, int NJ>
GT_HDI constexpr int d2_knot() {
  return d2_stage<NJ>() && !d2_stages<T, NJ>() ? D2Knot<NJ>::TILE
                                               : D2Knot<NJ>::SIZE;
}
template <typename T, int NJ>
using D2Knot1 = KnotShape<T, EEHead<T, NJ>, d2_knot<T, NJ>(), d2_lanes<NJ>(),
                          1>;
template <typename T, int NJ>
using D2Plan = KnotShape<
    T, EEHead<T, NJ>, d2_knot<T, NJ>(), d2_lanes<NJ>(),
    best_knots(D2Knot1<T, NJ>::HEAD,
               D2Knot1<T, NJ>::STRIDE * (long long)sizeof(T), d2_lanes<NJ>(),
               fd_regs<T>(), true)>;

// fd's plan: a warp a knot at every joint count (compare_kernels.py's
// shapes, PERF.md): Minv's phases have 36 + 6 NJ items of each child of a
// level (iiwa: 78 on a chain), and on iiwa 8 threads a knot ran 1.5x a warp
// at 1 and 1024 lanes (16 threads: 1.1x), unlike rnea's 6 items a joint.
// G the largest power of 2 up to 8 that fits (its output rows are G
// consecutive lanes: 32-byte runs at G = 8 in float32; at 28 joints 4 | 2
// knots fit a block in float32 | float64).
template <typename T, int NJ>
using FDKnot1 = KnotShape<T, RobotConst<T, NJ>, FDQKnot<NJ>::SIZE, WARP, 1>;
template <typename T, int NJ>
using FDPlanQ = WsPlan<
    T,
    KnotShape<T, RobotConst<T, NJ>, FDQKnot<NJ>::SIZE, WARP,
              best_knots(FDKnot1<T, NJ>::HEAD,
                         FDKnot1<T, NJ>::STRIDE * (long long)sizeof(T), WARP,
                         fd_regs<T>(), true)>,
    FDQKnot<NJ>::SIZE>;
// minv's plan: fd's Minv phases, so fd's width, a warp a knot (16 threads
// took 1.1x and 8 threads 1.7x a warp's time at 1 and 1024 iiwa lanes;
// compare_kernels.py's shapes, PERF.md); G the largest power of 2 up to 8
// that fits (its NJ^2 output rows are G consecutive lanes: 32-byte runs at
// G = 8 in float32; at 28 joints 4 | 2 knots fit a block in float32 |
// float64).
template <typename T, int NJ>
using MinvKnot1 = KnotShape<T, RobotConst<T, NJ>, MinvKnot<NJ>::SIZE, WARP,
                            1>;
template <typename T, int NJ>
using MinvPlan = WsPlan<
    T,
    KnotShape<T, RobotConst<T, NJ>, MinvKnot<NJ>::SIZE, WARP,
              best_knots(MinvKnot1<T, NJ>::HEAD,
                         MinvKnot1<T, NJ>::STRIDE * (long long)sizeof(T),
                         WARP, fd_regs<T>(), true)>,
    MinvKnot<NJ>::SIZE>;
// crba's plan: a phase has 6 items a column of the joints on its level and
// below, and 6 rows of each parent; threads a knot by joint count
// (crba_lanes), the width that ran fastest for the zoo's robot of that
// count (compare_kernels.py's shapes; PERF.md): 16 on the chains of 2 and
// 7 joints (iiwa: 1.06-1.08x a warp's time at 1 and 1024 lanes, but at
// 131072 a warp took 1.6x and 8 threads 1.08x its time) and at 12 (hyq,
// 16384 lanes), a warp otherwise (on atlas 16 threads took 1.3x a warp's
// time); G the largest power of 2 up to 8 that fits (32-byte runs of its
// output rows in either dtype).
template <int NJ>
GT_HDI constexpr int crba_lanes() {
  return NJ == 2 || NJ == 7 || NJ == 12 ? 16 : WARP;
}
template <typename T, int NJ>
using CRBAKnot1 = KnotShape<T, RobotConst<T, NJ>, CRBAKnot<NJ>::SIZE,
                            crba_lanes<NJ>(), 1>;
template <typename T, int NJ>
using CRBAPlan = KnotShape<
    T, RobotConst<T, NJ>, CRBAKnot<NJ>::SIZE, crba_lanes<NJ>(),
    best_knots(CRBAKnot1<T, NJ>::HEAD,
               CRBAKnot1<T, NJ>::STRIDE * (long long)sizeof(T),
               crba_lanes<NJ>(), fd_regs<T>(), true)>;
// eepos's plan: a phase has at most 12 items (an entry of rows 0-2 of a
// 4x4 product), so 8 threads a lane (4 and 16 ran no faster at 131072 iiwa
// lanes), G the largest power of 2 up to 8 that fits (each of the 6 output
// rows of an EE is G consecutive lanes).
constexpr int EE_LANES = 8;
template <typename T, int NJ>
using EEKnot1 = KnotShape<T, EEHead<T, NJ, false>, EEKnot<NJ>::SIZE,
                          EE_LANES, 1>;
template <typename T, int NJ>
using EEPlan = KnotShape<
    T, EEHead<T, NJ, false>, EEKnot<NJ>::SIZE, EE_LANES,
    best_knots(EEKnot1<T, NJ>::HEAD,
               EEKnot1<T, NJ>::STRIDE * (long long)sizeof(T), EE_LANES,
               fd_regs<T>(), true)>;

// deepos's plan: the shape that ran fastest for iiwa at config 3's 131072
// lanes (compare_kernels.py's shapes; PERF.md), one for every batch: 4
// threads a lane (its phases have 7-84 items on iiwa), its knots
// group_stride apart (16 banks apart, 4 threads a lane took 1.8x and 8
// threads 1.27x the time), G the largest power of 2 up to DJ_MAX_G = 16
// that fits (G = 16 ran 4% faster than 8 at
// 131072 lanes; each of the 6 NJ output rows of an EE is G consecutive
// lanes: 64-byte runs in float32).
constexpr int DJ_LANES = 4, DJ_MAX_G = 16;
template <typename T, int NJ>
using DJKnot1 = GroupShape<T, EEHead<T, NJ>, DJKnot<NJ>::SIZE, DJ_LANES, 1>;
template <typename T, int NJ>
using DJPlan = GroupShape<
    T, EEHead<T, NJ>, DJKnot<NJ>::SIZE, DJ_LANES,
    best_knots(DJKnot1<T, NJ>::HEAD,
               DJKnot1<T, NJ>::STRIDE * (long long)sizeof(T), DJ_LANES,
               fd_regs<T>(), true, DJ_MAX_G)>;

// Knot g of the block takes lane l0 + g. The block reads the (NJ, G) tiles
// of q, qd and u (G consecutive lanes a row; the first INPUTS of them) into
// its knots; lanes past L read zeros.
template <typename T, int NJ, int KNOT, int INPUTS = 3>
GT_HD void load_inputs(const T* q, const T* qd, const T* u, long long L,
                       long long l0, int G, T* knots, int tid, int nthreads) {
  for (int e = tid; e < INPUTS * NJ * G; e += nthreads) {
    const int w = e / (NJ * G), r = (e / G) % NJ, g = e % G;
    const T* src = w == 0 ? q : (w == 1 ? qd : u);
    const long long l = l0 + g;
    knots[(long long)g * KNOT + w * NJ + r] = l < L ? src[r * L + l] : T(0);
  }
}

// Row r < rows of each knot's block at `first` (knot 0's row 0) to row r of
// the lane-major (rows, L) output, G consecutive lanes at a time.
template <typename T, int KNOT>
GT_HD void store_rows(const T* first, int rows, T* dst, long long L,
                      long long l0, int G, int tid, int nthreads) {
  for (int e = tid; e < rows * G; e += nthreads) {
    const int r = e / G, g = e % G;
    const long long l = l0 + g;
    if (l < L) dst[r * L + l] = first[(long long)g * KNOT + r];
  }
}

}  // namespace gt

#ifndef __CUDACC__
#include <limits>
#include <type_traits>
#include <vector>

namespace gt {

// Host drivers (the tests' g++ build, csrc/opcount.cpp): the block code of
// the kernels with G = 1, every lane in turn, each knot's buffer filled
// with NaN first so that a read of state no phase wrote shows (idsva_so:
// the card's G, each block's valid knots in turn). A number type other
// than float (csrc/opcount.cpp's counting type) takes double's plan.
template <typename T>
using PlanType =
    typename std::conditional<sizeof(T) == 4, float, double>::type;

// fd_du on chip (FDChipPlan of PT's dtype): a knot at a time, the
// cluster's regions in one buffer
template <typename T, int NJ, typename PT = PlanType<T>>
void fd_du_chip_host(const T* model, const T* q, const T* qd, const T* u,
                     T* dfdu, T* qdd, T* Mi, long long L, T gravity) {
  using P = FDChipPlan<PT, NJ>;
  static_assert(P::CL >= 1, "one fd_du knot fits a cluster");
  std::vector<RobotConst<T, NJ>> R(1);
  R[0].load(model, 0, 1);
  std::vector<T> buf(P::CL * P::RANK_VALUES);
  T* rg[3] = {buf.data() + P::RK_BASE * P::RANK_VALUES + P::OF_BASE,
              buf.data() + P::RK_MSM * P::RANK_VALUES + P::OF_MSM,
              buf.data() + P::RK_FMC * P::RANK_VALUES + P::OF_FMC};
  for (long long l = 0; l < L; ++l) {
    for (auto& x : buf) x = T(std::numeric_limits<double>::quiet_NaN());
#ifdef GT_RACE_CHECK
    gt_race_watch(buf.data(), (long)(buf.size() * sizeof(T)));
#endif
    fd_du_chip_lane<T, NJ, P>(HostPar<P::LANES>{}, R[0], rg, q, qd, u, dfdu,
                              qdd, Mi, L, l, gravity);
  }
#ifdef GT_RACE_CHECK
  gt_race_watch(nullptr, 0);
#endif
}

template <typename T, int NJ>
void fd_du_host(const T* model, const T* q, const T* qd, const T* u, T* dfdu,
                T* qdd, T* Mi, long long L, T gravity) {
  if constexpr (fd_on_chip<PlanType<T>, NJ>()) {
    fd_du_chip_host<T, NJ>(model, q, qd, u, dfdu, qdd, Mi, L, gravity);
    return;
  }
  using O = FDKnot<NJ>;
  std::vector<RobotConst<T, NJ>> R(1);
  R[0].load(model, 0, 1);
  std::vector<T> k(O::SIZE);
  for (long long l = 0; l < L; ++l) {
    for (auto& x : k) x = T(std::numeric_limits<double>::quiet_NaN());
    load_inputs<T, NJ, O::SIZE>(q, qd, u, L, l, 1, k.data(), 0, 1);
    fd_du_knot<T, NJ>(HostPar<FDPlan<T, NJ>::LANES>{}, R[0], k.data(),
                      gravity);
    store_rows<T, O::SIZE>(k.data() + O::DFDU, 2 * NJ * NJ, dfdu, L, l, 1,
                           0, 1);
    store_rows<T, O::SIZE>(k.data() + O::QDD, NJ, qdd, L, l, 1, 0, 1);
    store_rows<T, O::SIZE>(k.data() + O::MI, NJ * NJ, Mi, L, l, 1, 0, 1);
  }
}

template <typename T, int NJ, template <typename, int> class DOp = DFormed>
void fdsva_so_host(const T* model, const T* q, const T* qd, const T* u,
                   T* out, long long L, T gravity) {
  using O = SOKnot<NJ>;
  std::vector<RobotConst<T, NJ>> R(1);
  R[0].load(model, 0, 1);
  std::vector<SOLists<NJ>> lists(1);
  lists[0].build(R[0]);
  std::vector<T> k(O::SIZE);
  for (long long l = 0; l < L; ++l) {
    for (auto& x : k) x = T(std::numeric_limits<double>::quiet_NaN());
    load_inputs<T, NJ, O::SIZE>(q, qd, u, L, l, 1, k.data(), 0, 1);
    fdsva_so_knot<T, NJ, DOp>(HostPar<SOPlan<T, NJ>::LANES>{}, R[0],
                              lists[0], k.data(), gravity);
    store_rows<T, O::SIZE>(k.data() + O::TILE, 4 * O::N3, out, L, l, 1, 0,
                           1);
  }
}

template <typename T, int NJ, template <typename, int> class DOp = DFormed,
          typename PT = PlanType<T>>
void idsva_so_host(const T* model, const T* q, const T* qd, const T* qdd,
                   T* out, long long L, T gravity) {
  using O = IDKnot<NJ>;
  using P = IDSOPlan<PT, NJ>;
  static_assert(P::G >= 1, "one idsva_so knot must fit");
  std::vector<RobotConst<T, NJ>> R(1);
  R[0].load(model, 0, 1);
  std::vector<SOLists<NJ>> lists(1);
  lists[0].build(R[0]);
  std::vector<T> k((long long)P::G * O::SIZE);
  for (long long l0 = 0; l0 < L; l0 += P::G) {
    for (auto& x : k) x = T(std::numeric_limits<double>::quiet_NaN());
    load_inputs<T, NJ, O::SIZE>(q, qd, qdd, L, l0, P::G, k.data(), 0, 1);
    for (int g = 0; g < P::G && l0 + g < L; ++g)
      idsva_so_knot<T, NJ, O, DOp>(HostPar<P::LANES>{}, R[0], lists[0],
                                   k.data() + (long long)g * O::SIZE,
                                   gravity);
    store_rows<T, O::SIZE>(k.data() + O::TILE, 4 * O::N3, out, L, l0, P::G,
                           0, 1);
  }
}

// idsva_so's banded block code with the card's G (IDSOBandPlan of PT's
// dtype): at each band (or only band `only`), each block's valid knots in
// turn, then the band's rows
template <typename T, int NJ, template <typename, int> class DOp = DFormed,
          typename PT = PlanType<T>>
void idsva_so_band_host(const T* model, const T* q, const T* qd,
                        const T* qdd, T* out, long long L, T gravity,
                        int only = -1) {
  using P = IDSOBandPlan<PT, NJ>;
  static_assert(P::G >= 1, "one idsva_so band must fit");
  using O = IDBandKnot<NJ, P::BAND_ROWS, P::LANES>;
  constexpr int ROWS = P::BAND_ROWS, N2 = NJ * NJ;
  std::vector<RobotConst<T, NJ>> R(1);
  R[0].load(model, 0, 1);
  std::vector<SOLists<NJ>> lists(1);
  lists[0].build(R[0]);
  std::vector<T> k((long long)P::G * O::SIZE);
  for (int band = 0; band < P::BANDS; ++band) {
    if (only >= 0 && band != only) continue;
    const int r0 = band * ROWS;
    const int rows = 4 * NJ - r0 < ROWS ? 4 * NJ - r0 : ROWS;
    for (long long l0 = 0; l0 < L; l0 += P::G) {
      for (auto& x : k) x = T(std::numeric_limits<double>::quiet_NaN());
      load_inputs<T, NJ, O::SIZE>(q, qd, qdd, L, l0, P::G, k.data(), 0, 1);
      for (int g = 0; g < P::G && l0 + g < L; ++g)
        idsva_so_knot<T, NJ, O, DOp, ROWS>(
            HostPar<P::LANES>{}, R[0], lists[0],
            k.data() + (long long)g * O::SIZE, gravity, r0);
      store_rows<T, O::SIZE>(k.data() + O::TILE, rows * N2,
                             out + (long long)r0 * N2 * L, L, l0, P::G, 0,
                             1);
    }
  }
}

// idsva_so's device-memory tile (IDSOTilePlan of PT's dtype) with the
// card's G: the output zeroed (the launcher's memset), then each block's
// valid knots in turn, each accumulating in its lane of `out`; the lists
// `lists` (ntrip triples, then npair pairs)
template <typename T, int NJ, typename PT = PlanType<T>>
void idsva_so_tile_host(const T* model, const T* q, const T* qd,
                        const T* qdd, T* out, long long L, T gravity,
                        const int* lists, int ntrip, int npair) {
  using O = IDKnot<NJ>;
  using P = IDSOTilePlan<PT, NJ>;
  static_assert(P::G >= 1, "one idsva_so knot's stage quantities must fit");
  constexpr int S = O::STAGES_END;
  const SOListView lv{ntrip, npair, lists, lists + ntrip};
  std::vector<RobotConst<T, NJ>> R(1);
  R[0].load_tree(model, 0, 1);
  for (long long e = 0; e < 4LL * O::N3 * L; ++e) out[e] = T(0);
  std::vector<T> k((long long)P::G * S);
  for (long long l0 = 0; l0 < L; l0 += P::G) {
    for (auto& x : k) x = T(std::numeric_limits<double>::quiet_NaN());
    load_inputs<T, NJ, S>(q, qd, qdd, L, l0, P::G, k.data(), 0, 1);
    for (int g = 0; g < P::G && l0 + g < L; ++g) {
#ifdef GT_RACE_CHECK
      gt_race_watch(k.data() + (long long)g * S, S * (long)sizeof(T));
#endif
      idsva_so_knot_to<T, NJ>(HostPar<P::LANES>{}, R[0], lv,
                              k.data() + (long long)g * S, gravity,
                              out + l0 + g, L);
    }
  }
#ifdef GT_RACE_CHECK
  gt_race_watch(nullptr, 0);
#endif
}

// idsva_so's block code as the card runs it in PT's dtype (idso_route):
// the whole tile where one knot's fits a block, else in bands, else in
// device memory (the lists built here)
template <typename T, int NJ, template <typename, int> class DOp = DFormed,
          typename PT = PlanType<T>>
void idsva_so_plan_host(const T* model, const T* q, const T* qd,
                        const T* qdd, T* out, long long L, T gravity) {
  if constexpr (idso_route<PT, NJ>() == IDSO_WHOLE) {
    idsva_so_host<T, NJ, DOp, PT>(model, q, qd, qdd, out, L, gravity);
  } else if constexpr (idso_route<PT, NJ>() == IDSO_BANDS) {
    idsva_so_band_host<T, NJ, DOp, PT>(model, q, qd, qdd, out, L, gravity);
  } else {
    std::vector<RobotConst<T, NJ>> R(1);
    R[0].load(model, 0, 1);
    int ntrip = 0, npair = 0;
    const std::vector<int> lists = so_lists_host<NJ>(R[0], &ntrip, &npair);
    idsva_so_tile_host<T, NJ, PT>(model, q, qd, qdd, out, L, gravity,
                                  lists.data(), ntrip, npair);
  }
}

// id_du's block code with the card's G, each block's valid knots in turn
template <typename T, int NJ, int PASSES = idu_passes<NJ>()>
void id_du_host(const T* model, const T* q, const T* qd, const T* qdd,
                T* dcdu, long long L, T gravity) {
  using O = IDUKnot<NJ, PASSES>;
  using P = IDUPlan<PlanType<T>, NJ, PASSES>;
  constexpr int G = plan_g<P>();
  std::vector<RobotConst<T, NJ>> R(1);
  R[0].load(model, 0, 1);
  std::vector<T> k((long long)G * O::SIZE);
  for (long long l0 = 0; l0 < L; l0 += G) {
    for (auto& x : k) x = T(std::numeric_limits<double>::quiet_NaN());
    load_inputs<T, NJ, O::SIZE>(q, qd, qdd, L, l0, G, k.data(), 0, 1);
    for (int g = 0; g < G && l0 + g < L; ++g) {
#ifdef GT_RACE_CHECK
      gt_race_watch(k.data() + (long long)g * O::SIZE,
                    O::SIZE * (long)sizeof(T));
#endif
      id_du_knot<T, NJ, PASSES>(HostPar<P::LANES>{}, R[0],
                                k.data() + (long long)g * O::SIZE, gravity);
    }
    store_rows<T, O::SIZE>(k.data() + O::DC, 2 * NJ * NJ, dcdu, L, l0, G, 0,
                           1);
  }
#ifdef GT_RACE_CHECK
  gt_race_watch(nullptr, 0);
#endif
}

// rnea's block code with the card's G, each block's valid knots in turn (qdd
// null: the bias form)
template <typename T, int NJ>
void rnea_host(const T* model, const T* q, const T* qd, const T* qdd, T* c,
               long long L, T gravity) {
  using O = RNEAKnot<NJ>;
  using P = RNEAPlan<PlanType<T>, NJ>;
  static_assert(P::G >= 1, "one rnea knot must fit");
  std::vector<RobotConst<T, NJ>> R(1);
  R[0].load_tree(model, 0, 1);
  std::vector<T> k((long long)P::G * O::SIZE);
  for (long long l0 = 0; l0 < L; l0 += P::G) {
    for (auto& x : k) x = T(std::numeric_limits<double>::quiet_NaN());
    if (qdd)
      load_inputs<T, NJ, O::SIZE>(q, qd, qdd, L, l0, P::G, k.data(), 0, 1);
    else
      load_inputs<T, NJ, O::SIZE, 2>(q, qd, qdd, L, l0, P::G, k.data(), 0,
                                     1);
    for (int g = 0; g < P::G && l0 + g < L; ++g) {
      T* kg = k.data() + (long long)g * O::SIZE;
#ifdef GT_RACE_CHECK
      gt_race_watch(kg, O::SIZE * (long)sizeof(T));
#endif
      if (qdd)
        rnea_knot<RNEA_FULL, T, NJ>(HostPar<P::LANES>{}, R[0], kg, gravity);
      else
        rnea_knot<RNEA_BIAS, T, NJ>(HostPar<P::LANES>{}, R[0], kg, gravity);
    }
    store_rows<T, O::SIZE>(k.data() + O::C, NJ, c, L, l0, P::G, 0, 1);
  }
#ifdef GT_RACE_CHECK
  gt_race_watch(nullptr, 0);
#endif
}

// fd's block code with the card's G, each block's valid knots in turn
template <typename T, int NJ>
void fd_host(const T* model, const T* q, const T* qd, const T* u, T* qdd,
             long long L, T gravity) {
  using O = FDQKnot<NJ>;
  using P = FDPlanQ<PlanType<T>, NJ>;
  constexpr int G = plan_g<P>();
  std::vector<RobotConst<T, NJ>> R(1);
  R[0].load_tree(model, 0, 1);
  std::vector<T> k((long long)G * O::SIZE);
  for (long long l0 = 0; l0 < L; l0 += G) {
    for (auto& x : k) x = T(std::numeric_limits<double>::quiet_NaN());
    load_inputs<T, NJ, O::SIZE>(q, qd, u, L, l0, G, k.data(), 0, 1);
    for (int g = 0; g < G && l0 + g < L; ++g) {
      T* kg = k.data() + (long long)g * O::SIZE;
#ifdef GT_RACE_CHECK
      gt_race_watch(kg, O::SIZE * (long)sizeof(T));
#endif
      fd_knot<T, NJ>(HostPar<P::LANES>{}, R[0], kg, gravity);
    }
    store_rows<T, O::SIZE>(k.data() + O::QDD, NJ, qdd, L, l0, G, 0, 1);
  }
#ifdef GT_RACE_CHECK
  gt_race_watch(nullptr, 0);
#endif
}

// minv's block code with the card's G, each block's valid knots in turn
// (dense: the mirrored instance, else the upper factor's)
template <typename T, int NJ>
void minv_host(const T* model, const T* q, T* Mi, long long L, bool dense) {
  using O = MinvKnot<NJ>;
  using P = MinvPlan<PlanType<T>, NJ>;
  constexpr int G = plan_g<P>();
  std::vector<RobotConst<T, NJ>> R(1);
  R[0].load_tree(model, 0, 1);
  std::vector<T> k((long long)G * O::SIZE);
  for (long long l0 = 0; l0 < L; l0 += G) {
    for (auto& x : k) x = T(std::numeric_limits<double>::quiet_NaN());
    load_q<T, NJ, O::SIZE>(q, L, l0, G, k.data(), 0, 1);
    for (int g = 0; g < G && l0 + g < L; ++g) {
      T* kg = k.data() + (long long)g * O::SIZE;
#ifdef GT_RACE_CHECK
      gt_race_watch(kg, O::SIZE * (long)sizeof(T));
#endif
      if (dense)
        minv_knot<true, T, NJ>(HostPar<P::LANES>{}, R[0], kg);
      else
        minv_knot<false, T, NJ>(HostPar<P::LANES>{}, R[0], kg);
    }
    store_rows<T, O::SIZE>(k.data() + O::MI, NJ * NJ, Mi, L, l0, G, 0, 1);
  }
#ifdef GT_RACE_CHECK
  gt_race_watch(nullptr, 0);
#endif
}

// crba's block code with the card's G, each block's valid knots in turn
template <typename T, int NJ>
void crba_host(const T* model, const T* q, T* M, long long L) {
  using O = CRBAKnot<NJ>;
  using P = CRBAPlan<PlanType<T>, NJ>;
  static_assert(P::G >= 1, "one crba knot must fit");
  std::vector<RobotConst<T, NJ>> R(1);
  R[0].load_tree(model, 0, 1);
  std::vector<T> k((long long)P::G * O::SIZE);
  for (long long l0 = 0; l0 < L; l0 += P::G) {
    for (auto& x : k) x = T(std::numeric_limits<double>::quiet_NaN());
    load_q<T, NJ, O::SIZE>(q, L, l0, P::G, k.data(), 0, 1);
    for (int g = 0; g < P::G && l0 + g < L; ++g) {
      T* kg = k.data() + (long long)g * O::SIZE;
#ifdef GT_RACE_CHECK
      gt_race_watch(kg, O::SIZE * (long)sizeof(T));
#endif
      crba_knot<T, NJ>(HostPar<P::LANES>{}, R[0], kg);
    }
    store_rows<T, O::SIZE>(k.data() + O::M, NJ * NJ, M, L, l0, P::G, 0, 1);
  }
#ifdef GT_RACE_CHECK
  gt_race_watch(nullptr, 0);
#endif
}

// eepos's block code with the card's G: at each EE, each block's valid
// knots in turn, then the block's rows
template <typename T, int NJ>
void eepos_host(const T* model, const T* ee, int ne, const T* q, T* out,
                long long L) {
  using O = EEKnot<NJ>;
  using P = EEPlan<PlanType<T>, NJ>;
  static_assert(P::G >= 1, "one eepos knot must fit");
  std::vector<EEHead<T, NJ, false>> H(1);
  H[0].load(model, 0, 1);
  std::vector<T> k((long long)P::G * O::SIZE);
  for (int e = 0; e < ne; ++e) {
    H[0].select(ee + e * EERow<NJ>::SIZE, 0, 1);
    for (long long l0 = 0; l0 < L; l0 += P::G) {
      for (auto& x : k) x = T(std::numeric_limits<double>::quiet_NaN());
      load_q<T, NJ, O::SIZE>(q, L, l0, P::G, k.data(), 0, 1);
      for (int g = 0; g < P::G && l0 + g < L; ++g) {
        T* kg = k.data() + (long long)g * O::SIZE;
#ifdef GT_RACE_CHECK
        gt_race_watch(kg, O::SIZE * (long)sizeof(T));
#endif
        eepos_knot<T, NJ>(HostPar<P::LANES>{}, H[0], kg);
      }
      store_rows<T, O::SIZE>(k.data() + O::POSE, 6, out + 6LL * e * L, L, l0,
                             P::G, 0, 1);
    }
  }
#ifdef GT_RACE_CHECK
  gt_race_watch(nullptr, 0);
#endif
}

// d2eepos's block code with the card's G: at each EE, each block's valid
// knots in turn, then the block's store
template <typename T, int NJ, bool STAGE = d2_stages<PlanType<T>, NJ>()>
void d2eepos_host(const T* model, const T* ee, int ne, const T* q, T* out,
                  long long L) {
  using O = D2Knot<NJ>;
  using P = D2Plan<PlanType<T>, NJ>;
  static_assert(P::G >= 1, "one d2eepos knot must fit");
  std::vector<EEHead<T, NJ>> H(1);
  H[0].load(model, 0, 1);
  std::vector<T> k((long long)P::G * O::SIZE);
  for (int e = 0; e < ne; ++e) {
    H[0].select(ee + e * EERow<NJ>::SIZE, 0, 1);
    T* oe = out + 6LL * e * NJ * NJ * L;
    for (long long l0 = 0; l0 < L; l0 += P::G) {
      for (auto& x : k) x = T(std::numeric_limits<double>::quiet_NaN());
      load_q<T, NJ, O::SIZE>(q, L, l0, P::G, k.data(), 0, 1);
      for (int g = 0; g < P::G && l0 + g < L; ++g) {
#ifdef GT_RACE_CHECK
        gt_race_watch(k.data() + (long long)g * O::SIZE,
                      O::SIZE * (long)sizeof(T));
#endif
        d2eepos_knot<T, NJ, STAGE>(HostPar<P::LANES>{}, H[0],
                                   k.data() + (long long)g * O::SIZE, oe, L,
                                   l0 + g);
      }
      d2eepos_store<T, NJ, O::SIZE, P::G, STAGE>(H[0], k.data(), oe, L, l0,
                                                 0, 1);
    }
  }
#ifdef GT_RACE_CHECK
  gt_race_watch(nullptr, 0);
#endif
}

// deepos's block code with the card's G: at each EE, each block's valid
// knots in turn, then the block's rows
template <typename T, int NJ>
void deepos_host(const T* model, const T* ee, int ne, const T* q, T* out,
                 long long L) {
  using O = DJKnot<NJ>;
  using P = DJPlan<PlanType<T>, NJ>;
  static_assert(P::G >= 1, "one deepos knot must fit");
  std::vector<EEHead<T, NJ>> H(1);
  H[0].load(model, 0, 1);
  std::vector<T> k((long long)P::G * O::SIZE);
  for (int e = 0; e < ne; ++e) {
    H[0].select(ee + e * EERow<NJ>::SIZE, 0, 1);
    T* oe = out + 6LL * e * NJ * L;
    for (long long l0 = 0; l0 < L; l0 += P::G) {
      for (auto& x : k) x = T(std::numeric_limits<double>::quiet_NaN());
      load_q<T, NJ, O::SIZE>(q, L, l0, P::G, k.data(), 0, 1);
      for (int g = 0; g < P::G && l0 + g < L; ++g) {
        T* kg = k.data() + (long long)g * O::SIZE;
#ifdef GT_RACE_CHECK
        gt_race_watch(kg, O::SIZE * (long)sizeof(T));
#endif
        deepos_knot<T, NJ>(HostPar<P::LANES>{}, H[0], kg);
      }
      deepos_store<T, NJ, O::SIZE, P::G>(H[0], k.data(), oe, L, l0, 0, 1);
    }
  }
#ifdef GT_RACE_CHECK
  gt_race_watch(nullptr, 0);
#endif
}

}  // namespace gt
#endif

#ifdef __CUDACC__
#include <type_traits>

namespace gt {

// The lanes of a block on the device-memory route (WsPlan): lanes
// blockIdx.x, + gridDim.x, ... one at a time, through the block's knot in
// the workspace: load(l), run(), store(l), the block meeting between them
// (a barrier orders the block's device-memory accesses as it does its
// shared ones).
template <class Load, class Run, class Store>
__device__ __forceinline__ void ws_lanes(long long L, Load&& load, Run&& run,
                                         Store&& store) {
  for (long long l = blockIdx.x; l < L; l += gridDim.x) {
    __syncthreads();   // the head has landed; the last lane's rows are out
    load(l);
    __syncthreads();
    run();
    __syncthreads();
    store(l);
  }
}

// The on-chip programs' cluster (warp.cuh: ChipPack; CL blocks, CL 1: the
// block alone), in PTX (cooperative_groups' header would add seconds of
// nvcc to every source): this block's rank (%cluster_ctarank), the
// cluster's barrier (arrive with release, wait with acquire: every shared
// write of a phase is seen by the next phase in every block), and the
// generic address of `p` (this block's shared memory) in rank r's (mapa;
// this block's own address for its own rank).
template <int CL>
__device__ __forceinline__ int chip_rank() {
  if constexpr (CL == 1) {
    return 0;
  } else {
    unsigned r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
    return (int)r;
  }
}
template <int CL>
__device__ __forceinline__ void chip_sync() {
  if constexpr (CL == 1) {
    __syncthreads();
  } else {
    asm volatile("barrier.cluster.arrive.release;" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
  }
}
template <int CL, typename P>
__device__ __forceinline__ P* chip_map(P* p, int r) {
  if constexpr (CL == 1) {
    return p;
  } else {
    if (r == chip_rank<CL>()) return p;
    unsigned long long q;
    asm volatile("mapa.u64 %0, %1, %2;"
                 : "=l"(q)
                 : "l"(reinterpret_cast<unsigned long long>(p)), "r"(r));
    return reinterpret_cast<P*>(q);
  }
}

// The cluster's N threads (thread `lane` = rank * threads a block + the
// thread's index), a phase ended by the cluster's barrier. CLOCKED (the
// phase clock of the kernels built with GT_CHIP_CLOCK): thread 0 records
// clock64() after each phase at clk[(*n)++].
template <int N, int CL, bool CLOCKED = false>
struct ChipPar {
  static constexpr int LANES = N;
  int lane;
  long long* clk = nullptr;
  int* n = nullptr;
  template <class F>
  __device__ __forceinline__ void operator()(F&& f) const {
    f(lane);
    chip_sync<CL>();
    if (CLOCKED && lane == 0) clk[(*n)++] = clock64();
  }
};

// A kernel's dynamic shared-memory limit, and the largest carve-out of an
// SM's L1 for shared memory, so that as many blocks as the plan counts fit.
template <class K>
inline cudaError_t smem_attrs(K* fn, long long bytes) {
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(fn,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// Launch `fn`, a kernel of plan P on the device-memory route, over `units`
// lanes or problems: min(units, nws) blocks of P::LANES threads, the
// workspace `ws` holding nws knots (its last argument). The attributes are
// set at every launch: kernels of one signature (minv's dense and upper
// instances) share this instantiation.
template <class P, class... K, class... A>
inline int launch_ws(void (*fn)(K...), long long units, void* ws,
                     long long nws, cudaStream_t stream, A... args) {
  if (units == 0) return 0;
  if (ws == nullptr || nws < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t attr = smem_attrs(fn, P::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  fn<<<(unsigned)(nws < units ? nws : units), P::LANES, P::BYTES, stream>>>(
      args...);
  return (int)cudaGetLastError();
}

// Launch `fn`, a kernel of an on-chip plan P (FDChipPlan, RicChipPlan),
// over `units` lanes or problems: clusters of P::CL blocks of P::NT
// threads, as many as the card holds at once (the occupancy calculator's
// active clusters) and at most `units`, each striding over the units.
template <class P, class... K, class... A>
inline int launch_chip(void (*fn)(K...), long long units, cudaStream_t stream,
                       A... args) {
  if (units == 0) return 0;
  cudaError_t e = smem_attrs(fn, P::BYTES);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P::CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P::CL);
  cfg.blockDim = dim3(P::NT);
  cfg.dynamicSmemBytes = (size_t)P::BYTES;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int most = 0;
  e = cudaOccupancyMaxActiveClusters(&most, fn, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (most < 1) return (int)cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3((unsigned)((units < most ? units : most) * P::CL));
  e = cudaLaunchKernelEx(&cfg, fn, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The block plan P of kernel `fn` and its launch attributes, for the
// wrappers and chip_smoke.py: out = {G, threads a knot, dynamic shared
// bytes a block, registers a thread, local (stack) bytes a thread, static
// shared bytes, max threads a block, max dynamic shared bytes, programs a
// block per problem (the line search's step-size rows), blocks an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), blocks a lane (idsva_so
// in bands: the bands; else 1), device-memory bytes a block (the workspace
// of the device-memory route; 0 on the shared-memory one), 1 where the
// output tile accumulates in device memory (idsva_so: IDSOTilePlan), blocks
// a problem (an on-chip plan's cluster; else 1)}. `fn` null (a kernel that
// is not instantiated): the plan alone.
template <class P, class = void>
struct PlanBands {
  static constexpr int value = 1;
};
template <class P>
struct PlanBands<P, std::void_t<decltype(P::BANDS)>> {
  static constexpr int value = P::BANDS;
};
template <class P, class = void>
struct PlanDeviceTile {
  static constexpr int value = 0;
};
template <class P>
struct PlanDeviceTile<P, std::void_t<decltype(P::DEVICE_TILE)>> {
  static constexpr int value = P::DEVICE_TILE ? 1 : 0;
};

template <class P>
inline int kernel_info(const void* fn, int* out) {
  constexpr int cl = PlanCluster<P>::value;
  out[8] = P::ROWS;
  out[9] = 0;
  out[10] = PlanBands<P>::value;
  out[11] = (int)PlanWs<P>::value;
  out[12] = PlanDeviceTile<P>::value;
  out[13] = cl;
  // the launch's attributes, which the occupancy calculator reads; a plan
  // that holds no knot (G 0) and has no device-memory route is never
  // launched, and querying it would leave an error that the library's next
  // call reports
  if (fn != nullptr && (P::G >= 1 || PlanWs<P>::value > 0)) {
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)P::BYTES);
    cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
    int blocks = 0;
    const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fn, plan_g<P>() * P::ROWS * P::LANES / cl,
        (size_t)P::BYTES);
    out[9] = occ == cudaSuccess ? blocks : -1;
  }
  cudaFuncAttributes a{};
  const cudaError_t err =
      fn == nullptr ? cudaSuccess : cudaFuncGetAttributes(&a, fn);
  out[0] = P::G;
  out[1] = P::LANES;
  out[2] = (int)P::BYTES;
  out[3] = a.numRegs;
  out[4] = (int)a.localSizeBytes;
  out[5] = (int)a.sharedSizeBytes;
  out[6] = a.maxThreadsPerBlock;
  out[7] = a.maxDynamicSharedSizeBytes;
  return (int)err;
}

}  // namespace gt
#endif
