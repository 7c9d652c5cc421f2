"""The thread-group kernels of this checkout against those of another, on one
card.

    python3 compare_kernels.py --other DIR [--other DIR2 ...]
                               [--kernels riccati_factored,linesearch,...]
                               [--sass rollout,fd_du,...]
                               [--out build/compare_kernels.json]
    python3 compare_kernels.py --other DIR --hands52

``--hands52`` compares only fd_du and the dense riccati (stationary and
per knot) at 52 joints (atlas_hands52, tests/torch_big_robots.py), where a
knot or problem does not fit a block beside others (an earlier tree's
device-memory route, this tree's on-chip one): each tree's fd_du.cu and
riccati.cu compiled at 52 joints with ``-Xptxas -v`` (registers, stack and
spills of each instance), each tree's block plans, and the device time of
a launch in float32 at config 5's shapes (fd_du over N S = 65536 lanes,
riccati at N = 16, S = 4096; the stacked riccati at N = 16 on 512
problems) on the same inputs (a seed's random states and controls for
fd_du; for the sweeps A = I + dt (random), B = dt (random), an SPD
curvature), in turns: the others, this, this, the others in reverse; and
the largest difference of each output from the first other tree's,
relative to its scale, and for the sweeps each tree's from a float64 plain
run on the first 8 problems (`err_vs_f64`). It also clocks this tree's on-chip programs phase
by phase at those shapes in float32 (fd_du.cu and riccati.cu built with
``-DGT_CHIP_CLOCK``: clock64() after each phase of one lane or problem,
one cluster alone on the card; `phase_cycles`, the riccati's grouped by
step of its knot program and averaged over the knots), and times this
tree's two routes at the joint counts of ``--thresholds`` (kernel:dtype:
joints items; by default fd_du and the stationary riccati at 28 joints,
atlas, in both dtypes, just below where the on-chip routes take over;
atlas with grippers above 28), config 5's shapes: the route the library
takes there against the on-chip program forced there
(`gridtorch_riccati_chip_forced`, `gridtorch_fd_du_chip_forced`).

Each DIR is another checkout of this repository (for example the parent
commit, unpacked with ``git archive``), named by its directory. The
kernels (``--kernels``, any of fd_du, fdsva_so, idsva_so,
riccati_factored, linesearch, riccati, rollout, feedback_rollout, id_du,
d2eepos, rnea (its bias form too), aba, fd, eepos, minv (dense), crba and
deepos; by default riccati_factored, linesearch, riccati and rollout) are compiled from every
tree's ``csrc/`` with nvcc for sm_90a, one library per joint count and
tree (the counts of JOINTS that the tree's ``build.py`` lists, the sources
it has; a tree without a kernel or a joint count is not timed there),
every nvcc at once, with ``-Xptxas -v``; the script prints each kernel
instance's
registers, stack, spills and static shared memory as ptxas reports them,
this tree's block plans and ``cudaFuncGetAttributes``
(``build.warp_kernel_info``), and then each kernel's device time per launch
(CUDA events) at the main paths' shapes in float32, every tree on the same
inputs, in turns: the others, this, this, the others in reverse (the
kernels of a knot or a lane at up to 1024 lanes also from a CUDA graph of
20 launches, `graph_ms`: back-to-back calls of a kernel of a few
microseconds read the host's time a call). The GRiD
kernels (fd_du, fdsva_so, idsva_so, id_du and rnea with u as qdd, rnea's
bias form, aba, fd, minv, crba, and eepos, deepos and d2eepos on q at every
EE of the robot) run on inputs ~ U(-1, 1); the sweeps on the inputs of the solver's first iteration (plain ops:
config 3's EE reach and QuadCost task at N=64, B=2048, config 4's
QuadCost at N=32, each with six step sizes; the dense riccati on the
QuadCost task's stationary curvature, the rollout on the solver's first
rollout, U0 = 0; the feedback rollout on the line search's inputs with
kff = FB_ALPHA k, config 3's tracking shape and config 4's trees). It also
checks this tree on every shape by the float32 rule of ``chip_smoke.py``:
against a float64 plain run on the first problems (or lanes), within 10 x
the first other tree's own error plus 1e-5 of the scale (the line search
per step-size row). And it clocks this tree's programs phase by phase
(csrc/warp.cuh, csrc/sweep_warp.cuh, built into kernels that wrap each
phase in clock64()): the cycles of every phase of unit 0 of block 0, while
the other blocks run as in a launch; for the sweeps the mean of each phase
over the knots (for the knot programs also the cycles of the block's head:
the robot's constants and lists). fd, eepos, minv, crba and deepos also
get the cycles of their serial function (dynamics.cuh: fd_lane,
ee_pose_lane, minv_lane, crba_lane, ee_jac_lane) on lane 0 of a thread a
lane, as an earlier tree's kernels ran them, and the time through this
tree's wrapper (ops/cuda/kernels.py, as the GRiD API calls it); crba on iiwa at 1 and 1024 lanes also the time of
the crba wrapper followed by torch.linalg.inv of M, Minv by two calls
(`crba_inv_ms`). For the rollout and the feedback
rollout it also times this tree's block shapes (threads a rollout x
problems a block, csrc/sweep_warp.cuh: RollShape; those that fit an SM),
for idsva_so its knot
shapes (threads a knot x knots a block, csrc/warp.cuh: KnotShape; those
that fit an SM; as many blocks as the card holds, each taking every
gridDim.x-th group of lanes, and a block a group), for id_du one and two
column passes, for d2eepos its shapes (threads a lane x lanes a block,
staged or direct stores), for rnea, aba, fd, eepos, minv, crba and
deepos theirs (threads a knot x knots a block, LANE_SHAPES; eepos and
deepos EE_SHAPES), at every shape of the
kernel, against the plan's output. ``--sass`` compiles the named kernels'
sources in every tree too and compares this tree's machine code with the
first other tree's (``cuobjdump -sass`` of each object, float and double,
at each joint count), without timing them.
Needs one NVIDIA GPU and nvcc.
"""

import argparse
import concurrent.futures
import ctypes
import dataclasses
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
JOINTS = (2, 7, 8, 12, 16, 17, 28)
SOURCES = {"fd_du": "fd_du.cu", "fdsva_so": "fdsva_so.cu",
           "idsva_so": "idsva_so.cu", "riccati_factored": "riccati.cu",
           "linesearch": "linesearch.cu", "riccati": "riccati.cu",
           "rollout": "rollout.cu", "feedback_rollout": "feedback_rollout.cu",
           "id_du": "id_du.cu", "d2eepos": "d2eepos.cu", "rnea": "rnea.cu",
           "rnea_bias": "rnea.cu", "aba": "aba.cu", "fd": "fd.cu",
           "eepos": "eepos.cu", "minv": "minv.cu", "crba": "crba.cu",
           "deepos": "deepos.cu"}
# the kernels of a knot a thread group, on (n, lanes) inputs (d2eepos,
# eepos, minv (dense), crba and deepos: q only; rnea_bias: q and qd, rnea's
# bias form, timed wherever rnea is)
KNOT_KERNELS = ("fd_du", "fdsva_so", "idsva_so", "id_du", "d2eepos", "rnea",
                "rnea_bias", "aba", "fd", "eepos", "minv", "crba", "deepos")
# the phase clock's knot programs (PHASE_CLOCK_CU: phase_clock's mode)
CLOCK_MODE = {"fd_du": 0, "fdsva_so": 1, "idsva_so": 2, "id_du": 3,
              "rnea": 4, "rnea_bias": 5, "aba": 6, "fd": 7, "minv": 8,
              "crba": 9}
# the serial lane functions clocked a thread a lane (PHASE_CLOCK_CU:
# lane_clock's mode): fd_lane, ee_pose_lane, minv_lane, crba_lane,
# ee_jac_lane
SERIAL_MODE = {"fd": 0, "eepos": 1, "minv": 2, "crba": 3, "deepos": 4}
DEFAULT_KERNELS = "riccati_factored,linesearch,riccati,rollout"
# (kernel, robot, lanes): config 3 and the GRiD API (iiwa 131072 and 1024
# lanes), config 4's N*B lanes (iiwa 32768, the others 16384), config 5's
# fd_du (N*S = 65536 lanes on atlas and gym_humanoid) and gym_humanoid's
# fused fdsva_so at config 4's 16384; the sweeps
# (kernel, robot, (cost, N, B)): config 3 (EE reach and QuadCost task, N=64,
# B=2048) and config 4 (QuadCost, N=32, iiwa B=1024, the others 512); the
# dense riccati at the QuadCost task's (iiwa, N=64, B=2048) and on the
# 16-joint plan (dm_quadruped, N=32, B=512); the rollout at config 3's and
# config 4's first rollout ("roll", N, B); idsva_so at the GRiD API's 1024
# lanes and config 4's N*B; the feedback rollout at config 3's tracking
# shape (N=64, B=2048) and on config 4's trees (N=32, B=512); id_du and
# d2eepos at configs 1 and 2's B=1 and 1024 lanes, config 3's 131072 and
# 16384 lanes on the trees (gym_ant: its EEs welded to the base, zeros only);
# rnea (with qdd and the bias form) and aba at 1, 1024 and 131072 iiwa
# lanes, 16384 on hyq, at 1 (config 5's plant) and 1024 on atlas and (aba)
# gym_humanoid; fd, minv, crba and deepos at 1 (configs 1 and 2), 1024 and
# 131072 (config 3's EE cost: deepos) iiwa lanes, hyq at 16384, atlas at 1
# and 1024; eepos at those but hyq's 1024 (4 EEs); eepos and deepos also at
# 2048 iiwa lanes
SHAPES = [("fd_du", "iiwa", 131072), ("fd_du", "iiwa", 1024),
          ("fd_du", "iiwa", 32768), ("fd_du", "gym_ant", 16384),
          ("fd_du", "hyq", 16384), ("fd_du", "dm_quadruped", 16384),
          ("fd_du", "atlas", 65536), ("fd_du", "gym_humanoid", 65536),
          ("fdsva_so", "iiwa", 32768), ("fdsva_so", "iiwa", 1024),
          ("fdsva_so", "gym_ant", 16384), ("fdsva_so", "hyq", 16384),
          ("fdsva_so", "dm_quadruped", 16384),
          ("fdsva_so", "gym_humanoid", 16384),
          ("riccati_factored", "iiwa", ("ee", 64, 2048)),
          ("linesearch", "iiwa", ("ee", 64, 2048)),
          ("linesearch", "iiwa", ("quad3", 64, 2048)),
          ("linesearch", "iiwa", ("quad4", 32, 1024)),
          ("linesearch", "hyq", ("quad4", 32, 512)),
          ("linesearch", "gym_ant", ("quad4", 32, 512)),
          ("linesearch", "dm_quadruped", ("quad4", 32, 512)),
          ("riccati", "iiwa", ("quad3", 64, 2048)),
          ("riccati", "dm_quadruped", ("quad4", 32, 512)),
          ("rollout", "iiwa", ("roll", 64, 2048)),
          ("rollout", "iiwa", ("roll", 32, 1024)),
          ("rollout", "hyq", ("roll", 32, 512)),
          ("rollout", "gym_ant", ("roll", 32, 512)),
          ("rollout", "dm_quadruped", ("roll", 32, 512)),
          ("idsva_so", "iiwa", 1024), ("idsva_so", "iiwa", 32768),
          ("idsva_so", "hyq", 16384), ("idsva_so", "gym_ant", 16384),
          ("idsva_so", "dm_quadruped", 16384),
          ("feedback_rollout", "iiwa", ("ee", 64, 2048)),
          ("feedback_rollout", "hyq", ("quad4", 32, 512)),
          ("feedback_rollout", "gym_ant", ("quad4", 32, 512)),
          ("feedback_rollout", "dm_quadruped", ("quad4", 32, 512)),
          ("id_du", "iiwa", 1), ("id_du", "iiwa", 1024),
          ("id_du", "iiwa", 131072), ("id_du", "hyq", 16384),
          ("id_du", "dm_quadruped", 16384),
          ("d2eepos", "iiwa", 1), ("d2eepos", "iiwa", 1024),
          ("d2eepos", "iiwa", 131072), ("d2eepos", "hyq", 16384),
          ("d2eepos", "gym_ant", 16384), ("d2eepos", "dm_quadruped", 16384)]
SHAPES += [(what, robot, lanes) for what in ("rnea", "rnea_bias", "aba")
           for robot, lanes in (("iiwa", 1), ("iiwa", 1024), ("iiwa", 131072),
                                ("hyq", 16384), ("atlas", 1), ("atlas", 1024),
                                ("gym_humanoid", 1), ("gym_humanoid", 1024))
           if what == "aba" or robot != "gym_humanoid"]
SHAPES += [(what, robot, lanes)
           for what in ("fd", "eepos", "minv", "crba", "deepos")
           for robot, lanes in (("iiwa", 1), ("iiwa", 1024), ("iiwa", 131072),
                                ("hyq", 1024 if what == "eepos" else 16384),
                                ("atlas", 1), ("atlas", 1024))]
# eepos and deepos at config 3's terminal cost: B = 2048 lanes
SHAPES += [(what, "iiwa", 2048) for what in ("eepos", "deepos")]
# the rollout's block shapes timed beside its plan: (threads a rollout,
# problems a block), whole warps a block (8 x 2 is half a warp)
ROLL_SHAPES = ((8, 4), (8, 8), (16, 2), (16, 4), (16, 8), (32, 2), (32, 4),
               (32, 8))
# idsva_so's knot shapes timed beside its plan: (threads a knot as a
# multiple of the fewest, knots a block); the phase-clock library builds
# those that fit an SM
IDSO_SHAPES = ((1, 2), (1, 4), (1, 6), (1, 8), (2, 2), (2, 4), (2, 8),
               (4, 2), (4, 4))
# id_du's column passes timed beside its plan's (each with its BlockPlan)
IDU_PASSES = (1, 2)
# d2eepos's shapes timed beside its plan: (threads a lane, lanes a block),
# each with the staged and the direct stores
D2_SHAPES = ((8, 8), (8, 16), (16, 4), (16, 8), (32, 4), (32, 8))
# rnea's, aba's, fd's, eepos's, minv's, crba's and deepos's shapes timed
# beside their plans: (threads a knot, knots a block), whole warps a block;
# those that fit an SM
LANE_SHAPES = ((8, 4), (8, 8), (16, 2), (16, 4), (16, 8), (32, 1), (32, 2),
               (32, 4), (32, 8))
# eepos's and deepos's also with 4 threads a lane (an eepos phase has at
# most 12 items, a deepos one 12 k) and 16 lanes a block
EE_SHAPES = LANE_SHAPES + ((4, 8), (4, 16), (8, 16))
# the step size folded into the feedback rollout's kff (a power of 2: the
# fold is exact)
FB_ALPHA = 0.25
DT = {"dm_quadruped": 0.002}
# the sweeps' lanes held against float64: the first CHECK problems
CHECK = 256


# the programs with a clock around each phase; unit 0 of block 0 keeps its
# phases' cycles
PHASE_CLOCK_CU = r"""
#include <type_traits>

#include "rollout.cu"
#include "idsva_so.cu"
#include "feedback_rollout.cu"
#include "id_du.cu"
#include "d2eepos.cu"
#include "rnea.cu"
#include "aba.cu"
#include "fd.cu"
#include "eepos.cu"
#include "minv.cu"
#include "crba.cu"
#include "deepos.cu"

extern __shared__ double gt_smem[];

template <int N>
struct ClockPar {
  static constexpr int LANES = N;
  int lane, bar;
  long long* rec;
  int* count;
  template <class F>
  __device__ void operator()(F&& f) const {
    const long long t0 = clock64();
    f(lane);
    if (N <= 32) __syncwarp();
    else asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(N) : "memory");
    if (rec && lane == 0 && *count < 4096) rec[*count] = clock64() - t0;
    ++*count;
  }
};

// the knot programs: MODE 0 fd_du, 1 fdsva_so, 2 idsva_so, 3 id_du (u as
// qdd), 4 rnea (u as qdd), 5 rnea's bias form, 6 aba, 7 fd, 8 minv
// (dense), 9 crba
template <int MODE, typename T, int NJ>
struct KnotPlanOf {
  using type = gt::IDUPlan<T, NJ>;
};
template <typename T, int NJ>
struct KnotPlanOf<0, T, NJ> {
  using type = gt::FDPlan<T, NJ>;
};
template <typename T, int NJ>
struct KnotPlanOf<1, T, NJ> {
  using type = gt::SOPlan<T, NJ>;
};
template <typename T, int NJ>
struct KnotPlanOf<2, T, NJ> {
  using type = gt::IDSOPlan<T, NJ>;
};
template <typename T, int NJ>
struct KnotPlanOf<4, T, NJ> {
  using type = gt::RNEAPlan<T, NJ>;
};
template <typename T, int NJ>
struct KnotPlanOf<5, T, NJ> {
  using type = gt::RNEAPlan<T, NJ>;
};
template <typename T, int NJ>
struct KnotPlanOf<6, T, NJ> {
  using type = gt::ABAPlan<T, NJ>;
};
template <typename T, int NJ>
struct KnotPlanOf<7, T, NJ> {
  using type = gt::FDPlanQ<T, NJ>;
};
template <typename T, int NJ>
struct KnotPlanOf<8, T, NJ> {
  using type = gt::MinvPlan<T, NJ>;
};
template <typename T, int NJ>
struct KnotPlanOf<9, T, NJ> {
  using type = gt::CRBAPlan<T, NJ>;
};
template <int MODE, typename T, int NJ>
using KnotPlan = typename KnotPlanOf<MODE, T, NJ>::type;

template <typename T, int NJ, int MODE>
__global__ void clocked(const T* model, const T* q, const T* qd, const T* u,
                        long long L, T gravity, long long* rec, int* phases,
                        long long* knot) {
  using P = KnotPlan<MODE, T, NJ>;
  constexpr bool SO = MODE == 1 || MODE == 2;
  constexpr int N = P::LANES, S = P::STRIDE;
  auto& H = *reinterpret_cast<gt::SOHead<T, NJ>*>(gt_smem);
  T* knots = reinterpret_cast<T*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  const int tid = threadIdx.x, G = blockDim.x / N;
  const long long c0 = clock64();
  if constexpr (MODE >= 4)   // rnea, aba, fd, minv, crba: the tree's lists
    H.R.load_tree(model, tid, blockDim.x);
  else
    H.R.load(model, tid, blockDim.x);
  gt::load_inputs<T, NJ, S, MODE >= 8 ? 1 : MODE == 5 ? 2 : 3>(
      q, qd, u, L, (long long)blockIdx.x * G, G, knots, tid, blockDim.x);
  __syncthreads();
  if (SO && tid == 0) H.lists.build(H.R);
  __syncthreads();
  const bool first = blockIdx.x == 0 && tid < N;
  if (first && tid == 0) knot[1] = clock64() - c0;   // the block's head
  int count = 0;
  const ClockPar<N> par{tid % N, 1 + tid / N, first ? rec : nullptr, &count};
  T* k = knots + (long long)(tid / N) * S;
  if constexpr (MODE == 9)
    gt::crba_knot<T, NJ>(par, H.R, k);
  else if constexpr (MODE == 8)
    gt::minv_knot<true, T, NJ>(par, H.R, k);
  else if constexpr (MODE == 7)
    gt::fd_knot<T, NJ>(par, H.R, k, gravity);
  else if constexpr (MODE == 6)
    gt::aba_knot<T, NJ>(par, H.R, k, gravity);
  else if constexpr (MODE == 5)
    gt::rnea_knot<gt::RNEA_BIAS, T, NJ>(par, H.R, k, gravity);
  else if constexpr (MODE == 4)
    gt::rnea_knot<gt::RNEA_FULL, T, NJ>(par, H.R, k, gravity);
  else if constexpr (MODE == 3)
    gt::id_du_knot<T, NJ, gt::idu_passes<NJ>()>(par, H.R, k, gravity);
  else if constexpr (MODE == 2)
    gt::idsva_so_knot<T, NJ, gt::IDKnot<NJ>>(par, H.R, H.lists, k, gravity);
  else if constexpr (MODE == 1)
    gt::fdsva_so_knot<T, NJ>(par, H.R, H.lists, k, gravity);
  else
    gt::fd_du_knot<T, NJ>(par, H.R, k, gravity);
  if (first && tid == 0) {
    *phases = count;
    *knot = clock64() - c0;
  }
}

template <int MODE>
static int knot_clock(const void* model, const void* q, const void* qd,
                      const void* u, long long L, long long* rec,
                      int* phases, long long* knot) {
  constexpr int NJ = GT_NJ;
  using P = KnotPlan<MODE, float, NJ>;
  if constexpr (P::G < 1) {   // one knot does not fit a block
    return (int)cudaErrorInvalidConfiguration;
  } else {
    auto fn = clocked<float, NJ, MODE>;
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)P::BYTES);
    fn<<<(unsigned)((L + P::G - 1) / P::G), P::LANES * P::G, P::BYTES>>>(
        (const float*)model, (const float*)q, (const float*)qd,
        (const float*)u, L, -9.81f, rec, phases, knot);
    return (int)cudaGetLastError();
  }
}

extern "C" int phase_clock(int mode, int nj, const void* model,
                           const void* q, const void* qd, const void* u,
                           long long L, long long* rec, int* phases,
                           long long* knot) {
  if (nj != GT_NJ) return (int)cudaErrorInvalidValue;
  if (mode == 0) return knot_clock<0>(model, q, qd, u, L, rec, phases, knot);
  if (mode == 1) return knot_clock<1>(model, q, qd, u, L, rec, phases, knot);
  if (mode == 2) return knot_clock<2>(model, q, qd, u, L, rec, phases, knot);
  if (mode == 4) return knot_clock<4>(model, q, qd, u, L, rec, phases, knot);
  if (mode == 5) return knot_clock<5>(model, q, qd, u, L, rec, phases, knot);
  if (mode == 6) return knot_clock<6>(model, q, qd, u, L, rec, phases, knot);
  if (mode == 7) return knot_clock<7>(model, q, qd, u, L, rec, phases, knot);
  if (mode == 8) return knot_clock<8>(model, q, qd, u, L, rec, phases, knot);
  if (mode == 9) return knot_clock<9>(model, q, qd, u, L, rec, phases, knot);
  return knot_clock<3>(model, q, qd, u, L, rec, phases, knot);
}

// the serial lane functions (dynamics.cuh) a thread a lane, in blocks of
// 128 as the per-lane kernels run them: MODE 0 fd_lane, 1 ee_pose_lane, 2
// minv_lane (dense), 3 crba_lane, 4 ee_jac_lane; the thread of lane 0
// keeps its cycles, from its first load to its last store
template <int NJ, int MODE>
__global__ void clocked_lane(const float* model, const float* ee, int ne,
                             const float* q, const float* qd,
                             const float* u, float* out, long long L,
                             long long* cycles) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const long long c0 = clock64();
  const gt::Robot<float, NJ> R(model);
  float ql[NJ];
  gt::lane_load<float, NJ>(q, L, lane, ql);
  if constexpr (MODE == 0) {
    float qdl[NJ], ul[NJ], a[NJ];
    gt::lane_load<float, NJ>(qd, L, lane, qdl);
    gt::lane_load<float, NJ>(u, L, lane, ul);
    gt::fd_lane<float, NJ>(R, ql, qdl, ul, -9.81f, a);
    gt::lane_store<float, NJ>(a, L, lane, out);
  } else if constexpr (MODE == 1) {
    gt::ee_pose_lane<float, NJ>(R, ee, ne, ql, out + lane, L);
  } else if constexpr (MODE == 2) {
    float mi[NJ * NJ];
    gt::minv_lane<float, NJ>(R, ql, true, mi);
    gt::lane_store<float, NJ * NJ>(mi, L, lane, out);
  } else if constexpr (MODE == 3) {
    float m[NJ * NJ];
    gt::crba_lane<float, NJ>(R, ql, m);
    gt::lane_store<float, NJ * NJ>(m, L, lane, out);
  } else {
    gt::ee_jac_lane<float, NJ>(R, ee, ne, ql, out + lane, L);
  }
  if (lane == 0) *cycles = clock64() - c0;
}

template <int MODE>
static int lane_clock_launch(const void* model, const void* ee, int ne,
                             const void* q, const void* qd, const void* u,
                             void* out, long long L, long long* cycles) {
  clocked_lane<GT_NJ, MODE><<<gt_grid(L, 128), 128>>>(
      (const float*)model, (const float*)ee, ne, (const float*)q,
      (const float*)qd, (const float*)u, (float*)out, L, cycles);
  return (int)cudaGetLastError();
}

extern "C" int lane_clock(int mode, int nj, const void* model,
                          const void* ee, int ne, const void* q,
                          const void* qd, const void* u, void* out,
                          long long L, long long* cycles) {
  if (nj != GT_NJ) return (int)cudaErrorInvalidValue;
  if (mode == 0)
    return lane_clock_launch<0>(model, ee, ne, q, qd, u, out, L, cycles);
  if (mode == 1)
    return lane_clock_launch<1>(model, ee, ne, q, qd, u, out, L, cycles);
  if (mode == 2)
    return lane_clock_launch<2>(model, ee, ne, q, qd, u, out, L, cycles);
  if (mode == 3)
    return lane_clock_launch<3>(model, ee, ne, q, qd, u, out, L, cycles);
  return lane_clock_launch<4>(model, ee, ne, q, qd, u, out, L, cycles);
}

// rnea (kind 0; bias: its bias form, qdd null), aba (1), fd (2), minv (3,
// dense) and crba (4) at shape (lanes threads a knot, g knots a block),
// float32; a shape that does not fit an SM is not built
template <int W, int G>
static int lane_shape_launch(int kind, int bias, const void* model,
                             const void* q, const void* qd, const void* x,
                             void* out, long long L) {
  constexpr int NJ = GT_NJ;
  using PR = gt::KnotShape<float, gt::RobotConst<float, NJ>,
                           gt::RNEAKnot<NJ>::SIZE, W, G>;
  using PA = gt::KnotShape<float, gt::RobotConst<float, NJ>,
                           gt::ABAKnot<NJ>::SIZE, W, G>;
  using PF = gt::KnotShape<float, gt::RobotConst<float, NJ>,
                           gt::FDQKnot<NJ>::SIZE, W, G>;
  using PM = gt::KnotShape<float, gt::RobotConst<float, NJ>,
                           gt::MinvKnot<NJ>::SIZE, W, G>;
  using PC = gt::KnotShape<float, gt::RobotConst<float, NJ>,
                           gt::CRBAKnot<NJ>::SIZE, W, G>;
  if constexpr (W * G > 512 || W * G % 32 != 0) {
    return (int)cudaErrorInvalidConfiguration;
  } else if (kind == 4) {
    if constexpr (PC::BYTES <= gt::SMEM_LIMIT)
      return launch_crba<float, NJ, PC>(model, q, out, L, 0);
    return (int)cudaErrorInvalidConfiguration;
  } else if (kind == 3) {
    if constexpr (PM::BYTES <= gt::SMEM_LIMIT)
      return launch_minv<float, NJ, PM>(model, q, out, L, 1, 0);
    return (int)cudaErrorInvalidConfiguration;
  } else if (kind == 2) {
    if constexpr (PF::BYTES <= gt::SMEM_LIMIT)
      return launch_fd<float, NJ, PF>(model, q, qd, x, out, L, -9.81, 0);
    return (int)cudaErrorInvalidConfiguration;
  } else if (kind == 1) {
    if constexpr (PA::BYTES <= gt::SMEM_LIMIT)
      return launch_aba<float, NJ, PA>(model, q, qd, x, out, L, -9.81, 0);
    return (int)cudaErrorInvalidConfiguration;
  } else {
    if constexpr (PR::BYTES <= gt::SMEM_LIMIT)
      return launch_rnea<float, NJ, PR>(model, q, qd, bias ? nullptr : x,
                                        out, L, -9.81, 0);
    return (int)cudaErrorInvalidConfiguration;
  }
}

extern "C" int lane_shape(int kind, int bias, int lanes, int g, int nj,
                          const void* model, const void* q, const void* qd,
                          const void* x, void* out, long long L) {
  if (nj != GT_NJ) return (int)cudaErrorInvalidValue;
#define GT_SHAPE(W, G)                                                      \
  if (lanes == W && g == G)                                                 \
    return lane_shape_launch<W, G>(kind, bias, model, q, qd, x, out, L);
  GT_SHAPE(8, 4) GT_SHAPE(8, 8) GT_SHAPE(16, 2) GT_SHAPE(16, 4)
  GT_SHAPE(16, 8) GT_SHAPE(32, 1) GT_SHAPE(32, 2) GT_SHAPE(32, 4)
  GT_SHAPE(32, 8)
#undef GT_SHAPE
  return (int)cudaErrorInvalidValue;
}

// d2eepos's plan, a row of blocks an EE; block (0, 0) (EE 0) clocks its
// knot 0
template <int NJ>
__global__ void clocked_d2(const float* model, const float* ee, int ne,
                           const float* q, float* out, long long L,
                           long long* rec, int* phases, long long* knot) {
  using P = gt::D2Plan<float, NJ>;
  constexpr int N = P::LANES, S = P::STRIDE, G = P::G;
  auto& H = *reinterpret_cast<gt::EEHead<float, NJ>*>(gt_smem);
  float* knots =
      reinterpret_cast<float*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  const int tid = threadIdx.x, nt = blockDim.x, e = blockIdx.y;
  const long long l0 = (long long)blockIdx.x * G;
  const long long c0 = clock64();
  H.load(model, tid, nt);
  gt::load_q<float, NJ, S>(q, L, l0, G, knots, tid, nt);
  __syncthreads();
  H.select(ee + e * gt::EERow<NJ>::SIZE, tid, nt);
  __syncthreads();
  const bool first = blockIdx.x == 0 && e == 0 && tid < N;
  if (first && tid == 0) knot[1] = clock64() - c0;   // the block's head
  int count = 0;
  const ClockPar<N> par{tid % N, 1 + tid / N, first ? rec : nullptr, &count};
  float* oe = out + 6LL * e * NJ * NJ * L;
  constexpr bool STAGE = gt::d2_stage<NJ>();
  gt::d2eepos_knot<float, NJ, STAGE>(par, H, knots + (long long)(tid / N) * S,
                                    oe, L, l0 + tid / N);
  __syncthreads();
  gt::d2eepos_store<float, NJ, S, G, STAGE>(H, knots, oe, L, l0, tid, nt);
  if (first && tid == 0) {
    *phases = count;
    *knot = clock64() - c0;
  }
}

extern "C" int d2_clock(int nj, const void* model, const void* ee, int ne,
                        const void* q, void* out, long long L, long long* rec,
                        int* phases, long long* knot) {
  constexpr int NJ = GT_NJ;
  using P = gt::D2Plan<float, NJ>;
  if (nj != NJ) return (int)cudaErrorInvalidValue;
  gt::smem_attrs(clocked_d2<NJ>, P::BYTES);
  clocked_d2<NJ><<<dim3((unsigned)((L + P::G - 1) / P::G), (unsigned)ne),
                   P::G * P::LANES, P::BYTES>>>(
      (const float*)model, (const float*)ee, ne, (const float*)q,
      (float*)out, L, rec, phases, knot);
  return (int)cudaGetLastError();
}

// eepos's plan, a row of blocks an EE, each block a group of lanes; block
// (0, 0) (EE 0) clocks its knot 0
template <int NJ>
__global__ void clocked_ee(const float* model, const float* ee, int ne,
                           const float* q, float* out, long long L,
                           long long* rec, int* phases, long long* knot) {
  using P = gt::EEPlan<float, NJ>;
  constexpr int N = P::LANES, S = P::STRIDE, G = P::G;
  auto& H = *reinterpret_cast<gt::EEHead<float, NJ, false>*>(gt_smem);
  float* knots =
      reinterpret_cast<float*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  const int tid = threadIdx.x, nt = blockDim.x, e = blockIdx.y;
  const long long l0 = (long long)blockIdx.x * G;
  const long long c0 = clock64();
  H.load(model, tid, nt);
  H.select(ee + e * gt::EERow<NJ>::SIZE, tid, nt);
  gt::load_q<float, NJ, S>(q, L, l0, G, knots, tid, nt);
  __syncthreads();
  const bool first = blockIdx.x == 0 && e == 0 && tid < N;
  if (first && tid == 0) knot[1] = clock64() - c0;   // the block's head
  int count = 0;
  const ClockPar<N> par{tid % N, 1 + tid / N, first ? rec : nullptr, &count};
  gt::eepos_knot<float, NJ>(par, H, knots + (long long)(tid / N) * S);
  __syncthreads();
  gt::store_rows<float, S>(knots + gt::EEKnot<NJ>::POSE, 6, out + 6LL * e * L,
                           L, l0, G, tid, nt);
  if (first && tid == 0) {
    *phases = count;
    *knot = clock64() - c0;
  }
}

extern "C" int ee_clock(int nj, const void* model, const void* ee, int ne,
                        const void* q, void* out, long long L, long long* rec,
                        int* phases, long long* knot) {
  constexpr int NJ = GT_NJ;
  using P = gt::EEPlan<float, NJ>;
  if (nj != NJ) return (int)cudaErrorInvalidValue;
  gt::smem_attrs(clocked_ee<NJ>, P::BYTES);
  clocked_ee<NJ><<<dim3((unsigned)((L + P::G - 1) / P::G), (unsigned)ne),
                   P::G * P::LANES, P::BYTES>>>(
      (const float*)model, (const float*)ee, ne, (const float*)q,
      (float*)out, L, rec, phases, knot);
  return (int)cudaGetLastError();
}

// the eepos kernel at shape (lanes threads a lane, g lanes a block),
// float32; a shape that does not fit an SM is not built
template <int W, int G>
static int ee_shape_launch(const void* model, const void* ee, int ne,
                           const void* q, void* out, long long L) {
  constexpr int NJ = GT_NJ;
  using P = gt::KnotShape<float, gt::EEHead<float, NJ, false>,
                          gt::EEKnot<NJ>::SIZE, W, G>;
  if constexpr (P::BYTES <= gt::SMEM_LIMIT && W * G <= 512 &&
                W * G % 32 == 0)
    return launch_eepos<float, NJ, P>(model, ee, ne, q, out, L, 0);
  return (int)cudaErrorInvalidConfiguration;
}

extern "C" int ee_shape(int lanes, int g, int nj, const void* model,
                        const void* ee, int ne, const void* q, void* out,
                        long long L) {
  if (nj != GT_NJ) return (int)cudaErrorInvalidValue;
#define GT_SHAPE(W, G)                                                      \
  if (lanes == W && g == G)                                                 \
    return ee_shape_launch<W, G>(model, ee, ne, q, out, L);
  GT_SHAPE(8, 4) GT_SHAPE(8, 8) GT_SHAPE(16, 2) GT_SHAPE(16, 4)
  GT_SHAPE(16, 8) GT_SHAPE(32, 1) GT_SHAPE(32, 2) GT_SHAPE(32, 4)
  GT_SHAPE(32, 8) GT_SHAPE(4, 8) GT_SHAPE(4, 16) GT_SHAPE(8, 16)
#undef GT_SHAPE
  return (int)cudaErrorInvalidValue;
}

// deepos's plan, a row of blocks an EE, each block a group of lanes; block
// (0, 0) (EE 0) clocks its knot 0
template <int NJ>
__global__ void clocked_dj(const float* model, const float* ee, int ne,
                           const float* q, float* out, long long L,
                           long long* rec, int* phases, long long* knot) {
  using P = gt::DJPlan<float, NJ>;
  constexpr int N = P::LANES, S = P::STRIDE, G = P::G;
  auto& H = *reinterpret_cast<gt::EEHead<float, NJ>*>(gt_smem);
  float* knots =
      reinterpret_cast<float*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  const int tid = threadIdx.x, nt = blockDim.x, e = blockIdx.y;
  const long long l0 = (long long)blockIdx.x * G;
  const long long c0 = clock64();
  H.load(model, tid, nt);
  H.select(ee + e * gt::EERow<NJ>::SIZE, tid, nt);
  gt::load_q<float, NJ, S>(q, L, l0, G, knots, tid, nt);
  __syncthreads();
  const bool first = blockIdx.x == 0 && e == 0 && tid < N;
  if (first && tid == 0) knot[1] = clock64() - c0;   // the block's head
  int count = 0;
  const ClockPar<N> par{tid % N, 1 + tid / N, first ? rec : nullptr, &count};
  gt::deepos_knot<float, NJ>(par, H, knots + (long long)(tid / N) * S);
  __syncthreads();
  gt::deepos_store<float, NJ, S, G>(H, knots, out + 6LL * e * NJ * L, L, l0,
                                    tid, nt);
  if (first && tid == 0) {
    *phases = count;
    *knot = clock64() - c0;
  }
}

extern "C" int dj_clock(int nj, const void* model, const void* ee, int ne,
                        const void* q, void* out, long long L, long long* rec,
                        int* phases, long long* knot) {
  constexpr int NJ = GT_NJ;
  using P = gt::DJPlan<float, NJ>;
  if (nj != NJ) return (int)cudaErrorInvalidValue;
  gt::smem_attrs(clocked_dj<NJ>, P::BYTES);
  clocked_dj<NJ><<<dim3((unsigned)((L + P::G - 1) / P::G), (unsigned)ne),
                   P::G * P::LANES, P::BYTES>>>(
      (const float*)model, (const float*)ee, ne, (const float*)q,
      (float*)out, L, rec, phases, knot);
  return (int)cudaGetLastError();
}

// the deepos kernel at shape (lanes threads a lane, g lanes a block), its
// knots group_stride apart (or, `banks16`, 16 banks apart: knot_stride),
// float32; a shape that does not fit an SM is not built
template <int W, int G, class P>
static int dj_shape_launch(const void* model, const void* ee, int ne,
                           const void* q, void* out, long long L) {
  constexpr int NJ = GT_NJ;
  if constexpr (P::BYTES <= gt::SMEM_LIMIT && W * G <= 512 &&
                W * G % 32 == 0)
    return launch_deepos<float, NJ, P>(model, ee, ne, q, out, L, 0);
  return (int)cudaErrorInvalidConfiguration;
}

template <int W, int G>
static int dj_shape_of(int banks16, const void* model, const void* ee,
                       int ne, const void* q, void* out, long long L) {
  constexpr int NJ = GT_NJ, K = gt::DJKnot<NJ>::SIZE;
  using H = gt::EEHead<float, NJ>;
  if (banks16)
    return dj_shape_launch<W, G, gt::KnotShape<float, H, K, W, G>>(
        model, ee, ne, q, out, L);
  return dj_shape_launch<W, G, gt::GroupShape<float, H, K, W, G>>(
      model, ee, ne, q, out, L);
}

extern "C" int dj_shape(int lanes, int g, int banks16, int nj,
                        const void* model, const void* ee, int ne,
                        const void* q, void* out, long long L) {
  if (nj != GT_NJ) return (int)cudaErrorInvalidValue;
#define GT_SHAPE(W, G)                                                      \
  if (lanes == W && g == G)                                                 \
    return dj_shape_of<W, G>(banks16, model, ee, ne, q, out, L);
  GT_SHAPE(8, 4) GT_SHAPE(8, 8) GT_SHAPE(16, 2) GT_SHAPE(16, 4)
  GT_SHAPE(16, 8) GT_SHAPE(32, 1) GT_SHAPE(32, 2) GT_SHAPE(32, 4)
  GT_SHAPE(32, 8) GT_SHAPE(4, 8) GT_SHAPE(4, 16) GT_SHAPE(8, 16)
#undef GT_SHAPE
  return (int)cudaErrorInvalidValue;
}

// the id_du kernel with `passes` column passes (its BlockPlan), float32
extern "C" int idu_shape(int passes, int nj, const void* model,
                         const void* q, const void* qd, const void* qdd,
                         void* out, long long L) {
  if (nj != GT_NJ) return (int)cudaErrorInvalidValue;
  if (passes == 1)
    return launch_id_du<float, GT_NJ, 1>(model, q, qd, qdd, out, L, -9.81, 0);
  return launch_id_du<float, GT_NJ, 2>(model, q, qd, qdd, out, L, -9.81, 0);
}

// the d2eepos kernel at shape (lanes threads a lane, g lanes a block),
// staged or direct stores, float32; a shape that does not fit an SM is not
// built
template <int W, int G, bool STAGE>
static int d2_shape_launch(const void* model, const void* ee, int ne,
                           const void* q, void* out, long long L) {
  constexpr int NJ = GT_NJ;
  using P = gt::KnotShape<float, gt::EEHead<float, NJ>, gt::D2Knot<NJ>::SIZE,
                          W, G>;
  if constexpr (P::BYTES <= gt::SMEM_LIMIT && W * G <= 512 &&
                W * G % 32 == 0)
    return launch_d2eepos<float, NJ, P, STAGE>(model, ee, ne, q, out, L, 0);
  return (int)cudaErrorInvalidConfiguration;
}

extern "C" int d2_shape(int lanes, int g, int stage, int nj,
                        const void* model, const void* ee, int ne,
                        const void* q, void* out, long long L) {
  if (nj != GT_NJ) return (int)cudaErrorInvalidValue;
#define GT_SHAPE(W, G)                                                      \
  if (lanes == W && g == G)                                                 \
    return stage ? d2_shape_launch<W, G, true>(model, ee, ne, q, out, L)    \
                 : d2_shape_launch<W, G, false>(model, ee, ne, q, out, L);
  GT_SHAPE(8, 8) GT_SHAPE(8, 16) GT_SHAPE(16, 4) GT_SHAPE(16, 8)
  GT_SHAPE(32, 4) GT_SHAPE(32, 8)
#undef GT_SHAPE
  return (int)cudaErrorInvalidValue;
}

template <int NJ>
__global__ void clocked_ric(const float* A, const float* Bm, const float* lx,
                            const float* lu, const float* Jw,
                            const float* Vx0, const float* Vxx0, float* ks,
                            float* Ks, int N, long long B, int r, float reg,
                            float qd, float ud, long long* rec, int* phases,
                            long long* knot) {
  using P = gt::RicPlan<float, NJ>;
  constexpr int W = P::LANES;
  float* knots =
      reinterpret_cast<float*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long c0 = clock64();
  const bool first = blockIdx.x == 0 && tid < W;
  int count = 0;
  const ClockPar<W> par{tid % W, 1 + tid / W, first ? rec : nullptr, &count};
  const gt::FactoredIn<float, NJ, P::BUFS> in{
      A, Bm, lx, lu, Jw, B, N, r, qd, ud};
  gt::riccati_block<float, NJ, P::G>(par, tid, nt, tid / W, knots, P::STRIDE,
                                     (long long)blockIdx.x * P::G, in, Vx0,
                                     Vxx0, ks, Ks, N, B, reg);
  if (first && tid == 0) {
    *phases = count;
    *knot = clock64() - c0;
  }
}

extern "C" int ric_clock(int nj, const void* A, const void* Bm,
                         const void* lx, const void* lu, const void* Jw,
                         const void* Vx0, const void* Vxx0, void* ks,
                         void* Ks, int N, long long B, int r, double reg,
                         double qd, double ud, long long* rec, int* phases,
                         long long* knot) {
  constexpr int NJ = GT_NJ;
  using P = gt::RicPlan<float, NJ>;
  if (nj != NJ) return (int)cudaErrorInvalidValue;
  gt::smem_attrs(clocked_ric<NJ>, P::BYTES);
  clocked_ric<NJ><<<(unsigned)((B + P::G - 1) / P::G), P::G * P::LANES,
                    P::BYTES>>>(
      (const float*)A, (const float*)Bm, (const float*)lx, (const float*)lu,
      (const float*)Jw, (const float*)Vx0, (const float*)Vxx0, (float*)ks,
      (float*)Ks, N, B, r, (float)reg, (float)qd, (float)ud, rec, phases,
      knot);
  return (int)cudaGetLastError();
}

template <int NJ, class Cost>
__global__ void clocked_ls(const float* model, const float* x0,
                           const float* Uref, const float* Xref,
                           const float* k, const float* K, const float* al,
                           const float* lo, const float* hi, float* X,
                           float* U, float* cost, int N, long long B, int na,
                           int rows, float dt, const float* cbuf, int ncost,
                           long long* rec, int* phases, long long* knot) {
  using P = gt::LSPlan<float, NJ>;
  constexpr int W = P::LANES;
  auto& H = *reinterpret_cast<gt::LSHead<float, NJ>*>(gt_smem);
  float* tiles =
      reinterpret_cast<float*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  float* rolls = tiles + 2 * P::G * P::TILE;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long c0 = clock64();
  H.load(model, cbuf, ncost, lo, hi, tid, nt);
  __syncthreads();
  const bool first = blockIdx.x == 0 && blockIdx.y == 0 && tid < W;
  int count = 0;
  const ClockPar<W> par{tid % W, 1 + tid / W, first ? rec : nullptr, &count};
  gt::linesearch_block<float, NJ, Cost, P::G>(
      par, tid, nt, tid / W, H, tiles, P::TILE, rolls, P::STRIDE, rows,
      (long long)blockIdx.x * P::G, blockIdx.y * rows, x0,
      gt::FeedbackLaw<float, NJ>{Uref, Xref, k, K, al}, X, U, cost, N, B, na,
      dt, -9.81f);
  if (first && tid == 0) {
    *phases = count;
    *knot = clock64() - c0;
  }
}

extern "C" int ls_clock(int kind, int nj, const void* model, const void* x0,
                        const void* Uref, const void* Xref, const void* k,
                        const void* K, const void* al, const void* lo,
                        const void* hi, void* X, void* U, void* cost, int N,
                        long long B, int na, double dt, const void* cbuf,
                        long long* rec, int* phases, long long* knot) {
  constexpr int NJ = GT_NJ;
  using P = gt::LSPlan<float, NJ>;
  if (nj != NJ) return (int)cudaErrorInvalidValue;
  const int rows = P::rows_for(na);
  const dim3 grid((unsigned)((B + P::G - 1) / P::G),
                  (unsigned)((na + rows - 1) / rows));
  auto fn = kind == 0 ? clocked_ls<NJ, gt::EECostW<float, NJ>>
                      : clocked_ls<NJ, gt::QuadCostW<float, NJ>>;
  gt::smem_attrs(fn, P::BYTES);
  fn<<<grid, P::G * rows * P::LANES, (int)P::bytes(rows)>>>(
      (const float*)model, (const float*)x0, (const float*)Uref,
      (const float*)Xref, (const float*)k, (const float*)K, (const float*)al,
      (const float*)lo, (const float*)hi, (float*)X, (float*)U, (float*)cost,
      N, B, na, rows, (float)dt, (const float*)cbuf, kind == 0 ? 7 : 7 * NJ,
      rec, phases, knot);
  return (int)cudaGetLastError();
}

// the dense riccati with a stationary curvature
template <int NJ>
__global__ void clocked_ricd(const float* A, const float* Bm, const float* lx,
                             const float* lu, const float* lxx,
                             const float* luu, const float* lux,
                             const float* Vx0, const float* Vxx0, float* ks,
                             float* Ks, int N, long long B, float reg,
                             long long* rec, int* phases, long long* knot) {
  using P = gt::RicPlan<float, NJ, gt::RIC_STATIONARY>;
  constexpr int W = P::LANES;
  float* knots =
      reinterpret_cast<float*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long c0 = clock64();
  const bool first = blockIdx.x == 0 && tid < W;
  int count = 0;
  const ClockPar<W> par{tid % W, 1 + tid / W, first ? rec : nullptr, &count};
  const gt::DenseIn<float, NJ, true, P::BUFS> in{
      A, Bm, lx, lu, lxx, luu, lux, B};
  gt::riccati_block<float, NJ, P::G>(par, tid, nt, tid / W, knots, P::STRIDE,
                                     (long long)blockIdx.x * P::G, in, Vx0,
                                     Vxx0, ks, Ks, N, B, reg);
  if (first && tid == 0) {
    *phases = count;
    *knot = clock64() - c0;
  }
}

extern "C" int ricd_clock(int nj, const void* A, const void* Bm,
                          const void* lx, const void* lu, const void* lxx,
                          const void* luu, const void* lux, const void* Vx0,
                          const void* Vxx0, void* ks, void* Ks, int N,
                          long long B, double reg, long long* rec,
                          int* phases, long long* knot) {
  constexpr int NJ = GT_NJ;
  using P = gt::RicPlan<float, NJ, gt::RIC_STATIONARY>;
  if (nj != NJ) return (int)cudaErrorInvalidValue;
  gt::smem_attrs(clocked_ricd<NJ>, P::BYTES);
  clocked_ricd<NJ><<<(unsigned)((B + P::G - 1) / P::G), P::G * P::LANES,
                     P::BYTES>>>(
      (const float*)A, (const float*)Bm, (const float*)lx, (const float*)lu,
      (const float*)lxx, (const float*)luu, (const float*)lux,
      (const float*)Vx0, (const float*)Vxx0, (float*)ks, (float*)Ks, N, B,
      (float)reg, rec, phases, knot);
  return (int)cudaGetLastError();
}

// the open-loop rollout
template <int NJ>
__global__ void clocked_roll(const float* model, const float* x0,
                             const float* U, const float* lo, const float* hi,
                             float* X, int N, long long B, float dt,
                             long long* rec, int* phases, long long* knot) {
  using P = gt::RollPlan<float, NJ>;
  constexpr int W = P::LANES;
  auto& H = *reinterpret_cast<gt::LSHead<float, NJ>*>(gt_smem);
  float* tiles =
      reinterpret_cast<float*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  float* rolls = tiles + 2 * P::G * P::TILE;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long c0 = clock64();
  H.load(model, nullptr, 0, lo, hi, tid, nt);
  __syncthreads();
  const bool first = blockIdx.x == 0 && tid < W;
  int count = 0;
  const ClockPar<W> par{tid % W, 1 + tid / W, first ? rec : nullptr, &count};
  gt::linesearch_block<float, NJ, gt::NoCost<float, NJ>, P::G>(
      par, tid, nt, tid / W, H, tiles, P::TILE, rolls, P::STRIDE, 1,
      (long long)blockIdx.x * P::G, 0, x0, gt::OpenLoop<float, NJ>{U}, X,
      nullptr, nullptr, N, B, 1, dt, -9.81f);
  if (first && tid == 0) {
    *phases = count;
    *knot = clock64() - c0;
  }
}

extern "C" int roll_clock(int nj, const void* model, const void* x0,
                          const void* U, const void* lo, const void* hi,
                          void* X, int N, long long B, double dt,
                          long long* rec, int* phases, long long* knot) {
  constexpr int NJ = GT_NJ;
  using P = gt::RollPlan<float, NJ>;
  if (nj != NJ) return (int)cudaErrorInvalidValue;
  gt::smem_attrs(clocked_roll<NJ>, P::BYTES);
  clocked_roll<NJ><<<(unsigned)((B + P::G - 1) / P::G), P::G * P::LANES,
                     P::BYTES>>>(
      (const float*)model, (const float*)x0, (const float*)U,
      (const float*)lo, (const float*)hi, (float*)X, N, B, (float)dt, rec,
      phases, knot);
  return (int)cudaGetLastError();
}

// whether a rollout block of G problems of W threads, with a tile of TILE
// values a problem, fits an SM in float32 (asked before RollShape, which
// refuses a shape that does not fit)
template <int W, int G, int TILE>
constexpr bool roll_fits() {
  return gt::roll_bytes<float, GT_NJ>(G, TILE) <= gt::SMEM_LIMIT &&
         W * G <= 512 && W * G % 32 == 0;
}

template <int W, int G>
static int roll_shape_launch(const void* model, const void* x0,
                             const void* U, const void* lo, const void* hi,
                             void* X, int N, long long B, double dt) {
  constexpr int NJ = GT_NJ;
  if constexpr (roll_fits<W, G, NJ>())
    return launch_rollout<float, NJ, gt::RollShape<float, NJ, W, G>>(
        model, x0, U, lo, hi, X, N, B, dt, -9.81, 0);
  return (int)cudaErrorInvalidConfiguration;
}

// the rollout kernel at block shape (lanes threads a rollout, g problems a
// block), float32; a shape that does not fit an SM is not built
extern "C" int roll_shape(int lanes, int g, int nj, const void* model,
                          const void* x0, const void* U, const void* lo,
                          const void* hi, void* X, int N, long long B,
                          double dt) {
  constexpr int NJ = GT_NJ;
  if (nj != NJ) return (int)cudaErrorInvalidValue;
#define GT_SHAPE(W, G)                                                      \
  if (lanes == W && g == G)                                                 \
    return roll_shape_launch<W, G>(model, x0, U, lo, hi, X, N, B, dt);
  GT_SHAPE(8, 4) GT_SHAPE(8, 8) GT_SHAPE(16, 2) GT_SHAPE(16, 4)
  GT_SHAPE(16, 8) GT_SHAPE(32, 2) GT_SHAPE(32, 4) GT_SHAPE(32, 8)
#undef GT_SHAPE
  return (int)cudaErrorInvalidValue;
}

// the feedback rollout
template <int NJ>
__global__ void clocked_fbr(const float* model, const float* x0,
                            const float* Uref, const float* Xref,
                            const float* kff, const float* K, const float* lo,
                            const float* hi, float* X, float* U, int N,
                            long long B, float dt, long long* rec,
                            int* phases, long long* knot) {
  using P = gt::FBPlan<float, NJ>;
  constexpr int W = P::LANES;
  auto& H = *reinterpret_cast<gt::LSHead<float, NJ>*>(gt_smem);
  float* tiles =
      reinterpret_cast<float*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  float* rolls = tiles + 2 * P::G * P::TILE;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long c0 = clock64();
  H.load(model, nullptr, 0, lo, hi, tid, nt);
  __syncthreads();
  const bool first = blockIdx.x == 0 && tid < W;
  int count = 0;
  const ClockPar<W> par{tid % W, 1 + tid / W, first ? rec : nullptr, &count};
  gt::linesearch_block<float, NJ, gt::NoCost<float, NJ>, P::G>(
      par, tid, nt, tid / W, H, tiles, P::TILE, rolls, P::STRIDE, 1,
      (long long)blockIdx.x * P::G, 0, x0,
      gt::FoldedStepLaw<float, NJ>{{Uref, Xref, kff, K, nullptr}}, X, U,
      nullptr, N, B, 1, dt, -9.81f);
  if (first && tid == 0) {
    *phases = count;
    *knot = clock64() - c0;
  }
}

extern "C" int fbr_clock(int nj, const void* model, const void* x0,
                         const void* Uref, const void* Xref, const void* kff,
                         const void* K, const void* lo, const void* hi,
                         void* X, void* U, int N, long long B, double dt,
                         long long* rec, int* phases, long long* knot) {
  constexpr int NJ = GT_NJ;
  using P = gt::FBPlan<float, NJ>;
  if (nj != NJ) return (int)cudaErrorInvalidValue;
  gt::smem_attrs(clocked_fbr<NJ>, P::BYTES);
  clocked_fbr<NJ><<<(unsigned)((B + P::G - 1) / P::G), P::G * P::LANES,
                    P::BYTES>>>(
      (const float*)model, (const float*)x0, (const float*)Uref,
      (const float*)Xref, (const float*)kff, (const float*)K,
      (const float*)lo, (const float*)hi, (float*)X, (float*)U, N, B,
      (float)dt, rec, phases, knot);
  return (int)cudaGetLastError();
}

template <int W, int G>
static int fbr_shape_launch(const void* model, const void* x0,
                            const void* Uref, const void* Xref,
                            const void* kff, const void* K, const void* lo,
                            const void* hi, void* X, void* U, int N,
                            long long B, double dt) {
  constexpr int NJ = GT_NJ;
  if constexpr (roll_fits<W, G, gt::LSTile<NJ>::SIZE>())
    return launch_feedback_rollout<
        float, NJ,
        gt::RollShape<float, NJ, W, G, gt::FoldedStepLaw<float, NJ>>>(
        model, x0, Uref, Xref, kff, K, lo, hi, X, U, N, B, dt, -9.81, 0);
  return (int)cudaErrorInvalidConfiguration;
}

// the feedback rollout kernel at block shape (lanes threads a rollout, g
// problems a block), float32; a shape that does not fit an SM is not built
extern "C" int fbr_shape(int lanes, int g, int nj, const void* model,
                         const void* x0, const void* Uref, const void* Xref,
                         const void* kff, const void* K, const void* lo,
                         const void* hi, void* X, void* U, int N, long long B,
                         double dt) {
  constexpr int NJ = GT_NJ;
  if (nj != NJ) return (int)cudaErrorInvalidValue;
#define GT_SHAPE(W, G)                                                      \
  if (lanes == W && g == G)                                                 \
    return fbr_shape_launch<W, G>(model, x0, Uref, Xref, kff, K, lo, hi, X, \
                                  U, N, B, dt);
  GT_SHAPE(8, 4) GT_SHAPE(8, 8) GT_SHAPE(16, 2) GT_SHAPE(16, 4)
  GT_SHAPE(16, 8) GT_SHAPE(32, 2) GT_SHAPE(32, 4) GT_SHAPE(32, 8)
#undef GT_SHAPE
  return (int)cudaErrorInvalidValue;
}

// the idsva_so kernel at knot shape (M times the fewest threads a knot of
// fd_du and fdsva_so, G knots a block), float32, with as many blocks as the
// card holds (`resident`) or a block a group; a shape that does not fit an
// SM is not built
template <int M, int G>
static int idso_shape_launch(const void* model, const void* q,
                             const void* qd, const void* qdd, void* out,
                             long long L, bool resident) {
  constexpr int NJ = GT_NJ, W = M * gt::knot_lanes<NJ>();
  using P = gt::KnotShape<float, gt::SOHead<float, NJ>, gt::IDKnot<NJ>::SIZE,
                          W, G>;
  if constexpr (P::BYTES <= gt::SMEM_LIMIT && W * G <= 512 &&
                W * G % 32 == 0)
    return launch_idsva_so<float, NJ, P>(model, q, qd, qdd, out, L, -9.81,
                                         0, resident);
  return (int)cudaErrorInvalidConfiguration;
}

extern "C" int idso_shape(int mult, int g, int resident, int nj,
                          const void* model, const void* q, const void* qd,
                          const void* qdd, void* out, long long L) {
  if (nj != GT_NJ) return (int)cudaErrorInvalidValue;
#define GT_SHAPE(M, G)                                                      \
  if (mult == M && g == G)                                                  \
    return idso_shape_launch<M, G>(model, q, qd, qdd, out, L, resident);
  GT_SHAPE(1, 2) GT_SHAPE(1, 4) GT_SHAPE(1, 6) GT_SHAPE(1, 8) GT_SHAPE(2, 2)
  GT_SHAPE(2, 4) GT_SHAPE(2, 8) GT_SHAPE(4, 2) GT_SHAPE(4, 4)
#undef GT_SHAPE
  return (int)cudaErrorInvalidValue;
}
"""



def nvcc():
    from gridcodegenerator_tpu_torch.ops.cuda import build
    return build._nvcc(), build.NVCC_FLAGS


def tree_joints(tree: Path) -> tuple:
    """The joint counts of JOINTS that the tree's build lists (an earlier
    tree may build fewer)."""
    text = (tree / "gridcodegenerator_tpu_torch" / "ops" / "cuda"
            / "build.py").read_text()
    listed = re.search(r"SUPPORTED_JOINTS = \(([^)]*)\)", text).group(1)
    return tuple(nj for nj in JOINTS
                 if str(nj) in (v.strip() for v in listed.split(",")))


def compile_tree(tree: Path, out: Path, sources, clocked: bool = False,
                 joints=None):
    """{nj: library path} at the joint counts the tree builds (or
    `joints`), of the sources it has, and the ptxas report of every object;
    with `clocked`, also {nj: phase-clock library path}."""
    exe, flags = nvcc()
    csrc = tree / "gridcodegenerator_tpu_torch" / "csrc"
    joints = tree_joints(tree) if joints is None else joints
    sources = [src for src in sources if (csrc / src).exists()]
    jobs = [(nj, csrc / src) for nj in joints for src in sources]
    clock_joints = joints if clocked else ()
    if clocked:
        (out / "phase_clock.cu").write_text(PHASE_CLOCK_CU)
        jobs += [(nj, out / "phase_clock.cu") for nj in clock_joints]

    def one(job):
        nj, src = job
        clock = src.name == "phase_clock.cu"
        obj = out / (f"phase_clock{nj}.so" if clock else f"{src.name}.nj{nj}.o")
        r = subprocess.run([exe, *flags, f"-DGT_NJ={nj}", "-Xptxas", "-v",
                            "-I", str(csrc), "-shared" if clock else "-c",
                            str(src), "-o", str(obj)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc {tree.name}/{src.name} nj={nj}:\n"
                               f"{r.stderr}")
        return "" if clock else r.stdout + r.stderr

    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        reports = list(pool.map(one, jobs))
    clocks = {nj: out / f"phase_clock{nj}.so" for nj in clock_joints}
    libs = {}
    for nj in joints:
        lib = out / f"lib_nj{nj}.so"
        subprocess.run([exe, *flags, "-shared",
                        *(str(out / f"{src}.nj{nj}.o") for src in sources),
                        "-o", str(lib)], check=True, capture_output=True)
        libs[nj] = lib
    return libs, "\n".join(reports), clocks


def compare_sass(work: Path, other: str, joints, sources) -> dict:
    """{"<source> nj<n>": {"identical": bool, "lines": this tree's SASS
    lines, "differing": lines that differ in place, and the difference in
    length}}: cuobjdump -sass of this tree's object of each source (float
    and double instances) against the other tree's, at each joint count
    both trees build; where they differ, the first 4000 lines of `diff -u`
    go to sass_<source>_nj<n>.diff in the work directory."""
    exe = Path(nvcc()[0]).parent / "cuobjdump"
    out = {}
    for src in sources:
        for nj in joints:
            objs = [work / tree / f"{src}.nj{nj}.o" for tree in ("this", other)]
            if not all(o.exists() for o in objs):   # a tree builds fewer
                continue
            a, b = (subprocess.run([str(exe), "-sass", str(o)], check=True,
                                   capture_output=True,
                                   text=True).stdout.splitlines()
                    for o in objs)
            diff = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
            out[f"{src} nj{nj}"] = {"identical": a == b, "lines": len(a),
                                    "differing": diff}
            if a != b:
                files = [work / f"{t}_{src}_nj{nj}.sass" for t in ("this",
                                                                   other)]
                for f, text in zip(files, (a, b)):
                    f.write_text("\n".join(text))
                d = subprocess.run(["diff", "-u", str(files[1]),
                                    str(files[0])], capture_output=True,
                                   text=True).stdout.splitlines()[:4000]
                (work / f"sass_{src}_nj{nj}.diff").write_text("\n".join(d))
    return out


KERNEL_NAMES = ("fd_du_chip_kernel", "fd_du_ws_kernel", "riccati_chip_kernel",
                "riccati_ws_kernel",
                "fd_du_kernel", "fdsva_so_kernel", "riccati_factored_kernel",
                "linesearch_kernel", "riccati_kernel", "rollout_kernel",
                "riccati_dense_kernel", "idsva_so_kernel",
                "feedback_rollout_kernel", "id_du_kernel", "d2eepos_kernel",
                "rnea_kernel", "aba_kernel", "fd_kernel", "eepos_kernel",
                "minv_kernel", "crba_kernel", "deepos_kernel")


def parse_ptxas(text: str) -> dict:
    """{"fd_du f32 nj7": {registers, stack, spill_stores, spill_loads,
    smem, cumulative_stack}} for the instances of the thread-group kernels
    (fd_du, fdsva_so, idsva_so, riccati_factored, linesearch_ee,
    linesearch_quad, riccati_stationary, riccati_stacked, rollout,
    feedback_rollout, id_du, d2eepos, rnea (with qdd), rnea_bias, aba, fd,
    eepos, minv (dense), minv_upper, crba, deepos; an earlier tree's
    riccati_dense and its per-lane idsva_so, feedback_rollout, id_du,
    d2eepos, rnea, aba, fd, eepos, minv, crba and deepos) in ptxas's
    report."""
    def key(mangled):
        m = re.match(r"_Z\d+(\w+?_kernel)I([fd])Li(\d+)E", mangled)
        if not m or m.group(1) not in KERNEL_NAMES:
            return None
        name = m.group(1)[:-7]
        if name == "linesearch":
            name += "_ee" if "EECost" in mangled else "_quad"
        if name in ("riccati", "riccati_chip", "riccati_ws"):
            name += "_stationary" if "Lb1E" in mangled else "_stacked"
        if name == "rnea" and "RneaModeE0E" in mangled:   # RNEA_BIAS
            name += "_bias"
        if name == "minv" and mangled[m.end():].startswith("Lb0E"):
            name += "_upper"   # the upper factor's instance
        return f"{name} {'f32' if m.group(2) == 'f' else 'f64'} nj{m.group(3)}"

    stats, cur, props = {}, None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = key(m.group(1))
            if cur:
                stats.setdefault(cur, {})
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:   # the entry's own frame, not those of functions it calls
            props = key(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props:
            stats.setdefault(props, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
            props = None
            continue
        if cur is None:
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            stats[cur]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            stats[cur]["smem"] = int(s.group(1)) if s else 0
            # the entry's frame plus those of the functions it calls
            s = re.search(r"(\d+) bytes cumulative stack size", line)
            if s:
                stats[cur]["cumulative_stack"] = int(s.group(1))
    return stats


def bind(libs: dict, kernels, scratch: bool) -> dict:
    P, I, L, D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_double)
    # the kernels with a device-memory route take its workspace and blocks
    # last (None, 0 here: every count timed keeps its knots in shared
    # memory); an earlier tree's entry points without them ignore the two
    # trailing arguments
    ws = [P, L]
    sig = {"fd_du": [I, I, P, P, P, P, P, P, P, L, D, P] + ws,
           "fdsva_so": ([I, I, P, P, P, P, P, P, L, D, P] if scratch
                        else [I, I, P, P, P, P, P, L, D, P]),
           "riccati_factored": [I, I] + [P] * 9 + [I, L, I, D, D, D, P] + ws,
           "linesearch": [I, I] + [P] * 12 + [I, L, I, D, D, I, P, P] + ws,
           "riccati": [I, I] + [P] * 7 + [I] + [P] * 4 + [I, L, D, P] + ws,
           "rollout": [I, I] + [P] * 6 + [I, L, D, D, P],
           "idsva_so": [I, I, P, P, P, P, P, L, D, P, P, I, I],
           "feedback_rollout": [I, I] + [P] * 10 + [I, L, D, D, P] + ws,
           "id_du": [I, I, P, P, P, P, P, L, D, P] + ws,
           "d2eepos": [I, I, P, P, I, P, P, L, P],
           "rnea": [I, I, P, P, P, P, P, L, D, P],
           "aba": [I, I, P, P, P, P, P, L, D, P],
           "fd": [I, I, P, P, P, P, P, L, D, P] + ws,
           "eepos": [I, I, P, P, I, P, P, L, P],
           "minv": [I, I, P, P, P, L, I, P] + ws,
           "crba": [I, I, P, P, P, L, P],
           "deepos": [I, I, P, P, I, P, P, L, P]}
    out = {}
    for nj, path in libs.items():
        h = ctypes.CDLL(str(path))
        for k in set(kernels) - {"rnea_bias"}:   # rnea's entry point
            fn = getattr(h, f"gridtorch_{k}", None)
            if fn is None:   # an earlier tree without the kernel
                continue
            fn.argtypes, fn.restype = sig[k], I
        out[nj] = h
    return out


def bind_clock(path: Path):
    P, I, L, D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_double)
    h = ctypes.CDLL(str(path))
    h.phase_clock.argtypes = [I, I, P, P, P, P, L, P, P, P]
    h.ric_clock.argtypes = [I] + [P] * 9 + [I, L, I, D, D, D, P, P, P]
    h.ls_clock.argtypes = [I, I] + [P] * 12 + [I, L, I, D, P, P, P, P]
    h.ricd_clock.argtypes = [I] + [P] * 11 + [I, L, D, P, P, P]
    h.roll_clock.argtypes = [I] + [P] * 6 + [I, L, D, P, P, P]
    h.roll_shape.argtypes = [I, I, I] + [P] * 6 + [I, L, D]
    h.fbr_clock.argtypes = [I] + [P] * 10 + [I, L, D, P, P, P]
    h.fbr_shape.argtypes = [I, I, I] + [P] * 10 + [I, L, D]
    h.idso_shape.argtypes = [I, I, I, I] + [P] * 5 + [L]
    h.d2_clock.argtypes = [I, P, P, I, P, P, L, P, P, P]
    h.idu_shape.argtypes = [I, I] + [P] * 5 + [L]
    h.d2_shape.argtypes = [I, I, I, I, P, P, I, P, P, L]
    h.lane_shape.argtypes = [I, I, I, I, I] + [P] * 5 + [L]
    h.lane_clock.argtypes = [I, I, P, P, I, P, P, P, P, L, P]
    h.ee_clock.argtypes = [I, P, P, I, P, P, L, P, P, P]
    h.ee_shape.argtypes = [I, I, I, P, P, I, P, P, L]
    h.dj_clock.argtypes = [I, P, P, I, P, P, L, P, P, P]
    h.dj_shape.argtypes = [I, I, I, I, P, P, I, P, P, L]
    for fn in (h.phase_clock, h.ric_clock, h.ls_clock, h.ricd_clock,
               h.roll_clock, h.roll_shape, h.fbr_clock, h.fbr_shape,
               h.idso_shape, h.d2_clock, h.idu_shape, h.d2_shape,
               h.lane_shape, h.lane_clock, h.ee_clock, h.ee_shape,
               h.dj_clock, h.dj_shape):
        fn.restype = I
    return h


def sweep_inputs(m, cost_kind, N, B, dev):
    """The sweeps' arguments as the solver's first iteration makes them with
    the plain ops, from x0 ~ U(-0.2, 0.2) (seed 0) and U0 = 0, six step
    sizes; as chip_smoke.py's phases 3 and 6 make them: {riccati_factored
    (EE reach) or riccati (QuadCost, stationary), linesearch, rollout,
    feedback_rollout (the line search's inputs, kff = FB_ALPHA k)}."""
    from gridcodegenerator_tpu_torch.ops import eepose
    from gridcodegenerator_tpu_torch.ops.cuda import sweeps as S
    from gridcodegenerator_tpu_torch.trajopt.cost import EEReachCost, QuadCost
    from gridcodegenerator_tpu_torch.trajopt.ilqr import (
        ILQRConfig, make_ilqr, resolve_control_bounds)
    n, dt = m.n, DT.get(m.name, 0.01)
    if cost_kind == "roll":
        cost_kind = "quad4"
    if cost_kind == "ee":
        goal = eepose.eepos(m, torch.full((n, 1), 0.5, dtype=m.dtype,
                                          device=dev))[:3, 0]
        cost = EEReachCost(model=m, goal_xyz=goal, w_pos=0.5, w_pos_f=200.0)
    else:
        full = lambda v, k: torch.full((k,), v, dtype=m.dtype, device=dev)
        xg = full(0.0, 2 * n)
        xg[0] = 1.0 if cost_kind == "quad3" else 0.5
        if cost_kind == "quad3":
            xg[1] = 0.5
        cost = QuadCost(Q=full(0.1, 2 * n), R=full(1e-3, n),
                        Qf=full(100.0, 2 * n), x_goal=xg)
    cfg = ILQRConfig(N=N, dt=dt, iters=1, use_kernels=False)
    _, parts = make_ilqr(m, cost, cfg, expose_parts=True)
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(-0.2, 0.2,
                                                           (2 * n, B)),
                         dtype=m.dtype, device=dev)
    U0 = torch.zeros((N, n, B), dtype=m.dtype, device=dev)
    X = parts["rollout"](x0, U0)
    A, Bm = parts["linearize"](X[:N], U0)
    fold = lambda Z: Z.transpose(0, 1).reshape(Z.shape[1], -1)
    _, Vx0, Vxx0 = cost.terminal_expansion(X[N])
    out = {}
    if cost_kind == "ee":
        Jw, lx, lu = cost.gn_stage_factor(fold(X[:N]), fold(U0), 0)
        ric = (A, Bm, lx.contiguous(), lu.contiguous(), Jw.contiguous(),
               Vx0.contiguous(), Vxx0.contiguous(), cfg.reg,
               *cost.gn_factor_diags)
        ks, Ks = S.riccati_factored_plain(*ric)
        out["riccati_factored"] = ric
    else:
        unfold = lambda z: z.reshape(z.shape[:-1] + (N, B)).movedim(-2, 0)
        _, lx, lu, lxx, luu, lux = cost.stage_expansion(fold(X[:N]),
                                                        fold(U0), 0)
        ric = (A, Bm, unfold(lx).contiguous(), unfold(lu).contiguous(),
               *(c[..., :B].contiguous() for c in (lxx, luu, lux)),
               Vx0.contiguous(), Vxx0.contiguous(), cfg.reg)
        ks, Ks = S.riccati_plain(*ric)
        out["riccati"] = ric
    lo, hi = resolve_control_bounds(m, cfg)
    al = torch.tensor(cfg.alphas, dtype=m.dtype, device=dev)[:, None]
    out["linesearch"] = (m, X[0].contiguous(), U0, X[:N].contiguous(),
                         ks.contiguous(), Ks.contiguous(),
                         al.repeat(1, B).contiguous(), dt, -9.81, lo, hi,
                         cost)
    out["rollout"] = (m, x0, U0, dt, -9.81, lo, hi)
    out["feedback_rollout"] = (m, X[0].contiguous(), U0, X[:N].contiguous(),
                               (FB_ALPHA * ks).contiguous(), Ks.contiguous(),
                               dt, -9.81, lo, hi)
    return out


def head_ric(ric, B, nb):
    """riccati_factored's arguments on the first nb problems."""
    A, Bm, lx, lu, Jw, Vx0, Vxx0, *rest = ric
    knot = lambda z: z.reshape(z.shape[:-1] + (-1, B))[..., :nb].reshape(
        z.shape[:-1] + (-1,)).contiguous()
    return (A[..., :nb].contiguous(), Bm[..., :nb].contiguous(), knot(lx),
            knot(lu), knot(Jw), Vx0[:, :nb].contiguous(),
            Vxx0[..., :nb].contiguous(), *rest)


def head_ls(ls, nb):
    """The line search's arguments on the first nb problems."""
    m, x0, Ur, Xr, k, K, al, *rest = ls
    cut = lambda z: z[..., :nb].contiguous()
    return (m, cut(x0), cut(Ur), cut(Xr), cut(k), cut(K), cut(al), *rest)


def to64(args, m64):
    from gridcodegenerator_tpu_torch.trajopt.cost import EEReachCost, QuadCost

    def one(a):
        if isinstance(a, torch.Tensor):
            return a.double()
        if isinstance(a, EEReachCost):
            return dataclasses.replace(a, model=m64,
                                       goal_xyz=a.goal_xyz.double())
        if isinstance(a, QuadCost):
            return QuadCost(Q=a.Q.double(), R=a.R.double(), Qf=a.Qf.double(),
                            x_goal=a.x_goal.double())
        return a
    return (m64,) + tuple(one(a) for a in args[1:])


THRESHOLDS = "fd_du:f32:28,fd_du:f64:28,riccati:f32:28,riccati:f64:28"


def thresholds(work: Path, time_cuda, items: str) -> dict:
    """--hands52's `thresholds` (the module's docstring): {"kernel dtype":
    {joints: {route_ms, chip_ms}}}."""
    from gridcodegenerator_tpu_torch.models.model import build_model
    from gridcodegenerator_tpu_torch.topology.urdf import parse_urdf
    from gridcodegenerator_tpu_torch.ops.cuda import build
    from torch_big_robots import atlas_hands_name, atlas_hands_urdf

    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    exe, flags = nvcc()
    csrc = ROOT / "gridcodegenerator_tpu_torch" / "csrc"
    want = [(k, d, int(j)) for k, d, j in
            (item.split(":") for item in items.split(","))]
    joints = sorted({j for _, _, j in want})
    out_dir = work / "thresholds"
    out_dir.mkdir()

    def one(job):
        nj, src = job
        subprocess.run([exe, *flags, f"-DGT_NJ={nj}", "-DGT_CHIP_CLOCK",
                        "-I", str(csrc), "-c", str(csrc / src), "-o",
                        str(out_dir / f"{src}.nj{nj}.o")], check=True,
                       capture_output=True)

    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(one, [(nj, src) for nj in joints
                            for src in ("fd_du.cu", "riccati.cu")]))
    dev = torch.device("cuda:0")
    stream = torch.cuda.current_stream(dev).cuda_stream
    res = {f"{k} {d}": {} for k, d, _ in want}
    for nj in joints:
        lib = out_dir / f"lib{nj}.so"
        subprocess.run([exe, *flags, "-shared",
                        str(out_dir / f"fd_du.cu.nj{nj}.o"),
                        str(out_dir / f"riccati.cu.nj{nj}.o"), "-o",
                        str(lib)], check=True, capture_output=True)
        h = ctypes.CDLL(str(lib))
        h.gridtorch_fd_du.argtypes = [I, I] + [P] * 7 + [L, ctypes.c_double,
                                                         P, P, L]
        h.gridtorch_riccati.argtypes = ([I, I] + [P] * 7 + [I] + [P] * 4
                                        + [I, L, ctypes.c_double, P, P, L])
        h.gridtorch_fd_du_chip_forced.argtypes = [I] + [P] * 7 + [L, P]
        h.gridtorch_riccati_chip_forced.argtypes = ([I] + [P] * 11
                                                    + [I, L, P, L, P])
        h.gridtorch_riccati_chip_forced.restype = L
        h.gridtorch_riccati_info.argtypes = [I, I, P]
        k = (nj - 28) // 2
        topo = parse_urdf(atlas_hands_urdf(k), name=atlas_hands_name(k))
        for kernel, dname, _ in (w for w in want if w[2] == nj):
            dt = torch.float32 if dname == "f32" else torch.float64
            code = build.DTYPE_CODES[dt]
            m = build_model(topo, dtype=dt, device=dev)
            res[f"{kernel} {dname}"][nj] = threshold_times(
                h, kernel, m, code, stream, time_cuda)
            torch.cuda.empty_cache()
        print(f"thresholds nj{nj}: " + json.dumps(
            {k: v.get(nj) for k, v in res.items()}), flush=True)
    return res


def threshold_times(h, kernel, m, code, stream, time_cuda) -> dict:
    """One kernel's route and its forced on-chip program on model m (the
    library h of its joint count), config 5's shapes: {route_ms,
    chip_ms}."""
    from gridcodegenerator_tpu_torch.ops.cuda import build

    dev, nj = m.device, m.n
    gen = torch.Generator(device=dev).manual_seed(nj)
    rand = lambda *sh: (torch.rand(*sh, generator=gen, device=dev,
                                   dtype=m.dtype) * 2 - 1)
    ptr = lambda t: None if t is None else t.data_ptr()
    n, nx = nj, 2 * nj
    if kernel == "fd_du":
        lanes = 16 * 4096
        mb = build.model_buffer(m)
        q, qd, u = rand(n, lanes), rand(n, lanes), rand(n, lanes)
        outs = (torch.empty(n, 2 * n, lanes, device=dev, dtype=m.dtype),
                torch.empty(n, lanes, device=dev, dtype=m.dtype),
                torch.empty(n, n, lanes, device=dev, dtype=m.dtype))
        args = (ptr(mb), ptr(q), ptr(qd), ptr(u), *map(ptr, outs))
        return {
            "route_ms": time_cuda(lambda: build.check(h.gridtorch_fd_du(
                code, nj, *args, lanes, -9.81, stream, None, 0),
                "fd_du"), iters=3),
            "chip_ms": time_cuda(lambda: build.check(
                h.gridtorch_fd_du_chip_forced(code, *args, lanes,
                                              stream), "fd_du chip"),
                iters=3)}
    N, B, dt = 16, 4096, 0.002
    eye = lambda k: torch.eye(k, device=dev, dtype=m.dtype)[:, :,
                                                             None]
    A = (eye(nx)[None] + dt * rand(N, nx, nx, B)).contiguous()
    Bm = (dt * rand(N, nx, n, B)).contiguous()
    Mx = rand(nx, nx, B)
    ins = (A, Bm, rand(N, nx, B), rand(N, n, B),
           (torch.einsum("ikb,jkb->ijb", Mx, Mx) / nx).contiguous(),
           (1e-2 * eye(n).expand(n, n, B)).contiguous(),
           (0.1 * rand(n, nx, B)).contiguous(), rand(nx, B),
           (10 * eye(nx).expand(nx, nx, B)).contiguous())
    outs = (torch.empty(N, n, B, device=dev, dtype=m.dtype),
            torch.empty(N, n, nx, B, device=dev, dtype=m.dtype))
    per = h.gridtorch_riccati_chip_forced(code, *([None] * 11), N, B,
                                          None, 0, None)
    rec = torch.empty(per, device=dev, dtype=m.dtype)
    a7, (Vx0, Vxx0) = tuple(map(ptr, ins[:7])), ins[7:]
    # the library's route: a workspace where it takes device memory
    info = (ctypes.c_int * 16)()
    build.check(h.gridtorch_riccati_info(code, nj, info), "info")
    p = dict(zip(build.INFO_FIELDS, info))
    ws, nws = None, 0
    if p["workspace_bytes"]:
        sms = torch.cuda.get_device_properties(
            dev).multi_processor_count
        nws = min(B, max(1, p["blocks_per_sm"]) * sms)
        ws = torch.empty(nws * p["workspace_bytes"] // 4,
                         device=dev)
    return {
        "route_ms": time_cuda(lambda: build.check(
            h.gridtorch_riccati(code, nj, *a7, 1, ptr(Vx0),
                                ptr(Vxx0), *map(ptr, outs), N, B,
                                1e-6, stream, ptr(ws), nws),
            "riccati"), iters=3),
        "chip_ms": time_cuda(lambda: build.check(
            h.gridtorch_riccati_chip_forced(
                code, *a7, ptr(Vx0), ptr(Vxx0), *map(ptr, outs), N,
                B, ptr(rec), rec.numel(), stream), "riccati chip"),
            iters=3)}


def hands52(trees: dict, work: Path, time_cuda,
            threshold_items: str = THRESHOLDS) -> dict:
    """--hands52: fd_du and the dense riccati of every tree at 52 joints
    (the module's docstring)."""
    from gridcodegenerator_tpu_torch.models.model import build_model
    from gridcodegenerator_tpu_torch.topology.urdf import parse_urdf
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_big_robots import atlas_hands_name, atlas_hands_urdf
    from gridcodegenerator_tpu_torch.ops.cuda import build
    from gridcodegenerator_tpu_torch.ops.cuda import sweeps as S

    P, I, L, D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_double)
    nj, dev = 52, torch.device("cuda:0")
    out = {"ptxas": {}, "plans": {}, "ms": {}, "rel_diff": {},
           "err_vs_f64": {}}
    libs = {}
    for name, tree in trees.items():
        (work / name).mkdir()
        built, report, _ = compile_tree(tree, work / name,
                                        ["fd_du.cu", "riccati.cu"],
                                        joints=(nj,))
        out["ptxas"][name] = {k: v for k, v in parse_ptxas(report).items()
                              if "nj52" in k and (k.startswith("fd_du")
                                                  or k.startswith("riccati"))
                              and "factored" not in k}
        h = ctypes.CDLL(str(built[nj]))
        h.gridtorch_fd_du.argtypes = [I, I] + [P] * 7 + [L, D, P, P, L]
        h.gridtorch_riccati.argtypes = ([I, I] + [P] * 7 + [I] + [P] * 4
                                        + [I, L, D, P, P, L])
        for what in ("fd_du", "riccati", "riccati_stacked"):
            getattr(h, f"gridtorch_{what}_info").argtypes = [I, I, P]
        libs[name] = h
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def plan(name, what):
        info = (ctypes.c_int * 16)()
        build.check(getattr(libs[name], f"gridtorch_{what}_info")(
            0, nj, info), what)
        return dict(zip(build.INFO_FIELDS, info))

    def workspace(name, what, units, N=0):
        """An earlier tree's device-memory workspace (build.workspace), or
        this tree's problem-major copy of the sweep's inputs (B records)."""
        h = libs[name]
        inputs = getattr(h, "gridtorch_riccati_inputs", None)
        if what != "fd_du" and inputs is not None:
            inputs.argtypes, inputs.restype = [I, I, I, I], L
            per = inputs(0, nj, N, int(what == "riccati"))
            if per > 0:
                return torch.empty(units * per, device=dev), units * per
        p = plan(name, what)
        if not p["workspace_bytes"]:
            return None, 0
        blocks = min(units, max(1, p["blocks_per_sm"]) * sms)
        return torch.empty(blocks * p["workspace_bytes"] // 4,
                           device=dev), blocks

    k = (nj - 28) // 2
    m = build_model(parse_urdf(atlas_hands_urdf(k),
                               name=atlas_hands_name(k)),
                    dtype=torch.float32, device=dev)
    mb = build.model_buffer(m)
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *s: torch.rand(*s, generator=gen, device=dev) * 2 - 1
    n, nx, dt, stream = nj, 2 * nj, 0.002, torch.cuda.current_stream(
        dev).cuda_stream
    lanes = 16 * 4096
    q, qd, u = rand(n, lanes), rand(n, lanes), rand(n, lanes)

    def sweep(N, B, stat):
        eye = lambda k: torch.eye(k, device=dev)[:, :, None]
        A = (eye(nx)[None] + dt * rand(N, nx, nx, B)).contiguous()
        Bm = (dt * rand(N, nx, n, B)).contiguous()
        lead = () if stat else (N,)
        Mx = rand(*lead, nx, nx, B)
        lxx = (torch.einsum("...ikb,...jkb->...ijb", Mx, Mx) / nx).contiguous()
        luu = (1e-2 * eye(n).expand(*lead, n, n, B)).contiguous()
        lux = (0.1 * rand(*lead, n, nx, B)).contiguous()
        return (A, Bm, rand(N, nx, B), rand(N, n, B), lxx, luu, lux,
                rand(nx, B), (10 * eye(nx).expand(nx, nx, B)).contiguous())

    cases = {"fd_du": None, "riccati": sweep(16, 4096, True),
             "riccati_stacked": sweep(16, 512, False)}
    ptr = lambda t: None if t is None else t.data_ptr()

    def runner(name, what):
        h = libs[name]
        if what == "fd_du":
            outs = (torch.empty(n, 2 * n, lanes, device=dev),
                    torch.empty(n, lanes, device=dev),
                    torch.empty(n, n, lanes, device=dev))
            ws, nws = workspace(name, what, lanes)

            def fn():
                build.check(h.gridtorch_fd_du(
                    0, nj, ptr(mb), ptr(q), ptr(qd), ptr(u),
                    *map(ptr, outs), lanes, -9.81, stream, ptr(ws), nws),
                    what)
            return fn, outs
        A, Bm, lx, lu, lxx, luu, lux, Vx0, Vxx0 = cases[what]
        N, B = A.shape[0], A.shape[-1]
        outs = (torch.empty(N, n, B, device=dev),
                torch.empty(N, n, nx, B, device=dev))
        ws, nws = workspace(name, what, B, N)

        def fn():
            build.check(h.gridtorch_riccati(
                0, nj, *map(ptr, (A, Bm, lx, lu, lxx, luu, lux)),
                int(what == "riccati"), ptr(Vx0), ptr(Vxx0),
                *map(ptr, outs), N, B, 1e-6, stream, ptr(ws), nws), what)
        return fn, outs

    # this tree's phase clock (GT_CHIP_CLOCK)
    exe, flags = nvcc()
    csrc = ROOT / "gridcodegenerator_tpu_torch" / "csrc"
    clk_dir = work / "clock"
    clk_dir.mkdir()
    objs = []
    for src in ("fd_du.cu", "riccati.cu"):
        obj = clk_dir / (src + ".o")
        subprocess.run([exe, *flags, f"-DGT_NJ={nj}", "-DGT_CHIP_CLOCK",
                        "-I", str(csrc), "-c", str(csrc / src), "-o",
                        str(obj)], check=True, capture_output=True)
        objs.append(str(obj))
    subprocess.run([exe, *flags, "-shared", *objs, "-o",
                    str(clk_dir / "libclock.so")], check=True,
                   capture_output=True)
    hc = ctypes.CDLL(str(clk_dir / "libclock.so"))
    hc.gridtorch_fd_du_clock.argtypes = [P] * 9
    hc.gridtorch_riccati_clock.argtypes = [P] * 5 + [I, P, P]
    hc.gridtorch_riccati.argtypes = libs["this"].gridtorch_riccati.argtypes
    hc.gridtorch_riccati_inputs.argtypes = [I, I, I, I]
    hc.gridtorch_riccati_inputs.restype = L
    clk = torch.zeros(1 << 14, dtype=torch.int64, device=dev)
    cnt = torch.zeros(1, dtype=torch.int32, device=dev)
    one = lambda x: x[..., :1].contiguous()   # lane or problem 0
    fouts = (torch.empty(n, 2 * n, 1, device=dev),
             torch.empty(n, 1, device=dev), torch.empty(n, n, 1, device=dev))
    build.check(hc.gridtorch_fd_du_clock(
        ptr(mb), *map(ptr, (one(q), one(qd), one(u)) + fouts), ptr(clk),
        ptr(cnt)), "fd_du clock")
    torch.cuda.synchronize()
    c = clk[:int(cnt)].cpu().numpy()
    out["phase_cycles"] = {"fd_du": [int(x) for x in np.diff(c)]}
    A, Bm, lx, lu, lxx, luu, lux, Vx0, Vxx0 = cases["riccati"]
    N, B = A.shape[0], A.shape[-1]
    per = hc.gridtorch_riccati_inputs(0, nj, N, 1)
    rec = torch.empty(B * per, device=dev)
    routs = (torch.empty(N, n, B, device=dev),
             torch.empty(N, n, nx, B, device=dev))
    build.check(hc.gridtorch_riccati(
        0, nj, *map(ptr, (A, Bm, lx, lu, lxx, luu, lux)), 1, ptr(Vx0),
        ptr(Vxx0), *map(ptr, routs), N, B, 1e-6, stream, ptr(rec),
        rec.numel()), "riccati")
    clk.zero_()
    routs = tuple(one(o) for o in routs)
    build.check(hc.gridtorch_riccati_clock(
        *map(ptr, (rec, one(Vx0), one(Vxx0)) + routs), N, ptr(clk),
        ptr(cnt)), "riccati clock")
    torch.cuda.synchronize()
    c = np.diff(clk[:int(cnt)].cpu().numpy()).reshape(N, -1)
    # a knot's phases: the wait, Qx/Qu and the first slab, a phase a slab,
    # [Quu + reg I | I], Gauss-Jordan a pivot a phase, K, W, V, Vxx
    ns = c.shape[1] - 7 - nj
    steps = [("wait", 0, 1), ("q_and_first_slab", 1, 2),
             ("slabs", 2, 2 + ns), ("aug", 2 + ns, 3 + ns),
             ("gauss_jordan", 3 + ns, 3 + ns + nj),
             ("gains", 3 + ns + nj, 4 + ns + nj),
             ("w", 4 + ns + nj, 5 + ns + nj),
             ("value", 5 + ns + nj, 6 + ns + nj),
             ("symmetrize", 6 + ns + nj, 7 + ns + nj)]
    out["phase_cycles"]["riccati_knot_mean"] = {
        k: float(c[1:, a:b].sum(1).mean()) for k, a, b in steps}
    print("hands52 phase_cycles: " + json.dumps(out["phase_cycles"]),
          flush=True)
    out["thresholds"] = thresholds(work, time_cuda, threshold_items)

    names = list(trees)
    order = names[1:] + ["this", "this"] + names[1:][::-1]
    for what in cases:
        out["plans"][what] = {name: {
            f: v for f, v in plan(name, what).items()
            if f in ("knots_per_block", "threads_per_knot",
                     "smem_bytes_per_block", "registers", "local_bytes",
                     "blocks_per_sm", "workspace_bytes", "cluster_blocks")}
            for name in names}
        runs = {name: runner(name, what) for name in names}
        for name in names:
            runs[name][0]()
        torch.cuda.synchronize()
        first = runs[names[1]][1]
        out["rel_diff"][what] = max(
            float((o - r).abs().max()) / max(1.0, float(r.abs().max()))
            for o, r in zip(runs["this"][1], first))
        if what != "fd_du":
            ref = S.riccati_plain(*(a[..., :8].double()
                                    for a in cases[what]), 1e-6)
            out["err_vs_f64"][what] = {name: max(
                float((o[..., :8].double() - r).abs().max())
                / max(1.0, float(r.abs().max()))
                for o, r in zip(runs[name][1], ref)) for name in names}
        ms = {name: [] for name in names}
        for name in order:
            ms[name].append(time_cuda(runs[name][0], iters=3))
        out["ms"][what] = ms
        print(f"hands52 {what}: " + json.dumps({
            "ms": ms, "rel_diff": out["rel_diff"][what],
            "err_vs_f64": out["err_vs_f64"].get(what)}), flush=True)
        del runs
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, type=Path, action="append")
    ap.add_argument("--kernels", default=DEFAULT_KERNELS)
    ap.add_argument("--sass", default="",
                    help="kernels whose objects are compiled in every tree "
                         "and compared by cuobjdump -sass with the first "
                         "other tree's, not timed")
    ap.add_argument("--out", default="build/compare_kernels.json")
    ap.add_argument("--hands52", action="store_true",
                    help="only fd_du and the dense riccati at 52 joints, "
                         "config 5's shapes (the module's docstring)")
    ap.add_argument("--thresholds", default=THRESHOLDS,
                    help="with --hands52: kernel:dtype:joints items whose "
                         "route is timed against the forced on-chip one")
    args = ap.parse_args()
    kernels = tuple(args.kernels.split(","))
    if any(k not in SOURCES for k in kernels):
        raise ValueError(f"--kernels: each of {tuple(SOURCES)}")
    if "rnea" in kernels and "rnea_bias" not in kernels:
        kernels += ("rnea_bias",)
    if not torch.cuda.is_available():
        raise RuntimeError("compare_kernels.py needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    from gridcodegenerator_tpu_torch.models.model import build_model
    from gridcodegenerator_tpu_torch.models.zoo import load_robot
    from gridcodegenerator_tpu_torch.ops.cuda import build
    from gridcodegenerator_tpu_torch.ops.cuda import kernels as K
    from gridcodegenerator_tpu_torch.ops.cuda import sweeps as S
    from gridcodegenerator_tpu_torch.utils.timing import time_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    trees = {"this": ROOT} | {d.resolve().name: d.resolve()
                              for d in args.other}
    others = list(trees)[1:]
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="compare-", dir=ROOT / "build"))
    if args.hands52:
        result = {"device": smi} | hands52(trees, work, time_cuda,
                                           args.thresholds)
        print("hands52: " + json.dumps(result), flush=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
        return
    result = {"device": smi, "ptxas": {}, "info": {}, "times": []}
    sass = tuple(k for k in args.sass.split(",") if k)
    if any(k not in SOURCES for k in sass):
        raise ValueError(f"--sass: each of {tuple(SOURCES)}")
    sources = sorted({SOURCES[k] for k in kernels + sass})
    libs = {}
    for name, tree in trees.items():
        (work / name).mkdir()
        built, report, clocks = compile_tree(tree, work / name, sources,
                                             clocked=name == "this")
        if name == "this":
            clock_libs = {nj: bind_clock(p) for nj, p in clocks.items()}
        result["ptxas"][name] = parse_ptxas(report)
        so_src = tree / "gridcodegenerator_tpu_torch" / "csrc" / "fdsva_so.cu"
        scratch = so_src.exists() and "void* scratch" in so_src.read_text()
        libs[name] = bind(built, kernels, scratch), scratch
    for nj in JOINTS:
        for dtype in (torch.float32, torch.float64):
            for what in set(kernels) & set(build.WARP_KERNELS):
                result["info"][f"{what} {str(dtype)[6:]} nj{nj}"] = \
                    build.warp_kernel_info(what, nj, dtype)
    if sass:
        result["sass"] = compare_sass(work, others[0], tree_joints(ROOT),
                                      sorted({SOURCES[k] for k in sass}))
        print("sass: " + json.dumps(result["sass"]), flush=True)
    print("ptxas: " + json.dumps(result["ptxas"]), flush=True)
    print("info: " + json.dumps(result["info"]), flush=True)

    dev = torch.device("cuda:0")
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()
    models = {}
    rec = torch.zeros(4096, dtype=torch.int64, device=dev)
    phases = torch.zeros(1, dtype=torch.int32, device=dev)
    knot = torch.zeros(2, dtype=torch.int64, device=dev)
    clock_out = lambda: (ptr(rec), ptr(phases), ptr(knot))

    def graph_ms(fn, launches=20, replays=5):
        """Device ms a launch of `fn` (a bare launch on `stream`) from a CUDA
        graph of `launches` launches, replayed: no host time between them,
        where back-to-back calls of a kernel of a few microseconds read the
        host's time a call; the error's text if the capture failed."""
        nonlocal stream
        g = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(g):
                stream = torch.cuda.current_stream(dev).cuda_stream
                for _ in range(launches):
                    fn()
        except RuntimeError as e:
            return str(e)
        finally:
            stream = torch.cuda.current_stream(dev).cuda_stream
        return time_cuda(g.replay, iters=replays) / launches

    for what, robot, shape in SHAPES:
        if what not in kernels:
            continue
        if robot not in models:
            models[robot] = build_model(load_robot(robot),
                                        dtype=torch.float32, device=dev)
        m = models[robot]
        m64 = m.to(dtype=torch.float64)
        n = m.n
        clock = clock_libs[n]
        entry = "rnea" if what == "rnea_bias" else what
        # the trees that build this joint count and kernel (an earlier tree
        # may build fewer)
        has = [t for t in trees if n in libs[t][0]
               and hasattr(libs[t][0][n], f"gridtorch_{entry}")]
        if what in KNOT_KERNELS:
            lanes = shape
            rng = np.random.default_rng(0)
            q, qd, u = (torch.as_tensor(rng.uniform(-1, 1, (n, lanes)),
                                        dtype=torch.float32, device=dev)
                        for _ in range(3))
            mb = build.model_buffer(m)
            eb = build.ee_buffer(m)
            ne = eb.shape[0]

            def d2_out():
                return torch.empty(6 * ne, n, n, lanes, device=dev)

            def runner(tree):
                lib = libs[tree][0][n]
                if what in ("rnea", "rnea_bias", "aba"):
                    outs = (torch.empty(n, lanes, device=dev),)
                    x = None if what == "rnea_bias" else u
                    entry = (lib.gridtorch_aba if what == "aba"
                             else lib.gridtorch_rnea)

                    def fn():
                        build.check(entry(0, n, ptr(mb), ptr(q), ptr(qd),
                                          ptr(x), ptr(outs[0]), lanes, -9.81,
                                          stream), what)
                    return fn, outs
                if what == "id_du":
                    outs = (torch.empty(n, 2 * n, lanes, device=dev),)

                    def fn():
                        build.check(lib.gridtorch_id_du(
                            0, n, ptr(mb), ptr(q), ptr(qd), ptr(u),
                            ptr(outs[0]), lanes, -9.81, stream, None, 0), what)
                    return fn, outs
                if what == "d2eepos":
                    outs = (d2_out(),)

                    def fn():
                        build.check(lib.gridtorch_d2eepos(
                            0, n, ptr(mb), ptr(eb), ne, ptr(q), ptr(outs[0]),
                            lanes, stream), what)
                    return fn, outs
                if what in ("eepos", "deepos"):
                    cols = (n,) if what == "deepos" else ()
                    outs = (torch.empty(6 * ne, *cols, lanes, device=dev),)
                    ee_fn = getattr(lib, f"gridtorch_{what}")

                    def fn():
                        build.check(ee_fn(0, n, ptr(mb), ptr(eb), ne, ptr(q),
                                          ptr(outs[0]), lanes, stream), what)
                    return fn, outs
                if what == "fd":
                    outs = (torch.empty(n, lanes, device=dev),)

                    def fn():
                        build.check(lib.gridtorch_fd(
                            0, n, ptr(mb), ptr(q), ptr(qd), ptr(u),
                            ptr(outs[0]), lanes, -9.81, stream, None, 0), what)
                    return fn, outs
                if what in ("minv", "crba"):
                    outs = (torch.empty(n, n, lanes, device=dev),)
                    dense = (1,) if what == "minv" else ()
                    no_ws = (None, 0) if what == "minv" else ()
                    m_fn = getattr(lib, f"gridtorch_{what}")

                    def fn():
                        build.check(m_fn(0, n, ptr(mb), ptr(q), ptr(outs[0]),
                                         lanes, *dense, stream, *no_ws), what)
                    return fn, outs
                if what == "fd_du":
                    outs = (torch.empty(n, 2 * n, lanes, device=dev),
                            torch.empty(n, lanes, device=dev),
                            torch.empty(n, n, lanes, device=dev))

                    def fn():
                        build.check(lib.gridtorch_fd_du(
                            0, n, ptr(mb), ptr(q), ptr(qd), ptr(u),
                            *map(ptr, outs), lanes, -9.81, stream, None, 0),
                            what)
                    return fn, outs
                outs = (torch.empty(4, n, n, n, lanes, device=dev),)
                if what == "idsva_so":
                    def fn():
                        build.check(lib.gridtorch_idsva_so(
                            0, n, ptr(mb), ptr(q), ptr(qd), ptr(u),
                            ptr(outs[0]), lanes, -9.81, stream, None, 0, 0),
                            what)
                    return fn, outs
                extra = ((torch.empty(4, n, n, n, lanes, device=dev),)
                         if libs[tree][1] else ())

                def fn():
                    build.check(lib.gridtorch_fdsva_so(
                        0, n, ptr(mb), ptr(q), ptr(qd), ptr(u),
                        ptr(outs[0]), *map(ptr, extra), lanes, -9.81,
                        stream), what)
                return fn, outs

            sub = slice(0, min(lanes, 1024))
            if what == "rnea_bias":
                ref64 = K.rnea_plain(m64, q[:, sub].double(),
                                     qd[:, sub].double())
            elif what in ("d2eepos", "eepos", "deepos", "crba"):
                ref64 = getattr(K, f"{what}_plain")(m64, q[:, sub].double())
            elif what == "minv":
                ref64 = K.minv_plain(m64, q[:, sub].double(), True)
            else:
                ref64 = getattr(K, f"{what}_plain")(
                    m64, q[:, sub].double(), qd[:, sub].double(),
                    u[:, sub].double())
            ref64 = ref64 if isinstance(ref64, tuple) else (ref64,)
            cut = lambda outs: tuple(o[..., sub] for o in outs)
            rows = 1
            label = lanes

            def clock_fn():
                if what == "d2eepos":
                    return clock.d2_clock(n, ptr(mb), ptr(eb), ne, ptr(q),
                                          ptr(d2_out()), lanes, *clock_out())
                if what in ("eepos", "deepos"):
                    cols = (n,) if what == "deepos" else ()
                    out = torch.empty(6 * ne, *cols, lanes, device=dev)
                    fn = clock.dj_clock if cols else clock.ee_clock
                    return fn(n, ptr(mb), ptr(eb), ne, ptr(q), ptr(out), lanes,
                              *clock_out())
                return clock.phase_clock(CLOCK_MODE[what], n, ptr(mb),
                                         ptr(q), ptr(qd), ptr(u), lanes,
                                         *clock_out())

            def wrapper_fn():   # this tree's wrapper, as GRiD calls it
                if what in ("fd", "minv"):
                    return getattr(K, what)(m, q, *((qd, u) if what == "fd"
                                                    else (True,)))
                return getattr(K, what)(m, q)
        else:
            cost_kind, N, B = shape
            ins = sweep_inputs(m, cost_kind, N, B, dev)
            label = f"{cost_kind} N={N} B={B}"
            nb = min(B, CHECK)
            if what == "riccati_factored":
                ric = ins[what]
                A, Bm, lx, lu, Jw, Vx0, Vxx0, *scalars = ric
                reg, qdg, udg = map(float, scalars)
                r = Jw.shape[0]

                def runner(tree):
                    lib = libs[tree][0][n]
                    outs = (torch.empty(N, n, B, device=dev),
                            torch.empty(N, n, 2 * n, B, device=dev))

                    def fn():
                        build.check(lib.gridtorch_riccati_factored(
                            0, n, *map(ptr, (A, Bm, lx, lu, Jw, Vx0, Vxx0)),
                            *map(ptr, outs), N, B, r, reg, qdg, udg, stream,
                            None, 0), what)
                    return fn, outs
                ref64 = S.riccati_factored_plain(
                    *(a.double() if isinstance(a, torch.Tensor) else a
                      for a in head_ric(ric, B, nb)))
                cut = lambda outs: tuple(o[..., :nb] for o in outs)
                rows = 1

                def clock_fn():
                    outs = (torch.empty(N, n, B, device=dev),
                            torch.empty(N, n, 2 * n, B, device=dev))
                    return clock.ric_clock(
                        n, *map(ptr, (A, Bm, lx, lu, Jw, Vx0, Vxx0)),
                        *map(ptr, outs), N, B, r, reg, qdg, udg,
                        *clock_out())
            elif what == "riccati":
                ric = ins[what]
                A, Bm, lx, lu, lxx, luu, lux, Vx0, Vxx0, reg = ric
                stat = int(lxx.ndim == 3)

                def runner(tree):
                    lib = libs[tree][0][n]
                    outs = (torch.empty(N, n, B, device=dev),
                            torch.empty(N, n, 2 * n, B, device=dev))

                    def fn():
                        build.check(lib.gridtorch_riccati(
                            0, n, *map(ptr, (A, Bm, lx, lu, lxx, luu, lux)),
                            stat, ptr(Vx0), ptr(Vxx0), *map(ptr, outs), N, B,
                            float(reg), stream, None, 0), what)
                    return fn, outs
                ref64 = S.riccati_plain(*(
                    a[..., :nb].double() if isinstance(a, torch.Tensor)
                    else a for a in ric))
                cut = lambda outs: tuple(o[..., :nb] for o in outs)
                rows = 1

                def clock_fn():
                    outs = (torch.empty(N, n, B, device=dev),
                            torch.empty(N, n, 2 * n, B, device=dev))
                    return clock.ricd_clock(
                        n, *map(ptr, (A, Bm, lx, lu, lxx, luu, lux, Vx0,
                                      Vxx0)),
                        *map(ptr, outs), N, B, float(reg), *clock_out())
            elif what == "rollout":
                _, x0, U0, dt, g, lo, hi = ins[what]
                mb = build.model_buffer(m)

                def launch(lib_fn, X):
                    return lib_fn(0, n, ptr(mb), ptr(x0), ptr(U0), ptr(lo),
                                  ptr(hi), ptr(X), N, B, dt, g, stream)

                def runner(tree):
                    lib = libs[tree][0][n]
                    outs = (torch.empty(N, 2 * n, B, device=dev),)

                    def fn():
                        build.check(launch(lib.gridtorch_rollout, outs[0]),
                                    what)
                    return fn, outs
                ref64 = (S.rollout_plain(m64, x0[:, :nb].double(),
                                         U0[..., :nb].double(), dt, g,
                                         *(None if b is None else b.double()
                                           for b in (lo, hi))),)
                cut = lambda outs: tuple(o[..., :nb] for o in outs)
                rows = 1

                def clock_fn():
                    X = torch.empty(N, 2 * n, B, device=dev)
                    return clock.roll_clock(
                        n, ptr(mb), ptr(x0), ptr(U0), ptr(lo), ptr(hi),
                        ptr(X), N, B, dt, *clock_out())
            elif what == "feedback_rollout":
                fb = ins[what]
                _, x0, Ur, Xr, kf, Km, dt, g, lo, hi = fb
                mb = build.model_buffer(m)
                fb_in = tuple(map(ptr, (mb, x0, Ur, Xr, kf, Km, lo, hi)))

                def fb_outs():
                    return (torch.empty(N, 2 * n, B, device=dev),
                            torch.empty(N, n, B, device=dev))

                def runner(tree):
                    lib = libs[tree][0][n]
                    outs = fb_outs()

                    def fn():
                        build.check(lib.gridtorch_feedback_rollout(
                            0, n, *fb_in, *map(ptr, outs), N, B, dt, g,
                            stream, None, 0), what)
                    return fn, outs
                cut_fb = lambda z: z[..., :nb].contiguous()
                head = fb[:1] + tuple(map(cut_fb, fb[1:6])) + fb[6:]
                ref64 = S.feedback_rollout_plain(*to64(head, m64))
                cut = lambda outs: tuple(o[..., :nb] for o in outs)
                rows = 1

                def clock_fn():
                    return clock.fbr_clock(n, *fb_in, *map(ptr, fb_outs()),
                                           N, B, dt, *clock_out())
            else:
                _, x0, Ur, Xr, kf, Km, al, dt, g, lo, hi, cost = ins[what]
                na = al.shape[0]
                w = cost.kernel_weights
                kind = S.COST_KINDS[w["kind"]]
                mb = build.model_buffer(m, w["ee_index"])
                cb = build.cost_buffer(cost, x0)

                def runner(tree):
                    lib = libs[tree][0][n]
                    outs = (torch.empty(N, 2 * n, na * B, device=dev),
                            torch.empty(N, n, na * B, device=dev),
                            torch.empty(na * B, device=dev))

                    def fn():
                        build.check(lib.gridtorch_linesearch(
                            0, n, ptr(mb), *map(ptr, (x0, Ur, Xr, kf, Km, al,
                                                      lo, hi)),
                            *map(ptr, outs), N, B, na, dt, g, kind, ptr(cb),
                            stream, None, 0), what)
                    return fn, outs
                head = head_ls(ins[what], nb)
                ref64 = S.linesearch_rollout_plain(*to64(head, m64))
                cut = lambda outs: tuple(
                    o.reshape(o.shape[:-1] + (na, B))[..., :nb]
                    .reshape(o.shape[:-1] + (na * nb,)) for o in outs)
                rows = na

                def clock_fn():
                    outs = (torch.empty(N, 2 * n, na * B, device=dev),
                            torch.empty(N, n, na * B, device=dev),
                            torch.empty(na * B, device=dev))
                    return clock.ls_clock(
                        kind, n, ptr(mb), *map(ptr, (x0, Ur, Xr, kf, Km, al,
                                                     lo, hi)),
                        *map(ptr, outs), N, B, na, dt, ptr(cb),
                        *clock_out())

        run = {tree: runner(tree) for tree in has}
        for fn, _ in run.values():
            fn()
        torch.cuda.synchronize()

        def row_err(outs):   # per output, per step-size row
            return [(o.double() - r).abs().reshape(-1, rows, o.shape[-1]
                                                   // rows).amax(dim=(0, 2))
                    for o, r in zip(cut(outs), ref64)]
        err = {tree: row_err(outs) for tree, (_, outs) in run.items()}
        scale = [r.abs().reshape(-1, rows, r.shape[-1] // rows).amax(
            dim=(0, 2)).clamp(min=1.0) for r in ref64]
        for e, e0, s in zip(err["this"], err[others[0]], scale):
            # rows the other tree leaves non-finite (float32 overflow of
            # an unstable alpha = 1 loop) bound nothing
            if not bool(((e <= 10 * e0 + 1e-5 * s) | ~e0.isfinite()).all()):
                raise AssertionError(f"{what} {robot} {label}: this tree's "
                                     f"error vs float64 {e.tolist()}, "
                                     f"{others[0]}'s {e0.tolist()}")
        iters = (20 if what in KNOT_KERNELS and shape <= 32768
                 else 10)
        mine = [t for t in others if t in run]
        order = mine + ["this", "this"] + mine[::-1]
        ms = {tree: [] for tree in run}
        for tree in order:
            ms[tree].append(time_cuda(run[tree][0], iters=iters))
        gms = {tree: [] for tree in run}
        if what in KNOT_KERNELS and shape <= 1024:
            for tree in order:
                gms[tree].append(graph_ms(run[tree][0]))
        if what == "rollout":   # the block shapes against the plan
            X = torch.empty(N, 2 * n, B, device=dev)
            ref = run["this"][1][0]
            shapes = {}
            for lanes_g in ROLL_SHAPES:
                def shape_fn():
                    return clock.roll_shape(
                        *lanes_g, n, ptr(mb), ptr(x0), ptr(U0), ptr(lo),
                        ptr(hi), ptr(X), N, B, dt)
                code = shape_fn()
                if code == 9:   # cudaErrorInvalidConfiguration: does not fit
                    continue
                build.check(code, "rollout shape")
                torch.cuda.synchronize()
                shapes["x".join(map(str, lanes_g))] = {
                    "ms": time_cuda(shape_fn, iters=iters),
                    "max_abs_diff_vs_plan": float((X - ref).abs().max())}
            del X
        if what == "feedback_rollout":   # the block shapes against the plan
            outs = fb_outs()
            shapes = {}
            for lanes_g in ROLL_SHAPES:
                def shape_fn():
                    return clock.fbr_shape(*lanes_g, n, *fb_in,
                                           *map(ptr, outs), N, B, dt)
                code = shape_fn()
                if code == 9:   # cudaErrorInvalidConfiguration: does not fit
                    continue
                build.check(code, "feedback rollout shape")
                torch.cuda.synchronize()
                shapes["x".join(map(str, lanes_g))] = {
                    "ms": time_cuda(shape_fn, iters=iters),
                    "max_abs_diff_vs_plan": max(
                        float((o - r).abs().max())
                        for o, r in zip(outs, run["this"][1]))}
            del outs
        if what == "idsva_so":   # the knot shapes that fit, against the plan
            out = torch.empty(4, n, n, n, lanes, device=dev)
            shapes = {}
            base = 16 if 2 * n <= 16 else 32   # warp.cuh:knot_lanes
            for (mult, g), resident in itertools.product(IDSO_SHAPES,
                                                         (1, 0)):
                def shape_fn():
                    return clock.idso_shape(mult, g, resident, n, ptr(mb),
                                            ptr(q), ptr(qd), ptr(u), ptr(out),
                                            lanes)
                code = shape_fn()
                if code == 9:   # cudaErrorInvalidConfiguration: does not fit
                    continue
                build.check(code, "idsva_so shape")
                torch.cuda.synchronize()
                key = f"{mult * base}x{g}" + ("" if resident else " a group"
                                              " a block")
                shapes[key] = {
                    "ms": time_cuda(shape_fn, iters=iters),
                    "max_abs_diff_vs_plan": float(
                        (out - run["this"][1][0]).abs().max())}
            del out
        if what == "id_du":   # the column passes against the plan
            out = torch.empty(n, 2 * n, lanes, device=dev)
            shapes = {}
            for passes in IDU_PASSES:
                def shape_fn():
                    build.check(clock.idu_shape(passes, n, ptr(mb), ptr(q),
                                                ptr(qd), ptr(u), ptr(out),
                                                lanes), "id_du shape")
                shape_fn()
                torch.cuda.synchronize()
                shapes[f"{passes} pass{'es' if passes > 1 else ''}"] = {
                    "ms": time_cuda(shape_fn, iters=iters),
                    "max_abs_diff_vs_plan": float(
                        (out - run["this"][1][0]).abs().max())}
            del out
        if what == "d2eepos":   # the shapes that fit, against the plan
            out = d2_out()
            shapes = {}
            for (w, g), stage in itertools.product(D2_SHAPES, (1, 0)):
                def shape_fn():
                    return clock.d2_shape(w, g, stage, n, ptr(mb), ptr(eb),
                                          ne, ptr(q), ptr(out), lanes)
                code = shape_fn()
                if code == 9:   # cudaErrorInvalidConfiguration: does not fit
                    continue
                build.check(code, "d2eepos shape")
                torch.cuda.synchronize()
                key = f"{w}x{g}" + ("" if stage else " direct")
                shapes[key] = {
                    "ms": time_cuda(shape_fn, iters=iters),
                    "max_abs_diff_vs_plan": float(
                        (out - run["this"][1][0]).abs().max())}
            del out
        if what in ("rnea", "rnea_bias", "aba", "fd", "eepos", "minv",
                    "crba", "deepos"):
            # the shapes against the plan
            out = torch.empty_like(run["this"][1][0])
            shapes = {}
            kind = {"aba": 1, "fd": 2, "minv": 3, "crba": 4}.get(what, 0)
            ee_kernel = what in ("eepos", "deepos")
            # deepos's shapes also with its knots 16 banks apart
            variants = ((0, ""), (1, " 16 banks")) if what == "deepos" else (
                (0, ""),)
            for (w, g), (banks16, tag) in itertools.product(
                    EE_SHAPES if ee_kernel else LANE_SHAPES, variants):
                def shape_fn():
                    if what == "deepos":
                        return clock.dj_shape(w, g, banks16, n, ptr(mb),
                                              ptr(eb), ne, ptr(q), ptr(out),
                                              lanes)
                    if what == "eepos":
                        return clock.ee_shape(w, g, n, ptr(mb), ptr(eb), ne,
                                              ptr(q), ptr(out), lanes)
                    return clock.lane_shape(kind, int(what == "rnea_bias"),
                                            w, g, n, ptr(mb), ptr(q),
                                            ptr(qd), ptr(u), ptr(out), lanes)
                code = shape_fn()
                if code == 9:   # cudaErrorInvalidConfiguration: does not fit
                    continue
                build.check(code, f"{what} shape")
                torch.cuda.synchronize()
                shapes[f"{w}x{g}{tag}"] = {
                    "ms": time_cuda(shape_fn, iters=iters),
                    "max_abs_diff_vs_plan": float(
                        (out - run["this"][1][0]).abs().max())}
            del out
        row = {"kernel": what, "robot": robot, "joints": n, "shape": label,
               "ms": ms,
               **({"graph_ms": gms} if any(gms.values()) else {}),
               "err_vs_f64": {t: max(float(x.max()) for x in e)
                              for t, e in err.items()}}
        build.check(clock_fn(), "phase clock")   # the programs' phases
        torch.cuda.synchronize()
        nph = min(int(phases.item()), 4096)
        cyc = rec[:nph].tolist()
        row["knot_cycles"] = int(knot[0])
        if what in SERIAL_MODE:   # the serial function, a thread a lane
            scratch_out = torch.empty(max(6 * ne, n) * n * lanes, device=dev)
            build.check(clock.lane_clock(
                SERIAL_MODE[what], n, ptr(mb), ptr(eb), ne, ptr(q), ptr(qd),
                ptr(u), ptr(scratch_out), lanes, ptr(knot)), "lane clock")
            torch.cuda.synchronize()
            row["serial_cycles"] = int(knot[0])
            row["wrapper_ms"] = time_cuda(wrapper_fn, iters=iters)
            del scratch_out
        if what == "crba" and robot == "iiwa" and lanes <= 1024:
            # Minv by two calls: the crba kernel, then torch.linalg.inv
            row["crba_inv_ms"] = time_cuda(
                lambda: torch.linalg.inv(K.crba(m, q).permute(2, 0, 1)),
                iters=iters)
        if what in ("rollout", "feedback_rollout", "idsva_so", "id_du",
                    "d2eepos", "rnea", "rnea_bias", "aba", "fd", "eepos",
                    "minv", "crba", "deepos"):
            row["block_shapes"] = shapes
        if what in KNOT_KERNELS:
            row["phase_cycles"] = cyc
            row["head_cycles"] = int(knot[1])
        else:   # each phase's mean over the knots
            steps = N
            per = nph // steps
            arr = np.asarray(cyc[:per * steps]).reshape(steps, per)
            row |= {"phases": nph, "phases_per_step": per,
                    "step_phase_cycles_mean": arr.mean(0).round(1).tolist(),
                    "step_cycles_mean": float(arr.sum(1).mean()),
                    "after_last_step": cyc[per * steps:]}
        result["times"].append(row)
        print("time: " + json.dumps(row), flush=True)
        del run
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
