"""The kernels above 28 joints on the host: their block plans, and the
block code of the instances that the device-memory routes and the on-chip
routes changed or added.

* Every block plan of every kernel but the second-order pair, at every
  joint count from 29 to 64 in float32 and float64, holds a knot (problem,
  rollout) in a block's shared memory or takes the device-memory route
  (csrc/warp.cuh: WsPlan; the rollouts' tiles: TILES_WS), and stays within
  the 232,448 bytes a block may use: a g++ build of the plan constants
  alone (csrc/warp.cuh, csrc/sweep_warp.cuh).
* A host C++ build of the kernels whose plans changed (fd_du, id_du, minv,
  fd, the three Riccati instances, the rollouts and the line search; their
  device-memory instances run one knot a block with csrc/warp.cuh:
  WS_LANES threads; fd_du and the dense riccati run one knot or problem a
  block or a thread-block cluster with its state on chip instead:
  csrc/warp.cuh: FDChipPlan, csrc/sweep_warp.cuh: RicChipPlan), at 34 and
  52 joints (atlas with grippers and with hands,
  tests/torch_big_robots.py), driven over a few lanes through ctypes as
  tests/test_torch_kernels.py drives its harness, against the plain
  PyTorch versions in float64 (1e-9 of each output's scale).
* The on-chip programs of fd_du and the dense riccati with the plans of
  both dtypes (the chunks, slabs and threads of each; run in float64), and
  with the race check on: no entry of the knot's or problem's state
  written by two threads of one phase, and the same bits with each phase's
  threads in reverse order.
* idsva_so's device-memory tile (csrc/warp.cuh: IDSOTilePlan,
  idsva_so_knot_to; the float64 plan's G and threads a knot, on the lists
  so_lists_host builds, as the library's gridtorch_so_lists does for the
  card) at 34 and 52 joints, with the race check on (each entry of the
  output and of the knot's shared state touched by one thread of a phase;
  the threads of each phase also run in reverse), against idsva_so_plain
  in float64 (1e-9 of its scale); and idsva_so's routes there
  (csrc/warp.cuh: idso_route).

Skipped without a host C++ compiler. This file imports no jax.
"""

import ctypes
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_kernels as tk
from gridcodegenerator_tpu_torch.models.model import build_model
from gridcodegenerator_tpu_torch.topology.urdf import parse_urdf
from torch_big_robots import atlas_hands_name, atlas_hands_urdf

torch.set_num_threads(1)
CSRC = (Path(__file__).resolve().parents[1] / "gridcodegenerator_tpu_torch"
        / "csrc")
TOL = 1e-9
SMEM_LIMIT = 232448
# the hands' joints (k a hand) of the two robots, and their sweeps' step:
# the fingers' light links under the joint damping make semi-implicit Euler
# diverge at 0.01 (in the JAX reference too: test_torch_big_robots.py)
HANDS = {34: 3, 52: 12}
DT = 0.002

PLANS = r"""
#include <cstdio>
#include <utility>
#include "sweep_warp.cuh"
using namespace gt;

// name, dtype, joints, G, threads, bytes a block, device-memory bytes a
// block, blocks a problem (a cluster's on chip)
template <class P>
void row(const char* name, const char* dt, int nj) {
  std::printf("%s %s %d %d %d %lld %lld %d\n", name, dt, nj, (int)P::G,
              (int)P::LANES, (long long)P::BYTES,
              (long long)PlanWs<P>::value, PlanCluster<P>::value);
}
// the route's plan: on chip where the shared-memory plan holds no knot
template <bool CHIP, class Chip, class Shared>
void route(const char* name, const char* dt, int nj) {
  if constexpr (CHIP)
    row<Chip>(name, dt, nj);
  else
    row<Shared>(name, dt, nj);
}
template <typename T, int NJ>
void plans(const char* dt) {
  route<fd_on_chip<T, NJ>(), FDChipPlan<T, NJ>, FDPlan<T, NJ>>("fd_du", dt,
                                                                NJ);
  row<IDUPlan<T, NJ>>("id_du", dt, NJ);
  row<MinvPlan<T, NJ>>("minv", dt, NJ);
  row<FDPlanQ<T, NJ>>("fd", dt, NJ);
  row<RNEAPlan<T, NJ>>("rnea", dt, NJ);
  row<ABAPlan<T, NJ>>("aba", dt, NJ);
  row<CRBAPlan<T, NJ>>("crba", dt, NJ);
  row<EEPlan<T, NJ>>("eepos", dt, NJ);
  row<DJPlan<T, NJ>>("deepos", dt, NJ);
  row<D2Plan<T, NJ>>("d2eepos", dt, NJ);
  row<RicPlan<T, NJ>>("riccati_factored", dt, NJ);
  route<ric_on_chip<T, NJ, RIC_STATIONARY>(), RicChipPlan<T, NJ>,
        RicPlan<T, NJ, RIC_STATIONARY>>("riccati", dt, NJ);
  route<ric_on_chip<T, NJ, RIC_DENSE>(), RicChipPlan<T, NJ>,
        RicPlan<T, NJ, RIC_DENSE>>("riccati_stacked", dt, NJ);
  row<LSPlan<T, NJ>>("linesearch", dt, NJ);
  row<RollPlan<T, NJ>>("rollout", dt, NJ);
  row<FBPlan<T, NJ>>("feedback_rollout", dt, NJ);
}
template <int... N>
void all(std::integer_sequence<int, N...>) {
  ((plans<float, 29 + N>("float32"), plans<double, 29 + N>("float64")), ...);
}
int main() { all(std::make_integer_sequence<int, 36>{}); }
"""

HARNESS = r"""
#define GT_RACE_CHECK
#include <cstring>
#include <unordered_map>
#include "fd_du.cu"
#include "id_du.cu"
#include "minv.cu"
#include "fd.cu"
#include "riccati.cu"
#include "rollout.cu"
#include "feedback_rollout.cu"
#include "linesearch.cu"
#include "idsva_so.cu"
using namespace gt;
typedef long long ll;

""" + tk.RACE_CHECK + r"""

// the entry points of tests/test_torch_kernels.py's harness (its
// _host_run drives them), for the kernels whose plans changed
#define HOST(NJ)                                                            \
extern "C" void fd_du_##NJ(const double* m, const double* q,                \
    const double* qd, const double* u, double* d, double* a, double* mi,    \
    ll L) { fd_du_host<double, NJ>(m, q, qd, u, d, a, mi, L, -9.81); }       \
extern "C" void id_du_##NJ(const double* m, const double* q,                \
    const double* qd, const double* qdd, double* d, ll L) {                 \
  id_du_host<double, NJ>(m, q, qd, qdd, d, L, -9.81);                       \
}                                                                           \
extern "C" void minv_##NJ(const double* m, const double* q, double* mi,    \
    ll L, int dense) { minv_host<double, NJ>(m, q, mi, L, dense != 0); }    \
extern "C" void fd_##NJ(const double* m, const double* q,                   \
    const double* qd, const double* u, double* qdd, ll L) {                 \
  fd_host<double, NJ>(m, q, qd, u, qdd, L, -9.81);                          \
}                                                                           \
extern "C" void fbr_##NJ(const double* m, const double* x0,                \
    const double* Ur, const double* Xr, const double* kff, const double* K, \
    const double* lo, const double* hi, double* X, double* U, int N,        \
    ll B, double dt) {                                                      \
  feedback_rollout_host<double, NJ>(m, x0, Ur, Xr, kff, K, lo, hi, X, U, N, \
                                    B, dt, -9.81);                          \
}                                                                           \
extern "C" void rollout_##NJ(const double* m, const double* x0,            \
    const double* U, const double* lo, const double* hi, double* X, int N,  \
    ll B, double dt) {                                                      \
  rollout_host<double, NJ>(m, x0, U, lo, hi, X, N, B, dt, -9.81);           \
}                                                                           \
extern "C" void ls_##NJ(const double* m, const double* x0,                 \
    const double* Ur, const double* Xr, const double* k, const double* K,   \
    const double* al, const double* lo, const double* hi, double* X,        \
    double* U, double* c, int N, ll B, int na, int kind, const double* w,   \
    double dt) {                                                            \
  if (kind == 0)                                                            \
    linesearch_host<double, NJ, EECostW<double, NJ>>(m, x0, Ur, Xr, k, K,   \
        al, lo, hi, X, U, c, N, B, na, dt, -9.81, w, 7);                    \
  else if (kind == 1)                                                       \
    linesearch_host<double, NJ, QuadCostW<double, NJ>>(m, x0, Ur, Xr, k, K, \
        al, lo, hi, X, U, c, N, B, na, dt, -9.81, w, 7 * NJ);               \
  else                                                                      \
    linesearch_host<double, NJ, NoCost<double, NJ>>(m, x0, Ur, Xr, k, K,    \
        al, lo, hi, X, U, nullptr, N, B, na, dt, -9.81, nullptr, 0);        \
}                                                                           \
extern "C" void ricd_##NJ(const double* A, const double* Bm,               \
    const double* lx, const double* lu, const double* lxx,                  \
    const double* luu, const double* lux, int stationary,                   \
    const double* Vx0, const double* Vxx0, double* ks, double* Ks, int N,   \
    ll B, double reg) {                                                     \
  riccati_dense_host<double, NJ>(A, Bm, lx, lu, lxx, luu, lux,              \
                                 stationary != 0, Vx0, Vxx0, ks, Ks, N, B,  \
                                 reg);                                      \
}                                                                           \
extern "C" void ric_##NJ(const double* A, const double* Bm,                \
    const double* lx, const double* lu, const double* Jw,                   \
    const double* Vx0, const double* Vxx0, double* ks, double* Ks, int N,   \
    ll B, int r, double reg, double qd, double ud) {                        \
  riccati_factored_host<double, NJ>(A, Bm, lx, lu, Jw, Vx0, Vxx0, ks, Ks,   \
                                    N, B, r, reg, qd, ud);                  \
}                                                                           \
extern "C" void threads_##NJ(int* out) {                                    \
  out[0] = FDPlan<double, NJ>::LANES;                                       \
  out[1] = IDUPlan<double, NJ>::LANES;                                      \
  out[2] = MinvPlan<double, NJ>::LANES;                                     \
  out[3] = FDPlanQ<double, NJ>::LANES;                                      \
  out[4] = RicPlan<double, NJ>::LANES;                                      \
  out[5] = FDChipPlan<double, NJ>::LANES;                                   \
  out[6] = FDChipPlan<double, NJ>::CL;                                      \
  out[7] = RicChipPlan<double, NJ>::LANES;                                  \
  out[8] = RicChipPlan<double, NJ>::CL;                                     \
  out[9] = fd_on_chip<double, NJ>();                                        \
  out[10] = ric_on_chip<double, NJ, RIC_STATIONARY>();                      \
  out[11] = ric_on_chip<double, NJ, RIC_DENSE>();                           \
}                                                                           \
extern "C" void fdc_##NJ(const double* m, const double* q,                 \
    const double* qd, const double* u, double* d, double* a, double* mi,    \
    ll L, int f32plan) {                                                    \
  if (f32plan)                                                              \
    fd_du_chip_host<double, NJ, float>(m, q, qd, u, d, a, mi, L, -9.81);    \
  else                                                                      \
    fd_du_chip_host<double, NJ, double>(m, q, qd, u, d, a, mi, L, -9.81);   \
}                                                                           \
extern "C" void ricc_##NJ(const double* A, const double* Bm,               \
    const double* lx, const double* lu, const double* lxx,                  \
    const double* luu, const double* lux, int stationary,                   \
    const double* Vx0, const double* Vxx0, double* ks, double* Ks, int N,   \
    ll B, double reg, int f32plan) {                                        \
  const DenseIn<double, NJ, true, 1> st{A, Bm, lx, lu, lxx, luu, lux, B};   \
  const DenseIn<double, NJ, false, 1> dn{A, Bm, lx, lu, lxx, luu, lux, B};  \
  if (stationary && f32plan)                                                \
    riccati_chip_host<double, NJ, true, float>(st, Vx0, Vxx0, ks, Ks, N, B, \
                                               reg);                        \
  else if (stationary)                                                      \
    riccati_chip_host<double, NJ, true, double>(st, Vx0, Vxx0, ks, Ks, N,   \
                                                B, reg);                    \
  else if (f32plan)                                                         \
    riccati_chip_host<double, NJ, false, float>(dn, Vx0, Vxx0, ks, Ks, N,   \
                                                B, reg);                    \
  else                                                                      \
    riccati_chip_host<double, NJ, false, double>(dn, Vx0, Vxx0, ks, Ks, N,  \
                                                 B, reg);                   \
}                                                                           \
extern "C" void idso_tile_##NJ(const double* m, const double* q,           \
    const double* qd, const double* qdd, double* out, ll L) {               \
  idsva_so_plan_host<double, NJ>(m, q, qd, qdd, out, L, -9.81);             \
}                                                                           \
extern "C" void idso_routes_##NJ(int* out) {                                \
  out[0] = idso_route<float, NJ>();                                         \
  out[1] = idso_route<double, NJ>();                                        \
  out[2] = IDSOBandPlan<float, NJ>::BANDS;                                  \
  out[3] = IDSOBandPlan<double, NJ>::BANDS;                                 \
  out[4] = IDSOTilePlan<float, NJ>::G;                                      \
  out[5] = IDSOTilePlan<float, NJ>::LANES;                                  \
  out[6] = IDSOTilePlan<double, NJ>::G;                                     \
  out[7] = IDSOTilePlan<double, NJ>::LANES;                                 \
}
HOST(34)
HOST(52)
"""

# the kernel cases (tests/test_torch_kernels.py: KERNELS' names) whose
# instances changed, with fd (its arguments are fd_du's)
CASES = ("fd_du", "id_du", "minv", "minv_upper", "fd", "riccati_factored",
         "riccati", "riccati_stacked", "rollout", "feedback_rollout",
         "linesearch_rollout", "linesearch_quad", "linesearch_nocost")


def _cxx():
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    return cxx


_plan_rows = {}


def plan_rows(tmp_path):
    """The PLANS program's rows (a g++ build of the plan constants alone),
    once: name, dtype, joints, G, threads, bytes a block, device-memory
    bytes a block, blocks a problem."""
    if not _plan_rows:
        cxx = _cxx()
        (tmp_path / "plans.cpp").write_text(PLANS)
        exe = tmp_path / "plans"
        subprocess.run([cxx, "-O0", "-std=c++17", "-I", str(CSRC),
                        str(tmp_path / "plans.cpp"), "-o", str(exe)],
                       check=True, capture_output=True, timeout=300)
        out = subprocess.run([str(exe)], check=True, capture_output=True,
                             text=True, timeout=60).stdout.split()
        for i in range(0, len(out), 8):
            name, dt, *nums = out[i:i + 8]
            _plan_rows[name, dt, int(nums[0])] = tuple(map(int, nums[1:]))
    return _plan_rows


def test_plans_hold_a_knot_or_take_device_memory_from_29_to_64(tmp_path):
    """Each plan at 29-64 joints in both dtypes: a knot in shared memory,
    or (id_du, minv, fd, riccati_factored) the device-memory route, or
    (fd_du, the dense riccati) one knot or problem on chip, within a
    block's shared memory every way; the rollouts' blocks fit with their
    tiles in device memory where they must."""
    rows = plan_rows(tmp_path)
    assert len(rows) == 16 * 2 * 36
    ws_route = {"id_du", "minv", "fd", "riccati_factored"}
    seen_ws = set()
    for (name, dt, nj), (g, lanes, nbytes, ws, cl) in rows.items():
        where = f"{name} {dt} at {nj} joints"
        assert 0 < nbytes <= SMEM_LIMIT, where
        assert 0 < lanes <= 512 * cl, where
        if g == 0:
            assert name in ws_route and ws > 0, where
            seen_ws.add(name)
        if name in ("fd_du", "id_du"):   # a thread a column of a pass
            assert lanes >= nj, where
        if name in ("fd_du", "riccati", "riccati_stacked"):
            assert ws == 0 and g >= 1, where
        if name in ("linesearch", "feedback_rollout") and ws:
            assert dt == "float64" and g >= 1, where
            seen_ws.add(name)
    assert seen_ws == ws_route | {"linesearch", "feedback_rollout"}


# where fd_du and the dense riccati (stationary and stacked) keep one knot
# or problem on chip, {name: (float32, float64)}: from 29 joints
# (csrc/warp.cuh: CHIP_FROM), every count above the 28 their shared-memory
# plans were built for
ON_CHIP_FROM = {"fd_du": (29, 29), "riccati": (29, 29),
                "riccati_stacked": (29, 29)}
# the most joints whose problem one block holds in float32 (fd_du: all)
ONE_BLOCK_F32 = {"fd_du": 64, "riccati": 54, "riccati_stacked": 54}


@pytest.mark.parametrize("name", sorted(ON_CHIP_FROM))
def test_onchip_plans_fit_a_block_or_cluster_from_29_to_64(tmp_path, name):
    """fd_du's and the dense riccati's instances at 29-64 joints in both
    dtypes: from 29 joints one knot or problem sits on chip in a block, or
    in a cluster of at most 4 blocks, each
    within the 232,448 bytes a block may use, with no device memory; one
    block holds it in float32 up to 64 joints (fd_du) and 54 (riccati); a
    block of 256 threads a cluster's rank, 512 alone (riccati)."""
    rows = plan_rows(tmp_path)
    for d, dt in enumerate(("float32", "float64")):
        for nj in range(29, 65):
            g, lanes, nbytes, ws, cl = rows[name, dt, nj]
            where = f"{name} {dt} at {nj} joints"
            if nj < ON_CHIP_FROM[name][d]:
                assert cl == 1 and lanes <= 512, where
                continue
            assert g == 1 and ws == 0 and 0 < nbytes <= SMEM_LIMIT, where
            assert cl in (1, 2, 4), where
            assert lanes == 256 * cl * (2 if name != "fd_du" and cl == 1
                                        else 1), where
            if dt == "float32":
                assert (cl == 1) == (nj <= ONE_BLOCK_F32[name]), where


@pytest.fixture(scope="module")
def ws_lib(tmp_path_factory):
    cxx = _cxx()
    d = tmp_path_factory.mktemp("ws_kernels")
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libws.so"
    t = time.perf_counter()
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I",
                    str(CSRC), str(d / "harness.cpp"), "-o", str(lib)],
                   check=True, capture_output=True, timeout=600)
    seconds = time.perf_counter() - t
    print(f"host build of the changed kernels at 34 and 52 joints: "
          f"{seconds:.1f} s of g++")
    return ctypes.CDLL(str(lib))


_inputs = {}


def inputs(nj):
    """Each case's float64 arguments on atlas with nj joints (the solver's
    first iteration, as tests/test_torch_kernels.py makes them), once."""
    if nj not in _inputs:
        k = HANDS[nj]
        m = build_model(parse_urdf(atlas_hands_urdf(k),
                                   name=atlas_hands_name(k)),
                        dtype=torch.float64, device="cpu")
        tk.DT[m.name] = DT
        args = tk.path_inputs(m, 4, 3, seed=3)
        args["fd"] = args["fd_du"]
        _inputs[nj] = m, args
    return _inputs[nj]


def test_ws_instances_run_on_more_than_a_warp(ws_lib):
    """At 52 joints in float64 the device-memory instances run one knot a
    block with WS_LANES threads (id_du's joints, more than a warp's 32,
    each get a thread; minv, fd, riccati_factored); fd_du and the dense
    riccati run on chip instead: one knot or problem a cluster of 2 blocks
    of 256 threads (fd_du's chunk columns a thread each, the other threads
    folding df/du), and the shared-memory plan they replace would hold
    none (WS_LANES)."""
    out = (ctypes.c_int * 12)()
    ws_lib.threads_52(out)
    assert list(out[:5]) == [128] * 5
    assert list(out[5:]) == [512, 2, 512, 2, 1, 1, 1]


@pytest.mark.parametrize("nj", sorted(HANDS))
@pytest.mark.parametrize("name", CASES)
def test_host_block_code_above_28_joints_matches_plain(ws_lib, name, nj):
    m, args = inputs(nj)
    got = tk._host_run(ws_lib, name, args[name])
    want = tk._outs(tk.WRAPPERS[name][1](*args[name]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.isfinite(w).all()
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= TOL * scale, name
    if name == "minv_upper":   # exact zeros below the diagonal
        assert not got[0].permute(2, 0, 1).tril(-1).any()


ONCHIP = ("fd_du", "riccati", "riccati_stacked")


def _onchip_run(lib, name, args, nj, f32plan):
    """fd_du's or the dense riccati's on-chip program (FDChipPlan,
    RicChipPlan) with the plan of float32 (f32plan) or float64, run in
    float64 on the wrapper's arguments."""
    if name == "fd_du":
        m, q, qd, u, _ = args
        n, L = q.shape
        out = (torch.empty(n, 2 * n, L, dtype=q.dtype),
               torch.empty(n, L, dtype=q.dtype),
               torch.empty(n, n, L, dtype=q.dtype))
        getattr(lib, f"fdc_{nj}")(
            *map(tk._p, (tk.build.model_buffer(m), q, qd, u) + out),
            ctypes.c_longlong(L), ctypes.c_int(f32plan))
        return out
    A, Bm, lx, lu, lxx, luu, lux, Vx0, Vxx0, reg = args
    N, nx, n, B = Bm.shape
    out = (torch.empty(N, n, B, dtype=A.dtype),
           torch.empty(N, n, nx, B, dtype=A.dtype))
    getattr(lib, f"ricc_{nj}")(
        *map(tk._p, (A, Bm, lx, lu, lxx, luu, lux)),
        ctypes.c_int(int(lxx.ndim == 3)), *map(tk._p, (Vx0, Vxx0) + out),
        ctypes.c_int(N), ctypes.c_longlong(B), ctypes.c_double(reg),
        ctypes.c_int(f32plan))
    return out


def _held(got, want, what):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.isfinite(w).all()
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= TOL * scale, what


@pytest.mark.parametrize("nj", sorted(HANDS))
@pytest.mark.parametrize("plan", ("float32", "float64"))
@pytest.mark.parametrize("name", ONCHIP)
def test_host_onchip_programs_match_plain(ws_lib, name, plan, nj):
    """fd_du's on-chip program (chunks of C gradient columns, df/du folded
    chunk by chunk) and the dense riccati's (slabs of [Vxx A | Vxx B]
    folded into the Q blocks) with each dtype's plan (its chunk or slab
    width, threads and cluster) against the plain versions in float64,
    within 1e-9 of each output's scale."""
    m, args = inputs(nj)
    got = _onchip_run(ws_lib, name, args[name], nj, plan == "float32")
    _held(got, tk._outs(tk.WRAPPERS[name][1](*args[name])), name)


@pytest.mark.parametrize("nj", sorted(HANDS))
@pytest.mark.parametrize("name", ("fd_du", "riccati_stacked"))
def test_host_onchip_phases_write_disjoint_entries(ws_lib, name, nj):
    """The on-chip programs with the float64 plan (at 52 joints a cluster
    of 2 blocks for both) on one knot or problem of two knots, with the
    race check on: no entry of the state written by two threads of one
    phase, the same bits with each phase's threads in reverse order, and
    within 1e-9 of the plain version's scale."""
    m, args = inputs(nj)
    if name == "fd_du":
        mm, q, qd, u, gr = args[name]
        case = (mm, q[:, :1].contiguous(), qd[:, :1].contiguous(),
                u[:, :1].contiguous(), gr)
    else:
        *knots, Vx0, Vxx0, reg = args[name]   # knots: a leading N axis
        case = (*(a[:2, ..., :1].contiguous() for a in knots),
                Vx0[:, :1].contiguous(), Vxx0[..., :1].contiguous(), reg)
    outs = []
    ws_lib.race_watch(1)
    try:
        for reverse in (0, 1):
            ws_lib.race_reverse(reverse)
            ws_lib.race_reset()
            outs.append(_onchip_run(ws_lib, name, case, nj, 0))
            assert ws_lib.race_count() == 0
    finally:
        ws_lib.race_reverse(0)
        ws_lib.race_watch(0)
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    _held(outs[0], tk._outs(tk.WRAPPERS[name][1](*case)), name)


# idsva_so's routes (csrc/warp.cuh: idso_route) where the whole tile does
# not fit: {joints: (float32, float64)}, and the bands of each dtype's band
# plan (0: not even one band fits)
IDSO_ROUTES = {34: ("device", "device"), 52: ("device", "device")}
IDSO_BANDS = {34: (4, 11), 52: (52, 0)}


@pytest.mark.parametrize("nj", sorted(HANDS))
def test_idsva_so_routes_above_28_joints(ws_lib, nj):
    """Above 28 joints both dtypes take the device tile, where the bands
    would be 4 | 11 (float32 | float64) at 34 joints and 52 | none (not one
    band fits) at 52: 4 knots of 128 threads a block in float32, 1 of 256
    in float64 at 52."""
    out = (ctypes.c_int * 8)()
    getattr(ws_lib, f"idso_routes_{nj}")(out)
    routes = tuple(tk.K.IDSO_ROUTES[r] for r in out[:2])
    assert routes == IDSO_ROUTES[nj]
    assert tuple(out[2:4]) == IDSO_BANDS[nj]
    if nj == 52:
        assert list(out[4:8]) == [4, 128, 1, 256]


# the lanes of the race-checked device tile: a ragged block of the float64
# plan's 2 knots at 34 joints; one knot at 52, whose race check and plain
# reference take seconds a lane
TILE_LANES = {34: 3, 52: 1}


@pytest.mark.parametrize("nj", sorted(HANDS))
def test_host_idsva_so_device_tile_matches_plain(ws_lib, nj):
    """idsva_so's device-memory tile (the float64 plan: G knots a block,
    each accumulating in its lane of the zeroed output, on the robot's
    lists from so_lists_host) on TILE_LANES lanes: no entry of the output
    or of a knot's shared state touched by two threads of one phase, the
    same output with each phase's threads in reverse order, and within
    1e-9 of idsva_so_plain's scale."""
    m, args = inputs(nj)
    _, q, qd, u, _ = args["fd_du"]
    L = TILE_LANES[nj]
    q, qd = q[:, :L].contiguous(), qd[:, :L].contiguous()
    qdd = torch.as_tensor(np.random.default_rng(nj).uniform(-1, 1, q.shape))
    n = q.shape[0]
    outs = []
    ws_lib.race_watch(1)
    for reverse in (0, 1):
        ws_lib.race_reverse(reverse)
        ws_lib.race_reset()
        out = torch.full((4, n, n, n, L), float("nan"), dtype=torch.float64)
        getattr(ws_lib, f"idso_tile_{nj}")(
            *map(tk._p, (tk.build.model_buffer(m), q, qd, qdd, out)),
            ctypes.c_longlong(L))
        assert ws_lib.race_count() == 0
        outs.append(out)
    ws_lib.race_reverse(0)
    ws_lib.race_watch(0)
    assert torch.equal(outs[0], outs[1])
    want = tk.K.idsva_so_plain(m, q, qd, qdd, -9.81)
    scale = max(1.0, float(want.abs().max()))
    assert float((outs[0] - want).abs().max()) <= TOL * scale


@pytest.mark.parametrize("nj", sorted(HANDS))
def test_operation_counts_of_the_second_order_above_28_joints(nj):
    """utils/opcount.py counts idsva_so at 34 and 52 joints and fdsva_so at
    34 (its count at 52 runs the same code over a larger tree, for
    seconds): the counted lane of the card's route computes what the plain
    version does; the need is at most what runs; both dtypes run idsva_so's
    device tile, each knot's program once, so they execute the same;
    fdsva_so executes the composed route, more than fd_du and idsva_so
    together."""
    m, args = inputs(nj)
    _, q, qd, u, _ = args["fd_du"]
    x = [a[:, 0].numpy() for a in (q, qd, u)]
    ops = lambda k, dt, ex: tk.opcount.ops_per_lane(
        k, m.to(dtype=dt), executed=ex)
    kernels = ("idsva_so", "fdsva_so") if nj == 34 else ("idsva_so",)
    ran = {k: ops(k, torch.float64, True) for k in kernels + ("fd_du",)}
    for k in kernels:
        assert 0 < ops(k, torch.float64, False) <= ran[k]
        want = getattr(tk.K, k + "_plain")(
            m, *(torch.as_tensor(v)[:, None] for v in x), -9.81)[..., 0]
        got = tk.opcount.so_lane_values(k, m, *x, executed=True)
        scale = max(1.0, float(want.abs().max()))
        assert float(np.abs(got - want.numpy()).max()) <= TOL * scale
    if "fdsva_so" in ran:
        assert ran["fdsva_so"] > ran["fd_du"] + ran["idsva_so"]
    assert ops("idsva_so", torch.float32, True) == ran["idsva_so"]
