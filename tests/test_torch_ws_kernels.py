"""The kernels above 28 joints on the host: their block plans, and the
block code of the instances that the device-memory routes changed or
added.

* Every block plan of every kernel but the second-order pair, at every
  joint count from 29 to 64 in float32 and float64, holds a knot (problem,
  rollout) in a block's shared memory or takes the device-memory route
  (csrc/warp.cuh: WsPlan; the rollouts' tiles: TILES_WS), and stays within
  the 232,448 bytes a block may use: a g++ build of the plan constants
  alone (csrc/warp.cuh, csrc/sweep_warp.cuh).
* A host C++ build of the kernels whose plans changed (fd_du, id_du, minv,
  fd, the three Riccati instances, the rollouts and the line search; their
  device-memory instances run one knot a block with csrc/warp.cuh:
  WS_LANES threads), at 34 and 52 joints (atlas with grippers and with
  hands, tests/torch_big_robots.py), driven over a few lanes through
  ctypes as tests/test_torch_kernels.py drives its harness, against the
  plain PyTorch versions in float64 (1e-9 of each output's scale).
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
// block, and whether the instance has a device-memory route
template <class P>
void row(const char* name, const char* dt, int nj) {
  std::printf("%s %s %d %d %d %lld %lld\n", name, dt, nj, (int)P::G,
              (int)P::LANES, (long long)P::BYTES,
              (long long)PlanWs<P>::value);
}
template <typename T, int NJ>
void plans(const char* dt) {
  row<FDPlan<T, NJ>>("fd_du", dt, NJ);
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
  row<RicPlan<T, NJ, RIC_STATIONARY>>("riccati", dt, NJ);
  row<RicPlan<T, NJ, RIC_DENSE>>("riccati_stacked", dt, NJ);
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


def test_plans_hold_a_knot_or_take_device_memory_from_29_to_64(tmp_path):
    """Each plan at 29-64 joints in both dtypes: a knot in shared memory, or
    (fd_du, id_du, minv, fd, the Riccati sweeps) the device-memory route,
    within a block's shared memory either way; the rollouts' blocks fit
    with their tiles in device memory where they must."""
    cxx = _cxx()
    (tmp_path / "plans.cpp").write_text(PLANS)
    exe = tmp_path / "plans"
    subprocess.run([cxx, "-O0", "-std=c++17", "-I", str(CSRC),
                    str(tmp_path / "plans.cpp"), "-o", str(exe)], check=True,
                   capture_output=True, timeout=300)
    rows = subprocess.run([str(exe)], check=True, capture_output=True,
                          text=True, timeout=60).stdout.split()
    rows = [rows[i:i + 7] for i in range(0, len(rows), 7)]
    assert len(rows) == 16 * 2 * 36
    ws_route = {"fd_du", "id_du", "minv", "fd", "riccati_factored", "riccati",
                "riccati_stacked"}
    seen_ws = set()
    for name, dt, nj, g, lanes, nbytes, ws in rows:
        nj, g, lanes, nbytes, ws = map(int, (nj, g, lanes, nbytes, ws))
        where = f"{name} {dt} at {nj} joints"
        assert 0 < nbytes <= SMEM_LIMIT, where
        assert 0 < lanes <= 512, where
        if g == 0:
            assert name in ws_route and ws > 0, where
            seen_ws.add(name)
        if name in ("fd_du", "id_du"):   # a thread a column of a pass
            assert lanes >= nj, where
        if name in ("linesearch", "feedback_rollout") and ws:
            assert dt == "float64" and g >= 1, where
            seen_ws.add(name)
    assert seen_ws == ws_route | {"linesearch", "feedback_rollout"}


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
    block with WS_LANES threads: fd_du's columns and id_du's joints, more
    than a warp's 32, each get a thread."""
    out = (ctypes.c_int * 5)()
    ws_lib.threads_52(out)
    assert list(out) == [128] * 5


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
