"""The port's kernel contract: imports, dispatch, and each CUDA kernel
against its plain PyTorch version.

* Importing the port (and ``chip_smoke.py``) pulls in neither jax nor the
  JAX package.
* CPU tensors run the plain versions; launch counters stay at 0.
* The kernels' per-lane code (``csrc/*.cu``) is ``__host__ __device__``: a
  host C++ build of it, driven over every lane, must match the plain
  versions in float64 (1e-9). Skipped without a host C++ compiler.
* On a CUDA device (tests marked ``cuda``), each kernel must match its plain
  version on the same inputs in float64 (1e-9). Run them there with
  ``python -m pytest --noconftest -q tests/test_torch_kernels.py``.

This file imports no jax, so it also runs where jax is not installed.
"""

import copy
import ctypes
import dataclasses
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gridcodegenerator_tpu_torch.api import GRiD
from gridcodegenerator_tpu_torch.models.model import build_model
from gridcodegenerator_tpu_torch.models.zoo import load_robot, pendulum_urdf
from gridcodegenerator_tpu_torch.topology.urdf import parse_urdf
from gridcodegenerator_tpu_torch.ops import eepose
from gridcodegenerator_tpu_torch.ops.cuda import build
from gridcodegenerator_tpu_torch.ops.cuda import kernels as K
from gridcodegenerator_tpu_torch.ops.cuda import sweeps as S
from gridcodegenerator_tpu_torch.trajopt.cost import EEReachCost, QuadCost
from gridcodegenerator_tpu_torch.trajopt.ilqr import (ILQRConfig, make_ilqr,
                                                      resolve_control_bounds)
from gridcodegenerator_tpu_torch.trajopt.sqp import SQPConfig, make_sqp
from gridcodegenerator_tpu_torch.utils import opcount
from torch_big_robots import atlas_hands_name, atlas_hands_urdf

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-9
# kernel cases: each kernel, plus the bias form of rnea and the upper factor
# of minv, which launch the rnea and minv kernels
KERNELS = ("fd_du", "rollout", "riccati_factored", "linesearch_rollout",
           "rnea", "rnea_bias", "id_du", "aba", "minv", "minv_upper",
           "idsva_so", "fdsva_so", "riccati", "riccati_stacked",
           "linesearch_quad", "feedback_rollout")
# the GRiD API's kernel cases; the _targets cases run the EE kernels on
# some of the robot's EEs (GRiD(ee_targets=...))
GRID_CASES = ("rnea", "rnea_bias", "id_du", "aba", "minv", "minv_upper",
              "fd_du", "fd", "crba", "eepos", "eepos_targets", "deepos",
              "deepos_targets", "d2eepos", "d2eepos_targets")
KERNEL_OF = {"rnea_bias": "rnea", "minv_upper": "minv",
             "eepos_targets": "eepos", "deepos_targets": "deepos",
             "d2eepos_targets": "d2eepos",
             "riccati_stacked": "riccati",
             "linesearch_quad": "linesearch_rollout"}
# EE targets per robot (pendulum2 has no fixed frames to name); gym_ant's
# EEs are welded to the base, so their chains are empty
TARGETS = {"pendulum2": None, "pendulum4": None, "mixed5": None,
           "pendulum20": None, "iiwa": ["ee_fixed"],
           "hyq": ["lf_foot_fixed", "rh_foot_fixed"],
           "gym_ant": ["front_left_leg_weld", "back_leg_weld"],
           "dm_quadruped": ["toe_front_left_weld", "toe_back_right_weld"],
           "gym_humanoid": ["right_foot_weld"], "atlas": ["l_sole_fixed"]}
# the zoo's joint counts and a 20-joint chain: 2, 4 and 20 (chains), 5 (a
# chain with prismatic and skew-axis joints), 7, 12 (branched, 4 EEs), 8
# (EEs on the base), 16 (branched, 4 EEs), 17 and 28 (humanoids, 2 EEs).
# At 20 joints idsva_so holds a knot's whole tile in float32 and runs in
# bands in float64, and fdsva_so is fused in float32 and composed in
# float64; at 28 both dtypes take bands and the composed route.
ROBOTS = ("pendulum2", "pendulum4", "mixed5", "iiwa", "hyq", "gym_ant",
          "dm_quadruped", "gym_humanoid", "pendulum20", "atlas")
# the joint counts of the host harness (HOST(n))
HOST_JOINTS = (2, 4, 5, 7, 8, 12, 16, 17, 20, 28)


def topo(robot):
    """The zoo's robot, or "pendulum20": models/zoo.py:pendulum_urdf(20)."""
    if robot == "pendulum20":
        return parse_urdf(pendulum_urdf(20), name="pendulum20")
    return load_robot(robot)

# the sweeps' time step: dm_quadruped's joint damping (30) on its light links
# makes semi-implicit Euler diverge at 0.01 (in the JAX reference too), and
# so does gym_humanoid's step (test_torch_mpc.py), so their sweeps run at a
# step where the rollouts stay bounded
# (the 20-joint chain's line-search rollouts leave every bound at 0.01:
# states 1.2e7, costs 1.4e12)
DT = {"dm_quadruped": 0.002, "gym_humanoid": 0.002, "pendulum20": 0.002,
      "atlas_grippers64": 0.002}


def path_inputs(model, N, B, seed):
    """Each kernel's arguments as the solver's first iteration makes them
    (plain ops), from random initial states and controls."""
    n, dev = model.n, model.device
    dt = DT.get(model.name, 0.01)
    goal = eepose.eepos(model, torch.full((n, 1), 0.5, dtype=model.dtype,
                                          device=dev))[:3, 0]
    cost = EEReachCost(model=model, goal_xyz=goal, w_pos=0.5, w_pos_f=200.0)
    cfg = ILQRConfig(N=N, dt=dt, iters=1, use_kernels=False)
    _, parts = make_ilqr(model, cost, cfg, expose_parts=True)
    rng = np.random.default_rng(seed)
    x0 = torch.as_tensor(rng.uniform(-0.3, 0.3, (2 * n, B)),
                         dtype=model.dtype, device=dev)
    U = torch.as_tensor(rng.uniform(-4, 4, (N, n, B)), dtype=model.dtype,
                        device=dev)
    X = parts["rollout"](x0, U)
    fold = lambda Z: Z.transpose(0, 1).reshape(Z.shape[1], -1)
    A, Bm = parts["linearize"](X[:N], U)
    _, Vx0, Vxx0 = cost.terminal_expansion(X[N])
    Jw, lx, lu = cost.gn_stage_factor(fold(X[:N]), fold(U), 0)
    ric = (A, Bm, lx.contiguous(), lu.contiguous(), Jw.contiguous(),
           Vx0.contiguous(), Vxx0.contiguous(), cfg.reg,
           *cost.gn_factor_diags)
    ks, Ks = S.riccati_factored_plain(*ric)
    lo, hi = resolve_control_bounds(model, cfg)
    if lo is None:   # give every robot an active per-dof clamp
        lo = torch.full((n, 1), -3.0, dtype=model.dtype, device=dev)
        hi = torch.full((n, 1), 3.5, dtype=model.dtype, device=dev)
    al = torch.as_tensor(rng.uniform(0.05, 1.0, (4, B)), dtype=model.dtype,
                         device=dev)
    q, qd, u = fold(X[:N, :n]), fold(X[:N, n:]), fold(U)
    # dense Riccati curvature: symmetric lxx, well-conditioned SPD luu, any
    # lux, per knot (stacked) and one block (stationary)
    nx = 2 * n

    def rand(*shape):
        return torch.as_tensor(rng.uniform(-1, 1, shape), dtype=model.dtype,
                               device=dev)
    Mx, Mu = rand(N, nx, nx, B), rand(N, n, n, B)
    lxx = torch.einsum("tikb,tjkb->tijb", Mx, Mx) / nx
    luu = (torch.einsum("tikb,tjkb->tijb", Mu, Mu) / n
           + torch.eye(n, dtype=model.dtype, device=dev)[:, :, None])
    lux = 0.1 * rand(N, n, nx, B)
    dense = (A, Bm, rand(N, nx, B), rand(N, n, B))
    tail = (Vx0.contiguous(), Vxx0.contiguous(), cfg.reg)
    quad = QuadCost(Q=torch.as_tensor(rng.uniform(0.05, 1, nx)),
                    R=torch.as_tensor(rng.uniform(1e-3, 1e-2, n)),
                    Qf=torch.as_tensor(rng.uniform(10, 100, nx)),
                    x_goal=torch.as_tensor(rng.uniform(-0.5, 0.5, nx)))
    return {
        "fd_du": (model, q, qd, u, -9.81),
        "feedback_rollout": (model, X[0].contiguous(), U, X[:N].contiguous(),
                             0.5 * ks, Ks, dt, -9.81, lo, hi),
        "rnea": (model, q, qd, u, -9.81),   # u as qdd
        "rnea_bias": (model, q, qd, None, -9.81),
        "id_du": (model, q, qd, u, -9.81),
        "aba": (model, q, qd, u, -9.81),
        "minv": (model, q, True),
        "minv_upper": (model, q, False),
        "rollout": (model, x0, U, dt, -9.81, lo, hi),
        "riccati_factored": ric,
        "linesearch_rollout": (model, X[0].contiguous(), U,
                               X[:N].contiguous(), ks, Ks, al, dt, -9.81,
                               lo, hi, cost),
        "linesearch_quad": (model, X[0].contiguous(), U, X[:N].contiguous(),
                            ks, Ks, al, dt, -9.81, lo, hi, quad),
        "linesearch_nocost": (model, X[0].contiguous(), U, X[:N].contiguous(),
                              ks, Ks, al, dt, -9.81, lo, hi, None),
        "idsva_so": (model, q, qd, u, -9.81),   # u as qdd
        "fdsva_so": (model, q, qd, u, -9.81),
        "riccati": dense + (lxx[0].contiguous(), luu[0].contiguous(),
                            lux[0].contiguous()) + tail,
        "riccati_stacked": dense + tuple(c.contiguous()
                                         for c in (lxx, luu, lux)) + tail,
    }


def grid_inputs(model, robot, L, seed):
    """Each GRiD kernel case on (n, L) inputs ~ U(-1, 1)."""
    rng = np.random.default_rng(seed)
    q, qd, x = (torch.as_tensor(rng.uniform(-1, 1, (model.n, L)),
                                dtype=model.dtype, device=model.device)
                for _ in range(3))
    tg = TARGETS[robot]
    return {"rnea": (model, q, qd, x, -9.81),
            "rnea_bias": (model, q, qd, None, -9.81),
            "id_du": (model, q, qd, x, -9.81),
            "aba": (model, q, qd, x, -9.81),
            "minv": (model, q, True),
            "minv_upper": (model, q, False),
            "fd_du": (model, q, qd, x, -9.81),
            "fd": (model, q, qd, x, -9.81),
            "crba": (model, q),
            "eepos": (model, q),
            "eepos_targets": (model, q, tg),
            "deepos": (model, q),
            "deepos_targets": (model, q, tg),
            "d2eepos": (model, q),
            "d2eepos_targets": (model, q, tg)}


def grid_params(robots):
    return [(case, robot) for robot in robots for case in GRID_CASES
            if TARGETS[robot] or not case.endswith("_targets")]


WRAPPERS = {"fd_du": (K.fd_du, K.fd_du_plain),
            "rollout": (S.rollout, S.rollout_plain),
            "riccati_factored": (S.riccati_factored,
                                 S.riccati_factored_plain),
            "linesearch_rollout": (S.linesearch_rollout,
                                   S.linesearch_rollout_plain),
            "rnea": (K.rnea, K.rnea_plain),
            "rnea_bias": (K.rnea, K.rnea_plain),
            "id_du": (K.id_du, K.id_du_plain),
            "aba": (K.aba, K.aba_plain),
            "minv": (K.minv, K.minv_plain),
            "minv_upper": (K.minv, K.minv_plain),
            "fd": (K.fd, K.fd_plain),
            "crba": (K.crba, K.crba_plain),
            "eepos": (K.eepos, K.eepos_plain),
            "eepos_targets": (K.eepos, K.eepos_plain),
            "deepos": (K.deepos, K.deepos_plain),
            "deepos_targets": (K.deepos, K.deepos_plain),
            "d2eepos": (K.d2eepos, K.d2eepos_plain),
            "d2eepos_targets": (K.d2eepos, K.d2eepos_plain),
            "feedback_rollout": (S.feedback_rollout,
                                 S.feedback_rollout_plain),
            "idsva_so": (K.idsva_so, K.idsva_so_plain),
            "fdsva_so": (K.fdsva_so, K.fdsva_so_plain),
            "riccati": (S.riccati, S.riccati_plain),
            "riccati_stacked": (S.riccati, S.riccati_plain),
            "linesearch_quad": (S.linesearch_rollout,
                                S.linesearch_rollout_plain),
            "linesearch_nocost": (S.linesearch_rollout,
                                  S.linesearch_rollout_plain)}


def _outs(o):
    return tuple(t for t in (o if isinstance(o, tuple) else (o,))
                 if t is not None)


def _max_err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


# The robots of the libraries built at first use are held, as the card
# tests hold every robot, within TOL of each output's scale max(1,
# max|ref|): the 20-joint chain's Minv amplifies rounding (its fdsva_so
# reaches 919 at path_inputs' states, and the host block code and the plain
# version part by 6e-12 of that).
SCALED = {"pendulum4", "mixed5", "pendulum20"}


def tol(robot, ref):
    if robot not in SCALED:
        return TOL
    return TOL * max(1.0, max(float(r.abs().max()) for r in ref))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import gridcodegenerator_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.split('.')[0] == 'gridcodegenerator_tpu']\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


@pytest.mark.parametrize("name", KERNELS)
def test_cpu_tensors_take_the_plain_version(name):
    m = build_model(load_robot("pendulum2"), dtype=torch.float64, device="cpu")
    args = path_inputs(m, 4, 3, seed=0)[name]
    build.reset_counters()
    wrapper, plain = WRAPPERS[name]
    got = _outs(wrapper(*args))
    assert build.PLAIN_CALLS[KERNEL_OF.get(name, name)] == 1
    assert not build.LAUNCHES
    want = _outs(plain(*args))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("case", GRID_CASES)
def test_cpu_tensors_take_the_plain_version_grid(case):
    m = build_model(load_robot("hyq"), dtype=torch.float64, device="cpu")
    args = grid_inputs(m, "hyq", 3, seed=0)[case]
    build.reset_counters()
    wrapper, plain = WRAPPERS[case]
    got = _outs(wrapper(*args))
    assert dict(build.PLAIN_CALLS) == {KERNEL_OF.get(case, case): 1}
    assert not build.LAUNCHES
    want = _outs(plain(*args))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_kernel_key_refuses_what_the_build_does_not_cover():
    x = torch.zeros(3, dtype=torch.float64)
    fl = build_model(load_robot("iiwa_floating"), dtype=torch.float64, device="cpu")
    with pytest.raises(NotImplementedError):
        build.kernel_key(fl, x, "t")
    pend29 = build_model(parse_urdf(pendulum_urdf(29), name="pendulum29"),
                         dtype=torch.float64, device="cpu")
    assert build.kernel_key(pend29, x, "t") == (1, 29)
    pend65 = build_model(parse_urdf(pendulum_urdf(65), name="pendulum65"),
                         dtype=torch.float64, device="cpu")
    with pytest.raises(NotImplementedError, match="65 joints"):
        build.kernel_key(pend65, x, "t")
    hyq = build_model(load_robot("hyq"), dtype=torch.float64, device="cpu")
    assert build.kernel_key(hyq, x, "t") == (1, 12)
    iiwa = build_model(load_robot("iiwa"), dtype=torch.float64, device="cpu")
    assert build.kernel_key(iiwa, x, "t") == (1, 7)
    with pytest.raises(ValueError):   # model and inputs disagree on dtype
        build.kernel_key(iiwa, x.float(), "t")
    with pytest.raises(NotImplementedError):
        build.kernel_key(iiwa.to(dtype=torch.float16), x.half(), "t")


@pytest.mark.parametrize("nj", [1, 4, 5, 20, 28, 29, 64, 65])
def test_kernel_key_takes_every_count_from_1_to_28(monkeypatch, nj):
    """A chain of 1 to 64 joints (build.MAX_JOINTS; 28 before the
    device-memory routes) has a kernel library, built at its first use; 65
    raises with the reason, before any nvcc."""
    ran = []
    monkeypatch.setattr(build, "build", lambda *a, **k: ran.append(a))
    monkeypatch.setattr(build, "_nvcc", lambda: ran.append("nvcc"))
    m = build_model(parse_urdf(pendulum_urdf(nj), name=f"pendulum{nj}"),
                    dtype=torch.float32, device="cpu")
    x = torch.zeros(3, dtype=torch.float32)
    if nj <= build.MAX_JOINTS:
        assert build.kernel_key(m, x, "t") == (0, nj)
        S._check_riccati_key("t", nj, torch.float32)
    else:
        for check in (lambda: build.kernel_key(m, x, "t"),
                      lambda: S._check_riccati_key("t", nj, torch.float32),
                      lambda: build.lib(nj)):
            with pytest.raises(NotImplementedError,
                               match=f"{nj} joints .1 to 64: the kernels"):
                check()
    assert not ran


def test_fits_refuses_a_plan_that_holds_no_knot(monkeypatch):
    """build.fits reads an instance's plan once and raises, with the bytes
    one knot needs, where it holds none (fdsva_so's fused kernel above 22
    joints in float32 takes the composed route instead); a plan that holds
    one passes."""
    asked = []

    def info(what, nj, dtype):
        asked.append((what, nj, dtype))
        g = 0 if nj == 28 and what in ("idsva_so", "fdsva_so") else 2
        return {"knots_per_block": g, "smem_bytes_per_block": 412512}
    monkeypatch.setattr(build, "warp_kernel_info", info)
    monkeypatch.setattr(build, "_plans", {})
    build.fits("fd_du", 28, torch.float32)
    build.fits("fd_du", 28, torch.float32)
    with pytest.raises(RuntimeError, match="412512 B of shared memory"):
        build.fits("idsva_so", 28, torch.float32)
    with pytest.raises(RuntimeError, match="^fdsva_so: one 28-joint"):
        build.fits("fdsva_so", 28, torch.float64)
    assert asked == [("fd_du", 28, torch.float32),
                     ("idsva_so", 28, torch.float32),
                     ("fdsva_so", 28, torch.float64)]


def test_model_buffer_layout():
    m = build_model(load_robot("iiwa"), dtype=torch.float64, device="cpu")
    buf = build.model_buffer(m)
    n = m.n
    assert buf.numel() == 36 * n * 2 + n + 16 * n + 16 + 4 * n + n * n
    off = 36 * n * 2 + n + 16 * n
    np.testing.assert_array_equal(buf[off:off + 16].reshape(4, 4).numpy(),
                                  m.Tfixed[0].numpy())
    assert buf[off + 16:off + 16 + n].tolist() == list(m.parent)
    assert build.model_buffer(m) is buf


def test_ee_buffer_layout():
    m = build_model(load_robot("hyq"), dtype=torch.float64, device="cpu")
    buf = build.ee_buffer(m)
    assert buf.shape == (4, 16 + m.n)
    for row, (chain, fid) in zip(buf, eepose.ee_chains(m)):
        np.testing.assert_array_equal(row[:16].reshape(4, 4).numpy(),
                                      m.Tfixed[fid].numpy())
        assert row[16:].nonzero().flatten().tolist() == list(chain)
    sub = build.ee_buffer(m, TARGETS["hyq"])
    torch.testing.assert_close(sub, buf[[0, 3]], rtol=0, atol=0)
    assert build.ee_buffer(m) is buf
    assert build.ee_buffer(m, TARGETS["hyq"]) is sub
    pend = build_model(load_robot("pendulum2"), dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(build.ee_buffer(pend).numpy(),
                                  [[*np.eye(4).ravel(), 1.0, 1.0]])
    ant = build_model(load_robot("gym_ant"), dtype=torch.float64, device="cpu")
    assert not build.ee_buffer(ant)[:, 16:].any()   # welded to the base


# ---------------------------------------------------------------------------
# host build of the kernels' per-lane code
# ---------------------------------------------------------------------------

# the host's race check of the knot programs (GT_RACE_CHECK), which the
# harnesses of this file and tests/test_torch_ws_kernels.py define
RACE_CHECK = r"""
// the host's race check of the warp programs (warp.cuh, so.cuh): which
// thread of which phase last touched each tensor entry
static std::unordered_map<const void*, std::pair<long, int>> g_touch;
static long g_phase = 0, g_races = 0, g_touches = 0;
static int g_thread = 0;
void gt::gt_race_touch(const void* p) {
  auto& e = g_touch[p];
  if (e.first == g_phase && e.second != g_thread) ++g_races;
  e = {g_phase, g_thread};
  ++g_touches;
}
// the watched buffer of the sweep programs (sweep_warp.cuh): compared
// before and after each thread of a phase, each changed double a touch by
// that thread
static const unsigned char* g_watch = nullptr;
static long g_watch_bytes = 0;
static bool g_watch_on = false;
static std::vector<unsigned char> g_snap;
static int g_prev = -1;
static void watch_diff() {
  if (!g_watch_on || !g_watch || g_prev < 0) return;
  for (long o = 0; o < g_watch_bytes; o += 8)
    if (std::memcmp(g_watch + o, g_snap.data() + o, 8) != 0)
      gt::gt_race_touch(g_watch + o);
}
static void watch_snap() {
  if (g_watch_on && g_watch) std::memcpy(g_snap.data(), g_watch, g_watch_bytes);
}
void gt::gt_race_phase() { ++g_phase; g_prev = -1; watch_snap(); }
void gt::gt_race_thread(int t) {
  const int t_now = t;
  if (g_prev >= 0) { g_thread = g_prev; watch_diff(); watch_snap(); }
  g_prev = g_thread = t_now;
}
void gt::gt_race_done() { watch_diff(); g_prev = -1; }
void gt::gt_race_watch(const void* p, long bytes) {
  g_watch = static_cast<const unsigned char*>(p);
  g_watch_bytes = bytes;
  g_snap.resize(bytes);
}
bool gt::gt_race_reverse = false;
extern "C" void race_reverse(int on) { gt::gt_race_reverse = on != 0; }
extern "C" void race_watch(int on) { g_watch_on = on != 0; }
extern "C" void race_reset() { g_touch.clear(); g_races = g_touches = 0; }
extern "C" long race_count() { return g_races; }
extern "C" long touch_count() { return g_touches; }
"""

HARNESS = r"""
#define GT_RACE_CHECK
#include <cstring>
#include <unordered_map>
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
using namespace gt;
typedef long long ll;

// (q, qd, x) -> out over L lanes for the per-lane functions of rnea (x =
// qdd, may be null), id_du (x = qdd) and aba (x = u)
template <int NJ, int OUT, class F>
void lanes3(const double* q, const double* qd, const double* x, double* out,
            ll L, F lane_fn) {
  for (ll l = 0; l < L; ++l) {
    double ql[NJ], qdl[NJ], xl[NJ], ol[OUT];
    lane_load<double, NJ>(q, L, l, ql);
    lane_load<double, NJ>(qd, L, l, qdl);
    if (x) lane_load<double, NJ>(x, L, l, xl);
    lane_fn(ql, qdl, x ? xl : nullptr, ol);
    lane_store<double, OUT>(ol, L, l, out);
  }
}

""" + RACE_CHECK + r"""

// the warp kernels' block plans: {G, threads a knot, bytes a block, rows
// a block} of fd_du, fdsva_so, riccati_factored, linesearch_rollout, the
// dense riccati (stationary, then a block per knot), rollout, idsva_so,
// feedback_rollout, id_du, d2eepos, idsva_so's bands (then the bands of
// each dtype), rnea, aba, fd, eepos, minv and crba in float32 and float64
template <typename P>
void plan_into(int* out) {
  out[0] = P::G;
  out[1] = P::LANES;
  out[2] = (int)P::BYTES;
  out[3] = P::ROWS;
}

// idsva_so's banded block code on its own (the plan of float32 or float64,
// run in double; one band, or every band with band < 0): the number of
// bands of that plan, 0 where not even one band fits
template <int NJ>
int idsva_so_band(const double* m, const double* q, const double* qd,
                  const double* qdd, double* out, ll L, int f32, int band) {
  race_reset();
  if (f32) {
    if constexpr (IDSOBandPlan<float, NJ>::G >= 1) {
      idsva_so_band_host<double, NJ, DFormed, float>(m, q, qd, qdd, out, L,
                                                      -9.81, band);
      return IDSOBandPlan<float, NJ>::BANDS;
    }
  } else {
    if constexpr (IDSOBandPlan<double, NJ>::G >= 1) {
      idsva_so_band_host<double, NJ>(m, q, qd, qdd, out, L, -9.81, band);
      return IDSOBandPlan<double, NJ>::BANDS;
    }
  }
  return 0;
}

// whether two heads hold the same tree lists (levels and children)
template <int NJ>
int same_tree_lists(const RobotConst<double, NJ>& a,
                    const RobotConst<double, NJ>& b) {
  if (a.nlev != b.nlev) return 0;
  for (int l = 0; l <= a.nlev; ++l)
    if (a.lstart[l] != b.lstart[l]) return 0;
  for (int p = 0; p <= NJ; ++p)
    if (a.cstart[p] != b.cstart[p]) return 0;
  for (int i = 0; i < NJ; ++i)
    if (a.ljoint[i] != b.ljoint[i]) return 0;
  for (int n = 0; n < a.cstart[NJ]; ++n)
    if (a.clist[n] != b.clist[n]) return 0;
  return 1;
}

#define HOST(NJ)                                                            \
extern "C" int size_##NJ() { return Layout<NJ>::SIZE; }                     \
extern "C" void plans_##NJ(int* out) {                                      \
  plan_into<FDPlan<float, NJ>>(out);                                        \
  plan_into<FDPlan<double, NJ>>(out + 4);                                   \
  plan_into<SOPlan<float, NJ>>(out + 8);                                    \
  plan_into<SOPlan<double, NJ>>(out + 12);                                  \
  plan_into<RicPlan<float, NJ>>(out + 16);                                  \
  plan_into<RicPlan<double, NJ>>(out + 20);                                 \
  plan_into<LSPlan<float, NJ>>(out + 24);                                   \
  plan_into<LSPlan<double, NJ>>(out + 28);                                  \
  plan_into<RicPlan<float, NJ, RIC_STATIONARY>>(out + 32);                  \
  plan_into<RicPlan<double, NJ, RIC_STATIONARY>>(out + 36);                 \
  plan_into<RicPlan<float, NJ, RIC_DENSE>>(out + 40);                       \
  plan_into<RicPlan<double, NJ, RIC_DENSE>>(out + 44);                      \
  plan_into<RollPlan<float, NJ>>(out + 48);                                 \
  plan_into<RollPlan<double, NJ>>(out + 52);                                \
  plan_into<IDSOPlan<float, NJ>>(out + 56);                                 \
  plan_into<IDSOPlan<double, NJ>>(out + 60);                                \
  plan_into<FBPlan<float, NJ>>(out + 64);                                   \
  plan_into<FBPlan<double, NJ>>(out + 68);                                  \
  plan_into<IDUPlan<float, NJ>>(out + 72);                                  \
  plan_into<IDUPlan<double, NJ>>(out + 76);                                 \
  plan_into<D2Plan<float, NJ>>(out + 80);                                   \
  plan_into<D2Plan<double, NJ>>(out + 84);                                  \
  plan_into<IDSOBandPlan<float, NJ>>(out + 88);                             \
  plan_into<IDSOBandPlan<double, NJ>>(out + 92);                            \
  out[96] = IDSOBandPlan<float, NJ>::BANDS;                                 \
  out[97] = IDSOBandPlan<double, NJ>::BANDS;                                \
  plan_into<RNEAPlan<float, NJ>>(out + 100);                                \
  plan_into<RNEAPlan<double, NJ>>(out + 104);                               \
  plan_into<ABAPlan<float, NJ>>(out + 108);                                 \
  plan_into<ABAPlan<double, NJ>>(out + 112);                                \
  plan_into<FDPlanQ<float, NJ>>(out + 116);                                 \
  plan_into<FDPlanQ<double, NJ>>(out + 120);                                \
  plan_into<EEPlan<float, NJ>>(out + 124);                                  \
  plan_into<EEPlan<double, NJ>>(out + 128);                                 \
  plan_into<MinvPlan<float, NJ>>(out + 132);                                \
  plan_into<MinvPlan<double, NJ>>(out + 136);                               \
  plan_into<CRBAPlan<float, NJ>>(out + 140);                                \
  plan_into<CRBAPlan<double, NJ>>(out + 144);                               \
  plan_into<DJPlan<float, NJ>>(out + 148);                                  \
  plan_into<DJPlan<double, NJ>>(out + 152);                                 \
}                                                                           \
extern "C" int tree_lists_##NJ(const double* m) {                          \
  std::vector<RobotConst<double, NJ>> R(2);                                 \
  R[0].load(m, 0, 1);                                                       \
  R[1].load_tree(m, 0, 1);                                                  \
  return same_tree_lists(R[0], R[1]);                                       \
}                                                                           \
extern "C" void fd_du_##NJ(const double* m, const double* q,                \
    const double* qd, const double* u, double* d, double* a, double* mi,    \
    ll L) { fd_du_host<double, NJ>(m, q, qd, u, d, a, mi, L, -9.81); }       \
extern "C" void rnea_##NJ(const double* m, const double* q,                 \
    const double* qd, const double* qdd, double* c, ll L) {                 \
  race_reset();                                                             \
  rnea_host<double, NJ>(m, q, qd, qdd, c, L, -9.81);                        \
}                                                                           \
extern "C" void rnea_lane_##NJ(const double* m, const double* q,            \
    const double* qd, const double* qdd, double* c, ll L) {                 \
  Robot<double, NJ> R(m);                                                   \
  lanes3<NJ, NJ>(q, qd, qdd, c, L, [&](const double* a, const double* b,    \
      const double* x, double* o) {                                         \
    rnea_lane<double, NJ>(R, a, b, x, -9.81, o); });                        \
}                                                                           \
extern "C" void id_du_##NJ(const double* m, const double* q,                \
    const double* qd, const double* qdd, double* d, ll L) {                 \
  race_reset();                                                             \
  id_du_host<double, NJ>(m, q, qd, qdd, d, L, -9.81);                       \
}                                                                           \
extern "C" void id_du_lane_##NJ(const double* m, const double* q,           \
    const double* qd, const double* qdd, double* d, ll L) {                 \
  Robot<double, NJ> R(m);                                                   \
  lanes3<NJ, NJ * 2 * NJ>(q, qd, qdd, d, L, [&](const double* a,            \
      const double* b, const double* x, double* o) {                        \
    id_du_lane<double, NJ>(R, a, b, x, -9.81, o); });                       \
}                                                                           \
extern "C" void aba_##NJ(const double* m, const double* q,                  \
    const double* qd, const double* u, double* qdd, ll L) {                 \
  race_reset();                                                             \
  aba_host<double, NJ>(m, q, qd, u, qdd, L, -9.81);                         \
}                                                                           \
extern "C" void aba_lane_##NJ(const double* m, const double* q,             \
    const double* qd, const double* u, double* qdd, ll L) {                 \
  Robot<double, NJ> R(m);                                                   \
  lanes3<NJ, NJ>(q, qd, u, qdd, L, [&](const double* a, const double* b,   \
      const double* x, double* o) {                                         \
    aba<double, NJ>(R, a, b, x, -9.81, o); });                              \
}                                                                           \
extern "C" void minv_##NJ(const double* m, const double* q, double* mi,    \
    ll L, int dense) {                                                      \
  race_reset();                                                             \
  minv_host<double, NJ>(m, q, mi, L, dense != 0);                           \
}                                                                           \
extern "C" void minv_lane_##NJ(const double* m, const double* q,            \
    double* mi, ll L, int dense) {                                          \
  Robot<double, NJ> R(m);                                                   \
  for (ll l = 0; l < L; ++l) {                                              \
    double ql[NJ], ml[NJ * NJ];                                             \
    lane_load<double, NJ>(q, L, l, ql);                                     \
    minv_lane<double, NJ>(R, ql, dense != 0, ml);                           \
    lane_store<double, NJ * NJ>(ml, L, l, mi);                              \
  }                                                                         \
}                                                                           \
extern "C" void fd_##NJ(const double* m, const double* q,                   \
    const double* qd, const double* u, double* qdd, ll L) {                 \
  race_reset();                                                             \
  fd_host<double, NJ>(m, q, qd, u, qdd, L, -9.81);                          \
}                                                                           \
extern "C" void fd_lane_##NJ(const double* m, const double* q,              \
    const double* qd, const double* u, double* qdd, ll L) {                 \
  Robot<double, NJ> R(m);                                                   \
  lanes3<NJ, NJ>(q, qd, u, qdd, L, [&](const double* a, const double* b,   \
      const double* x, double* o) {                                         \
    fd_lane<double, NJ>(R, a, b, x, -9.81, o); });                          \
}                                                                           \
extern "C" void crba_##NJ(const double* m, const double* q, double* M,     \
    ll L) {                                                                 \
  race_reset();                                                             \
  crba_host<double, NJ>(m, q, M, L);                                        \
}                                                                           \
extern "C" void crba_lane_##NJ(const double* m, const double* q,            \
    double* M, ll L) {                                                      \
  Robot<double, NJ> R(m);                                                   \
  for (ll l = 0; l < L; ++l) {                                              \
    double ql[NJ], ml[NJ * NJ];                                             \
    lane_load<double, NJ>(q, L, l, ql);                                     \
    crba_lane<double, NJ>(R, ql, ml);                                       \
    lane_store<double, NJ * NJ>(ml, L, l, M);                               \
  }                                                                         \
}                                                                           \
extern "C" void eepos_##NJ(const double* m, const double* ee, int ne,      \
    const double* q, double* out, ll L) {                                   \
  race_reset();                                                             \
  eepos_host<double, NJ>(m, ee, ne, q, out, L);                             \
}                                                                           \
extern "C" void eepos_lane_##NJ(const double* m, const double* ee, int ne, \
    const double* q, double* out, ll L) {                                   \
  Robot<double, NJ> R(m);                                                   \
  for (ll l = 0; l < L; ++l) {                                              \
    double ql[NJ];                                                          \
    lane_load<double, NJ>(q, L, l, ql);                                     \
    ee_pose_lane<double, NJ>(R, ee, ne, ql, out + l, L);                    \
  }                                                                         \
}                                                                           \
extern "C" void deepos_##NJ(const double* m, const double* ee, int ne,     \
    const double* q, double* out, ll L) {                                   \
  race_reset();                                                             \
  deepos_host<double, NJ>(m, ee, ne, q, out, L);                            \
}                                                                           \
extern "C" void deepos_lane_##NJ(const double* m, const double* ee, int ne, \
    const double* q, double* out, ll L) {                                   \
  Robot<double, NJ> R(m);                                                   \
  for (ll l = 0; l < L; ++l) {                                              \
    double ql[NJ];                                                          \
    lane_load<double, NJ>(q, L, l, ql);                                     \
    ee_jac_lane<double, NJ>(R, ee, ne, ql, out + l, L);                     \
  }                                                                         \
}                                                                           \
extern "C" void d2eepos_##NJ(const double* m, const double* ee, int ne,    \
    const double* q, double* out, ll L) {                                   \
  race_reset();                                                             \
  d2eepos_host<double, NJ>(m, ee, ne, q, out, L);                           \
}                                                                           \
extern "C" void d2eepos_route_##NJ(const double* m, const double* ee,       \
    int ne, const double* q, double* out, ll L, int stage) {                \
  if (stage) d2eepos_host<double, NJ, true>(m, ee, ne, q, out, L);          \
  else d2eepos_host<double, NJ, false>(m, ee, ne, q, out, L);               \
}                                                                           \
extern "C" void d2eepos_lane_##NJ(const double* m, const double* ee,        \
    int ne, const double* q, double* out, ll L) {                           \
  Robot<double, NJ> R(m);                                                   \
  for (ll l = 0; l < L; ++l) {                                              \
    double ql[NJ];                                                          \
    lane_load<double, NJ>(q, L, l, ql);                                     \
    ee_hess_lane<double, NJ>(R, ee, ne, ql, out + l, L);                    \
  }                                                                         \
}                                                                           \
extern "C" void fbr_##NJ(const double* m, const double* x0,                \
    const double* Ur, const double* Xr, const double* kff, const double* K, \
    const double* lo, const double* hi, double* X, double* U, int N,        \
    ll B, double dt) {                                                      \
  race_reset();                                                             \
  feedback_rollout_host<double, NJ>(m, x0, Ur, Xr, kff, K, lo, hi, X, U, N, \
                                    B, dt, -9.81);                          \
}                                                                           \
extern "C" void fbr_lane_##NJ(const double* m, const double* x0,           \
    const double* Ur, const double* Xr, const double* kff, const double* K, \
    const double* lo, const double* hi, double* X, double* U, int N,        \
    ll B, double dt) {                                                      \
  Robot<double, NJ> R(m);                                                   \
  for (ll b = 0; b < B; ++b)                                                \
    feedback_rollout_lane<double, NJ>(R, x0, Ur, Xr, kff, K, lo, hi, X, U,  \
                                      N, B, b, dt, -9.81);                  \
}                                                                           \
extern "C" void rollout_##NJ(const double* m, const double* x0,            \
    const double* U, const double* lo, const double* hi, double* X, int N,  \
    ll B, double dt) {                                                      \
  race_reset();                                                             \
  rollout_host<double, NJ>(m, x0, U, lo, hi, X, N, B, dt, -9.81);           \
}                                                                           \
extern "C" void rollout_lane_##NJ(const double* m, const double* x0,       \
    const double* U, const double* lo, const double* hi, double* X, int N,  \
    ll B, double dt) {                                                      \
  Robot<double, NJ> R(m);                                                   \
  for (ll b = 0; b < B; ++b)                                                \
    rollout_lane<double, NJ>(R, x0, U, lo, hi, X, N, B, b, dt, -9.81);      \
}                                                                           \
extern "C" void ls_##NJ(const double* m, const double* x0,                 \
    const double* Ur, const double* Xr, const double* k, const double* K,   \
    const double* al, const double* lo, const double* hi, double* X,        \
    double* U, double* c, int N, ll B, int na, int kind, const double* w,   \
    double dt) {                                                            \
  race_reset();                                                             \
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
extern "C" void ls_nocost_lane_##NJ(const double* m, const double* x0,     \
    const double* Ur, const double* Xr, const double* k, const double* K,   \
    const double* al, const double* lo, const double* hi, double* X,        \
    double* U, int N, ll B, int na, double dt) {                            \
  Robot<double, NJ> R(m);                                                   \
  const NoCostK<double, NJ> nc{nullptr};                                    \
  for (ll l = 0; l < na * B; ++l)                                           \
    linesearch_lane<double, NJ>(R, x0, Ur, Xr, k, K, al, lo, hi, X, U,      \
                                nullptr, N, B, na, l, dt, -9.81, nc);       \
}                                                                           \
extern "C" void ricd_##NJ(const double* A, const double* Bm,               \
    const double* lx, const double* lu, const double* lxx,                  \
    const double* luu, const double* lux, int stationary,                   \
    const double* Vx0, const double* Vxx0, double* ks, double* Ks, int N,   \
    ll B, double reg) {                                                     \
  race_reset();                                                             \
  riccati_dense_host<double, NJ>(A, Bm, lx, lu, lxx, luu, lux,              \
                                 stationary != 0, Vx0, Vxx0, ks, Ks, N, B,  \
                                 reg);                                      \
}                                                                           \
extern "C" void ricd_lane_##NJ(const double* A, const double* Bm,          \
    const double* lx, const double* lu, const double* lxx,                  \
    const double* luu, const double* lux, int stationary,                   \
    const double* Vx0, const double* Vxx0, double* ks, double* Ks, int N,   \
    ll B, double reg) {                                                     \
  for (ll b = 0; b < B; ++b)                                                \
    riccati_dense_lane<double, NJ>(A, Bm, lx, lu, lxx, luu, lux,            \
                                   stationary != 0, Vx0, Vxx0, ks, Ks, N,   \
                                   B, b, reg);                              \
}                                                                           \
extern "C" void idsva_so_##NJ(const double* m, const double* q,             \
    const double* qd, const double* qdd, double* out, ll L) {               \
  race_reset();                                                             \
  idsva_so_plan_host<double, NJ>(m, q, qd, qdd, out, L, -9.81);             \
}                                                                           \
extern "C" int idsva_so_band_##NJ(const double* m, const double* q,         \
    const double* qd, const double* qdd, double* out, ll L, int f32,        \
    int band) {                                                             \
  return idsva_so_band<NJ>(m, q, qd, qdd, out, L, f32, band);               \
}                                                                           \
extern "C" void idsva_so_lane_##NJ(const double* m, const double* q,        \
    const double* qd, const double* qdd, double* out, ll L) {               \
  Robot<double, NJ> R(m);                                                   \
  for (ll l = 0; l < L; ++l) {                                              \
    double ql[NJ], qdl[NJ], xl[NJ];                                         \
    lane_load<double, NJ>(q, L, l, ql);                                     \
    lane_load<double, NJ>(qd, L, l, qdl);                                   \
    lane_load<double, NJ>(qdd, L, l, xl);                                   \
    idsva_so_lane<double, NJ>(R, ql, qdl, xl, -9.81, out + l, L);           \
  }                                                                         \
}                                                                           \
extern "C" void fdsva_so_##NJ(const double* m, const double* q,             \
    const double* qd, const double* u, double* out, ll L) {                 \
  race_reset();                                                             \
  fdsva_so_host<double, NJ>(m, q, qd, u, out, L, -9.81);                    \
}                                                                           \
extern "C" void ric_##NJ(const double* A, const double* Bm,                \
    const double* lx, const double* lu, const double* Jw,                   \
    const double* Vx0, const double* Vxx0, double* ks, double* Ks, int N,   \
    ll B, int r, double reg, double qd, double ud) {                        \
  race_reset();                                                             \
  riccati_factored_host<double, NJ>(A, Bm, lx, lu, Jw, Vx0, Vxx0, ks, Ks,   \
                                    N, B, r, reg, qd, ud);                  \
}
HOST(2)
HOST(4)
HOST(5)
HOST(7)
HOST(8)
HOST(12)
HOST(16)
HOST(17)
HOST(20)
HOST(28)
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("host_kernels")
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libhost.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-I", str(ROOT / "gridcodegenerator_tpu_torch" / "csrc"),
                    str(d / "harness.cpp"), "-o", str(lib)],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib))


def _p(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _host_run(lib, name, args, lane=False):
    """Run the host build of kernel ``name`` on the wrapper's arguments: the
    kernel's block code (the sweeps, fd_du, rnea, id_du, aba, minv, fd,
    crba, eepos, d2eepos and the second-order kernels), or with ``lane`` the
    serial lane function (the rollouts, the dense riccati, rnea, idsva_so,
    id_du, aba, minv, fd, crba, eepos and d2eepos)."""
    serial = "_lane" if lane else ""
    ll, D = ctypes.c_longlong, ctypes.c_double
    if name == "fd_du":
        m, q, qd, u, _ = args
        n, L = q.shape
        out = (torch.empty(n, 2 * n, L, dtype=q.dtype),
               torch.empty(n, L, dtype=q.dtype),
               torch.empty(n, n, L, dtype=q.dtype))
        getattr(lib, f"fd_du_{n}")(_p(build.model_buffer(m)), _p(q), _p(qd),
                                   _p(u), *map(_p, out), ll(L))
        return out
    if name in ("rnea", "rnea_bias", "id_du", "aba"):
        m, q, qd, x, _ = args
        n, L = q.shape
        out = torch.empty((n, 2 * n, L) if name == "id_du" else (n, L),
                          dtype=q.dtype)
        fn = KERNEL_OF.get(name, name) + serial
        getattr(lib, f"{fn}_{n}")(_p(build.model_buffer(m)), _p(q), _p(qd),
                                  _p(x), _p(out), ll(L))
        return (out,)
    if name == "fd":
        m, q, qd, u, _ = args
        n, L = q.shape
        out = torch.empty(n, L, dtype=q.dtype)
        getattr(lib, f"fd{serial}_{n}")(_p(build.model_buffer(m)), _p(q),
                                        _p(qd), _p(u), _p(out), ll(L))
        return (out,)
    if name == "crba":
        m, q = args
        n, L = q.shape
        out = torch.empty(n, n, L, dtype=q.dtype)
        getattr(lib, f"crba{serial}_{n}")(_p(build.model_buffer(m)), _p(q),
                                          _p(out), ll(L))
        return (out,)
    if name.startswith(("eepos", "deepos", "d2eepos")):
        m, q, *targets = args
        n, L = q.shape
        ee = build.ee_buffer(m, *targets)
        ne = ee.shape[0]
        kernel = KERNEL_OF.get(name, name)
        cols = {"eepos": (), "deepos": (n,), "d2eepos": (n, n)}[kernel]
        # NaN where the card would hand over uninitialised memory
        out = torch.full((6 * ne, *cols, L), float("nan"), dtype=q.dtype)
        fn = kernel + serial
        getattr(lib, f"{fn}_{n}")(_p(build.model_buffer(m)), _p(ee),
                                  ctypes.c_int(ne), _p(q), _p(out), ll(L))
        return (out,)
    if name in ("minv", "minv_upper"):
        m, q, dense = args
        n, L = q.shape
        out = torch.empty(n, n, L, dtype=q.dtype)
        getattr(lib, f"minv{serial}_{n}")(_p(build.model_buffer(m)), _p(q),
                                          _p(out), ll(L),
                                          ctypes.c_int(int(dense)))
        return (out,)
    if name == "rollout":
        m, x0, U, dt, _, lo, hi = args
        N, n, B = U.shape
        X = torch.empty(N, 2 * n, B, dtype=U.dtype)
        getattr(lib, f"rollout{serial}_{n}")(
            _p(build.model_buffer(m)), _p(x0), _p(U), _p(lo), _p(hi), _p(X),
            N, ll(B), D(dt))
        return (X,)
    if name == "feedback_rollout":
        m, x0, Ur, Xr, kff, Km, dt, _, lo, hi = args
        N, n, B = Ur.shape
        X = torch.empty(N, 2 * n, B, dtype=Ur.dtype)
        U = torch.empty(N, n, B, dtype=Ur.dtype)
        getattr(lib, f"fbr{serial}_{n}")(
            *map(_p, (build.model_buffer(m), x0, Ur, Xr, kff, Km, lo, hi, X,
                      U)), N, ll(B), D(dt))
        return X, U
    if name in ("idsva_so", "fdsva_so"):
        m, q, qd, x, _ = args
        n, L = q.shape
        # NaN where the card would hand over uninitialised memory: every
        # entry the lane does not write shows
        out = torch.full((4, n, n, n, L), float("nan"), dtype=q.dtype)
        getattr(lib, f"{name}{serial}_{n}")(_p(build.model_buffer(m)), _p(q),
                                            _p(qd), _p(x), _p(out), ll(L))
        return (out,)
    if name in ("riccati", "riccati_stacked"):
        A, Bm, lx, lu, lxx, luu, lux, Vx0, Vxx0, reg = args
        N, nx, n, B = Bm.shape
        ks = torch.empty(N, n, B, dtype=A.dtype)
        Ks = torch.empty(N, n, nx, B, dtype=A.dtype)
        getattr(lib, f"ricd{serial}_{n}")(
            *map(_p, (A, Bm, lx, lu, lxx, luu, lux)),
            ctypes.c_int(int(lxx.ndim == 3)), *map(_p, (Vx0, Vxx0, ks, Ks)),
            N, ll(B), D(reg))
        return ks, Ks
    if name == "riccati_factored":
        A, Bm, lx, lu, Jw, Vx0, Vxx0, reg, qd, ud = args
        N, nx, n, B = Bm.shape
        ks = torch.empty(N, n, B, dtype=A.dtype)
        Ks = torch.empty(N, n, nx, B, dtype=A.dtype)
        getattr(lib, f"ric_{n}")(*map(_p, (A, Bm, lx, lu, Jw, Vx0, Vxx0, ks,
                                           Ks)), N, ll(B), Jw.shape[0],
                                 D(reg), D(qd), D(ud))
        return ks, Ks
    m, x0, Ur, Xr, k, Km, al, dt, _, lo, hi, cost = args
    N, n, B = Ur.shape
    na = al.shape[0]
    X = torch.empty(N, 2 * n, na * B, dtype=x0.dtype)
    U = torch.empty(N, n, na * B, dtype=x0.dtype)
    if cost is None:   # the no-cost instance, or its serial lane
        ins = (build.model_buffer(m), x0, Ur, Xr, k, Km, al, lo, hi, X, U)
        if lane:
            getattr(lib, f"ls_nocost_lane_{n}")(*map(_p, ins), N, ll(B), na,
                                                D(dt))
        else:
            getattr(lib, f"ls_{n}")(*map(_p, ins), _p(None), N, ll(B), na,
                                    S.COST_KINDS["none"], _p(None), D(dt))
        return X, U
    c = torch.empty(na * B, dtype=x0.dtype)
    w = cost.kernel_weights
    wv = torch.tensor(w["values"], dtype=torch.float64)
    getattr(lib, f"ls_{n}")(_p(build.model_buffer(m, w["ee_index"])),
                            *map(_p, (x0, Ur, Xr, k, Km, al, lo, hi, X, U, c)),
                            N, ll(B), na, S.COST_KINDS[w["kind"]], _p(wv),
                            D(dt))
    return X, U, c


def pairs(names, robot_first=False):
    """The (name, robot) cases of kernels on ROBOTS; (robot, name) with
    ``robot_first``."""
    if robot_first:
        return [(r, n) for r in ROBOTS for n in names]
    return [(n, r) for n in names for r in ROBOTS]


@pytest.mark.parametrize("name,robot", pairs(KERNELS))
def test_host_build_of_kernel_matches_plain(host_lib, name, robot):
    m = build_model(topo(robot), dtype=torch.float64, device="cpu")
    assert getattr(host_lib, f"size_{m.n}")() == build.model_buffer(m).numel()
    args = path_inputs(m, 6, 5, seed=2)[name]
    got = _host_run(host_lib, name, args)
    want = _outs(WRAPPERS[name][1](*args))
    assert len(got) == len(want)
    assert _max_err(got, want) <= tol(robot, want)
    if name == "minv_upper":   # exact zeros below the diagonal
        assert not got[0].permute(2, 0, 1).tril(-1).any()


# the ints plans_<nj> writes: 4 a plan (k = offset / 4), idsva_so's bands
# at 96 and 97, rnea's and aba's plans from 100, fd's and eepos's from 116,
# minv's and crba's from 132, deepos's from 148
PLANS = 156


@pytest.mark.parametrize("nj", HOST_JOINTS)
def test_warp_block_plans_fit_an_sm(host_lib, nj):
    """Every instance's block plan of the thread-group kernels holds a knot
    (or problem, or rollout), fits a block's 227 KB and 512 threads and
    keeps whole warps: fd_du and fdsva_so (csrc/warp.cuh: BlockPlan) two
    half-warp knots a warp and a thread per gradient column of a pass, a
    knot 1, 2 or 4 times its fewest threads; the Riccati sweeps
    (riccati_factored, the dense riccati with a stationary curvature and
    with a block per knot) 1, 2 or 4 warps a problem; the line search
    (csrc/sweep_warp.cuh: LSPlan) 8 problems a block (4 where 8 do not
    fit, 2 in float64 at 28 joints), 1 to 8 of their step-size rows, 8, 16
    or 32 threads a rollout; the open-loop rollout (RollPlan) and the
    feedback rollout (FBPlan) 2, 4 or 8 problems a block of 8, 16 or 32
    threads each;
    idsva_so (IDSOPlan) as fdsva_so; id_du (IDUPlan) as fd_du, a thread per
    gradient column of its pass (one pass of 2 NJ columns up to 16 joints,
    two of NJ above); d2eepos (D2Plan) 8 threads a lane up to 8 joints, a
    warp above, G a power of 2 that makes each output row's run 32 bytes or
    more. Where one knot of fdsva_so does not fit a block (20 joints in
    float64, 28 in both) its plan holds none (G 0) and fdsva_so takes the
    composed route; where idsva_so's whole tile does not (the same counts),
    its banded plan (IDSOBandPlan) holds one band of a knot: the fewest
    bands of 256 threads that fit, 2 | 5 at 28 joints (float32 |
    float64), 2 in float64 at 20. rnea (RNEAPlan) and aba (ABAPlan, on the
    rollouts' ABA phases) 8 threads a knot on the chains of 2 and 7 joints
    and a warp otherwise (rnea 16 at 12 joints), G a power of 2 up to 8
    that makes each output row's run 32 bytes or more but where a block
    holds fewer (aba's 28-joint knot in float64: 4). fd (FDPlanQ, fd_du's
    first half) and minv (MinvPlan, fd's Minv passes) a warp a knot, G as
    rnea's but 4 | 2 knots a block at 28 joints (float32 | float64); eepos
    (EEPlan) 8 threads a lane, 8 lanes a block; crba (CRBAPlan) 16
    threads a knot at 2, 7 and 12 joints and a warp otherwise, G as
    rnea's; deepos (DJPlan, d2eepos's twist phases) 4 threads a lane, 16
    lanes a block."""
    out = (ctypes.c_int * PLANS)()
    getattr(host_lib, f"plans_{nj}")(out)
    base = 16 if 2 * nj <= 16 else 32
    no_knot = {20: (3, 15), 28: (2, 3, 14, 15)}.get(nj, ())
    for k in range(22):
        g, lanes, nbytes, rows = out[4 * k: 4 * k + 4]
        if k in no_knot:   # fdsva_so, idsva_so's whole tile
            assert g == 0 and nbytes > 232448
            continue
        assert 0 < nbytes <= 232448
        assert g * rows * lanes <= 512 and (g * rows * lanes) % 32 == 0
        if k >= 20:   # d2eepos, float32 then float64
            assert rows == 1 and lanes == (8 if nj <= 8 else 32)
            assert g in (1, 2, 4, 8)
            assert g * (4 if k == 20 else 8) >= 32
        elif k >= 18:   # id_du
            assert g >= 1 and rows == 1 and lanes in (base, 2 * base,
                                                      4 * base)
            assert lanes >= (2 * nj if nj <= 16 else nj)
        elif k < 4 or 14 <= k < 16:
            assert g >= 1 and rows == 1 and lanes in (base, 2 * base,
                                                      4 * base)
            assert lanes >= nj
        elif k < 6 or 8 <= k < 12:
            assert g >= 1 and rows == 1 and lanes in (32, 64, 128)
        elif k < 8:   # the line search: 2 a block only in float64 at 28
            assert g in ((2, 4, 8) if nj == 28 and k == 7 else (4, 8))
            assert 1 <= rows <= 8 and lanes in (8, 16, 32)
        else:   # the rollouts: RollPlan (12, 13), FBPlan (16, 17)
            assert g in (2, 4, 8) and rows == 1 and lanes in (8, 16, 32)
    bands = out[96:98]
    assert bands == {20: [1, 2], 28: [2, 5]}.get(nj, bands)
    for k, f32 in ((22, 1), (23, 0)):   # IDSOBandPlan float32, float64
        g, lanes, nbytes, rows = out[4 * k: 4 * k + 4]
        if 15 - f32 not in no_knot:
            continue
        assert g >= 1 and lanes == 256 and rows == 1
        assert 0 < nbytes <= 232448 and g * lanes <= 512
    for k in range(25, 29):   # rnea, aba: float32, then float64
        g, lanes, nbytes, rows = out[4 * k: 4 * k + 4]
        assert 0 < nbytes <= 232448 and rows == 1
        assert lanes == (8 if nj in (2, 7) else
                         16 if nj == 12 and k < 27 else 32)
        assert g in (1, 2, 4, 8) and (g * lanes) % 32 == 0
        f32 = k % 2 == 1
        if k == 28 and nj == 28:   # aba's float64 knot: 4 a block
            assert g == 4
        else:   # 32-byte runs
            assert g * (4 if f32 else 8) >= 32
    for k in range(29, 33):   # fd, eepos: float32, then float64
        g, lanes, nbytes, rows = out[4 * k: 4 * k + 4]
        assert 0 < nbytes <= 232448 and rows == 1
        assert g in (1, 2, 4, 8) and (g * lanes) % 32 == 0
        f32 = k % 2 == 1
        if k >= 31:   # eepos
            assert lanes == 8 and g == 8
        elif nj == 28:   # fd's 28-joint knot: 4 | 2 a block
            assert lanes == 32 and g == (4 if f32 else 2)
        else:   # 32-byte runs
            assert lanes == 32 and g * (4 if f32 else 8) >= 32
    for k in range(33, 37):   # minv, crba: float32, then float64
        g, lanes, nbytes, rows = out[4 * k: 4 * k + 4]
        assert 0 < nbytes <= 232448 and rows == 1
        assert g in (1, 2, 4, 8) and (g * lanes) % 32 == 0
        f32 = k % 2 == 1
        if k >= 35:   # crba: 16 at 2, 7 and 12 joints, 32-byte runs
            assert lanes == (16 if nj in (2, 7, 12) else 32)
            assert g * (4 if f32 else 8) >= 32
        elif nj == 28:   # minv's 28-joint knot: 4 | 2 a block
            assert lanes == 32 and g == (4 if f32 else 2)
        else:   # 32-byte runs
            assert lanes == 32 and g * (4 if f32 else 8) >= 32
    for k in (37, 38):   # deepos: float32, then float64
        g, lanes, nbytes, rows = out[4 * k: 4 * k + 4]
        assert 0 < nbytes <= 232448 and rows == 1
        assert lanes == 4 and g == 16


def test_compare_kernels_reads_ptxas_report():
    """compare_kernels.py keeps the thread-group kernels' instances (fd_du,
    fdsva_so, idsva_so, riccati_factored, the line search with each cost,
    the dense riccati by its curvature, the rollout, the feedback rollout,
    id_du, d2eepos, rnea with qdd and in the bias form, aba, minv dense and
    its upper factor, crba, and an earlier tree's deepos, a thread a lane)
    from a ptxas report, with the frames of called functions (cumulative),
    and no other kernel's (the script's own clock of a serial lane)."""
    spec = importlib.util.spec_from_file_location(
        "compare_kernels", Path(__file__).resolve().parents[1] /
        "compare_kernels.py")
    ck = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ck)
    fd = "_Z12fd_du_kernelIdLi7EEvPKT_S2_S2_S2_PS0_S3_S3_xS0_"
    deepos = "_Z13deepos_kernelIfLi7EEvPKT_S2_iS2_PS0_x"
    other = "_Z12clocked_laneILi7ELi4EEvPKfS1_iS1_S1_S1_PfxPx"
    minv = ("_Z11minv_kernelIfLi7ELb0EN2gt9KnotShapeIfNS0_9RobotConstIfLi7EEE"
            "Li1197ELi32ELi8EEEEvPKT_S7_PS5_x")
    crba = ("_Z11crba_kernelIdLi12EN2gt9KnotShapeIdNS0_9RobotConstIdLi12EEELi"
            "1188ELi16ELi8EEEEvPKT_S7_PS5_x")
    rnea = ("_Z11rnea_kernelIfLi7ELN2gt8RneaModeE0ENS0_9KnotShapeIfNS0_9Robot"
            "ConstIfLi7EEELi448ELi8ELi8EEEEvPKT_S8_S8_S8_PS6_xS6_")
    aba = ("_Z10aba_kernelIdLi28EN2gt9KnotShapeIdNS0_9RobotConstIdLi28EEELi3864"
           "ELi32ELi4EEEEvPKT_S7_S7_S7_PS5_xS5_")
    ric = "_Z23riccati_factored_kernelIfLi12EEvPKT_S2_S2_S2_S2_S2_S2_PS0_"
    ls = "_Z17linesearch_kernelIfLi7EN2gt9QuadCostWIfLi7EEEEvPKT_S5_"
    ricd = "_Z14riccati_kernelIdLi16ELb1EEvPKT_S2_S2_S2_S2_S2_S2_S2_S2_PS0_"
    roll = ("_Z14rollout_kernelIdLi16EN2gt9RollShapeIdLi16ELi32ELi4EEEEvPKT_"
            "S5_S5_S5_S5_PS3_ixS3_S3_")
    ids = "_Z15idsva_so_kernelIfLi7EEvPKT_S2_S2_S2_PS0_xS0_"
    fbr = ("_Z23feedback_rollout_kernelIdLi12EN2gt9RollShapeIdLi12ELi32ELi4ENS0_"
           "13FoldedStepLawIdLi12EEEEEEvPKT_S7_S7_S7_S7_S7_S7_S7_PS5_S8_ixS5_"
           "S5_")
    idu = "_Z12id_du_kernelIfLi7ELi1EEvPKT_S2_S2_S2_PS0_xS0_"
    d2 = ("_Z14d2eepos_kernelIdLi12EN2gt9KnotShapeIdNS0_6EEHeadIdLi12EEELi3220E"
          "Li32ELi8EEELb1EEvPKT_S8_iS8_PS6_x")
    report = "\n".join([
        f"ptxas info    : Compiling entry function '{minv}' for 'sm_90a'",
        f"ptxas info    : Function properties for {minv}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 56 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{crba}' for 'sm_90a'",
        f"ptxas info    : Function properties for {crba}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{rnea}' for 'sm_90a'",
        f"ptxas info    : Function properties for {rnea}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{aba}' for 'sm_90a'",
        f"ptxas info    : Function properties for {aba}",
        "    96 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 96 bytes "
        "cumulative stack size",
        f"ptxas info    : Compiling entry function '{idu}' for 'sm_90a'",
        f"ptxas info    : Function properties for {idu}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 59 registers, used 16 barriers",
        f"ptxas info    : Compiling entry function '{d2}' for 'sm_90a'",
        f"ptxas info    : Function properties for {d2}",
        "    176 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 122 registers, used 1 barriers, 176 bytes "
        "cumulative stack size",
        f"ptxas info    : Compiling entry function '{ids}' for 'sm_90a'",
        f"ptxas info    : Function properties for {ids}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 96 registers, 0 bytes cumulative stack size",
        f"ptxas info    : Compiling entry function '{fbr}' for 'sm_90a'",
        f"ptxas info    : Function properties for {fbr}",
        "    48 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 48 bytes "
        "cumulative stack size",
        f"ptxas info    : Compiling entry function '{ricd}' for 'sm_90a'",
        f"ptxas info    : Function properties for {ricd}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 80 registers, used 16 barriers",
        f"ptxas info    : Compiling entry function '{roll}' for 'sm_90a'",
        f"ptxas info    : Function properties for {roll}",
        "    112 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 172 registers, used 1 barriers, 112 bytes "
        "cumulative stack size",
        f"ptxas info    : Compiling entry function '{ric}' for 'sm_90a'",
        f"ptxas info    : Function properties for {ric}",
        "    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 56 registers, 8 bytes cumulative stack size",
        f"ptxas info    : Compiling entry function '{ls}' for 'sm_90a'",
        f"ptxas info    : Function properties for {ls}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 80 registers, 0 bytes cumulative stack size",
        f"ptxas info    : Compiling entry function '{deepos}' for 'sm_90a'",
        f"ptxas info    : Function properties for {deepos}",
        "    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, 16 bytes cumulative stack size",
        f"ptxas info    : Compiling entry function '{other}' for 'sm_90a'",
        f"ptxas info    : Function properties for {other}",
        "    24 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 48 registers, 24 bytes cumulative stack size",
        f"ptxas info    : Compiling entry function '{fd}' for 'sm_90a'",
        f"ptxas info    : Function properties for {fd}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 98 registers, 72 bytes cumulative stack size, "
        "560 bytes cmem[0]"])
    assert ck.parse_ptxas(report) == {
        "fd_du f64 nj7": {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                          "registers": 98, "smem": 0, "cumulative_stack": 72},
        "riccati_factored f32 nj12": {
            "stack": 8, "spill_stores": 0, "spill_loads": 0,
            "registers": 56, "smem": 0, "cumulative_stack": 8},
        "linesearch_quad f32 nj7": {
            "stack": 0, "spill_stores": 0, "spill_loads": 0,
            "registers": 80, "smem": 0, "cumulative_stack": 0},
        "riccati_stationary f64 nj16": {
            "stack": 0, "spill_stores": 0, "spill_loads": 0,
            "registers": 80, "smem": 0},
        "rollout f64 nj16": {
            "stack": 112, "spill_stores": 0, "spill_loads": 0,
            "registers": 172, "smem": 0, "cumulative_stack": 112},
        "idsva_so f32 nj7": {
            "stack": 0, "spill_stores": 0, "spill_loads": 0,
            "registers": 96, "smem": 0, "cumulative_stack": 0},
        "feedback_rollout f64 nj12": {
            "stack": 48, "spill_stores": 0, "spill_loads": 0,
            "registers": 168, "smem": 0, "cumulative_stack": 48},
        "id_du f32 nj7": {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                          "registers": 59, "smem": 0},
        "d2eepos f64 nj12": {
            "stack": 176, "spill_stores": 0, "spill_loads": 0,
            "registers": 122, "smem": 0, "cumulative_stack": 176},
        "rnea_bias f32 nj7": {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                              "registers": 40, "smem": 0},
        "aba f64 nj28": {
            "stack": 96, "spill_stores": 0, "spill_loads": 0,
            "registers": 168, "smem": 0, "cumulative_stack": 96},
        "minv_upper f32 nj7": {"stack": 0, "spill_stores": 0,
                               "spill_loads": 0, "registers": 56, "smem": 0},
        "crba f64 nj12": {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                          "registers": 64, "smem": 0},
        "deepos f32 nj7": {
            "stack": 16, "spill_stores": 0, "spill_loads": 0,
            "registers": 40, "smem": 0, "cumulative_stack": 16}}


@pytest.mark.parametrize("robot,name", (
    [pytest.param(r, "fdsva_so", id=r) for r in ROBOTS]
    + [pytest.param(r, "idsva_so", id=f"{r}-idsva_so") for r in ROBOTS]))
def test_host_fdsva_so_phases_touch_disjoint_entries(host_lib, robot, name):
    """The fdsva_so warp program splits the IDSVA-SO stages over (j, a, st)
    triples, the corrections over (j, a) pairs and the contractions over
    columns (csrc/warp.cuh); idsva_so runs the same IDSVA-SO program alone:
    run phase by phase on the host, no entry of the knot's tensor is
    touched by two threads of one phase."""
    m = build_model(topo(robot), dtype=torch.float64, device="cpu")
    args = path_inputs(m, 2, 2, seed=2)[name]
    host_lib.race_count.restype = ctypes.c_long
    host_lib.touch_count.restype = ctypes.c_long
    got = _host_run(host_lib, name, args)
    # fdsva_so's contractions touch every entry; idsva_so's stages at least
    # every entry that comes out non-zero
    least = 4 * m.n ** 3 if name == "fdsva_so" else int((got[0] != 0).sum())
    assert host_lib.touch_count() > least > 0
    assert host_lib.race_count() == 0
    want = _outs(WRAPPERS[name][1](*args))
    assert _max_err(got, want) <= tol(robot, want)


SWEEP_PROGRAMS = ("riccati_factored", "linesearch_rollout", "linesearch_quad",
                  "riccati", "riccati_stacked", "rollout", "feedback_rollout")


@pytest.mark.parametrize("robot,name", pairs(
    ("fd_du", "fdsva_so", "idsva_so") + SWEEP_PROGRAMS + ("id_du", "d2eepos",
                                                          "rnea", "rnea_bias",
                                                          "aba", "fd",
                                                          "eepos", "minv",
                                                          "crba", "deepos"),
    robot_first=True))
def test_host_warp_phases_do_not_depend_on_thread_order(host_lib, robot,
                                                        name):
    """No thread of a phase of the thread-group programs (csrc/warp.cuh,
    csrc/sweep_warp.cuh) reads what another thread of that phase writes:
    run phase by phase on the host with the threads of each phase in
    reverse order, fd_du, fdsva_so, idsva_so, the Riccati sweeps (factored,
    dense stationary and per knot), the line search (both costs), the
    open-loop and feedback rollouts, id_du, d2eepos, rnea (with qdd and
    the bias form), aba, fd, eepos, minv (dense), crba and deepos give the
    same bits."""
    m = build_model(topo(robot), dtype=torch.float64, device="cpu")
    key = name if name in SWEEP_PROGRAMS else "fdsva_so"
    args = path_inputs(m, 2, 2, seed=3)[key]
    if name in ("d2eepos", "eepos", "crba", "deepos"):   # q
        args = args[:2]
    if name == "minv":   # q, dense
        args = args[:2] + (True,)
    if name == "rnea_bias":   # no qdd
        args = args[:3] + (None,) + args[4:]
    got = _host_run(host_lib, name, args)
    host_lib.race_reverse(1)
    try:
        rev = _host_run(host_lib, name, args)
    finally:
        host_lib.race_reverse(0)
    for a, b in zip(got, rev):
        assert torch.equal(a, b)
    want = _outs(WRAPPERS[name][1](*args))
    assert _max_err(got, want) <= tol(robot, want)


@pytest.mark.parametrize("name", SWEEP_PROGRAMS)
@pytest.mark.parametrize("robot", ROBOTS)
def test_host_sweep_phases_write_disjoint_entries(host_lib, robot, name):
    """The Riccati and rollout programs (csrc/sweep_warp.cuh) split each
    phase over the group's threads: run phase by phase on the host, no
    entry of a problem's or rollout's state is written by two threads of
    one phase (the harness compares the state before and after each
    thread)."""
    m = build_model(topo(robot), dtype=torch.float64, device="cpu")
    args = path_inputs(m, 2, 2, seed=2)[name]
    host_lib.race_count.restype = ctypes.c_long
    host_lib.touch_count.restype = ctypes.c_long
    host_lib.race_watch(1)
    try:
        got = _host_run(host_lib, name, args)
    finally:
        host_lib.race_watch(0)
    assert host_lib.touch_count() > 2 * (2 * m.n) ** 2
    assert host_lib.race_count() == 0
    want = _outs(WRAPPERS[name][1](*args))
    assert _max_err(got, want) <= tol(robot, want)


@pytest.mark.parametrize("name", ["id_du", "d2eepos", "d2eepos_targets",
                                  "rnea", "rnea_bias", "aba", "fd", "eepos",
                                  "minv", "crba", "deepos"])
@pytest.mark.parametrize("robot", ROBOTS)
def test_host_knot_phases_write_disjoint_entries(host_lib, robot, name):
    """id_du's, d2eepos's, rnea's, fd's, eepos's, minv's, crba's and
    deepos's knot programs (csrc/warp.cuh) and aba's (csrc/sweep_warp.cuh)
    split each phase over the knot's threads: run phase by phase on the
    host, no entry of a knot's state is written by two threads of one phase
    (the harness compares the knot before and after each thread); d2eepos
    on every EE of the robot and on some of them, eepos and deepos on every
    EE (gym_ant: its four feet, on every EE)."""
    if robot == "gym_ant":
        m = gym_ant_feet(torch.float64, "cpu")
    else:
        m = build_model(topo(robot), dtype=torch.float64, device="cpu")
    if name.endswith("_targets") and (robot == "gym_ant" or not TARGETS[robot]):
        name = "d2eepos"
    args = grid_inputs(m, robot, 3, seed=9)[name]
    host_lib.race_count.restype = ctypes.c_long
    host_lib.touch_count.restype = ctypes.c_long
    host_lib.race_watch(1)
    try:
        got = _host_run(host_lib, name, args)
    finally:
        host_lib.race_watch(0)
    if name == "id_du":
        least = 3 * m.n * m.n
    elif name in ("rnea", "rnea_bias", "aba", "fd", "minv", "crba"):
        least = 3 * 36 * m.n   # the transforms
    else:   # the chains' 4x4 matrices at least
        targets = args[2] if name == "d2eepos_targets" else None
        least = 3 * 16 * sum(len(c) for c, _ in eepose.ee_chains(m, targets))
    assert least > 0
    assert host_lib.touch_count() > least
    assert host_lib.race_count() == 0
    want = _outs(WRAPPERS[name][1](*args))
    assert _max_err(got, want) <= tol(robot, want)


@pytest.mark.parametrize("robot", ROBOTS)
def test_host_tree_head_builds_the_lists_of_load(host_lib, robot):
    """rnea's and aba's block head (warp.cuh:RobotConst::load_tree, the
    lists counted by all the block's threads) holds the levels and
    children lists that load's thread 0 walks, on chains and on trees with
    several joints on the base (hyq, gym_ant, dm_quadruped, the
    humanoids)."""
    m = build_model(topo(robot), dtype=torch.float64, device="cpu")
    assert getattr(host_lib, f"tree_lists_{m.n}")(_p(build.model_buffer(m)))


@pytest.mark.parametrize("robot", ROBOTS)
def test_host_id_du_is_fd_du_without_minv(host_lib, robot):
    """id_du and fd_du run one RNEA and ID-gradient program
    (warp.cuh:id_grad_columns_knot): -Minv times id_du's dc/du at fd_du's
    own qdd is fd_du's df/du."""
    m = build_model(topo(robot), dtype=torch.float64, device="cpu")
    args = path_inputs(m, 2, 3, seed=5)["fd_du"]
    dfdu, qdd, Mi = _host_run(host_lib, "fd_du", args)
    dc, = _host_run(host_lib, "id_du", (m, args[1], args[2], qdd, -9.81))
    got = -torch.einsum("ijl,jkl->ikl", Mi, dc)
    assert float(dfdu.abs().max()) > 1.0
    assert _max_err((got,), (dfdu,)) <= tol(robot, (dfdu,))


@pytest.mark.parametrize("robot", ROBOTS)
def test_host_d2eepos_direct_stores_match_the_staged(host_lib, robot):
    """d2eepos's two store routes (csrc/warp.cuh:d2eepos_knot): each pair's
    entries written straight out by its thread, and staged in the knot's
    tile and written as rows of G lanes, give the same bits on every
    entry, zeros included."""
    m = gym_ant_feet(torch.float64, "cpu") if robot == "gym_ant" else (
        build_model(topo(robot), dtype=torch.float64, device="cpu"))
    _, q = grid_inputs(m, robot, 11, seed=10)["d2eepos"]
    ee = build.ee_buffer(m)
    staged, direct = (torch.full((6 * ee.shape[0], m.n, m.n, q.shape[1]),
                                 float("nan"), dtype=q.dtype)
                      for _ in range(2))
    for out, stage in ((staged, 1), (direct, 0)):
        getattr(host_lib, f"d2eepos_route_{m.n}")(
            _p(build.model_buffer(m)), _p(ee), ctypes.c_int(ee.shape[0]),
            _p(q), _p(out), ctypes.c_longlong(q.shape[1]), ctypes.c_int(stage))
    assert torch.equal(direct, staged)
    want = _outs(K.d2eepos_plain(m, q))
    assert _max_err((staged,), want) <= tol(robot, want)


# the batches of the newer programs' ragged-block cases, by the plan's G
RAGGED_B = ("1", "G-1", "G+1", "37")
# the double plan's index in plans_<nj> (the host build runs it)
PLAN_INDEX = {"linesearch_nocost": 7, "riccati": 9, "riccati_stacked": 11, "rollout": 13,
              "idsva_so": 15, "feedback_rollout": 17, "id_du": 19,
              "d2eepos": 21, "rnea": 26, "rnea_bias": 26, "aba": 28,
              "fd": 30, "eepos": 32, "minv": 34, "minv_upper": 34,
              "crba": 36, "deepos": 38}


def _ragged_b(host_lib, name, nj, B):
    """The batch named B ("G-1", ...) for the double plan of ``name`` (of
    idsva_so: its banded plan where the whole tile's holds no knot)."""
    out = (ctypes.c_int * PLANS)()
    getattr(host_lib, f"plans_{nj}")(out)
    g = out[4 * PLAN_INDEX[name]] or out[4 * 23]
    return {"1": 1, "G-1": max(g - 1, 1), "G+1": g + 1, "37": 37}[B]


def _ragged_cases(old_ids, old, new):
    """The earlier cases under their ids, then the newer programs' cases."""
    return ([pytest.param(*c, id=old_ids(*c)) for c in old]
            + [pytest.param(*c, id="-".join(map(str, c))) for c in new])


@pytest.mark.parametrize("robot,name,na,N,B", _ragged_cases(
    lambda robot, name, na, N, B: f"{robot}-{name}-{na}-{N}",
    [(robot, name, na, N, "11") for robot in ("pendulum2", "iiwa", "hyq")
     for name in ("linesearch_rollout", "linesearch_quad") for na in (1, 6)
     for N in (1, 3)],
    [(robot, name, 1, N, B) for name in ("rollout", "feedback_rollout")
     for robot in ("pendulum2", "iiwa", "hyq", "dm_quadruped")
     for N in (1, 2, 5) for B in RAGGED_B]))
def test_host_line_search_on_ragged_blocks(host_lib, robot, name, na, N, B):
    """The line search's block code with the card's plan: 11 problems (8 a
    block: a ragged second block), one step size or six (split over blocks
    of rows), one knot or three; and the open-loop and feedback rollouts'
    (the same block, one row) on 1, G - 1, G + 1 and 37 problems, 1, 2 or
    5 knots."""
    m = build_model(topo(robot), dtype=torch.float64, device="cpu")
    B = 11 if B == "11" else _ragged_b(host_lib, name, m.n, B)
    args = list(path_inputs(m, N, B, seed=4)[name])
    if name.startswith("linesearch"):
        args[6] = torch.as_tensor(np.random.default_rng(5).uniform(
            0.05, 1.0, (na, B)), dtype=torch.float64)
    got = _host_run(host_lib, name, args)
    want = _outs(WRAPPERS[name][1](*args))
    assert got[0].shape == want[0].shape == (N, 2 * m.n, na * B)
    assert _max_err(got, want) <= tol(robot, want)


@pytest.mark.parametrize("robot", ["iiwa", "hyq"])
@pytest.mark.parametrize("B", RAGGED_B)
def test_host_nocost_line_search_is_the_serial_lane_bit_for_bit(host_lib,
                                                                 robot, B):
    """The line search without a cost (kind "none": csrc/linesearch.cu's
    NoCost instance, what a cost that is not time-invariant runs) on 1,
    G - 1, G + 1 and 37 problems, six step sizes over blocks of rows: its
    block code gives the serial linesearch_lane's bits for X and U, and the
    plain version's X and U within TOL; it writes no cost."""
    m = build_model(topo(robot), dtype=torch.float64, device="cpu")
    B = _ragged_b(host_lib, "linesearch_nocost", m.n, B)
    args = list(path_inputs(m, 2, B, seed=6)["linesearch_nocost"])
    args[6] = torch.as_tensor(np.random.default_rng(7).uniform(
        0.05, 1.0, (6, B)), dtype=torch.float64)
    got = _host_run(host_lib, "linesearch_nocost", args)
    lane = _host_run(host_lib, "linesearch_nocost", args, lane=True)
    assert got[0].shape == (2, 2 * m.n, 6 * B)
    for a, b in zip(got, lane):
        assert torch.equal(a, b)
    want = _outs(S.linesearch_rollout_plain(*args))
    assert len(want) == 2 and _max_err(got, want) <= TOL


@pytest.mark.parametrize("robot,N,name,B", _ragged_cases(
    lambda robot, N, name, B: f"{robot}-{N}",
    [(robot, N, "riccati_factored", "11")
     for robot in ("pendulum2", "iiwa", "hyq", "dm_quadruped")
     for N in (1, 3)],
    [(robot, N, name, B) for robot in ("pendulum2", "iiwa", "hyq",
                                       "dm_quadruped")
     for name in ("riccati", "riccati_stacked") for N in (1, 2, 5)
     for B in RAGGED_B]))
def test_host_riccati_factored_on_ragged_blocks(host_lib, robot, N, name, B):
    """riccati_factored's block code with the card's plan on 11 problems
    (a ragged last block), one knot or three; and the dense riccati's
    (stationary and per knot) on 1, G - 1, G + 1 and 37 problems, 1, 2 or
    5 knots."""
    m = build_model(topo(robot), dtype=torch.float64, device="cpu")
    B = 11 if B == "11" else _ragged_b(host_lib, name, m.n, B)
    args = path_inputs(m, N, B, seed=4)[name]
    got = _host_run(host_lib, name, args)
    want = _outs(WRAPPERS[name][1](*args))
    assert got[0].shape == want[0].shape
    assert _max_err(got, want) <= tol(robot, want)


@pytest.mark.parametrize("name,robot", pairs(
    ("riccati", "riccati_stacked", "rollout", "feedback_rollout", "idsva_so",
     "id_du", "d2eepos", "rnea", "rnea_bias", "aba", "eepos", "fd", "minv",
     "minv_upper", "crba", "deepos")))
def test_host_block_code_is_the_serial_lane_bit_for_bit(host_lib, name,
                                                        robot):
    """The block code of the dense riccati (stationary and per knot), of
    the open-loop and feedback rollouts and aba (csrc/sweep_warp.cuh: the
    rollouts' ABA phases), and the knot programs of idsva_so, rnea (with
    qdd and the bias form), eepos and crba (csrc/warp.cuh), run on the host
    with the card's plans, gives the bits of the serial functions
    riccati_dense_lane, rollout_lane, feedback_rollout_lane, aba,
    idsva_so_lane, rnea_lane, ee_pose_lane and crba_lane: every value keeps
    the serial order of operations (eepos on every robot, gym_ant's empty
    chains included; crba's parents add their children's composite
    inertias in descending order, and each row of X_c^T Ic_c is formed as
    XTMX_add forms it). id_du's, d2eepos's, deepos's, fd's and minv's
    (dense and the upper factor) knot programs are held to TOL against
    id_du_lane, ee_hess_lane, ee_jac_lane, fd_lane and minv_lane:
    id_du's columns skip the structural zeros of the transforms and walk
    only the related joints, d2eepos forms a mixed second derivative as
    Xi_a dT/dq_b, not along the chain, deepos dT/dq_a as Xi_a F, not as
    prefix_a dT_a suffix_a, and fd's and minv's Minv passes
    (fd_du's, warp.cuh:minv_backward_knot) distribute X_c^T over the
    backward pass's sums,
    F_p += X_c^T F_c + (X_c^T U_c) M_c and IA_p += (X_c^T IA_c) X_c -
    (X_c^T U_c) Dinv_c (X_c^T U_c)^T, where dynamics.cuh:minv_upper forms
    X_c^T (F_c + U_c M_c) and X_c^T (IA_c - U_c Dinv_c U_c^T) X_c. idsva_so
    is held to TOL: its
    knot program (warp.cuh:so_stages_knot, the phase of BC and f, which
    fdsva_so runs too) forms f's bias term crf(v) IC v as a cross product,
    where so.cuh:so_stages multiplies by crf(v)'s 6x6 matrix, zeros
    included; that sum's other order is the only difference."""
    m = build_model(topo(robot), dtype=torch.float64, device="cpu")
    args = (grid_inputs(m, robot, 11, seed=2)[name]
            if name in ("d2eepos", "eepos", "fd", "minv", "minv_upper",
                        "crba", "deepos")
            else path_inputs(m, 6, 11, seed=2)[name])
    got = _host_run(host_lib, name, args)
    lane = _host_run(host_lib, name, args, lane=True)
    assert len(got) == len(lane)
    if name == "idsva_so":
        assert _max_err(got, lane) <= tol(robot, lane)
        assert torch.equal(got[0] == 0, lane[0] == 0)
        return
    if name in ("id_du", "d2eepos", "fd", "minv", "minv_upper", "deepos"):
        assert _max_err(got, lane) <= tol(robot, lane)
        return
    for a, b in zip(got, lane):
        assert torch.equal(a, b)


@pytest.mark.parametrize("robot", ROBOTS)
def test_host_fd_is_fd_du_first_half(host_lib, robot):
    """fd and fd_du run one program for qdd (warp.cuh:fd_qdd_knot: the bias
    RNEA, Carpentier's Minv, qdd = Minv (u - c)) in their own layouts
    (FDQKnot, FDKnot) and plans: fd's qdd is fd_du's, bit for bit."""
    m = build_model(topo(robot), dtype=torch.float64, device="cpu")
    args = grid_inputs(m, robot, 5, seed=14)["fd"]
    qdd, = _host_run(host_lib, "fd", args)
    _, want, _ = _host_run(host_lib, "fd_du", args)
    assert float(want.abs().max()) > 0.1
    assert torch.equal(qdd, want)


@pytest.mark.parametrize("robot", ROBOTS)
def test_host_minv_is_fd_du_minv(host_lib, robot):
    """minv, fd and fd_du run one program for Minv (warp.cuh:
    minv_setup_knot, minv_backward_knot, minv_forward_knot) in their own
    layouts (MinvKnot, FDKnot) and plans: minv's dense Minv is fd_du's
    Minv, bit for bit; its upper instance has the same upper triangle and
    +0 below the diagonal (no -0, which torch.equal would not tell)."""
    m = build_model(topo(robot), dtype=torch.float64, device="cpu")
    args = grid_inputs(m, robot, 5, seed=14)["fd"]
    _, _, want = _host_run(host_lib, "fd_du", args)
    dense, = _host_run(host_lib, "minv", (m, args[1], True))
    upper, = _host_run(host_lib, "minv_upper", (m, args[1], False))
    assert float(want.abs().max()) > 0.1
    assert torch.equal(dense, want)
    up, lo = (upper.permute(2, 0, 1).triu(), upper.permute(2, 0, 1).tril(-1))
    assert torch.equal(up, dense.permute(2, 0, 1).triu())
    assert not lo.any() and not bool(torch.signbit(lo).any())


def test_host_eepos_of_an_empty_chain_is_its_fixed_frame(host_lib):
    """An EE whose chain is empty takes its fixed frame's pose in every
    lane, as ee_chain_T does, beside an EE on a chain (iiwa's, and one on no
    joint with a turned and moved fixed frame): the knot program
    (warp.cuh:eepos_knot) gives the serial ee_pose_lane's bits for both."""
    m = build_model(topo("iiwa"), dtype=torch.float64, device="cpu")
    n, L = m.n, 9
    c, s = np.cos(0.3), np.sin(0.3)
    tfix = np.array([[c, -s, 0, 0.1], [s, c, 0, -0.2], [0, 0, 1, 0.3],
                     [0, 0, 0, 1]])
    empty = torch.as_tensor(np.concatenate([tfix.ravel(), np.zeros(n)]))
    ee = torch.stack([build.ee_buffer(m)[0], empty]).contiguous()
    q = torch.as_tensor(np.random.default_rng(15).uniform(-1, 1, (n, L)))
    outs = []
    for fn in ("eepos", "eepos_lane"):
        out = torch.full((12, L), float("nan"), dtype=torch.float64)
        getattr(host_lib, f"{fn}_{n}")(_p(build.model_buffer(m)), _p(ee),
                                       ctypes.c_int(2), _p(q), _p(out),
                                       ctypes.c_longlong(L))
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    torch.testing.assert_close(outs[0][:6], K.eepos_plain(m, q), rtol=0,
                               atol=TOL)
    pose = torch.tensor([0.1, -0.2, 0.3, 0.0, 0.0, 0.3],
                        dtype=torch.float64)[:, None].expand(6, L)
    assert torch.equal(outs[0][6:], outs[0][6:, :1].expand(6, L))
    assert torch.equal(outs[0][6:9], pose[:3])
    torch.testing.assert_close(outs[0][6:], pose, rtol=0, atol=TOL)


@pytest.mark.parametrize("robot,B", _ragged_cases(
    lambda robot, B: f"{robot}-{B}", [],
    [(robot, B) for robot in ROBOTS for B in RAGGED_B]))
def test_host_idsva_so_on_ragged_blocks(host_lib, robot, B):
    """idsva_so's block code with the card's plan (G knots a block, the
    inputs past the last lane read as zeros, the output rows masked) on 1,
    G - 1, G + 1 and 37 lanes."""
    m = build_model(topo(robot), dtype=torch.float64, device="cpu")
    L = _ragged_b(host_lib, "idsva_so", m.n, B)
    rng = np.random.default_rng(8)
    q, qd, qdd = (torch.as_tensor(rng.uniform(-1, 1, (m.n, L)))
                  for _ in range(3))
    args = (m, q, qd, qdd, -9.81)
    got = _host_run(host_lib, "idsva_so", args)
    want = _outs(K.idsva_so_plain(*args))
    assert got[0].shape == want[0].shape == (4, m.n, m.n, m.n, L)
    assert _max_err(got, want) <= tol(robot, want)


@pytest.mark.parametrize("plan", ["float32", "float64"])
@pytest.mark.parametrize("robot", ["pendulum20", "atlas"])
def test_host_idsva_so_bands_hold_their_rows(host_lib, robot, plan):
    """idsva_so's banded knot program (warp.cuh:IDSOBandPlan, so.cuh:SOBand)
    with the card's plan of each dtype, run in double one band at a time,
    the race check on: each band writes exactly its rows (c, i) of the
    (4, n, n, n) tensor, each within TOL of the serial idsva_so_lane, and
    no entry (the threads' sinks included) is touched by two threads of one
    phase; all bands together give the whole tensor. 1 | 2 bands at 20
    joints, 2 | 5 at 28 (float32 | float64)."""
    m = build_model(topo(robot), dtype=torch.float64, device="cpu")
    n, L = m.n, 3
    rng = np.random.default_rng(12)
    q, qd, qdd = (torch.as_tensor(rng.uniform(-1, 1, (n, L)))
                  for _ in range(3))
    args = (m, q, qd, qdd, -9.81)
    lane = _host_run(host_lib, "idsva_so", args, lane=True)[0]
    host_lib.race_count.restype = ctypes.c_long
    host_lib.touch_count.restype = ctypes.c_long
    f32 = int(plan == "float32")

    def run(band):
        out = torch.full((4, n, n, n, L), float("nan"), dtype=torch.float64)
        nb = getattr(host_lib, f"idsva_so_band_{n}")(
            _p(build.model_buffer(m)), _p(q), _p(qd), _p(qdd), _p(out),
            ctypes.c_longlong(L), f32, band)
        assert host_lib.race_count() == 0 and host_lib.touch_count() > 0
        return nb, out.reshape(4 * n, n * n, L)

    nb, whole = run(-1)
    assert nb == {(20, 1): 1, (20, 0): 2, (28, 1): 2, (28, 0): 5}[n, f32]
    want = lane.reshape(4 * n, n * n, L)
    assert _max_err((whole,), (want,)) <= tol(robot, (want,))
    rows = -(-4 * n // nb)
    for band in range(nb):
        _, out = run(band)
        mine = slice(band * rows, min((band + 1) * rows, 4 * n))
        assert _max_err((out[mine],), (want[mine],)) <= tol(robot, (want,))
        rest = torch.cat([out[:mine.start], out[mine.stop:]])
        assert bool(rest.isnan().all())   # no row of another band written


@pytest.mark.parametrize("robot,name,B", _ragged_cases(
    lambda robot, name, B: f"{robot}-{name}-{B}", [],
    [(robot, name, B) for name in ("id_du", "d2eepos") for robot in ROBOTS
     for B in RAGGED_B]))
def test_host_id_du_and_d2eepos_on_ragged_blocks(host_lib, robot, name, B):
    """id_du's and d2eepos's block code with the card's plan (G knots a
    block, the inputs past the last lane read as zeros, the output rows
    masked) on 1, G - 1, G + 1 and 37 lanes."""
    m = build_model(topo(robot), dtype=torch.float64, device="cpu")
    L = _ragged_b(host_lib, name, m.n, B)
    args = grid_inputs(m, robot, L, seed=11)[name]
    got = _host_run(host_lib, name, args)
    want = _outs(WRAPPERS[name][1](*args))
    assert got[0].shape == want[0].shape and got[0].shape[-1] == L
    assert _max_err(got, want) <= tol(robot, want)


@pytest.mark.parametrize("robot,name,B", _ragged_cases(
    lambda robot, name, B: f"{robot}-{name}-{B}", [],
    [(robot, name, B) for name in ("rnea", "rnea_bias", "aba")
     for robot in ROBOTS for B in RAGGED_B]
    + [(robot, name, B) for name in ("fd", "eepos") for robot in ROBOTS
       for B in RAGGED_B]
    + [(robot, name, B) for name in ("minv", "minv_upper", "crba")
       for robot in ROBOTS for B in RAGGED_B]
    + [(robot, "deepos", B) for robot in ROBOTS for B in RAGGED_B]))
def test_host_rnea_and_aba_on_ragged_blocks(host_lib, robot, name, B):
    """rnea's (with qdd and the bias form), aba's, fd's, eepos's, minv's
    (dense and the upper factor), crba's and deepos's block code with the
    card's plan (G knots a block, the inputs past the last lane read as
    zeros, the output rows masked) on 1, G - 1, G + 1 and 37 lanes."""
    m = build_model(topo(robot), dtype=torch.float64, device="cpu")
    L = _ragged_b(host_lib, name, m.n, B)
    args = grid_inputs(m, robot, L, seed=13)[name]
    got = _host_run(host_lib, name, args)
    want = _outs(WRAPPERS[name][1](*args))
    ne = len(eepose.ee_chains(m))
    rows = ((6 * ne,) if name == "eepos" else (6 * ne, m.n) if name == "deepos"
            else (m.n, m.n) if name in ("minv", "minv_upper", "crba")
            else (m.n,))
    assert got[0].shape == want[0].shape == rows + (L,)
    assert _max_err(got, want) <= tol(robot, want)


@pytest.mark.parametrize("robot", ROBOTS)
def test_host_feedback_rollout_is_the_line_search_alpha_1_row(host_lib,
                                                              robot):
    """The feedback rollout with kff = k is the line search's alpha = 1 row
    bit for bit: the two run one block and step program, and alpha k + s is
    k + s at alpha = 1."""
    m = build_model(topo(robot), dtype=torch.float64, device="cpu")
    ls = list(path_inputs(m, 6, 5, seed=2)["linesearch_rollout"])
    ls[6] = torch.ones_like(ls[6][:1])
    X, U, _ = _host_run(host_lib, "linesearch_rollout", ls)
    Xf, Uf = _host_run(host_lib, "feedback_rollout", ls[:6] + ls[7:11])
    assert torch.equal(Xf, X) and torch.equal(Uf, U)


@pytest.mark.parametrize("case,robot", grid_params(ROBOTS))
def test_host_build_of_grid_kernel_matches_plain(host_lib, case, robot):
    """Every GRiD kernel's lane code on chains (pendulum2, iiwa), branched
    robots with 12 and 16 joints and 4 EEs (hyq, dm_quadruped), and EEs
    with empty chains (gym_ant, 8 joints)."""
    m = build_model(topo(robot), dtype=torch.float64, device="cpu")
    assert getattr(host_lib, f"size_{m.n}")() == build.model_buffer(m).numel()
    args = grid_inputs(m, robot, 9, seed=6)[case]
    got = _host_run(host_lib, case, args)
    want = _outs(WRAPPERS[case][1](*args))
    assert len(got) == len(want)
    assert all(g.shape == w.shape for g, w in zip(got, want))
    assert _max_err(got, want) <= tol(robot, want)


def gym_ant_feet(dtype, device):
    """gym_ant with its fixed frames dropped, so that its EEs are its four
    leaf links: its fixed frames all sit on the base (empty chains)."""
    topo = copy.copy(load_robot("gym_ant"))
    topo.fixed_joints = []
    return build_model(topo, dtype=dtype, device=device)


EE_KERNELS = ("eepos", "deepos", "d2eepos")


@pytest.mark.parametrize("case", EE_KERNELS)
def test_host_build_of_ee_kernel_on_gym_ant_feet(host_lib, case):
    """The EE kernels' lane code on the 8-joint instance, on chains that
    are not empty."""
    m = gym_ant_feet(torch.float64, "cpu")
    args = grid_inputs(m, "gym_ant", 9, seed=6)[case]
    got = _host_run(host_lib, case, args)
    want = _outs(WRAPPERS[case][1](*args))
    assert float(want[0].abs().max()) > 0.1
    assert _max_err(got, want) <= TOL


@pytest.fixture(scope="module")
def counts():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    m = build_model(load_robot("iiwa"), dtype=torch.float64, device="cpu")
    quad = path_inputs(m, 2, 1, seed=0)["linesearch_quad"][-1]
    return m, quad


@pytest.mark.parametrize("kernel", opcount.KERNELS)
def test_operation_counts(counts, kernel):
    """Every kernel's lane does work; the sweeps' work grows by the same
    amount with every knot; the bound takes the slower of its two limits."""
    m, quad = counts
    kw = dict(cost=quad) if kernel == "linesearch_rollout" else {}
    if kernel in ("rollout", "feedback_rollout", "linesearch_rollout",
                  "riccati_factored", "riccati"):
        c4, c8, c12 = (opcount.ops_per_lane(kernel, m, N=N, **kw)
                       for N in (4, 8, 12))
        assert 0 < c4 < c8 < c12 and c12 - c8 == c8 - c4
        kw["N"] = 8
    else:
        assert opcount.ops_per_lane(kernel, m) > 0
    # the function's arithmetic is at most what the lane code executes
    assert (0 < opcount.ops_per_lane(kernel, m, **kw)
            <= opcount.ops_per_lane(kernel, m, executed=True, **kw))
    ms, by = opcount.bound_ms(67e9, 1.0, torch.float32)
    assert by == "operations" and abs(ms - 1.0) < 1e-12
    assert opcount.bound_ms(1.0, 3.35e9, torch.float32) == (1.0, "bytes")


@pytest.mark.parametrize("executed", [False, True])
@pytest.mark.parametrize("robot", ["iiwa", "hyq"])
@pytest.mark.parametrize("kernel", ["idsva_so", "fdsva_so"])
def test_counted_second_order_lanes_compute_the_function(counts, kernel,
                                                         robot, executed):
    """The counted second-order lanes (the kernel's own, and the reference
    algorithm's with D1-D4 stored and constants folded) compute what the
    plain version does."""
    m = build_model(topo(robot), dtype=torch.float64, device="cpu")
    q, qd, x = np.random.default_rng(7).uniform(-1, 1, (3, m.n))
    want = getattr(K, kernel + "_plain")(
        m, *(torch.as_tensor(v)[:, None] for v in (q, qd, x)), -9.81)
    got = opcount.so_lane_values(kernel, m, q, qd, x, executed=executed)
    want = want[..., 0].numpy()
    assert np.abs(got - want).max() <= TOL * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("robot", ["gym_humanoid", "atlas"])
def test_operation_counts_at_17_and_28_joints(robot):
    """The counter covers the new joint counts: every kernel's need is at
    most what its lane code executes; at 28 joints idsva_so executes its
    knot program in every band (2 in float32, 5 in float64) and fdsva_so
    the composed route (fd_du, idsva_so, the contractions), each more than
    the fused knot's need."""
    m = build_model(topo(robot), dtype=torch.float64, device="cpu")
    quad = path_inputs(m, 2, 1, seed=0)["linesearch_quad"][-1]
    for kernel in opcount.KERNELS:
        kw = dict(N=4) if kernel in ("rollout", "feedback_rollout",
                                     "riccati_factored", "riccati") else {}
        if kernel == "linesearch_rollout":
            kw = dict(N=4, cost=quad)
        need = opcount.ops_per_lane(kernel, m, **kw)
        assert 0 < need <= opcount.ops_per_lane(kernel, m, executed=True,
                                                **kw)
    if robot == "atlas":
        ex = {dt: {k: opcount.ops_per_lane(k, m.to(dtype=dt), executed=True)
                   for k in ("idsva_so", "fdsva_so", "fd_du")}
              for dt in (torch.float32, torch.float64)}
        for e in ex.values():   # composed: fd_du + idsva_so + contractions
            assert e["fdsva_so"] > e["fd_du"] + e["idsva_so"]
        # five bands repeat more of the knot program than two
        assert ex[torch.float64]["idsva_so"] > ex[torch.float32]["idsva_so"]


@pytest.mark.parametrize("kernel", ["rnea", "aba", "fd", "eepos", "minv",
                                    "crba", "deepos"])
@pytest.mark.parametrize("robot", ROBOTS)
def test_operation_counts_of_the_rnea_and_aba_knots(counts, robot, kernel):
    """At every joint count of the host harness, the executed count of rnea,
    aba, fd, eepos, minv, crba and deepos is their knot program's (every
    thread of the knot's group, phase by phase: warp.cuh:rnea_host,
    fd_host, eepos_host, minv_host, crba_host, deepos_host,
    sweep_warp.cuh:aba_host), at least the function's need (the serial lane
    with constants folded; deepos: the fewer of the chain form's and the
    twist form's), and the same in either dtype's plan's width.
    gym_ant's EEs are welded to its base: their poses are constants of the
    robot, which the knot program forms and the function needs no
    operation for, and their Jacobians zeros."""
    m = build_model(topo(robot), dtype=torch.float64, device="cpu")
    need = opcount.ops_per_lane(kernel, m)
    ran = opcount.ops_per_lane(kernel, m, executed=True)
    welded = kernel in ("eepos", "deepos") and robot == "gym_ant"
    assert (0 == need if welded else 0 < need) and need <= ran and ran > 0
    assert ran == opcount.ops_per_lane(kernel, m.to(dtype=torch.float32),
                                       executed=True)


def test_operation_counts_follow_the_work(counts):
    m, quad = counts
    ops = lambda k, **kw: opcount.ops_per_lane(k, m, **kw)
    assert ops("fdsva_so") > ops("idsva_so")
    assert ops("fd_du") > ops("fd") > ops("minv")
    assert ops("riccati", N=8, stationary=False) == ops("riccati", N=8)
    ee = EEReachCost(model=m, goal_xyz=torch.zeros(3, dtype=torch.float64))
    assert (ops("linesearch_rollout", N=8, cost=ee)
            > ops("linesearch_rollout", N=8, cost=quad))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("name,robot", pairs(KERNELS))
def test_cuda_kernel_matches_plain(cuda_device, name, robot):
    m = build_model(topo(robot), dtype=torch.float64,
                    device=cuda_device)
    args = path_inputs(m, 6, 37, seed=3)[name]   # 37 lanes: a ragged block
    kern, plain = WRAPPERS[name]
    build.reset_counters()
    got = _outs(kern(*args))
    torch.cuda.synchronize()
    if name == "fdsva_so" and K.fdsva_so_route(m.n, m.dtype) == K.COMPOSED:
        assert dict(build.LAUNCHES) == {"fd_du": 1, "idsva_so": 1}
    else:
        assert build.LAUNCHES[KERNEL_OF.get(name, name)] == 1
    assert not build.PLAIN_CALLS
    want = _outs(plain(*args))
    assert all(g.is_cuda and g.shape == w.shape for g, w in zip(got, want))
    assert _max_err(got, want) <= tol(robot, want)
    if name == "minv_upper":   # exact zeros below the diagonal
        assert not got[0].permute(2, 0, 1).tril(-1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["linesearch_rollout", "linesearch_quad",
                                  "linesearch_nocost", "feedback_rollout",
                                  "d2eepos"])
def test_cuda_tiles_in_device_memory_at_64_joints(cuda_device, name):
    """At 64 joints in float64 (atlas with two 18-joint grippers,
    tests/torch_big_robots.py; its library built at first use) the line
    search's and the feedback rollout's tiles sit in device memory
    (TILES_WS) and d2eepos stores directly: each launches once and matches
    its plain twin on 5 problems (N = 4) within TOL of each output's
    scale."""
    m = build_model(parse_urdf(atlas_hands_urdf(18),
                               name=atlas_hands_name(18)),
                    dtype=torch.float64, device=cuda_device)
    assert m.n == 64 and m.name in DT
    for what in ("linesearch", "feedback_rollout"):
        assert build.plan(what, m.n, torch.float64)["workspace_bytes"] > 0
    if name == "d2eepos":
        args = (m, torch.as_tensor(np.random.default_rng(4).uniform(
            -1, 1, (m.n, 5)), dtype=torch.float64, device=cuda_device))
    else:
        args = path_inputs(m, 4, 5, seed=4)[name]
    kern, plain = WRAPPERS[name]
    build.reset_counters()
    got = _outs(kern(*args))
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {KERNEL_OF.get(name, name): 1}
    assert not build.PLAIN_CALLS
    want = _outs(plain(*args))
    assert all(g.is_cuda and g.shape == w.shape for g, w in zip(got, want))
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    assert _max_err(got, want) <= TOL * scale


# Above 32 joints id_du's knots take more than one warp in shared memory
# (warp.cuh: knot_lanes, at least 64 threads: a thread a column of a pass,
# a thread a joint, and barriers across the warps; the plan may give a
# knot more): in float32 at 33-47 joints and in float64 at 33. Its other
# instances at these counts take the device-memory route; fd_du runs one
# knot on chip in a block or a cluster of blocks there (warp.cuh:
# FDChipPlan; from 29 joints). The robots: the 33- and 46-joint chains
# and atlas_grippers34 (a tree: two 3-joint grippers on atlas).
TWO_WARP_ROBOTS = {"pendulum33": 33, "atlas_grippers34": 34,
                   "pendulum46": 46}
# the (kernel, dtype) instances whose knots sit in shared memory there
TWO_WARP_SHARED = {("id_du", torch.float32): range(33, 48),
                   ("id_du", torch.float64): range(33, 34)}
# float32 against a float64 plain run: chip_smoke.py's rule, within
# F32_FACTOR times the plain float32 version's own error plus F32_FLOOR of
# the output's scale
F32_FACTOR, F32_FLOOR = 10.0, 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("robot", list(TWO_WARP_ROBOTS))
@pytest.mark.parametrize("name", ["fd_du", "id_du"])
def test_cuda_two_warp_knots_match_plain(cuda_device, name, robot, dtype):
    """fd_du and id_du at 33, 34 and 46 joints (libraries built at first
    use) take the plan TWO_WARP_SHARED says: more than a warp a knot in
    shared memory, else the device-memory route (id_du) or one knot on
    chip, a block or a cluster of blocks of 256 threads and no workspace
    (fd_du). Each launches once on 37 lanes (a
    ragged block) and holds its float64 plain version within TOL of each
    output's scale in float64, by the float32 rule in float32."""
    nj = TWO_WARP_ROBOTS[robot]
    t = (parse_urdf(atlas_hands_urdf(3), name=atlas_hands_name(3))
         if robot.startswith("atlas") else
         parse_urdf(pendulum_urdf(nj), name=robot))
    m64 = build_model(t, dtype=torch.float64, device=cuda_device)
    assert m64.n == nj
    p = build.plan(name, nj, dtype)
    if nj in TWO_WARP_SHARED.get((name, dtype), ()):
        assert p["knots_per_block"] >= 1 and p["threads_per_knot"] > 32
        assert p["workspace_bytes"] == 0
    elif name == "fd_du":
        assert p["knots_per_block"] == 1 and p["workspace_bytes"] == 0
        assert p["threads_per_knot"] == 256 * p["cluster_blocks"]
    else:
        assert p["knots_per_block"] == 0 and p["workspace_bytes"] > 0
    rng = np.random.default_rng(5)
    x64 = tuple(torch.as_tensor(rng.uniform(-1, 1, (nj, 37)),
                                dtype=torch.float64, device=cuda_device)
                for _ in range(3))
    m = m64.to(dtype=dtype)
    kern, plain = WRAPPERS[name]
    build.reset_counters()
    got = _outs(kern(m, *(x.to(dtype) for x in x64)))
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {name: 1}
    assert not build.PLAIN_CALLS
    want = _outs(plain(m64, *x64))
    assert all(g.is_cuda and g.dtype == dtype and g.shape == w.shape
               for g, w in zip(got, want))
    if dtype == torch.float64:
        scale = max(1.0, max(float(w.abs().max()) for w in want))
        assert _max_err(got, want) <= TOL * scale
        return
    ref32 = _outs(plain(m, *(x.to(dtype) for x in x64)))
    for g, w, r in zip(got, want, ref32):
        assert bool(torch.isfinite(g).all())
        own = float((r.double() - w).abs().max())
        bound = F32_FACTOR * own + F32_FLOOR * max(1.0, float(w.abs().max()))
        assert float((g.double() - w).abs().max()) <= bound


@pytest.mark.cuda
def test_cuda_second_order_refuses_above_28_joints(cuda_device):
    """Above 28 joints the second order runs on the card, where the JAX
    package leaves its Pallas kernels: on atlas_grippers34 in float64
    GRiD.idsva_so launches idsva_so (its tile in device memory) and
    GRiD.fdsva_so fd_du and idsva_so (the composed route), no plain
    version, at 5 lanes (a ragged block), within 1e-9 of the plain
    version's scale; make_sqp solves there on the kernels (rollout, fd_du
    twice, idsva_so and the line search an iteration), within 1e-6 of a
    plain solve's cost scale."""
    t = parse_urdf(atlas_hands_urdf(3), name=atlas_hands_name(3))
    g = GRiD(t, dtype=torch.float64, device=cuda_device)
    plain = GRiD(t, dtype=torch.float64, device=cuda_device,
                 use_kernels=False)
    n = g.n
    assert K.idsva_so_route(n, torch.float64) == K.DEVICE
    xb = np.random.default_rng(34).uniform(-1, 1, (5, n))
    for method, launches in (("idsva_so", {"idsva_so": 1}),
                             ("fdsva_so", {"fd_du": 1, "idsva_so": 1})):
        build.reset_counters()
        got = getattr(g, method)(xb, xb, xb)
        torch.cuda.synchronize()
        assert dict(build.LAUNCHES) == launches and not build.PLAIN_CALLS
        want = getattr(plain, method)(xb, xb, xb)
        assert got.is_cuda and got.shape == want.shape == (5, 4, n, n, n)
        scale = max(1.0, float(want.abs().max()))
        assert _max_err((got,), (want,)) <= TOL * scale, method
    kw = dict(dtype=torch.float64, device=cuda_device)
    xg = torch.zeros(2 * n, **kw)
    xg[0] = 0.2
    cost = QuadCost(Q=torch.full((2 * n,), 0.1, **kw),
                    R=torch.full((n,), 1e-3, **kw),
                    Qf=torch.full((2 * n,), 10.0, **kw), x_goal=xg)
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(-0.05, 0.05,
                                                          (2 * n, 3)), **kw)
    U0 = torch.zeros((4, n, 3), **kw)
    build.reset_counters()
    res = make_sqp(g.model, cost, SQPConfig(N=4, dt=0.002, iters=2))(x0, U0)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {"rollout": 1, "fd_du": 4, "idsva_so": 2,
                                    "linesearch_rollout": 2}
    assert not build.PLAIN_CALLS
    ref = make_sqp(g.model, cost, SQPConfig(N=4, dt=0.002, iters=2,
                                            use_kernels=False))(x0, U0)
    assert bool(torch.isfinite(res.cost_trace).all())
    tol = 1e-6 * float(ref.cost_trace.abs().max())
    assert float((res.cost_trace - ref.cost_trace).abs().max()) <= tol


# the float32 sweeps' robots: not the 20-joint chain, whose float32
# riccati_factored gains part from float64 by 4e-4 of their scale in the
# plain version itself (Gauss-Jordan on an ill-conditioned Quu; 8e-5 at
# dt 0.002); chip_smoke.py holds its float32 kernels by its own rule
F32_SWEEP_ROBOTS = tuple(r for r in ROBOTS if r != "pendulum20")


@pytest.mark.cuda
@pytest.mark.parametrize("robot", F32_SWEEP_ROBOTS)
@pytest.mark.parametrize("name", SWEEP_PROGRAMS)
def test_cuda_sweep_programs_in_float32(cuda_device, name, robot):
    """The float32 instances of riccati_factored and the line search
    (csrc/sweep_warp.cuh) launch on every robot and agree with a float64
    plain run within 1e-4 of each output's scale (6 knots: the closed
    loops do not amplify rounding far)."""
    m = build_model(topo(robot), dtype=torch.float64,
                    device=cuda_device)
    args = path_inputs(m, 6, 37, seed=3)[name]
    m32 = m.to(dtype=torch.float32)
    a32 = tuple(m32 if a is m else a.float() if isinstance(a, torch.Tensor)
                else a for a in args)
    if isinstance(args[-1], EEReachCost):
        a32 = a32[:-1] + (dataclasses.replace(
            args[-1], model=m32, goal_xyz=args[-1].goal_xyz.float()),)
    build.reset_counters()
    got = _outs(WRAPPERS[name][0](*a32))
    torch.cuda.synchronize()
    assert build.LAUNCHES[KERNEL_OF.get(name, name)] == 1
    want = _outs(WRAPPERS[name][1](*args))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        assert float((g.double() - w).abs().max()) <= 1e-4 * max(
            1.0, float(w.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("case,robot", grid_params(ROBOTS[1:]))
def test_cuda_grid_kernel_matches_plain(cuda_device, case, robot):
    m = build_model(topo(robot), dtype=torch.float64,
                    device=cuda_device)
    args = grid_inputs(m, robot, 37, seed=3)[case]   # a ragged block
    kern, plain = WRAPPERS[case]
    build.reset_counters()
    got = _outs(kern(*args))
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {KERNEL_OF.get(case, case): 1}
    assert not build.PLAIN_CALLS
    want = _outs(plain(*args))
    assert all(g.is_cuda and g.shape == w.shape for g, w in zip(got, want))
    assert _max_err(got, want) <= tol(robot, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", EE_KERNELS)
def test_cuda_ee_kernel_on_gym_ant_feet(cuda_device, case):
    m = gym_ant_feet(torch.float64, cuda_device)
    args = grid_inputs(m, "gym_ant", 37, seed=3)[case]   # a ragged block
    build.reset_counters()
    got = _outs(WRAPPERS[case][0](*args))
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {case: 1} and not build.PLAIN_CALLS
    want = _outs(WRAPPERS[case][1](*args))
    assert float(want[0].abs().max()) > 0.1
    assert _max_err(got, want) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("robot", ["iiwa", "hyq", "atlas"])
def test_cuda_nocost_line_search_matches_plain(cuda_device, robot):
    """The line search's no-cost instance launches once, counted apart,
    and its X and U match the plain twin's (float64, 37 problems, six step
    sizes) and the EE instance's on the same inputs; no cost comes out."""
    m = build_model(topo(robot), dtype=torch.float64, device=cuda_device)
    ins = path_inputs(m, 6, 37, seed=3)
    args = ins["linesearch_nocost"]
    build.reset_counters()
    X, U, c = S.linesearch_rollout(*args)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {"linesearch_nocost": 1} and c is None
    assert not build.PLAIN_CALLS
    want = _outs(S.linesearch_rollout_plain(*args))
    assert _max_err((X, U), want) <= tol(robot, want)
    ee = S.linesearch_rollout(*ins["linesearch_rollout"])[:2]
    assert _max_err((X, U), ee) <= tol(robot, ee)


@pytest.mark.cuda
def test_cuda_slice_launches_every_kernel(cuda_device):
    m = build_model(load_robot("iiwa"), dtype=torch.float64,
                    device=cuda_device)
    goal = eepose.eepos(m, torch.full((7, 1), 0.5, dtype=torch.float64,
                                      device=cuda_device))[:3, 0]
    cost = EEReachCost(model=m, goal_xyz=goal, w_pos=0.5, w_pos_f=200.0)
    rng = np.random.default_rng(0)
    x0 = torch.as_tensor(rng.uniform(-0.2, 0.2, (14, 33)), device=cuda_device)
    U0 = torch.zeros((8, 7, 33), dtype=torch.float64, device=cuda_device)
    build.reset_counters()
    res = make_ilqr(m, cost, ILQRConfig(N=8, iters=2, use_kernels=True))(x0,
                                                                          U0)
    # the EE cost's pose (the first total cost's stage and terminal, then
    # each iteration's terminal expansion and GN factor) and Jacobian
    assert dict(build.LAUNCHES) == {"rollout": 1, "fd_du": 2,
                                    "riccati_factored": 2,
                                    "linesearch_rollout": 2, "eepos": 6,
                                    "deepos": 4}
    assert not build.PLAIN_CALLS
    build.reset_counters()
    ref = make_ilqr(m, cost, ILQRConfig(N=8, iters=2, use_kernels=False))(
        x0, U0)
    assert not build.LAUNCHES and build.PLAIN_CALLS["deepos"] == 4
    assert float((res.cost_trace - ref.cost_trace).abs().max()) <= 1e-8


@pytest.mark.cuda
def test_cuda_parallel_riccati_launches_no_riccati_kernel(cuda_device):
    """config 3's EE task with ``parallel_riccati``: the rollout, fd_du, the
    line search and the EE cost's kernels launch, no Riccati sweep (the
    scan is plain torch on the card); its costs match the sequential
    kernel solve at reg 0 (float64, N=8, 33 problems)."""
    m = build_model(load_robot("iiwa"), dtype=torch.float64,
                    device=cuda_device)
    goal = eepose.eepos(m, torch.full((7, 1), 0.5, dtype=torch.float64,
                                      device=cuda_device))[:3, 0]
    cost = EEReachCost(model=m, goal_xyz=goal, w_pos=0.5, w_pos_f=200.0)
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(-0.2, 0.2,
                                                           (14, 33)),
                         device=cuda_device)
    U0 = torch.zeros((8, 7, 33), dtype=torch.float64, device=cuda_device)
    build.reset_counters()
    par = make_ilqr(m, cost, ILQRConfig(N=8, iters=2, reg=0.0,
                                        parallel_riccati=True))(x0, U0)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {"rollout": 1, "fd_du": 2,
                                    "linesearch_rollout": 2, "eepos": 6,
                                    "deepos": 4}
    assert not build.PLAIN_CALLS
    seq = make_ilqr(m, cost, ILQRConfig(N=8, iters=2, reg=0.0))(x0, U0)
    assert float((par.cost_trace - seq.cost_trace).abs().max()) <= 1e-8


@pytest.mark.cuda
def test_cuda_floating_grid_launches_nothing(cuda_device):
    """GRiD on hyq_floating on the card: every first-order method runs its
    plain twin on CUDA tensors and launches no kernel; the kernels
    themselves refuse the floating model."""
    g = GRiD("hyq_floating", dtype=torch.float64, device=cuda_device)
    rng = np.random.default_rng(0)
    q = rng.uniform(-1, 1, (5, g.num_pos))
    v = rng.uniform(-1, 1, (5, g.num_vel))
    for method, twin, args in (
            ("id", "rnea", (q, v, v)), ("minv", "minv", (q,)),
            ("fd", "fd", (q, v, v)), ("aba", "aba", (q, v, v)),
            ("crba", "crba", (q,)), ("id_du", "id_du", (q, v, v)),
            ("fd_du", "fd_du", (q, v, v)), ("eepos", "eepos", (q,)),
            ("deepos", "deepos", (q,)), ("d2eepos", "d2eepos", (q,))):
        build.reset_counters()
        out = getattr(g, method)(*args)
        torch.cuda.synchronize()
        assert out.is_cuda and bool(torch.isfinite(out).all()), method
        assert not build.LAUNCHES
        assert dict(build.PLAIN_CALLS) == {twin: 1}, method
    qk = torch.as_tensor(q.T.copy(), device=cuda_device)
    with pytest.raises(NotImplementedError, match="fixed-base"):
        K.minv(g.model, qk)


@pytest.mark.cuda
@pytest.mark.parametrize("robot", ROBOTS)
def test_cuda_rnea_and_aba_plans_and_launches(cuda_device, robot):
    """rnea and aba run a thread group a knot (build.WARP_KERNELS): each
    instance's plan holds a knot, 8 threads on the chains of 2 and 7 joints
    and a warp otherwise (rnea 16 on hyq), keeps no per-thread array of the
    joints' transforms in local memory, and launches; each call (rnea with
    qdd and the bias form, aba) launches its kernel once, runs nothing
    plain and matches the plain twin in float64 at 1, G + 1 and 37
    lanes."""
    m = build_model(topo(robot), dtype=torch.float64, device=cuda_device)
    for what in ("rnea", "aba"):
        for dtype in (torch.float32, torch.float64):
            info = build.warp_kernel_info(what, m.n, dtype)
            assert info["knots_per_block"] >= 1 and info["blocks_per_sm"] >= 1
            assert info["threads_per_knot"] == (
                8 if m.n in (2, 7) else
                16 if m.n == 12 and what == "rnea" else 32)
            item = torch.finfo(dtype).bits // 8
            assert info["local_bytes"] < 36 * m.n * item
    g = build.plan("aba", m.n, torch.float64)["knots_per_block"]
    for lanes in (1, g + 1, 37):
        cases = grid_inputs(m, robot, lanes, seed=14)
        for case in ("rnea", "rnea_bias", "aba"):
            kern, plain = WRAPPERS[case]
            build.reset_counters()
            got = _outs(kern(*cases[case]))
            torch.cuda.synchronize()
            assert dict(build.LAUNCHES) == {KERNEL_OF.get(case, case): 1}
            assert not build.PLAIN_CALLS
            want = _outs(plain(*cases[case]))
            assert got[0].is_cuda and got[0].shape == want[0].shape
            assert _max_err(got, want) <= tol(robot, want)


@pytest.mark.cuda
@pytest.mark.parametrize("robot", ROBOTS)
def test_cuda_fd_and_eepos_plans_and_launches(cuda_device, robot):
    """fd, eepos, minv, crba and deepos run a thread group a knot
    (build.WARP_KERNELS): each instance's plan holds a knot (fd and minv: a
    warp; eepos: 8 threads a lane; deepos: 4; crba: 16 threads at 2, 7 and
    12 joints, else a warp), keeps no
    per-thread array of the joints' transforms in local memory, and
    launches; each call launches its kernel once, runs nothing plain and
    matches the plain twin in float64 at 1, G + 1 and 37 lanes (eepos and
    deepos on every EE of the robot and on some of them; minv dense and the
    upper factor, +0 below its diagonal)."""
    m = build_model(topo(robot), dtype=torch.float64, device=cuda_device)
    crba_lanes = 16 if m.n in (2, 7, 12) else 32
    for what in ("fd", "eepos", "minv", "crba", "deepos"):
        for dtype in (torch.float32, torch.float64):
            info = build.warp_kernel_info(what, m.n, dtype)
            assert info["knots_per_block"] >= 1 and info["blocks_per_sm"] >= 1
            assert info["threads_per_knot"] == {
                "eepos": 8, "deepos": 4, "crba": crba_lanes}.get(what, 32)
            item = torch.finfo(dtype).bits // 8
            assert info["local_bytes"] < 36 * m.n * item
    cases_of = ("fd", "eepos", "minv", "minv_upper", "crba", "deepos") + (
        ("eepos_targets", "deepos_targets") if TARGETS[robot] else ())
    for case in cases_of:
        kernel = KERNEL_OF.get(case, case)
        g = build.plan(kernel, m.n, torch.float64)["knots_per_block"]
        for lanes in (1, g + 1, 37):
            args = grid_inputs(m, robot, lanes, seed=16)[case]
            kern, plain = WRAPPERS[case]
            build.reset_counters()
            got = _outs(kern(*args))
            torch.cuda.synchronize()
            assert dict(build.LAUNCHES) == {kernel: 1}
            assert not build.PLAIN_CALLS
            want = _outs(plain(*args))
            assert got[0].is_cuda and got[0].shape == want[0].shape
            assert _max_err(got, want) <= tol(robot, want)
            if case == "minv_upper":   # +0 below the diagonal
                lo = got[0].permute(2, 0, 1).tril(-1)
                assert not lo.any() and not bool(torch.signbit(lo).any())


# each GRiD method, the kernel it launches and its number of inputs
GRID_CALLS = {"id": ("rnea", 3), "id_du": ("id_du", 3), "aba": ("aba", 3),
              "fd_du": ("fd_du", 3), "minv": ("minv", 1), "fd": ("fd", 3),
              "crba": ("crba", 1), "eepos": ("eepos", 1),
              "deepos": ("deepos", 1), "d2eepos": ("d2eepos", 1),
              "idsva_so": ("idsva_so", 3), "fdsva_so": ("fdsva_so", 3)}


@pytest.mark.cuda
def test_cuda_grid_launches_one_kernel_per_call(cuda_device):
    """Each GRiD method launches exactly its kernel, unbatched and at a
    ragged B, and matches the plain GRiD on the same inputs (float64)."""
    g = GRiD("iiwa", dtype=torch.float64, device=cuda_device)
    plain = GRiD("iiwa", dtype=torch.float64, device=cuda_device,
                 use_kernels=False)
    rng = np.random.default_rng(4)
    for shape in ((7,), (37, 7)):
        x = [rng.uniform(-1, 1, shape) for _ in range(3)]
        for method, (kernel, nargs) in GRID_CALLS.items():
            build.reset_counters()
            got = getattr(g, method)(*x[:nargs])
            torch.cuda.synchronize()
            assert dict(build.LAUNCHES) == {kernel: 1}, method
            assert not build.PLAIN_CALLS
            want = getattr(plain, method)(*x[:nargs])
            assert build.PLAIN_CALLS[kernel] == 1
            assert got.is_cuda and got.shape == want.shape
            assert _max_err((got,), (want,)) <= TOL
    # 4 joints: its library built at first use
    build.reset_counters()
    tau = GRiD("pendulum4", device=cuda_device).id(np.zeros(4), np.zeros(4))
    assert tau.shape == (4,) and dict(build.LAUNCHES) == {"rnea": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("robot", ["gym_humanoid", "atlas"])
def test_cuda_grid_on_the_humanoids(cuda_device, robot):
    """GRiD on the 17- and 28-joint instances: each method launches exactly
    its kernel, unbatched and at a ragged B, and matches the plain GRiD
    (float64); fdsva_so on its composed route (at 28 joints, and at 17 if
    that route is the faster there) launches fd_du and idsva_so."""
    g = GRiD(robot, dtype=torch.float64, device=cuda_device)
    plain = GRiD(robot, dtype=torch.float64, device=cuda_device,
                 use_kernels=False)
    n = g.num_vel
    composed = K.fdsva_so_route(n, torch.float64) == K.COMPOSED
    assert composed or n < 28
    rng = np.random.default_rng(4)
    for shape in ((n,), (37, n)):
        x = [rng.uniform(-1, 1, shape) for _ in range(3)]
        for method, (kernel, nargs) in GRID_CALLS.items():
            build.reset_counters()
            got = getattr(g, method)(*x[:nargs])
            torch.cuda.synchronize()
            want_launch = ({"fd_du": 1, "idsva_so": 1}
                           if kernel == "fdsva_so" and composed
                           else {kernel: 1})
            assert dict(build.LAUNCHES) == want_launch, method
            assert not build.PLAIN_CALLS
            want = getattr(plain, method)(*x[:nargs])
            assert got.is_cuda and got.shape == want.shape
            tol = TOL * max(1.0, float(want.abs().max()))
            assert _max_err((got,), (want,)) <= tol, method


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_so_kernels_on_a_28_joint_knot(cuda_device, dtype):
    """At 28 joints (atlas) idsva_so runs its tile in bands (2 in float32,
    5 in float64, a band a block) and fdsva_so the composed route (fd_du,
    idsva_so, the contractions): both match their plain twins at 37 lanes
    (a ragged block), float64 within 1e-9 of the output's scale, float32
    within 1e-4 of a float64 plain run's scale."""
    m = build_model(load_robot("atlas"), dtype=torch.float64,
                    device=cuda_device)
    info = build.warp_kernel_info("idsva_so", 28, dtype)
    assert info["knots_per_block"] >= 1
    assert info["bands"] == (2 if dtype == torch.float32 else 5)
    assert build.warp_kernel_info("fdsva_so", 28,
                                  dtype)["knots_per_block"] == 0
    assert K.fdsva_so_route(28, dtype) == K.COMPOSED
    args = grid_inputs(m, "atlas", 37, seed=3)["fd_du"]
    mk = m.to(dtype=dtype)
    ak = (mk,) + tuple(a.to(dtype) for a in args[1:4]) + (args[4],)
    for name, launches in (("idsva_so", {"idsva_so": 1}),
                           ("fdsva_so", {"fd_du": 1, "idsva_so": 1})):
        build.reset_counters()
        got = getattr(K, name)(*ak)
        torch.cuda.synchronize()
        assert dict(build.LAUNCHES) == launches and not build.PLAIN_CALLS
        want = getattr(K, name + "_plain")(*args)
        scale = max(1.0, float(want.abs().max()))
        rel = 1e-9 if dtype == torch.float64 else 1e-4
        assert got.dtype == dtype and got.shape == want.shape
        assert float((got.double() - want).abs().max()) <= rel * scale


@pytest.mark.cuda
@pytest.mark.parametrize("robot", ["gym_humanoid", "atlas"])
def test_cuda_scenario_step_launches_the_path_kernels(cuda_device, robot):
    """Config 5's scenario step at S = 64 (N = 8, 2 iterations, QuadCost,
    float64) launches the rollout once and fd_du, the stationary riccati
    and the line search each iteration, runs no plain version, and matches
    the plain step (u0, U_next, costs within 1e-8 of their scale); a
    closed-loop period adds one aba launch."""
    from gridcodegenerator_tpu_torch.parallel.scenario import (
        ScenarioMPCConfig, closed_loop, make_scenario_step)
    m = build_model(topo(robot), dtype=torch.float64,
                    device=cuda_device)
    n, S = m.n, 64
    full = lambda v, k: torch.full((k,), v, dtype=torch.float64,
                                   device=cuda_device)
    xg = full(0.0, 2 * n)
    xg[0] = 0.2
    cost = QuadCost(Q=full(0.1, 2 * n), R=full(1e-3, n),
                    Qf=full(10.0, 2 * n), x_goal=xg)
    dt = DT.get(robot, 0.01)
    x0s = torch.as_tensor(0.02 * np.random.default_rng(0).standard_normal(
        (2 * n, S)), device=cuda_device)
    U = torch.zeros((8, n, S), dtype=torch.float64, device=cuda_device)
    outs = {}
    for use_kernels in (True, False):
        cfg = ScenarioMPCConfig(ILQRConfig(N=8, dt=dt, iters=2,
                                           use_kernels=use_kernels), S)
        build.reset_counters()
        outs[use_kernels] = make_scenario_step(m, cost, cfg)(x0s, U)
        torch.cuda.synchronize()
        if use_kernels:
            assert dict(build.LAUNCHES) == {
                "rollout": 1, "fd_du": 2, "riccati": 2,
                "linesearch_rollout": 2}
            assert not build.PLAIN_CALLS
    for got, want in zip(outs[True], outs[False]):
        assert got.shape == want.shape
        tol = 1e-8 * max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= tol
    cfg = ScenarioMPCConfig(ILQRConfig(N=8, dt=dt, iters=2), S)
    build.reset_counters()
    xs, us = closed_loop(m, cost, cfg, torch.zeros(2 * n, dtype=torch.float64,
                                                   device=cuda_device), 1)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {"rollout": 1, "fd_du": 2, "riccati": 2,
                                    "linesearch_rollout": 2, "aba": 1}
    assert xs.shape == (2, 2 * n) and bool(torch.isfinite(xs).all())


@pytest.mark.cuda
@pytest.mark.parametrize("robot", ["iiwa", "hyq"])
def test_cuda_sqp_and_quad_ilqr_launch_every_kernel(cuda_device, robot):
    """SQP (config 4's path) and first-order QuadCost iLQR on the card
    launch their kernels, run no plain version, and match plain solves:
    iLQR within 1e-8; SQP within 1e-6 of the cost scale, since its
    exact-Hessian sweep amplifies rounding (on the CPU, scaling the plain
    second-order tensors by 1 + 1e-12 moves hyq's cost trace here by
    2.4e-8 of its scale)."""
    m = build_model(topo(robot), dtype=torch.float64,
                    device=cuda_device)
    n = m.n
    xg = torch.zeros(2 * n, dtype=torch.float64, device=cuda_device)
    xg[0] = 0.5
    full = lambda v, k: torch.full((k,), v, dtype=torch.float64,
                                   device=cuda_device)
    cost = QuadCost(Q=full(0.1, 2 * n), R=full(1e-3, n),
                    Qf=full(100.0, 2 * n), x_goal=xg)
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(-0.2, 0.2,
                                                          (2 * n, 33)),
                         device=cuda_device)
    U0 = torch.zeros((6, n, 33), dtype=torch.float64, device=cuda_device)
    for make, cfg, second in ((make_sqp, SQPConfig, "fdsva_so"),
                              (make_ilqr, ILQRConfig, "riccati")):
        build.reset_counters()
        res = make(m, cost, cfg(N=6, iters=2, use_kernels=True))(x0, U0)
        torch.cuda.synchronize()
        assert dict(build.LAUNCHES) == {"rollout": 1, "fd_du": 2, second: 2,
                                        "linesearch_rollout": 2}
        assert not build.PLAIN_CALLS
        ref = make(m, cost, cfg(N=6, iters=2, use_kernels=False))(x0, U0)
        tol = (1e-6 * float(ref.cost_trace.abs().max())
               if make is make_sqp else 1e-8)
        assert float((res.cost_trace - ref.cost_trace).abs().max()) <= tol


@pytest.mark.cuda
def test_cuda_gloo_collectives_stage_through_the_host(cuda_device,
                                                      tmp_path):
    """Two gloo ranks on the one card: psum, ppermute and all_gather on
    CUDA tensors give the host-side results, return CUDA tensors and
    count every byte copied to and from host memory; NCCL over ranks that
    share the card raises."""
    import torch_rank_tasks as tasks
    from gridcodegenerator_tpu_torch.parallel.launch import RankGroup
    with RankGroup(2, f"file://{tmp_path / 'store'}", "gloo",
                   timeout_s=120) as group:
        got = group.run(tasks.cuda_collectives_probe)
    for rank, res in enumerate(got):
        assert res["on_card"] and res["nccl_refused"]
        np.testing.assert_array_equal(res["psum"], [3.0, 30.0])
        np.testing.assert_array_equal(res["all_gather"],
                                      [[1.0, 10.0], [2.0, 20.0]])
        # 16 bytes each way for psum, 16 out and 32 back for all_gather;
        # ppermute: rank 1 sends x and 2x (32 bytes), rank 0 takes them
        assert res["staged"] == {"psum": 32, "all_gather": 48,
                                 "ppermute": 32}
        if rank == 0:
            np.testing.assert_array_equal(res["ppermute"],
                                          [[2.0, 20.0], [4.0, 40.0]])
        else:
            assert res["ppermute"] is None
