"""The port's iLQR slice against the JAX solver (CPU, float64).

Config 3's task at a small size: iiwa reaching an EE point with
``EEReachCost``, N=8 knots, B=4 problems, 2 iterations. The JAX solver runs
its XLA scan path on the CPU; the port runs its plain versions (CPU
tensors). cost_trace, X and U must agree within 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridcodegenerator_tpu.models.model import build_model as jax_build_model
from gridcodegenerator_tpu.models.zoo import load_robot as jax_load_robot
from gridcodegenerator_tpu.ops import eepose as jax_eepose
from gridcodegenerator_tpu.trajopt.cost import EEReachCost as JaxEEReachCost
from gridcodegenerator_tpu.trajopt.ilqr import ILQRConfig as JaxILQRConfig
from gridcodegenerator_tpu.trajopt.ilqr import make_ilqr as jax_make_ilqr
from gridcodegenerator_tpu_torch.models.model import (ARRAY_FIELDS,
                                                       STATIC_FIELDS,
                                                       build_model,
                                                       model_from_numpy)
from gridcodegenerator_tpu_torch.models.zoo import load_robot
from gridcodegenerator_tpu_torch.ops.cuda import build
from gridcodegenerator_tpu_torch.trajopt.cost import EEReachCost, QuadCost
from gridcodegenerator_tpu_torch.trajopt.ilqr import (ILQRConfig, make_ilqr,
                                                      resolve_control_bounds)

torch.set_num_threads(1)
N, B, ITERS = 8, 4, 2


@pytest.fixture(scope="module")
def problem():
    jm = jax_build_model(jax_load_robot("iiwa"), dtype=jnp.float64)
    tm = model_from_numpy({f: np.asarray(getattr(jm, f)) for f in ARRAY_FIELDS},
                          {f: getattr(jm, f) for f in STATIC_FIELDS},
                          device="cpu")
    n = jm.n
    goal = jax_eepose.eepos(jm, jnp.full((n, 1), 0.5, jnp.float64))[:3, 0]
    jcost = JaxEEReachCost(model=jm, goal_xyz=goal, w_pos=0.5, w_pos_f=200.0)
    tcost = EEReachCost(model=tm, goal_xyz=torch.as_tensor(np.array(goal)),
                        w_pos=0.5, w_pos_f=200.0)
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-0.2, 0.2, (2 * n, B))
    U0 = np.zeros((N, n, B))
    return jm, tm, jcost, tcost, x0, U0


def test_slice_matches_jax_solver(problem):
    jm, tm, jcost, tcost, x0, U0 = problem
    ref = jax.jit(jax_make_ilqr(jm, jcost, JaxILQRConfig(N=N, iters=ITERS)))(
        jnp.asarray(x0), jnp.asarray(U0))
    build.reset_counters()
    res = make_ilqr(tm, tcost, ILQRConfig(N=N, iters=ITERS))(
        torch.as_tensor(x0), torch.as_tensor(U0))
    # CPU tensors: every phase ran its plain version, the EE cost's pose
    # and Jacobian too, no kernel launched
    assert dict(build.PLAIN_CALLS) == {"rollout": 1, "fd_du": ITERS,
                                       "riccati_factored": ITERS,
                                       "linesearch_rollout": ITERS,
                                       "eepos": 2 + 2 * ITERS,
                                       "deepos": 2 * ITERS}
    assert not build.LAUNCHES
    for f in ("cost_trace", "X", "U"):
        np.testing.assert_allclose(getattr(res, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=1e-8, err_msg=f)
    tr = res.cost_trace.numpy()
    assert (tr[-1] < tr[0]).all()


def test_plain_flag_matches_default_on_cpu(problem):
    _, tm, _, tcost, x0, U0 = problem
    a = make_ilqr(tm, tcost, ILQRConfig(N=N, iters=1))(
        torch.as_tensor(x0), torch.as_tensor(U0))
    b = make_ilqr(tm, tcost, ILQRConfig(N=N, iters=1, use_kernels=False))(
        torch.as_tensor(x0), torch.as_tensor(U0))
    assert torch.equal(a.cost_trace, b.cost_trace)
    with pytest.raises(ValueError):   # kernels demanded on CPU tensors
        make_ilqr(tm, tcost, ILQRConfig(N=N, iters=1, use_kernels=True))(
            torch.as_tensor(x0), torch.as_tensor(U0))


def test_expose_parts_compose_one_iteration(problem):
    _, tm, _, tcost, x0, U0 = problem
    solve, parts = make_ilqr(tm, tcost, ILQRConfig(N=N, iters=1),
                             expose_parts=True)
    x0t, U0t = torch.as_tensor(x0), torch.as_tensor(U0)
    X = parts["rollout"](x0t, U0t)
    assert X.shape == (N + 1, 14, B)
    A, Bm = parts["linearize"](X[:N], U0t)
    assert A.shape == (N, 14, 14, B) and Bm.shape == (N, 14, 7, B)
    ks, Ks = parts["backward"](X, U0t, A, Bm)
    _, _, cn = parts["forward"](X, U0t, ks, Ks)
    c0 = parts["total_cost"](X, U0t)
    res = solve(x0t, U0t)
    np.testing.assert_allclose(res.cost_trace[1].numpy(),
                               torch.minimum(cn, c0).numpy(), atol=1e-12)


@pytest.mark.parametrize("flag", ["use_second_order", "parallel_riccati",
                                  "ls_two_stage", "knot_axis"])
def test_left_out_options_raise(problem, flag):
    _, tm, _, tcost, x0, U0 = problem
    if flag in ("use_second_order", "parallel_riccati"):
        # DDP with the EE cost is ported (its dense Gauss-Newton
        # expansion), and so is the associative-scan Riccati: each solves,
        # as the plain route does
        args = torch.as_tensor(x0), torch.as_tensor(U0)
        a, b = (make_ilqr(tm, tcost, ILQRConfig(
            N=N, iters=1, use_kernels=uk, **{flag: True}))(*args)
            for uk in (None, False))
        assert bool(torch.isfinite(a.cost_trace).all())
        assert (a.cost_trace[1] <= a.cost_trace[0]).all()
        for f in ("cost_trace", "X", "U"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        return
    if flag == "knot_axis":
        # the knot-sharded backward runs on a mesh (tests/
        # test_torch_knot_riccati.py); it raises where the JAX solver does,
        # and without a mesh that has the axis
        ko = dict(knot_axis="kp", knot_axis_size=2)
        per_problem = QuadCost(Q=torch.full((14,), 0.1),
                               R=torch.full((7,), 1e-3),
                               Qf=torch.full((14,), 10.0),
                               x_goal=torch.zeros((14, B)))
        for kw, c, err in ((dict(use_second_order=True), tcost,
                            NotImplementedError),
                           (dict(parallel_riccati=True), tcost,
                            NotImplementedError),
                           (dict(knot_axis_size=3), tcost, ValueError),
                           ({}, per_problem, NotImplementedError),
                           ({}, tcost, ValueError)):   # no mesh
            with pytest.raises(err):
                make_ilqr(tm, c, ILQRConfig(N=N, **(ko | kw)))
        # an axis of one rank is no split: the one-device solver
        make_ilqr(tm, tcost, ILQRConfig(N=N, knot_axis="kp"))
        return
    with pytest.raises(NotImplementedError):
        make_ilqr(tm, tcost, ILQRConfig(N=N, **{flag: True}))


def test_control_bounds_are_per_dof_effort_limits():
    m = build_model(load_robot("iiwa"), dtype=torch.float32, device="cpu")
    lo, hi = resolve_control_bounds(m, ILQRConfig())
    assert lo.shape == (7, 1) and hi.shape == (7, 1)
    assert torch.equal(hi, torch.full((7, 1), 300.0)) and torch.equal(lo, -hi)
    lo, hi = resolve_control_bounds(m, ILQRConfig(u_min=-2.0, u_max=3.0))
    assert torch.equal(lo, torch.full((7, 1), -2.0))
    p = build_model(load_robot("pendulum2"), dtype=torch.float32, device="cpu")
    assert resolve_control_bounds(p, ILQRConfig()) == (None, None)
