"""The port's SQP (exact-Hessian DDP) and first-order QuadCost iLQR against
the JAX solvers (CPU, float64).

Bench config 4's task at a small size: ``QuadCost`` with x_goal[0] = 0.5,
Q 0.1, R 1e-3, Qf 100, N=4 knots, B=2 problems, 2 iterations, x0 ~ U(-0.2,
0.2). The JAX solvers run their XLA path on the CPU; the port runs its plain
versions (CPU tensors). cost_trace, X and U must agree within 1e-8.

On pendulum2 the JAX ``make_sqp`` solve runs whole, jitted. On iiwa, jitting
it traces the unrolled 7-joint FDSVA-SO into the solve and compiles for many
minutes on the CPU, so the reference there is the JAX solver's own phases
(``make_ilqr(..., expose_parts=True)``), composed as its ``solve`` composes
them, with the FDSVA-SO tensors from ``ops.so.fdsva_so`` run eagerly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridcodegenerator_tpu.models.model import build_model as jax_build_model
from gridcodegenerator_tpu.models.zoo import load_robot as jax_load_robot
from gridcodegenerator_tpu.ops import so as jax_so
from gridcodegenerator_tpu.trajopt.cost import QuadCost as JaxQuadCost
from gridcodegenerator_tpu.trajopt.ilqr import ILQRConfig as JaxILQRConfig
from gridcodegenerator_tpu.trajopt.ilqr import make_ilqr as jax_make_ilqr
from gridcodegenerator_tpu.trajopt.sqp import SQPConfig as JaxSQPConfig
from gridcodegenerator_tpu.trajopt.sqp import make_sqp as jax_make_sqp
from gridcodegenerator_tpu_torch.models.model import (ARRAY_FIELDS,
                                                       STATIC_FIELDS,
                                                       build_model,
                                                       model_from_numpy)
from gridcodegenerator_tpu_torch.models.zoo import load_robot
from gridcodegenerator_tpu_torch.ops.cuda import build
from gridcodegenerator_tpu_torch.ops.cuda import kernels as K
from gridcodegenerator_tpu_torch.trajopt.cost import QuadCost
from gridcodegenerator_tpu_torch.trajopt.ilqr import ILQRConfig, make_ilqr
from gridcodegenerator_tpu_torch.trajopt.sqp import SQPConfig, make_sqp

torch.set_num_threads(1)
N, B, ITERS = 4, 2, 2
ATOL = 1e-8


def problem(robot, dtype=np.float64):
    jm = jax_build_model(jax_load_robot(robot), dtype=jnp.dtype(dtype))
    tm = model_from_numpy({f: np.asarray(getattr(jm, f)) for f in ARRAY_FIELDS},
                          {f: getattr(jm, f) for f in STATIC_FIELDS},
                          device="cpu")
    n = jm.n
    w = dict(Q=np.full(2 * n, 0.1), R=np.full(n, 1e-3),
             Qf=np.full(2 * n, 100.0), x_goal=np.zeros(2 * n))
    w["x_goal"][0] = 0.5
    w = {k: v.astype(dtype) for k, v in w.items()}
    jcost = JaxQuadCost(**{k: jnp.asarray(v) for k, v in w.items()})
    tcost = QuadCost(**{k: torch.as_tensor(v) for k, v in w.items()})
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-0.2, 0.2, (2 * n, B))
    U0 = np.zeros((N, n, B))
    return jm, tm, jcost, tcost, x0, U0


def jax_solve_by_parts(jm, jcost, cfg, x0, U0):
    """The JAX solver's iterations from its exposed phases, with eager
    FDSVA-SO tensors (see the module docstring)."""
    _, parts = jax_make_ilqr(jm, jcost, cfg, expose_parts=True)
    X = parts["rollout"](x0, U0)
    U, c = U0, parts["total_cost"](X, U0)
    trace = [c]
    for _ in range(cfg.iters):
        Amat, Bmat, (qf, qdf, uf) = parts["linearize"](X[:cfg.N], U)
        so_flat = jax_so.fdsva_so(jm, qf, qdf, uf, cfg.gravity)
        so_t = tuple(so_flat[i] for i in range(4))
        ks, Ks = parts["backward"](X, U, Amat, Bmat, so_t)
        Xn, Un, cn = parts["forward"](X, U, ks, Ks)
        acc = cn < c
        X = jnp.where(acc[None, None, :], Xn, X)
        U = jnp.where(acc[None, None, :], Un, U)
        c = jnp.where(acc, cn, c)
        trace.append(c)
    return dict(X=X, U=U, cost_trace=jnp.stack(trace))


def _check(res, ref):
    for f in ("cost_trace", "X", "U"):
        np.testing.assert_allclose(getattr(res, f).numpy(),
                                   np.asarray(ref[f]), rtol=0, atol=ATOL,
                                   err_msg=f)
    tr = res.cost_trace.numpy()
    assert (np.diff(tr, axis=0) <= 0).all() and (tr[-1] < tr[0]).all()


@pytest.mark.parametrize("robot", ["pendulum2", "iiwa"])
def test_sqp_matches_jax(robot):
    jm, tm, jcost, tcost, x0, U0 = problem(robot)
    jcfg = JaxSQPConfig(N=N, iters=ITERS)
    if robot == "pendulum2":
        r = jax.jit(jax_make_sqp(jm, jcost, jcfg))(jnp.asarray(x0),
                                                   jnp.asarray(U0))
        ref = dict(X=r.X, U=r.U, cost_trace=r.cost_trace)
    else:
        ref = jax_solve_by_parts(jm, jcost, jcfg, jnp.asarray(x0),
                                 jnp.asarray(U0))
    build.reset_counters()
    res = make_sqp(tm, tcost, SQPConfig(N=N, iters=ITERS))(
        torch.as_tensor(x0), torch.as_tensor(U0))
    # CPU tensors: the plain versions ran; the DDP backward is plain torch
    # and calls no kernel wrapper
    assert dict(build.PLAIN_CALLS) == {"rollout": 1, "fd_du": ITERS,
                                       "fdsva_so": ITERS,
                                       "linesearch_rollout": ITERS}
    assert not build.LAUNCHES
    _check(res, ref)


@pytest.mark.parametrize("robot", ["pendulum2", "iiwa"])
def test_quad_ilqr_matches_jax(robot):
    """First order: the stationary-curvature Riccati sweep."""
    jm, tm, jcost, tcost, x0, U0 = problem(robot)
    r = jax.jit(jax_make_ilqr(jm, jcost, JaxILQRConfig(N=N, iters=ITERS)))(
        jnp.asarray(x0), jnp.asarray(U0))
    build.reset_counters()
    res = make_ilqr(tm, tcost, ILQRConfig(N=N, iters=ITERS))(
        torch.as_tensor(x0), torch.as_tensor(U0))
    assert dict(build.PLAIN_CALLS) == {"rollout": 1, "fd_du": ITERS,
                                       "riccati": ITERS,
                                       "linesearch_rollout": ITERS}
    _check(res, dict(X=r.X, U=r.U, cost_trace=r.cost_trace))


@pytest.mark.parametrize("bound", [5.1, 20.3])
def test_quad_ilqr_keeps_scalar_bounds_exact(bound):
    """Scalar control bounds that bind stay exact in float64, as the JAX
    solver keeps a Python scalar: rounded through float32 they move U by
    ~1e-7 on pendulum2."""
    jm, tm, jcost, tcost, x0, U0 = problem("pendulum2")
    r = jax.jit(jax_make_ilqr(jm, jcost, JaxILQRConfig(
        N=N, iters=ITERS, u_min=-bound, u_max=bound)))(jnp.asarray(x0),
                                                       jnp.asarray(U0))
    res = make_ilqr(tm, tcost, ILQRConfig(N=N, iters=ITERS, u_min=-bound,
                                          u_max=bound, use_kernels=False))(
        torch.as_tensor(x0), torch.as_tensor(U0))
    assert float(res.U.abs().max()) == bound   # the bound binds
    for f in ("cost_trace", "U"):
        np.testing.assert_allclose(getattr(res, f).numpy(),
                                   np.asarray(getattr(r, f)), rtol=0,
                                   atol=ATOL, err_msg=f)


def test_sqp_parts_and_refusals():
    _, tm, _, tcost, x0, U0 = problem("pendulum2")
    solve, parts = make_sqp(tm, tcost, SQPConfig(N=N, iters=1),
                            expose_parts=True)
    x0t, U0t = torch.as_tensor(x0), torch.as_tensor(U0)
    X = parts["rollout"](x0t, U0t)
    A, Bm = parts["linearize"](X[:N], U0t)
    so_flat = parts["second_order"](X, U0t)
    assert so_flat.shape == (4, 2, 2, 2, N * B)
    ks, Ks = parts["backward"](X, U0t, A, Bm, so_flat)
    _, _, cn = parts["forward"](X, U0t, ks, Ks)
    c0 = parts["total_cost"](X, U0t)
    res = solve(x0t, U0t)
    np.testing.assert_allclose(res.cost_trace[1].numpy(),
                               torch.minimum(cn, c0).numpy(), atol=1e-12)
    with pytest.raises(ValueError):
        make_sqp(tm, tcost, SQPConfig(N=N, use_second_order=False))
    # per-problem goals run (at one step size, as in the JAX solver): the
    # shared goal given to each problem solves as the shared goal does
    per_problem = QuadCost(Q=tcost.Q, R=tcost.R, Qf=tcost.Qf,
                           x_goal=tcost.x_goal[:, None].repeat(1, B))
    assert not per_problem.time_invariant
    one = SQPConfig(N=N, iters=1, alphas=(1.0,))
    a, b = (make_sqp(tm, c, one)(x0t, U0t) for c in (per_problem, tcost))
    np.testing.assert_allclose(a.cost_trace.numpy(), b.cost_trace.numpy(),
                               rtol=0, atol=1e-12)

    class PerKnotCurvature(QuadCost):
        stationary_curvature = False

    per_knot = PerKnotCurvature(Q=tcost.Q, R=tcost.R, Qf=tcost.Qf,
                                x_goal=tcost.x_goal)
    # first order with a per-knot curvature runs the stacked riccati and
    # solves as the stationary block does
    build.reset_counters()
    a = make_ilqr(tm, per_knot, ILQRConfig(N=N, iters=1))(x0t, U0t)
    assert build.PLAIN_CALLS["riccati"] == 1
    b = make_ilqr(tm, tcost, ILQRConfig(N=N, iters=1))(x0t, U0t)
    for f in ("cost_trace", "X", "U"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    make_sqp(tm, per_knot, SQPConfig(N=N))     # the DDP sweep reads any


def test_sqp_amplifies_rounding_of_the_second_order_tensors(monkeypatch):
    """Why solves of the exact-Hessian sweep are compared within a share of
    their cost scale on the card: in float64, scaling the second-order
    tensors by 1 + 1e-12 moves hyq's SQP cost trace (N=6, B=33, 2
    iterations) by ~2.4e-8 of its scale; the first-order QuadCost solve,
    which does not read them, does not move."""
    m = build_model(load_robot("hyq"), dtype=torch.float64, device="cpu")
    n = m.n
    xg = torch.zeros(2 * n, dtype=torch.float64)
    xg[0] = 0.5
    full = lambda v, k: torch.full((k,), v, dtype=torch.float64)
    cost = QuadCost(Q=full(0.1, 2 * n), R=full(1e-3, n),
                    Qf=full(100.0, 2 * n), x_goal=xg)
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(-0.2, 0.2,
                                                          (2 * n, 33)))
    U0 = torch.zeros((6, n, 33), dtype=torch.float64)
    moved = {}
    for make, cfg in ((make_sqp, SQPConfig), (make_ilqr, ILQRConfig)):
        ref = make(m, cost, cfg(N=6, iters=2))(x0, U0).cost_trace
        plain = K.fdsva_so_plain
        with monkeypatch.context() as mp:
            mp.setattr(K, "fdsva_so_plain", lambda *a: plain(*a) * (1 + 1e-12))
            got = make(m, cost, cfg(N=6, iters=2))(x0, U0).cost_trace
        moved[make] = float((got - ref).abs().max() / ref.abs().max())
    assert 1e-10 < moved[make_sqp] < 1e-6
    assert moved[make_ilqr] == 0.0


def config4_float32_agreement(robot, problems, iters=4, n_knots=32):
    """Bench config 4's task (QuadCost, N=32, 4 iterations, x0 ~ U(-0.2,
    0.2) from bench.py's default_rng(0), rounded to float32) on its first
    ``problems`` problems, solved in float32 and float64 by the JAX solver
    (its phases composed, eager FDSVA-SO) and by the port's plain solver:
    for each, the share of problems whose float32 final cost lies within
    rel 1e-3 of its float64 one, and the median rel. difference."""
    rng = np.random.default_rng(0)
    x0 = {r: rng.uniform(-0.2, 0.2, (2 * n, b))
          for r, n, b in (("iiwa", 7, 1024), ("hyq", 12, 512))}[robot]
    x0 = x0[:, :problems].astype(np.float32)
    final = {}
    for dtype in (np.float32, np.float64):
        jm, tm, jcost, tcost, _, _ = problem(robot, dtype)
        U0 = np.zeros((n_knots, jm.n, problems), dtype)
        cfg = JaxSQPConfig(N=n_knots, iters=iters)
        final["jax", dtype] = np.asarray(jax_solve_by_parts(
            jm, jcost, cfg, jnp.asarray(x0, dtype), jnp.asarray(U0))[
                "cost_trace"][-1], np.float64)
        final["port", dtype] = make_sqp(tm, tcost, SQPConfig(
            N=n_knots, iters=iters))(torch.as_tensor(x0.astype(dtype)),
                                     torch.as_tensor(U0)).cost.double().numpy()
    out = {}
    for who in ("jax", "port"):
        rel = (np.abs(final[who, np.float32] - final[who, np.float64])
               / np.abs(final[who, np.float64]))
        out[who] = {"share_rel_1e-3": float((rel <= 1e-3).mean()),
                    "median_rel": float(np.median(rel))}
    return out


def config4_float64_sensitivity(robot, problems, eps, iters=4, n_knots=32):
    """How far rounding-sized changes of the second-order tensors move the
    port's float64 plain SQP on config 4's task (as above): the cost trace
    with fdsva_so's output scaled by 1 + ``eps`` against the unscaled one,
    as the largest first-iteration difference over the cost scale, and per
    iteration the share of problems within rel 1e-3."""
    _, tm, _, tcost, _, _ = problem(robot)
    rng = np.random.default_rng(0)
    x0 = {r: rng.uniform(-0.2, 0.2, (2 * n, b))
          for r, n, b in (("iiwa", 7, 1024), ("hyq", 12, 512))}[robot]
    x0 = torch.as_tensor(x0[:, :problems].astype(np.float32),
                         dtype=torch.float64)
    U0 = torch.zeros((n_knots, tm.n, problems), dtype=torch.float64)
    solve = lambda: make_sqp(tm, tcost, SQPConfig(N=n_knots, iters=iters))(
        x0, U0).cost_trace
    ref = solve()
    plain = K.fdsva_so_plain
    try:
        K.fdsva_so_plain = lambda *a: plain(*a) * (1 + eps)
        got = solve()
    finally:
        K.fdsva_so_plain = plain
    rel = (got - ref).abs() / ref.abs()
    return {"eps": eps,
            "iter1_max_abs_over_scale": float((got - ref)[1].abs().max()
                                              / ref.abs().max()),
            "share_rel_1e-3_per_iter": [float(x) for x in
                                        (rel <= 1e-3).double().mean(1)]}


if __name__ == "__main__":
    import json
    import sys

    # PYTHONPATH=. python tests/test_torch_sqp.py [problems], from the root
    # of the repo: config4_float64_sensitivity and config4_float32_agreement
    # on the CPU for iiwa and hyq (minutes per robot at 64 problems, most of
    # it the JAX package's eager FDSVA-SO)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    count = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    for robot in ("iiwa", "hyq"):
        print(json.dumps({"robot": robot, "problems": count, "sensitivity": [
            config4_float64_sensitivity(robot, count, eps)
            for eps in (1e-15, 1e-13)]}), flush=True)
        print(json.dumps({"robot": robot, "problems": count}
                         | config4_float32_agreement(robot, count)),
              flush=True)
