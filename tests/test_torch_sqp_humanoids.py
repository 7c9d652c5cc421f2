"""The port's SQP (exact-Hessian DDP) on the humanoids against the JAX
solver (CPU, float64): gym_humanoid (17 joints) and atlas (28).

Bench config 4's task at a small size, as ``tests/test_torch_sqp.py`` holds
pendulum2 and iiwa: ``QuadCost`` with x_goal[0] = 0.5, Q 0.1, R 1e-3, Qf
100, N=4 knots, B=2 problems, 2 iterations, x0 ~ U(-0.2, 0.2); each robot
at its config-4 time step (``chip_smoke.py``: DT4). The port runs its plain
versions (CPU tensors); the JAX reference is its solver's phases
(``make_ilqr(..., expose_parts=True)``) composed as its ``solve`` composes
them, with eager FDSVA-SO tensors (jitting the JAX solve would trace the
unrolled 28-joint FDSVA-SO into it). cost_trace, X and U must agree within
1e-8.

The time step: from config 4's x0 (numpy ``default_rng(0)``, U(-0.2, 0.2),
B=512, U = 0) the JAX reference's Euler step stays finite over N=32 knots
on atlas at bench.py's 0.01, and on gym_humanoid only at 0.002.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridcodegenerator_tpu.models.model import build_model as jax_build_model
from gridcodegenerator_tpu.models.zoo import load_robot as jax_load_robot
from gridcodegenerator_tpu.ops import so as jax_so
from gridcodegenerator_tpu.trajopt.cost import QuadCost as JaxQuadCost
from gridcodegenerator_tpu.trajopt.ilqr import \
    dynamics_step as jax_dynamics_step
from gridcodegenerator_tpu.trajopt.ilqr import make_ilqr as jax_make_ilqr
from gridcodegenerator_tpu.trajopt.sqp import SQPConfig as JaxSQPConfig
from gridcodegenerator_tpu_torch.models.model import (ARRAY_FIELDS,
                                                       STATIC_FIELDS,
                                                       model_from_numpy)
from gridcodegenerator_tpu_torch.ops.cuda import build
from gridcodegenerator_tpu_torch.trajopt.cost import QuadCost
from gridcodegenerator_tpu_torch.trajopt.sqp import SQPConfig, make_sqp

torch.set_num_threads(1)
N, B, ITERS = 4, 2, 2
ATOL = 1e-8
# config 4's time step of each robot (chip_smoke.py: DT4)
DT = {"atlas": 0.01, "gym_humanoid": 0.002}
GRAV = -9.81


def problem(robot):
    jm = jax_build_model(jax_load_robot(robot), dtype=jnp.float64)
    tm = model_from_numpy({f: np.asarray(getattr(jm, f)) for f in ARRAY_FIELDS},
                          {f: getattr(jm, f) for f in STATIC_FIELDS},
                          device="cpu")
    n = jm.n
    w = dict(Q=np.full(2 * n, 0.1), R=np.full(n, 1e-3),
             Qf=np.full(2 * n, 100.0), x_goal=np.zeros(2 * n))
    w["x_goal"][0] = 0.5
    jcost = JaxQuadCost(**{k: jnp.asarray(v) for k, v in w.items()})
    tcost = QuadCost(**{k: torch.as_tensor(v) for k, v in w.items()})
    x0 = np.random.default_rng(0).uniform(-0.2, 0.2, (2 * n, B))
    return jm, tm, jcost, tcost, x0, np.zeros((N, n, B))


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
        ks, Ks = parts["backward"](X, U, Amat, Bmat,
                                   tuple(so_flat[i] for i in range(4)))
        Xn, Un, cn = parts["forward"](X, U, ks, Ks)
        acc = cn < c
        X = jnp.where(acc[None, None, :], Xn, X)
        U = jnp.where(acc[None, None, :], Un, U)
        c = jnp.where(acc, cn, c)
        trace.append(c)
    return dict(X=X, U=U, cost_trace=jnp.stack(trace))


@pytest.mark.parametrize("robot", ["gym_humanoid", "atlas"])
def test_sqp_matches_jax(robot):
    jm, tm, jcost, tcost, x0, U0 = problem(robot)
    ref = jax_solve_by_parts(jm, jcost, JaxSQPConfig(N=N, dt=DT[robot],
                                                     iters=ITERS),
                             jnp.asarray(x0), jnp.asarray(U0))
    build.reset_counters()
    res = make_sqp(tm, tcost, SQPConfig(N=N, dt=DT[robot], iters=ITERS))(
        torch.as_tensor(x0), torch.as_tensor(U0))
    # CPU tensors: the plain versions ran (fdsva_so's plain twin, whatever
    # route the card takes); the DDP backward is plain torch
    assert dict(build.PLAIN_CALLS) == {"rollout": 1, "fd_du": ITERS,
                                       "fdsva_so": ITERS,
                                       "linesearch_rollout": ITERS}
    assert not build.LAUNCHES
    for f in ("cost_trace", "X", "U"):
        np.testing.assert_allclose(getattr(res, f).numpy(),
                                   np.asarray(ref[f]), rtol=0, atol=ATOL,
                                   err_msg=f)
    tr = res.cost_trace.numpy()
    assert (np.diff(tr, axis=0) <= 0).all() and (tr[-1] < tr[0]).all()


@pytest.mark.parametrize("robot,dt,finite", [("atlas", 0.01, True),
                                             ("gym_humanoid", 0.01, False),
                                             ("gym_humanoid", 0.002, True)])
def test_config4_time_step_keeps_the_reference_finite(robot, dt, finite):
    """Config 4's rule for the time step (PERF.md section 4): the largest
    of 0.01 / 5^k at which the JAX reference's open-loop rollouts from
    config 4's x0 stay finite over its N=32 knots."""
    jm = jax_build_model(jax_load_robot(robot), dtype=jnp.float64)
    n = jm.n
    x = jnp.asarray(np.random.default_rng(0).uniform(-0.2, 0.2, (2 * n, 512)))
    u = jnp.zeros((n, 512))
    with np.errstate(all="ignore"):
        for _ in range(32):
            x = jax_dynamics_step(jm, x, u, dt, GRAV)
    assert bool(np.isfinite(np.asarray(x)).all()) == finite
