"""The port's dynamics_step and MPC against the JAX package (CPU, float64).

* ``trajopt/ilqr.py:dynamics_step`` (one semi-implicit Euler step of ABA)
  on pendulum2, iiwa and gym_humanoid: within 1e-10.
* ``trajopt/mpc.py:MPC``: ``replan`` (the solve, its first control and the
  shifted warm start U[1:] ++ U[-1:]) and ``rollout_closed_loop`` on
  pendulum2 and iiwa, bench config 5's QuadCost (Q 0.1, R 1e-3, Qf 10,
  x_goal[0] 0.2), N=4, 2 iterations: within 1e-8, as the solvers are held
  in ``tests/test_torch_ilqr.py``.
* gym_humanoid's Euler step at bench config 5's dt = 0.01 leaves the finite
  numbers within 16 knots from x0 ~ 0.02 N(0, 1), in the JAX reference too;
  at dt 0.002 neither does.

The JAX side runs on the CPU (its XLA path); the port runs its plain
versions (CPU tensors). Both take the same numpy inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridcodegenerator_tpu.models.model import build_model as jax_build_model
from gridcodegenerator_tpu.models.zoo import load_robot as jax_load_robot
from gridcodegenerator_tpu.trajopt.cost import QuadCost as JaxQuadCost
from gridcodegenerator_tpu.trajopt.ilqr import ILQRConfig as JaxILQRConfig
from gridcodegenerator_tpu.trajopt.ilqr import \
    dynamics_step as jax_dynamics_step
from gridcodegenerator_tpu.trajopt.mpc import MPC as JaxMPC
from gridcodegenerator_tpu_torch.models.model import (ARRAY_FIELDS,
                                                       STATIC_FIELDS,
                                                       model_from_numpy)
from gridcodegenerator_tpu_torch.ops.cuda import build
from gridcodegenerator_tpu_torch.trajopt.cost import QuadCost
from gridcodegenerator_tpu_torch.trajopt.ilqr import (ILQRConfig,
                                                      dynamics_step)
from gridcodegenerator_tpu_torch.trajopt.mpc import MPC

torch.set_num_threads(1)
GRAV = -9.81
N, B, ITERS = 4, 3, 2


def models(robot):
    jm = jax_build_model(jax_load_robot(robot), dtype=jnp.float64)
    tm = model_from_numpy({f: np.asarray(getattr(jm, f)) for f in ARRAY_FIELDS},
                          {f: getattr(jm, f) for f in STATIC_FIELDS},
                          device="cpu")
    return jm, tm


def config5_costs(n):
    """bench.py config 5's QuadCost, for both packages."""
    w = dict(Q=np.full(2 * n, 0.1), R=np.full(n, 1e-3),
             Qf=np.full(2 * n, 10.0), x_goal=np.zeros(2 * n))
    w["x_goal"][0] = 0.2
    return (JaxQuadCost(**{k: jnp.asarray(v) for k, v in w.items()}),
            QuadCost(**{k: torch.as_tensor(v) for k, v in w.items()}))


def _close(ours, ref, atol):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("robot", ["pendulum2", "iiwa", "gym_humanoid"])
def test_dynamics_step_matches_jax(robot):
    jm, tm = models(robot)
    n = jm.n
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.5, 0.5, (2 * n, 5))
    u = rng.uniform(-2, 2, (n, 5))
    ref = jax_dynamics_step(jm, jnp.asarray(x), jnp.asarray(u), 0.01, GRAV)
    build.reset_counters()
    got = dynamics_step(tm, torch.as_tensor(x), torch.as_tensor(u), 0.01,
                        GRAV)
    # a CPU tensor: the aba wrapper's plain version, no kernel
    assert dict(build.PLAIN_CALLS) == {"aba": 1} and not build.LAUNCHES
    assert got.shape == (2 * n, 5)
    _close(got, ref, 1e-10)


@pytest.mark.parametrize("dt,finite", [(0.01, False), (0.002, True)])
def test_gym_humanoid_euler_step_diverges_at_0_01(dt, finite):
    """Config 5's gym_humanoid (bench.py:250-253, dt 0.01): from bench.py's
    scenario spread (x0 ~ 0.02 N(0, 1), U = 0) some rollouts of the JAX
    reference's dynamics_step and of the port's leave the finite numbers
    within 16 knots (which ones may differ where a rollout is on the edge:
    the finite ones reach ~1e300); at dt 0.002 every rollout of both stays
    bounded, and the two agree (1e-10)."""
    jm, tm = models("gym_humanoid")
    n = jm.n
    x0 = 0.02 * np.random.default_rng(0).standard_normal((2 * n, 64))
    u = np.zeros((n, 64))
    xj, xt = jnp.asarray(x0), torch.as_tensor(x0)
    with np.errstate(all="ignore"):
        for _ in range(16):
            xj = jax_dynamics_step(jm, xj, jnp.asarray(u), dt, GRAV)
            xt = dynamics_step(tm, xt, torch.as_tensor(u), dt, GRAV)
    fin_j = np.isfinite(np.asarray(xj)).all(axis=0)
    fin_t = np.isfinite(xt.numpy()).all(axis=0)
    if finite:
        assert fin_j.all() and fin_t.all()
        assert np.abs(np.asarray(xj)).max() < 10
        _close(xt, xj, 1e-10)
    else:
        assert not fin_j.all() and not fin_t.all()


@pytest.fixture(scope="module", params=["pendulum2", "iiwa"])
def mpc_pair(request):
    jm, tm = models(request.param)
    jcost, tcost = config5_costs(jm.n)
    jmpc = JaxMPC(jm, jcost, JaxILQRConfig(N=N, dt=0.01, iters=ITERS))
    tmpc = MPC(tm, tcost, ILQRConfig(N=N, dt=0.01, iters=ITERS))
    return jm.n, jmpc, tmpc


def test_mpc_replan_matches_jax(mpc_pair):
    n, jmpc, tmpc = mpc_pair
    rng = np.random.default_rng(2)
    x0 = 0.05 * rng.standard_normal((2 * n, B))
    U = rng.uniform(-1, 1, (N, n, B))
    ref = jmpc.replan(jnp.asarray(x0), jnp.asarray(U))
    build.reset_counters()
    got = tmpc.replan(torch.as_tensor(x0), torch.as_tensor(U))
    assert dict(build.PLAIN_CALLS) == {"rollout": 1, "fd_du": ITERS,
                                       "riccati": ITERS,
                                       "linesearch_rollout": ITERS}
    u0, U_next, cost = got
    assert u0.shape == (n, B) and U_next.shape == (N, n, B)
    # the warm start is the plan shifted one knot, its last knot repeated
    assert torch.equal(U_next[-1], U_next[-2])
    for ours, theirs in zip(got, ref):
        _close(ours, theirs, 1e-8)


def test_mpc_closed_loop_matches_jax(mpc_pair):
    n, jmpc, tmpc = mpc_pair
    x0 = 0.05 * np.random.default_rng(3).standard_normal((2 * n, B))
    ref = jmpc.rollout_closed_loop(jnp.asarray(x0), 3)
    build.reset_counters()
    got = tmpc.rollout_closed_loop(torch.as_tensor(x0), 3)
    # three periods: a solve each and one plant step (ABA) each
    assert build.PLAIN_CALLS["rollout"] == 3
    assert build.PLAIN_CALLS["aba"] == 3
    assert [t.shape for t in got] == [(4, 2 * n, B), (3, n, B), (3, B)]
    for ours, theirs in zip(got, ref):
        _close(ours, theirs, 1e-8)
    assert np.isfinite(got[0].numpy()).all()
