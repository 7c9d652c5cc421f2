"""The port's one-device scenario-tree MPC step against the JAX package's
(CPU, float64).

Bench config 5's task at a small size: ``QuadCost`` (Q 0.1, R 1e-3, Qf 10,
x_goal[0] 0.2), S=8 scenarios, N=4 knots, 2 iterations, on pendulum2 and
iiwa. The JAX step runs ``make_scenario_step`` on a one-device mesh
(``make_mesh(1)``: its psum and pmin reduce over one shard); the port's
runs one solve over all S scenarios as lanes (CPU tensors: the plain
versions). Both take the same numpy scenario states, since torch cannot
reproduce ``jax.random``: u0, U_next and the costs agree within 1e-8, on the
first step and on a second one warm-started with the first's U_next.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridcodegenerator_tpu.models.model import build_model as jax_build_model
from gridcodegenerator_tpu.models.zoo import load_robot as jax_load_robot
from gridcodegenerator_tpu.parallel.mesh import make_mesh
from gridcodegenerator_tpu.parallel.scenario import \
    ScenarioMPCConfig as JaxScenarioMPCConfig
from gridcodegenerator_tpu.parallel.scenario import \
    make_scenario_step as jax_make_scenario_step
from gridcodegenerator_tpu.trajopt.cost import QuadCost as JaxQuadCost
from gridcodegenerator_tpu.trajopt.ilqr import ILQRConfig as JaxILQRConfig
from gridcodegenerator_tpu_torch.models.model import (ARRAY_FIELDS,
                                                       STATIC_FIELDS,
                                                       model_from_numpy)
from gridcodegenerator_tpu_torch.ops.cuda import build
from gridcodegenerator_tpu_torch.parallel.scenario import (
    ScenarioMPCConfig, closed_loop, consensus, make_scenario_step,
    perturb_scenarios)
from gridcodegenerator_tpu_torch.trajopt.cost import QuadCost
from gridcodegenerator_tpu_torch.trajopt.ilqr import (ILQRConfig,
                                                      dynamics_step)

torch.set_num_threads(1)
S, N, ITERS = 8, 4, 2


def problem(robot):
    jm = jax_build_model(jax_load_robot(robot), dtype=jnp.float64)
    tm = model_from_numpy({f: np.asarray(getattr(jm, f)) for f in ARRAY_FIELDS},
                          {f: getattr(jm, f) for f in STATIC_FIELDS},
                          device="cpu")
    n = jm.n
    w = dict(Q=np.full(2 * n, 0.1), R=np.full(n, 1e-3),
             Qf=np.full(2 * n, 10.0), x_goal=np.zeros(2 * n))
    w["x_goal"][0] = 0.2
    jcost = JaxQuadCost(**{k: jnp.asarray(v) for k, v in w.items()})
    tcost = QuadCost(**{k: torch.as_tensor(v) for k, v in w.items()})
    return jm, tm, jcost, tcost


@pytest.mark.parametrize("robot", ["pendulum2", "iiwa"])
def test_scenario_step_matches_jax(robot):
    jm, tm, jcost, tcost = problem(robot)
    n = jm.n
    jstep = jax_make_scenario_step(
        jm, jcost, JaxScenarioMPCConfig(JaxILQRConfig(N=N, iters=ITERS), S),
        make_mesh(1))
    tstep = make_scenario_step(
        tm, tcost, ScenarioMPCConfig(ILQRConfig(N=N, iters=ITERS), S))
    rng = np.random.default_rng(0)
    U = np.zeros((N, n, S))
    Uj, Ut = jnp.asarray(U), torch.as_tensor(U)
    for _ in range(2):   # the second step warm-started by the first
        x0s = 0.02 * rng.standard_normal((2 * n, S))
        ref = jstep(jnp.asarray(x0s), Uj)
        build.reset_counters()
        got = tstep(torch.as_tensor(x0s), Ut)
        assert dict(build.PLAIN_CALLS) == {"rollout": 1, "fd_du": ITERS,
                                           "riccati": ITERS,
                                           "linesearch_rollout": ITERS}
        assert not build.LAUNCHES
        u0, Ut, costs = got
        assert u0.shape == (n,) and Ut.shape == (N, n, S)
        assert costs.shape == (S,)
        for ours, theirs in zip(got, ref):
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                       rtol=0, atol=1e-8)
        Uj = ref[1]


def test_consensus_is_the_softmin_weighted_mean():
    rng = np.random.default_rng(1)
    u0s, c = rng.standard_normal((3, 6)), rng.uniform(0, 5, 6)
    w = np.exp(-2.0 * (c - c.min()))
    want = (u0s * w).sum(axis=1) / w.sum()
    got = consensus(torch.as_tensor(u0s), torch.as_tensor(c), 2.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14)
    # the lowest cost dominates as the temperature grows
    got = consensus(torch.as_tensor(u0s), torch.as_tensor(c), 1e4)
    np.testing.assert_allclose(got.numpy(), u0s[:, c.argmin()], rtol=1e-12)


def test_perturb_scenarios_draws_from_the_generator():
    x0 = torch.linspace(-1, 1, 6, dtype=torch.float64)
    a = perturb_scenarios(torch.Generator().manual_seed(3), x0, 5, 0.02)
    b = perturb_scenarios(torch.Generator().manual_seed(3), x0, 5, 0.02)
    c = perturb_scenarios(torch.Generator().manual_seed(4), x0, 5, 0.02)
    assert a.shape == (6, 5) and a.dtype == torch.float64
    assert torch.equal(a, b) and not torch.equal(a, c)
    noise = torch.randn((6, 5), generator=torch.Generator().manual_seed(3),
                        dtype=torch.float64)
    assert torch.equal(a, x0[:, None] + 0.02 * noise)


def test_closed_loop_composes_the_step_and_the_plant():
    """closed_loop: each period perturbs the state into S scenarios, takes
    one scenario step warm-started by the last, and applies the consensus
    control through dynamics_step."""
    _, tm, _, tcost = problem("pendulum2")
    n = tm.n
    cfg = ScenarioMPCConfig(ILQRConfig(N=N, iters=ITERS), S)
    x0 = torch.tensor([0.1, -0.2, 0.0, 0.3], dtype=torch.float64)
    build.reset_counters()
    xs, us = closed_loop(tm, tcost, cfg, x0, 3,
                         torch.Generator().manual_seed(7))
    assert build.PLAIN_CALLS["aba"] == 3 and build.PLAIN_CALLS["rollout"] == 3
    assert xs.shape == (4, 2 * n) and us.shape == (3, n)
    gen = torch.Generator().manual_seed(7)
    step = make_scenario_step(tm, tcost, cfg)
    x, U = x0, torch.zeros((N, n, S), dtype=torch.float64)
    for t in range(3):
        u0, U, _ = step(perturb_scenarios(gen, x, S, 0.01), U)
        x = dynamics_step(tm, x[:, None], u0[:, None], cfg.ilqr.dt,
                          cfg.ilqr.gravity)[:, 0]
        assert torch.equal(us[t], u0) and torch.equal(xs[t + 1], x)


def test_a_mesh_is_not_ported():
    """The one-device step's refusals. A mesh runs now (tests/
    test_torch_mesh.py, with the mesh's own refusals); without one, a
    knot axis of more than one rank raises where the JAX solver raises, and
    without a mesh to provide it."""
    _, tm, _, tcost = problem("pendulum2")
    ko = dict(N=N, iters=ITERS, knot_axis="kp", knot_axis_size=2)
    for kw, err in ((dict(use_second_order=True), NotImplementedError),
                    (dict(parallel_riccati=True), NotImplementedError),
                    (dict(N=5), ValueError),
                    ({}, ValueError)):          # no mesh
        with pytest.raises(err):
            make_scenario_step(tm, tcost, ScenarioMPCConfig(
                ILQRConfig(**(ko | kw)), S))
    with pytest.raises(NotImplementedError):    # a time-varying cost
        per_problem = dataclasses.replace(
            tcost, x_goal=torch.zeros((4, S), dtype=torch.float64))
        make_scenario_step(tm, per_problem, ScenarioMPCConfig(
            ILQRConfig(**ko), S))
    step = make_scenario_step(tm, tcost, ScenarioMPCConfig(
        ILQRConfig(N=N, iters=ITERS), S))
    with pytest.raises(ValueError):   # S scenarios, not S - 1
        step(torch.zeros((4, S - 1), dtype=torch.float64),
             torch.zeros((N, 2, S - 1), dtype=torch.float64))
