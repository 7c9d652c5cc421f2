"""The port's EE reach cost on the eepos and deepos routes (CPU, float64).

``EEReachCost`` takes its pose and Jacobian through the kernel wrappers
(``ops/cuda/kernels.py:eepos``, ``deepos``): on CPU tensors they run the
counted plain twins, so ``build.PLAIN_CALLS`` counts every EE call of the
cost, and a term that needs the error only (``stage``, ``terminal``) calls
the pose alone. ``make_ilqr(use_kernels=False)`` hands the cost the plain
twins. Each term equals the JAX cost's on the same inputs, and a small
config-3 solve (iiwa, N=4, B=3, 2 iterations) the JAX solver's within
1e-8.
"""

import dataclasses

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
                                                       model_from_numpy)
from gridcodegenerator_tpu_torch.ops.cuda import build
from gridcodegenerator_tpu_torch.ops.cuda import kernels as K
from gridcodegenerator_tpu_torch.trajopt.cost import EEReachCost
from gridcodegenerator_tpu_torch.trajopt.ilqr import ILQRConfig, make_ilqr

torch.set_num_threads(1)
N, B, ITERS = 4, 3, 2
# the EE calls of each cost term: the error alone, or the error and the
# Jacobian
CALLS = {"stage": {"eepos": 1}, "terminal": {"eepos": 1},
         "terminal_expansion": {"eepos": 1, "deepos": 1},
         "gn_stage_factor": {"eepos": 1, "deepos": 1}}


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
    rng = np.random.default_rng(7)
    x0 = rng.uniform(-0.2, 0.2, (2 * n, B))
    U0 = np.zeros((N, n, B))
    x = rng.uniform(-1, 1, (2 * n, 5))
    u = rng.uniform(-1, 1, (n, 5))
    return jm, tm, jcost, tcost, x0, U0, x, u


def _call(cost, method, x, u):
    if method in ("stage", "gn_stage_factor"):
        return getattr(cost, method)(x, u, 0)
    return getattr(cost, method)(x)


@pytest.mark.parametrize("method", list(CALLS))
def test_ee_cost_terms_count_their_plain_calls(problem, method):
    """On CPU tensors each term runs the counted plain twins: the pose alone
    where only the error is used, the pose and the Jacobian where the
    Jacobian is; its values are the JAX cost's."""
    _, _, jcost, tcost, _, _, x, u = problem
    build.reset_counters()
    got = _call(tcost, method, torch.as_tensor(x), torch.as_tensor(u))
    assert dict(build.PLAIN_CALLS) == CALLS[method]
    assert not build.LAUNCHES
    want = _call(jcost, method, jnp.asarray(x), jnp.asarray(u))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-10)


def test_small_solve_counts_ee_calls_and_matches_jax(problem):
    """A solve of I iterations calls the pose 2 + 2 I times (the first
    total cost's stage and terminal, then each iteration's terminal
    expansion and GN factor) and the Jacobian 2 I times; its costs are the
    JAX solver's, and the plain flag's solve gives the same bits."""
    jm, tm, jcost, tcost, x0, U0, _, _ = problem
    ref = jax.jit(jax_make_ilqr(jm, jcost, JaxILQRConfig(N=N, iters=ITERS)))(
        jnp.asarray(x0), jnp.asarray(U0))
    runs = {}
    for use_kernels in (None, False):
        build.reset_counters()
        runs[use_kernels] = make_ilqr(tm, tcost, ILQRConfig(
            N=N, iters=ITERS, use_kernels=use_kernels))(
                torch.as_tensor(x0), torch.as_tensor(U0))
        assert dict(build.PLAIN_CALLS) == {
            "rollout": 1, "fd_du": ITERS, "riccati_factored": ITERS,
            "linesearch_rollout": ITERS, "eepos": 2 + 2 * ITERS,
            "deepos": 2 * ITERS}
        assert not build.LAUNCHES
    res = runs[None]
    np.testing.assert_allclose(res.cost_trace.numpy(),
                               np.asarray(ref.cost_trace), rtol=0, atol=1e-8)
    assert torch.equal(res.cost_trace, runs[False].cost_trace)
    assert (res.cost_trace[-1] < res.cost_trace[0]).all()


def test_plain_solve_hands_the_cost_the_plain_twins(problem, monkeypatch):
    """make_ilqr(use_kernels=False) gives the cost the plain twins, so it
    never reaches the wrappers (here made to raise); a solve with the
    default route, and the cost called on its own, go through them."""
    _, tm, _, tcost, x0, U0, x, u = problem

    def refuse(*args, **kwargs):
        raise RuntimeError("the wrapper was called")

    monkeypatch.setattr(K, "eepos", refuse)
    monkeypatch.setattr(K, "deepos", refuse)
    args = torch.as_tensor(x0), torch.as_tensor(U0)
    build.reset_counters()
    make_ilqr(tm, tcost, ILQRConfig(N=N, iters=1, use_kernels=False))(*args)
    assert build.PLAIN_CALLS["eepos"] == 4 and build.PLAIN_CALLS["deepos"] == 2
    with pytest.raises(RuntimeError, match="wrapper"):
        make_ilqr(tm, tcost, ILQRConfig(N=N, iters=1))(*args)
    with pytest.raises(RuntimeError, match="wrapper"):
        tcost.stage(torch.as_tensor(x), torch.as_tensor(u), 0)
    plain = dataclasses.replace(tcost, ee_fns=(K.eepos_plain, K.deepos_plain))
    assert plain.stage(torch.as_tensor(x), torch.as_tensor(u), 0).shape == (5,)
