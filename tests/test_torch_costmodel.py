"""The port's ``CostModel`` route against the JAX package (CPU, float64).

* ``QuadCost`` and ``EEReachCost``, with a shared and a per-problem goal:
  every term and flag equals the JAX cost's within 1e-12.
* A tracking cost ramped along the horizon (its weight and reference a
  function of the knot index ``t``: not stationary, not time-invariant),
  written once against each package's ``CostModel`` from the same numpy
  parameters: the first-order and the SQP solves (pendulum2, N=4, B=3, 2
  iterations) equal the JAX solves within 1e-8.
* Per-problem ``QuadCost`` and ``EEReachCost`` goals at one step size, the
  case the JAX solver runs: the same, first order and SQP.
* ``make_sqp`` with the EE reach cost (iiwa, N=4, B=3) against the JAX
  solver's phases (jitting the JAX ``make_sqp`` on iiwa compiles the
  unrolled FDSVA-SO for many minutes, so its tensors run eagerly, as in
  ``test_torch_sqp.py``).
* A per-problem goal with six step sizes: the JAX solver fails with a
  ``TypeError`` (its line search widens the lanes to 6 B), the port raises
  ``NotImplementedError`` before any launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridcodegenerator_tpu.models.model import build_model as jax_build_model
from gridcodegenerator_tpu.models.zoo import load_robot as jax_load_robot
from gridcodegenerator_tpu.ops import eepose as jax_eepose
from gridcodegenerator_tpu.ops import so as jax_so
from gridcodegenerator_tpu.trajopt import cost as jax_cost_mod
from gridcodegenerator_tpu.trajopt.ilqr import ILQRConfig as JaxILQRConfig
from gridcodegenerator_tpu.trajopt.ilqr import make_ilqr as jax_make_ilqr
from gridcodegenerator_tpu.trajopt.sqp import SQPConfig as JaxSQPConfig
from gridcodegenerator_tpu.trajopt.sqp import make_sqp as jax_make_sqp
from gridcodegenerator_tpu_torch.models.model import (ARRAY_FIELDS,
                                                       STATIC_FIELDS,
                                                       model_from_numpy)
from gridcodegenerator_tpu_torch.ops.cuda import build
from gridcodegenerator_tpu_torch.trajopt.cost import (CostModel, EEReachCost,
                                                      QuadCost)
from gridcodegenerator_tpu_torch.trajopt.ilqr import ILQRConfig, make_ilqr
from gridcodegenerator_tpu_torch.trajopt.sqp import SQPConfig, make_sqp

torch.set_num_threads(1)
N, B, ITERS = 4, 3, 2
ATOL = 1e-8
ONE = (1.0,)


def models(robot):
    jm = jax_build_model(jax_load_robot(robot), dtype=jnp.float64)
    tm = model_from_numpy({f: np.asarray(getattr(jm, f)) for f in ARRAY_FIELDS},
                          {f: getattr(jm, f) for f in STATIC_FIELDS},
                          device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def pend():
    return models("pendulum2")


def quad_weights(n, per_problem):
    rng = np.random.default_rng(3)
    w = dict(Q=np.full(2 * n, 0.1), R=np.full(n, 1e-3),
             Qf=np.full(2 * n, 100.0), x_goal=np.zeros(2 * n))
    w["x_goal"][0] = 0.5
    if per_problem:
        w["x_goal"] = w["x_goal"][:, None] + rng.uniform(-0.3, 0.3, (2 * n, B))
    return w


def costs(kind, per_problem, jm, tm):
    """The JAX cost and the port's, from the same numpy parameters."""
    n = jm.n
    if kind == "quad":
        w = quad_weights(n, per_problem)
        return (jax_cost_mod.QuadCost(**{k: jnp.asarray(v)
                                         for k, v in w.items()}),
                QuadCost(**{k: torch.as_tensor(v) for k, v in w.items()}))
    # goal b: the EE at q = 0.5 + U(-0.1, 0.1) per joint
    q = 0.5 + np.random.default_rng(1).uniform(-0.1, 0.1, (n, B))
    goal = np.array(jax_eepose.eepos(jm, jnp.asarray(q)))[:3]
    if not per_problem:
        goal = goal[:, 0]
    kw = dict(w_pos=0.5, w_pos_f=200.0)
    return (jax_cost_mod.EEReachCost(model=jm, goal_xyz=jnp.asarray(goal),
                                     **kw),
            EEReachCost(model=tm, goal_xyz=torch.as_tensor(goal), **kw))


class _Ramp:
    """0.5 s_t (x - s_t xg)^T diag(Q) (x - s_t xg) + 0.5 u^T diag(R) u, with
    s_t = (t + 1) / N; terminal 0.5 (x - xg)^T diag(Qf) (x - xg)."""

    stationary_curvature = False
    time_invariant = False

    def __init__(self, w):
        self.Q, self.R, self.Qf, self.xg = (self.xp.asarray(w[k]) for k in (
            "Q", "R", "Qf", "x_goal"))

    def stage(self, x, u, t):
        s = (t + 1) / N
        dx = x - s * self.xg[:, None]
        return (0.5 * s * (self.Q[:, None] * dx * dx).sum(0)
                + 0.5 * (self.R[:, None] * u * u).sum(0))

    def terminal(self, x):
        dx = x - self.xg[:, None]
        return 0.5 * (self.Qf[:, None] * dx * dx).sum(0)

    def _block(self, w, like):
        return self.xp.diag(w)[:, :, None] + 0.0 * like[None, None, :]

    def stage_expansion(self, x, u, t):
        s = (t + 1) / N
        dx = x - s * self.xg[:, None]
        zero = 0.0 * x[0]
        lux = self.xp.zeros((u.shape[0], x.shape[0]) + x.shape[1:],
                            dtype=x.dtype) + zero
        return (self.stage(x, u, t), s * self.Q[:, None] * dx,
                self.R[:, None] * u, self._block(s * self.Q, zero),
                self._block(self.R, zero), lux)

    def terminal_expansion(self, x):
        dx = x - self.xg[:, None]
        return (self.terminal(x), self.Qf[:, None] * dx,
                self._block(self.Qf, 0.0 * x[0]))


class JaxRamp(_Ramp, jax_cost_mod.CostModel):
    xp = jnp


class TorchRamp(_Ramp, CostModel):
    xp = torch


def problem(robot, kind, per_problem, jm, tm):
    """(JAX cost, port cost, x0, U0) for robot's n."""
    n = jm.n
    if kind == "ramp":
        w = quad_weights(n, False)
        jc, tc = JaxRamp(w), TorchRamp(w)
    else:
        jc, tc = costs(kind, per_problem, jm, tm)
    x0 = np.random.default_rng(0).uniform(-0.2, 0.2, (2 * n, B))
    return jc, tc, x0, np.zeros((N, n, B))


def check(res, ref):
    for f in ("cost_trace", "X", "U"):
        np.testing.assert_allclose(getattr(res, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=ATOL, err_msg=f)
    tr = res.cost_trace
    assert (tr[1:] <= tr[:-1]).all() and (tr[-1] < tr[0]).any()


def _terms(cost, x, u, ee):
    out = {"stage": cost.stage(x, u, 1), "terminal": cost.terminal(x),
           "stage_expansion": cost.stage_expansion(x, u, 1),
           "terminal_expansion": cost.terminal_expansion(x),
           "flags": (cost.time_invariant, cost.stationary_curvature)}
    if ee:
        out["gn_stage_factor"] = cost.gn_stage_factor(x, u, 1)
        out["flags"] += (cost.gn_factor_diags,)
    return out


@pytest.mark.parametrize("kind", ["quad", "ee"])
@pytest.mark.parametrize("per_problem", [False, True],
                         ids=["shared", "per_problem"])
def test_cost_terms_match_jax(pend, kind, per_problem):
    jm, tm = pend
    jc, tc = costs(kind, per_problem, jm, tm)
    rng = np.random.default_rng(5)
    x, u = rng.uniform(-1, 1, (2 * jm.n, B)), rng.uniform(-1, 1, (jm.n, B))
    got = _terms(tc, torch.as_tensor(x), torch.as_tensor(u), kind == "ee")
    want = _terms(jc, jnp.asarray(x), jnp.asarray(u), kind == "ee")
    assert got.pop("flags") == want.pop("flags")
    assert tc.time_invariant is (not per_problem)
    assert (tc.kernel_weights is None) is per_problem
    for k, w in want.items():
        g = got[k] if isinstance(got[k], tuple) else (got[k],)
        w = w if isinstance(w, tuple) else (w,)
        assert len(g) == len(w), k
        for a, b in zip(g, w):
            b = np.broadcast_to(np.asarray(b), tuple(a.shape))
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-12,
                                       err_msg=k)


@pytest.mark.parametrize("solver", ["ilqr", "sqp"])
@pytest.mark.parametrize("kind", ["ramp", "quad", "ee"])
def test_per_knot_solves_match_jax(pend, kind, solver):
    """The per-knot route: the ramped cost at the six step sizes, the
    per-problem goals at one; first order (the stacked riccati, the
    no-cost line search, the cost summed knot by knot) and SQP."""
    jm, tm = pend
    jc, tc, x0, U0 = problem("pendulum2", kind, True, jm, tm)
    alphas = {} if kind == "ramp" else dict(alphas=ONE)
    jcfg = (JaxSQPConfig if solver == "sqp" else JaxILQRConfig)(
        N=N, iters=ITERS, use_pallas=False, **alphas)
    ref = jax.jit((jax_make_sqp if solver == "sqp" else jax_make_ilqr)(
        jm, jc, jcfg))(jnp.asarray(x0), jnp.asarray(U0))
    build.reset_counters()
    res = (make_sqp if solver == "sqp" else make_ilqr)(
        tm, tc, (SQPConfig if solver == "sqp" else ILQRConfig)(
            N=N, iters=ITERS, **alphas))(torch.as_tensor(x0),
                                         torch.as_tensor(U0))
    calls = {"rollout": 1, "fd_du": ITERS, "linesearch_nocost": ITERS}
    calls |= ({"fdsva_so": ITERS} if solver == "sqp" else {"riccati": ITERS})
    if kind == "ee":   # the pose a knot in each total cost and expansion
        calls |= {"eepos": (N + 1) * (1 + 2 * ITERS),
                  "deepos": (N + 1) * ITERS}
    assert dict(build.PLAIN_CALLS) == calls
    check(res, ref)


def test_sqp_with_the_ee_cost_matches_jax():
    """Config 3's task under config 4's solver: the DDP backward on the EE
    cost's dense Gauss-Newton expansion, one folded call a sweep."""
    jm, tm = models("iiwa")
    jc, tc, x0, U0 = problem("iiwa", "ee", False, jm, tm)
    cfg = JaxSQPConfig(N=N, iters=ITERS, use_pallas=False)
    _, parts = jax_make_ilqr(jm, jc, cfg, expose_parts=True)
    rollout, linearize, backward, forward, total = (
        jax.jit(parts[k]) for k in ("rollout", "linearize", "backward",
                                    "forward", "total_cost"))
    X = rollout(jnp.asarray(x0), jnp.asarray(U0))
    U, c = jnp.asarray(U0), total(X, jnp.asarray(U0))
    trace = [c]
    for _ in range(ITERS):
        Amat, Bmat, (qf, qdf, uf) = linearize(X[:N], U)
        so_flat = jax_so.fdsva_so(jm, qf, qdf, uf, cfg.gravity)
        ks, Ks = backward(X, U, Amat, Bmat, tuple(so_flat[i]
                                                  for i in range(4)))
        Xn, Un, cn = forward(X, U, ks, Ks)
        acc = cn < c
        X = jnp.where(acc[None, None, :], Xn, X)
        U = jnp.where(acc[None, None, :], Un, U)
        c = jnp.where(acc, cn, c)
        trace.append(c)
    build.reset_counters()
    res = make_sqp(tm, tc, SQPConfig(N=N, iters=ITERS))(torch.as_tensor(x0),
                                                        torch.as_tensor(U0))
    assert dict(build.PLAIN_CALLS) == {
        "rollout": 1, "fd_du": ITERS, "fdsva_so": ITERS,
        "linesearch_rollout": ITERS, "eepos": 2 + 2 * ITERS,
        "deepos": 2 * ITERS}
    check(res, type("Ref", (), dict(X=X, U=U, cost_trace=jnp.stack(trace))))


@pytest.mark.parametrize("kind", ["quad", "ee"])
def test_per_problem_goal_with_six_step_sizes_raises(pend, kind):
    """The JAX solver's widened line-search lanes (6 B) do not broadcast
    against a (., B) goal; the port refuses the case before any launch."""
    jm, tm = pend
    jc, tc, x0, U0 = problem("pendulum2", kind, True, jm, tm)
    with pytest.raises(TypeError, match="broadcast"):
        jax_make_ilqr(jm, jc, JaxILQRConfig(N=N, iters=1, use_pallas=False))(
            jnp.asarray(x0), jnp.asarray(U0))
    build.reset_counters()
    with pytest.raises(NotImplementedError, match="JAX solver cannot"):
        make_ilqr(tm, tc, ILQRConfig(N=N, iters=1))
    with pytest.raises(NotImplementedError, match="JAX solver cannot"):
        make_sqp(tm, tc, SQPConfig(N=N, iters=1))
    assert not build.PLAIN_CALLS and not build.LAUNCHES
    # one problem's goal, or one step size, runs
    make_ilqr(tm, tc, ILQRConfig(N=N, iters=1, alphas=ONE))
