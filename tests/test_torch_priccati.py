"""The port's associative-scan Riccati against the JAX package (CPU, float64).

``trajopt/priccati.py``'s ``_combine`` and ``suffix_value_functions``
against the JAX ones on random elements made from a numpy seed; the
solver's ``parallel_riccati`` route against the JAX solver with the same
flag (pendulum2, QuadCost) and against the port's sequential solver
(iiwa, the EE cost, ``reg=0``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridcodegenerator_tpu.models.model import build_model as jax_build_model
from gridcodegenerator_tpu.models.zoo import load_robot as jax_load_robot
from gridcodegenerator_tpu.ops import eepose as jax_eepose
from gridcodegenerator_tpu.trajopt import priccati as jax_priccati
from gridcodegenerator_tpu.trajopt.cost import QuadCost as JaxQuadCost
from gridcodegenerator_tpu.trajopt.ilqr import ILQRConfig as JaxILQRConfig
from gridcodegenerator_tpu.trajopt.ilqr import make_ilqr as jax_make_ilqr
from gridcodegenerator_tpu_torch.models.model import (ARRAY_FIELDS,
                                                       STATIC_FIELDS,
                                                       model_from_numpy)
from gridcodegenerator_tpu_torch.ops.cuda import build
from gridcodegenerator_tpu_torch.trajopt import priccati
from gridcodegenerator_tpu_torch.trajopt.cost import EEReachCost, QuadCost
from gridcodegenerator_tpu_torch.trajopt.ilqr import ILQRConfig, make_ilqr

torch.set_num_threads(1)
TOL = 1e-10     # of each output's scale max(1, max|ref|)


def _scale_close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _spd(rng, m, B, lead=()):
    """Random SPD blocks, (*lead, m, m, B)."""
    G = rng.standard_normal(lead + (m, m, B))
    return (np.einsum("...ikb,...jkb->...ijb", G, G) / m
            + np.eye(m)[:, :, None])


def _lqr_inputs(N, nx, nu, B, seed):
    rng = np.random.default_rng(seed)
    A = np.eye(nx)[:, :, None] + 0.1 * rng.standard_normal((N, nx, nx, B))
    Bm = 0.1 * rng.standard_normal((N, nx, nu, B))
    lx = rng.standard_normal((N, nx, B))
    lu = rng.standard_normal((N, nu, B))
    lxx = _spd(rng, nx, B, (N,))
    luu = _spd(rng, nu, B, (N,))
    lux = 0.1 * rng.standard_normal((N, nu, nx, B))
    VxN = rng.standard_normal((nx, B))
    VxxN = _spd(rng, nx, B)
    return A, Bm, lx, lu, lxx, luu, lux, VxN, VxxN


def _elem(rng, nx, B):
    """A random conditional-value element (A, b, C, eta, J), C and J SPD."""
    return (np.eye(nx)[:, :, None] + 0.2 * rng.standard_normal((nx, nx, B)),
            rng.standard_normal((nx, B)), _spd(rng, nx, B),
            rng.standard_normal((nx, B)), _spd(rng, nx, B))


def test_combine_matches_jax():
    rng = np.random.default_rng(0)
    e1, e2 = _elem(rng, 6, 3), _elem(rng, 6, 3)
    got = priccati._combine([torch.as_tensor(a) for a in e1],
                            [torch.as_tensor(a) for a in e2])
    want = jax_priccati._combine([jnp.asarray(a) for a in e1],
                                 [jnp.asarray(a) for a in e2])
    for g, w in zip(got, want):
        _scale_close(g.numpy(), w)


def test_combine_is_associative():
    rng = np.random.default_rng(1)
    a, b, c = ([torch.as_tensor(x) for x in _elem(rng, 5, 3)]
               for _ in range(3))
    left = priccati._combine(priccati._combine(a, b), c)
    right = priccati._combine(a, priccati._combine(b, c))
    for x, y in zip(left, right):
        _scale_close(x.numpy(), y.numpy(), 1e-12)


@pytest.mark.parametrize("N", [13, 16])
def test_suffix_value_functions_match_jax(N):
    args = _lqr_inputs(N, 6, 3, 3, seed=N)
    Vx, Vxx = priccati.suffix_value_functions(
        *(torch.as_tensor(a) for a in args))
    jVx, jVxx = jax_priccati.suffix_value_functions(
        *(jnp.asarray(a) for a in args))
    assert Vx.shape == (N + 1, 6, 3) and Vxx.shape == (N + 1, 6, 6, 3)
    _scale_close(Vx.numpy(), jVx)
    _scale_close(Vxx.numpy(), jVxx)


@pytest.mark.parametrize("n", [11, 65])
def test_scan_visits_every_prefix_like_a_sequential_fold(n):
    """The scan of a non-commutative product (3x3 matrices) gives every
    prefix product, as a fold does, in log-depth rounds: two batched
    combines a halving, none at the base (11 at config 3's 65 elements,
    121 pairs)."""
    rng = np.random.default_rng(2)
    M = torch.as_tensor(rng.standard_normal((3, 3, n)) / 1.5)
    rounds = []
    got, = priccati.associative_scan(
        lambda a, b: [torch.einsum("ik...,kj...->ij...", a[0], b[0])], [M],
        rounds)
    assert len(rounds) <= 2 * int(np.ceil(np.log2(n)))
    assert sum(rounds) <= 2 * (n - 1)    # the pairs joined: ~2x a fold's
    acc = M[..., 0]
    for k in range(n):
        if k:
            acc = acc @ M[..., k]
        _scale_close(got[..., k].numpy(), acc.numpy(), 1e-12)


def _torch_model(jm):
    return model_from_numpy({f: np.asarray(getattr(jm, f))
                             for f in ARRAY_FIELDS},
                            {f: getattr(jm, f) for f in STATIC_FIELDS},
                            device="cpu")


def test_parallel_solve_matches_jax_on_pendulum2():
    """JAX ``test_trajopt.py:test_parallel_riccati_matches_sequential``'s
    problem: pendulum2, QuadCost, N=16, B=4, 4 iterations, reg 0."""
    jm = jax_build_model(jax_load_robot("pendulum2"), dtype=jnp.float64)
    tm = _torch_model(jm)
    n, B, N = jm.n, 4, 16
    xg = np.zeros(2 * n)
    xg[0] = 0.7
    w = dict(Q=np.full(2 * n, 0.1), R=np.full(n, 1e-3),
             Qf=np.full(2 * n, 10.0), x_goal=xg)
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-0.3, 0.3, (2 * n, B))
    U0 = rng.uniform(-0.1, 0.1, (N, n, B))
    ref = jax.jit(jax_make_ilqr(
        jm, JaxQuadCost(**{k: jnp.asarray(v) for k, v in w.items()}),
        JaxILQRConfig(N=N, iters=4, reg=0.0, parallel_riccati=True)))(
            jnp.asarray(x0), jnp.asarray(U0))
    build.reset_counters()
    got = make_ilqr(tm, QuadCost(**{k: torch.as_tensor(v)
                                    for k, v in w.items()}),
                    ILQRConfig(N=N, iters=4, reg=0.0,
                               parallel_riccati=True))(
        torch.as_tensor(x0), torch.as_tensor(U0))
    # no Riccati sweep, kernel or plain twin, ran
    assert dict(build.PLAIN_CALLS) == {"rollout": 1, "fd_du": 4,
                                       "linesearch_rollout": 4}
    for f in ("cost_trace", "X", "U", "K", "k"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=1e-8, err_msg=f)


def test_parallel_solve_matches_sequential_on_iiwa_ee_reach():
    """iiwa, the EE cost (its folded expansion), N=8, B=4, 2 iterations,
    reg 0: the scan and the sequential factored sweep give one solve."""
    jm = jax_build_model(jax_load_robot("iiwa"), dtype=jnp.float64)
    tm = _torch_model(jm)
    n, B, N = jm.n, 4, 8
    goal = jax_eepose.eepos(jm, jnp.full((n, 1), 0.5, jnp.float64))[:3, 0]
    cost = EEReachCost(model=tm, goal_xyz=torch.as_tensor(np.array(goal)),
                       w_pos=0.5, w_pos_f=200.0)
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(-0.2, 0.2,
                                                          (2 * n, B)))
    U0 = torch.zeros((N, n, B), dtype=torch.float64)
    seq = make_ilqr(tm, cost, ILQRConfig(N=N, iters=2, reg=0.0))(x0, U0)
    build.reset_counters()
    par = make_ilqr(tm, cost, ILQRConfig(N=N, iters=2, reg=0.0,
                                         parallel_riccati=True))(x0, U0)
    assert dict(build.PLAIN_CALLS) == {"rollout": 1, "fd_du": 2,
                                       "linesearch_rollout": 2,
                                       "eepos": 6, "deepos": 4}
    # the line-search kernel takes the gains only contiguous
    assert par.K.is_contiguous() and par.k.is_contiguous()
    np.testing.assert_allclose(par.cost_trace.numpy(),
                               seq.cost_trace.numpy(), rtol=0, atol=1e-10)
    for f in ("U", "K"):
        np.testing.assert_allclose(getattr(par, f).numpy(),
                                   getattr(seq, f).numpy(), rtol=0,
                                   atol=1e-8, err_msg=f)
