"""The port's plain sweeps against the JAX package's Pallas sweep kernels.

The JAX kernels run in Pallas interpret mode on the CPU, as the JAX
package's own ``tests/test_pallas_sweeps.py`` runs them; the port's plain
versions (what its wrappers run on CPU tensors) take the same numpy inputs.
The feedback rollout is also held against the ``lax.scan`` of that file.
float64, tolerance 1e-10 absolute (scaled by the gains' size for the
n=7 Riccati case).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridcodegenerator_tpu.models.model import build_model as jax_build_model
from gridcodegenerator_tpu.models.zoo import load_robot as jax_load_robot
from gridcodegenerator_tpu.ops.aba import aba as jax_aba
from gridcodegenerator_tpu.ops import eepose as jax_eepose
from gridcodegenerator_tpu.ops.pallas import sweeps as jax_sweeps
from gridcodegenerator_tpu.ops.spatial import bmv as jax_bmv
from gridcodegenerator_tpu.trajopt.cost import EEReachCost as JaxEEReachCost
from gridcodegenerator_tpu_torch.models.model import (ARRAY_FIELDS,
                                                       STATIC_FIELDS,
                                                       model_from_numpy)
from gridcodegenerator_tpu_torch.ops.cuda import build, sweeps
from gridcodegenerator_tpu_torch.trajopt.cost import EEReachCost

torch.set_num_threads(1)
ATOL = 1e-10
GRAV, DT = -9.81, 0.01


@pytest.fixture(scope="module")
def iiwa():
    jm = jax_build_model(jax_load_robot("iiwa"), dtype=jnp.float64)
    tm = model_from_numpy({f: np.asarray(getattr(jm, f)) for f in ARRAY_FIELDS},
                          {f: getattr(jm, f) for f in STATIC_FIELDS},
                          device="cpu")
    return jm, tm


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(ours, ref, atol=ATOL):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("bounded", [False, True])
def test_rollout_matches_jax_kernel(iiwa, bounded):
    jm, tm = iiwa
    n, N, B = jm.n, 8, 4
    rng = np.random.default_rng(3)
    x0 = rng.uniform(-0.5, 0.5, (2 * n, B))
    U = rng.uniform(-5, 5, (N, n, B))
    lo = hi = None
    if bounded:   # per-dof (n, 1) bounds, as the effort limits arrive
        lo = -rng.uniform(1, 3, (n, 1))
        hi = rng.uniform(1, 3, (n, 1))
    ref = jax_sweeps.rollout_pallas(jm, N, DT, GRAV, lo, hi, block_b=B,
                                    interpret=True)(jnp.asarray(x0),
                                                    jnp.asarray(U))
    build.reset_counters()
    ours = sweeps.rollout(tm, _t(x0), _t(U), DT, GRAV,
                          None if lo is None else _t(lo),
                          None if hi is None else _t(hi))
    assert build.PLAIN_CALLS["rollout"] == 1 and not build.LAUNCHES
    _close(ours, ref)


@pytest.mark.parametrize("dt,finite", [(0.01, False), (0.002, True)])
def test_dm_quadruped_euler_step_diverges_at_0_01(dt, finite):
    """Config 4's dm_quadruped (bench.py:212-213, dt 0.01): its joint
    damping on light links makes the semi-implicit Euler step unstable, so
    from x0 ~ U(-0.2, 0.2), U = 0 every rollout of the JAX reference (a scan
    of its ABA) and of the port leaves the finite numbers by knot 32; at
    dt 0.002 both stay bounded, and they agree (1e-10)."""
    jm = jax_build_model(jax_load_robot("dm_quadruped"), dtype=jnp.float64)
    tm = model_from_numpy({f: np.asarray(getattr(jm, f)) for f in ARRAY_FIELDS},
                          {f: getattr(jm, f) for f in STATIC_FIELDS},
                          device="cpu")
    n, N, B = jm.n, 32, 4
    x0 = np.random.default_rng(0).uniform(-0.2, 0.2, (2 * n, B))
    U = np.zeros((N, n, B))

    def body(x, u):
        q, qd = x[:n], x[n:]
        qd_new = qd + dt * jax_aba(jm, q, qd, u, GRAV)
        xn = jnp.concatenate([q + dt * qd_new, qd_new], axis=0)
        return xn, xn

    with np.errstate(all="ignore"):
        _, ref = jax.lax.scan(body, jnp.asarray(x0), jnp.asarray(U))
        ref = np.asarray(ref)
        ours = sweeps.rollout(tm, _t(x0), _t(U), dt, GRAV)
    last = lambda X: np.isfinite(np.asarray(X)[-1]).all(axis=0)
    assert last(ref).tolist() == last(ours).tolist() == [finite] * B
    if finite:
        assert np.abs(ref).max() < 10
        _close(ours, ref)


@pytest.mark.parametrize("bounded", [False, True])
def test_feedback_rollout_matches_jax_kernel_and_scan(iiwa, bounded):
    """u_t = clamp(Uref_t + kff_t + K_t (x_t - Xref_t)); X after each step,
    U after the clamp."""
    jm, tm = iiwa
    n, N, B = jm.n, 8, 4
    nx = 2 * n
    rng = np.random.default_rng(4)
    x0 = rng.uniform(-0.5, 0.5, (nx, B))
    Uref = rng.uniform(-1, 1, (N, n, B))
    Xref = rng.uniform(-0.5, 0.5, (N, nx, B))
    kff = 0.1 * rng.uniform(-1, 1, (N, n, B))
    K = 0.1 * rng.uniform(-1, 1, (N, n, nx, B))
    lo = hi = None
    if bounded:   # per-dof (n, 1) bounds, active on some controls
        lo, hi = -0.6 * np.ones((n, 1)), 0.7 * np.ones((n, 1))
    ins = (x0, Uref, Xref, kff, K)
    X_r, U_r = jax_sweeps.feedback_rollout_pallas(
        jm, N, DT, GRAV, lo, hi, block_b=B, interpret=True)(
            *map(jnp.asarray, ins))

    def body(x, inp):
        xr, ur, k_t, K_t = inp
        u = ur + k_t + jax_bmv(K_t, x - xr)
        if bounded:
            u = jnp.clip(u, lo, hi)
        q, qd = x[:n], x[n:]
        qd_new = qd + DT * jax_aba(jm, q, qd, u, GRAV)
        xn = jnp.concatenate([q + DT * qd_new, qd_new], axis=0)
        return xn, (xn, u)

    _, (X_s, U_s) = jax.lax.scan(body, jnp.asarray(x0), tuple(
        map(jnp.asarray, (Xref, Uref, kff, K))))
    build.reset_counters()
    X_o, U_o = sweeps.feedback_rollout(
        tm, *map(_t, ins), DT, GRAV, None if lo is None else _t(lo),
        None if hi is None else _t(hi))
    assert build.PLAIN_CALLS["feedback_rollout"] == 1 and not build.LAUNCHES
    assert X_o.shape == (N, nx, B) and U_o.shape == (N, n, B)
    if bounded:
        assert bool((U_o == 0.7).any()) and bool((U_o == -0.6).any())
    for ours, ref in ((X_o, X_r), (U_o, U_r), (X_o, X_s), (U_o, U_s)):
        _close(ours, ref)


def test_linesearch_rollout_matches_jax_kernel(iiwa):
    """Per-lane step sizes, alpha-major output lanes, per-dof clamp and the
    EE reach cost summed in the sweep."""
    jm, tm = iiwa
    n, N, B = jm.n, 6, 4
    nx, na = 2 * n, 3
    rng = np.random.default_rng(5)
    goal = jax_eepose.eepos(jm, jnp.full((n, 1), 0.3, jnp.float64))[:3, 0]
    jcost = JaxEEReachCost(model=jm, goal_xyz=goal, w_pos=0.5, w_pos_f=50.0)
    tcost = EEReachCost(model=tm, goal_xyz=_t(goal), w_pos=0.5, w_pos_f=50.0)
    x0 = rng.uniform(-0.2, 0.2, (nx, B))
    Uref = rng.uniform(-2, 2, (N, n, B))
    Xref = rng.uniform(-0.2, 0.2, (N, nx, B))
    ks = rng.uniform(-1, 1, (N, n, B))
    Ks = 2.0 * rng.uniform(-1, 1, (N, n, nx, B))
    rows = rng.uniform(0.05, 1.0, (na, B))
    lo, hi = -1.5 * np.ones((n, 1)), 1.8 * np.ones((n, 1))
    ccv, stage, term = jcost.pallas_cost()
    fb = jax_sweeps.linesearch_rollout_pallas(
        jm, N, DT, GRAV, (1.0,) * na, lo, hi, block_b=B, interpret=True,
        cost_consts=ccv, stage_cost=stage, terminal_cost=term)
    X_r, U_r, c_r = fb(*map(jnp.asarray, (x0, Uref, Xref, ks, Ks, rows)))
    X_o, U_o, c_o = sweeps.linesearch_rollout(
        tm, *map(_t, (x0, Uref, Xref, ks, Ks, rows)), DT, GRAV, _t(lo),
        _t(hi), tcost)
    assert X_o.shape == (N, nx, na * B) and c_o.shape == (na * B,)
    assert bool((U_o == 1.8).any())   # the clamp is active
    _close(X_o, X_r)
    _close(U_o, U_r)
    _close(c_o, c_r)


@pytest.mark.parametrize("n,r,qd_diag,u_diag", [(3, 2, 0.05, 1e-3),
                                                 (7, 3, 0.01, 1e-4)])
def test_riccati_factored_matches_jax_kernel(n, r, qd_diag, u_diag):
    """The JAX package's own factored-sweep test problem (n=3), and config
    3's sizes (n=7, rank 3, w_vel=0.01, w_u=1e-4), whose small luu gives
    gains of ~1e3: there the 1e-10 bound is relative to the gains' scale."""
    N, B, reg = 6, 4, 1e-6
    nx = 2 * n
    rng = np.random.default_rng(11)
    A = np.eye(nx)[None, :, :, None] + 0.05 * rng.uniform(-1, 1,
                                                          (N, nx, nx, B))
    Bm = 0.1 * rng.uniform(-1, 1, (N, nx, n, B))
    lx = rng.uniform(-1, 1, (nx, N * B))          # knot-major flat lanes
    lu = rng.uniform(-1, 1, (n, N * B))
    Jw = rng.uniform(-1, 1, (r, n, N * B))
    Vx0 = rng.uniform(-1, 1, (nx, B))
    Vxx0 = np.tile(np.diag(rng.uniform(0.5, 2, nx))[:, :, None], (1, 1, B))
    args = (A, Bm, lx, lu, Jw, Vx0, Vxx0)
    fused = jax_sweeps.riccati_pallas_factored(n, N, reg, r, qd_diag, u_diag,
                                               dtype=jnp.float64,
                                               interpret=True)
    k_r, K_r = fused(*map(jnp.asarray, args))
    k_o, K_o = sweeps.riccati_factored(*map(_t, args), reg, qd_diag, u_diag)
    for ours, ref in ((k_o, k_r), (K_o, K_r)):
        scale = max(1.0, float(np.abs(np.asarray(ref)).max()))
        _close(ours, ref, atol=ATOL * scale)
