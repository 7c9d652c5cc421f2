"""The port's knot-sharded Riccati reduce against the JAX package (CPU,
float64).

Four gloo ranks, spawned once for the module over a FileStore
(``parallel/launch.py:RankGroup``), run ``tests/torch_rank_tasks.py``:
they import torch and the port only. The JAX references run here, on the
conftest's 8-device CPU mesh, under ``shard_map`` as the JAX package's
``tests/test_knot_riccati.py`` builds them:

* ``sharded_lqr_gains`` over a ("kp",) mesh of D = 1, 2, 3 and 4 ranks on
  random LQR stacks made with numpy (D = 3: the ranks with no source in a
  round keep their aggregate), within 1e-10 of scale;
* the knot-sharded ``make_ilqr`` on pendulum2 (QuadCost, N=8, B=4, 3
  iterations, kp 2 and 4): cost within 1e-10, U within 1e-8;
* the knot-sharded solve with the EE cost on iiwa (kp=2) against the
  port's one-device ``parallel_riccati`` solve: within 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from gridcodegenerator_tpu.models.model import build_model as jax_build_model
from gridcodegenerator_tpu.models.zoo import load_robot as jax_load_robot
from gridcodegenerator_tpu.ops import eepose as jax_eepose
from gridcodegenerator_tpu.parallel.knot_riccati import \
    sharded_lqr_gains as jax_sharded_lqr_gains
from gridcodegenerator_tpu.trajopt.cost import QuadCost as JaxQuadCost
from gridcodegenerator_tpu.trajopt.ilqr import ILQRConfig as JaxILQRConfig
from gridcodegenerator_tpu.trajopt.ilqr import ILQRResult as JaxILQRResult
from gridcodegenerator_tpu.trajopt.ilqr import make_ilqr as jax_make_ilqr
from gridcodegenerator_tpu_torch.models.model import (ARRAY_FIELDS,
                                                       STATIC_FIELDS,
                                                       model_from_numpy)
from gridcodegenerator_tpu_torch.parallel.launch import RankGroup
from gridcodegenerator_tpu_torch.trajopt.cost import EEReachCost
from gridcodegenerator_tpu_torch.trajopt.ilqr import ILQRConfig, make_ilqr

import torch_rank_tasks as tasks

torch.set_num_threads(1)
RANKS = 4
TOL = 1e-10     # of each output's scale max(1, max|ref|)


def _scale_close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    store = tmp_path_factory.mktemp("knot_riccati") / "store"
    with RankGroup(RANKS, f"file://{store}", "gloo", timeout_s=120) as g:
        yield g


def _rand_lqr(N, nx, nu, B, seed):
    """The JAX package's ``tests/test_knot_riccati.py:_rand_lqr``."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.normal(size=s)

    def spd(n_):
        X = rng.normal(size=(N, n_, n_, B))
        return (np.einsum("tijb,tkjb->tikb", X, X)
                + np.eye(n_)[None, :, :, None])

    return (r(N, nx, nx, B) * 0.5, r(N, nx, nu, B), r(N, nx, B),
            r(N, nu, B), spd(nx), spd(nu), r(N, nu, nx, B) * 0.3,
            r(nx, B), spd(nx)[0])


@pytest.mark.parametrize("D, N, nx, B", [(1, 8, 3, 2), (2, 32, 4, 3),
                                         (3, 24, 3, 2), (4, 32, 4, 3)])
def test_port_sharded_lqr_gains_match_jax(ranks, D, N, nx, B):
    args = _rand_lqr(N, nx, 2, B, seed=D)
    mesh = Mesh(np.asarray(jax.devices()[:D]), ("kp",))
    want = jax.jit(jax_sharded_lqr_gains(mesh, "kp", reg=0.0))(
        *map(jnp.asarray, args))
    got = ranks.run(tasks.lqr_gains, D, args)
    assert all(g is None for g in got[D:])      # ranks outside the mesh
    for rank_got in got[:D]:
        for ours, theirs in zip(rank_got, want):
            assert ours.shape == theirs.shape
            _scale_close(ours, theirs)


def test_port_sharded_lqr_gains_refuse_uneven_knots(ranks):
    # 10 knots over 4 ranks: JAX's ValueError, on every rank
    got = ranks.run(tasks.raises, "lqr_gains", 4, _rand_lqr(10, 3, 2, 2, 0))
    assert got == ["ValueError"] * RANKS


def _jax_and_port(robot):
    jm = jax_build_model(jax_load_robot(robot), dtype=jnp.float64)
    spec = ({f: np.asarray(getattr(jm, f)) for f in ARRAY_FIELDS},
            {f: getattr(jm, f) for f in STATIC_FIELDS})
    return jm, spec


def _quad(n):
    w = dict(Q=np.full(2 * n, 0.1), R=np.full(n, 1e-3),
             Qf=np.full(2 * n, 10.0), x_goal=np.zeros(2 * n))
    w["x_goal"][0] = 0.7
    return w


@pytest.mark.parametrize("kp", [2, 4])
def test_port_knot_sharded_solve_matches_jax_shard_map(ranks, kp):
    jm, spec = _jax_and_port("pendulum2")
    n, N, B, iters = jm.n, 8, 4, 3
    w = _quad(n)
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-0.3, 0.3, (2 * n, B))
    U0 = rng.uniform(-0.1, 0.1, (N, n, B))
    jcost = JaxQuadCost(**{k: jnp.asarray(v) for k, v in w.items()})
    solver = jax_make_ilqr(jm, jcost, JaxILQRConfig(
        N=N, iters=iters, knot_axis="kp", knot_axis_size=kp))
    jmesh = Mesh(np.asarray(jax.devices()[:kp]), ("kp",))
    want = jax.jit(jax.shard_map(
        solver, mesh=jmesh, in_specs=(P(), P()),
        out_specs=JaxILQRResult(*(P(),) * len(JaxILQRResult._fields)),
        check_vma=False))(
            jnp.asarray(x0), jnp.asarray(U0))
    got = ranks.run(tasks.knot_solve, spec, "quad", w,
                    dict(N=N, iters=iters), kp, x0, U0)
    assert all(g is None for g in got[kp:])
    for res in got[:kp]:
        # each rank linearized its N/kp knots once an iteration; no
        # Riccati sweep ran
        assert res["plain_calls"] == {"rollout": 1, "fd_du": iters,
                                      "linesearch_rollout": iters}
        np.testing.assert_allclose(res["cost"], np.asarray(want.cost),
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(res["U"], np.asarray(want.U), rtol=0,
                                   atol=1e-8)
        np.testing.assert_allclose(res["cost_trace"],
                                   np.asarray(want.cost_trace), rtol=0,
                                   atol=1e-10)
        assert np.array_equal(res["U"], got[0]["U"])


def test_port_knot_sharded_ee_cost_matches_parallel_riccati(ranks):
    """iiwa, EEReachCost (its dense Gauss-Newton expansion), kp=2, against
    the port's one-device associative-scan solve: the same reduce, one
    device."""
    jm, spec = _jax_and_port("iiwa")
    n, N, B, iters = jm.n, 8, 4, 2
    goal = np.asarray(jax_eepose.eepos(jm, jnp.full((n, 1), 0.5,
                                                    jnp.float64))[:3, 0])
    w = dict(goal_xyz=goal, w_pos=0.5, w_pos_f=200.0)
    rng = np.random.default_rng(1)
    x0 = rng.uniform(-0.2, 0.2, (2 * n, B))
    U0 = np.zeros((N, n, B))
    got = ranks.run(tasks.knot_solve, spec, "ee", w,
                    dict(N=N, iters=iters), 2, x0, U0)
    tm = model_from_numpy(*spec, device="cpu")
    tcost = EEReachCost(model=tm, goal_xyz=torch.as_tensor(goal),
                        w_pos=0.5, w_pos_f=200.0)
    want = make_ilqr(tm, tcost, ILQRConfig(N=N, iters=iters,
                                           parallel_riccati=True))(
        torch.as_tensor(x0), torch.as_tensor(U0))
    for res in got[:2]:
        assert res["plain_calls"]["fd_du"] == iters
        for f in ("cost_trace", "X", "U", "ks", "Ks"):
            np.testing.assert_allclose(
                res[f], getattr(want, {"ks": "k", "Ks": "K"}.get(f, f))
                .numpy(), rtol=0, atol=1e-8, err_msg=f)
