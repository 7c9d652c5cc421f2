"""The port's multi-device scenario step against the JAX package (CPU,
float64).

Four gloo ranks, spawned once for the module over a FileStore
(``parallel/launch.py:RankGroup``), run ``tests/torch_rank_tasks.py``:
they import torch and the port only. The JAX references run here, on the
conftest's 8-device CPU mesh (its first four devices).

Config 5's task at a small size on pendulum2: ``QuadCost`` (Q 0.1, R 1e-3,
Qf 10, x_goal[0] 0.2), S=8 scenarios, N=8 knots, 2 iterations, two steps
(the second warm-started by the first's U_next), on a flat dp=4 mesh and a
hybrid (dp 2, kp 2) mesh, whose solve is knot-sharded. Every rank takes
its shard of the same numpy scenario states; the shards are gathered back:

* against the JAX step on the same mesh: u0, U_next and costs within 1e-8;
* the hybrid step against the flat one and the port's one-device step
  (the test the JAX package lacks): within 1e-8;
* ``closed_loop`` on either mesh against ``closed_loop`` on one device;
* the collectives on a (2, 2) mesh, and the mesh cases that raise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridcodegenerator_tpu.models.model import build_model as jax_build_model
from gridcodegenerator_tpu.models.zoo import load_robot as jax_load_robot
from gridcodegenerator_tpu.parallel.mesh import make_hybrid_mesh as \
    jax_make_hybrid_mesh
from gridcodegenerator_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gridcodegenerator_tpu.parallel.scenario import \
    ScenarioMPCConfig as JaxScenarioMPCConfig
from gridcodegenerator_tpu.parallel.scenario import \
    make_scenario_step as jax_make_scenario_step
from gridcodegenerator_tpu.trajopt.cost import QuadCost as JaxQuadCost
from gridcodegenerator_tpu.trajopt.ilqr import ILQRConfig as JaxILQRConfig
from gridcodegenerator_tpu_torch.models.model import (ARRAY_FIELDS,
                                                       STATIC_FIELDS,
                                                       model_from_numpy)
from gridcodegenerator_tpu_torch.parallel.launch import RankGroup
from gridcodegenerator_tpu_torch.parallel.scenario import (
    ScenarioMPCConfig, closed_loop, make_scenario_step)
from gridcodegenerator_tpu_torch.trajopt.cost import QuadCost
from gridcodegenerator_tpu_torch.trajopt.ilqr import ILQRConfig

import torch_rank_tasks as tasks

torch.set_num_threads(1)
RANKS, S, N, ITERS = 4, 8, 8, 2
CFG = dict(N=N, iters=ITERS)
MESHES = ("flat", "hybrid")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    store = tmp_path_factory.mktemp("mesh") / "store"
    with RankGroup(RANKS, f"file://{store}", "gloo", timeout_s=120) as g:
        yield g


@pytest.fixture(scope="module")
def problem():
    jm = jax_build_model(jax_load_robot("pendulum2"), dtype=jnp.float64)
    spec = ({f: np.asarray(getattr(jm, f)) for f in ARRAY_FIELDS},
            {f: getattr(jm, f) for f in STATIC_FIELDS})
    n = jm.n
    w = dict(Q=np.full(2 * n, 0.1), R=np.full(n, 1e-3),
             Qf=np.full(2 * n, 10.0), x_goal=np.zeros(2 * n))
    w["x_goal"][0] = 0.2
    rng = np.random.default_rng(0)
    x0s = [0.02 * rng.standard_normal((2 * n, S)) for _ in range(2)]
    return jm, spec, w, x0s


@pytest.fixture(scope="module")
def port_steps(ranks, problem):
    """Each mesh's two steps, as every rank returned them."""
    _, spec, w, x0s = problem
    n = spec[1]["n"]
    return {kind: ranks.run(tasks.scenario_steps, spec, w, CFG, S, kind,
                            x0s, np.zeros((N, n, S)))
            for kind in MESHES}


def _one_device_steps(problem):
    _, spec, w, x0s = problem
    tm = model_from_numpy(*spec, device="cpu")
    step = make_scenario_step(tm, QuadCost(**{
        k: torch.as_tensor(v) for k, v in w.items()}),
        ScenarioMPCConfig(ILQRConfig(**CFG), S))
    U = torch.zeros((N, tm.n, S), dtype=torch.float64)
    out = []
    for x in x0s:
        u0, U, c = step(torch.as_tensor(x), U)
        out.append({"u0": u0.numpy(), "U_next": U.numpy(),
                    "costs": c.numpy()})
    return out


def test_port_collectives_on_a_2x2_mesh(ranks):
    got = ranks.run(tasks.collectives_probe)
    for r, res in enumerate(got):
        dp, kp = res["coords"]
        assert (dp, kp) == divmod(r, 2)        # row-major, dp outermost
        np.testing.assert_array_equal(res["psum_all"], [6.0, 60.0])
        kp_pair = [2 * dp, 2 * dp + 1]
        np.testing.assert_array_equal(res["psum_kp"],
                                      [sum(kp_pair), 10 * sum(kp_pair)])
        np.testing.assert_array_equal(res["pmin_dp"], [kp, 10 * kp])
        np.testing.assert_array_equal(res["gather_kp"],
                                      [[q, 10 * q] for q in kp_pair])
        if r == RANKS - 1:                     # no rank r + 1
            assert res["ppermute"] is None
        else:
            np.testing.assert_array_equal(
                res["ppermute"], [[r + 1, 10 * (r + 1)],
                                  [2 * (r + 1), 20 * (r + 1)]])
        np.testing.assert_array_equal(res["shard"], [[r], [r + 4]])
        np.testing.assert_array_equal(res["unshard"],
                                      np.arange(8.0).reshape(2, 4))


@pytest.mark.parametrize("kind", MESHES)
def test_port_scenario_step_on_a_mesh_matches_jax(problem, port_steps,
                                                  kind):
    jm, _, w, x0s = problem
    mesh = (jax_make_mesh(RANKS) if kind == "flat" else
            jax_make_hybrid_mesh(("dp", "kp"), kp_size=2, n_devices=RANKS))
    jstep = jax_make_scenario_step(
        jm, JaxQuadCost(**{k: jnp.asarray(v) for k, v in w.items()}),
        JaxScenarioMPCConfig(JaxILQRConfig(**CFG), S), mesh)
    U = jnp.zeros((N, jm.n, S))
    for t, x in enumerate(x0s):
        ref = jstep(jnp.asarray(x), U)
        U = ref[1]
        for rank, steps in enumerate(port_steps[kind]):
            got = steps[t]
            # flat: 2 scenarios a rank, each solve on all 8 knots;
            # hybrid: 4 a dp rank, fd_du on 4 knots, no Riccati sweep
            assert got["local_scenarios"] == (2 if kind == "flat" else 4)
            assert tuple(got["scenario_axes"]) == ("dp",)
            assert got["plain_calls"] == (
                {"rollout": 1, "fd_du": ITERS, "riccati": ITERS,
                 "linesearch_rollout": ITERS} if kind == "flat" else
                {"rollout": 1, "fd_du": ITERS, "linesearch_rollout": ITERS})
            for f, theirs in zip(("u0", "U_next", "costs"), ref):
                np.testing.assert_allclose(got[f], np.asarray(theirs),
                                           rtol=0, atol=1e-8,
                                           err_msg=f"{kind} rank {rank} {f}")


def test_port_hybrid_mesh_equals_flat_and_one_device(problem, port_steps):
    one = _one_device_steps(problem)
    for t in range(2):
        for kind in MESHES:
            for steps in port_steps[kind]:
                for f in ("u0", "U_next", "costs"):
                    np.testing.assert_allclose(
                        steps[t][f], one[t][f], rtol=0, atol=1e-8,
                        err_msg=f"{kind} step {t} {f}")
        # the two kp replicas of a dp rank hold the same scenarios, solved
        # alike: equal, bit for bit
        hyb = port_steps["hybrid"]
        for a, b in ((0, 1), (2, 3)):
            for f in ("u0", "U_next", "costs"):
                assert np.array_equal(hyb[a][t][f], hyb[b][t][f])


@pytest.mark.parametrize("kind", MESHES)
def test_port_closed_loop_on_a_mesh_equals_one_device(ranks, problem, kind):
    _, spec, w, _ = problem
    x0 = np.array([0.1, -0.2, 0.0, 0.3])
    got = ranks.run(tasks.mesh_closed_loop, spec, w, CFG, S, kind, x0, 3, 7)
    tm = model_from_numpy(*spec, device="cpu")
    xs, us = closed_loop(tm, QuadCost(**{
        k: torch.as_tensor(v) for k, v in w.items()}),
        ScenarioMPCConfig(ILQRConfig(**CFG), S), torch.as_tensor(x0), 3,
        torch.Generator().manual_seed(7))
    # the draws are the one-device loop's; on the flat mesh u0 sums in
    # another order, on the hybrid mesh the gains come from the knot-sharded
    # reduce (the step's 1e-8 above)
    tol = 1e-12 if kind == "flat" else 1e-8
    for gx, gu in got:
        np.testing.assert_allclose(gx, xs.numpy(), rtol=0, atol=tol)
        np.testing.assert_allclose(gu, us.numpy(), rtol=0, atol=tol)
        assert np.array_equal(gx, got[0][0])


def test_port_mesh_refusals(ranks, problem):
    _, spec, w, _ = problem
    for got in ranks.run(tasks.refusals, spec, w, CFG):
        assert got == {"scenarios_not_divisible": "ValueError",
                       "global_arrays_to_the_step": "ValueError",
                       "axis_not_in_mesh": "ValueError",
                       "axis_size_differs": "ValueError"}


def test_port_ranks_load_no_jax(ranks):
    for mods in ranks.run(tasks.loaded_modules):
        assert "torch" in mods and "gridcodegenerator_tpu_torch" in mods
        assert "jax" not in mods and "gridcodegenerator_tpu" not in mods
