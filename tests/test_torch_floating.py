"""The port's floating base against the JAX package (CPU, float64).

Robots: pendulum2, iiwa, hyq (branched) and mixed5 (a prismatic and a
skew-axis joint), each ``_floating`` (a quaternion root: num_pos = num_vel
+ 1). Inputs are made with numpy from a seed, B=3 lanes, the root's
quaternion random and unnormalized (the transforms normalize it).

* Every first-order ``GRiD`` method but ``d2eepos`` against the JAX ops
  that the JAX ``GRiD(use_pallas=False)`` jit-compiles, run eagerly here
  (compiling them takes minutes on hyq): within 1e-10 of each output's
  scale max(1, max|ref|). A floating GRiD call runs exactly its plain
  twin. (``d2eepos`` and the JAX ``id_grad_seeded`` witness, whose eager
  JAX references take most of a minute, are in
  ``tests/test_torch_floating_jvp.py``.)
* ``xforms.floating_xmat``, ``minv_factors`` (the upper factor) and
  ``id_grad`` against their JAX counterparts, and the topology's ``Xmat``
  and ``Tmat`` of the floating joint against the JAX topology's.
* The counterparts of the JAX ``tests/test_floating_base.py``: M Minv = I,
  id linear in qdd with matrix M, fd and aba invert id; the dynamics do
  not see the quaternion's scale; at the identity base pose the joint rows
  match the fixed base; the base's q-columns are body-frame tangent
  derivatives (central differences of exp(-eps crm(e_j)) X).
* The refusals the JAX package makes: second order, the solvers, and the
  kernels (``use_kernels=True``).
"""

import importlib.util

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from gridcodegenerator_tpu.models.model import build_model as jax_build_model
from gridcodegenerator_tpu.models.zoo import load_robot as jax_load_robot
from gridcodegenerator_tpu.ops import aba as jax_aba
from gridcodegenerator_tpu.ops import crba as jax_crba
from gridcodegenerator_tpu.ops import eepose as jax_eepose
from gridcodegenerator_tpu.ops import fd as jax_fd
from gridcodegenerator_tpu.ops import fd_grad as jax_fd_grad
from gridcodegenerator_tpu.ops import id_grad as jax_id_grad
from gridcodegenerator_tpu.ops import minv as jax_minv
from gridcodegenerator_tpu.ops import rnea as jax_rnea
from gridcodegenerator_tpu.ops import xforms as jax_xforms
from gridcodegenerator_tpu_torch import GRiD
from gridcodegenerator_tpu_torch.codegen import gen_all_code
from gridcodegenerator_tpu_torch.models.model import build_model
from gridcodegenerator_tpu_torch.models.zoo import load_robot
from gridcodegenerator_tpu_torch.ops import xforms
from gridcodegenerator_tpu_torch.ops.cuda import build
from gridcodegenerator_tpu_torch.ops.id_grad import id_grad
from gridcodegenerator_tpu_torch.ops.minv import minv_factors
from gridcodegenerator_tpu_torch.ops.rnea import rnea_bpass, rnea_fpass
from gridcodegenerator_tpu_torch.trajopt.cost import QuadCost
from gridcodegenerator_tpu_torch.trajopt.ilqr import (ILQRConfig,
                                                      dynamics_step,
                                                      make_ilqr)

torch.set_num_threads(1)
ROBOTS = ["pendulum2_floating", "iiwa_floating", "hyq_floating",
          "mixed5_floating"]
B, TOL = 3, 1e-10
# GRiD method -> (the plain twin it runs, its inputs)
METHODS = {
    "id": ("rnea", "q qd qdd"), "id_nqdd": ("rnea", "q qd"),
    "minv": ("minv", "q"), "minv_upper": ("minv", "q"),
    "fd": ("fd", "q qd u"), "aba": ("aba", "q qd u"), "crba": ("crba", "q"),
    "id_du": ("id_du", "q qd qdd"), "id_du_nqdd": ("id_du", "q qd"),
    "fd_du": ("fd_du", "q qd u"), "eepos": ("eepos", "q"),
    "deepos": ("deepos", "q"), "fk": (None, "q"),
    "id_packed": ("rnea", "q qd qdd"),
    "aba_packed": ("aba", "q qd u"), "fd_packed": ("fd", "q qd u"),
    "fd_du_packed": ("fd_du", "q qd u"),
}


def _scale_close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _inputs(npos, nv, seed):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1, 1, (B, npos))
    q[:, 3:7] = 0.5 + rng.uniform(0, 1.5, (B, 1)) * rng.standard_normal(
        (B, 4))                                   # unnormalized quaternion
    return {"q": q, "qd": rng.uniform(-1, 1, (B, nv)),
            "qdd": rng.uniform(-1, 1, (B, nv)),
            "u": rng.uniform(-1, 1, (B, nv))}


class Robot:
    """One robot's port GRiD, JAX model and inputs; the JAX references
    computed at first use and kept."""

    def __init__(self, name):
        self.g = GRiD(name, dtype=torch.float64, device="cpu")
        self.jm = jax_build_model(jax_load_robot(name), dtype=jnp.float64)
        self.x = _inputs(self.g.num_pos, self.g.num_vel, seed=len(name))
        self._ref = {}

    def lanes(self, k):
        return jnp.asarray(self.x[k].T)

    def ref(self, method):
        if method not in self._ref:
            self._ref[method] = self._jax(method.replace("_packed", ""))
        return self._ref[method]

    def _jax(self, method):
        jm, L = self.jm, self.lanes
        q, qd, qdd, u = L("q"), L("qd"), L("qdd"), L("u")
        out = {
            "id": lambda: jax_rnea.rnea(jm, q, qd, qdd),
            "id_nqdd": lambda: jax_rnea.rnea(jm, q, qd, None),
            "minv": lambda: jax_minv.minv(jm, q, True),
            "minv_upper": lambda: jax_minv.minv(jm, q, False),
            "fd": lambda: jax_fd.forward_dynamics(jm, q, qd, u),
            "aba": lambda: jax_aba.aba(jm, q, qd, u),
            "crba": lambda: jax_crba.crba(jm, q),
            "id_du": lambda: jax_id_grad.id_grad(jm, q, qd, qdd),
            "id_du_nqdd": lambda: jax_id_grad.id_grad(jm, q, qd,
                                                      jnp.zeros_like(qd)),
            "fd_du": lambda: jax_fd_grad.fd_grad(jm, q, qd, u),
            "eepos": lambda: jax_eepose.eepos(jm, q),
            "deepos": lambda: jax_eepose.deepos(jm, q),
            "fk": lambda: jax_eepose.fk(jm, q),
            "d2eepos": lambda: jax_eepose.d2eepos(jm, q),
        }[method]()
        return np.moveaxis(np.asarray(out), -1, 0)

    def call(self, method):
        g, x = self.g, self.x
        args = [x[k] for k in METHODS.get(method, (None, "q"))[1].split()]
        if method.endswith("_packed"):
            return getattr(g, method)(np.concatenate(args, axis=-1))
        if method == "minv_upper":
            return g.minv(*args, dense=False)
        return getattr(g, method.replace("_nqdd", ""))(*args)


@pytest.fixture(scope="module", params=ROBOTS)
def robot(request):
    return Robot(request.param)


def check_method(robot, method, twin):
    """``robot``'s GRiD ``method`` ran exactly its plain ``twin`` and
    matches the JAX reference."""
    build.reset_counters()
    got = robot.call(method)
    assert dict(build.PLAIN_CALLS) == ({twin: 1} if twin else {}), method
    assert not build.LAUNCHES
    _scale_close(got.numpy(), robot.ref(method))


@pytest.mark.parametrize("method", list(METHODS))
def test_grid_method_matches_jax(robot, method):
    check_method(robot, method, METHODS[method][0])


def test_floating_xmat_matches_jax():
    rng = np.random.default_rng(3)
    q7 = rng.standard_normal((7, 5)) * np.array([1, 1, 1, 2, 2, 2, 2])[:, None]
    _scale_close(xforms.floating_xmat(torch.as_tensor(q7)).numpy(),
                 jax_xforms.floating_xmat(jnp.asarray(q7)), 1e-14)


def test_minv_factors_and_id_grad_match_jax(robot):
    q, qd, qdd = (torch.as_tensor(robot.x[k].T) for k in ("q", "qd", "qdd"))
    Mu = minv_factors(robot.g.model, q)
    want, _ = jax_minv.minv_factors(robot.jm, robot.lanes("q"))
    _scale_close(Mu.numpy(), want)
    # the diagonal base block is stored as its upper triangle alone
    assert not bool(Mu[1:6, 0].any())
    _scale_close(id_grad(robot.g.model, q, qd, qdd).numpy(),
                 jax_id_grad.id_grad(robot.jm, robot.lanes("q"),
                                     robot.lanes("qd"), robot.lanes("qdd")))


def test_floating_joint_xmat_and_tmat_match_jax_topology():
    rng = np.random.default_rng(4)
    q7 = rng.standard_normal(7)
    mine = load_robot("iiwa_floating").joints[0]
    theirs = jax_load_robot("iiwa_floating").joints[0]
    assert mine.jtype == theirs.jtype == "floating"
    np.testing.assert_array_equal(mine.Xmat(q7), theirs.Xmat(q7))
    np.testing.assert_array_equal(mine.Tmat(q7), theirs.Tmat(q7))
    for jm, jt in zip(load_robot("iiwa").joints, jax_load_robot("iiwa").joints):
        np.testing.assert_array_equal(jm.Tmat(0.3), jt.Tmat(0.3))


# ---------------------------------------------------------------------------
# the JAX tests/test_floating_base.py, on the port
# ---------------------------------------------------------------------------

def _unit_state(model, seed):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1, 1, (model.num_pos, B))
    q[3:7] /= np.linalg.norm(q[3:7], axis=0)
    return (torch.as_tensor(q), torch.as_tensor(rng.uniform(
        -1, 1, (model.num_vel, B))), torch.as_tensor(rng.uniform(
            -1, 1, (model.num_vel, B))))


@pytest.mark.parametrize("name", ROBOTS[:3])
def test_port_floating_consistency(name):
    g = GRiD(name, dtype=torch.float64, device="cpu")
    q, qd, qdd = (t.T.numpy() for t in _unit_state(g.model, 0))
    nv = g.num_vel
    c, c0 = g.id(q, qd, qdd), g.id(q, qd)
    M, Mi = g.crba(q), g.minv(q)
    np.testing.assert_allclose((M @ Mi).numpy(),
                               np.broadcast_to(np.eye(nv), (B, nv, nv)),
                               atol=1e-9)
    np.testing.assert_allclose((c - c0).numpy(),
                               torch.einsum("bij,bj->bi", M,
                                            torch.as_tensor(qdd)).numpy(),
                               atol=1e-9)
    np.testing.assert_allclose(g.fd(q, qd, c).numpy(), qdd, atol=1e-9)
    np.testing.assert_allclose(g.aba(q, qd, c).numpy(), qdd, atol=1e-9)


def test_quaternion_scale_invariance():
    g = GRiD("pendulum2_floating", dtype=torch.float64, device="cpu")
    q, qd, qdd = (t.T.numpy() for t in _unit_state(g.model, 1))
    q2 = q.copy()
    q2[:, 3:7] *= 2.5
    for m, args in (("id", (qd, qdd)), ("aba", (qd, qdd)), ("minv", ()),
                    ("eepos", ())):
        np.testing.assert_allclose(getattr(g, m)(q2, *args).numpy(),
                                   getattr(g, m)(q, *args).numpy(),
                                   atol=1e-10, err_msg=m)


def test_identity_pose_matches_fixed_base():
    fixed = GRiD("pendulum2", dtype=torch.float64, device="cpu")
    flt = GRiD("pendulum2_floating", dtype=torch.float64, device="cpu")
    q_j, qd_j = np.array([[0.3, 0.5]]), np.array([[0.1, -0.2]])
    q_f = np.concatenate([np.zeros((1, 6)), np.ones((1, 1)), q_j], axis=1)
    qd_f = np.concatenate([np.zeros((1, 6)), qd_j], axis=1)
    np.testing.assert_allclose(flt.id(q_f, qd_f)[:, 6:].numpy(),
                               fixed.id(q_j, qd_j).numpy(), atol=1e-10)
    np.testing.assert_allclose(flt.eepos(q_f).numpy(),
                               fixed.eepos(q_j).numpy(), atol=1e-12)
    np.testing.assert_allclose(flt.fk(q_f)[:, 1:].numpy(),
                               fixed.fk(q_j).numpy(), atol=1e-12)


def _crm6(j):
    e = np.zeros(6)
    e[j] = 1.0

    def skew(x):
        return np.array([[0, -x[2], x[1]], [x[2], 0, -x[0]],
                         [-x[1], x[0], 0]])
    C = np.zeros((6, 6))
    C[:3, :3] = C[3:, 3:] = skew(e[:3])
    C[3:, :3] = skew(e[3:])
    return C


def test_base_columns_are_body_frame_tangents():
    """dc/dq's base columns: central differences along exp(-eps crm(e_j))
    X_0, the flow of a body-frame base velocity."""
    m = build_model(load_robot("iiwa_floating"), dtype=torch.float64,
                    device="cpu")
    q, qd, qdd = _unit_state(m, 2)
    D = id_grad(m, q, qd, qdd)

    def c_of(Xs):
        _, _, f = rnea_fpass(m, Xs, qd, qdd)
        return rnea_bpass(m, Xs, qd, f)[0]

    Xs = xforms.all_xmats(m, q)
    eps = 1e-7
    for j in range(6):
        side = []
        for sgn in (1, -1):
            E = torch.as_tensor(sla.expm(-sgn * eps * _crm6(j)))
            side.append(c_of([torch.einsum("rc,cdb->rdb", E, Xs[0])]
                             + Xs[1:]))
        np.testing.assert_allclose(D[:, j].numpy(),
                                   ((side[0] - side[1]) / (2 * eps)).numpy(),
                                   atol=5e-6)


# ---------------------------------------------------------------------------
# what a floating base refuses, as the JAX package does
# ---------------------------------------------------------------------------

def test_second_order_solvers_and_kernels_refuse_a_floating_base():
    g = GRiD("iiwa_floating", dtype=torch.float64, device="cpu")
    x = np.zeros((2, g.num_vel))
    q = np.zeros((2, g.num_pos))
    for method in ("idsva_so", "fdsva_so"):
        with pytest.raises(NotImplementedError, match="second-order"):
            getattr(g, method)(q, x, x)
    with pytest.raises(NotImplementedError, match="fixed-base"):
        GRiD("iiwa_floating", device="cpu", use_kernels=True)
    n = g.num_vel
    cost = QuadCost(Q=torch.ones(2 * n, dtype=torch.float64),
                    R=torch.ones(n, dtype=torch.float64),
                    Qf=torch.ones(2 * n, dtype=torch.float64),
                    x_goal=torch.zeros(2 * n, dtype=torch.float64))
    with pytest.raises(NotImplementedError, match="make_ilqr"):
        make_ilqr(g.model, cost, ILQRConfig(N=4))
    with pytest.raises(NotImplementedError, match="make_ilqr"):
        dynamics_step(g.model, torch.zeros((2 * n, 1), dtype=torch.float64),
                      torch.zeros((n, 1), dtype=torch.float64), 0.01)


def test_generated_module_routes_a_floating_base(tmp_path):
    """gen_all_code's module for hyq_floating: its algorithms run the
    plain twins and equal GRiD's; its kernel tier binds the plain twins;
    its timing table leaves out the second order."""
    path = gen_all_code(load_robot("hyq_floating"), "grid_hyq_floating",
                        path=str(tmp_path / "grid_hyq_floating.py"))
    spec = importlib.util.spec_from_file_location("grid_hyq_floating", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.FLOATING_BASE and mod.NUM_POS == 19
    assert [a for a, _ in mod._TIMING_SET] == [
        "id", "minv", "fd", "aba", "crba", "id_du", "fd_du", "eepos",
        "deepos", "d2eepos"]
    mod.configure(device="cpu", dtype=torch.float64)
    g = GRiD("hyq_floating", dtype=torch.float64, device="cpu")
    x = _inputs(19, 18, 5)
    for name, nargs in mod._TIMING_SET:
        args = (x["q"],) if nargs == 1 else (x["q"], x["qd"], x["u"])
        build.reset_counters()
        got = getattr(mod, name)(*args)
        assert not build.LAUNCHES and sum(build.PLAIN_CALLS.values()) == 1
        assert torch.equal(got, getattr(g, name)(*args)), name
    assert mod.fd_kernel().func.__name__ == "fd_plain"
    with pytest.raises(NotImplementedError):
        mod.idsva_so(x["q"], x["qd"], x["qdd"])
