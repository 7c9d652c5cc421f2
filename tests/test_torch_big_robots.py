"""The port above 28 joints against the JAX package (CPU, float64).

The robots are atlas with hands (tests/torch_big_robots.py): both packages
parse the same URDF string with their own ``parse_urdf``.

* atlas_grippers34 (34 joints): the port's ``GRiD`` first-order methods
  (plain versions on CPU tensors) against the JAX ``GRiD``'s XLA tier
  (``use_pallas=False``, run eagerly: jitting its calls at 34 joints takes
  over 200 s on one core) on 3 lanes, within 1e-10 of scale.
* The JAX reference's semi-implicit Euler step (``dynamics_step``) sets
  config 5's dt on atlas_hands52: at atlas's 0.01 the fingers' light links
  under the joint damping leave the finite numbers, at 0.002 they stay
  bounded (as gym_humanoid's step does at 0.002).
* atlas_hands52 (52 joints): the plain rnea, minv, crba, aba, fd, id_du
  and fd_du against the JAX package's float64 oracle
  (gridcodegenerator_tpu/reference/oracle.py) on 2 lanes, within 1e-10 of
  scale.
* Above 64 joints (``build.MAX_JOINTS``) the second-order wrappers raise
  ``NotImplementedError`` on CUDA tensors before any launch or nvcc; at 34
  joints on the CPU they, ``GRiD``'s second order and ``make_sqp`` run the
  plain versions (tests/test_torch_big_so.py holds them against the JAX
  package's XLA tier; on the card they launch the kernels:
  tests/test_torch_kernels.py,
  ``test_cuda_second_order_refuses_above_28_joints``).

Config 5's scenario step on these robots: tests/test_torch_big_scenario.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridcodegenerator_tpu.api import GRiD as JaxGRiD
from gridcodegenerator_tpu.models.model import build_model as jax_build_model
from gridcodegenerator_tpu.reference import oracle as jax_oracle
from gridcodegenerator_tpu.topology.urdf import parse_urdf as jax_parse_urdf
from gridcodegenerator_tpu.trajopt.ilqr import \
    dynamics_step as jax_dynamics_step
from gridcodegenerator_tpu_torch import GRiD
from gridcodegenerator_tpu_torch.models.model import build_model
from gridcodegenerator_tpu_torch.ops import aba, crba, fd, minv, rnea
from gridcodegenerator_tpu_torch.ops.cuda import build
from gridcodegenerator_tpu_torch.ops.cuda import kernels as K
from gridcodegenerator_tpu_torch.ops.fd_grad import fd_grad
from gridcodegenerator_tpu_torch.ops.id_grad import id_grad
from gridcodegenerator_tpu_torch.topology.urdf import parse_urdf
from gridcodegenerator_tpu_torch.trajopt.cost import QuadCost
from gridcodegenerator_tpu_torch.trajopt.sqp import SQPConfig, make_sqp
from torch_big_robots import atlas_hands_name, atlas_hands_urdf

torch.set_num_threads(1)
TOL = 1e-10
GRIPPERS, HANDS = 3, 12   # joints a hand: atlas_grippers34, atlas_hands52


def scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    return float(np.abs(got - want).max()) / scale


def robot(k, jax_side=False):
    urdf, name = atlas_hands_urdf(k), atlas_hands_name(k)
    return (jax_parse_urdf(urdf, name=name) if jax_side
            else parse_urdf(urdf, name=name))


# ---------------------------------------------------------------------------
# GRiD's first-order methods on atlas_grippers34
# ---------------------------------------------------------------------------

CALLS = {
    "id": lambda g, x: g.id(x["q"], x["qd"], x["qdd"]),
    "id_bias": lambda g, x: g.id(x["q"], x["qd"]),
    "id_du": lambda g, x: g.id_du(x["q"], x["qd"], x["qdd"]),
    "aba": lambda g, x: g.aba(x["q"], x["qd"], x["u"]),
    "minv": lambda g, x: g.minv(x["q"]),
    "minv_upper": lambda g, x: g.minv(x["q"], dense=False),
    "fd": lambda g, x: g.fd(x["q"], x["qd"], x["u"]),
    "crba": lambda g, x: g.crba(x["q"]),
    "fd_du": lambda g, x: g.fd_du(x["q"], x["qd"], x["u"]),
    "eepos": lambda g, x: g.eepos(x["q"]),
    "deepos": lambda g, x: g.deepos(x["q"]),
    "d2eepos": lambda g, x: g.d2eepos(x["q"]),
}


@pytest.fixture(scope="module")
def grids():
    return (GRiD(robot(GRIPPERS), dtype=torch.float64, device="cpu"),
            JaxGRiD(robot(GRIPPERS, jax_side=True), dtype=jnp.float64,
                    use_pallas=False))


@pytest.mark.parametrize("call", sorted(CALLS))
def test_grid_first_order_matches_jax_grid_above_28(grids, call):
    ours, ref = grids
    assert ours.n == 34 and ref.n == 34
    rng = np.random.default_rng(20)
    x = {k: rng.uniform(-1, 1, (3, ours.n)) for k in ("q", "qd", "qdd", "u")}
    build.reset_counters()
    got = CALLS[call](ours, x)
    assert not build.LAUNCHES and sum(build.PLAIN_CALLS.values()) == 1
    with jax.disable_jit():
        want = CALLS[call](ref, x)
    assert scaled_err(got.numpy(), want) <= TOL


# ---------------------------------------------------------------------------
# atlas_hands52: config 5's step size
# ---------------------------------------------------------------------------

DT = 0.002   # config 5's step on the hands


def test_jax_reference_step_sets_config5_dt_on_the_hands():
    """The JAX reference's semi-implicit Euler step (dynamics_step) on
    atlas_hands52 from config 5's scenario spread, under random controls:
    at atlas's 0.01 the state leaves the finite numbers within 100 steps,
    at 0.002 it stays bounded."""
    jm = jax_build_model(robot(HANDS, jax_side=True), dtype=jnp.float64)
    n = jm.n
    rng = np.random.default_rng(22)
    x0 = 0.02 * rng.standard_normal((2 * n, 4))
    us = rng.uniform(-1, 1, (100, n, 4))

    step = jax.jit(lambda x, u, dt: jax_dynamics_step(jm, x, u, dt))

    def final(dt):
        x = jnp.asarray(x0)
        for u in us:
            x = step(x, jnp.asarray(u), dt)
        return np.asarray(x)
    assert not np.isfinite(final(0.01)).all()
    x = final(DT)
    assert np.isfinite(x).all() and np.abs(x).max() < 100


# ---------------------------------------------------------------------------
# atlas_hands52: the plain ops against the JAX package's float64 oracle
# ---------------------------------------------------------------------------

# each plain op and its oracle function: (op on lane-major tensors, oracle
# on one sample) -> one output
PLAIN = {
    "rnea": (lambda m, q, qd, qdd, u: rnea.rnea(m, q, qd, qdd),
             lambda t, q, qd, qdd, u: jax_oracle.rnea(t, q, qd, qdd)[0]),
    "minv": (lambda m, q, qd, qdd, u: minv.minv(m, q),
             lambda t, q, qd, qdd, u: jax_oracle.minv(t, q)),
    "crba": (lambda m, q, qd, qdd, u: crba.crba(m, q),
             lambda t, q, qd, qdd, u: jax_oracle.crba(t, q)),
    "aba": (lambda m, q, qd, qdd, u: aba.aba(m, q, qd, u),
            lambda t, q, qd, qdd, u: jax_oracle.aba(t, q, qd, u)),
    "fd": (lambda m, q, qd, qdd, u: fd.forward_dynamics(m, q, qd, u),
           lambda t, q, qd, qdd, u: jax_oracle.forward_dynamics(t, q, qd, u)),
    "id_du": (lambda m, q, qd, qdd, u: id_grad(m, q, qd, qdd),
              lambda t, q, qd, qdd, u: jax_oracle.rnea_grad(t, q, qd, qdd)),
    "fd_du": (lambda m, q, qd, qdd, u: fd_grad(m, q, qd, u),
              lambda t, q, qd, qdd, u: jax_oracle.fd_grad(t, q, qd, u)[0]),
}


@pytest.mark.parametrize("fn", list(PLAIN))
def test_plain_ops_match_the_jax_oracle_at_52_joints(fn):
    m = build_model(robot(HANDS), dtype=torch.float64, device="cpu")
    jtopo = robot(HANDS, jax_side=True)
    assert m.n == 52
    rng = np.random.default_rng(21)
    xs = tuple(rng.uniform(-1, 1, (m.n, 2)) for _ in range(4))
    op, ref = PLAIN[fn]
    got = op(m, *map(torch.as_tensor, xs)).numpy()
    for b in range(2):
        assert scaled_err(got[..., b], ref(jtopo, *(x[:, b] for x in xs))) \
            <= TOL


# ---------------------------------------------------------------------------
# the second order's ceiling: 64 joints, as every kernel's
# ---------------------------------------------------------------------------

class _OnCard:
    """Stands for a CUDA tensor of the model's dtype and device: the
    wrappers check the joint count before they read anything else of it."""
    is_cuda = True

    def __init__(self, m):
        self.dtype, self.device = m.dtype, m.device


def quad_cost(m):
    n, kw = m.n, dict(dtype=m.dtype, device=m.device)
    return QuadCost(Q=torch.ones(2 * n, **kw), R=torch.ones(n, **kw),
                    Qf=torch.ones(2 * n, **kw),
                    x_goal=torch.zeros(2 * n, **kw))


def test_second_order_refuses_above_28_joints():
    """On a CUDA tensor the second-order wrappers refuse atlas with two
    19-joint hands (66 joints, above build.MAX_JOINTS) by name before any
    launch or nvcc; on the CPU at 34 joints they, GRiD's second order and
    make_sqp run the plain versions."""
    m66 = build_model(robot(19), dtype=torch.float64, device="cpu")
    assert m66.n == 66 > build.MAX_JOINTS
    build.reset_counters()
    for fn in (K.idsva_so, K.fdsva_so):
        x = _OnCard(m66)
        with pytest.raises(NotImplementedError,
                           match=f"^{fn.__name__} .*66 joints .1 to 64"):
            fn(m66, x, x, x)
    assert not build.LAUNCHES and not build.PLAIN_CALLS
    g = GRiD(robot(GRIPPERS), dtype=torch.float64, device="cpu")
    m = g.model
    xb = np.random.default_rng(25).uniform(-1, 1, (2, m.n))
    for method in ("idsva_so", "fdsva_so"):
        out = getattr(g, method)(xb, xb, xb)
        assert out.shape == (2, 4, m.n, m.n, m.n)
        assert bool(torch.isfinite(out).all())
    assert not build.LAUNCHES
    assert dict(build.PLAIN_CALLS) == {"idsva_so": 1, "fdsva_so": 1}
    make_sqp(m, quad_cost(m), SQPConfig(N=4))


def test_generated_module_of_a_52_joint_robot(tmp_path):
    """gen_all_code's module for atlas_hands52 imports, its algorithms
    equal GRiD's on the CPU, and its timing table holds them all, the
    second order too (the card has a kernel for it up to 64 joints)."""
    import importlib.util

    from gridcodegenerator_tpu_torch.codegen import gen_all_code
    topo = robot(HANDS)
    path = gen_all_code(topo, "grid_atlas_hands52",
                        path=str(tmp_path / "grid_atlas_hands52.py"))
    spec = importlib.util.spec_from_file_location("grid_atlas_hands52", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert [a for a, _ in mod._TIMING_SET] == [
        "id", "minv", "fd", "aba", "crba", "id_du", "fd_du", "idsva_so",
        "fdsva_so", "eepos", "deepos", "d2eepos"]
    mod.configure(device="cpu", dtype=torch.float64)
    g = GRiD(topo, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(23)
    x = [rng.uniform(-1, 1, (2, 52)) for _ in range(3)]
    for name, nargs in mod._TIMING_SET:
        assert torch.equal(getattr(mod, name)(*x[:nargs]),
                           getattr(g, name)(*x[:nargs])), name
