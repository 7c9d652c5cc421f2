"""The port's plain dynamics ops against the JAX package's (CPU, float64).

Inputs are made with numpy from a seed and fed to both packages; the
constants reach the port through ``model_from_numpy``. The plain twins of
the port's kernels are also held against the JAX Pallas kernels they
replace, run in interpret mode as ``tests/test_pallas.py`` runs them.
Tolerance: 1e-10 absolute, the oracle tolerance of the JAX package's own
tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridcodegenerator_tpu.models.model import build_model as jax_build_model
from gridcodegenerator_tpu.models.zoo import load_robot as jax_load_robot
from gridcodegenerator_tpu.ops import aba as jax_aba
from gridcodegenerator_tpu.ops import eepose as jax_eepose
from gridcodegenerator_tpu.ops import fd_grad as jax_fd_grad
from gridcodegenerator_tpu.ops import linalg as jax_linalg
from gridcodegenerator_tpu.ops import minv as jax_minv
from gridcodegenerator_tpu.ops import rnea as jax_rnea
from gridcodegenerator_tpu.ops.pallas import kernels as pk
from gridcodegenerator_tpu_torch.models.model import (ARRAY_FIELDS,
                                                       STATIC_FIELDS,
                                                       model_from_numpy)
from gridcodegenerator_tpu_torch.ops import aba, eepose, fd_grad, linalg
from gridcodegenerator_tpu_torch.ops import minv, rnea
from gridcodegenerator_tpu_torch.ops.cuda import build
from gridcodegenerator_tpu_torch.ops.cuda import kernels

torch.set_num_threads(1)
ATOL = 1e-10
B = 6


@pytest.fixture(scope="module", params=["pendulum2", "iiwa"])
def pair(request):
    jm = jax_build_model(jax_load_robot(request.param), dtype=jnp.float64)
    tm = model_from_numpy({f: np.asarray(getattr(jm, f)) for f in ARRAY_FIELDS},
                          {f: getattr(jm, f) for f in STATIC_FIELDS},
                          device="cpu")
    rng = np.random.default_rng(7)
    q, qd, u, qdd = (rng.uniform(-1, 1, (jm.n, B)) for _ in range(4))
    return jm, tm, dict(q=q, qd=qd, u=u, qdd=qdd)


def _t(x):
    return torch.as_tensor(x)


def _close(ours, ref):
    if not isinstance(ref, (tuple, list)):
        ours, ref = (ours,), (ref,)
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=ATOL)


OPS = {
    "rnea": (lambda m, x: rnea.rnea(m, _t(x["q"]), _t(x["qd"]), _t(x["qdd"])),
             lambda m, x: jax_rnea.rnea(m, x["q"], x["qd"], x["qdd"])),
    "rnea_bias": (lambda m, x: rnea.rnea(m, _t(x["q"]), _t(x["qd"])),
                  lambda m, x: jax_rnea.rnea(m, x["q"], x["qd"])),
    "minv": (lambda m, x: minv.minv(m, _t(x["q"])),
             lambda m, x: jax_minv.minv(m, x["q"])),
    "minv_upper": (lambda m, x: minv.minv(m, _t(x["q"]), dense=False),
                   lambda m, x: jax_minv.minv(m, x["q"], dense=False)),
    "aba": (lambda m, x: aba.aba(m, _t(x["q"]), _t(x["qd"]), _t(x["u"])),
            lambda m, x: jax_aba.aba(m, x["q"], x["qd"], x["u"])),
    "fd_grad": (lambda m, x: fd_grad.fd_grad(
                    m, _t(x["q"]), _t(x["qd"]), _t(x["u"]),
                    return_extras=True),
                lambda m, x: jax_fd_grad.fd_grad(
                    m, x["q"], x["qd"], x["u"], return_extras=True)),
    "eepos": (lambda m, x: eepose.eepos(m, _t(x["q"])),
              lambda m, x: jax_eepose.eepos(m, x["q"])),
    "eexyz": (lambda m, x: eepose.eexyz(m, _t(x["q"])),
              lambda m, x: jax_eepose.eexyz(m, x["q"])),
    "deepos": (lambda m, x: eepose.deepos(m, _t(x["q"])),
               lambda m, x: jax_eepose.deepos(m, x["q"])),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_op_matches_jax(pair, op):
    jm, tm, x = pair
    ours, ref = OPS[op]
    _close(ours(tm, x), ref(jm, x))


def test_fd_du_plain_matches_jax_fd_grad(pair):
    """The plain version behind the fd_du kernel wrapper against the JAX
    XLA path that its Pallas kernel is pinned to."""
    jm, tm, x = pair
    build.reset_counters()
    ours = kernels.fd_du(tm, _t(x["q"]), _t(x["qd"]), _t(x["u"]))
    assert build.PLAIN_CALLS["fd_du"] == 1 and not build.LAUNCHES
    ref = jax_fd_grad.fd_grad(jm, x["q"], x["qd"], x["u"],
                              return_extras=True)
    _close(ours, ref)


def test_gj_inverse_matches_jax():
    rng = np.random.default_rng(0)
    m = 7
    A = rng.standard_normal((B, m, m))
    A = np.moveaxis(A @ np.swapaxes(A, 1, 2) + m * np.eye(m), 0, -1)
    ours = linalg.gj_inverse(_t(A))
    _close(ours, jax_linalg.gj_inverse(jnp.asarray(A)))
    eye = np.einsum("ikb,kjb->ijb", ours.numpy(), A)
    np.testing.assert_allclose(eye, np.eye(m)[:, :, None] + 0 * eye,
                               atol=1e-12)


# plain twin of a port kernel -> (its JAX Pallas kernel, interpret mode, and
# the number of (n, B) inputs both take)
PALLAS = {
    "rnea": (kernels.rnea_plain,
             lambda m: pk.rnea_pallas(m, -9.81, block_b=8, interpret=True), 3),
    "rnea_bias": (kernels.rnea_plain,
                  lambda m: pk.rnea_pallas(m, -9.81, with_qdd=False,
                                           block_b=8, interpret=True), 2),
    "id_du": (kernels.id_du_plain,
              lambda m: pk.id_du_pallas(m, -9.81, block_b=8, interpret=True),
              3),
    "aba": (kernels.aba_plain,
            lambda m: pk.aba_pallas(m, -9.81, block_b=8, interpret=True), 3),
    "minv": (lambda m, q: kernels.minv_plain(m, q, True),
             lambda m: pk.minv_pallas(m, True, block_b=8, interpret=True), 1),
    "minv_upper": (lambda m, q: kernels.minv_plain(m, q, False),
                   lambda m: pk.minv_pallas(m, False, block_b=8,
                                            interpret=True), 1),
}


@pytest.mark.parametrize("case", sorted(PALLAS))
def test_plain_twin_matches_jax_pallas_kernel(pair, case):
    jm, tm, _ = pair
    plain, pallas, nargs = PALLAS[case]
    rng = np.random.default_rng(5)
    x = [rng.uniform(-1, 1, (jm.n, 8)) for _ in range(nargs)]   # B = 8
    _close(plain(tm, *map(_t, x)),
           pallas(jm)(*(jnp.asarray(a) for a in x)))


def _pair_of(robot):
    jm = jax_build_model(jax_load_robot(robot), dtype=jnp.float64)
    tm = model_from_numpy({f: np.asarray(getattr(jm, f)) for f in ARRAY_FIELDS},
                          {f: getattr(jm, f) for f in STATIC_FIELDS},
                          device="cpu")
    return jm, tm


# gym_humanoid (17 joints) is left out: its three interpret runs take 32 s
# on one CPU core (hyq's 19 s)
@pytest.mark.parametrize("case", ["aba", "rnea", "rnea_bias"])
@pytest.mark.parametrize("robot", ["hyq"])
def test_plain_twin_matches_jax_pallas_kernel_on_trees(robot, case):
    """rnea (with qdd and the bias form) and aba, whose kernels run a tree's
    level a phase, on a branched robot, hyq (12 joints, four legs): each
    plain twin against the JAX Pallas kernel it replaces, in interpret
    mode, float64, B = 8."""
    jm, tm = _pair_of(robot)
    plain, pallas, nargs = PALLAS[case]
    rng = np.random.default_rng(5)
    x = [rng.uniform(-1, 1, (jm.n, 8)) for _ in range(nargs)]   # B = 8
    _close(plain(tm, *map(_t, x)),
           pallas(jm)(*(jnp.asarray(a) for a in x)))
