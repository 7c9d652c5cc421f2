"""The port's plain forward dynamics, CRBA and EE kinematics against the
JAX package (CPU).

Inputs are made with numpy from a seed and fed to both packages; JAX
models reach the port through ``model_from_numpy``. The port's GRiD calls
built on these ops are in ``test_torch_api_kinematics.py``.

* Plain ops (``ops/fd.py``, ``ops/crba.py``, ``ops/eepose.py``) against
  the JAX ops in float64: 1e-10, the oracle tolerance of the JAX package's
  tests.
* The plain twins of the fd, crba, eepos, deepos and d2eepos kernels
  against the JAX Pallas kernels they replace, in interpret mode: fd and
  crba at 1e-10. The Pallas EE kernels use the polynomial atan2 that Mosaic
  needed; the port uses the exact one, and in float64 (q ~ U(-3, 3)) the
  polynomial form is off by up to 7.7e-9 in the pose and 3.9e-6 in its
  Jacobian, so eepos is held at 2e-8 and deepos at 1e-5. In the Hessian the
  gap reached 4.2e-4 (iiwa, B=16, six seeds each of q ~ U(-1, 1) and
  U(-3, 3)), so d2eepos is held at 1e-3; against the JAX XLA tier, which
  takes the exact atan2, it is held at 1e-10 like the other ops.
"""

import copy
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridcodegenerator_tpu.models.model import build_model as jax_build_model
from gridcodegenerator_tpu.models.zoo import load_robot as jax_load_robot
from gridcodegenerator_tpu.ops import crba as jax_crba
from gridcodegenerator_tpu.ops import eepose as jax_eepose
from gridcodegenerator_tpu.ops import fd as jax_fd
from gridcodegenerator_tpu.ops.pallas import kernels as pk
from gridcodegenerator_tpu_torch.models.model import (ARRAY_FIELDS,
                                                       STATIC_FIELDS,
                                                       model_from_numpy)
from gridcodegenerator_tpu_torch.ops import crba, eepose, fd
from gridcodegenerator_tpu_torch.ops.cuda import build
from gridcodegenerator_tpu_torch.ops.cuda import kernels

torch.set_num_threads(1)
ATOL = 1e-10
EEPOS_POLY_ATOL = 2e-8
DEEPOS_POLY_ATOL = 1e-5
D2EEPOS_POLY_ATOL = 1e-3
# EE targets per robot: pendulum2 and mixed5 have no fixed frames to name;
# gym_ant's EEs are welded to the base (empty chains); hyq is branched, 12
# joints, 4 EEs; mixed5 has prismatic joints
TARGETS = {"pendulum2": None, "iiwa": ["ee_fixed"],
           "hyq": ["lf_foot_fixed", "rh_foot_fixed"],
           "gym_ant": ["front_left_leg_weld", "back_leg_weld"],
           "mixed5": None, "gym_ant_feet": None}
DYNAMICS_ROBOTS = ("pendulum2", "iiwa", "hyq")
EE_ROBOTS = DYNAMICS_ROBOTS + ("gym_ant",)
# gym_ant_feet: gym_ant with its fixed frames dropped, so that its EEs are
# its four leaf links (its fixed frames all sit on the base)
HESSIAN_ROBOTS = EE_ROBOTS + ("mixed5", "gym_ant_feet")


@functools.lru_cache(maxsize=None)
def pair(robot):
    topo = jax_load_robot(robot.removesuffix("_feet"))
    if robot.endswith("_feet"):
        topo = copy.copy(topo)
        topo.fixed_joints = []
    jm = jax_build_model(topo, dtype=jnp.float64)
    tm = model_from_numpy({f: np.asarray(getattr(jm, f)) for f in ARRAY_FIELDS},
                          {f: getattr(jm, f) for f in STATIC_FIELDS},
                          device="cpu")
    return jm, tm


def inputs(n, B, nargs, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (n, B)) for _ in range(nargs)]


def _t(x):
    return torch.as_tensor(x)


def _close(ours, ref, atol=ATOL):
    if not isinstance(ref, (tuple, list)):
        ours, ref = (ours,), (ref,)
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        o = torch.stack(o) if isinstance(o, list) else o
        r = np.stack(r) if isinstance(r, list) else np.asarray(r)
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=atol)


# op -> (port op, JAX op, number of (n, B) inputs); tg = the robot's targets
OPS = {
    "fd": (lambda m, x, tg: fd.forward_dynamics(m, *map(_t, x)),
           lambda m, x, tg: jax_fd.forward_dynamics(m, *x), 3),
    "fd_extras": (lambda m, x, tg: fd.forward_dynamics(
                      m, *map(_t, x), return_extras=True),
                  lambda m, x, tg: jax_fd.forward_dynamics(
                      m, *x, return_extras=True), 3),
    "crba": (lambda m, x, tg: crba.crba(m, _t(x[0])),
             lambda m, x, tg: jax_crba.crba(m, x[0]), 1),
    "fk": (lambda m, x, tg: eepose.fk(m, _t(x[0])),
           lambda m, x, tg: jax_eepose.fk(m, x[0]), 1),
    "eepos": (lambda m, x, tg: eepose.eepos(m, _t(x[0])),
              lambda m, x, tg: jax_eepose.eepos(m, x[0]), 1),
    "eepos_targets": (lambda m, x, tg: eepose.eepos(m, _t(x[0]), tg),
                      lambda m, x, tg: jax_eepose.eepos(m, x[0], tg), 1),
    "eexyz_targets": (lambda m, x, tg: eepose.eexyz(m, _t(x[0]), tg),
                      lambda m, x, tg: jax_eepose.eexyz(m, x[0], tg), 1),
    "deepos": (lambda m, x, tg: eepose.deepos(m, _t(x[0])),
               lambda m, x, tg: jax_eepose.deepos(m, x[0]), 1),
    "deepos_targets": (lambda m, x, tg: eepose.deepos(m, _t(x[0]), tg),
                       lambda m, x, tg: jax_eepose.deepos(m, x[0], tg), 1),
    "d2eepos": (lambda m, x, tg: eepose.d2eepos(m, _t(x[0])),
                lambda m, x, tg: jax_eepose.d2eepos(m, x[0]), 1),
    "d2eepos_targets": (lambda m, x, tg: eepose.d2eepos(m, _t(x[0]), tg),
                        lambda m, x, tg: jax_eepose.d2eepos(m, x[0], tg), 1),
}


def _op_params():
    out = []
    for op in OPS:
        robots = (HESSIAN_ROBOTS if op.startswith("d2")
                  else EE_ROBOTS if op.startswith(("ee", "dee", "fk"))
                  else DYNAMICS_ROBOTS)
        out += [(op, r) for r in robots
                if TARGETS[r] or not op.endswith("_targets")]
    return out


@pytest.mark.parametrize("op,robot", _op_params())
def test_op_matches_jax(op, robot):
    jm, tm = pair(robot)
    ours, ref, nargs = OPS[op]
    x = inputs(jm.n, 6, nargs, seed=7)
    _close(ours(tm, x, TARGETS[robot]), ref(jm, x, TARGETS[robot]))


def test_ee_chains_match_jax():
    for robot in EE_ROBOTS:
        jm, tm = pair(robot)
        for tg in (None, TARGETS[robot]):
            assert eepose.ee_chains(tm, tg) == [
                (tuple(c), f) for c, f in jax_eepose.ee_chains(jm, tg)]
            assert eepose.num_ees(tm, tg) == jax_eepose.num_ees(jm, tg)
    with pytest.raises(ValueError):
        eepose.ee_chains(pair("hyq")[1], ["no_such_frame"])


# plain twin of a port kernel -> (its JAX Pallas kernel in interpret mode,
# number of (n, B) inputs, tolerance); tg = the robot's targets
PALLAS = {
    "fd": (lambda m, x, tg: kernels.fd_plain(m, *x),
           lambda m, tg: pk.fd_pallas(m, -9.81, block_b=8, interpret=True),
           3, ATOL),
    "crba": (lambda m, x, tg: kernels.crba_plain(m, *x),
             lambda m, tg: pk.crba_pallas(m, block_b=8, interpret=True),
             1, ATOL),
    "eepos": (lambda m, x, tg: kernels.eepos_plain(m, *x),
              lambda m, tg: pk.eepos_pallas(m, block_b=8, interpret=True),
              1, EEPOS_POLY_ATOL),
    "eepos_targets": (lambda m, x, tg: kernels.eepos_plain(m, *x, tg),
                      lambda m, tg: pk.eepos_pallas(m, tg, block_b=8,
                                                    interpret=True),
                      1, EEPOS_POLY_ATOL),
    "deepos": (lambda m, x, tg: kernels.deepos_plain(m, *x),
               lambda m, tg: pk.deepos_pallas(m, block_b=8, interpret=True),
               1, DEEPOS_POLY_ATOL),
    "deepos_targets": (lambda m, x, tg: kernels.deepos_plain(m, *x, tg),
                       lambda m, tg: pk.deepos_pallas(m, tg, block_b=8,
                                                      interpret=True),
                       1, DEEPOS_POLY_ATOL),
    "d2eepos": (lambda m, x, tg: kernels.d2eepos_plain(m, *x),
                lambda m, tg: pk.d2eepos_pallas(m, block_b=16,
                                                interpret=True),
                1, D2EEPOS_POLY_ATOL),
}


def _pallas_params():
    out = []
    for case in PALLAS:
        if case == "d2eepos":   # one robot: interpret mode takes ~40 s
            continue
        robots = EE_ROBOTS if "epos" in case else DYNAMICS_ROBOTS
        out += [(case, r) for r in robots
                if TARGETS[r] or not case.endswith("_targets")]
    return out


@pytest.mark.parametrize("case,robot", _pallas_params() + [("d2eepos",
                                                                "iiwa")])
def test_plain_twin_matches_jax_pallas_kernel(case, robot):
    jm, tm = pair(robot)
    plain, pallas, nargs, atol = PALLAS[case]
    # B = 8; d2eepos_pallas tiles its lanes by 16
    x = inputs(jm.n, 16 if case == "d2eepos" else 8, nargs, seed=5)
    build.reset_counters()
    ours = plain(tm, list(map(_t, x)), TARGETS[robot])
    assert sum(build.PLAIN_CALLS.values()) == 1 and not build.LAUNCHES
    _close(ours, pallas(jm, TARGETS[robot])(*map(jnp.asarray, x)), atol)
